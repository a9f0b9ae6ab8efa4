// The patch-attention forward tile shared by K1 (attention.cu, inference)
// and K5 (attention_dropout.cu, training with dropout), and the fragment
// helpers K6 uses too: one warp, 16 query rows of one (g, h) patch against
// all of its P <= 128 keys, with both products on the tensor cores as
// 3xTF32 mma.sync.m16n8k8 (tc_common.cuh).
//
// attend_rows: S = (q scale) k^T for all P keys in registers (64 floats a
// thread), masked logits (-1e9 at an invalid key, -inf past P), the row
// max, exps and sums in one pass (each logit computed once: with P <= 128
// one key tile is the whole row), then out = exps v / sum. With kDrop the
// exps whose keep bit is 0 are left out of the product (not of the sum),
// out is scaled by 1 / (1 - rate) and the row logsumexp is written.
//
// With bf16 q and out (T = bf16, K1 under compute_dtype bfloat16; k and v
// staged widened to fp32 by the caller) the tile computes the JAX
// package's XLA attention at that dtype (models/layers.py
// SerializedAttention): q * scale rounded to bf16 (scale, a bf16 value,
// given by the wrapper), fp32 logits and softmax, the normalised
// probabilities rounded to bf16 before the product with v, which sums in
// fp32, and the output rounded to bf16 once. Every operand is then a bf16
// value, so each product is one TF32 pass (mma1); the exps use expf, and
// the rows are normalised (an IEEE division by the row sum, as softmax
// divides) before P v, where the fp32 tile scales after it.
//
// A C fragment of one product is the A fragment of the next with no
// shuffle: the k index of an 8-wide step is permuted so that A column t is
// element 2t and column t + 4 is element 2t + 1, which is where the
// accumulator holds them. Shared-memory rows are padded (Layout) so that
// every fragment load is free of bank conflicts. A patch with no valid key
// gets uniform weights (every logit is -1e9), as the plain version does.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"

namespace r3dl {

constexpr int kMaxP = 128;
constexpr float kNegInf = -1e9f;
constexpr unsigned kFull = 0xffffffffu;

// An A fragment (16 x 8) split once, used against several B fragments.
struct FragA {
  Split s[4];
  __device__ __forceinline__ FragA(float a0, float a1, float a2, float a3)
      : s{split(a0), split(a1), split(a2), split(a3)} {}
};

// d += a b in 3xTF32; b0, b1: this lane's B fragment in fp32 (the
// fragment layouts are in tc_common.cuh).
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0,
                                     float b1) {
  const Split b[2] = {split(b0), split(b1)};
  mma3(d, a.s, b);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// Row strides in floats. Dh + 4: a load at (row r, col c) or at
// (row 2c, col r) hits 32 distinct banks. SB: (row c, col r).
template <int Dh>
struct Layout {
  static constexpr int S = Dh + 4;
  static constexpr int SB = Dh % 16 == 8 ? Dh : Dh + 8;   // 8 or 24 mod 32
  static constexpr int DS = kMaxP + 4;
};

// This warp's query rows row0 + lane / 4 and row0 + lane / 4 + 8 (row0 < P,
// a multiple of 16) of one patch. q, out: the patch's (P, Dh) rows in
// global memory; sk, sv: its k and v rows in shared memory (fp32) at stride
// Layout<Dh>::S, rows P..(P rounded up to 8)-1 zero; smask: its key mask.
// kDrop: sbits holds W keep-bit words a row (bit j % 32 of word j / 32 is
// key j), inv_keep = 1 / (1 - rate), lse the patch's (P,) row logsumexp.
// kAllTiles (P > 120: all 16 key tiles): the key-tile loops have no
// bounds test, so the tiles' independent product chains are one basic
// block that the compiler interleaves (with a test per tile, one warp
// waits out each chain's latency in turn); attend_rows picks it. T: the
// type of q and out (float: 3xTF32; bf16: one pass, see above).
template <int Dh, bool kDrop, bool kAllTiles, typename T>
__device__ __forceinline__ void attend_tiles(
    const T* __restrict__ q, T* __restrict__ out, float* __restrict__ lse,
    const float* sk, const float* sv, const unsigned char* smask,
    const uint32_t* sbits, int W, int row0, int P, float scale,
    float inv_keep) {
  constexpr bool kOne = !std::is_same<T, float>::value;
  static_assert(!(kOne && kDrop), "no bf16 path with dropout");
  constexpr int S = Layout<Dh>::S;
  constexpr int KD = Dh / 8;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int nt = kAllTiles ? kMaxP / 8 : ((P + 7) & ~7) >> 3;  // key tiles
  const int r0 = row0 + gr, r1 = r0 + 8;   // this lane's query rows
  const T* q0 = q + (long long)r0 * Dh;
  const T* q1 = q + (long long)r1 * Dh;
  // q * scale; rounded to bf16 on the bf16 path
  auto qs = [&](T v) {
    if constexpr (kOne) return round_bf16(widen(v) * scale);
    else return v * scale;
  };

  // S = (q scale) k^T: s[n] is the 16 x 8 tile of keys 8n..8n+7. The
  // head-dim loop stays a loop: unrolled, the tile's straight-line code is
  // too long for the instruction cache, and K1, one block per SM once a
  // call, then fetches all of it cold after the forward's other kernels
  // (scripts/torch_k1_k3_plans.py times it so)
  float s[kMaxP / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxP / 8; ++n)
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 1
  for (int kk = 0; kk < KD; ++kk) {
    const int d = kk * 8 + t;
    const float a0 = r0 < P ? qs(q0[d]) : 0.f;
    const float a1 = r1 < P ? qs(q1[d]) : 0.f;
    const float a2 = r0 < P ? qs(q0[d + 4]) : 0.f;
    const float a3 = r1 < P ? qs(q1[d + 4]) : 0.f;
    if constexpr (kOne) {
#pragma unroll
      for (int n = 0; n < kMaxP / 8; ++n) {
        if (kAllTiles || n < nt) {
          const float* kr = sk + (n * 8 + gr) * S + kk * 8 + t;
          mma1(s[n], a0, a1, a2, a3, kr[0], kr[4]);
        }
      }
    } else {
      const FragA a(a0, a1, a2, a3);
#pragma unroll
      for (int n = 0; n < kMaxP / 8; ++n) {
        if (kAllTiles || n < nt) {
          const float* kr = sk + (n * 8 + gr) * S + kk * 8 + t;
          mma3(s[n], a, kr[0], kr[4]);
        }
      }
    }
  }

  // masked logits, row max, exps and row sums (over every key), then, with
  // dropout, the dropped exps in place
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < kMaxP / 8; ++n) {
    if (kAllTiles || n < nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * t + (e & 1);
        const float x = j >= P ? -INFINITY : smask[j] ? s[n][e] : kNegInf;
        s[n][e] = x;
        if (e < 2) m0 = fmaxf(m0, x);
        else m1 = fmaxf(m1, x);
      }
    }
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
  const uint32_t* b0 = sbits + r0 * W;
  const uint32_t* b1 = sbits + r1 * W;
#pragma unroll
  for (int n = 0; n < kMaxP / 8; ++n) {
    if (kAllTiles || n < nt) {
      uint32_t w0 = 0u, w1 = 0u;
      if constexpr (kDrop) {
        const int sh = (n & 3) * 8 + 2 * t;
        w0 = b0[n >> 2] >> sh;
        w1 = b1[n >> 2] >> sh;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float z = s[n][e] - (e < 2 ? m0 : m1);
        const float x = kOne ? expf(z) : __expf(z);
        if (e < 2) l0 += x;
        else l1 += x;
        if constexpr (kDrop) {
          const uint32_t w = e < 2 ? w0 : w1;
          s[n][e] = (w >> (e & 1)) & 1u ? x : 0.f;
        } else {
          s[n][e] = x;
        }
      }
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if constexpr (kOne) {
    // the probabilities, rounded to bf16 as the reference casts them
#pragma unroll
    for (int n = 0; n < kMaxP / 8; ++n) {
      if (kAllTiles || n < nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = round_bf16(s[n][e] / (e < 2 ? l0 : l1));
      }
    }
  }

  // out = (kept) exps v: the S tile's C fragment is the A fragment of its
  // 8 keys, key 2t as column t and key 2t + 1 as column t + 4
  float o[KD][4];
#pragma unroll
  for (int m = 0; m < KD; ++m) o[m][0] = o[m][1] = o[m][2] = o[m][3] = 0.f;
#pragma unroll
  for (int n = 0; n < kMaxP / 8; ++n) {
    if (kAllTiles || n < nt) {
      if constexpr (kOne) {
#pragma unroll
        for (int m = 0; m < KD; ++m) {
          const float* vr = sv + (n * 8 + 2 * t) * S + m * 8 + gr;
          mma1(o[m], s[n][0], s[n][2], s[n][1], s[n][3], vr[0], vr[S]);
        }
      } else {
        const FragA a(s[n][0], s[n][2], s[n][1], s[n][3]);
#pragma unroll
        for (int m = 0; m < KD; ++m) {
          const float* vr = sv + (n * 8 + 2 * t) * S + m * 8 + gr;
          mma3(o[m], a, vr[0], vr[S]);
        }
      }
    }
  }
  const float f0 = kOne ? 1.f : inv_keep / l0;
  const float f1 = kOne ? 1.f : inv_keep / l1;
  T* o0 = out + (long long)r0 * Dh;
  T* o1 = out + (long long)r1 * Dh;
#pragma unroll
  for (int m = 0; m < KD; ++m) {
    const int c = m * 8 + 2 * t;
    if (r0 < P) {
      o0[c] = narrow<T>(o[m][0] * f0);
      o0[c + 1] = narrow<T>(o[m][1] * f0);
    }
    if (r1 < P) {
      o1[c] = narrow<T>(o[m][2] * f1);
      o1[c + 1] = narrow<T>(o[m][3] * f1);
    }
  }
  if constexpr (kDrop) {
    if (t == 0) {
      if (r0 < P) lse[r0] = m0 + logf(l0);
      if (r1 < P) lse[r1] = m1 + logf(l1);
    }
  }
}

template <int Dh, bool kDrop, typename T = float>
__device__ __forceinline__ void attend_rows(
    const T* __restrict__ q, T* __restrict__ out, float* __restrict__ lse,
    const float* sk, const float* sv, const unsigned char* smask,
    const uint32_t* sbits, int W, int row0, int P, float scale,
    float inv_keep) {
  if (P > kMaxP - 8)
    attend_tiles<Dh, kDrop, true, T>(q, out, lse, sk, sv, smask, sbits, W,
                                     row0, P, scale, inv_keep);
  else
    attend_tiles<Dh, kDrop, false, T>(q, out, lse, sk, sv, smask, sbits, W,
                                      row0, P, scale, inv_keep);
}

}  // namespace r3dl
