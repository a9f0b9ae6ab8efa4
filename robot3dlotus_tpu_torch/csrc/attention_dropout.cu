// K5 / K6: serialized patch attention with attention dropout, training
//   a   = softmax(where(key_valid[g], (q[g, h] * scale) k[g, h]^T, -1e9))
//   out = where(keep, a / (1 - rate), 0) v[g, h]
// q, k, v, out, g, dq, dk, dv: (G, H, P, Dh) fp32; key_valid: (G, P) bool;
// lse: (G, H, P) fp32, the row logsumexp of the masked logits; bits:
// (G, H, P, ceil(P / 32)) uint32, bit j % 32 of word j / 32 of row i is
// keep[i, j].
//
// Replaces robot3dlotus_tpu/ops/pallas_attention.py
// `patch_attention_dropout`: `_drop_forward` (_attn_drop_fwd_kernel, K5)
// and `_drop_backward` (_attn_drop_bwd_kernel, K6). As there, the
// probabilities are fp32, keep = bits >= rate * 2^32 and kept probabilities
// are scaled by 1 / (1 - rate). Unlike there, the forward writes what the
// backward needs instead of the backward recomputing it: K5 writes out, the
// row logsumexp and the keep mask at 1 bit per (query, key) pair, and K6
// reads them (FlashAttention-2's split). The JAX dataflow writes nothing
// of size P x P; this one writes P x P bits (43 MB per release step).
//
// Random bits: the TPU seeded its hardware generator per (patch, head).
// Here a Philox4x32-10 counter-based generator: key (seed, g * H + h),
// counter (e / 4, 0, 0, 0) with e = i * P + j the element's index in the
// (P, P) tile, word e % 4 of the output (ops/attention.py has the same
// generator in PyTorch). Only K5 runs it: one word of 32 keep bits per
// thread and pass, before the products; K6 reads the bits.
//
// Bound: the products run on the tensor cores as 3xTF32 (below), 3 TF32
// products for each fp32 one: the forward's 4 P^2 Dh flops per (g, h) and
// the backward's 10 P^2 Dh at 3 x that over 494.7 TFLOP/s, against the
// bytes moved (q, k, v, out, lse, bits; the backward also g, dq, dk, dv);
// at the release shapes the bytes bound both. K5 also does the Philox
// integer work, P^2 / 4 generator calls of 10 rounds per (g, h), each
// round two 32 x 32 -> 64-bit multiplies (four 32-bit results) and two
// three-input XORs: 60 integer operations a call, at 64 a clock on each
// of the H100's 132 SMs (16.7 T/s at 1.98 GHz) a floor of its own that
// exceeds K5's bytes at the release shapes (P = 128, rate > 0).
// Design: one block of 8 warps owns one whole (g, h) patch (P <= 128), so
// nothing crosses blocks and there are no atomics. Every product is
// mma.sync.m16n8k8 TF32 with each fp32 operand split as x = big + small
// and big*big + big*small + small*big summed in fp32 (tc_common.cuh, as in
// the conv kernels): errors at the fp32 level, where one TF32 product
// would miss the 1e-4 bar.
// K5: warp w owns query rows 16w..16w+15 and runs attention_tile.cuh's
// attend_rows on them, the tile K1 (attention.cu) runs too: S for all P
// keys in registers, the row max, exp and sum once, the kept exps times v,
// scaled by 1 / ((1 - rate) l) at the end.
// K6: phase 1, warp w owns keys 16w..16w+15 and walks the queries in
// 8-query steps: S^T = k (q scale)^T and dP^T = v g^T, then
// p = exp(S - lse), da = keep dP / (1 - rate), ds = p (da - D) with
// D = g . out, and dv += (keep p / (1 - rate))^T g, dk += ds^T (q scale)
// in registers; ds goes to shared memory (128 x 132 floats). Phase 2, warp
// w owns queries 16w..: dq = ds k scale. Five products, each computed
// once; 105 KB of shared memory, two blocks an SM.
//
// A masked key's logit is the constant -1e9, so its ds is 0: the exact
// gradient. The JAX kernel leaves ds = a (da - D) there, which differs only
// in a patch with no valid key (uniform a); the model never sends a
// cotangent into such a patch (its rows are dead slots). In such a patch
// lse = -1e9 + log P rounds to -1e9 in fp32, so K6 takes p = 1 / P there
// instead of exp(S - lse).
//
// bf16 (r3dl_attention_dropout_fwd_bf16 / _bwd_bf16, training under
// compute_dtype bfloat16): q, k, v, out, g, dq, dk, dv bf16; lse and the
// bits as above.
// K5 at bf16 (attn_drop_fwd16_kernel) runs on the bf16 tensor cores: the
// block stages its patch's k and v as they are with 16-byte cp.async
// (attention_tile.cuh stage_rows16, 22.5 KB of shared memory with the
// bits at Dh = 32, against 38 KB of widened fp32 rows before), generates
// the keep bits while they land (a whole word of 8 Philox calls unrolled
// per thread where the 32 keys start on a generator call, so the calls'
// chains interleave), and its warps run attend_rows16, the tile K1 runs
// at bf16: S and P v as bf16 mma.sync.m16n8k16 with ldmatrix fragments,
// exact bf16 products in fp32 sums, so the results are the widened
// TF32 design's up to the order of summation. It rounds where
// K1's bf16 path rounds (q * scale to bf16, scale a bf16 value from the
// wrapper; the dropped probabilities to bf16 before P v; the output
// once), so K5 at rate 0 is K1 bit for bit. The Philox work bounds it at
// the release shapes; the tile's own work (S, softmax, P v) takes about as
// long, and two blocks an SM, in different phases, overlap the two.
// K6 at bf16 stages the rows widened to fp32 (the same shared-memory
// layout) and keeps the fp32 kernel's 3xTF32 products, exact on the bf16
// operands; it computes as the Pallas body `_attn_drop_bwd_kernel` does,
// in fp32: p from the saved lse and the bf16 q * scale, the unrounded
// probabilities in dv and ds, D = g . out from K5's bf16 output, and dq,
// dk, dv each rounded to bf16 once.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"

namespace {

using r3dl::FragA;
using r3dl::kFull;
using r3dl::kMaxP;
using r3dl::Layout;
using r3dl::mma3;

constexpr int kWarps = 8;                 // 8 warps x 16 rows = kMaxP
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxWords = kMaxP / 32;     // bit words per row

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += W0;
    k1 += W1;
  }
  return c;
}

__device__ __forceinline__ uint4 philox_at(long long c, uint32_t seed,
                                           uint32_t stream) {
  return philox4x32_10(make_uint4((uint32_t)c, (uint32_t)(c >> 32), 0u, 0u),
                       seed, stream);
}

__device__ __forceinline__ uint32_t word_of(const uint4& r, int w) {
  return w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
}

// Keep bits of keys j0..j0+n-1 (n <= 32) of query row i: bit j - j0.
__device__ uint32_t keep_word(int i, int j0, int n, int P, uint32_t seed,
                              uint32_t stream, uint32_t thresh) {
  if (thresh == 0u) return n == 32 ? kFull : (1u << n) - 1u;
  const long long e0 = (long long)i * P + j0;
  uint32_t word = 0u;
  if ((e0 & 3) == 0 && (n & 3) == 0) {    // whole generator calls
    for (int c = 0; c < n / 4; ++c) {
      const uint4 r = philox_at((e0 >> 2) + c, seed, stream);
      word |= (uint32_t)(r.x >= thresh) << (4 * c) |
              (uint32_t)(r.y >= thresh) << (4 * c + 1) |
              (uint32_t)(r.z >= thresh) << (4 * c + 2) |
              (uint32_t)(r.w >= thresh) << (4 * c + 3);
    }
    return word;
  }
  long long cur = -1;
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  for (int j = 0; j < n; ++j) {
    const long long e = e0 + j;
    if ((e >> 2) != cur) {
      cur = e >> 2;
      r = philox_at(cur, seed, stream);
    }
    word |= (uint32_t)(word_of(r, (int)(e & 3)) >= thresh) << j;
  }
  return word;
}

// keep_word for the bf16 kernel: a whole word of 8 generator calls,
// unrolled so that their chains interleave, where the 32 keys start on a
// call (P a multiple of 4); else keep_word. (The fp32 kernel keeps
// keep_word: it sits at the 128-register cap.)
__device__ __forceinline__ uint32_t keep_word_fast(int i, int j0, int n,
                                                   int P, uint32_t seed,
                                                   uint32_t stream,
                                                   uint32_t thresh) {
  const long long e0 = (long long)i * P + j0;
  if (n != 32 || (e0 & 3) || thresh == 0u)
    return keep_word(i, j0, n, P, seed, stream, thresh);
  uint32_t word = 0u;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const uint4 r = philox_at((e0 >> 2) + c, seed, stream);
    word |= (uint32_t)(r.x >= thresh) << (4 * c) |
            (uint32_t)(r.y >= thresh) << (4 * c + 1) |
            (uint32_t)(r.z >= thresh) << (4 * c + 2) |
            (uint32_t)(r.w >= thresh) << (4 * c + 3);
  }
  return word;
}

// rows [0, P8) of a (P, Dh) slice into shared memory at stride S, times
// mul (bf16 rows: widened, and the product rounded to bf16, which leaves
// them as they are at mul = 1); rows P..P8-1 zero (the ragged 8-row tile)
template <int Dh, typename T>
__device__ __forceinline__ void load_rows(float* dst, int S,
                                          const T* __restrict__ src, int P,
                                          int P8, float mul) {
  for (int i = threadIdx.x; i < P8 * Dh; i += kThreads) {
    const int r = i / Dh, d = i - r * Dh;
    float x = 0.f;
    if (r < P) {
      x = r3dl::widen(src[i]) * mul;
      if constexpr (!std::is_same<T, float>::value) x = r3dl::round_bf16(x);
    }
    dst[r * S + d] = x;
  }
}

template <int Dh>
size_t fwd_smem() {
  return (2 * (size_t)kMaxP * Layout<Dh>::S) * sizeof(float) +
         (size_t)kMaxP * kMaxWords * sizeof(uint32_t);
}

template <int Dh>
__global__ void __launch_bounds__(kThreads, 2)
attn_drop_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const unsigned char* __restrict__ kv,
                     float* __restrict__ out, float* __restrict__ lse,
                     uint32_t* __restrict__ bits, int H, int P, float scale,
                     uint32_t seed, uint32_t thresh, float inv_keep) {
  constexpr int S = Layout<Dh>::S;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kMaxP * S;
  uint32_t* sbits = reinterpret_cast<uint32_t*>(sv + kMaxP * S);
  __shared__ unsigned char smask[kMaxP];

  const int W = (P + 31) >> 5;
  const int P8 = (P + 7) & ~7;
  const long long gh = blockIdx.x;
  const long long base = gh * P * Dh;
  const int tid = threadIdx.x;
  load_rows<Dh, float>(sk, S, k + base, P, P8, 1.f);
  load_rows<Dh, float>(sv, S, v + base, P, P8, 1.f);
  if (tid < P) smask[tid] = kv[gh / H * P + tid];
  for (int w = tid; w < P * W; w += kThreads) {
    const int i = w / W, j0 = (w - i * W) * 32;
    const uint32_t word =
        keep_word(i, j0, min(32, P - j0), P, seed, (uint32_t)gh, thresh);
    sbits[w] = word;
    bits[gh * P * W + w] = word;
  }
  __syncthreads();

  const int warp = tid >> 5;
  if (warp * 16 >= P) return;
  r3dl::attend_rows<Dh, true>(q + base, out + base, lse + gh * P, sk, sv,
                              smask, sbits, W, warp * 16, P, scale,
                              inv_keep);
}

// K5 at bf16 (the header): k and v rows at Layout16's stride, rows
// P..P16-1 zero, then the keep bits
template <int Dh>
size_t fwd16_smem() {
  return 2 * (size_t)kMaxP * r3dl::Layout16<Dh>::S * sizeof(r3dl::bf16) +
         (size_t)kMaxP * kMaxWords * sizeof(uint32_t);
}

template <int Dh>
__global__ void __launch_bounds__(kThreads, 2)
attn_drop_fwd16_kernel(const r3dl::bf16* __restrict__ q,
                       const r3dl::bf16* __restrict__ k,
                       const r3dl::bf16* __restrict__ v,
                       const unsigned char* __restrict__ kv,
                       r3dl::bf16* __restrict__ out, float* __restrict__ lse,
                       uint32_t* __restrict__ bits, int H, int P,
                       float scale, uint32_t seed, uint32_t thresh,
                       float inv_keep) {
  constexpr int S = r3dl::Layout16<Dh>::S;
  extern __shared__ float4 smem4[];
  r3dl::bf16* sk = reinterpret_cast<r3dl::bf16*>(smem4);
  r3dl::bf16* sv = sk + kMaxP * S;
  uint32_t* sbits = reinterpret_cast<uint32_t*>(sv + kMaxP * S);
  __shared__ unsigned char smask[kMaxP];

  const int W = (P + 31) >> 5;
  const int P16 = (P + 15) & ~15;
  const long long gh = blockIdx.x;
  const long long base = gh * P * Dh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  r3dl::stage_rows16<Dh>(sk, k + base, P, P16, tid, kThreads);
  r3dl::stage_rows16<Dh>(sv, v + base, P, P16, tid, kThreads);
  r3dl::cp_async_commit();
  if (tid < P) smask[tid] = kv[gh / H * P + tid];
  // this lane's two q rows into L1, and the keep bits, while k and v land
  const int qc = min(8 * (lane & 3), Dh - 1);
  for (int r = warp * 16 + (lane >> 2); r < min(P, warp * 16 + 16); r += 8)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(q + base + r * Dh + qc));
  for (int w = tid; w < P * W; w += kThreads) {
    const int i = w / W, j0 = (w - i * W) * 32;
    const uint32_t word = keep_word_fast(i, j0, min(32, P - j0), P, seed,
                                         (uint32_t)gh, thresh);
    sbits[w] = word;
    bits[gh * P * W + w] = word;
  }
  r3dl::cp_async_wait<0>();
  __syncthreads();

  if (warp * 16 >= P) return;
  r3dl::attend_rows16<Dh, true>(q + base, out + base, lse + gh * P, sk, sv,
                                smask, sbits, W, warp * 16, P, scale,
                                inv_keep);
}

template <int Dh>
size_t bwd_smem() {
  using L = Layout<Dh>;
  return ((size_t)kMaxP * L::DS + 2 * (size_t)kMaxP * L::S + 2 * kMaxP) *
             sizeof(float) +
         (size_t)kMaxP * kMaxWords * sizeof(uint32_t);
}

// 8-query tiles per phase-1 step of K6: one keeps the Dh = 32 instance
// within 128 registers; two spill 148 bytes and run 19% slower on an H100
// SXM (scripts/attention_dropout_variants.py)
constexpr int kChunk = 1;

template <int Dh, typename T>
__global__ void __launch_bounds__(kThreads, 2)
attn_drop_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const unsigned char* __restrict__ kv,
                     const T* __restrict__ o,
                     const float* __restrict__ lse,
                     const uint32_t* __restrict__ bits,
                     const T* __restrict__ gout, T* __restrict__ dq,
                     T* __restrict__ dk, T* __restrict__ dv, int H,
                     int P, float scale, float inv_keep) {
  using r3dl::narrow;
  using r3dl::widen;
  using L = Layout<Dh>;
  constexpr int S = L::S, SB = L::SB, DS = L::DS;
  constexpr int KD = Dh / 8;
  static_assert(kMaxP * SB <= 2 * kMaxP * S, "k fits where q and g were");
  extern __shared__ float smem[];
  float* sds = smem;                  // ds[query][key], stride DS
  float* sq = sds + kMaxP * DS;       // q * scale (phase 1), k (phase 2)
  float* sg = sq + kMaxP * S;
  float* slse = sg + kMaxP * S;
  float* sD = slse + kMaxP;           // D_i = g_i . out_i
  uint32_t* sbits = reinterpret_cast<uint32_t*>(sD + kMaxP);
  __shared__ unsigned char smask[kMaxP];

  const int W = (P + 31) >> 5;
  const int P8 = (P + 7) & ~7;
  const long long gh = blockIdx.x;
  const long long base = gh * P * Dh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  load_rows<Dh, T>(sq, S, q + base, P, P8, scale);
  load_rows<Dh, T>(sg, S, gout + base, P, P8, 1.f);
  for (int i = tid; i < P * W; i += kThreads) sbits[i] = bits[gh * P * W + i];
  if (tid < kMaxP) slse[tid] = tid < P ? lse[gh * P + tid] : 0.f;
  for (int r = warp; r < kMaxP; r += kWarps) {   // D, one row per warp
    float x = 0.f;
    if (r < P && lane < Dh)
      x = widen(gout[base + (long long)r * Dh + lane]) *
          widen(o[base + (long long)r * Dh + lane]);
#pragma unroll
    for (int sh = 16; sh; sh >>= 1) x += __shfl_xor_sync(kFull, x, sh);
    if (lane == 0) sD[r] = x;
  }
  bool valid = false;
  if (tid < P) valid = smask[tid] = kv[gh / H * P + tid];
  const bool any_valid = __syncthreads_or(valid);

  // ---- phase 1: warp w owns keys 16w..16w+15 ----
  const int j0 = warp * 16 + gr, j1 = j0 + 8;   // this lane's keys
  if (warp * 16 < P) {
    const T* k0 = k + base + (long long)j0 * Dh;
    const T* k1 = k + base + (long long)j1 * Dh;
    const T* v0 = v + base + (long long)j0 * Dh;
    const T* v1 = v + base + (long long)j1 * Dh;
    float ka[KD][4], va[KD][4];   // A fragments of this warp's k and v rows
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int d = kk * 8 + t;
      ka[kk][0] = j0 < P ? widen(k0[d]) : 0.f;
      ka[kk][1] = j1 < P ? widen(k1[d]) : 0.f;
      ka[kk][2] = j0 < P ? widen(k0[d + 4]) : 0.f;
      ka[kk][3] = j1 < P ? widen(k1[d + 4]) : 0.f;
      va[kk][0] = j0 < P ? widen(v0[d]) : 0.f;
      va[kk][1] = j1 < P ? widen(v1[d]) : 0.f;
      va[kk][2] = j0 < P ? widen(v0[d + 4]) : 0.f;
      va[kk][3] = j1 < P ? widen(v1[d + 4]) : 0.f;
    }
    const bool val0 = j0 < P && smask[j0], val1 = j1 < P && smask[j1];
    const float inv_p = 1.f / (float)P;
    float dka[KD][4], dva[KD][4];
#pragma unroll
    for (int m = 0; m < KD; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[m][e] = dva[m][e] = 0.f;

    for (int c0 = 0; c0 < P8; c0 += 8 * kChunk) {
      // S^T = k (q scale)^T and dP^T = v g^T on queries c0..c0+15
      float s[kChunk][4], dp[kChunk][4];
#pragma unroll
      for (int n = 0; n < kChunk; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const FragA ak(ka[kk][0], ka[kk][1], ka[kk][2], ka[kk][3]);
        const FragA av(va[kk][0], va[kk][1], va[kk][2], va[kk][3]);
#pragma unroll
        for (int n = 0; n < kChunk; ++n) {
          if (c0 + 8 * n < P8) {
            const int off = (c0 + 8 * n + gr) * S + kk * 8 + t;
            mma3(s[n], ak, sq[off], sq[off + 4]);
            mma3(dp[n], av, sg[off], sg[off + 4]);
          }
        }
      }
      // p, the dropped p, ds; ds to shared memory for phase 2
#pragma unroll
      for (int n = 0; n < kChunk; ++n) {
        if (c0 + 8 * n < P8) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + 8 * n + 2 * t + (e & 1);    // query
            const int j = e < 2 ? j0 : j1;                 // key
            const bool val = e < 2 ? val0 : val1;
            const bool live = c < P && j < P;
            const bool kp =
                live && ((sbits[c * W + (j >> 5)] >> (j & 31)) & 1u);
            const float p = !any_valid ? inv_p
                            : val      ? __expf(s[n][e] - slse[c])
                                       : 0.f;
            const float da = kp ? dp[n][e] * inv_keep : 0.f;
            const float ds = live && val ? p * (da - sD[c]) : 0.f;
            sds[c * DS + j] = ds;
            s[n][e] = kp ? p * inv_keep : 0.f;
            dp[n][e] = ds;
          }
        }
      }
      // dv += (dropped p)^T g, dk += ds^T (q scale): C fragments as A,
      // query 2t as column t and 2t + 1 as column t + 4
#pragma unroll
      for (int n = 0; n < kChunk; ++n) {
        if (c0 + 8 * n < P8) {
          const FragA apd(s[n][0], s[n][2], s[n][1], s[n][3]);
          const FragA ads(dp[n][0], dp[n][2], dp[n][1], dp[n][3]);
#pragma unroll
          for (int m = 0; m < KD; ++m) {
            const int off = (c0 + 8 * n + 2 * t) * S + m * 8 + gr;
            mma3(dva[m], apd, sg[off], sg[off + S]);
            mma3(dka[m], ads, sq[off], sq[off + S]);
          }
        }
      }
    }
    T* dk0 = dk + base + (long long)j0 * Dh;
    T* dk1 = dk + base + (long long)j1 * Dh;
    T* dv0 = dv + base + (long long)j0 * Dh;
    T* dv1 = dv + base + (long long)j1 * Dh;
#pragma unroll
    for (int m = 0; m < KD; ++m) {
      const int c = m * 8 + 2 * t;
      if (j0 < P) {
        dk0[c] = narrow<T>(dka[m][0]);
        dk0[c + 1] = narrow<T>(dka[m][1]);
        dv0[c] = narrow<T>(dva[m][0]);
        dv0[c + 1] = narrow<T>(dva[m][1]);
      }
      if (j1 < P) {
        dk1[c] = narrow<T>(dka[m][2]);
        dk1[c + 1] = narrow<T>(dka[m][3]);
        dv1[c] = narrow<T>(dva[m][2]);
        dv1[c + 1] = narrow<T>(dva[m][3]);
      }
    }
  }
  __syncthreads();

  // ---- phase 2: warp w owns queries 16w..16w+15; dq = ds k scale ----
  load_rows<Dh, T>(sq, SB, k + base, P, P8, 1.f);   // k where q and g were
  __syncthreads();
  if (warp * 16 >= P) return;
  const int r0 = warp * 16 + gr, r1 = r0 + 8;
  float acc[KD][4];
#pragma unroll
  for (int m = 0; m < KD; ++m)
    acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
  for (int kk = 0; kk < P8 / 8; ++kk) {
    const float* d0 = sds + r0 * DS + kk * 8 + t;
    const float* d1 = sds + r1 * DS + kk * 8 + t;
    const FragA a(d0[0], d1[0], d0[4], d1[4]);
#pragma unroll
    for (int m = 0; m < KD; ++m) {
      const float* kr = sq + (kk * 8 + t) * SB + m * 8 + gr;
      mma3(acc[m], a, kr[0], kr[4 * SB]);
    }
  }
  T* q0 = dq + base + (long long)r0 * Dh;
  T* q1 = dq + base + (long long)r1 * Dh;
#pragma unroll
  for (int m = 0; m < KD; ++m) {
    const int c = m * 8 + 2 * t;
    if (r0 < P) {
      q0[c] = narrow<T>(acc[m][0] * scale);
      q0[c + 1] = narrow<T>(acc[m][1] * scale);
    }
    if (r1 < P) {
      q1[c] = narrow<T>(acc[m][2] * scale);
      q1[c + 1] = narrow<T>(acc[m][3] * scale);
    }
  }
}

template <int Dh, typename T>
int launch_fwd(const T* q, const T* k, const T* v, const unsigned char* kv,
               T* out, float* lse, uint32_t* bits, int G, int H, int P,
               float scale, uint32_t seed, uint32_t thresh, float inv_keep,
               cudaStream_t stream) {
  const unsigned grid = (unsigned)((long long)G * H);
  if constexpr (std::is_same<T, float>::value) {
    static const cudaError_t attr =
        r3dl::allow_smem(attn_drop_fwd_kernel<Dh>, fwd_smem<Dh>());
    if (attr != cudaSuccess) return (int)attr;
    attn_drop_fwd_kernel<Dh><<<grid, kThreads, fwd_smem<Dh>(), stream>>>(
        q, k, v, kv, out, lse, bits, H, P, scale, seed, thresh, inv_keep);
  } else {
    static const cudaError_t attr =
        r3dl::allow_smem(attn_drop_fwd16_kernel<Dh>, fwd16_smem<Dh>());
    if (attr != cudaSuccess) return (int)attr;
    attn_drop_fwd16_kernel<Dh><<<grid, kThreads, fwd16_smem<Dh>(), stream>>>(
        q, k, v, kv, out, lse, bits, H, P, scale, seed, thresh, inv_keep);
  }
  return (int)cudaGetLastError();
}

template <int Dh, typename T>
int launch_bwd(const T* q, const T* k, const T* v, const unsigned char* kv,
               const T* out, const float* lse, const uint32_t* bits,
               const T* gout, T* dq, T* dk, T* dv, int G, int H, int P,
               float scale, float inv_keep, cudaStream_t stream) {
  static const cudaError_t attr =
      r3dl::allow_smem(attn_drop_bwd_kernel<Dh, T>, bwd_smem<Dh>());
  if (attr != cudaSuccess) return (int)attr;
  attn_drop_bwd_kernel<Dh, T><<<(unsigned)((long long)G * H), kThreads,
                                bwd_smem<Dh>(), stream>>>(
      q, k, v, kv, out, lse, bits, gout, dq, dk, dv, H, P, scale, inv_keep);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const T* q, const T* k, const T* v, const unsigned char* kv, T* out,
        float* lse, unsigned* bits, int G, int H, int P, int Dh, float scale,
        unsigned seed, unsigned thresh, float inv_keep, cudaStream_t stream) {
  // the bf16 kernel: k, v staged 16 bytes at a time, q and out in pairs
  if (P < 1 || P > kMaxP ||
      (!std::is_same<T, float>::value &&
       ((((uintptr_t)k | (uintptr_t)v) & 15) ||
        (((uintptr_t)q | (uintptr_t)out) & 3))))
    return (int)cudaErrorInvalidValue;
  if ((long long)G * H == 0) return (int)cudaGetLastError();
  switch (Dh) {
    case 8: return launch_fwd<8, T>(q, k, v, kv, out, lse, bits, G, H, P,
                                    scale, seed, thresh, inv_keep, stream);
    case 16: return launch_fwd<16, T>(q, k, v, kv, out, lse, bits, G, H, P,
                                      scale, seed, thresh, inv_keep, stream);
    case 24: return launch_fwd<24, T>(q, k, v, kv, out, lse, bits, G, H, P,
                                      scale, seed, thresh, inv_keep, stream);
    case 32: return launch_fwd<32, T>(q, k, v, kv, out, lse, bits, G, H, P,
                                      scale, seed, thresh, inv_keep, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int bwd(const T* q, const T* k, const T* v, const unsigned char* kv,
        const T* out, const float* lse, const unsigned* bits, const T* gout,
        T* dq, T* dk, T* dv, int G, int H, int P, int Dh, float scale,
        float inv_keep, cudaStream_t stream) {
  if (P < 1 || P > kMaxP) return (int)cudaErrorInvalidValue;
  if ((long long)G * H == 0) return (int)cudaGetLastError();
  switch (Dh) {
    case 8: return launch_bwd<8, T>(q, k, v, kv, out, lse, bits, gout, dq,
                                    dk, dv, G, H, P, scale, inv_keep, stream);
    case 16: return launch_bwd<16, T>(q, k, v, kv, out, lse, bits, gout, dq,
                                      dk, dv, G, H, P, scale, inv_keep,
                                      stream);
    case 24: return launch_bwd<24, T>(q, k, v, kv, out, lse, bits, gout, dq,
                                      dk, dv, G, H, P, scale, inv_keep,
                                      stream);
    case 32: return launch_bwd<32, T>(q, k, v, kv, out, lse, bits, gout, dq,
                                      dk, dv, G, H, P, scale, inv_keep,
                                      stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int r3dl_attention_dropout_fwd(
    const float* q, const float* k, const float* v, const unsigned char* kv,
    float* out, float* lse, unsigned* bits, int G, int H, int P, int Dh,
    float scale, unsigned seed, unsigned thresh, float inv_keep,
    cudaStream_t stream) {
  return fwd<float>(q, k, v, kv, out, lse, bits, G, H, P, Dh, scale, seed,
                    thresh, inv_keep, stream);
}

extern "C" int r3dl_attention_dropout_bwd(
    const float* q, const float* k, const float* v, const unsigned char* kv,
    const float* out, const float* lse, const unsigned* bits,
    const float* gout, float* dq, float* dk, float* dv, int G, int H, int P,
    int Dh, float scale, float inv_keep, cudaStream_t stream) {
  return bwd<float>(q, k, v, kv, out, lse, bits, gout, dq, dk, dv, G, H, P,
                    Dh, scale, inv_keep, stream);
}

// The same with bf16 q, k, v, out (and g, dq, dk, dv); lse and bits as
// above; scale a bf16 value; the forward takes k and v 16-byte aligned, q
// and out 4-byte.
extern "C" int r3dl_attention_dropout_fwd_bf16(
    const r3dl::bf16* q, const r3dl::bf16* k, const r3dl::bf16* v,
    const unsigned char* kv, r3dl::bf16* out, float* lse, unsigned* bits,
    int G, int H, int P, int Dh, float scale, unsigned seed, unsigned thresh,
    float inv_keep, cudaStream_t stream) {
  return fwd<r3dl::bf16>(q, k, v, kv, out, lse, bits, G, H, P, Dh, scale,
                         seed, thresh, inv_keep, stream);
}

extern "C" int r3dl_attention_dropout_bwd_bf16(
    const r3dl::bf16* q, const r3dl::bf16* k, const r3dl::bf16* v,
    const unsigned char* kv, const r3dl::bf16* out, const float* lse,
    const unsigned* bits, const r3dl::bf16* gout, r3dl::bf16* dq,
    r3dl::bf16* dk, r3dl::bf16* dv, int G, int H, int P, int Dh, float scale,
    float inv_keep, cudaStream_t stream) {
  return bwd<r3dl::bf16>(q, k, v, kv, out, lse, bits, gout, dq, dk, dv, G, H,
                         P, Dh, scale, inv_keep, stream);
}
