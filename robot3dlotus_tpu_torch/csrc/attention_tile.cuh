// The patch-attention forward tiles shared by K1 (attention.cuh, inference)
// and K5 (attention_dropout.cuh, training with dropout), and the fragment
// helpers K6 uses too: one warp, 16 query rows of one (g, h) patch against
// all of its P <= 128 keys, both products on the tensor cores
// (tc_common.cuh). Two tiles, one per dtype:
//
// attend_rows (fp32 q, k, v, out: K1, K5): S = (q scale) k^T for all P keys
// in registers (64 floats a thread), masked logits (-1e9 at an invalid
// key, -inf past P), the row max, exps and sums in one pass (each logit
// computed once: with P <= 128 one key tile is the whole row), then out =
// exps v / sum. With kDrop the exps whose keep bit is 0 are left out of the
// product (not of the sum), out is scaled by 1 / (1 - rate) and the row
// logsumexp is written. Both products are 3xTF32 mma.sync.m16n8k8 on k and
// v rows staged in fp32 (Layout). A C fragment of one product is the A
// fragment of the next with no shuffle: the k index of an 8-wide step is
// permuted so that A column t is element 2t and column t + 4 is element
// 2t + 1, which is where the accumulator holds them.
//
// attend_rows16 (bf16 q, k, v, out: K1 and K5 under compute_dtype
// bfloat16): the JAX package's XLA attention at that dtype (models/
// layers.py SerializedAttention): q * scale rounded to bf16 (scale, a bf16
// value, given by the wrapper), fp32 logits and softmax, the normalised
// (and, with kDrop, dropped and scaled by 1 / (1 - rate), as flax Dropout
// drops them before the cast) probabilities rounded to bf16 before the
// product with v, which sums in fp32, and the output rounded to bf16 once.
// Every operand is then a bf16 value, so both products run as they are on
// the bf16 tensor cores (mma.sync.m16n8k16, fp32 sums; the 8-wide tail of
// Dh = 8 or 24 as m16n8k8): k and v stay bf16 in shared memory (Layout16,
// staged by stage_rows16 with 16-byte cp.async), their B fragments come
// from ldmatrix (v's transposed), q's A fragments from 4-byte loads of
// bf16 pairs, and the rounded probabilities of two 8-key C fragments are
// the A fragment of their 16 keys. Against the fp32 layout widened from
// bf16 (one TF32 pass) that is half the shared memory, a quarter of the
// mma instructions, no widening in the inner loop. The exps are expf,
// and each probability is the IEEE quotient exp / sum: a
// product by the row's reciprocal, corrected once by its fused residual
// (div_rn below), where a division would cost several times that.
//
// Bound: at the release shapes K1 and K5 are bound by their bytes (q, k,
// v, out; K5 also lse and bits) and K5 also by its Philox work
// (attention_dropout.cuh); the products are 4 P^2 Dh flops per (g, h).
//
// Shared-memory rows are padded (Layout, Layout16) so that every fragment
// load is free of bank conflicts. A patch with no valid key gets uniform
// weights (every logit is -1e9), as the plain version does.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ---- the attention options (ops/attention.py head_scale and rpe) ----
// The logit of query i and key j becomes S_ij hs + bias_ij, before the
// key mask: S_ij the product (q scale) k^T, hs the head's scale (scaled
// cosine attention's exp(min(logit_scale, log 100)), a product in fp32
// after the dot, not folded into q), and bias_ij the learned relative
// position bias table[c(dx) + b, h] + table[R + c(dy) + b, h] +
// table[2R + c(dz) + b, h], summed in that order, with (dx, dy, dz) the
// grid coordinates of query i less those of key j, c the clip to
// [-b, b] and R = 2b + 1 (the JAX package's rpe_bias). The bias is looked
// up in the kernel from the patch's grid coordinates and the head's table
// column, both staged in shared memory: no (G, H, P, P) bias is ever
// written. The release model has neither option: NoOpts, whose calls
// compile to nothing, so the release instantiations are what they were.
// kRoundP (the fp32 tile, with either option on): the JAX XLA attention
// at bf16 under upcast_attention, q and k fp32 and v bf16 (widened by the
// wrapper, so every v is a bf16 value): the normalised, dropped
// probabilities are rounded to bf16 before P v, as `attn.astype(v.dtype)`
// rounds them (models/layers.py:392 of the JAX package). K6 takes the
// forward's saved state as it is (bf16 training follows the TPU kernel's
// backward, unrounded probabilities in dv and ds).
constexpr int kMaxPosBound = 15;    // b at P = 128: int((4 P)^(1/3) 2)
constexpr int kTableSmem = 96;      // floats: 3 (2 kMaxPosBound + 1) = 93

// the options' device pointers as the wrapper passes them (NULL: off)
struct OptArgs {
  const float* hs;       // (H,) fp32
  const int* gc;         // (G, P, 3) int32 grid coordinates
  const float* table;    // (3R, H) fp32
  int b;                 // the position bound, 0..kMaxPosBound
};

template <bool kScale_, bool kRpe_, bool kRoundP_ = false>
struct LogitOpts {
  static constexpr bool kScale = kScale_, kRpe = kRpe_;
  static constexpr bool kAny = kScale || kRpe;
  static constexpr bool kRoundP = kRoundP_;
  static constexpr bool kTile = false;   // the bias looked up here
  static constexpr bool kSelect = false;  // a logit only for a valid key
  static_assert(kAny || !kRoundP, "kRoundP comes with an option");
  // shared memory (bytes, 16-byte aligned) the options take after the
  // kernel's own: the patch's coordinates as int4 rows, the table column
  static constexpr size_t kSmem =
      kRpe ? kMaxP * sizeof(int4) + kTableSmem * sizeof(float) : 0;
  float hs = 1.f;
  const int4* gc = nullptr;
  const float* tab = nullptr;
  int b = 0, R = 0;

  // this block's options for patch g, head h; smem: kSmem bytes; the
  // caller syncs the block before the first lookup
  __device__ __forceinline__ void stage(const OptArgs& a, long long g, int h,
                                        int H, int P, int tid, int nthreads,
                                        void* smem) {
    if constexpr (kScale) hs = a.hs[h];
    if constexpr (kRpe) {
      int4* sg = reinterpret_cast<int4*>(smem);
      float* st = reinterpret_cast<float*>(sg + kMaxP);
      b = a.b;
      R = 2 * b + 1;
      const int* src = a.gc + g * P * 3;
      for (int i = tid; i < P; i += nthreads)
        sg[i] = make_int4(src[3 * i], src[3 * i + 1], src[3 * i + 2], 0);
      for (int i = tid; i < 3 * R; i += nthreads)
        st[i] = a.table[(long long)i * H + h];
      gc = sg;
      tab = st;
    }
  }
  // the grid coordinates of point r (zero past P)
  __device__ __forceinline__ int4 coords(int r, int P) const {
    if constexpr (kRpe) {
      if (r < P) return gc[r];
    }
    return make_int4(0, 0, 0, 0);
  }
  // component a (0, 1, 2) of point r's grid coordinates (r < P)
  __device__ __forceinline__ int axis(int r, int a) const {
    return reinterpret_cast<const int*>(gc)[4 * r + a];
  }
  __device__ __forceinline__ int bin(int d) const {
    return min(max(d, -b), b) + b;
  }
  // the table rows of query coordinates gi against key coordinates gj
  __device__ __forceinline__ int3 bins(int4 gi, int4 gj) const {
    return make_int3(bin(gi.x - gj.x), R + bin(gi.y - gj.y),
                     2 * R + bin(gi.z - gj.z));
  }
  __device__ __forceinline__ float bias(int4 gi, int4 gj) const {
    const int3 r = bins(gi, gj);
    return __fadd_rn(__fadd_rn(tab[r.x], tab[r.y]), tab[r.z]);
  }
  // the logit of product x, query coordinates gi, key coordinates gj
  __device__ __forceinline__ float operator()(float x, int4 gi,
                                              int4 gj) const {
    if constexpr (kScale) x = __fmul_rn(x, hs);
    if constexpr (kRpe) x = __fadd_rn(x, bias(gi, gj));
    return x;
  }
  // the tiles call it between the two products (a tile Opts waits there
  // for its bias)
  __device__ __forceinline__ void wait() const {}
};
using NoOpts = LogitOpts<false, false>;

template <class Opts>
struct OptsTag {
  using type = Opts;
};

// f(OptsTag<Opts>()) with the LogitOpts of the options that hs and gc
// turn on (kRoundP as given); invalid when neither is
template <bool kRoundP, class F>
int with_opts(const float* hs, const int* gc, const float* table, F&& f) {
  if ((gc == nullptr) != (table == nullptr))
    return (int)cudaErrorInvalidValue;
  if (hs && gc) return f(OptsTag<LogitOpts<true, true, kRoundP>>());
  if (hs) return f(OptsTag<LogitOpts<true, false, kRoundP>>());
  if (gc) return f(OptsTag<LogitOpts<false, true, kRoundP>>());
  return (int)cudaErrorInvalidValue;
}

// The logit of product x at C-fragment element e of key tile n (key j,
// query coordinates gi): LogitOpts looks the bias up from the coordinates;
// an Opts with kTile (K1's bias tile, attention_opts.cuh) reads the bias
// that its block's bias warps wrote for (n, e), the same fp32 sum. An
// Opts with kSelect (K1's, attention_opts.cuh) has every key's logit
// computed and then selected, where LogitOpts computes it only for a
// valid key: the compiler branches around each logit's operations there
// (a BSSY / BSYNC pair each), and selects here.
template <class Opts>
__device__ __forceinline__ float opt_logit(const Opts& opt, float x, int n,
                                           int e, int4 gi, int j, int P) {
  if constexpr (Opts::kTile) return opt.logit(x, n, e);
  else return opt(x, gi, opt.coords(j, P));
}

// x / y rounded to nearest, for y >= 1 and 0 <= x <= y (a probability):
// the product by ry = 1 / y rounded, corrected by its exact residual
// (Markstein's step: correctly rounded when ry is)
__device__ __forceinline__ float div_rn(float x, float y, float ry) {
  const float q = x * ry;
  return fmaf(fmaf(-q, y, x), ry, q);
}

// x rounded to the nearest bf16 value, as fp32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Row strides in floats. Dh + 4: a load at (row r, col c) or at
// (row 2c, col r) hits 32 distinct banks. SB: (row c, col r).
template <int Dh>
struct Layout {
  static constexpr int S = Dh + 4;
  static constexpr int SB = Dh % 16 == 8 ? Dh : Dh + 8;   // 8 or 24 mod 32
  static constexpr int DS = kMaxP + 4;
};

// bf16 rows at a stride of S values: 2 S bytes an odd multiple of 16, so
// the 8 rows of an ldmatrix matrix fall on distinct banks
template <int Dh>
struct Layout16 {
  static constexpr int S = (Dh / 8) % 2 ? Dh : Dh + 8;
};

// The masked logits of this lane's two rows (s: nt 8-key tiles of C
// fragments, key n * 8 + 2t + (e & 1), e < 2 the first row; with
// options, opt's logits of the products s, g0 and g1 the rows' grid
// coordinates), their row
// maxima m0, m1 and sums l0, l1 of the exps over every key; s holds the
// exps after, with kDrop those whose keep bit (b0, b1: the rows' words)
// is 0 set to 0. kExact: expf (the bf16 tile), else __expf.
template <bool kDrop, bool kAllTiles, bool kExact, class Opts>
__device__ __forceinline__ void softmax_rows(
    float (&s)[kMaxP / 8][4], int nt, int P, int t,
    const unsigned char* smask, const uint32_t* b0, const uint32_t* b1,
    float& m0, float& m1, float& l0, float& l1, const Opts& opt, int4 g0,
    int4 g1) {
  m0 = m1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < kMaxP / 8; ++n) {
    if (kAllTiles || n < nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * t + (e & 1);
        float x;
        if constexpr (Opts::kSelect) {
          const float y = opt_logit(opt, s[n][e], n, e, e < 2 ? g0 : g1, j,
                                    P);
          x = j >= P ? -INFINITY : smask[j] ? y : kNegInf;
        } else {
          x = j >= P    ? -INFINITY
              : smask[j] ? opt_logit(opt, s[n][e], n, e, e < 2 ? g0 : g1, j,
                                     P)
                         : kNegInf;
        }
        s[n][e] = x;
        if (e < 2) m0 = fmaxf(m0, x);
        else m1 = fmaxf(m1, x);
      }
    }
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  l0 = l1 = 0.f;
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
        const float x = kExact ? expf(z) : __expf(z);
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
}

// This warp's query rows row0 + lane / 4 and row0 + lane / 4 + 8 (row0 < P,
// a multiple of 16) of one patch. q, out: the patch's (P, Dh) rows in
// global memory; sk, sv: its k and v rows in shared memory (fp32) at stride
// Layout<Dh>::S, rows P..(P rounded up to 8)-1 zero; smask: its key mask.
// kDrop: sbits holds W keep-bit words a row (bit j % 32 of word j / 32 is
// key j), inv_keep = 1 / (1 - rate), lse the patch's (P,) row logsumexp.
// kAllTiles (P > 120: all 16 key tiles): the key-tile loops have no
// bounds test, so the tiles' independent product chains are one basic
// block that the compiler interleaves (with a test per tile, one warp
// waits out each chain's latency in turn); attend_rows picks it.
template <int Dh, bool kDrop, bool kAllTiles, class Opts>
__device__ __forceinline__ void attend_tiles(
    const float* __restrict__ q, float* __restrict__ out,
    float* __restrict__ lse, const float* sk, const float* sv,
    const unsigned char* smask, const uint32_t* sbits, int W, int row0,
    int P, float scale, float inv_keep, const Opts& opt) {
  constexpr int S = Layout<Dh>::S;
  constexpr int KD = Dh / 8;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int nt = kAllTiles ? kMaxP / 8 : ((P + 7) & ~7) >> 3;  // key tiles
  const int r0 = row0 + gr, r1 = r0 + 8;   // this lane's query rows
  const float* q0 = q + (long long)r0 * Dh;
  const float* q1 = q + (long long)r1 * Dh;

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
    const FragA a(r0 < P ? q0[d] * scale : 0.f, r1 < P ? q1[d] * scale : 0.f,
                  r0 < P ? q0[d + 4] * scale : 0.f,
                  r1 < P ? q1[d + 4] * scale : 0.f);
#pragma unroll
    for (int n = 0; n < kMaxP / 8; ++n) {
      if (kAllTiles || n < nt) {
        const float* kr = sk + (n * 8 + gr) * S + kk * 8 + t;
        mma3(s[n], a, kr[0], kr[4]);
      }
    }
  }

  float m0, m1, l0, l1;
  opt.wait();
  softmax_rows<kDrop, kAllTiles, false>(s, nt, P, t, smask, sbits + r0 * W,
                                        sbits + r1 * W, m0, m1, l0, l1, opt,
                                        opt.coords(r0, P),
                                        opt.coords(r1, P));

  // kRoundP: the probabilities normalised (div_rn, as the bf16 tile),
  // dropped and rounded to bf16 before the product, which then needs no
  // scaling after it
  if constexpr (Opts::kRoundP) {
    const float rl0 = __frcp_rn(l0), rl1 = __frcp_rn(l1);
#pragma unroll
    for (int n = 0; n < kMaxP / 8; ++n) {
      if (kAllTiles || n < nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = div_rn(s[n][e], e < 2 ? l0 : l1,
                                 e < 2 ? rl0 : rl1);
          s[n][e] = round_bf16(kDrop ? x * inv_keep : x);
        }
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
      const FragA a(s[n][0], s[n][2], s[n][1], s[n][3]);
#pragma unroll
      for (int m = 0; m < KD; ++m) {
        const float* vr = sv + (n * 8 + 2 * t) * S + m * 8 + gr;
        mma3(o[m], a, vr[0], vr[S]);
      }
    }
  }
  const float f0 = Opts::kRoundP ? 1.f : inv_keep / l0;
  const float f1 = Opts::kRoundP ? 1.f : inv_keep / l1;
  float* o0 = out + (long long)r0 * Dh;
  float* o1 = out + (long long)r1 * Dh;
#pragma unroll
  for (int m = 0; m < KD; ++m) {
    const int c = m * 8 + 2 * t;
    if (r0 < P) {
      o0[c] = o[m][0] * f0;
      o0[c + 1] = o[m][1] * f0;
    }
    if (r1 < P) {
      o1[c] = o[m][2] * f1;
      o1[c + 1] = o[m][3] * f1;
    }
  }
  if constexpr (kDrop) {
    if (t == 0) {
      if (r0 < P) lse[r0] = m0 + logf(l0);
      if (r1 < P) lse[r1] = m1 + logf(l1);
    }
  }
}

template <int Dh, bool kDrop, class Opts = NoOpts>
__device__ __forceinline__ void attend_rows(
    const float* __restrict__ q, float* __restrict__ out,
    float* __restrict__ lse, const float* sk, const float* sv,
    const unsigned char* smask, const uint32_t* sbits, int W, int row0,
    int P, float scale, float inv_keep, const Opts& opt = Opts()) {
  if (P > kMaxP - 8)
    attend_tiles<Dh, kDrop, true>(q, out, lse, sk, sv, smask, sbits, W,
                                  row0, P, scale, inv_keep, opt);
  else
    attend_tiles<Dh, kDrop, false>(q, out, lse, sk, sv, smask, sbits, W,
                                   row0, P, scale, inv_keep, opt);
}

// ---- the bf16 tile ----

// rows [0, P16) of a patch's (P, Dh) bf16 slice into shared memory at
// stride Layout16<Dh>::S with 16-byte cp.async (src 16-byte aligned; Dh a
// multiple of 8), rows P..P16-1 zero-filled; the caller commits and waits
template <int Dh>
__device__ __forceinline__ void stage_rows16(bf16* dst,
                                             const bf16* __restrict__ src,
                                             int P, int P16, int tid,
                                             int nthreads) {
  constexpr int S = Layout16<Dh>::S, Q = Dh / 8;
  for (int i = tid; i < P16 * Q; i += nthreads) {
    const int r = i / Q, c = (i - r * Q) * 8;
    const bool in = r < P;
    cp_async16(dst + r * S + c, in ? src + (long long)r * Dh + c : src, in);
  }
}

// q * scale of rows r (< P, else 0) at columns d, d + 1, rounded to bf16
__device__ __forceinline__ uint32_t scaled_pair(const bf16* __restrict__ q,
                                                int Dh, int r, int P, int d,
                                                float scale) {
  if (r >= P) return 0u;
  const float2 f = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(q + (long long)r * Dh + d));
  return pack_bf16(f.x * scale, f.y * scale);
}

// attend_tiles for bf16 (the header): q, out bf16 (q 4-byte aligned); sk,
// sv bf16 rows at stride Layout16<Dh>::S, rows P..(P rounded up to 16)-1
// zero; the other arguments as attend_tiles takes them. kAllTiles (P >
// 112): all eight 16-key blocks, no bounds tests.
template <int Dh, bool kDrop, bool kAllTiles, class Opts>
__device__ __forceinline__ void attend_tiles16(
    const bf16* __restrict__ q, bf16* __restrict__ out,
    float* __restrict__ lse, const bf16* sk, const bf16* sv,
    const unsigned char* smask, const uint32_t* sbits, int W, int row0,
    int P, float scale, float inv_keep, const Opts& opt) {
  constexpr int S = Layout16<Dh>::S;
  constexpr int KF = Dh / 16;              // full 16-wide head-dim steps
  constexpr bool kTail = Dh % 16 != 0;     // and an 8-wide one (Dh 8, 24)
  constexpr int ND = Dh / 8;               // 8-wide output column tiles
  constexpr int kBlocks = kMaxP / 16;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;   // ldmatrix: matrix, its row
  const int nb = kAllTiles ? kBlocks : (P + 15) >> 4;   // 16-key blocks
  const int r0 = row0 + gr, r1 = r0 + 8;

  // A fragments of q * scale
  uint32_t qa[KF + kTail][4];
#pragma unroll
  for (int kk = 0; kk < KF + kTail; ++kk) {
    const int d = 16 * kk + 2 * t;
    qa[kk][0] = scaled_pair(q, Dh, r0, P, d, scale);
    qa[kk][1] = scaled_pair(q, Dh, r1, P, d, scale);
    if (kk < KF) {
      qa[kk][2] = scaled_pair(q, Dh, r0, P, d + 8, scale);
      qa[kk][3] = scaled_pair(q, Dh, r1, P, d + 8, scale);
    }
  }

  // S = (q scale) k^T, key block m = C tiles 2m, 2m + 1: ldmatrix matrix
  // i of an .x4 is keys 16m + 8 (i / 2).., head dims 16kk + 8 (i % 2)..
  float s[kMaxP / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxP / 8; ++n)
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int m = 0; m < kBlocks; ++m) {
    if (kAllTiles || m < nb) {
#pragma unroll
      for (int kk = 0; kk < KF; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, sk + (16 * m + 8 * (lm >> 1) + lr) * S + 16 * kk +
                           8 * (lm & 1));
        mma_bf16(s[2 * m], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * m + 1], qa[kk], b[2], b[3]);
      }
      if constexpr (kTail) {
        uint32_t b[2];
        ldmatrix_x2(b, sk + (16 * m + 8 * (lm & 1) + lr) * S + 16 * KF);
        mma_bf16_k8(s[2 * m], qa[KF][0], qa[KF][1], b[0]);
        mma_bf16_k8(s[2 * m + 1], qa[KF][0], qa[KF][1], b[1]);
      }
    }
  }

  float m0, m1, l0, l1;
  opt.wait();
  softmax_rows<kDrop, kAllTiles, true>(s, 2 * nb, P, t, smask,
                                       sbits + r0 * W, sbits + r1 * W, m0,
                                       m1, l0, l1, opt, opt.coords(r0, P),
                                       opt.coords(r1, P));
  // the (kept, scaled) probabilities, rounded to bf16 as the reference
  // casts them
  const float rl0 = __frcp_rn(l0), rl1 = __frcp_rn(l1);

  // out = P v, key block m: A = the probabilities of tiles 2m, 2m + 1;
  // B from v transposed, matrix i of an .x4 keys 16m + 8 (i % 2).., head
  // dims 8 (dd + i / 2)..
  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
#pragma unroll
  for (int m = 0; m < kBlocks; ++m) {
    if (kAllTiles || m < nb) {
      uint32_t pa[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = div_rn(s[2 * m + h][e], e < 2 ? l0 : l1,
                                 e < 2 ? rl0 : rl1);
          p[e] = kDrop ? x * inv_keep : x;
        }
        pa[2 * h] = pack_bf16(p[0], p[1]);
        pa[2 * h + 1] = pack_bf16(p[2], p[3]);
      }
      const bf16* vr = sv + (16 * m + 8 * (lm & 1) + lr) * S;
#pragma unroll
      for (int dd = 0; dd + 1 < ND; dd += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vr + 8 * (dd + (lm >> 1)));
        mma_bf16(o[dd], pa, b[0], b[1]);
        mma_bf16(o[dd + 1], pa, b[2], b[3]);
      }
      if constexpr (ND % 2) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, vr + 8 * (ND - 1));
        mma_bf16(o[ND - 1], pa, b[0], b[1]);
      }
    }
  }
  bf16* o0 = out + (long long)r0 * Dh;
  bf16* o1 = out + (long long)r1 * Dh;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int c = 8 * d + 2 * t;
    if (r0 < P)
      *reinterpret_cast<uint32_t*>(o0 + c) = pack_bf16(o[d][0], o[d][1]);
    if (r1 < P)
      *reinterpret_cast<uint32_t*>(o1 + c) = pack_bf16(o[d][2], o[d][3]);
  }
  if constexpr (kDrop) {
    if (t == 0) {
      if (r0 < P) lse[r0] = m0 + logf(l0);
      if (r1 < P) lse[r1] = m1 + logf(l1);
    }
  }
}

template <int Dh, bool kDrop, class Opts = NoOpts>
__device__ __forceinline__ void attend_rows16(
    const bf16* __restrict__ q, bf16* __restrict__ out,
    float* __restrict__ lse, const bf16* sk, const bf16* sv,
    const unsigned char* smask, const uint32_t* sbits, int W, int row0,
    int P, float scale, float inv_keep, const Opts& opt = Opts()) {
  if (P > kMaxP - 16)
    attend_tiles16<Dh, kDrop, true>(q, out, lse, sk, sv, smask, sbits, W,
                                    row0, P, scale, inv_keep, opt);
  else
    attend_tiles16<Dh, kDrop, false>(q, out, lse, sk, sv, smask, sbits, W,
                                     row0, P, scale, inv_keep, opt);
}

}  // namespace r3dl
