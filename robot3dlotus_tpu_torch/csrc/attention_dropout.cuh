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
// attend_rows on them, the tile K1 (attention.cuh) runs too: S for all P
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
// K6 at bf16 (attn_drop_bwd16_kernel) computes as the Pallas body
// `_attn_drop_bwd_kernel` does, in fp32: p from the saved lse and the bf16
// q * scale, the unrounded probabilities in dv and ds, D = g . out from
// K5's bf16 output, the exact ds = 0 at masked keys and p = 1 / P in a
// patch with no valid key, and dq, dk, dv each rounded to bf16 once. It
// runs on the bf16 tensor cores with K5's staging: q, k, v, g and out go
// to shared memory as they are (stage_rows16, 16-byte cp.async; out where
// ds goes later, read once for D), q * scale is rounded to bf16 in place,
// and every fragment comes from ldmatrix (.trans where a product reads a
// transpose). The fp32 design's phases stay: phase 1, warp w owns keys
// 16w.. and walks the queries 16 at a time; S^T = k (q scale)^T and
// dP^T = v g^T are one bf16 m16n8k16 each (both operands bf16 values, so
// every product is exact), where the earlier bf16 design widened the rows
// and ran 3xTF32 on all five products. dv += (keep p / (1 - rate))^T g,
// dk += ds^T (q scale) and, in phase 2 (warp w owns queries 16w..),
// dq = (ds k) scale multiply fp32 values (p, ds) by bf16 ones: each fp32
// fragment is split into three bf16 pieces (tc_common.cuh split_hi,
// split_mid_lo: hi + mid + lo reproduce it exactly), so the three bf16
// products sum it to the fp32 level as 3xTF32 did, in 3 k16 mma where
// 3xTF32 took 6 k8 ones; the small pieces first. (Two pieces would leave
// up to 2^-17 of each term; the third costs one mma in three.) ds goes to
// shared memory in fp32 (136-float rows: phase 2's 8-byte loads free of
// bank conflicts, phase 1's scalar stores two-way). Shared memory: 111 KB
// at Dh = 32 (ds 68 KB, the five bf16 slices 40 KB), two blocks an SM as
// before: ds in fp32 and the 128-register budget of two 256-thread blocks
// keep a third block out. No atomics: bit-equal from run to run.
//
// Options (attention_dropout_opts.cu, ops/attention.py head_scale and
// rpe): K5 runs attention_tile.cuh's tiles with LogitOpts (the logits
// S hs + bias, looked up in the kernel). K6 recomputes the same logits
// for p, takes ds hs as the gradient of S in dq and dk, and writes the
// options' gradients as one partial per (patch, head), summed by the
// wrapper in a fixed order (no atomics: bit-equal from launch to launch):
// dhs (G, H), the sum of ds S over the patch's (query, key) pairs, each
// lane's own sum reduced in a fixed order; and dtable (G, 3R, H), the sum
// of ds over the pairs of each table row, in a pass of its own
// (table_pass; after phase 1 at fp32, after phase 2 at bf16): ds is in
// shared memory then, so for each axis the threads of the patch's keys
// walk the queries, each adding ds into its own column of R rows (15.5
// KB, or two halves of the queries in two columns, in slices the phases
// no longer need; at a masked key or a dead query ds is exactly 0), and
// 8 warps sum the rows across the columns in a fixed order. No per-thread
// sums live through phase 1 (3R x 256 floats, 93 KB), so K6 with the
// options runs two blocks an SM, as the release K6 does (at bf16 v's
// fragments come from device memory and the options' lookup data take
// the end of v's slice). The release entry points (attention_dropout.cu)
// instantiate NoOpts.
#pragma once
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
using r3dl::OptArgs;

// the options' gradient partials (K6), NULL where off
struct OptGrads {
  float* hs;       // (G, H): sum of ds S over the patch
  float* table;    // (G, 3R, H): sum of ds over each table row's pairs
};

constexpr int kWarps = 8;                 // 8 warps x 16 rows = kMaxP
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxWords = kMaxP / 32;     // bit words per row

// K6's table pass (kRpe): the rows of one axis at a time, one column of
// kMaxP floats a row, thread j owning key j's column
constexpr int kMaxRows = 2 * r3dl::kMaxPosBound + 1;
constexpr size_t kRowsBytes = (size_t)kMaxRows * kMaxP * sizeof(float);

// K6's shared memory for the options (bytes): Opts' lookup data, then
// kWarps floats of dhs
template <class Opts>
__host__ __device__ constexpr size_t bwd_opts_smem() {
  return Opts::kAny ? Opts::kSmem + kWarps * sizeof(float) : 0;
}

// K6, one (query, key) pair's logit gradient ds into the options' sum
// dh += ds S (S the pair's product); the table's sums come after phase 1
// (table_pass)
template <class Opts>
__device__ __forceinline__ void add_pair(float ds, float S, float& dh) {
  if constexpr (Opts::kScale) dh = fmaf(ds, S, dh);
}

// K6, after phase 1: each warp's dhs into sdhs (before the block's
// barrier), then (after it) the block's dhs written
template <class Opts>
__device__ __forceinline__ void warp_dhs(float dh, float* sdhs) {
  if constexpr (Opts::kScale) {
#pragma unroll
    for (int sh = 16; sh; sh >>= 1) dh += __shfl_xor_sync(kFull, dh, sh);
    if ((threadIdx.x & 31) == 0) sdhs[threadIdx.x >> 5] = dh;
  }
}

template <class Opts>
__device__ __forceinline__ void write_dhs(const OptGrads& og, long long gh,
                                          const float* sdhs) {
  if constexpr (Opts::kScale) {
    if (threadIdx.x == 0) {
      float x = 0.f;
      for (int w = 0; w < kWarps; ++w) x += sdhs[w];
      og.hs[gh] = x;
    }
  }
}

// K6's partial of dtable for patch g, head h (kRpe), after phase 1 and a
// barrier: sds holds the logits' gradients ds[query][key] (row stride
// `ld`, 0 at a masked key or a dead query). For each axis in turn thread
// (half, j), j < P, walks its half of the queries (kHalves of them) in
// order and adds ds[i][j] to row bin(c_i - c_j) of its own column of
// `rows` (kHalves kRowsBytes: no two threads on one word, no bank
// conflicts, no atomics); then warp w sums rows w, w + 8, .. across the
// columns, half by half, in a fixed order. Bit-equal from launch to
// launch. The read-modify-write chain through shared memory sets its
// pace (with one half, on the 4 warps that own keys, about 2 of K6's 6.7
// ms a fp32 options step), so two halves run (8 warps, two chains of half
// the length) where the free slices hold their rows: Dh = 32 (at bf16 the
// pass follows phase 2, so that k's slice is free too). Walks that summed
// each bin's run in a register, in each axis's order, measured slower
// (PERF.md).
template <int kHalves, class Opts>
__device__ __forceinline__ void table_pass(const Opts& opt,
                                           const OptGrads& og,
                                           const float* sds, int ld,
                                           float* rows, long long gh, int H,
                                           int P) {
  static_assert(kHalves * kMaxP <= kThreads, "a thread a key and half");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int key = tid % kMaxP, half = tid / kMaxP;
  const long long g = gh / H;
  const int h = (int)(gh % H), R = opt.R;
  const int i0 = half * P / kHalves, i1 = (half + 1) * P / kHalves;
#pragma unroll 1
  for (int a = 0; a < 3; ++a) {
    if (half < kHalves) {
      float* col = rows + half * kMaxRows * kMaxP + key;
      for (int r = 0; r < R; ++r) col[r * kMaxP] = 0.f;
      if (key < P) {
        const int cj = opt.axis(key, a);
        const float* dsj = sds + key;
#pragma unroll 4
        for (int i = i0; i < i1; ++i)
          col[opt.bin(opt.axis(i, a) - cj) * kMaxP] += dsj[i * ld];
      }
    }
    __syncthreads();
    for (int r = warp; r < R; r += kWarps) {
      float x = 0.f;
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
        for (int i = lane; i < kMaxP; i += 32)
          x += rows[(hf * kMaxRows + r) * kMaxP + i];
#pragma unroll
      for (int sh = 16; sh; sh >>= 1) x += __shfl_xor_sync(kFull, x, sh);
      if (lane == 0) og.table[(g * 3 * R + a * R + r) * H + h] = x;
    }
    __syncthreads();
  }
}

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

// rows [0, P8) of a (P, Dh) fp32 slice into shared memory at stride S,
// times mul; rows P..P8-1 zero (the ragged 8-row tile)
template <int Dh>
__device__ __forceinline__ void load_rows(float* dst, int S,
                                          const float* __restrict__ src,
                                          int P, int P8, float mul) {
  for (int i = threadIdx.x; i < P8 * Dh; i += kThreads) {
    const int r = i / Dh, d = i - r * Dh;
    dst[r * S + d] = r < P ? src[i] * mul : 0.f;
  }
}

template <int Dh>
__host__ __device__ size_t fwd_smem() {
  return (2 * (size_t)kMaxP * Layout<Dh>::S) * sizeof(float) +
         (size_t)kMaxP * kMaxWords * sizeof(uint32_t);
}

template <int Dh, class Opts>
__global__ void __launch_bounds__(kThreads, 2)
attn_drop_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const unsigned char* __restrict__ kv,
                     float* __restrict__ out, float* __restrict__ lse,
                     uint32_t* __restrict__ bits, int H, int P, float scale,
                     uint32_t seed, uint32_t thresh, float inv_keep,
                     OptArgs oa) {
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
  load_rows<Dh>(sk, S, k + base, P, P8, 1.f);
  load_rows<Dh>(sv, S, v + base, P, P8, 1.f);
  if (tid < P) smask[tid] = kv[gh / H * P + tid];
  for (int w = tid; w < P * W; w += kThreads) {
    const int i = w / W, j0 = (w - i * W) * 32;
    const uint32_t word =
        keep_word(i, j0, min(32, P - j0), P, seed, (uint32_t)gh, thresh);
    sbits[w] = word;
    bits[gh * P * W + w] = word;
  }
  Opts opt;
  if constexpr (Opts::kAny)
    opt.stage(oa, gh / H, (int)(gh % H), H, P, tid, kThreads,
              reinterpret_cast<char*>(smem) + fwd_smem<Dh>());
  __syncthreads();

  const int warp = tid >> 5;
  if (warp * 16 >= P) return;
  r3dl::attend_rows<Dh, true>(q + base, out + base, lse + gh * P, sk, sv,
                              smask, sbits, W, warp * 16, P, scale,
                              inv_keep, opt);
}

// K5 at bf16 (the header): k and v rows at Layout16's stride, rows
// P..P16-1 zero, then the keep bits
template <int Dh>
__host__ __device__ size_t fwd16_smem() {
  return 2 * (size_t)kMaxP * r3dl::Layout16<Dh>::S * sizeof(r3dl::bf16) +
         (size_t)kMaxP * kMaxWords * sizeof(uint32_t);
}

template <int Dh, class Opts>
__global__ void __launch_bounds__(kThreads, 2)
attn_drop_fwd16_kernel(const r3dl::bf16* __restrict__ q,
                       const r3dl::bf16* __restrict__ k,
                       const r3dl::bf16* __restrict__ v,
                       const unsigned char* __restrict__ kv,
                       r3dl::bf16* __restrict__ out, float* __restrict__ lse,
                       uint32_t* __restrict__ bits, int H, int P,
                       float scale, uint32_t seed, uint32_t thresh,
                       float inv_keep, OptArgs oa) {
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
  Opts opt;
  if constexpr (Opts::kAny)
    opt.stage(oa, gh / H, (int)(gh % H), H, P, tid, kThreads,
              reinterpret_cast<char*>(smem4) + fwd16_smem<Dh>());
  r3dl::cp_async_wait<0>();
  __syncthreads();

  if (warp * 16 >= P) return;
  r3dl::attend_rows16<Dh, true>(q + base, out + base, lse + gh * P, sk, sv,
                                smask, sbits, W, warp * 16, P, scale,
                                inv_keep, opt);
}

template <int Dh>
__host__ __device__ size_t bwd_smem() {
  using L = Layout<Dh>;
  return ((size_t)kMaxP * L::DS + 2 * (size_t)kMaxP * L::S + 2 * kMaxP) *
             sizeof(float) +
         (size_t)kMaxP * kMaxWords * sizeof(uint32_t);
}

// K6 (fp32) with the options: its own shared memory, then the options'
// (bwd_opts_smem), then the table pass's rows where q and g's slices are
// too small to hold them (Dh = 8)
template <int Dh>
__host__ __device__ constexpr size_t q_g_bytes() {
  return 2 * (size_t)kMaxP * Layout<Dh>::S * sizeof(float);
}

// the table pass's halves: two where q and g's slices hold both rows
template <int Dh>
__host__ __device__ constexpr int table_halves() {
  return q_g_bytes<Dh>() >= 2 * kRowsBytes ? 2 : 1;
}

template <int Dh>
__host__ __device__ constexpr bool rows_in_q() {
  return q_g_bytes<Dh>() >= kRowsBytes;
}

template <int Dh, class Opts>
__host__ __device__ size_t bwd_total_smem() {
  return bwd_smem<Dh>() + bwd_opts_smem<Opts>() +
         (Opts::kRpe && !rows_in_q<Dh>() ? kRowsBytes : 0);
}

// 8-query tiles per phase-1 step of K6: one keeps the Dh = 32 instance
// within 128 registers; two spilled 148 bytes and ran 19% slower on an
// H100 SXM
constexpr int kChunk = 1;

template <int Dh, class Opts>
__global__ void __launch_bounds__(kThreads, 2)
attn_drop_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const unsigned char* __restrict__ kv,
                     const float* __restrict__ o,
                     const float* __restrict__ lse,
                     const uint32_t* __restrict__ bits,
                     const float* __restrict__ gout, float* __restrict__ dq,
                     float* __restrict__ dk, float* __restrict__ dv, int H,
                     int P, float scale, float inv_keep, OptArgs oa,
                     OptGrads og) {
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
  load_rows<Dh>(sq, S, q + base, P, P8, scale);
  load_rows<Dh>(sg, S, gout + base, P, P8, 1.f);
  for (int i = tid; i < P * W; i += kThreads) sbits[i] = bits[gh * P * W + i];
  if (tid < kMaxP) slse[tid] = tid < P ? lse[gh * P + tid] : 0.f;
  for (int r = warp; r < kMaxP; r += kWarps) {   // D, one row per warp
    float x = 0.f;
    if (r < P && lane < Dh)
      x = gout[base + (long long)r * Dh + lane] *
          o[base + (long long)r * Dh + lane];
#pragma unroll
    for (int sh = 16; sh; sh >>= 1) x += __shfl_xor_sync(kFull, x, sh);
    if (lane == 0) sD[r] = x;
  }
  bool valid = false;
  if (tid < P) valid = smask[tid] = kv[gh / H * P + tid];
  Opts opt;
  char* extra = reinterpret_cast<char*>(smem) + bwd_smem<Dh>();
  float* sdhs = reinterpret_cast<float*>(extra + Opts::kSmem);
  if constexpr (Opts::kAny)
    opt.stage(oa, gh / H, (int)(gh % H), H, P, tid, kThreads, extra);
  const bool any_valid = __syncthreads_or(valid);

  // ---- phase 1: warp w owns keys 16w..16w+15 ----
  const int j0 = warp * 16 + gr, j1 = j0 + 8;   // this lane's keys
  float dh = 0.f;                               // the options' sum of ds S
  if (warp * 16 < P) {
    const int4 gk0 = opt.coords(j0, P), gk1 = opt.coords(j1, P);
    const float* k0 = k + base + (long long)j0 * Dh;
    const float* k1 = k + base + (long long)j1 * Dh;
    const float* v0 = v + base + (long long)j0 * Dh;
    const float* v1 = v + base + (long long)j1 * Dh;
    float ka[KD][4], va[KD][4];   // A fragments of this warp's k and v rows
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int d = kk * 8 + t;
      ka[kk][0] = j0 < P ? k0[d] : 0.f;
      ka[kk][1] = j1 < P ? k1[d] : 0.f;
      ka[kk][2] = j0 < P ? k0[d + 4] : 0.f;
      ka[kk][3] = j1 < P ? k1[d + 4] : 0.f;
      va[kk][0] = j0 < P ? v0[d] : 0.f;
      va[kk][1] = j1 < P ? v1[d] : 0.f;
      va[kk][2] = j0 < P ? v0[d + 4] : 0.f;
      va[kk][3] = j1 < P ? v1[d + 4] : 0.f;
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
            const int4 gc = opt.coords(c, P), gk = e < 2 ? gk0 : gk1;
            const float x = opt(s[n][e], gc, gk);        // the logit
            const float p = !any_valid ? inv_p
                            : val      ? __expf(x - slse[c])
                                       : 0.f;
            const float da = kp ? dp[n][e] * inv_keep : 0.f;
            float ds = live && val ? p * (da - sD[c]) : 0.f;
            // the table pass reads the logits' gradients; dq and dk the
            // products' (ds hs), phase 2 scaling them as it reads
            if constexpr (Opts::kRpe) sds[c * DS + j] = ds;
            if constexpr (Opts::kAny) {
              add_pair<Opts>(ds, s[n][e], dh);
              if constexpr (Opts::kScale) ds *= opt.hs;   // d S
            }
            if constexpr (!Opts::kRpe) sds[c * DS + j] = ds;
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
    float* dk0 = dk + base + (long long)j0 * Dh;
    float* dk1 = dk + base + (long long)j1 * Dh;
    float* dv0 = dv + base + (long long)j0 * Dh;
    float* dv1 = dv + base + (long long)j1 * Dh;
#pragma unroll
    for (int m = 0; m < KD; ++m) {
      const int c = m * 8 + 2 * t;
      if (j0 < P) {
        dk0[c] = dka[m][0];
        dk0[c + 1] = dka[m][1];
        dv0[c] = dva[m][0];
        dv0[c + 1] = dva[m][1];
      }
      if (j1 < P) {
        dk1[c] = dka[m][2];
        dk1[c + 1] = dka[m][3];
        dv1[c] = dva[m][2];
        dv1[c + 1] = dva[m][3];
      }
    }
  }
  if constexpr (Opts::kAny) warp_dhs<Opts>(dh, sdhs);
  __syncthreads();
  if constexpr (Opts::kAny) write_dhs<Opts>(og, gh, sdhs);
  if constexpr (Opts::kRpe)    // the rows where q and g were (or after)
    table_pass<table_halves<Dh>()>(
        opt, og, sds, DS,
        rows_in_q<Dh>()
            ? sq
            : reinterpret_cast<float*>(extra + bwd_opts_smem<Opts>()),
        gh, H, P);

  // ---- phase 2: warp w owns queries 16w..16w+15; dq = ds k scale ----
  load_rows<Dh>(sq, SB, k + base, P, P8, 1.f);   // k where q and g were
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
    // with the bias, sds holds the logits' gradients: times hs here
    const float hs = Opts::kRpe && Opts::kScale ? opt.hs : 1.f;
    const FragA a(Opts::kRpe && Opts::kScale ? d0[0] * hs : d0[0],
                  Opts::kRpe && Opts::kScale ? d1[0] * hs : d1[0],
                  Opts::kRpe && Opts::kScale ? d0[4] * hs : d0[4],
                  Opts::kRpe && Opts::kScale ? d1[4] * hs : d1[4]);
#pragma unroll
    for (int m = 0; m < KD; ++m) {
      const float* kr = sq + (kk * 8 + t) * SB + m * 8 + gr;
      mma3(acc[m], a, kr[0], kr[4 * SB]);
    }
  }
  float* q0 = dq + base + (long long)r0 * Dh;
  float* q1 = dq + base + (long long)r1 * Dh;
#pragma unroll
  for (int m = 0; m < KD; ++m) {
    const int c = m * 8 + 2 * t;
    if (r0 < P) {
      q0[c] = acc[m][0] * scale;
      q0[c + 1] = acc[m][1] * scale;
    }
    if (r1 < P) {
      q1[c] = acc[m][2] * scale;
      q1[c + 1] = acc[m][3] * scale;
    }
  }
}

// ---- K6 at bf16 (the header) ----

// ds rows in floats: 8 mod 32, so phase 2's 8-byte fragment loads of a
// half warp (rows gid, columns 2t, 2t + 1) fall on 32 distinct banks
constexpr int kDS16 = kMaxP + 8;

// ds (fp32), then q * scale, g, k and v as bf16 rows at Layout16's stride
// (out staged where ds goes, before ds), then lse, D and the keep bits
template <int Dh>
__host__ __device__ size_t bwd16_smem() {
  return (size_t)kMaxP * kDS16 * sizeof(float) +
         4 * (size_t)kMaxP * r3dl::Layout16<Dh>::S * sizeof(r3dl::bf16) +
         2 * (size_t)kMaxP * sizeof(float) +
         (size_t)kMaxP * kMaxWords * sizeof(uint32_t);
}

// K6 (bf16) with the options: v's fragments come from device memory and
// the options' lookup data take the end of v's slice (after the kernel's
// own shared memory where it is too small: Dh = 8); the table pass runs
// after phase 2, its rows from q's slice on (q, g, k and the rest of v's
// slice are dead then; after the rest where too small: Dh = 8), in two
// halves where they hold both (Dh = 32)
template <int Dh>
__host__ __device__ constexpr size_t slice16() {
  return (size_t)kMaxP * r3dl::Layout16<Dh>::S * sizeof(r3dl::bf16);
}

template <int Dh, class Opts>
__host__ __device__ constexpr bool opts_in_v16() {
  return slice16<Dh>() >= bwd_opts_smem<Opts>();
}

// the bytes free from q's slice on once phase 2 is done
template <int Dh, class Opts>
__host__ __device__ constexpr size_t free16() {
  return 3 * slice16<Dh>() +
         (opts_in_v16<Dh, Opts>() ? slice16<Dh>() - bwd_opts_smem<Opts>()
                                  : slice16<Dh>());
}

template <int Dh, class Opts>
__host__ __device__ constexpr int table_halves16() {
  return free16<Dh, Opts>() >= 2 * kRowsBytes ? 2 : 1;
}

template <int Dh, class Opts>
__host__ __device__ constexpr bool rows_in_q16() {
  return free16<Dh, Opts>() >= kRowsBytes;
}

template <int Dh, class Opts>
__host__ __device__ size_t bwd16_total_smem() {
  return bwd16_smem<Dh>() +
         (opts_in_v16<Dh, Opts>() ? 0 : bwd_opts_smem<Opts>()) +
         (Opts::kRpe && !rows_in_q16<Dh, Opts>() ? kRowsBytes : 0);
}

// d += a b for an fp32 A fragment held as its three bf16 pieces (the
// products' sum exact to the fp32 level): the small pieces first
__device__ __forceinline__ void mma_pieces(float (&d)[4],
                                           const uint32_t (&hi)[4],
                                           const uint32_t (&mid)[4],
                                           const uint32_t (&lo)[4],
                                           uint32_t b0, uint32_t b1) {
  r3dl::mma_bf16(d, lo, b0, b1);
  r3dl::mma_bf16(d, mid, b0, b1);
  r3dl::mma_bf16(d, hi, b0, b1);
}

// the three pieces of an A fragment (16 x 16) given as four fp32 pairs
__device__ __forceinline__ void split_fragment(const float2 (&v)[4],
                                               uint32_t (&hi)[4],
                                               uint32_t (&mid)[4],
                                               uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r3dl::split_mid_lo(r3dl::split_hi(v[i], hi[i]), mid[i], lo[i]);
}

// acc[d] += A B for this warp's A pieces against the Dh / 8 column tiles of
// B read transposed from rows `rows` (16 of them, at stride S) of a bf16
// slice: ldmatrix .x4.trans matrix i holds rows 8 (i % 2).., columns
// 8 (dd + i / 2)..
template <int Dh>
__device__ __forceinline__ void mma_rows_t(float (&acc)[Dh / 8][4],
                                           const uint32_t (&hi)[4],
                                           const uint32_t (&mid)[4],
                                           const uint32_t (&lo)[4],
                                           const r3dl::bf16* rows,
                                           int lane) {
  constexpr int S = r3dl::Layout16<Dh>::S, ND = Dh / 8;
  const int lm = lane >> 3, lr = lane & 7;
  const r3dl::bf16* r = rows + (8 * (lm & 1) + lr) * S;
#pragma unroll
  for (int dd = 0; dd + 1 < ND; dd += 2) {
    uint32_t b[4];
    r3dl::ldmatrix_x4_trans(b, r + 8 * (dd + (lm >> 1)));
    mma_pieces(acc[dd], hi, mid, lo, b[0], b[1]);
    mma_pieces(acc[dd + 1], hi, mid, lo, b[2], b[3]);
  }
  if constexpr (ND % 2) {
    uint32_t b[2];
    r3dl::ldmatrix_x2_trans(b, r + 8 * (ND - 1));
    mma_pieces(acc[ND - 1], hi, mid, lo, b[0], b[1]);
  }
}

template <int Dh, class Opts>
__global__ void __launch_bounds__(kThreads, 2)
attn_drop_bwd16_kernel(const r3dl::bf16* __restrict__ q,
                       const r3dl::bf16* __restrict__ k,
                       const r3dl::bf16* __restrict__ v,
                       const unsigned char* __restrict__ kv,
                       const r3dl::bf16* __restrict__ o,
                       const float* __restrict__ lse,
                       const uint32_t* __restrict__ bits,
                       const r3dl::bf16* __restrict__ gout,
                       r3dl::bf16* __restrict__ dq,
                       r3dl::bf16* __restrict__ dk,
                       r3dl::bf16* __restrict__ dv, int H, int P,
                       float scale, float inv_keep, OptArgs oa,
                       OptGrads og) {
  using r3dl::bf16;
  constexpr int S = r3dl::Layout16<Dh>::S;
  constexpr int KF = Dh / 16;              // full 16-wide head-dim steps
  constexpr bool kTail = Dh % 16 != 0;     // and an 8-wide one (Dh 8, 24)
  constexpr int ND = Dh / 8;               // 8-wide head-dim column tiles
  static_assert(kMaxP * S * sizeof(bf16) <= kMaxP * kDS16 * sizeof(float),
                "out fits where ds goes");
  extern __shared__ float4 smem4[];
  float* sds = reinterpret_cast<float*>(smem4);  // ds[query][key], kDS16
  bf16* so = reinterpret_cast<bf16*>(sds);       // out, before ds
  bf16* sq = reinterpret_cast<bf16*>(sds + kMaxP * kDS16);  // q * scale
  bf16* sg = sq + kMaxP * S;
  bf16* sk = sg + kMaxP * S;
  bf16* sv = sk + kMaxP * S;
  float* slse = reinterpret_cast<float*>(sv + kMaxP * S);
  float* sD = slse + kMaxP;                      // D_i = g_i . out_i
  uint32_t* sbits = reinterpret_cast<uint32_t*>(sD + kMaxP);
  __shared__ unsigned char smask[kMaxP];

  const int W = (P + 31) >> 5;
  const int P16 = (P + 15) & ~15;
  const long long gh = blockIdx.x;
  const long long base = gh * P * Dh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;   // ldmatrix: matrix, its row
  r3dl::stage_rows16<Dh>(sq, q + base, P, P16, tid, kThreads);
  r3dl::stage_rows16<Dh>(sg, gout + base, P, P16, tid, kThreads);
  r3dl::stage_rows16<Dh>(sk, k + base, P, P16, tid, kThreads);
  if constexpr (!Opts::kAny)
    r3dl::stage_rows16<Dh>(sv, v + base, P, P16, tid, kThreads);
  r3dl::stage_rows16<Dh>(so, o + base, P, P16, tid, kThreads);
  r3dl::cp_async_commit();
  for (int i = tid; i < P * W; i += kThreads) sbits[i] = bits[gh * P * W + i];
  if (tid < kMaxP) slse[tid] = tid < P ? lse[gh * P + tid] : 0.f;
  bool valid = false;
  if (tid < P) valid = smask[tid] = kv[gh / H * P + tid];
  Opts opt;
  char* extra = reinterpret_cast<char*>(smem4) + bwd16_smem<Dh>();
  char* optsmem = opts_in_v16<Dh, Opts>()
                      ? reinterpret_cast<char*>(sv) + slice16<Dh>() -
                            bwd_opts_smem<Opts>()
                      : extra;
  float* sdhs = reinterpret_cast<float*>(optsmem + Opts::kSmem);
  if constexpr (Opts::kAny)
    opt.stage(oa, gh / H, (int)(gh % H), H, P, tid, kThreads, optsmem);
  r3dl::cp_async_wait<0>();
  const bool any_valid = __syncthreads_or(valid);
  // q * scale rounded to bf16 in place (the forward's bf16 q * scale), and
  // D in fp32, one row a warp (rows P..P16-1 are zero)
  for (int i = tid; i < P16 * (Dh / 2); i += kThreads) {
    const int r = i / (Dh / 2), c = 2 * (i - r * (Dh / 2));
    uint32_t* p = reinterpret_cast<uint32_t*>(sq + r * S + c);
    const float2 f = r3dl::unpack_bf16(*p);
    *p = r3dl::pack_bf16(f.x * scale, f.y * scale);
  }
  for (int r = warp; r < kMaxP; r += kWarps) {
    float x = 0.f;
    if (r < P && lane < Dh)
      x = __bfloat162float(sg[r * S + lane]) *
          __bfloat162float(so[r * S + lane]);
#pragma unroll
    for (int sh = 16; sh; sh >>= 1) x += __shfl_xor_sync(kFull, x, sh);
    if (lane == 0) sD[r] = x;
  }
  __syncthreads();

  // ---- phase 1: warp w owns keys 16w..16w+15, the queries in 16-query
  // blocks ----
  const int j0 = warp * 16 + gr, j1 = j0 + 8;   // this lane's keys
  float dh = 0.f;                               // the options' sum of ds S
  if (warp * 16 < P) {
    const int4 gk0 = opt.coords(j0, P), gk1 = opt.coords(j1, P);
    // A fragments of this warp's k and v rows: matrix i of an .x4 holds
    // keys 8 (i % 2).., head dims 16 kk + 8 (i / 2)..
    uint32_t ka[KF + kTail][4], va[KF + kTail][4];
#pragma unroll
    for (int kk = 0; kk < KF; ++kk) {
      const int off = (warp * 16 + 8 * (lm & 1) + lr) * S + 16 * kk +
                      8 * (lm >> 1);
      r3dl::ldmatrix_x4(ka[kk], sk + off);
      if constexpr (!Opts::kAny) r3dl::ldmatrix_x4(va[kk], sv + off);
    }
    if constexpr (kTail) {
      const int off = (warp * 16 + 8 * (lm & 1) + lr) * S + 16 * KF;
      uint32_t a[2];
      r3dl::ldmatrix_x2(a, sk + off);
      ka[KF][0] = a[0];
      ka[KF][1] = a[1];
      if constexpr (!Opts::kAny) {
        r3dl::ldmatrix_x2(a, sv + off);
        va[KF][0] = a[0];
        va[KF][1] = a[1];
      }
    }
    if constexpr (Opts::kAny) {
      // v's A fragments from device memory (its slice holds the options'
      // data): rows j0 / j1, head dims 16 kk + 2t (+ 8), as ldmatrix
      // gives them; rows past P zero
      const bf16* v0 = v + base + (long long)j0 * Dh + 2 * t;
      const bf16* v1 = v + base + (long long)j1 * Dh + 2 * t;
      auto pair = [&](const bf16* r, bool in, int d) {
        return in ? *reinterpret_cast<const uint32_t*>(r + d) : 0u;
      };
#pragma unroll
      for (int kk = 0; kk < KF + kTail; ++kk) {
        va[kk][0] = pair(v0, j0 < P, 16 * kk);
        va[kk][1] = pair(v1, j1 < P, 16 * kk);
        if (kk < KF) {
          va[kk][2] = pair(v0, j0 < P, 16 * kk + 8);
          va[kk][3] = pair(v1, j1 < P, 16 * kk + 8);
        }
      }
    }
    const bool val0 = j0 < P && smask[j0], val1 = j1 < P && smask[j1];
    const float inv_p = 1.f / (float)P;
    float dka[ND][4], dva[ND][4];
#pragma unroll
    for (int d = 0; d < ND; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;

    for (int m = 0; m < P16 / 16; ++m) {
      // S^T = k (q scale)^T and dP^T = v g^T on queries 16m..16m+15, two
      // 8-query C tiles each; B from q and g rows: matrix i of an .x4
      // holds queries 16m + 8 (i / 2).., head dims 16 kk + 8 (i % 2)..
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KF; ++kk) {
        const int off = (16 * m + 8 * (lm >> 1) + lr) * S + 16 * kk +
                        8 * (lm & 1);
        uint32_t b[4];
        r3dl::ldmatrix_x4(b, sq + off);
        r3dl::mma_bf16(s[0], ka[kk], b[0], b[1]);
        r3dl::mma_bf16(s[1], ka[kk], b[2], b[3]);
        r3dl::ldmatrix_x4(b, sg + off);
        r3dl::mma_bf16(dp[0], va[kk], b[0], b[1]);
        r3dl::mma_bf16(dp[1], va[kk], b[2], b[3]);
      }
      if constexpr (kTail) {
        const int off = (16 * m + 8 * (lm & 1) + lr) * S + 16 * KF;
        uint32_t b[2];
        r3dl::ldmatrix_x2(b, sq + off);
        r3dl::mma_bf16_k8(s[0], ka[KF][0], ka[KF][1], b[0]);
        r3dl::mma_bf16_k8(s[1], ka[KF][0], ka[KF][1], b[1]);
        r3dl::ldmatrix_x2(b, sg + off);
        r3dl::mma_bf16_k8(dp[0], va[KF][0], va[KF][1], b[0]);
        r3dl::mma_bf16_k8(dp[1], va[KF][0], va[KF][1], b[1]);
      }
      // p, the dropped p, ds (the fp32 kernel's arithmetic); ds to shared
      // memory for phase 2
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 16 * m + 8 * h + 2 * t + (e & 1);   // query
          const int j = e < 2 ? j0 : j1;                    // key
          const bool val = e < 2 ? val0 : val1;
          const bool live = c < P && j < P;
          const bool kp =
              live && ((sbits[c * W + (j >> 5)] >> (j & 31)) & 1u);
          const int4 gc = opt.coords(c, P), gk = e < 2 ? gk0 : gk1;
          const float x = opt(s[h][e], gc, gk);        // the logit
          const float p = !any_valid ? inv_p
                          : val      ? __expf(x - slse[c])
                                     : 0.f;
          const float da = kp ? dp[h][e] * inv_keep : 0.f;
          float ds = live && val ? p * (da - sD[c]) : 0.f;
          // the table pass reads the logits' gradients; dq and dk the
          // products' (ds hs), phase 2 scaling them as it reads
          if constexpr (Opts::kRpe) sds[c * kDS16 + j] = ds;
          if constexpr (Opts::kAny) {
            add_pair<Opts>(ds, s[h][e], dh);
            if constexpr (Opts::kScale) ds *= opt.hs;   // d S
          }
          if constexpr (!Opts::kRpe) sds[c * kDS16 + j] = ds;
          s[h][e] = kp ? p * inv_keep : 0.f;
          dp[h][e] = ds;
        }
      }
      // dv += (dropped p)^T g and dk += ds^T (q scale): the two C tiles
      // are the A fragment of the 16 queries (keys gr / gr + 8, queries
      // 2t.. of tile 0, then of tile 1), each fp32 pair split into its
      // three bf16 pieces
      uint32_t hi[4], mid[4], lo[4];
      {
        const float2 pd[4] = {make_float2(s[0][0], s[0][1]),
                              make_float2(s[0][2], s[0][3]),
                              make_float2(s[1][0], s[1][1]),
                              make_float2(s[1][2], s[1][3])};
        split_fragment(pd, hi, mid, lo);
      }
      mma_rows_t<Dh>(dva, hi, mid, lo, sg + 16 * m * S, lane);
      {
        const float2 ds[4] = {make_float2(dp[0][0], dp[0][1]),
                              make_float2(dp[0][2], dp[0][3]),
                              make_float2(dp[1][0], dp[1][1]),
                              make_float2(dp[1][2], dp[1][3])};
        split_fragment(ds, hi, mid, lo);
      }
      mma_rows_t<Dh>(dka, hi, mid, lo, sq + 16 * m * S, lane);
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const long long c = base + 8 * d + 2 * t;
      if (j0 < P) {
        *reinterpret_cast<uint32_t*>(dk + c + (long long)j0 * Dh) =
            r3dl::pack_bf16(dka[d][0], dka[d][1]);
        *reinterpret_cast<uint32_t*>(dv + c + (long long)j0 * Dh) =
            r3dl::pack_bf16(dva[d][0], dva[d][1]);
      }
      if (j1 < P) {
        *reinterpret_cast<uint32_t*>(dk + c + (long long)j1 * Dh) =
            r3dl::pack_bf16(dka[d][2], dka[d][3]);
        *reinterpret_cast<uint32_t*>(dv + c + (long long)j1 * Dh) =
            r3dl::pack_bf16(dva[d][2], dva[d][3]);
      }
    }
  }
  if constexpr (Opts::kAny) warp_dhs<Opts>(dh, sdhs);
  __syncthreads();
  if constexpr (Opts::kAny) write_dhs<Opts>(og, gh, sdhs);

  // ---- phase 2: warp w owns queries 16w..16w+15; dq = (ds k) scale, the
  // ds rows split into their three bf16 pieces, k read transposed (with
  // the bias every warp then goes on to the table pass) ----
  if constexpr (!Opts::kRpe) {
    if (warp * 16 >= P) return;
  }
  if (!Opts::kRpe || warp * 16 < P) {
    const int r0 = warp * 16 + gr, r1 = r0 + 8;
    float acc[ND][4];
#pragma unroll
    for (int d = 0; d < ND; ++d)
      acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
    for (int kk = 0; kk < P16 / 16; ++kk) {
      const float* d0 = sds + r0 * kDS16 + 16 * kk + 2 * t;
      const float* d1 = sds + r1 * kDS16 + 16 * kk + 2 * t;
      float2 a[4] = {*reinterpret_cast<const float2*>(d0),
                     *reinterpret_cast<const float2*>(d1),
                     *reinterpret_cast<const float2*>(d0 + 8),
                     *reinterpret_cast<const float2*>(d1 + 8)};
      if constexpr (Opts::kRpe && Opts::kScale) {
        // with the bias, sds holds the logits' gradients: times hs here
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = make_float2(a[i].x * opt.hs,
                                                       a[i].y * opt.hs);
      }
      uint32_t hi[4], mid[4], lo[4];
      split_fragment(a, hi, mid, lo);
      mma_rows_t<Dh>(acc, hi, mid, lo, sk + 16 * kk * S, lane);
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const long long c = base + 8 * d + 2 * t;
      if (r0 < P)
        *reinterpret_cast<uint32_t*>(dq + c + (long long)r0 * Dh) =
            r3dl::pack_bf16(acc[d][0] * scale, acc[d][1] * scale);
      if (r1 < P)
        *reinterpret_cast<uint32_t*>(dq + c + (long long)r1 * Dh) =
            r3dl::pack_bf16(acc[d][2] * scale, acc[d][3] * scale);
    }
  }
  if constexpr (Opts::kRpe) {   // the rows from q's slice on (or after)
    __syncthreads();
    table_pass<table_halves16<Dh, Opts>()>(
        opt, og, sds, kDS16,
        rows_in_q16<Dh, Opts>()
            ? reinterpret_cast<float*>(sq)
            : reinterpret_cast<float*>(
                  extra + (opts_in_v16<Dh, Opts>() ? 0
                                                   : bwd_opts_smem<Opts>())),
        gh, H, P);
  }
}

template <int Dh, typename T, class Opts>
int launch_fwd(const T* q, const T* k, const T* v, const unsigned char* kv,
               T* out, float* lse, uint32_t* bits, int G, int H, int P,
               float scale, uint32_t seed, uint32_t thresh, float inv_keep,
               const OptArgs& oa, cudaStream_t stream) {
  const unsigned grid = (unsigned)((long long)G * H);
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem = fwd_smem<Dh>() + Opts::kSmem;
    static const cudaError_t attr =
        r3dl::allow_smem(attn_drop_fwd_kernel<Dh, Opts>, smem);
    if (attr != cudaSuccess) return (int)attr;
    attn_drop_fwd_kernel<Dh, Opts><<<grid, kThreads, smem, stream>>>(
        q, k, v, kv, out, lse, bits, H, P, scale, seed, thresh, inv_keep,
        oa);
  } else {
    const size_t smem = fwd16_smem<Dh>() + Opts::kSmem;
    static const cudaError_t attr =
        r3dl::allow_smem(attn_drop_fwd16_kernel<Dh, Opts>, smem);
    if (attr != cudaSuccess) return (int)attr;
    attn_drop_fwd16_kernel<Dh, Opts><<<grid, kThreads, smem, stream>>>(
        q, k, v, kv, out, lse, bits, H, P, scale, seed, thresh, inv_keep,
        oa);
  }
  return (int)cudaGetLastError();
}

template <int Dh, typename T, class Opts>
int launch_bwd(const T* q, const T* k, const T* v, const unsigned char* kv,
               const T* out, const float* lse, const uint32_t* bits,
               const T* gout, T* dq, T* dk, T* dv, int G, int H, int P,
               float scale, float inv_keep, const OptArgs& oa,
               const OptGrads& og, cudaStream_t stream) {
  const unsigned grid = (unsigned)((long long)G * H);
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem = bwd_total_smem<Dh, Opts>();
    static const cudaError_t attr =
        r3dl::allow_smem(attn_drop_bwd_kernel<Dh, Opts>, smem);
    if (attr != cudaSuccess) return (int)attr;
    attn_drop_bwd_kernel<Dh, Opts><<<grid, kThreads, smem, stream>>>(
        q, k, v, kv, out, lse, bits, gout, dq, dk, dv, H, P, scale,
        inv_keep, oa, og);
  } else {
    const size_t smem = bwd16_total_smem<Dh, Opts>();
    static const cudaError_t attr =
        r3dl::allow_smem(attn_drop_bwd16_kernel<Dh, Opts>, smem);
    if (attr != cudaSuccess) return (int)attr;
    attn_drop_bwd16_kernel<Dh, Opts><<<grid, kThreads, smem, stream>>>(
        q, k, v, kv, out, lse, bits, gout, dq, dk, dv, H, P, scale,
        inv_keep, oa, og);
  }
  return (int)cudaGetLastError();
}

// blocks of K6 (T, Opts) that one SM holds at head dim Dh, its shared
// memory opted into (cudaOccupancyMaxActiveBlocksPerMultiprocessor); a
// negative cudaError on failure
template <typename T, class Opts>
int bwd_blocks_per_sm(int Dh) {
  auto one = [](auto kernel, size_t smem) {
    int n = 0;
    cudaError_t e = r3dl::allow_smem(kernel, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                        smem);
    return e == cudaSuccess ? n : -(int)e;
  };
  auto at = [&](auto dh) {
    constexpr int D = decltype(dh)::value;
    if constexpr (std::is_same<T, float>::value)
      return one(attn_drop_bwd_kernel<D, Opts>, bwd_total_smem<D, Opts>());
    else
      return one(attn_drop_bwd16_kernel<D, Opts>,
                 bwd16_total_smem<D, Opts>());
  };
  switch (Dh) {
    case 8: return at(std::integral_constant<int, 8>());
    case 16: return at(std::integral_constant<int, 16>());
    case 24: return at(std::integral_constant<int, 24>());
    case 32: return at(std::integral_constant<int, 32>());
    default: return -(int)cudaErrorInvalidValue;
  }
}

// the options' pointers: the bias needs gc and the table (and, in K6,
// its gradient), the scale hs (and its gradient), b within the table
template <class Opts>
bool opts_ok(const OptArgs& oa, const OptGrads* og) {
  if (Opts::kScale && (!oa.hs || (og && !og->hs))) return false;
  if (Opts::kRpe && (!oa.gc || !oa.table || (og && !og->table) ||
                     oa.b < 0 || oa.b > r3dl::kMaxPosBound))
    return false;
  return true;
}

template <typename T, class Opts>
int fwd(const T* q, const T* k, const T* v, const unsigned char* kv, T* out,
        float* lse, unsigned* bits, int G, int H, int P, int Dh, float scale,
        unsigned seed, unsigned thresh, float inv_keep, const OptArgs& oa,
        cudaStream_t stream) {
  // the bf16 kernel: k, v staged 16 bytes at a time, q and out in pairs
  if (P < 1 || P > kMaxP || !opts_ok<Opts>(oa, nullptr) ||
      (!std::is_same<T, float>::value &&
       ((((uintptr_t)k | (uintptr_t)v) & 15) ||
        (((uintptr_t)q | (uintptr_t)out) & 3))))
    return (int)cudaErrorInvalidValue;
  if ((long long)G * H == 0) return (int)cudaGetLastError();
  switch (Dh) {
    case 8: return launch_fwd<8, T, Opts>(q, k, v, kv, out, lse, bits, G, H,
                                          P, scale, seed, thresh, inv_keep,
                                          oa, stream);
    case 16: return launch_fwd<16, T, Opts>(q, k, v, kv, out, lse, bits, G,
                                            H, P, scale, seed, thresh,
                                            inv_keep, oa, stream);
    case 24: return launch_fwd<24, T, Opts>(q, k, v, kv, out, lse, bits, G,
                                            H, P, scale, seed, thresh,
                                            inv_keep, oa, stream);
    case 32: return launch_fwd<32, T, Opts>(q, k, v, kv, out, lse, bits, G,
                                            H, P, scale, seed, thresh,
                                            inv_keep, oa, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, class Opts>
int bwd(const T* q, const T* k, const T* v, const unsigned char* kv,
        const T* out, const float* lse, const unsigned* bits, const T* gout,
        T* dq, T* dk, T* dv, int G, int H, int P, int Dh, float scale,
        float inv_keep, const OptArgs& oa, const OptGrads& og,
        cudaStream_t stream) {
  // the bf16 kernel stages q, k, v, out and g 16 bytes at a time
  if (P < 1 || P > kMaxP || !opts_ok<Opts>(oa, &og) ||
      (!std::is_same<T, float>::value &&
       ((((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out |
          (uintptr_t)gout) & 15) ||
        (((uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) & 3))))
    return (int)cudaErrorInvalidValue;
  if ((long long)G * H == 0) return (int)cudaGetLastError();
  switch (Dh) {
    case 8: return launch_bwd<8, T, Opts>(q, k, v, kv, out, lse, bits, gout,
                                          dq, dk, dv, G, H, P, scale,
                                          inv_keep, oa, og, stream);
    case 16: return launch_bwd<16, T, Opts>(q, k, v, kv, out, lse, bits,
                                            gout, dq, dk, dv, G, H, P, scale,
                                            inv_keep, oa, og, stream);
    case 24: return launch_bwd<24, T, Opts>(q, k, v, kv, out, lse, bits,
                                            gout, dq, dk, dv, G, H, P, scale,
                                            inv_keep, oa, og, stream);
    case 32: return launch_bwd<32, T, Opts>(q, k, v, kv, out, lse, bits,
                                            gout, dq, dk, dv, G, H, P, scale,
                                            inv_keep, oa, og, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
