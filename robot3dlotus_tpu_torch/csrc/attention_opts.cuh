// K1 with the backbone's attention options (ptv3_config enable_rpe,
// scaled_cosine_attn): per-head logit scales hs (H,) fp32 and the relative
// position bias from the patches' grid coordinates gc (G, P, 3) int32 and
// the table (3R, H) fp32 at position bound b (R = 2b + 1), either or both
// (NULL: off). A separate source so that nvcc builds it beside the release
// instantiations.
//
// The scale alone is attention.cuh's kernel with InlineOpts: one product
// more a logit, computed for every key and selected (attention_tile.cuh
// opt_logit: LogitOpts branched around it, which cost a third of the
// release kernel's time at B = 1).
//
// With the bias (gc given), one of two plans (ops/attention.py
// attention_opts_plan). A logit's bias takes three clipped coordinate
// differences, three table reads at data-dependent banks and two adds,
// against about three instructions for the rest of its softmax; looked up
// by the math warps as LogitOpts does (the first design) it doubled the
// tile's work. Both plans stage the patch's coordinates as -4 (x, y, z) a
// point and the head's table column with its axes 32 floats apart in
// static shared memory, so that a clipped lookup is one add-and-min with
// a floor at 0 (__viaddmin_s32_relu) on a byte offset, and one load at
// that offset plus a constant (stage_bias, tile_bias).
//
// The inline plan (grids of more than a wave of blocks: B = 32): the math
// lanes look their logits' biases up themselves (InlineOpts) in
// attention.cuh's kernel, up to 8 warps a block.
//
// The bias-warp plan (a wave of blocks or less: B = 1, where an SM holds
// a block of 4 warps and the lookups' latency went unhidden): the kernel
// below. A block has two roles, `warps` warps each (at most kBiasWarps):
//   - its bias warps load the patch's grid coordinates and the head's
//     table column first, and write the bias of every logit of each math
//     warp's 16 query rows into shared memory, laid out as that warp's C
//     fragments (one float4 a lane and 8-key tile: rows gr, gr + 8 by
//     keys 2t, 2t + 1), each the fp32 sum (tx + ty) + tz.
//   - its math warps stage k and v with cp.async and run the tiles of
//     attention.cuh (attend_rows, attend_rows16) on query rows
//     16 (warps s + w)..; between the two products they wait for the
//     bias tile and add a logit's bias with one conflict-free 16-byte
//     load a key tile (BiasTileOpts), after the product times the head's
//     scale: the same fp32 operations in the same order as LogitOpts,
//     so the values are those of the first design and of the plain
//     version's order.
// The bias warps work while k and v land and the first product runs;
// named barriers order the roles (kBarMath: k and v staged, kBarBias:
// the coordinates and table staged, kBarTile: the bias written). Each
// block writes only its own rows: no atomics, the result bit-equal from
// launch to launch and, as a row's arithmetic does not depend on the
// split or on G, equal for a patch alone or in a batch.
//
// Two blocks an SM (__launch_bounds__): k and v (36.9 KB at fp32, Dh =
// 32), the coordinates (2 KB), the table (384 B, static) and the tiles
// (8 KB a math warp) take 71.4 KB a block.
#pragma once
#include "attention.cuh"

namespace {

using r3dl::kMaxP;
using r3dl::kTableSmem;

constexpr int kBiasWarps = 4;               // math warps a block, at most
constexpr int kTile4 = kMaxP / 8 * 32;      // a warp's tile, in float4
constexpr int kAxisStride = 32;             // table floats an axis
constexpr int kBarMath = 1, kBarTile = 2, kBarBias = 3;
// after k and v: coordinates, tiles (the table is static: bias_table)
constexpr size_t kBiasSmem = kMaxP * sizeof(int4) +
                             kBiasWarps * kTile4 * sizeof(float4);
static_assert(3 * kAxisStride <= kTableSmem &&
                  2 * r3dl::kMaxPosBound + 1 <= kAxisStride,
              "the table's axes fit their strides");

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// the head's table column, axis a at float kAxisStride a: static, so that
// a lookup's address is its byte offset plus a constant
__shared__ float bias_table[kTableSmem];

// The patch's coordinates as -4 (x, y, z) into sgc (kMaxP rows, zero past
// P) and the head's table column into bias_table, by `threads` threads
// from thread `t`; the caller syncs before the lookups
__device__ __forceinline__ void stage_bias(const r3dl::OptArgs& a,
                                           long long g, int h, int H, int P,
                                           int t, int threads, int4* sgc) {
  const int R = 2 * a.b + 1;
  const int* src = a.gc + g * P * 3;
  for (int i = t; i < kMaxP; i += threads)
    sgc[i] = i < P ? make_int4(-4 * src[3 * i], -4 * src[3 * i + 1],
                               -4 * src[3 * i + 2], 0)
                   : make_int4(0, 0, 0, 0);
  for (int i = t; i < 3 * R; i += threads)
    bias_table[i / R * kAxisStride + i % R] = a.table[(long long)i * H + h];
}

// LogitOpts' logits with the bias read from the block's bias tile
template <bool kScale_, bool kRoundP_>
struct BiasTileOpts {
  static constexpr bool kScale = kScale_, kRoundP = kRoundP_;
  static constexpr bool kTile = true, kSelect = true;
  float hs = 1.f;
  const float4* tile = nullptr;     // this warp's, [key tile][lane]
  int threads = 0;                  // the block's

  __device__ __forceinline__ int4 coords(int, int) const {
    return make_int4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void wait() const { bar_sync(kBarTile, threads); }
  // the logit of product x at element e of key tile n's C fragment
  __device__ __forceinline__ float logit(float x, int n, int e) const {
    if constexpr (kScale) x = __fmul_rn(x, hs);
    const float4 b = tile[n * 32 + (threadIdx.x & 31)];
    return __fadd_rn(x, e == 0 ? b.x : e == 1 ? b.y : e == 2 ? b.z : b.w);
  }
};

// the float at byte offset off of bias_table's axis a
template <int a>
__device__ __forceinline__ float table_at(int off) {
  return *reinterpret_cast<const float*>(
      reinterpret_cast<const char*>(bias_table + a * kAxisStride) + off);
}

// the bias of the query whose row offsets are a (4 (gi + b) on each axis:
// table row gi + b, in bytes) against the key whose coordinates are nk
// (-4 gj): each axis's row offset clipped to [0, hi = 8 b] (table rows 0
// .. 2b) by one add-and-min with a floor at 0
__device__ __forceinline__ float tile_bias(int3 a, int4 nk, int hi) {
  return __fadd_rn(
      __fadd_rn(table_at<0>(__viaddmin_s32_relu(a.x, nk.x, hi)),
                table_at<1>(__viaddmin_s32_relu(a.y, nk.y, hi))),
      table_at<2>(__viaddmin_s32_relu(a.z, nk.z, hi)));
}

// LogitOpts' logits, the bias (kRpe) looked up by the math lane itself
// (tile_bias on the staged coordinates and table), every key's logit
// computed and selected: the scale alone and the inline plan, in
// attention.cuh's kernel
template <bool kScale_, bool kRpe_, bool kRoundP_>
struct InlineOpts {
  static constexpr bool kScale = kScale_, kRpe = kRpe_, kAny = true;
  static constexpr bool kRoundP = kRoundP_, kTile = false, kSelect = true;
  static constexpr size_t kSmem = kRpe ? kMaxP * sizeof(int4) : 0;
  float hs = 1.f;
  const int4* sgc = nullptr;
  int hi = 0, base = 0;             // the table's rows 2b, b (bytes)

  __device__ __forceinline__ void stage(const r3dl::OptArgs& a, long long g,
                                        int h, int H, int P, int tid,
                                        int nthreads, void* smem) {
    if constexpr (kScale) hs = a.hs[h];
    if constexpr (kRpe) {
      sgc = reinterpret_cast<const int4*>(smem);
      stage_bias(a, g, h, H, P, tid, nthreads,
                 reinterpret_cast<int4*>(smem));
      hi = 8 * a.b;
      base = 4 * a.b;
    }
  }
  __device__ __forceinline__ int4 coords(int r, int) const {
    if constexpr (kRpe) return sgc[r];
    return make_int4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void wait() const {}
  __device__ __forceinline__ float operator()(float x, int4 gi,
                                              int4 gj) const {
    if constexpr (kScale) x = __fmul_rn(x, hs);
    if constexpr (kRpe)
      x = __fadd_rn(x, tile_bias(make_int3(base - gi.x, base - gi.y,
                                           base - gi.z), gj, hi));
    return x;
  }
};

// A bias warp's lane: the biases of query rows row0 + gr and + 8 against
// keys 8n + 2t, + 1 (n < nt; kAll: all 16 key tiles, no bounds test)
// into tile[n * 32 + lane] in the C fragment's order. sgc: every point's
// -4 (x, y, z) (zero past P).
template <bool kAll>
__device__ __forceinline__ void write_bias_tile(float4* tile, const int4* sgc,
                                                int b, int row0, int nt,
                                                int lane) {
  const int gr = lane >> 2, t = lane & 3;
  const int hi = 8 * b, base = 4 * b;
  const int4 c0 = sgc[row0 + gr], c1 = sgc[row0 + gr + 8];
  const int3 a0 = make_int3(base - c0.x, base - c0.y, base - c0.z);
  const int3 a1 = make_int3(base - c1.x, base - c1.y, base - c1.z);
#pragma unroll
  for (int n = 0; n < kMaxP / 8; ++n) {
    if (kAll || n < nt) {
      const int4 k0 = sgc[8 * n + 2 * t], k1 = sgc[8 * n + 2 * t + 1];
      tile[n * 32 + lane] =
          make_float4(tile_bias(a0, k0, hi), tile_bias(a0, k1, hi),
                      tile_bias(a1, k0, hi), tile_bias(a1, k1, hi));
    }
  }
}

template <int Dh, typename T, class Opts>
__global__ void __launch_bounds__(64 * kBiasWarps, 2)
patch_attention_bias_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const unsigned char* __restrict__ kv,
                            T* __restrict__ out, int H, int P, int splits,
                            float scale, r3dl::OptArgs oa) {
  extern __shared__ float4 smem4[];
  __shared__ unsigned char smask[kMaxP];

  const long long gh = blockIdx.x / splits;
  const int s = blockIdx.x % splits;
  const int h = (int)(gh % H);
  const long long base = gh * P * Dh;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warps = nthreads >> 6, mthreads = 32 * warps;
  const int warp = tid >> 5, lane = tid & 31;
  const int P8 = (P + 7) & ~7, P16 = (P + 15) & ~15, nt = P8 >> 3;
  char* opt_smem = reinterpret_cast<char*>(smem4) + smem_bytes<Dh, T>(P);
  int4* sgc = reinterpret_cast<int4*>(opt_smem);
  float4* stile = reinterpret_cast<float4*>(sgc + kMaxP);

  if (warp >= warps) {
    // a bias warp: the coordinates and the table column, then the tile of
    // math warp `warp - warps`
    stage_bias(oa, gh / H, h, H, P, tid - mthreads, mthreads, sgc);
    bar_sync(kBarBias, mthreads);
    const int row0 = (s * warps + warp - warps) * 16;
    if (row0 < P) {
      float4* tile = stile + (warp - warps) * kTile4;
      if (P > kMaxP - 8)
        write_bias_tile<true>(tile, sgc, oa.b, row0, nt, lane);
      else
        write_bias_tile<false>(tile, sgc, oa.b, row0, nt, lane);
    }
    bar_arrive(kBarTile, nthreads);
    return;
  }

  // a math warp: k and v as attention.cuh's kernel stages them, on the
  // math warps' threads
  float* sk = reinterpret_cast<float*>(smem4);
  float* sv = sk + P8 * r3dl::Layout<Dh>::S;
  r3dl::bf16* sk16 = reinterpret_cast<r3dl::bf16*>(smem4);
  r3dl::bf16* sv16 = sk16 + P16 * r3dl::Layout16<Dh>::S;
  if constexpr (std::is_same<T, float>::value) {
    constexpr int S = r3dl::Layout<Dh>::S;
    constexpr int Q = Dh / 4;
    for (int i = tid; i < P8 * Q; i += mthreads) {
      const int r = i / Q, c = (i - r * Q) * 4;
      const bool in = r < P;
      const long long off = base + (long long)r * Dh + c;
      r3dl::cp_async16(sk + r * S + c, in ? k + off : k, in);
      r3dl::cp_async16(sv + r * S + c, in ? v + off : v, in);
    }
  } else {
    r3dl::stage_rows16<Dh>(sk16, k + base, P, P16, tid, mthreads);
    r3dl::stage_rows16<Dh>(sv16, v + base, P, P16, tid, mthreads);
  }
  r3dl::cp_async_commit();
  for (int j = tid; j < P; j += mthreads) smask[j] = kv[gh / H * P + j];
  const int row0 = (s * warps + warp) * 16;
  const int qc = min(8 * (lane & 3), Dh - 1);
  for (int r = row0 + (lane >> 2); r < min(P, row0 + 16); r += 8)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(q + base + r * Dh + qc));
  Opts opt;
  if constexpr (Opts::kScale) opt.hs = oa.hs[h];
  opt.tile = stile + warp * kTile4;
  opt.threads = nthreads;
  r3dl::cp_async_wait<0>();
  bar_sync(kBarMath, mthreads);

  if (row0 >= P) {
    bar_arrive(kBarTile, nthreads);
    return;
  }
  if constexpr (std::is_same<T, float>::value)
    r3dl::attend_rows<Dh, false>(q + base, out + base, nullptr, sk, sv,
                                 smask, nullptr, 0, row0, P, scale, 1.f,
                                 opt);
  else
    r3dl::attend_rows16<Dh, false>(q + base, out + base, nullptr, sk16,
                                   sv16, smask, nullptr, 0, row0, P, scale,
                                   1.f, opt);
}

template <int Dh, typename T, class Opts>
int launch_bias(const T* q, const T* k, const T* v, const unsigned char* kv,
                T* out, int G, int H, int P, int warps, int splits,
                float scale, const r3dl::OptArgs& oa, cudaStream_t stream) {
  static const cudaError_t attr = r3dl::allow_smem(
      patch_attention_bias_kernel<Dh, T, Opts>,
      smem_bytes<Dh, T>(kMaxP) + kBiasSmem);
  if (attr != cudaSuccess) return (int)attr;
  patch_attention_bias_kernel<Dh, T, Opts>
      <<<(unsigned)((long long)G * H * splits), 64 * warps,
         smem_bytes<Dh, T>(P) + kBiasSmem, stream>>>(q, k, v, kv, out, H, P,
                                                      splits, scale, oa);
  return (int)cudaGetLastError();
}

// K1 with the bias (and the scale where hs is given): warps math warps a
// block (1..kBiasWarps), splits blocks a patch
template <typename T, class Opts>
int attention_bias(const T* q, const T* k, const T* v,
                   const unsigned char* kv, T* out, int G, int H, int P,
                   int Dh, int warps, int splits, float scale,
                   const r3dl::OptArgs& oa, cudaStream_t stream) {
  if (P < 1 || P > kMaxP || warps < 1 || warps > kBiasWarps || splits < 1 ||
      16 * warps * splits < P || (long long)G * H * splits > 0x7fffffffLL ||
      (((uintptr_t)k | (uintptr_t)v) & 15) || ((uintptr_t)q & 3) ||
      oa.table == nullptr || oa.b < 0 || oa.b > r3dl::kMaxPosBound)
    return (int)cudaErrorInvalidValue;
  if ((long long)G * H == 0) return (int)cudaGetLastError();
  switch (Dh) {
    case 8: return launch_bias<8, T, Opts>(q, k, v, kv, out, G, H, P, warps,
                                           splits, scale, oa, stream);
    case 16: return launch_bias<16, T, Opts>(q, k, v, kv, out, G, H, P,
                                             warps, splits, scale, oa,
                                             stream);
    case 24: return launch_bias<24, T, Opts>(q, k, v, kv, out, G, H, P,
                                             warps, splits, scale, oa,
                                             stream);
    case 32: return launch_bias<32, T, Opts>(q, k, v, kv, out, G, H, P,
                                             warps, splits, scale, oa,
                                             stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// tile: the bias-warp plan, else the inline plan (with the bias)
template <typename T, bool kRoundP>
int attention_opts(const T* q, const T* k, const T* v,
                   const unsigned char* kv, T* out, const float* hs,
                   const int* gc, const float* table, int b, int G, int H,
                   int P, int Dh, int warps, int splits, int tile,
                   float scale, cudaStream_t stream) {
  const r3dl::OptArgs oa{hs, gc, table, b};
  if (gc == nullptr) {
    if (hs == nullptr || table != nullptr) return (int)cudaErrorInvalidValue;
    return attention<T, InlineOpts<true, false, kRoundP>>(
        q, k, v, kv, out, G, H, P, Dh, warps, splits, scale, oa, stream);
  }
  if (table == nullptr) return (int)cudaErrorInvalidValue;
  if (tile)
    return hs ? attention_bias<T, BiasTileOpts<true, kRoundP>>(
                    q, k, v, kv, out, G, H, P, Dh, warps, splits, scale, oa,
                    stream)
              : attention_bias<T, BiasTileOpts<false, kRoundP>>(
                    q, k, v, kv, out, G, H, P, Dh, warps, splits, scale, oa,
                    stream);
  return hs ? attention<T, InlineOpts<true, true, kRoundP>>(
                  q, k, v, kv, out, G, H, P, Dh, warps, splits, scale, oa,
                  stream)
            : attention<T, InlineOpts<false, true, kRoundP>>(
                  q, k, v, kv, out, G, H, P, Dh, warps, splits, scale, oa,
                  stream);
}

}  // namespace
