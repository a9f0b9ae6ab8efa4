// K9:  small-channel row gather with sentinel rows
//        out[b, m, c] = x[b, idx[b, m], c] if 0 <= idx[b, m] < N, else 0
// K10: its backward, a scatter-add that drops sentinel rows
//        dx[b, idx[b, m], c] += g[b, m, c] for 0 <= idx[b, m] < N
//
// K9 replaces robot3dlotus_tpu/ops/pallas_gather.py `gather_rows_smallc`
// (_smallc_fwd_call / _smallc_kernel), K10 its custom VJP
// (_smallc_bwd_call / _smallc_bwd_kernel). On the TPU a row gather of a few
// channels was a two-level one-hot matrix product (idx = hi * 128 + lo) so
// that the MXU, which wants 128-lane tiles, did the addressing; an index
// outside [0, N) matched no one-hot column and gave a zero row, which is
// the "no neighbour" sentinel of the motion planner's stem (idx == N). On
// the H100 a scattered 4-byte read is cheap and the (N, C <= 32) source of
// one cloud (80 KB at N = 4096, C = 5) stays in L1/L2; none of the one-hot
// decomposition is carried over.
//
// Bound: bytes for both (no arithmetic beyond K10's adds): the indices
// read, the rows written (K9) or read (K10), the source read (K9) or
// written (K10), over the 3.35 TB/s memory rate. A training step's stem
// gather writes B * M * C = 32 * 512,000 * 5 = 82M floats, so K9 is a
// stream of stores. Design (K9): a grid of (row tiles of 1024 rows, B), so
// no thread divides to find its cloud. A block first loads its tile's
// indices once, coalesced, into shared memory (int32 or int64, a template;
// -1 for an index outside [0, N)) with plain loads: many blocks share an
// SM, so one block's index load overlaps the others' stores, and cp.async
// would only overlap it within the block. Then the threads walk the tile's
// rows * C output elements, which are contiguous: each thread computes 4
// consecutive elements and stores one float4 (a tile starts 16-byte
// aligned when M * C % 4 == 0; 4-byte stores otherwise), with 32-bit
// arithmetic inside the tile and c = e % C by a compile-time C for C = 4
// and 5 (a runtime C up to 32 otherwise). K9 only copies, so it equals its
// plain version bit for bit.
// K9 at bf16 (r3dl_gather_smallc16, gather_smallc16_kernel: the motion
// planner's categorical stem under compute_dtype bfloat16, C = 5, 83% of
// its rows the sentinel). On 2-byte elements the design above made a
// warp's load instruction touch ~26 rows 2 bytes at a time and ran ~5
// serial load -> store steps a thread: 0.58 of the bound at B = 32, 0.42
// at B = 1. Here a thread takes 4 consecutive rows: their indices in one
// 16-byte load, then each live row read whole as the 1-3 8-byte words
// that cover its 2 C bytes (a row starts 0, 2, 4 or 6 bytes into its
// first word; a funnel shift aligns it), all loads issued before the first
// store. 4 rows are 8 C bytes, C whole 8-byte words, packed by byte
// permutes and staged in shared memory; the block writes its tile as
// coalesced 16-byte streaming stores. No padded copy of x: a padding
// kernel costs ~1.4 us of device time (K3 bf16's stem_pad8_kernel at
// B = 1), a third of the B = 1 call. 1024-row tiles (512 above C = 16):
// 500 blocks of 256 threads at B = 1. Every C up to 32 compiles its own
// instance.
//
// K10 is bound by the same bytes: g (B * M * C floats) and the indices
// read once, dx written once; at the motion planner's training stem
// (B, M, C, n) = (32, 512,000, 5, 4,096) that is 328 + 66 + 2.6 MB,
// 0.118 ms at 3.35 TB/s. An earlier design (one thread per element, two
// 64-bit divisions each, the index re-read C times, a global fp32
// atomicAdd per element into a memset dx, ~125 adds contending for each
// destination row in L2) reached 0.44 of that bound. Plan
// (ops/gather.py scatter_smallc_plan, which this file checks):
//   - grid (ranges, B, slabs): block (r, b, s) owns cloud b, the r-th of
//     `ranges` runs of whole 1024-row tiles (range r holds tiles
//     [r nt / ranges, (r + 1) nt / ranges) of the nt = ceil(M / 1024)),
//     and slab s of the destination rows, [s window, (s + 1) window) of
//     [0, n), all C channels. A slab is as many rows as a block's shared
//     memory holds (n = 4096 whole up to C = 14); wider clouds take more
//     slabs, each reading g again, so that any n and C <= 32 run here.
//   - the block keeps a private copy of its slab of dx[b] in shared
//     memory (window x C fp32: 80 KB at n = 4096, C = 5; 112 KB at C = 7),
//     zeroed on entry, and adds into it with shared-memory atomics: no
//     global atomics, no memset.
//   - its 32 warps stream the range's g as float4 (consecutive lanes on
//     consecutive 16 bytes, kUnroll = 2 loads in flight a thread, 32 KB a
//     block, evict-first) with no barrier between entry and exit, so that
//     one warp's adds overlap the others' loads; 32 registers a thread, so
//     that two blocks share an SM where their copies fit (n = 4096 up to
//     C = 7): 64 warps an SM, the adds of one block beside the loads of
//     the other (scripts/torch_k10_plans.py: 0.59 of the bound at C = 5
//     with one block an SM, 0.73 with two); each float4 finds its
//     rows by a division (compile-time for C = 4, 5, 7) and loads their
//     indices (the lanes of a row share the line) with its g, before the
//     first add: an index read after the adds began put a DRAM round trip
//     in each thread's chain (0.50 of the bound at C = 5). 4-byte loads
//     where g or a cloud is not 16-byte aligned (M C not a multiple of 4).
//   - each block writes its copy once: into dx when ranges == 1, else into
//     its (range, cloud, slab) partial, and scatter_smallc_sum_kernel adds
//     a cloud's `ranges` partials in order (float4 lanes). The grid takes
//     ~132 x (blocks an SM) / (B * slabs) ranges (8 at B = 32, C <= 7), at
//     most M / (2 n), so that the partials' writes stay under half of g's
//     bytes (62 for a B = 1 stem), and at most nt; the partials are 21 MB
//     at the C = 5 shape.
// Staging g and the indices through a 3-stage cp.async ring of 16 KB tiles
// with a barrier a tile kept each block's adds from overlapping its loads
// (0.46 of the bound at C = 5, scripts/torch_k10_plans.py).
// The adds into a shared copy come in a run-dependent order, so K10
// agrees with a fixed-order sum to rounding, not bit for bit.
// bf16 (r3dl_scatter_smallc_add_bf16: the stems' input gradients under
// compute_dtype bfloat16): g and dx bf16, the same plan and shared fp32
// copies, and the fp32 sums rounded to bf16 once, as the Pallas VJP
// (pallas_gather.py `_smallc_op_bwd`: fp32 sums, one cast to the input's
// dtype) rounds them: by the block that writes dx when ranges == 1, else
// by the ranges' sum, which adds the fp32 partials first. Its bound is
// the same sum over half of g's bytes (164 MB at the policy stem's B = 32
// call, C = 7). Up to C = 8 it has a kernel of its own,
// scatter_smallc16_kernel; above, the kernel above reads g 8 bytes a
// load. On the H100 a shared fp32 atomicAdd is a compare-and-swap loop
// (ATOMS.CAST.SPIN), and on the stems' maps 83% of the rows are dead, so
// each add instruction of the kernel above ran ~5 live lanes of 32; and
// with no link live at all it took 1.66x its bound (C = 7): 8 bytes of g
// and two index loads a thread, one iteration in flight. Here a warp
// loads a 128-row chunk of g coalesced (16-byte words) with its rows'
// indices and stages it in shared memory, then issues the next chunk's
// loads; a ballot and a prefix count a row list the chunk's live rows,
// and the adds take a listed row's C values on C lanes, 32 / C rows an
// instruction. The adds are bound by the compare-and-swaps' latency, not
// by their count: a row a lane (C adds in series) and 16 warps an SM
// were slower than the kernel above on the stems' calls, so the block is
// 32 warps, one an SM (the slab and the warps' chunks: 186 KB at
// n = 4096, C = 7), 4 ranges at B = 32. The adds still come in arrival
// order: not bit-equal across launches.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 1024;   // K9 rows per block; a multiple of 4
constexpr int kMaxGridY = 65535;

// K9 at fp32
template <int kC, typename I>
__global__ void __launch_bounds__(kThreads)
    gather_smallc_kernel(const float* __restrict__ x,
                         const I* __restrict__ idx, float* __restrict__ out,
                         int N, int M, int c_rt, bool vec4) {
  __shared__ int s_idx[kTileRows];
  const int C = kC > 0 ? kC : c_rt;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, M - r0);
  const I* ib = idx + (long long)b * M + r0;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const long long i = (long long)__ldg(ib + r);
    s_idx[r] = (i >= 0 && i < N) ? (int)i : -1;
  }
  __syncthreads();
  const float* xb = x + (long long)b * N * C;
  float* ob = out + ((long long)b * M + r0) * C;
  const int total = rows * C;
  if (vec4) {
    for (int e = 4 * threadIdx.x; e < total; e += 4 * kThreads) {
      int row = e / C;
      int c = e - row * C;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = e + j < total ? s_idx[row] : -1;
        v[j] = i >= 0 ? __ldg(xb + i * C + c) : 0.0f;
        if (++c == C) {
          c = 0;
          ++row;
        }
      }
      if (e + 4 <= total) {
        *reinterpret_cast<float4*>(ob + e) = make_float4(v[0], v[1], v[2],
                                                         v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (e + j < total) ob[e + j] = v[j];
      }
    }
  } else {
    for (int e = threadIdx.x; e < total; e += kThreads) {
      const int row = e / C;
      const int i = s_idx[row];
      ob[e] = i >= 0 ? __ldg(xb + i * C + (e - row * C)) : 0.0f;
    }
  }
}

// ---- K9 at bf16 ----

// A row of kC bf16 sits at element b N kC + i kC of x, 2-byte aligned: it
// is read whole as the kWords 8-byte words (from x's 8-byte aligned base)
// that cover it, starting 0, 2, 4 or 6 bytes into the first, and shifted
// into kPairs 32-bit words, two channels each.
template <int kC>
struct Row16 {
  static constexpr int kWords = (2 * kC + 6 + 7) / 8;
  static constexpr int kPairs = (kC + 1) / 2;
  // rows a block (4 a thread; the tile's output staged in 32 KB at most)
  static constexpr int kTile = kC <= 16 ? 1024 : 512;
  static constexpr int kThreads = kTile / 4;
};

// the row at byte `byte` from base, x's 8-byte aligned start (a zero row
// when !live), as r[j] = channels 2j, 2j + 1 (the lower in the low half;
// the half past an odd kC is not read). Loads only the 8-byte words that
// hold the row's bytes, which lie in x's allocation.
template <int kC>
__device__ __forceinline__ void load_row16(const char* base, size_t byte,
                                           bool live,
                                           uint32_t (&r)[Row16<kC>::kPairs]) {
  constexpr int W = Row16<kC>::kWords;
  if (!live) byte = 0;
  const uint2* w =
      reinterpret_cast<const uint2*>(base + (byte & ~(size_t)7));
  const unsigned o = byte & 7u;
  const unsigned last = (o + 2 * kC - 1) >> 3;
  uint32_t u[2 * W + 1];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const uint2 v = live && k <= (int)last ? __ldg(w + k) : make_uint2(0, 0);
    u[2 * k] = v.x;
    u[2 * k + 1] = v.y;
  }
  u[2 * W] = 0;
  const bool q = o & 4u;
  const unsigned s = (o & 2u) * 8;
#pragma unroll
  for (int j = 0; j < Row16<kC>::kPairs; ++j)
    r[j] = __funnelshift_r(q ? u[j + 1] : u[j], q ? u[j + 2] : u[j + 1], s);
}

// 4 indices of consecutive rows (16-byte loads when `vec`), -1 past `rows`
template <typename I>
__device__ __forceinline__ void load_idx4(const I* p, int left, bool vec,
                                          long long (&i)[4]) {
  if (vec && left >= 4) {
    if constexpr (sizeof(I) == 4) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
      i[0] = v.x, i[1] = v.y, i[2] = v.z, i[3] = v.w;
    } else {
      const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(p));
      const longlong2 b = __ldcs(reinterpret_cast<const longlong2*>(p) + 1);
      i[0] = a.x, i[1] = a.y, i[2] = b.x, i[3] = b.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      i[k] = k < left ? (long long)__ldcs(p + k) : -1;
  }
}

// out[b, m] = x[b, idx[b, m]] for the tile's rows, bf16, kC channels. A
// thread gathers 4 consecutive rows (their indices one 16-byte load, each
// row its covering 8-byte words; a sentinel row loads nothing), all loads
// issued before its first store; the 4 rows are 8 kC bytes, kC whole
// 8-byte words, which it packs (one byte permute a 32-bit word) and
// stages in shared memory; the block then writes the tile's 2 kC x rows
// bytes as coalesced 16-byte streaming stores (2-byte stores where the
// tile's output does not start 16-byte aligned).
template <int kC, typename I>
__global__ void __launch_bounds__(Row16<kC>::kThreads)
    gather_smallc16_kernel(const unsigned short* __restrict__ x,
                           const I* __restrict__ idx,
                           unsigned short* __restrict__ out, int N, int M,
                           bool vec_idx) {
  using R = Row16<kC>;
  __shared__ __align__(16) uint2 s_out[R::kThreads * kC];
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * R::kTile;
  const int rows = min(R::kTile, M - r0);
  const int t = threadIdx.x;
  long long ii[4];
  load_idx4(idx + (size_t)b * M + r0 + 4 * t, rows - 4 * t, vec_idx, ii);
  // x may start at any 2-byte offset: rows are read from its 8-byte grid
  const char* base =
      reinterpret_cast<const char*>((uintptr_t)x & ~(uintptr_t)7);
  const size_t skew = (uintptr_t)x & 7;
  uint32_t r[4][R::kPairs];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool live = ii[k] >= 0 && ii[k] < N;
    load_row16<kC>(base, skew + 2 * ((size_t)b * N + (size_t)ii[k]) * kC,
                   live, r[k]);
  }
  // output halves v = 2w, 2w + 1 of the thread's 4 kC: row v / kC,
  // channel v % kC, byte 2 (v % 2) of pair word (v % kC) / 2
  uint32_t o32[2 * kC];
#pragma unroll
  for (int w = 0; w < 2 * kC; ++w) {
    const int v0 = 2 * w, v1 = 2 * w + 1;
    const int c0 = v0 % kC, c1 = v1 % kC;
    const unsigned sel = (c0 & 1 ? 0x32u : 0x10u) | (c1 & 1 ? 0x7600u
                                                             : 0x5400u);
    o32[w] = __byte_perm(r[v0 / kC][c0 / 2], r[v1 / kC][c1 / 2], sel);
  }
#pragma unroll
  for (int w = 0; w < kC; ++w)
    s_out[t * kC + w] = make_uint2(o32[2 * w], o32[2 * w + 1]);
  __syncthreads();
  unsigned short* ob = out + ((size_t)b * M + r0) * kC;
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(s_out);
  const int halves = rows * kC;
  int e = 0;
  if (((uintptr_t)ob & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(s_out);
    uint4* o4 = reinterpret_cast<uint4*>(ob);
    for (int k = t; k < halves / 8; k += R::kThreads) __stcs(o4 + k, s4[k]);
    e = halves / 8 * 8;
  }
  for (e += t; e < halves; e += R::kThreads) ob[e] = s16[e];
}

constexpr int kScatterThreads = 1024;
constexpr int kUnroll = 2;         // 4-element loads of g in flight a thread
constexpr int kMaxSmem = 227 * 1024;

__host__ __device__ inline size_t scatter_smem(int C, int window) {
  return ((size_t)4 * window * C + 15) / 16 * 16;
}

// 4 consecutive elements of g, widened: one float4 (fp32) or one 8-byte
// load of four bf16 (two pairs), evict-first
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const r3dl::bf16* p) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
  const float2 lo = r3dl::unpack_bf16(u.x), hi = r3dl::unpack_bf16(u.y);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// 4 consecutive fp32 sums into dx, rounded once to T
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(r3dl::bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(r3dl::pack_bf16(v.x, v.y), r3dl::pack_bf16(v.z, v.w));
}

// dx[b, i, c] += g[b, m, c] for the rows m of range blockIdx.x and the
// destination rows i of slab blockIdx.z, into a shared-memory copy of the
// slab written once at the end: into dx (ranges == 1, rounded once to T)
// or into the range's fp32 partial. T, the type of g and dx: fp32 or bf16
// (widened as it is read; the sums fp32 either way).
template <int kC, typename I, typename T>
__global__ void __launch_bounds__(kScatterThreads, 2)
    scatter_smallc_kernel(const T* __restrict__ g,
                          const I* __restrict__ idx, T* __restrict__ dx,
                          float* __restrict__ part, int B, int n, int M,
                          int c_rt, int ranges, int window, bool vec4) {
  extern __shared__ float4 smem4[];
  float* s_dx = reinterpret_cast<float*>(smem4);
  const unsigned C = kC > 0 ? kC : c_rt;
  const int r = blockIdx.x, b = blockIdx.y;
  const int d0 = blockIdx.z * window;
  const int rows_w = min(window, n - d0);
  const int nt = (M + kTileRows - 1) / kTileRows;
  const unsigned m0 =
      min(M, (int)((long long)r * nt / ranges) * kTileRows);
  const unsigned m1 =
      min(M, (int)((long long)(r + 1) * nt / ranges) * kTileRows);
  const T* gb = g + (size_t)b * M * C;
  const I* ib = idx + (size_t)b * M;
  // the slab's row of cloud row m, or -1: a 64-bit test, so that no
  // index outside [d0, d0 + rows_w) (int64 ones too) can alias into it
  auto slab_row = [&](unsigned m) {
    const long long i = (long long)__ldg(ib + m) - d0;
    return i >= 0 && i < rows_w ? (int)i : -1;
  };

  for (int e = threadIdx.x; e < rows_w * (int)C; e += kScatterThreads)
    s_dx[e] = 0.0f;
  __syncthreads();
  const unsigned e1 = m1 * C;
  if (vec4) {
    // each thread: kUnroll 4-element loads of g (consecutive threads on
    // consecutive elements) and the indices of their rows (<= 2 a load
    // for C >= 4, <= 4 below), all loads issued before the first add; no
    // barrier until the end
    constexpr unsigned kStep = 4 * kScatterThreads;
    const int rows_per = C >= 4 ? 2 : 4;
    for (unsigned base = m0 * C + 4 * threadIdx.x; base < e1;
         base += kStep * kUnroll) {
      float4 v[kUnroll];
      int slab[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned e = base + u * kStep;
        if (e >= e1) break;
        v[u] = load4(gb + e);
        const unsigned row = e / C;
        const unsigned last = (e + 3) / C;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          slab[u][k] = k < rows_per && row + k <= last ? slab_row(row + k)
                                                       : -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned e = base + u * kStep;
        if (e >= e1) break;
        unsigned c = e - e / C * C;
        // the current row's slab row first; shifted at each row change
        int i0 = slab[u][0], i1 = slab[u][1], i2 = slab[u][2];
        const int i3 = slab[u][3];
        const float vals[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (i0 >= 0) atomicAdd(s_dx + i0 * C + c, vals[j]);
          if (++c == C) {
            c = 0;
            i0 = i1;
            i1 = i2;
            i2 = i3;
          }
        }
      }
    }
  } else {
    for (unsigned e = m0 * C + threadIdx.x; e < e1; e += kScatterThreads) {
      const unsigned row = e / C;
      const int i = slab_row(row);
      if (i >= 0)
        atomicAdd(s_dx + i * C + (e - row * C), r3dl::widen(__ldcs(gb + e)));
    }
  }
  __syncthreads();
  const size_t off = (size_t)b * n * C + (size_t)d0 * C;
  if (ranges > 1) {
    float* ob = part + (size_t)r * B * n * C + off;
    for (int e = threadIdx.x; e < rows_w * (int)C; e += kScatterThreads)
      ob[e] = s_dx[e];
  } else {
    T* ob = dx + off;
    for (int e = threadIdx.x; e < rows_w * (int)C; e += kScatterThreads)
      ob[e] = r3dl::narrow<T>(s_dx[e]);
  }
}

// dx = the sum of the ranges' fp32 partials, in order, rounded once to T;
// 4-element lanes when the partial's length is a multiple of 4
template <typename T>
__global__ void scatter_smallc_sum_kernel(const float* __restrict__ work,
                                          T* __restrict__ dx, long long n,
                                          int ranges) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (n % 4 == 0) {
    const float4* w4 = reinterpret_cast<const float4*>(work);
    const long long n4 = n / 4;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < n4; e += stride) {
      float4 v = w4[e];
      for (int r = 1; r < ranges; ++r) {
        const float4 p = w4[r * n4 + e];
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
      store4(dx + 4 * e, v);
    }
  } else {
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < n; e += stride) {
      float v = work[e];
      for (int r = 1; r < ranges; ++r) v += work[r * n + e];
      dx[e] = r3dl::narrow<T>(v);
    }
  }
}

// ---- K10 at bf16, C <= 8 ----

constexpr int kScatter16Warps = 32;
constexpr int kChunk16 = 128;     // rows a warp takes at a time, 4 a lane

// a block's shared memory: its slab of dx (fp32), then a warp's staged
// chunk of g (128 rows x 2 C bytes) and its list of the chunk's live rows
__host__ __device__ inline size_t scatter16_smem(int C, int window) {
  return scatter_smem(C, window) +
         (size_t)kScatter16Warps * (2 * kChunk16 * C + 4 * kChunk16);
}

// A chunk of g as a warp loads it: lane l holds its 16-byte words l, l +
// 32, ... below 16 kC (the chunk's 128 rows), and the indices of rows
// 4 l .. 4 l + 3.
template <int kC, typename I>
struct Chunk16 {
  static constexpr int kWords = (16 * kC + 31) / 32;
  uint4 w[kWords];
  I i[4];
};

// the chunk of rows [c0, c0 + 128) of the cloud's g and idx, none from m1
// on (index -1, g zero); 16-byte evict-first loads when `vec` (every
// cloud's g and indices 16-byte aligned, m1 kC a multiple of 8), 2- and
// 4- or 8-byte ones otherwise
template <int kC, typename I>
__device__ __forceinline__ void load_chunk16(const unsigned short* gb,
                                             const I* ib, int c0, int m1,
                                             bool vec, int lane,
                                             Chunk16<kC, I>& t) {
  const int r = c0 + 4 * lane;
  if (vec && r + 4 <= m1) {
    if constexpr (sizeof(I) == 4) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(ib + r));
      t.i[0] = v.x, t.i[1] = v.y, t.i[2] = v.z, t.i[3] = v.w;
    } else {
      const longlong2* p = reinterpret_cast<const longlong2*>(ib + r);
      const longlong2 v0 = __ldcs(p), v1 = __ldcs(p + 1);
      t.i[0] = v0.x, t.i[1] = v0.y, t.i[2] = v1.x, t.i[3] = v1.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      t.i[k] = r + k < m1 ? __ldcs(ib + r + k) : I(-1);
  }
  const long long e0 = (long long)c0 * kC, e1 = (long long)m1 * kC;
#pragma unroll
  for (int j = 0; j < Chunk16<kC, I>::kWords; ++j) {
    const int w = lane + 32 * j;
    const long long e = e0 + 8 * w;
    if (vec) {
      t.w[j] = w < 16 * kC && e < e1
                   ? __ldcs(reinterpret_cast<const uint4*>(gb + e))
                   : make_uint4(0, 0, 0, 0);
    } else {
      uint32_t h[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        h[k] = w < 16 * kC && e + k < e1 ? __ldcs(gb + e + k) : 0;
      t.w[j] = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                          h[4] | h[5] << 16, h[6] | h[7] << 16);
    }
  }
}

// K10 at bf16 for C <= 8: the plan and output of scatter_smallc_kernel (a
// block owns (range, cloud, slab), keeps an fp32 copy of its slab of dx in
// shared memory and writes it once: rounded into dx, or into its partial),
// with each warp walking the range in chunks of 128 rows. A warp loads a
// chunk coalesced (16-byte words) and stages it in shared memory, then
// issues the next chunk's loads; per row k of a lane's 4, a ballot and a
// prefix count put the warp's live rows on its list (chunk row, slab
// row); the adds then take a listed row's kC values on kC lanes, 32 / kC
// rows an instruction (shared fp32 atomicAdd, a compare-and-swap loop on
// the H100), where a row's elements had ~5 live lanes of 32. 32 warps, so
// that many adds' latencies overlap.
template <int kC, typename I>
__global__ void __launch_bounds__(kScatter16Warps * 32, 1)
    scatter_smallc16_kernel(const unsigned short* __restrict__ g,
                            const I* __restrict__ idx,
                            r3dl::bf16* __restrict__ dx,
                            float* __restrict__ part, int B, int n, int M,
                            int ranges, int window, bool vec) {
  extern __shared__ float4 smem4[];
  float* s_dx = reinterpret_cast<float*>(smem4);
  const int r = blockIdx.x, b = blockIdx.y;
  const int d0 = blockIdx.z * window;
  const int rows_w = min(window, n - d0);
  const int nt = (M + kTileRows - 1) / kTileRows;
  const int m0 = min(M, (int)((long long)r * nt / ranges) * kTileRows);
  const int m1 = min(M, (int)((long long)(r + 1) * nt / ranges) * kTileRows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  char* own = reinterpret_cast<char*>(s_dx) + scatter_smem(kC, window) +
              (size_t)warp * (2 * kChunk16 * kC + 4 * kChunk16);
  uint4* s_g = reinterpret_cast<uint4*>(own);
  const unsigned short* s_g16 = reinterpret_cast<const unsigned short*>(own);
  int* s_list = reinterpret_cast<int*>(own + 2 * kChunk16 * kC);
  const unsigned short* gb = g + (size_t)b * M * kC;
  const I* ib = idx + (size_t)b * M;
  // the adds: a listed row's channel c on lane q kC + c, q < 32 / kC
  constexpr int kPer = 32 / kC;
  const int q = lane / kC, c = lane - q * kC;

  for (int e = threadIdx.x; e < rows_w * kC; e += kScatter16Warps * 32)
    s_dx[e] = 0.0f;
  __syncthreads();
  constexpr int kStep = kScatter16Warps * kChunk16;
  Chunk16<kC, I> t;
  int c0 = m0 + warp * kChunk16;
  if (c0 < m1) load_chunk16<kC>(gb, ib, c0, m1, vec, lane, t);
  for (; c0 < m1; c0 += kStep) {
#pragma unroll
    for (int j = 0; j < Chunk16<kC, I>::kWords; ++j)
      if (lane + 32 * j < 16 * kC) s_g[lane + 32 * j] = t.w[j];
    int count = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long i = (long long)t.i[k] - d0;
      const bool live = i >= 0 && i < rows_w;
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live)
        s_list[count + __popc(mask & ((1u << lane) - 1))] =
            (int)i << 7 | (4 * lane + k);
      count += __popc(mask);
    }
    if (c0 + kStep < m1)
      load_chunk16<kC>(gb, ib, c0 + kStep, m1, vec, lane, t);
    __syncwarp();
    if (q < kPer) {
      for (int e = q; e < count; e += kPer) {
        const int item = s_list[e];
        atomicAdd(s_dx + (item >> 7) * kC + c,
                  __uint_as_float((uint32_t)s_g16[(item & 127) * kC + c]
                                  << 16));
      }
    }
    __syncwarp();
  }
  __syncthreads();
  const size_t off = (size_t)b * n * kC + (size_t)d0 * kC;
  if (ranges > 1) {
    float* ob = part + (size_t)r * B * n * kC + off;
    for (int e = threadIdx.x; e < rows_w * kC; e += kScatter16Warps * 32)
      ob[e] = s_dx[e];
  } else {
    r3dl::bf16* ob = dx + off;
    for (int e = threadIdx.x; e < rows_w * kC; e += kScatter16Warps * 32)
      ob[e] = __float2bfloat16_rn(s_dx[e]);
  }
}

template <int kC, typename I>
int launch_scatter16(const r3dl::bf16* g, const void* idx, r3dl::bf16* dx,
                     float* work, int B, int n, int M, int ranges,
                     int window, cudaStream_t stream) {
  const size_t smem = scatter16_smem(kC, window);
  static const cudaError_t attr =
      r3dl::allow_smem(scatter_smallc16_kernel<kC, I>, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(ranges, B, (n + window - 1) / window);
  // 16-byte loads when every cloud's g and indices start 16-byte aligned
  const bool vec = (long long)M * kC % 8 == 0 && M % 4 == 0 &&
                   (uintptr_t)g % 16 == 0 && (uintptr_t)idx % 16 == 0;
  scatter_smallc16_kernel<kC, I><<<grid, kScatter16Warps * 32, smem, stream>>>(
      reinterpret_cast<const unsigned short*>(g), static_cast<const I*>(idx),
      dx, work, B, n, M, ranges, window, vec);
  return (int)cudaGetLastError();
}

template <int kC>
int scatter16_c(const r3dl::bf16* g, const void* idx, r3dl::bf16* dx,
                float* work, int B, int n, int M, int C, int idx64,
                int ranges, int window, cudaStream_t stream) {
  if constexpr (kC > 8) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (C != kC)
      return scatter16_c<kC + 1>(g, idx, dx, work, B, n, M, C, idx64, ranges,
                                 window, stream);
    return idx64 ? launch_scatter16<kC, long long>(g, idx, dx, work, B, n, M,
                                                    ranges, window, stream)
                 : launch_scatter16<kC, int>(g, idx, dx, work, B, n, M,
                                             ranges, window, stream);
  }
}

template <int kC, typename I, typename T>
int launch_scatter(const T* g, const void* idx, T* dx, float* work, int B,
                   int n, int M, int C, int ranges, int window,
                   cudaStream_t stream) {
  static const cudaError_t attr =
      r3dl::allow_smem(scatter_smallc_kernel<kC, I, T>, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(ranges, B, (n + window - 1) / window);
  // 4-element loads when every cloud's and range's g starts aligned to
  // them (16 bytes fp32, 8 bf16)
  const bool vec4 = (long long)M * C % 4 == 0 &&
                    (uintptr_t)g % (4 * sizeof(T)) == 0;
  scatter_smallc_kernel<kC, I, T>
      <<<grid, kScatterThreads, scatter_smem(C, window), stream>>>(
          g, static_cast<const I*>(idx), dx, work, B, n, M, C, ranges,
          window, vec4);
  return (int)cudaGetLastError();
}

template <typename I, typename T>
int launch_scatter_c(const T* g, const void* idx, T* dx, float* work, int B,
                     int n, int M, int C, int ranges, int window,
                     cudaStream_t stream) {
  switch (C) {
    case 4:
      return launch_scatter<4, I, T>(g, idx, dx, work, B, n, M, C, ranges,
                                     window, stream);
    case 5:
      return launch_scatter<5, I, T>(g, idx, dx, work, B, n, M, C, ranges,
                                     window, stream);
    case 7:
      return launch_scatter<7, I, T>(g, idx, dx, work, B, n, M, C, ranges,
                                     window, stream);
    default:
      return launch_scatter<0, I, T>(g, idx, dx, work, B, n, M, C, ranges,
                                     window, stream);
  }
}

template <typename T>
int scatter_smallc(const T* g, const void* idx, T* dx, float* work, int B,
                   int n, int M, int C, int idx64, int ranges, int window,
                   long long work_bytes, cudaStream_t stream) {
  if (B == 0 || n == 0 || C == 0) return (int)cudaGetLastError();
  const int nt = (M + kTileRows - 1) / kTileRows;
  const long long total = (long long)B * n * C;
  // bf16 with C <= 8: scatter_smallc16_kernel; scatter_smallc_kernel else
  const bool list16 = sizeof(T) == 2 && C <= 8;
  if (B > kMaxGridY || C < 1 || C > 32 || M < 0 || ranges < 1 ||
      ranges > 65535 || (ranges > 1 && ranges > nt) || window < 1 ||
      (n + window - 1) / window > kMaxGridY ||
      (list16 ? scatter16_smem(C, window) : scatter_smem(C, window)) >
          (size_t)kMaxSmem ||
      (long long)n * C >= (1LL << 31) || (long long)M * C >= (1LL << 31) ||
      (ranges > 1 && (!work || work_bytes < 4 * ranges * total)) ||
      (ranges > 1 && total % 4 == 0 && (uintptr_t)dx % (4 * sizeof(T))))
    return (int)cudaErrorInvalidValue;
  int err;
  if constexpr (sizeof(T) == 2) {
    err = list16 ? scatter16_c<1>(g, idx, dx, work, B, n, M, C, idx64,
                                  ranges, window, stream)
          : idx64 ? launch_scatter<0, long long, T>(g, idx, dx, work, B, n, M,
                                                   C, ranges, window, stream)
                  : launch_scatter<0, int, T>(g, idx, dx, work, B, n, M, C,
                                              ranges, window, stream);
  } else {
    err = idx64 ? launch_scatter_c<long long, T>(g, idx, dx, work, B, n, M,
                                                 C, ranges, window, stream)
                : launch_scatter_c<int, T>(g, idx, dx, work, B, n, M, C,
                                           ranges, window, stream);
  }
  if (err != cudaSuccess || ranges == 1) return err;
  const long long lanes = total % 4 == 0 ? total / 4 : total;
  const long long blocks = (lanes + 255) / 256;
  scatter_smallc_sum_kernel<T>
      <<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
          work, dx, total, ranges);
  return (int)cudaGetLastError();
}

template <typename I>
void launch_smallc(const float* x, const void* idx, float* out, int B, int N,
                   int M, int C, bool vec4, cudaStream_t stream) {
  const dim3 grid((M + kTileRows - 1) / kTileRows, B);
  const I* ix = static_cast<const I*>(idx);
  if (C == 4)
    gather_smallc_kernel<4, I><<<grid, kThreads, 0, stream>>>(
        x, ix, out, N, M, C, vec4);
  else if (C == 5)
    gather_smallc_kernel<5, I><<<grid, kThreads, 0, stream>>>(
        x, ix, out, N, M, C, vec4);
  else
    gather_smallc_kernel<0, I><<<grid, kThreads, 0, stream>>>(
        x, ix, out, N, M, C, vec4);
}

template <int kC, typename I>
void launch_smallc16(const unsigned short* x, const void* idx,
                     unsigned short* out, int B, int N, int M, bool vec_idx,
                     cudaStream_t stream) {
  using R = Row16<kC>;
  const dim3 grid((M + R::kTile - 1) / R::kTile, B);
  gather_smallc16_kernel<kC, I><<<grid, R::kThreads, 0, stream>>>(
      x, static_cast<const I*>(idx), out, N, M, vec_idx);
}

// the kernel of C (1..32) channels
template <int kC>
void smallc16_c(const unsigned short* x, const void* idx, unsigned short* out,
                int B, int N, int M, int C, int idx64, bool vec_idx,
                cudaStream_t stream) {
  if constexpr (kC <= 32) {
    if (C != kC)
      return smallc16_c<kC + 1>(x, idx, out, B, N, M, C, idx64, vec_idx,
                                stream);
    if (idx64)
      launch_smallc16<kC, long long>(x, idx, out, B, N, M, vec_idx, stream);
    else
      launch_smallc16<kC, int>(x, idx, out, B, N, M, vec_idx, stream);
  }
}

}  // namespace

// x: (B, N, C <= 32); idx: (B, M) int32 (idx64 = 0) or int64 (idx64 = 1),
// any value; out: (B, M, C)
extern "C" int r3dl_gather_smallc(const float* x, const void* idx, float* out,
                                  int B, int N, int M, int C, int idx64,
                                  cudaStream_t stream) {
  if (B == 0 || M == 0 || C == 0) return (int)cudaGetLastError();
  if (B > kMaxGridY || C > 32 || (long long)N * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  // float4 stores from an aligned start
  const bool vec4 = (long long)M * C % 4 == 0 && (uintptr_t)out % 16 == 0;
  if (idx64)
    launch_smallc<long long>(x, idx, out, B, N, M, C, vec4, stream);
  else
    launch_smallc<int>(x, idx, out, B, N, M, C, vec4, stream);
  return (int)cudaGetLastError();
}

// The same for 2-byte (bf16) elements: gather_smallc16_kernel.
extern "C" int r3dl_gather_smallc16(const unsigned short* x, const void* idx,
                                    unsigned short* out, int B, int N, int M,
                                    int C, int idx64, cudaStream_t stream) {
  if (B == 0 || M == 0 || C == 0) return (int)cudaGetLastError();
  if (B > kMaxGridY || C < 1 || C > 32 || (long long)N * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const bool vec_idx = M % 4 == 0 && (uintptr_t)idx % 16 == 0;
  smallc16_c<1>(x, idx, out, B, N, M, C, idx64, vec_idx, stream);
  return (int)cudaGetLastError();
}

// g: (B, M, C <= 32) fp32; idx: (B, M) int32 (idx64 = 0) or int64
// (idx64 = 1), any value; dx: (B, n, C), every element written here. The
// plan (ranges, window) is ops/gather.py scatter_smallc_plan's; work holds
// ranges * B * n * C floats when ranges > 1 (NULL otherwise).
extern "C" int r3dl_scatter_smallc_add(const float* g, const void* idx,
                                       float* dx, float* work, int B, int n,
                                       int M, int C, int idx64, int ranges,
                                       int window, long long work_bytes,
                                       cudaStream_t stream) {
  return scatter_smallc<float>(g, idx, dx, work, B, n, M, C, idx64, ranges,
                               window, work_bytes, stream);
}

// The same with bf16 g and dx (the fp32 sums rounded to bf16 once); work
// still fp32.
extern "C" int r3dl_scatter_smallc_add_bf16(const r3dl::bf16* g,
                                            const void* idx, r3dl::bf16* dx,
                                            float* work, int B, int n, int M,
                                            int C, int idx64, int ranges,
                                            int window, long long work_bytes,
                                            cudaStream_t stream) {
  return scatter_smallc<r3dl::bf16>(g, idx, dx, work, B, n, M, C, idx64,
                                    ranges, window, work_bytes, stream);
}
