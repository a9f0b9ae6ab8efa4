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
// plain version bit for bit. bf16 rows (r3dl_gather_smallc16, the motion
// planner's categorical stem under compute_dtype bfloat16) take the same
// kernel on 2-byte elements, 4 of them an 8-byte store; still a copy.
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
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 1024;   // K9 rows per block; a multiple of 4
constexpr int kMaxGridY = 65535;

// 4 consecutive elements of one output
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(unsigned short* p,
                                       const unsigned short (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(v[0] | (unsigned)v[1] << 16, v[2] | (unsigned)v[3] << 16);
}

// T: float, or unsigned short holding bf16 bits
template <int kC, typename I, typename T>
__global__ void __launch_bounds__(kThreads)
    gather_smallc_kernel(const T* __restrict__ x,
                         const I* __restrict__ idx, T* __restrict__ out,
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
  const T* xb = x + (long long)b * N * C;
  T* ob = out + ((long long)b * M + r0) * C;
  const int total = rows * C;
  if (vec4) {
    for (int e = 4 * threadIdx.x; e < total; e += 4 * kThreads) {
      int row = e / C;
      int c = e - row * C;
      T v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = e + j < total ? s_idx[row] : -1;
        v[j] = i >= 0 ? __ldg(xb + i * C + c) : T(0);
        if (++c == C) {
          c = 0;
          ++row;
        }
      }
      if (e + 4 <= total) {
        store4(ob + e, v);
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
      ob[e] = i >= 0 ? __ldg(xb + i * C + (e - row * C)) : T(0);
    }
  }
}

constexpr int kScatterThreads = 1024;
constexpr int kUnroll = 2;         // float4 loads of g in flight a thread
constexpr int kMaxSmem = 227 * 1024;

__host__ __device__ inline size_t scatter_smem(int C, int window) {
  return ((size_t)4 * window * C + 15) / 16 * 16;
}

// dx[b, i, c] += g[b, m, c] for the rows m of range blockIdx.x and the
// destination rows i of slab blockIdx.z, into a shared-memory copy of the
// slab written once at the end (into out: dx, or the range's partial)
template <int kC, typename I>
__global__ void __launch_bounds__(kScatterThreads, 2)
    scatter_smallc_kernel(const float* __restrict__ g,
                          const I* __restrict__ idx, float* __restrict__ out,
                          int B, int n, int M, int c_rt, int ranges,
                          int window, bool vec4) {
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
  const float* gb = g + (size_t)b * M * C;
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
    // each thread: kUnroll float4 of g (consecutive threads on consecutive
    // 16 bytes) and the indices of their rows (<= 2 a float4 for C >= 4,
    // <= 4 below), all loads issued before the first add; no barrier
    // until the end
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
        v[u] = __ldcs(reinterpret_cast<const float4*>(gb + e));
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
      if (i >= 0) atomicAdd(s_dx + i * C + (e - row * C), __ldcs(gb + e));
    }
  }
  __syncthreads();
  float* ob = out + ((ranges > 1 ? (size_t)r * B : 0) + b) * n * C +
              (size_t)d0 * C;
  for (int e = threadIdx.x; e < rows_w * (int)C; e += kScatterThreads)
    ob[e] = s_dx[e];
}

// dx = the sum of the ranges' partials, in order; float4 lanes when the
// partial's length is a multiple of 4
__global__ void scatter_smallc_sum_kernel(const float* __restrict__ work,
                                          float* __restrict__ dx,
                                          long long n, int ranges) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (n % 4 == 0) {
    const float4* w4 = reinterpret_cast<const float4*>(work);
    float4* d4 = reinterpret_cast<float4*>(dx);
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
      d4[e] = v;
    }
  } else {
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < n; e += stride) {
      float v = work[e];
      for (int r = 1; r < ranges; ++r) v += work[r * n + e];
      dx[e] = v;
    }
  }
}

template <int kC, typename I>
int launch_scatter(const float* g, const void* idx, float* dx, float* work,
                   int B, int n, int M, int C, int ranges, int window,
                   cudaStream_t stream) {
  static const cudaError_t attr =
      r3dl::allow_smem(scatter_smallc_kernel<kC, I>, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(ranges, B, (n + window - 1) / window);
  // float4 loads when every cloud's and range's g starts 16-byte aligned
  const bool vec4 = (long long)M * C % 4 == 0 && (uintptr_t)g % 16 == 0;
  scatter_smallc_kernel<kC, I>
      <<<grid, kScatterThreads, scatter_smem(C, window), stream>>>(
          g, static_cast<const I*>(idx), ranges > 1 ? work : dx, B, n, M, C,
          ranges, window, vec4);
  return (int)cudaGetLastError();
}

template <typename I>
int launch_scatter_c(const float* g, const void* idx, float* dx, float* work,
                     int B, int n, int M, int C, int ranges, int window,
                     cudaStream_t stream) {
  switch (C) {
    case 4:
      return launch_scatter<4, I>(g, idx, dx, work, B, n, M, C, ranges,
                                  window, stream);
    case 5:
      return launch_scatter<5, I>(g, idx, dx, work, B, n, M, C, ranges,
                                  window, stream);
    case 7:
      return launch_scatter<7, I>(g, idx, dx, work, B, n, M, C, ranges,
                                  window, stream);
    default:
      return launch_scatter<0, I>(g, idx, dx, work, B, n, M, C, ranges,
                                  window, stream);
  }
}

template <typename I, typename T>
void launch_smallc(const T* x, const void* idx, T* out, int B, int N, int M,
                   int C, bool vec4, cudaStream_t stream) {
  const dim3 grid((M + kTileRows - 1) / kTileRows, B);
  const I* ix = static_cast<const I*>(idx);
  if (C == 4)
    gather_smallc_kernel<4, I, T><<<grid, kThreads, 0, stream>>>(
        x, ix, out, N, M, C, vec4);
  else if (C == 5)
    gather_smallc_kernel<5, I, T><<<grid, kThreads, 0, stream>>>(
        x, ix, out, N, M, C, vec4);
  else
    gather_smallc_kernel<0, I, T><<<grid, kThreads, 0, stream>>>(
        x, ix, out, N, M, C, vec4);
}

template <typename T>
int gather_smallc(const T* x, const void* idx, T* out, int B, int N, int M,
                  int C, int idx64, cudaStream_t stream) {
  if (B == 0 || M == 0 || C == 0) return (int)cudaGetLastError();
  if (B > kMaxGridY || C > 32 || (long long)N * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  // 4-element stores: 16 bytes (fp32) or 8 (bf16) from an aligned start
  const bool vec4 = (long long)M * C % 4 == 0 &&
                    (uintptr_t)out % (4 * sizeof(T)) == 0;
  if (idx64)
    launch_smallc<long long, T>(x, idx, out, B, N, M, C, vec4, stream);
  else
    launch_smallc<int, T>(x, idx, out, B, N, M, C, vec4, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, N, C <= 32); idx: (B, M) int32 (idx64 = 0) or int64 (idx64 = 1),
// any value; out: (B, M, C)
extern "C" int r3dl_gather_smallc(const float* x, const void* idx, float* out,
                                  int B, int N, int M, int C, int idx64,
                                  cudaStream_t stream) {
  return gather_smallc<float>(x, idx, out, B, N, M, C, idx64, stream);
}

// The same for 2-byte (bf16) elements.
extern "C" int r3dl_gather_smallc16(const unsigned short* x, const void* idx,
                                    unsigned short* out, int B, int N, int M,
                                    int C, int idx64, cudaStream_t stream) {
  return gather_smallc<unsigned short>(x, idx, out, B, N, M, C, idx64,
                                       stream);
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
  if (B == 0 || n == 0 || C == 0) return (int)cudaGetLastError();
  const int nt = (M + kTileRows - 1) / kTileRows;
  const long long total = (long long)B * n * C;
  if (B > kMaxGridY || C < 1 || C > 32 || M < 0 || ranges < 1 ||
      ranges > 65535 || (ranges > 1 && ranges > nt) || window < 1 ||
      (n + window - 1) / window > kMaxGridY ||
      scatter_smem(C, window) > (size_t)kMaxSmem ||
      (long long)n * C >= (1LL << 31) || (long long)M * C >= (1LL << 31) ||
      (ranges > 1 && (!work || work_bytes < 4 * ranges * total)))
    return (int)cudaErrorInvalidValue;
  const int err =
      idx64 ? launch_scatter_c<long long>(g, idx, dx, work, B, n, M, C,
                                          ranges, window, stream)
            : launch_scatter_c<int>(g, idx, dx, work, B, n, M, C, ranges,
                                    window, stream);
  if (err != cudaSuccess || ranges == 1) return err;
  const long long lanes = total % 4 == 0 ? total / 4 : total;
  const long long blocks = (lanes + 255) / 256;
  scatter_smallc_sum_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256,
                              0, stream>>>(work, dx, total, ranges);
  return (int)cudaGetLastError();
}
