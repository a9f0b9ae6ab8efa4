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
// plain version bit for bit. K10 zeroes dx with cudaMemsetAsync and adds
// with fp32 atomicAdd, one thread per element: a stem cloud sends about
// 125 adds into each destination row, so sums agree with a fixed-order sum
// to rounding, not bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 1024;   // K9 rows per block; a multiple of 4
constexpr int kMaxGridY = 65535;

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
        *reinterpret_cast<float4*>(ob + e) =
            make_float4(v[0], v[1], v[2], v[3]);
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

template <typename I>
__global__ void scatter_smallc_add_kernel(const float* __restrict__ g,
                                          const I* __restrict__ idx,
                                          float* __restrict__ dx, int N,
                                          int M, int C, long long total) {
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kThreads) {
    const long long row = e / C;
    const long long i = (long long)idx[row];
    if (i < 0 || i >= N) continue;
    const int c = (int)(e - row * C);
    const long long b = row / M;
    atomicAdd(dx + (b * N + i) * C + c, g[e]);
  }
}

unsigned grid_for(long long total) {
  // enough blocks to fill 132 SMs many times over; the loop covers the rest
  const long long want = (total + kThreads - 1) / kThreads;
  const long long cap = 132LL * 64;
  return (unsigned)(want < cap ? want : cap);
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

}  // namespace

// x: (B, N, C <= 32); idx: (B, M) int32 (idx64 = 0) or int64 (idx64 = 1),
// any value; out: (B, M, C)
extern "C" int r3dl_gather_smallc(const float* x, const void* idx, float* out,
                                  int B, int N, int M, int C, int idx64,
                                  cudaStream_t stream) {
  if (B == 0 || M == 0 || C == 0) return (int)cudaGetLastError();
  if (B > kMaxGridY || C > 32 || (long long)N * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const bool vec4 = (long long)M * C % 4 == 0 && (uintptr_t)out % 16 == 0;
  if (idx64)
    launch_smallc<long long>(x, idx, out, B, N, M, C, vec4, stream);
  else
    launch_smallc<int>(x, idx, out, B, N, M, C, vec4, stream);
  return (int)cudaGetLastError();
}

// g: (B, M, C); idx: (B, M) int32 or int64, any value; dx: (B, N, C),
// zeroed here
extern "C" int r3dl_scatter_smallc_add(const float* g, const void* idx,
                                       float* dx, int B, int N, int M, int C,
                                       int idx64, cudaStream_t stream) {
  const cudaError_t err = cudaMemsetAsync(
      dx, 0, (size_t)B * N * C * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * M * C;
  if (total == 0) return (int)cudaGetLastError();
  if (idx64)
    scatter_smallc_add_kernel<long long><<<grid_for(total), kThreads, 0,
                                           stream>>>(
        g, static_cast<const long long*>(idx), dx, N, M, C, total);
  else
    scatter_smallc_add_kernel<int><<<grid_for(total), kThreads, 0, stream>>>(
        g, static_cast<const int*>(idx), dx, N, M, C, total);
  return (int)cudaGetLastError();
}
