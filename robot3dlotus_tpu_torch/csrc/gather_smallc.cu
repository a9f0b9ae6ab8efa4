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
// one cloud (80 KB at N = 4096, C = 5) stays in L1/L2, so each thread
// copies one element; none of the one-hot decomposition is carried over.
//
// Bound: bytes for both (no arithmetic beyond K10's adds): the indices
// read, the rows written (K9) or read (K10), the source read (K9) or
// written (K10), over the 3.35 TB/s memory rate. Design: one thread per
// output element (row m, channel c), so neighbouring threads write
// neighbouring addresses; 64-bit element offsets (a training step's stem
// gather has B * M * C = 32 * 512,000 * 5 = 82M elements); a grid-stride
// loop. K10 zeroes dx with cudaMemsetAsync and adds with fp32 atomicAdd:
// a stem cloud sends about 125 adds into each destination row, so sums
// agree with a fixed-order sum to rounding, not bit for bit. K9 only
// copies, so it equals its plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_smallc_kernel(const float* __restrict__ x,
                                     const int* __restrict__ idx,
                                     float* __restrict__ out, int N, int M,
                                     int C, long long total) {
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kThreads) {
    const long long row = e / C;
    const int c = (int)(e - row * C);
    const long long b = row / M;
    const int i = idx[row];
    out[e] = (i >= 0 && i < N) ? x[(b * N + i) * C + c] : 0.0f;
  }
}

__global__ void scatter_smallc_add_kernel(const float* __restrict__ g,
                                          const int* __restrict__ idx,
                                          float* __restrict__ dx, int N,
                                          int M, int C, long long total) {
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kThreads) {
    const long long row = e / C;
    const int i = idx[row];
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

}  // namespace

// x: (B, N, C); idx: (B, M), any int; out: (B, M, C)
extern "C" int r3dl_gather_smallc(const float* x, const int* idx, float* out,
                                  int B, int N, int M, int C,
                                  cudaStream_t stream) {
  const long long total = (long long)B * M * C;
  if (total == 0) return (int)cudaGetLastError();
  gather_smallc_kernel<<<grid_for(total), kThreads, 0, stream>>>(
      x, idx, out, N, M, C, total);
  return (int)cudaGetLastError();
}

// g: (B, M, C); idx: (B, M), any int; dx: (B, N, C), zeroed here
extern "C" int r3dl_scatter_smallc_add(const float* g, const int* idx,
                                       float* dx, int B, int N, int M, int C,
                                       cudaStream_t stream) {
  const cudaError_t err = cudaMemsetAsync(
      dx, 0, (size_t)B * N * C * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * M * C;
  if (total == 0) return (int)cudaGetLastError();
  scatter_smallc_add_kernel<<<grid_for(total), kThreads, 0, stream>>>(
      g, idx, dx, N, M, C, total);
  return (int)cudaGetLastError();
}
