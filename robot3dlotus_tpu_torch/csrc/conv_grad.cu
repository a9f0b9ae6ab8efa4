// K7: weight gradient of a submanifold conv on a (B, N, K) neighbour map
//   dW[k, c, o] = sum_{b, n} ok[b, n, k] * x[b, idx[b, n, k], c] * g[b, n, o]
// x: (B, N, Cin) fp32; idx / ok: (B, N, K); g: (B, N, Cout) the cotangent of
// the conv output; dW: (K, Cin, Cout) fp32. Serves both the k=3 CPE conv
// (K2's weight, Cin = Cout = 64..768) and the k=5 stem (K3's weight,
// K = 125, Cin = 7, Cout = 64).
//
// Replaces robot3dlotus_tpu/ops/pallas_conv.py `_dw_windowed`
// (_dw_kernel), which gathered each tap's sources through one-hot MXU
// products inside a sorted-order VMEM window and accumulated one resident
// dW tap block across the sequential (b, t) grid, plus the XLA `_dw_far`
// pass for links outside the window. Here the kernel reads the (B, N, K)
// map directly: no window, no far list.
//
// Bound: operations (2 Cin Cout flops per live link against Cin + Cout
// floats per row). Design (simple first, no atomics): dW is viewed as a
// (K * Cin, Cout) matrix, A[r, a] = ok[r, k] x[b, idx[r, k], c] with
// a = k * Cin + c and r = b * N + n, so dW = A^T g is one product over the
// B * N rows -- the stem's 125 x 7 taps and channels fill a tile as well as
// a CPE conv's 64 channels of one tap. One block per (64 a) x (64 outputs)
// tile and per split of the rows; 256 threads each accumulate a 4 x 4
// register tile in fp32 over chunks of 16 rows staged in shared memory
// (gathered x, zeros where !ok; the matching g rows). A chunk in which no
// row has a live link in the tile is skipped. With more than one split
// each block writes its partial tile to a workspace and a second kernel
// sums the splits in a fixed order, so the result is deterministic.
// wgmma/TF32 tiles are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kTA = 64;   // rows of dW (k, c pairs) per block
constexpr int kTC = 64;   // output channels per block
constexpr int kRK = 16;   // cloud rows per shared-memory stage
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
conv_weight_grad_kernel(const float* __restrict__ x,
                        const int* __restrict__ idx,
                        const unsigned char* __restrict__ ok,
                        const float* __restrict__ g, float* __restrict__ part,
                        int N, int K, int Cin, int Cout, long long R,
                        long long rows_per_split) {
  __shared__ float as[kRK][kTA];
  __shared__ float gs[kRK][kTC];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int a0 = blockIdx.x * kTA;
  const int co0 = blockIdx.y * kTC;
  const long long KC = (long long)K * Cin;
  const long long r_begin = blockIdx.z * rows_per_split;
  const long long r_end =
      r_begin + rows_per_split < R ? r_begin + rows_per_split : R;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long r0 = r_begin; r0 < r_end; r0 += kRK) {
    int live = 0;
#pragma unroll
    for (int t = 0; t < kRK * kTA / kThreads; ++t) {
      const int e = tid + t * kThreads;
      const int rr = e / kTA, aa = e % kTA;
      const long long r = r0 + rr;
      const int a = a0 + aa;
      float val = 0.f;
      if (r < r_end && a < KC) {
        const int k = a / Cin, c = a - k * Cin;
        const long long off = r * K + k;
        if (ok[off]) {
          const long long b = r / N;
          val = x[(b * N + idx[off]) * Cin + c];
          live = 1;
        }
      }
      as[rr][aa] = val;
    }
#pragma unroll
    for (int t = 0; t < kRK * kTC / kThreads; ++t) {
      const int e = tid + t * kThreads;
      const int rr = e / kTC, cc = e % kTC;
      const long long r = r0 + rr;
      const int co = co0 + cc;
      gs[rr][cc] = (r < r_end && co < Cout) ? g[r * Cout + co] : 0.f;
    }
    if (__syncthreads_or(live)) {
#pragma unroll
      for (int rr = 0; rr < kRK; ++rr) {
        float av[4], gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = as[rr][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) gv[j] = gs[rr][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], gv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* out = part + blockIdx.z * KC * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = a0 + ty + 16 * i;
    if (a >= KC) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx + 16 * j;
      if (co < Cout) out[(long long)a * Cout + co] = acc[i][j];
    }
  }
}

__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ dw, long long n,
                                  int splits) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += part[sp * n + e];
    dw[e] = s;
  }
}

}  // namespace

// work: (splits, K, Cin, Cout) fp32 scratch, unused (may be NULL) when
// splits == 1; rows_per_split a multiple of 16 with splits * rows_per_split
// >= B * N.
extern "C" int r3dl_conv_weight_grad(const float* x, const int* idx,
                                     const unsigned char* ok, const float* g,
                                     float* work, float* dw, int B, int N,
                                     int K, int Cin, int Cout, int splits,
                                     long long rows_per_split,
                                     cudaStream_t stream) {
  const long long R = (long long)B * N;
  const long long n = (long long)K * Cin * Cout;
  if (n == 0) return (int)cudaGetLastError();
  if (splits < 1 || rows_per_split % kRK ||
      (long long)splits * rows_per_split < R || (splits > 1 && !work))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((K * Cin + kTA - 1) / kTA),
                  (unsigned)((Cout + kTC - 1) / kTC), (unsigned)splits);
  conv_weight_grad_kernel<<<grid, kThreads, 0, stream>>>(
      x, idx, ok, g, splits > 1 ? work : dw, N, K, Cin, Cout, R,
      rows_per_split);
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (n + 255) / 256;
    sum_splits_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                        stream>>>(work, dw, n, splits);
  }
  return (int)cudaGetLastError();
}
