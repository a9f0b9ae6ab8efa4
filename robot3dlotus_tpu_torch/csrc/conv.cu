// K2: submanifold sparse conv as a gather-GEMM (the k=3 CPE conv)
//   out[b, n, :] = sum_k ok[b, n, k] * W[k]^T x[b, idx[b, n, k], :] + bias
// x: (B, N, Cin) fp32; idx: (B, N, K) int32; ok: (B, N, K) bool;
// W: (K, Cin, Cout) fp32 in stencil_offsets order; bias: (Cout,) or NULL.
//
// Replaces robot3dlotus_tpu/ops/pallas_conv.py `subm_conv_windowed`
// (_windowed_core / _conv_kernel, plus the XLA _far_correction for links
// outside the sorted-order window). The TPU kernel gathered through one-hot
// MXU products inside a VMEM window and sent the rest through capacity-
// bounded far lists. Here each block reads the (B, N, K) neighbour map
// directly, so there is no window, no far list and nothing that overflows.
//
// Bound: operations. 2 Cin Cout flops per live link against Cin + Cout
// floats of traffic per row: at C >= 64 the fp32 (non-tensor-core) rate of
// 67 TFLOP/s, not the 3.35 TB/s memory, sets the least time. Design
// (simple first): one block per tile of 64 output rows x 64 output
// channels, 256 threads, each accumulating a 4 x 4 register tile in fp32.
// The loop over the K taps gathers the tile's 64 neighbour rows, 16
// channels at a time, into shared memory (zeros where !ok), stages the
// matching 16 x 64 slice of W[k], and multiplies. A tap that no row of the
// tile uses is skipped (__syncthreads_or). Shared memory is 8.5 KB for any
// Cin, so C up to 768 needs no dynamic-smem attribute. No atomics: the sum
// order is fixed, so results are deterministic. wgmma/TF32 tiles and
// cp.async pipelining are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kTN = 64;   // output rows per block
constexpr int kTC = 64;   // output channels per block
constexpr int kCK = 16;   // input channels per shared-memory stage
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
subm_conv_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                 const unsigned char* __restrict__ ok,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 float* __restrict__ out, int N, int K, int Cin, int Cout) {
  __shared__ float xs[kTN][kCK];
  __shared__ float ws[kCK][kTC];
  __shared__ int sidx[kTN];
  __shared__ unsigned char sok[kTN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long b = blockIdx.z;
  const int n0 = blockIdx.x * kTN;
  const int co0 = blockIdx.y * kTC;
  const float* xb = x + b * N * (long long)Cin;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < K; ++k) {
    int live = 0;
    if (tid < kTN) {
      const int n = n0 + tid;
      int o = 0, id = 0;
      if (n < N) {
        const long long off = (b * N + n) * K + k;
        o = ok[off];
        id = idx[off];
      }
      sok[tid] = (unsigned char)o;
      sidx[tid] = id;
      live = o;
    }
    if (!__syncthreads_or(live)) continue;

    for (int c0 = 0; c0 < Cin; c0 += kCK) {
#pragma unroll
      for (int t = 0; t < kTN * kCK / kThreads; ++t) {
        const int e = tid + t * kThreads;
        const int r = e / kCK, cc = e % kCK, c = c0 + cc;
        xs[r][cc] = (sok[r] && c < Cin) ? xb[(long long)sidx[r] * Cin + c]
                                        : 0.f;
      }
#pragma unroll
      for (int t = 0; t < kCK * kTC / kThreads; ++t) {
        const int e = tid + t * kThreads;
        const int kk = e / kTC, col = e % kTC;
        const int c = c0 + kk, co = co0 + col;
        ws[kk][col] = (c < Cin && co < Cout)
                          ? w[((long long)k * Cin + c) * Cout + co]
                          : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int cc = 0; cc < kCK; ++cc) {
        float a[4], bw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][cc];
#pragma unroll
        for (int j = 0; j < 4; ++j) bw[j] = ws[cc][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx + 16 * j;
      if (co < Cout)
        out[(b * N + n) * Cout + co] = acc[i][j] + (bias ? bias[co] : 0.f);
    }
  }
}

}  // namespace

extern "C" int r3dl_subm_conv(const float* x, const int* idx,
                              const unsigned char* ok, const float* w,
                              const float* bias, float* out, int B, int N,
                              int K, int Cin, int Cout, cudaStream_t stream) {
  if ((long long)B * N * Cout == 0) return (int)cudaGetLastError();
  const dim3 grid((N + kTN - 1) / kTN, (Cout + kTC - 1) / kTC, B);
  subm_conv_kernel<<<grid, kThreads, 0, stream>>>(x, idx, ok, w, bias, out,
                                                  N, K, Cin, Cout);
  return (int)cudaGetLastError();
}
