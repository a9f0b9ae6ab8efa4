// K3: the fused k=5 stem conv (gather + stencil product, no bias)
//   out[b, n, :] = sum_k ok[b, n, k] * W[k]^T x[b, idx[b, n, k], :]
// x: (B, N, Cin <= 8) fp32; idx / ok: (B, N, K = 125); W: (K, Cin, Cout).
//
// Replaces robot3dlotus_tpu/ops/pallas_stem.py `stem_gather_windowed`
// (_gather_call / _gather_kernel), which gathered the 125 taps of
// 8-channel rows through one-hot MXU products inside a sorted-order window
// into a (B, N, 125 * 8) buffer that XLA then multiplied by the stencil
// weight (ops/sparse_conv.py:298). Here gather and product are one kernel
// and the (B, N, 1000) intermediate never reaches device memory.
//
// Bound: operations (2 Cin Cout flops per live link, 896 at Cin = 7,
// Cout = 64, against 7 floats gathered per link). The whole fp32 weight,
// 125 x 8 x 64 x 4 B = 256 KB, is over the 227 KB a block may hold, so it
// streams through shared memory in chunks of 8 taps: per chunk the block
// gathers its 64 rows x 8 taps x 8 channels (zero-padding Cin to 8 and
// zeros where !ok) and the matching 64 x 64 slice of W, then each of 256
// threads accumulates a 4 x 4 register tile in fp32 (33 KB of static
// shared memory in all). No atomics, so results are deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int kTN = 64;            // output rows per block
constexpr int kTC = 64;            // output channels per block
constexpr int kCp = 8;             // channels per tap after padding
constexpr int kKT = 8;             // taps per shared-memory stage
constexpr int kR = kKT * kCp;      // reduction depth per stage
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stem_conv_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                 const unsigned char* __restrict__ ok,
                 const float* __restrict__ w, float* __restrict__ out, int N,
                 int K, int Cin, int Cout) {
  __shared__ float xs[kTN][kR + 1];  // +1: rows ty and ty+1 on other banks
  __shared__ float ws[kR][kTC];
  __shared__ int sidx[kTN][kKT];
  __shared__ unsigned char sok[kTN][kKT];

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

  for (int k0 = 0; k0 < K; k0 += kKT) {
    for (int e = tid; e < kTN * kKT; e += kThreads) {
      const int r = e / kKT, kk = e % kKT;
      const int n = n0 + r, k = k0 + kk;
      const bool in = n < N && k < K;
      const long long off = (b * N + n) * K + k;
      sok[r][kk] = in ? ok[off] : 0;
      sidx[r][kk] = in ? idx[off] : 0;
    }
    __syncthreads();
    for (int e = tid; e < kTN * kR; e += kThreads) {
      const int r = e / kR, rr = e % kR;
      const int kk = rr / kCp, c = rr % kCp;
      xs[r][rr] = (sok[r][kk] && c < Cin)
                      ? xb[(long long)sidx[r][kk] * Cin + c]
                      : 0.f;
    }
    for (int e = tid; e < kR * kTC; e += kThreads) {
      const int rr = e / kTC, col = e % kTC;
      const int k = k0 + rr / kCp, c = rr % kCp, co = co0 + col;
      ws[rr][col] = (k < K && c < Cin && co < Cout)
                        ? w[((long long)k * Cin + c) * Cout + co]
                        : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kR; ++rr) {
      float a[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][rr];
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = ws[rr][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx + 16 * j;
      if (co < Cout) out[(b * N + n) * Cout + co] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int r3dl_stem_conv(const float* x, const int* idx,
                              const unsigned char* ok, const float* w,
                              float* out, int B, int N, int K, int Cin,
                              int Cout, cudaStream_t stream) {
  if (Cin < 1 || Cin > kCp) return (int)cudaErrorInvalidValue;
  if ((long long)B * N * Cout == 0) return (int)cudaGetLastError();
  const dim3 grid((N + kTN - 1) / kTN, (Cout + kTC - 1) / kTC, B);
  stem_conv_kernel<<<grid, kThreads, 0, stream>>>(x, idx, ok, w, out, N, K,
                                                  Cin, Cout);
  return (int)cudaGetLastError();
}
