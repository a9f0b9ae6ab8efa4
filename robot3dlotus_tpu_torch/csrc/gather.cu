// K4: batched row gather  out[b, m, :] = x[b, idx[b, m], :]
//
// Replaces robot3dlotus_tpu/ops/pallas_gather.py `permute_rows`
// (_permute_fwd_call / _fwd_kernel), which gathered rows on the TPU as a
// one-hot (P, N) x (N, C) matrix product so that HBM saw only contiguous
// reads. On the H100 a scattered row read is cheap, so the kernel reads
// each gathered row directly.
//
// Bound: bytes. It does no arithmetic; the least time is (rows read + rows
// written + indices) over the 3.35 TB/s memory rate. Design: one warp per
// output row, 16-byte vector copies when the row width allows them (D % 4
// == 0 and aligned pointers), 4-byte copies otherwise (the stage-0 entry
// sort gathers 7-channel rows). idx must be in range: unpool_gather pads
// a zero row at child_cap and points dropped points at it, so the kernel
// does not clamp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kVec4>
__global__ void gather_rows_kernel(const float* __restrict__ x,
                                   const int* __restrict__ idx,
                                   float* __restrict__ out, int N, int M,
                                   int D, long long rows) {
  const long long row = (long long)blockIdx.x * kWarpsPerBlock +
                        threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long b = row / M;
  const long long src = b * N + idx[row];
  if (kVec4) {
    const float4* xs = reinterpret_cast<const float4*>(x + src * D);
    float4* o = reinterpret_cast<float4*>(out + row * D);
    for (int c = lane; c < D / 4; c += 32) o[c] = xs[c];
  } else {
    const float* xs = x + src * D;
    float* o = out + row * D;
    for (int c = lane; c < D; c += 32) o[c] = xs[c];
  }
}

}  // namespace

extern "C" int r3dl_gather_rows(const float* x, const int* idx, float* out,
                                int B, int N, int M, int D,
                                cudaStream_t stream) {
  const long long rows = (long long)B * M;
  if (rows == 0 || D == 0) return (int)cudaGetLastError();
  const unsigned blocks =
      (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const bool vec4 = D % 4 == 0 && ((uintptr_t)x % 16 == 0) &&
                    ((uintptr_t)out % 16 == 0);
  if (vec4)
    gather_rows_kernel<true><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        x, idx, out, N, M, D, rows);
  else
    gather_rows_kernel<false><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        x, idx, out, N, M, D, rows);
  return (int)cudaGetLastError();
}
