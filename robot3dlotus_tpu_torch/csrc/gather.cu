// K4: batched row gather        out[b, m, :] = x[b, idx[b, m], :]
// K8: its backward, scatter-add  dx[b, idx[b, m], :] += g[b, m, :]
//
// K4 replaces robot3dlotus_tpu/ops/pallas_gather.py `permute_rows`
// (_permute_fwd_call / _fwd_kernel), which gathered rows on the TPU as a
// one-hot (P, N) x (N, C) matrix product so that HBM saw only contiguous
// reads. On the H100 a scattered row read is cheap, so the kernel reads
// each gathered row directly.
//
// K8 replaces `_permute_bwd_call` / `_bwd_kernel` (the custom VJP of
// permute_rows), which accumulated dx[b] in VMEM through the transposed
// one-hot across row tiles. Here each cotangent row is added into its
// destination row with fp32 atomicAdd: duplicate indices (the duplicate
// padding of ops/patching.py maps several rows onto one source row) sum
// correctly, but in an order that changes from run to run, so results
// agree with a fixed-order sum to rounding, not bit for bit.
//
// Bound: bytes for both. Neither does arithmetic beyond the adds; the least
// time is (rows read + rows written + indices) over the 3.35 TB/s memory
// rate. Design: one warp per row, 16-byte vector copies in K4 when the row
// width allows them (D % 4 == 0 and aligned pointers), 4-byte copies
// otherwise (the stage-0 entry sort gathers 7-channel rows); K8 zeroes dx
// with cudaMemsetAsync and adds 4-byte values. idx must be in range:
// unpool_gather pads a zero row at child_cap and points dropped points at
// it, so neither kernel clamps.
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

__global__ void scatter_rows_add_kernel(const float* __restrict__ g,
                                        const int* __restrict__ idx,
                                        float* __restrict__ dx, int N, int M,
                                        int D, long long rows) {
  const long long row = (long long)blockIdx.x * kWarpsPerBlock +
                        threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long b = row / M;
  const float* gs = g + row * D;
  float* o = dx + (b * N + idx[row]) * D;
  for (int c = lane; c < D; c += 32) atomicAdd(o + c, gs[c]);
}

unsigned row_blocks(long long rows) {
  return (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" int r3dl_gather_rows(const float* x, const int* idx, float* out,
                                int B, int N, int M, int D,
                                cudaStream_t stream) {
  const long long rows = (long long)B * M;
  if (rows == 0 || D == 0) return (int)cudaGetLastError();
  const bool vec4 = D % 4 == 0 && ((uintptr_t)x % 16 == 0) &&
                    ((uintptr_t)out % 16 == 0);
  if (vec4)
    gather_rows_kernel<true><<<row_blocks(rows), kWarpsPerBlock * 32, 0,
                               stream>>>(x, idx, out, N, M, D, rows);
  else
    gather_rows_kernel<false><<<row_blocks(rows), kWarpsPerBlock * 32, 0,
                                stream>>>(x, idx, out, N, M, D, rows);
  return (int)cudaGetLastError();
}

// dx: (B, N, D), zeroed here; g: (B, M, D); idx: (B, M) in [0, N)
extern "C" int r3dl_scatter_rows_add(const float* g, const int* idx,
                                     float* dx, int B, int N, int M, int D,
                                     cudaStream_t stream) {
  const cudaError_t err = cudaMemsetAsync(
      dx, 0, (size_t)B * N * D * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * M;
  if (rows == 0 || D == 0) return (int)cudaGetLastError();
  scatter_rows_add_kernel<<<row_blocks(rows), kWarpsPerBlock * 32, 0,
                            stream>>>(g, idx, dx, N, M, D, rows);
  return (int)cudaGetLastError();
}
