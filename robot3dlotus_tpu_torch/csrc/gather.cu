// K4: batched row gather with sentinel rows
//        out[b, m, :] = x[b, idx[b, m], :] if 0 <= idx[b, m] < N, else 0
// K8: its backward, a scatter-add that drops sentinel rows
//        dx[b, idx[b, m], :] += g[b, m, :] for 0 <= idx[b, m] < N
//
// K4 replaces robot3dlotus_tpu/ops/pallas_gather.py `permute_rows`
// (_permute_fwd_call / _fwd_kernel), which gathered rows on the TPU as a
// one-hot (P, N) x (N, C) matrix product so that HBM saw only contiguous
// reads. On the H100 a scattered row read is cheap, so the kernel reads
// each gathered row directly. The TPU kernel took only indices in [0, N),
// so the JAX decoder's unpool appended a zero row to every child feature
// tensor and pointed dropped parent points at it; K4 takes K9's contract
// instead (a zero row at any index outside [0, N)), and the port's unpool
// gathers from the child features directly, with no padded copy.
//
// K8 replaces `_permute_bwd_call` / `_bwd_kernel` (the custom VJP of
// permute_rows), which accumulated dx[b] in VMEM through the transposed
// one-hot across row tiles. Here each cotangent row is added into its
// destination row with fp32 atomicAdd, and a row whose index is outside
// [0, N) is dropped (the cotangent of K4's zero row): duplicate indices
// (the duplicate padding of ops/patching.py maps several rows onto one
// source row) sum correctly, but in an order that changes from run to run,
// so results agree with a fixed-order sum to rounding, not bit for bit.
//
// Bound: bytes for both. Neither does arithmetic beyond the adds; the least
// time is (rows read + rows written + indices) over the 3.35 TB/s memory
// rate. A release forward's K4 calls move well under a megabyte each, so
// at B = 1 a call costs its launch, and the wrapper's host path
// (ops/gather.py) is kept to one check, one allocation and one ctypes call.
// Design: a grid of (row tiles, B), so no thread divides to find its cloud;
// row arithmetic in 32 bits, 64-bit offsets only in the final addresses.
// A group of L lanes moves one row: with D % 4 == 0 and 16-byte aligned
// pointers, D/4 float4 per row and L = min(D/4, 32), so at D = 64 two rows
// share a warp and at D = 768 each lane moves 6 float4; otherwise 4-byte
// words with L = min(D, 32). x is read through the read-only path. Indices
// are int32 or int64 (a template), so the wrapper never casts them.
//
// bf16 rows (r3dl_gather_rows16, under compute_dtype bfloat16): the same
// kernel moves 2-byte elements, each row as 16-byte words when its bytes
// (2 D) are a multiple of 16 and the pointers are 16-byte aligned (D = 64
// bf16 is 128 bytes, 8 words a row), else 4-byte words (D even), else
// 2-byte ones. A copy: bit-equal to its plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerGroup = 2;   // rows each lane group moves per tile
constexpr int kWarpsPerBlock = 8;  // K8: one warp per cotangent row
constexpr int kMaxGridY = 65535;

template <typename V>
__device__ __forceinline__ V zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 zero_of<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
template <>
__device__ __forceinline__ uint4 zero_of<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}
template <>
__device__ __forceinline__ unsigned zero_of<unsigned>() { return 0u; }
template <>
__device__ __forceinline__ unsigned short zero_of<unsigned short>() {
  return 0;
}

// x (B, N, W), out (B, M, W) in units of V (16-, 4- or 2-byte words); block
// (blockIdx.x, b) moves rows [r0, r0 + groups * kRowsPerGroup) of cloud b
template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const V* __restrict__ x, const I* __restrict__ idx,
                       V* __restrict__ out, int N, int M, int W, int L) {
  const int groups = kThreads / L;
  const int g = threadIdx.x / L;
  if (g >= groups) return;
  const int lane = threadIdx.x - g * L;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * (groups * kRowsPerGroup);
  const int r_end = min(M, r0 + groups * kRowsPerGroup);
  const I* ib = idx + (long long)b * M;
  const V* xb = x + (long long)b * N * W;
  V* ob = out + (long long)b * M * W;
  for (int r = r0 + g; r < r_end; r += groups) {
    const long long i = (long long)__ldg(ib + r);
    V* dst = ob + (long long)r * W;
    if (i >= 0 && i < N) {
      const V* src = xb + i * W;
#pragma unroll 4
      for (int c = lane; c < W; c += L) dst[c] = __ldg(src + c);
    } else {
      for (int c = lane; c < W; c += L) dst[c] = zero_of<V>();
    }
  }
}

template <typename I>
__global__ void scatter_rows_add_kernel(const float* __restrict__ g,
                                        const I* __restrict__ idx,
                                        float* __restrict__ dx, int N, int M,
                                        int D) {
  const int r = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (r >= M) return;
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.y * M + r;
  const long long i = (long long)idx[row];
  if (i < 0 || i >= N) return;
  const float* gs = g + row * D;
  float* o = dx + ((long long)blockIdx.y * N + i) * D;
  for (int c = lane; c < D; c += 32) atomicAdd(o + c, gs[c]);
}

template <typename V, typename I>
void launch_gather(const void* x, const void* idx, void* out, int B, int N,
                   int M, int W, cudaStream_t stream) {
  const int L = W < 32 ? W : 32;
  const int rows_per_block = (kThreads / L) * kRowsPerGroup;
  const dim3 grid((M + rows_per_block - 1) / rows_per_block, B);
  gather_rows_kernel<V, I><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const V*>(x), static_cast<const I*>(idx),
      reinterpret_cast<V*>(out), N, M, W, L);
}

template <typename V>
void launch_gather_idx(const void* x, const void* idx, int idx64, void* out,
                       int B, int N, int M, int W, cudaStream_t stream) {
  if (idx64)
    launch_gather<V, long long>(x, idx, out, B, N, M, W, stream);
  else
    launch_gather<V, int>(x, idx, out, B, N, M, W, stream);
}

}  // namespace

// x: (B, N, D); idx: (B, M) int32 (idx64 = 0) or int64 (idx64 = 1), any
// value; out: (B, M, D)
extern "C" int r3dl_gather_rows(const float* x, const void* idx, float* out,
                                int B, int N, int M, int D, int idx64,
                                cudaStream_t stream) {
  if (B == 0 || M == 0 || D == 0) return (int)cudaGetLastError();
  if (B > kMaxGridY) return (int)cudaErrorInvalidValue;
  const bool vec4 = D % 4 == 0 && ((uintptr_t)x % 16 == 0) &&
                    ((uintptr_t)out % 16 == 0);
  if (vec4)
    launch_gather_idx<float4>(x, idx, idx64, out, B, N, M, D / 4, stream);
  else
    launch_gather_idx<float>(x, idx, idx64, out, B, N, M, D, stream);
  return (int)cudaGetLastError();
}

// The same for rows of D 2-byte elements (bf16): x (B, N, D), out (B, M, D).
extern "C" int r3dl_gather_rows16(const void* x, const void* idx, void* out,
                                  int B, int N, int M, int D, int idx64,
                                  cudaStream_t stream) {
  if (B == 0 || M == 0 || D == 0) return (int)cudaGetLastError();
  if (B > kMaxGridY) return (int)cudaErrorInvalidValue;
  const uintptr_t a = (uintptr_t)x | (uintptr_t)out;
  if (D % 8 == 0 && a % 16 == 0)
    launch_gather_idx<uint4>(x, idx, idx64, out, B, N, M, D / 8, stream);
  else if (D % 2 == 0 && a % 4 == 0)
    launch_gather_idx<unsigned>(x, idx, idx64, out, B, N, M, D / 2, stream);
  else
    launch_gather_idx<unsigned short>(x, idx, idx64, out, B, N, M, D,
                                      stream);
  return (int)cudaGetLastError();
}

// dx: (B, N, D), zeroed here; g: (B, M, D); idx: (B, M) int32 or int64,
// rows outside [0, N) dropped
extern "C" int r3dl_scatter_rows_add(const float* g, const void* idx,
                                     float* dx, int B, int N, int M, int D,
                                     int idx64, cudaStream_t stream) {
  const cudaError_t err = cudaMemsetAsync(
      dx, 0, (size_t)B * N * D * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || M == 0 || D == 0) return (int)cudaGetLastError();
  if (B > kMaxGridY) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  if (idx64)
    scatter_rows_add_kernel<long long><<<grid, kWarpsPerBlock * 32, 0,
                                         stream>>>(
        g, static_cast<const long long*>(idx), dx, N, M, D);
  else
    scatter_rows_add_kernel<int><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
        g, static_cast<const int*>(idx), dx, N, M, D);
  return (int)cudaGetLastError();
}
