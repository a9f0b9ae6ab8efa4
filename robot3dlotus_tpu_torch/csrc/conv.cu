// K2: submanifold sparse conv as a gather-GEMM (the k=3 CPE conv, and the
// k=5 stem of the Concat variant, 125 taps and 263 channels wide)
//   out[b, n, :] = sum_k ok[b, n, k] * W[k]^T x[b, idx[b, n, k], :] + bias
// x: (B, N, Cin) fp32; idx: (B, N, K) int32; ok: (B, N, K) bool;
// W: (K, Cin, Cout) fp32 in stencil_offsets order; bias: (Cout,) or NULL.
// The same kernel runs the conv's input gradient with the mirrored weight
// (ops/conv.py conv_input_grad).
//
// Replaces robot3dlotus_tpu/ops/pallas_conv.py `subm_conv_windowed`
// (_windowed_core / _conv_kernel, plus the XLA _far_correction for links
// outside the sorted-order window). The TPU kernel gathered through one-hot
// MXU products inside a VMEM window and sent the rest through capacity-
// bounded far lists. Here each block reads the (B, N, K) neighbour map
// directly, so there is no window, no far list and nothing that overflows.
//
// Bound: operations, 2 Cin Cout flops per live link (ok true); at B = 1
// the weight's bytes (27 Cin Cout floats, 64 MB at C = 768) come close.
// The products run on the tensor cores as 3xTF32 mma.sync.m16n8k8
// (tc_common.cuh): 3 TF32 products for each fp32 one.
//
// Design: output-stationary. One block of 8 warps owns 128 output rows x
// 64 output channels of one cloud, for the taps of its tap range.
//   1. Compaction: the tile's map rows go to shared memory (coalesced),
//      then for each tap a warp ballot and a prefix sum over the block
//      list the tile's rows whose link is live (ascending), with the
//      link's source row. In serialization order most taps are live in a
//      few rows of every tile, so a whole-tap skip per tile keeps most
//      (tile, tap) pairs; the list keeps only the live (row, tap) pairs,
//      padded to 16 (the mma's m).
//   2. Per tap and 32-channel chunk of Cin, one pipeline stage: the listed
//      rows of x and the (32 x 64) slice of W[k] go to shared memory with
//      16-byte cp.async (zero-fill past the list and the channel edge),
//      double-buffered, so the next stage loads while this one multiplies.
//      Warp (r, c) multiplies the list's 16-row groups r, r + 2, .. by its
//      16 output channels; the k index of each 8-wide step is permuted (A
//      column t is channel 2t, column t + 4 channel 2t + 1, and B's rows
//      alike) so that a thread's two A elements of a row are one 8-byte
//      load. The tensor cores' fp32 sums stay within a stage (12 products
//      a chain, since their rounding drifts over long chains); the stages
//      add up in registers, rounded to nearest.
//   3. After a tap's last chunk each warp adds its products into the
//      block's shared-memory accumulator at the rows' tile positions.
//      Within a tap the rows are distinct, and taps are separated by a
//      barrier, so there are no conflicts; each element sums its taps in
//      ascending order.
//   4. With `splits` tap ranges (B = 1 at the deep stages has fewer row x
//      channel tiles than the card has SMs), each block writes its partial
//      tile to scratch and subm_conv_reduce_kernel adds the ranges in a
//      fixed order with the bias. No float atomics anywhere: the result is
//      bit-equal from run to run.
// The kernel is instantiated for up to 27 taps (the CPE conv: 109 KB of
// shared memory, two blocks an SM) and up to 125 (the k=5 stem: the map
// rows and the per-tap lists of 125 taps take 198 KB, one block an SM).
// Channel counts that are not multiples of 4 (the stem's 263) are padded
// with zero channels by the wrapper (ops/conv.py).
//
// bf16 (r3dl_subm_conv_bf16, the forward under compute_dtype bfloat16):
// x, W and out bf16, the bias fp32; the reference (the JAX XLA conv,
// robot3dlotus_tpu/ops/sparse_conv.py subm_conv_apply) sums every tap in
// fp32, adds the fp32 bias and rounds once. The stages stage bf16 rows
// (16-byte cp.async of 8 channels, so channel counts are multiples of 8,
// padded by the wrapper) and widen each fragment to fp32 as it is read;
// every product is one TF32 pass (tc_common.cuh mma1); the accumulators,
// the tile's accumulator and the tap ranges' partials stay fp32, and only
// the tile's (or the reduction's) final value, bias added, is rounded to
// bf16. The Pallas kernel's per-tap-block rounding (pallas_conv.py
// `out_ref[0] += acc.astype(...)`) is not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"

namespace {

using r3dl::Split;
using r3dl::split;

constexpr int kTM = 128;       // output rows per block
constexpr int kStages = 2;     // pipeline stages in flight
constexpr int kKC = 32;        // input channels per stage
constexpr int kTN = 64;        // output channels per block
constexpr int kMaxTaps[] = {27, 125};   // k = 3; k = 5
constexpr int kThreads = 256;  // 8 warps: 2 row-group parities x 4 x 16 ch
constexpr int kGroups = kTM / 32;   // 16-row groups per warp, at most
constexpr int kXS = kKC + 8;   // x rows: 8-byte A loads on 32 banks
constexpr int kWS = kTN + 4;   // W rows: B loads (rows 2t, 2t + 1) on 32
constexpr int kAS = kTN + 4;   // accumulator rows
constexpr int kXSb = kKC + 8;  // bf16 x rows: 4-byte A loads on 32 banks
constexpr int kWSb = kTN + 8;  // bf16 W rows: B loads on distinct words

// 4 consecutive outputs of one row
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(r3dl::bf16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                         __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

template <int kMaxK>
struct Smem {
  float acc[kTM * kAS];
  union {
    struct {                   // the pipeline's ring
      float xs[kStages][kTM * kXS];
      float ws[kStages][kKC * kWS];
    } pipe;
    struct {                   // the tile's map, before the pipeline
      int idx[kTM * kMaxK];
      unsigned char ok[kTM * kMaxK];
    } map;
  } u;
  int src[kMaxK][kTM];
  unsigned char pos[kMaxK][kTM];
  unsigned bal[kMaxK][kTM / 32];
  int cnt[kMaxK];
  int taps[kMaxK];
  int ntaps;
};

template <int kMaxK, typename T>
__global__ void __launch_bounds__(kThreads, 2)
subm_conv_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                 const unsigned char* __restrict__ ok,
                 const T* __restrict__ w, const float* __restrict__ bias,
                 T* __restrict__ out, float* __restrict__ work, int N,
                 int K, int Cin, int Cout, int splits) {
  constexpr bool kOne = !std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  Smem<kMaxK>& sm = *reinterpret_cast<Smem<kMaxK>*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wr = warp & 1, wc = 16 * (warp >> 1);
  const int b = blockIdx.z / splits, s = blockIdx.z % splits;
  const int n0 = blockIdx.x * kTM, co0 = blockIdx.y * kTN;
  const int k_begin = s * K / splits, k_end = (s + 1) * K / splits;
  const long long row0 = (long long)b * N;

  for (int e = tid; e < kTM * kAS; e += kThreads) sm.acc[e] = 0.f;
  // 1. the tile's map rows into shared memory (the tile's rows, and each
  //    row's K entries, are contiguous), then the compaction: threads
  //    0..kTM-1 own one row each
  for (int e = tid; e < kTM * K; e += kThreads) {
    const long long off = (row0 + n0) * K + e;
    const int k = e % K;
    const bool live = n0 + e / K < N && k >= k_begin && k < k_end &&
                      ok[off];
    sm.u.map.ok[e] = (unsigned char)live;
    sm.u.map.idx[e] = live ? idx[off] : 0;
  }
  __syncthreads();
  if (tid < kTM)
    for (int k = k_begin; k < k_end; ++k) {
      const unsigned m = __ballot_sync(0xffffffffu,
                                       sm.u.map.ok[tid * K + k]);
      if (lane == 0) sm.bal[k][warp] = m;
    }
  __syncthreads();
  if (tid < kTM)
    for (int k = k_begin; k < k_end; ++k) {
      const unsigned m = sm.bal[k][warp];
      if (!((m >> lane) & 1u)) continue;
      int p = __popc(m & ((1u << lane) - 1u));
      for (int i = 0; i < warp; ++i) p += __popc(sm.bal[k][i]);
      sm.pos[k][p] = (unsigned char)tid;
      sm.src[k][p] = sm.u.map.idx[tid * K + k];
    }
  if (tid == 0) {
    int nt = 0;
    for (int k = k_begin; k < k_end; ++k) {
      int c = 0;
      for (int i = 0; i < kTM / 32; ++i) c += __popc(sm.bal[k][i]);
      sm.cnt[k] = c;
      if (c) sm.taps[nt++] = k;
    }
    sm.ntaps = nt;
  }
  __syncthreads();

  // 2. stages (tap, chunk of Cin) over the taps with a live row, in a ring
  //    of kStages
  const int nch = (Cin + kKC - 1) / kKC;
  const int stages = sm.ntaps * nch;
  // a 16-byte piece is V channels; bf16 rows at strides kWSb / kXSb, in
  // the fp32 rings' space
  constexpr int V = 16 / sizeof(T);
  constexpr int WS = kOne ? kWSb : kWS, XS = kOne ? kXSb : kXS;
  auto load = [&](int i) {
    const int buf = i % kStages;
    const int k = sm.taps[i / nch], c0 = (i % nch) * kKC;
    T* wb = reinterpret_cast<T*>(sm.u.pipe.ws[buf]);
    for (int e = tid; e < kKC * (kTN / V); e += kThreads) {
      const int r = e / (kTN / V), q = e % (kTN / V);
      const int c = c0 + r, col = co0 + V * q;
      const bool p = c < Cin && col < Cout;
      r3dl::cp_async16(wb + r * WS + V * q,
                       p ? w + ((long long)k * Cin + c) * Cout + col : w, p);
    }
    const int cnt = sm.cnt[k], rows = (cnt + 15) & ~15;
    T* xb = reinterpret_cast<T*>(sm.u.pipe.xs[buf]);
    for (int e = tid; e < rows * (kKC / V); e += kThreads) {
      const int r = e / (kKC / V), q = e % (kKC / V);
      const int c = c0 + V * q;
      const bool p = r < cnt && c < Cin;
      r3dl::cp_async16(xb + r * XS + V * q,
                       p ? x + (row0 + sm.src[k][r]) * Cin + c : x, p);
    }
  };

  float acc[kGroups][2][4];
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[gi][j][e] = 0.f;

  for (int i = 0; i < kStages - 1; ++i) {
    if (i < stages) load(i);
    r3dl::cp_async_commit();
  }
  for (int i = 0; i < stages; ++i) {
    if (i + kStages - 1 < stages) load(i + kStages - 1);
    r3dl::cp_async_commit();
    r3dl::cp_async_wait<kStages - 1>();
    __syncthreads();
    const int k = sm.taps[i / nch];
    const int cnt = sm.cnt[k], groups = (cnt + 15) >> 4;
    const T* xb = reinterpret_cast<const T*>(sm.u.pipe.xs[i % kStages]);
    const T* wb = reinterpret_cast<const T*>(sm.u.pipe.ws[i % kStages]);
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      const int g = wr + 2 * gi;
      if (g >= groups) break;
      float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < kKC / 8; ++ks) {
        const T* x0 = xb + (16 * g + gid) * XS + 8 * ks + 2 * tig;
        if constexpr (kOne) {
          const float2 v0 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x0));
          const float2 v8 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x0 + 8 * XS));
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = wc + 8 * j + gid;
            r3dl::mma1(part[j], v0.x, v8.x, v0.y, v8.y,
                       r3dl::widen(wb[(8 * ks + 2 * tig) * WS + col]),
                       r3dl::widen(wb[(8 * ks + 2 * tig + 1) * WS + col]));
          }
        } else {
          Split bf[2][2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = wc + 8 * j + gid;
            bf[j][0] = split(wb[(8 * ks + 2 * tig) * WS + col]);
            bf[j][1] = split(wb[(8 * ks + 2 * tig + 1) * WS + col]);
          }
          const float2 v0 = *reinterpret_cast<const float2*>(x0);
          const float2 v8 = *reinterpret_cast<const float2*>(x0 + 8 * XS);
          const Split af[4] = {split(v0.x), split(v8.x), split(v0.y),
                               split(v8.y)};
#pragma unroll
          for (int j = 0; j < 2; ++j) r3dl::mma3(part[j], af, bf[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gi][j][e] += part[j][e];
    }
    if (i % nch == nch - 1) {
      // 3. the tap's products into the tile's accumulator
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        const int g = wr + 2 * gi;
        if (g < groups)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * g + gid + 8 * h;
            if (r < cnt) {
              float* a = sm.acc + sm.pos[k][r] * kAS + wc + 2 * tig;
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                a[8 * j] += acc[gi][j][2 * h];
                a[8 * j + 1] += acc[gi][j][2 * h + 1];
              }
            }
          }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[gi][j][e] = 0.f;
      }
    }
    __syncthreads();
  }

  // 4. the tile out: with bias (rounded to T once), or the tap range's
  //    fp32 partial to scratch
  float* part = work + (long long)s * (gridDim.z / splits) * N * Cout;
  for (int e = tid; e < kTM * (kTN / 4); e += kThreads) {
    const int r = e / (kTN / 4), q = e % (kTN / 4);
    const int col = co0 + 4 * q;
    if (n0 + r >= N || col >= Cout) continue;
    float4 v = *reinterpret_cast<const float4*>(sm.acc + r * kAS + 4 * q);
    const long long o = (row0 + n0 + r) * Cout + col;
    if (splits > 1) {
      store4(part + o, v);
      continue;
    }
    if (bias) {
      v.x += bias[col];
      v.y += bias[col + 1];
      v.z += bias[col + 2];
      v.w += bias[col + 3];
    }
    store4(out + o, v);
  }
}

// out = sum over the tap ranges, in order, + bias, rounded to T once;
// float4 lanes
template <typename T>
__global__ void subm_conv_reduce_kernel(const float4* __restrict__ work,
                                        const float* __restrict__ bias,
                                        T* __restrict__ out, long long n4,
                                        int Cout, int splits) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n4; e += (long long)gridDim.x * blockDim.x) {
    float4 v = work[e];
    for (int s = 1; s < splits; ++s) {
      const float4 p = work[s * n4 + e];
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    if (bias) {
      const int col = (int)((4 * e) % Cout);
      v.x += bias[col];
      v.y += bias[col + 1];
      v.z += bias[col + 2];
      v.w += bias[col + 3];
    }
    store4(out + 4 * e, v);
  }
}

template <int kMaxK, typename T>
cudaError_t launch_conv(const T* x, const int* idx, const unsigned char* ok,
                        const T* w, const float* bias, T* out, float* work,
                        int B, int N, int K, int Cin, int Cout, int splits,
                        cudaStream_t stream) {
  static const cudaError_t attr =
      r3dl::allow_smem(subm_conv_kernel<kMaxK, T>, sizeof(Smem<kMaxK>));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + kTM - 1) / kTM, (Cout + kTN - 1) / kTN, B * splits);
  subm_conv_kernel<kMaxK, T>
      <<<grid, kThreads, sizeof(Smem<kMaxK>), stream>>>(
          x, idx, ok, w, bias, out, work, N, K, Cin, Cout, splits);
  return cudaGetLastError();
}

template <typename T>
int conv(const T* x, const int* idx, const unsigned char* ok, const T* w,
         const float* bias, T* out, float* work, int B, int N, int K,
         int Cin, int Cout, int splits, long long work_bytes,
         cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);   // channels in 16 bytes
  const long long n = (long long)B * N * Cout;
  if (n == 0) return (int)cudaGetLastError();
  if (K < 1 || K > kMaxTaps[1] || Cin % V || Cout % V || splits < 1 ||
      splits > K || (long long)B * splits > 65535 ||
      (((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) & 15) ||
      (splits > 1 && (!work || work_bytes < 4 * splits * n ||
                      ((uintptr_t)work & 15))))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      K <= kMaxTaps[0]
          ? launch_conv<kMaxTaps[0], T>(x, idx, ok, w, bias, out, work, B, N,
                                        K, Cin, Cout, splits, stream)
          : launch_conv<kMaxTaps[1], T>(x, idx, ok, w, bias, out, work, B, N,
                                        K, Cin, Cout, splits, stream);
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const long long n4 = n / 4, blocks = (n4 + 255) / 256;
    subm_conv_reduce_kernel<T>
        <<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
            reinterpret_cast<const float4*>(work), bias, out, n4, Cout,
            splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// work: (splits, B, N, Cout) fp32 scratch of work_bytes bytes, unused (may
// be NULL) when splits == 1; tap range s is [s K / splits, (s + 1) K /
// splits). K <= 125; Cin and Cout multiples of 4; x, w and out 16-byte
// aligned.
extern "C" int r3dl_subm_conv(const float* x, const int* idx,
                              const unsigned char* ok, const float* w,
                              const float* bias, float* out, float* work,
                              int B, int N, int K, int Cin, int Cout,
                              int splits, long long work_bytes,
                              cudaStream_t stream) {
  return conv<float>(x, idx, ok, w, bias, out, work, B, N, K, Cin, Cout,
                     splits, work_bytes, stream);
}

// The same with bf16 x, w and out (bias and work fp32); Cin and Cout
// multiples of 8.
extern "C" int r3dl_subm_conv_bf16(const r3dl::bf16* x, const int* idx,
                                   const unsigned char* ok,
                                   const r3dl::bf16* w, const float* bias,
                                   r3dl::bf16* out, float* work, int B, int N,
                                   int K, int Cin, int Cout, int splits,
                                   long long work_bytes,
                                   cudaStream_t stream) {
  return conv<r3dl::bf16>(x, idx, ok, w, bias, out, work, B, N, K, Cin, Cout,
                          splits, work_bytes, stream);
}
