// K3: the fused k=5 stem conv (gather + stencil product, no bias)
//   out[b, n, :] = sum_k ok[b, n, k] * W[k]^T x[b, idx[b, n, k], :]
// x: (B, N, Cin <= 8) fp32; idx / ok: (B, N, K <= 128; 125 for k = 5);
// W: (K, Cin, Cout) fp32, 16-byte aligned, Cout a multiple of 4.
//
// Replaces robot3dlotus_tpu/ops/pallas_stem.py `stem_gather_windowed`
// (_gather_call / _gather_kernel), which gathered the 125 taps of
// 8-channel rows through one-hot MXU products inside a sorted-order window
// into a (B, N, 125 * 8) buffer that XLA then multiplied by the stencil
// weight (ops/sparse_conv.py:298). Here gather and product are one kernel
// and the (B, N, 1000) intermediate never reaches device memory.
//
// Bound: bytes. Per live link (ok true, under 17% of the (row, tap) pairs
// of a release cloud) 2 Cin Cout flops, against the map's 5 bytes per
// (row, tap) pair that every pair costs: at B = 1 the 2.5 MB map takes
// ~0.75 us of the 3.35 TB/s, the live links' 3xTF32 products ~0.5 us of
// the tensor cores. The first SIMT design ran 64 blocks on 132 SMs and
// multiplied every tap, live or not, in fp32: 94x its bound at B = 1.
//
// Design: a warp owns 16 output rows x kCols output channels (64, or 32
// when Cin = 8) and walks a tap range; Cin is zero-padded to 8, so one tap
// is one k-step of mma.sync.m16n8k8, run as 3xTF32 (tc_common.cuh).
//   1. The block stages the W slice of its tap range and columns in shared
//      memory once (16-byte cp.async; 219 KB for all 125 taps x 7 x 64),
//      laid out [tap][n-tile][channel][column % 8] so that every B-fragment
//      load hits 32 banks; after one barrier its warps run on their own,
//      with no barrier per tap chunk.
//   2. The warp walks the range in chunks of 8 taps: each lane loads 4
//      (row, tap) entries of the map (idx and ok together, the next chunk's
//      while this one multiplies) and the warp shuffles them to the
//      A-fragment lanes; then every lane issues its 32 gathers of x (4 per
//      tap; a dead link loads nothing), so a chunk's loads fly together.
//   3. A tap none of the warp's 16 rows links to is skipped by one ballot:
//      in serialization order most (tap, 16-row group) pairs are dead. A
//      live tap's n-tiles are independent product chains with no branch
//      between them, accumulated by the tensor cores in fp32: at most 3
//      products a tap, 375 a row range (release rows have ~21 live taps),
//      whose rounding stays far inside the 1e-4 bar (the card tests hold
//      every link live too).
//   4. Rows are taken flat over the B clouds (row r is cloud r / N).
//      Training's 32 clouds run one 16-warp block per SM holding the whole
//      W slice, each warp taking row groups in turn. At B = 1 a cloud's row
//      groups cannot fill the card: the tap chunks are split into `splits`
//      ranges (ops/stem.py stem_conv_plan), each range writes its partial
//      tile to scratch and stem_conv_sum_kernel adds them in a fixed
//      order. No float atomics: the result is bit-equal from launch to
//      launch.
//
// bf16 (r3dl_stem_conv_bf16, under compute_dtype bfloat16): x and W bf16,
// out bf16. The block widens its W slice to fp32 as it stages it (plain
// loads, the layout of the fp32 path), the A fragments are widened as
// they are gathered, and every product is one TF32 pass (tc_common.cuh
// mma1). The sums stay fp32 over every tap, through the tap ranges'
// partials and their fixed-order sum, and are rounded to bf16 once, as
// the JAX XLA conv (robot3dlotus_tpu/ops/sparse_conv.py subm_conv_apply)
// rounds its fp32 accumulator.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"

namespace {

using r3dl::Split;
using r3dl::split;

constexpr int kCp = 8;             // channels per tap after padding
constexpr int kKT = 8;             // taps per chunk
constexpr int kMaxWarps = 16;      // 16-row groups per block, at most
constexpr int kMaxK = 128;         // taps a map row may hold
constexpr int kMaxSmem = 227 * 1024;  // shared memory a block may hold
constexpr unsigned kFull = 0xffffffffu;

// shared memory of a block: the W slice of R taps
template <int kCols>
size_t smem_bytes(int R, int Cin) {
  return (size_t)R * (kCols / 8) * Cin * 8 * sizeof(float);
}

// map entries (ok, idx) of taps k0 + 4 (lane / 16) .. + 3 of one row
// (offset `off`, skipped when !in); taps from `ke` on read as dead
__device__ __forceinline__ void load_map(
    unsigned char (&o)[4], int (&i)[4], const unsigned char* __restrict__ ok,
    const int* __restrict__ idx, long long off, bool in, int k0, int ke,
    int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + 4 * (lane >> 4) + j;
    const bool p = in && k < ke;
    o[j] = p ? ok[off + k] : 0;
    i[j] = p ? idx[off + k] : 0;
  }
}

// two consecutive outputs of a row
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(r3dl::bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int kCols, typename T>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
stem_conv_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                 const unsigned char* __restrict__ ok,
                 const T* __restrict__ w, T* __restrict__ out,
                 float* __restrict__ work, int rows, int N, int K, int Cin,
                 int Cout, int splits) {
  constexpr bool kOne = !std::is_same<T, float>::value;
  constexpr int J = kCols / 8;               // n-tiles
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // [R][J][Cin][8]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int s = blockIdx.z, co0 = blockIdx.y * kCols;
  const int chunks = (K + kKT - 1) / kKT;
  const int kb = s * chunks / splits * kKT;
  const int ke = min(K, (s + 1) * chunks / splits * kKT);
  const int R = ke - kb;                     // this range's taps

  // 1. the range's W slice: W[kb + t][c][co0 + 8 j + g] at
  //    ws[((t J + j) Cin + c) 8 + g]; columns past Cout zero-filled
  if constexpr (kOne) {
    for (int e = tid; e < R * Cin * J * 8; e += blockDim.x) {
      const int g = e & 7, j = (e >> 3) % J, tc = (e >> 3) / J;
      const int c = tc % Cin, t = tc / Cin;
      const int col = co0 + 8 * j + g;
      ws[((t * J + j) * Cin + c) * 8 + g] =
          col < Cout ? r3dl::widen(w[((long long)(kb + t) * Cin + c) * Cout +
                                     col])
                     : 0.f;
    }
  } else {
    for (int e = tid; e < R * Cin * J * 2; e += blockDim.x) {
      const int h = e & 1, j = (e >> 1) % J, tc = (e >> 1) / J;
      const int c = tc % Cin, t = tc / Cin;
      const int col = co0 + 8 * j + 4 * h;
      const bool p = col < Cout;
      r3dl::cp_async16(
          ws + (((t * J + j) * Cin + c) * 8 + 4 * h),
          p ? w + ((long long)(kb + t) * Cin + c) * Cout + col : w, p);
    }
    r3dl::cp_async_commit();
    r3dl::cp_async_wait<0>();
  }
  __syncthreads();

  float* part = work + (long long)s * rows * Cout;
  const int groups = (rows + 15) / 16;
  for (int grp = blockIdx.x * warps + warp; grp < groups;
       grp += gridDim.x * warps) {
    const int n0 = grp * 16;
    // lane L loads the map of row n0 + L % 16, taps 4 (L / 16) .. + 3 of
    // a chunk
    const int my_row = n0 + (lane & 15);
    const bool my_in = my_row < rows;
    const long long my_off = (long long)(my_in ? my_row : 0) * K;
    // this lane's fragment rows and their clouds' x
    const int r0 = n0 + gid, r1 = r0 + 8;
    const T* xb0 = x + (long long)(r0 / N) * N * Cin;
    const T* xb1 = x + (long long)(r1 / N) * N * Cin;

    unsigned char o_next[4];
    int i_next[4];
    load_map(o_next, i_next, ok, idx, my_off, my_in, kb, ke, lane);

    float acc[J][4];
#pragma unroll
    for (int j = 0; j < J; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    for (int c0 = 0; c0 < R; c0 += kKT) {
      // 2. this chunk's links (source row, -1 where none), the next
      //    chunk's map in flight, the A fragments: a0 (row gid, channel
      //    tig), a1 (gid + 8, tig), a2 (gid, tig + 4), a3 (gid + 8,
      //    tig + 4); zero past Cin
      int mine[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) mine[j] = o_next[j] ? i_next[j] : -1;
      if (c0 + kKT < R)
        load_map(o_next, i_next, ok, idx, my_off, my_in, kb + c0 + kKT, ke,
                 lane);
      int src0[kKT], src1[kKT];
      float a[kKT][4];
#pragma unroll
      for (int t = 0; t < kKT; ++t) {
        src0[t] = __shfl_sync(kFull, mine[t & 3], gid + 16 * (t >> 2));
        src1[t] = __shfl_sync(kFull, mine[t & 3], gid + 8 + 16 * (t >> 2));
        const T* x0 = xb0 + (long long)src0[t] * Cin;
        const T* x1 = xb1 + (long long)src1[t] * Cin;
        a[t][0] = src0[t] >= 0 && tig < Cin ? r3dl::widen(x0[tig]) : 0.f;
        a[t][1] = src1[t] >= 0 && tig < Cin ? r3dl::widen(x1[tig]) : 0.f;
        a[t][2] =
            src0[t] >= 0 && tig + 4 < Cin ? r3dl::widen(x0[tig + 4]) : 0.f;
        a[t][3] =
            src1[t] >= 0 && tig + 4 < Cin ? r3dl::widen(x1[tig + 4]) : 0.f;
      }
      // 3. the live taps' products
#pragma unroll
      for (int t = 0; t < kKT; ++t) {
        if (!__any_sync(kFull, src0[t] >= 0 || src1[t] >= 0)) continue;
        const float* wt = ws + (c0 + t) * J * Cin * 8;
        if constexpr (kOne) {
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const float* wj = wt + j * Cin * 8 + gid;
            r3dl::mma1(acc[j], a[t][0], a[t][1], a[t][2], a[t][3],
                       tig < Cin ? wj[tig * 8] : 0.f,
                       tig + 4 < Cin ? wj[(tig + 4) * 8] : 0.f);
          }
        } else {
          const Split af[4] = {split(a[t][0]), split(a[t][1]),
                               split(a[t][2]), split(a[t][3])};
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const float* wj = wt + j * Cin * 8 + gid;
            const Split bf[2] = {
                split(tig < Cin ? wj[tig * 8] : 0.f),
                split(tig + 4 < Cin ? wj[(tig + 4) * 8] : 0.f)};
            r3dl::mma3(acc[j], af, bf);
          }
        }
      }
    }

    // 4. the group's rows out (rounded to T), or the tap range's fp32
    //    partial to scratch
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int col = co0 + 8 * j + 2 * tig;
      if (col >= Cout) break;
      const long long o0 = (long long)r0 * Cout + col;
      const long long o1 = (long long)r1 * Cout + col;
      if (splits > 1) {
        if (r0 < rows) store2(part + o0, acc[j][0], acc[j][1]);
        if (r1 < rows) store2(part + o1, acc[j][2], acc[j][3]);
      } else {
        if (r0 < rows) store2(out + o0, acc[j][0], acc[j][1]);
        if (r1 < rows) store2(out + o1, acc[j][2], acc[j][3]);
      }
    }
  }
}

// out = the sum of the tap ranges' partials, in order, rounded to T once;
// float4 lanes
template <typename T>
__global__ void stem_conv_sum_kernel(const float4* __restrict__ work,
                                     T* __restrict__ out, long long n4,
                                     int splits) {
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
    store2(out + 4 * e, v.x, v.y);
    store2(out + 4 * e + 2, v.z, v.w);
  }
}

template <int kCols, typename T>
int launch(const T* x, const int* idx, const unsigned char* ok, const T* w,
           T* out, float* work, int B, int N, int K, int Cin, int Cout,
           int warps, int splits, int blocks, cudaStream_t stream) {
  static const cudaError_t attr =
      r3dl::allow_smem(stem_conv_kernel<kCols, T>, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  // the longest range's taps
  const int chunks = (K + kKT - 1) / kKT;
  const int range_taps = min(K, (chunks + splits - 1) / splits * kKT);
  if (smem_bytes<kCols>(range_taps, Cin) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, (Cout + kCols - 1) / kCols, splits);
  stem_conv_kernel<kCols, T><<<grid, 32 * warps,
                               smem_bytes<kCols>(range_taps, Cin), stream>>>(
      x, idx, ok, w, out, work, B * N, N, K, Cin, Cout, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int stem(const T* x, const int* idx, const unsigned char* ok, const T* w,
         T* out, float* work, int B, int N, int K, int Cin, int Cout,
         int cols, int warps, int splits, int blocks, long long work_bytes,
         cudaStream_t stream) {
  const long long n = (long long)B * N * Cout;
  if (n == 0) return (int)cudaGetLastError();
  const int chunks = (K + kKT - 1) / kKT;
  if (K < 1 || K > kMaxK || Cin < 1 || Cin > kCp || Cout % 4 ||
      (cols != 64 && cols != 32) || warps < 1 || warps > kMaxWarps ||
      splits < 1 || splits > chunks || splits > 65535 || blocks < 1 ||
      (long long)B * N > 0x7fffffffLL || ((uintptr_t)w & 15) ||
      ((uintptr_t)out & 15) ||
      (splits > 1 && (!work || work_bytes < 4 * splits * n ||
                      ((uintptr_t)work & 15))))
    return (int)cudaErrorInvalidValue;
  const int err = cols == 64
                      ? launch<64, T>(x, idx, ok, w, out, work, B, N, K, Cin,
                                      Cout, warps, splits, blocks, stream)
                      : launch<32, T>(x, idx, ok, w, out, work, B, N, K, Cin,
                                      Cout, warps, splits, blocks, stream);
  if (err != cudaSuccess || splits == 1) return err;
  const long long n4 = n / 4, sum_blocks = (n4 + 255) / 256;
  stem_conv_sum_kernel<T>
      <<<(unsigned)(sum_blocks < 4096 ? sum_blocks : 4096), 256, 0,
         stream>>>(reinterpret_cast<const float4*>(work), out, n4, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// cols: output channels per block (64, or 32: the W slice of 125 taps at
// Cin = 8 fits shared memory only so); warps: 16-row groups per block
// (1..16); blocks: blocks per column tile and range (each walks row groups
// blockIdx.x + i gridDim.x); splits: tap ranges, range s the 8-tap chunks
// [s C / splits, (s + 1) C / splits) of C = ceil(K / 8); work: (splits, B,
// N, Cout) fp32 scratch of work_bytes bytes, unused (may be NULL) when
// splits == 1 (ops/stem.py stem_conv_plan).
extern "C" int r3dl_stem_conv(const float* x, const int* idx,
                              const unsigned char* ok, const float* w,
                              float* out, float* work, int B, int N, int K,
                              int Cin, int Cout, int cols, int warps,
                              int splits, int blocks, long long work_bytes,
                              cudaStream_t stream) {
  return stem<float>(x, idx, ok, w, out, work, B, N, K, Cin, Cout, cols,
                     warps, splits, blocks, work_bytes, stream);
}

// The same with bf16 x, w and out (work fp32).
extern "C" int r3dl_stem_conv_bf16(const r3dl::bf16* x, const int* idx,
                                   const unsigned char* ok,
                                   const r3dl::bf16* w, r3dl::bf16* out,
                                   float* work, int B, int N, int K, int Cin,
                                   int Cout, int cols, int warps, int splits,
                                   int blocks, long long work_bytes,
                                   cudaStream_t stream) {
  return stem<r3dl::bf16>(x, idx, ok, w, out, work, B, N, K, Cin, Cout, cols,
                          warps, splits, blocks, work_bytes, stream);
}
