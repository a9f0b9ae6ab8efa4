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
// fp32, adds the fp32 bias and rounds once. The input gradient at bf16
// (r3dl_subm_conv_dx_bf16, training under compute_dtype bfloat16): x the
// fp32 owner sums of the bf16 cotangent (ops/conv.py conv_input_grad; K8
// keeps them unrounded), W the mirrored bf16 weight, out bf16, summed in
// fp32 and rounded to bf16 once, as the Pallas VJP (pallas_conv.py
// `_windowed_op_bwd`) rounds it. The Pallas kernel's per-tap-block
// rounding (pallas_conv.py `out_ref[0] += acc.astype(...)`) is not
// carried over.
//
// Both run subm_conv16_kernel, on the bf16 tensor cores. Its bound is the
// operations, 2 Cin Cout flops per live link at 989 TFLOP/s. The fp32
// design above, with bf16 rows widened as they were read, ran
// one TF32 m16n8k8 per 8 channels (two for the dx) in stages of 32
// channels. Timed with parts of the kernel switched off, its time went to
// a cost paid per stage (the barrier, the wait on the stage's loads, the
// loads' issue, the flush), to the map and its compaction, and, in the
// dx, to splitting every fp32 fragment into three pieces, far more than
// to the tensor cores' work: so the bf16 kernel makes fewer, fuller
// stages and splits only what needs splitting. It keeps steps 1,
// 3 and 4 (the compaction, the stage-local sums added to the shared
// accumulator in ascending tap order, the tap ranges' fixed-order
// reduction) and changes the rest:
//   - the operands go to the tensor cores as bf16: mma.sync.m16n8k16 with
//     ldmatrix fragments (W's transposed), half the mma instructions per
//     channel and no widening;
//   - a stage is a tap's list by 64 input channels (KC), twice the fp32
//     design's channels, in a ring of 2 (NS). The forward's stage holds
//     the tap's whole list (RC = 128 rows), so W's slice is loaded once per
//     tap and chunk; the dx's fp32 rows take twice the room, so its stage
//     holds 64 listed rows (a tap live in more takes two stages);
//   - 8 warps as 4 row lanes x 2 column groups of 32 output channels
//     (WR): each A fragment serves four 8-column tiles, and the dx splits
//     each fp32 fragment in two warps, not four;
//   - the dx's fp32 rows are split as they are read, hi first (rounded to
//     bf16) and what it leaves; only where a fragment leaves anything
//     (a warp vote) are mid and lo made and multiplied (tc_common.cuh
//     split_hi, split_mid_lo: hi + mid + lo = x exactly, so three bf16
//     products are exact to the fp32 level, as 3xTF32 was). An owner sum
//     of a single bf16 cotangent is a bf16 value, and only voxels shared
//     by several points leave a remainder (at the release shapes only the
//     finest stages' rows, ~10% of them), so elsewhere the dx multiplies
//     hi alone; skipping zero pieces leaves every sum as it was;
//   - the map rows are read 4 entries a thread at a time (their loads in
//     flight together), and the last warp builds the work list (a lane a
//     tap, a prefix sum) while the first four list the rows.
// mma.sync and not wgmma: the compacted lists are short (~2.3 live 16-row
// groups a tap and tile at the release shapes), where a 64-row wgmma
// would multiply mostly padding; with m16n8k16 the padding is at most 15
// rows a tap. The tensor cores' sums stay within a stage (4 mma a chain
// for the forward; the dx's hi pieces in one chain, lo then mid in
// another), then add up in registers, small pieces first.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"

namespace {

using r3dl::bf16;
using r3dl::Split;
using r3dl::split;

constexpr int kTM = 128;       // output rows per block
constexpr int kTN = 64;        // output channels per block
constexpr int kMaxTaps[] = {27, 125};   // k = 3; k = 5
constexpr int kThreads = 256;  // 8 warps: 2 row-group parities x 4 x 16 ch
constexpr int kAS = kTN + 4;   // accumulator rows
// the fp32 kernel's pipeline
constexpr int kStages = 2;     // pipeline stages in flight
constexpr int kKC = 32;        // input channels per stage
constexpr int kGroups = kTM / 32;   // 16-row groups per warp, at most
constexpr int kXS = kKC + 8;   // x rows: 8-byte A loads on 32 banks
constexpr int kWS = kTN + 4;   // W rows: B loads (rows 2t, 2t + 1) on 32
// the bf16 kernel's (Tc16): rows 16 bytes x an odd number apart for
// ldmatrix
constexpr int kWS16 = kTN + 8; // bf16 W rows: 144 bytes

// TX, the type of x: bf16 (the forward), or fp32 (the dx's owner sums)
template <typename TX>
struct Tc16 {
  static constexpr bool kFp32 = std::is_same<TX, float>::value;
  static constexpr int KC = 64;                // input channels a stage
  static constexpr int NS = 2;                 // the ring's stages
  // listed rows a stage holds: a tap's whole list for the forward; 64 for
  // the dx, whose fp32 rows take twice the room
  static constexpr int RC = kFp32 ? 64 : 128;
  // x rows: bf16 (KC + 8) x 2 bytes (ldmatrix); fp32 KC + 8 floats (the
  // split's 8-byte loads on 32 banks)
  static constexpr int XS = KC + 8;
  // 8 warps: WR row lanes x 8 / WR column groups of NT = WR 8-column
  // tiles; each warp multiplies GW of a stage's 16-row groups
  static constexpr int WR = 4;
  static constexpr int NT = WR;
  static constexpr int GW = RC / (16 * WR);
  static_assert(GW >= 1 && KC % 16 == 0 && NS >= 2, "a stage's shape");
};

// 4 consecutive outputs of one row
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                         __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

struct Pipe32 {                // the fp32 kernel's ring
  float xs[kStages][kTM * kXS];
  float ws[kStages][kKC * kWS];
};

template <typename TX>
struct Pipe16 {                // the bf16 kernel's ring
  TX xs[Tc16<TX>::NS][Tc16<TX>::RC * Tc16<TX>::XS];
  bf16 ws[Tc16<TX>::NS][Tc16<TX>::KC * kWS16];
};

// kItems: the capacity of the work list (a tap per item for the fp32
// kernel, up to kTM / RC for the bf16 one)
template <int kMaxK, class Pipe, int kItems>
struct Smem {
  float acc[kTM * kAS];
  union {
    Pipe pipe;
    struct {                   // the tile's map, before the pipeline
      int idx[kTM * kMaxK];
      unsigned char ok[kTM * kMaxK];
    } map;
  } u;
  int src[kMaxK][kTM];
  unsigned char pos[kMaxK][kTM];
  unsigned bal[kMaxK][kTM / 32];
  int cnt[kMaxK];
  int items[kItems];           // (first listed row) << 8 | tap, in order
  int nitems;
};

template <int kMaxK>
using Smem32 = Smem<kMaxK, Pipe32, kMaxK>;
template <int kMaxK, typename TX>
using Smem16 = Smem<kMaxK, Pipe16<TX>, kMaxK * (kTM / Tc16<TX>::RC)>;

// 1. The tile's map rows into shared memory (the tile's rows, and each
//    row's K entries, are contiguous), then the compaction: threads
//    0..kTM-1 own one row each; per tap of [k_begin, k_end) its live rows
//    (ascending tile positions `pos`, source rows `src`, `cnt` of them),
//    and the work list: each tap with a live row, cut into chunks of
//    `chunk` listed rows.
template <class Sm>
__device__ __forceinline__ void compact(Sm& sm, const int* __restrict__ idx,
                                        const unsigned char* __restrict__ ok,
                                        long long row0, int n0, int N, int K,
                                        int k_begin, int k_end, int chunk) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the map rows, kB entries a thread at a time, their loads in flight
  // together
  constexpr int kB = 4;
  const long long base = (row0 + n0) * K;
  const int total = kTM * K;
  for (int e0 = tid; e0 < total; e0 += kThreads * kB) {
    int v[kB];
    unsigned char o[kB];
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int e = e0 + j * kThreads;
      const bool in = e < total && n0 + e / K < N;
      o[j] = in ? ok[base + e] : 0;
      v[j] = in ? idx[base + e] : 0;
    }
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int e = e0 + j * kThreads;
      if (e >= total) break;
      const int k = e % K;
      const bool live = o[j] && k >= k_begin && k < k_end;
      sm.u.map.ok[e] = (unsigned char)live;
      sm.u.map.idx[e] = live ? v[j] : 0;
    }
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
  // the taps' counts and the work list, by the last warp: a lane a tap,
  // the items' positions by a prefix sum over the lanes
  if (warp == kThreads / 32 - 1) {
    int n = 0;
    for (int k0 = k_begin; k0 < k_end; k0 += 32) {
      const int k = k0 + lane;
      int c = 0;
      if (k < k_end)
        for (int i = 0; i < kTM / 32; ++i) c += __popc(sm.bal[k][i]);
      const int items = (c + chunk - 1) / chunk;
      int at = items;                          // inclusive prefix sum
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, at, d);
        if (lane >= d) at += y;
      }
      if (k < k_end) {
        sm.cnt[k] = c;
        for (int r = 0; r < items; ++r)
          sm.items[n + at - items + r] = r * chunk << 8 | k;
      }
      n += __shfl_sync(0xffffffffu, at, 31);
    }
    if (lane == 0) sm.nitems = n;
  }
  __syncthreads();
}

// 4. The tile out: with bias (rounded to TO once), or the tap range's
//    fp32 partial to scratch
template <typename TO>
__device__ __forceinline__ void write_tile(const float* acc,
                                           const float* __restrict__ bias,
                                           TO* __restrict__ out,
                                           float* __restrict__ work,
                                           long long row0, int n0, int co0,
                                           int N, int Cout, int s,
                                           int splits) {
  float* part = work + (long long)s * (gridDim.z / splits) * N * Cout;
  for (int e = threadIdx.x; e < kTM * (kTN / 4); e += kThreads) {
    const int r = e / (kTN / 4), q = e % (kTN / 4);
    const int col = co0 + 4 * q;
    if (n0 + r >= N || col >= Cout) continue;
    float4 v = *reinterpret_cast<const float4*>(acc + r * kAS + 4 * q);
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

// The fp32 kernel (x, W, out fp32; the design in the header)
template <int kMaxK>
__global__ void __launch_bounds__(kThreads, 2)
subm_conv_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                 const unsigned char* __restrict__ ok,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 float* __restrict__ out, float* __restrict__ work, int N,
                 int K, int Cin, int Cout, int splits) {
  extern __shared__ float4 smem4[];
  Smem32<kMaxK>& sm = *reinterpret_cast<Smem32<kMaxK>*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wr = warp & 1, wc = 16 * (warp >> 1);
  const int b = blockIdx.z / splits, s = blockIdx.z % splits;
  const int n0 = blockIdx.x * kTM, co0 = blockIdx.y * kTN;
  const int k_begin = s * K / splits, k_end = (s + 1) * K / splits;
  const long long row0 = (long long)b * N;

  for (int e = tid; e < kTM * kAS; e += kThreads) sm.acc[e] = 0.f;
  compact(sm, idx, ok, row0, n0, N, K, k_begin, k_end, kTM);

  // 2. stages (tap, chunk of Cin) over the taps with a live row, in a ring
  //    of kStages
  const int nch = (Cin + kKC - 1) / kKC;
  const int stages = sm.nitems * nch;
  auto load = [&](int i) {
    const int buf = i % kStages;
    const int k = sm.items[i / nch], c0 = (i % nch) * kKC;
    float* wb = sm.u.pipe.ws[buf];
    for (int e = tid; e < kKC * (kTN / 4); e += kThreads) {
      const int r = e / (kTN / 4), q = e % (kTN / 4);
      const int c = c0 + r, col = co0 + 4 * q;
      const bool p = c < Cin && col < Cout;
      r3dl::cp_async16(wb + r * kWS + 4 * q,
                       p ? w + ((long long)k * Cin + c) * Cout + col : w, p);
    }
    const int cnt = sm.cnt[k], rows = (cnt + 15) & ~15;
    float* xb = sm.u.pipe.xs[buf];
    for (int e = tid; e < rows * (kKC / 4); e += kThreads) {
      const int r = e / (kKC / 4), q = e % (kKC / 4);
      const int c = c0 + 4 * q;
      const bool p = r < cnt && c < Cin;
      r3dl::cp_async16(xb + r * kXS + 4 * q,
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
    const int k = sm.items[i / nch];
    const int cnt = sm.cnt[k], groups = (cnt + 15) >> 4;
    const float* xb = sm.u.pipe.xs[i % kStages];
    const float* wb = sm.u.pipe.ws[i % kStages];
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      const int g = wr + 2 * gi;
      if (g >= groups) break;
      float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < kKC / 8; ++ks) {
        const float* x0 = xb + (16 * g + gid) * kXS + 8 * ks + 2 * tig;
        Split bf[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = wc + 8 * j + gid;
          bf[j][0] = split(wb[(8 * ks + 2 * tig) * kWS + col]);
          bf[j][1] = split(wb[(8 * ks + 2 * tig + 1) * kWS + col]);
        }
        const float2 v0 = *reinterpret_cast<const float2*>(x0);
        const float2 v8 = *reinterpret_cast<const float2*>(x0 + 8 * kXS);
        const Split af[4] = {split(v0.x), split(v8.x), split(v0.y),
                             split(v8.y)};
#pragma unroll
        for (int j = 0; j < 2; ++j) r3dl::mma3(part[j], af, bf[j]);
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

  write_tile(sm.acc, bias, out, work, row0, n0, co0, N, Cout, s, splits);
}

// The bf16 kernel (the header): W and out bf16; x bf16 (the forward) or
// fp32 (the input gradient's owner sums)
template <int kMaxK, typename TX>
__global__ void __launch_bounds__(kThreads, 2)
subm_conv16_kernel(const TX* __restrict__ x, const int* __restrict__ idx,
                   const unsigned char* __restrict__ ok,
                   const bf16* __restrict__ w, const float* __restrict__ bias,
                   bf16* __restrict__ out, float* __restrict__ work, int N,
                   int K, int Cin, int Cout, int splits) {
  using C = Tc16<TX>;
  constexpr int KC = C::KC, NS = C::NS, XS = C::XS, RC = C::RC;
  constexpr int KS = KC / 16;            // 16-channel steps a stage
  constexpr int VX = 16 / sizeof(TX);    // x channels in 16 bytes
  extern __shared__ float4 smem4[];
  Smem16<kMaxK, TX>& sm = *reinterpret_cast<Smem16<kMaxK, TX>*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;   // ldmatrix: matrix, its row
  // warp: row lane wr (groups wr, wr + WR, ..), columns wc..wc + 8 NT - 1
  constexpr int WR = C::WR, NT = C::NT;
  const int wr = warp % WR, wc = 8 * NT * (warp / WR);
  const int b = blockIdx.z / splits, s = blockIdx.z % splits;
  const int n0 = blockIdx.x * kTM, co0 = blockIdx.y * kTN;
  const int k_begin = s * K / splits, k_end = (s + 1) * K / splits;
  const long long row0 = (long long)b * N;

  for (int e = tid; e < kTM * kAS; e += kThreads) sm.acc[e] = 0.f;
  compact(sm, idx, ok, row0, n0, N, K, k_begin, k_end, RC);

  // 2. stages (row chunk of a tap, chunk of Cin) in a ring of NS
  const int nch = (Cin + KC - 1) / KC;
  const int stages = sm.nitems * nch;
  auto load = [&](int i) {
    const int buf = i % NS;
    const int it = sm.items[i / nch], k = it & 255, r0 = it >> 8;
    const int c0 = (i % nch) * KC;
    bf16* wb = sm.u.pipe.ws[buf];
    for (int e = tid; e < KC * (kTN / 8); e += kThreads) {
      const int r = e / (kTN / 8), q = e % (kTN / 8);
      const int c = c0 + r, col = co0 + 8 * q;
      const bool p = c < Cin && col < Cout;
      r3dl::cp_async16(wb + r * kWS16 + 8 * q,
                       p ? w + ((long long)k * Cin + c) * Cout + col : w, p);
    }
    const int cnt = min(RC, sm.cnt[k] - r0), rows = (cnt + 15) & ~15;
    TX* xb = sm.u.pipe.xs[buf];
    for (int e = tid; e < rows * (KC / VX); e += kThreads) {
      const int r = e / (KC / VX), q = e % (KC / VX);
      const int c = c0 + VX * q;
      const bool p = r < cnt && c < Cin;
      r3dl::cp_async16(xb + r * XS + VX * q,
                       p ? x + (row0 + sm.src[k][r0 + r]) * Cin + c : x, p);
    }
  };

  // this warp's groups of a chunk's RC / 16
  float acc[C::GW][NT][4];
#pragma unroll
  for (int gi = 0; gi < C::GW; ++gi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[gi][j][e] = 0.f;

  for (int i = 0; i < NS - 1; ++i) {
    if (i < stages) load(i);
    r3dl::cp_async_commit();
  }
  for (int i = 0; i < stages; ++i) {
    // stage i has landed, and every warp is done with stage i - 1, whose
    // slot the load below refills
    r3dl::cp_async_wait<NS - 2>();
    __syncthreads();
    if (i + NS - 1 < stages) load(i + NS - 1);
    r3dl::cp_async_commit();
    const int it = sm.items[i / nch], k = it & 255, r0 = it >> 8;
    const int cnt = min(RC, sm.cnt[k] - r0), groups = (cnt + 15) >> 4;
    const TX* xb = sm.u.pipe.xs[i % NS];
    const bf16* wb = sm.u.pipe.ws[i % NS];
    if (wr < groups) {
      // B fragments of this warp's 8 NT output channels: ldmatrix
      // .x4.trans jj, matrix m holds input channels 16ks + 8 (m % 2)..,
      // output columns wc + 16jj + 8 (m / 2)..: b0, b1 of column tile
      // 2jj, then of tile 2jj + 1
      uint32_t bw[KS][NT / 2][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int jj = 0; jj < NT / 2; ++jj)
          r3dl::ldmatrix_x4_trans(
              bw[ks][jj], wb + (16 * ks + 8 * (lm & 1) + lr) * kWS16 + wc +
                              16 * jj + 8 * (lm >> 1));
#pragma unroll
      for (int gi = 0; gi < C::GW; ++gi) {
        const int g = wr + WR * gi;
        if (g >= groups) break;
        // the stage's sums; at fp32 x the hi pieces in one chain, mid and
        // lo in another (both are zero wherever a sum is a single bf16
        // cotangent, and a warp skips their products on a fragment where
        // they all are)
        float part[NT][4], small[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][e] = small[j][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if constexpr (C::kFp32) {
            uint32_t hi[4], mid[4], lo[4];
            // this lane's A elements (rows 16g + gid, + 8; channels
            // 16ks + 2tig, + 8) as hi pieces and what they leave; mid
            // and lo only where the fragment leaves anything
            const float* x0 = reinterpret_cast<const float*>(xb) +
                              (16 * g + gid) * XS + 16 * ks + 2 * tig;
            float2 r[4];
            uint32_t left = 0u;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              r[q] = r3dl::split_hi(*reinterpret_cast<const float2*>(
                                        x0 + (q & 1) * 8 * XS + (q >> 1) * 8),
                                    hi[q]);
              left |= __float_as_uint(r[q].x) | __float_as_uint(r[q].y);
            }
            const bool any_left =
                __any_sync(0xffffffffu, (left & 0x7fffffffu) != 0u);
            if (any_left)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                r3dl::split_mid_lo(r[q], mid[q], lo[q]);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const uint32_t b0 = bw[ks][j / 2][2 * (j % 2)];
              const uint32_t b1 = bw[ks][j / 2][2 * (j % 2) + 1];
              if (any_left) {
                r3dl::mma_bf16(small[j], lo, b0, b1);
                r3dl::mma_bf16(small[j], mid, b0, b1);
              }
              r3dl::mma_bf16(part[j], hi, b0, b1);
            }
          } else {
            // A matrix m: rows 16g + 8 (m % 2).., channels 16ks + 8 (m / 2)..
            uint32_t a[4];
            r3dl::ldmatrix_x4(a, xb + (16 * g + 8 * (lm & 1) + lr) * XS +
                                     16 * ks + 8 * (lm >> 1));
#pragma unroll
            for (int j = 0; j < NT; ++j)
              r3dl::mma_bf16(part[j], a, bw[ks][j / 2][2 * (j % 2)],
                             bw[ks][j / 2][2 * (j % 2) + 1]);
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)   // the small pieces' sum first
            acc[gi][j][e] += C::kFp32 ? small[j][e] + part[j][e]
                                      : part[j][e];
      }
    }
    if (i % nch == nch - 1) {
      // 3. the chunk's products into the tile's accumulator (its rows are
      //    distinct, and stages are separated by a barrier)
#pragma unroll
      for (int gi = 0; gi < C::GW; ++gi) {
        const int g = wr + WR * gi;
        if (g < groups)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * g + gid + 8 * h;
            if (r < cnt) {
              float* a = sm.acc + sm.pos[k][r0 + r] * kAS + wc + 2 * tig;
#pragma unroll
              for (int j = 0; j < NT; ++j) {
                a[8 * j] += acc[gi][j][2 * h];
                a[8 * j + 1] += acc[gi][j][2 * h + 1];
              }
            }
          }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[gi][j][e] = 0.f;
      }
    }
  }
  __syncthreads();

  write_tile(sm.acc, bias, out, work, row0, n0, co0, N, Cout, s, splits);
}

// out = sum over the tap ranges, in order, + bias, rounded to T (the
// output's type) once; float4 lanes
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

// the fp32 kernel for fp32 W, else the bf16 one
template <int kMaxK, typename TX, typename TW, typename TO>
cudaError_t launch_conv(const TX* x, const int* idx, const unsigned char* ok,
                        const TW* w, const float* bias, TO* out, float* work,
                        int B, int N, int K, int Cin, int Cout, int splits,
                        cudaStream_t stream) {
  const dim3 grid((N + kTM - 1) / kTM, (Cout + kTN - 1) / kTN, B * splits);
  if constexpr (std::is_same<TW, float>::value) {
    static const cudaError_t attr = r3dl::allow_smem(
        subm_conv_kernel<kMaxK>, sizeof(Smem32<kMaxK>));
    if (attr != cudaSuccess) return attr;
    subm_conv_kernel<kMaxK><<<grid, kThreads, sizeof(Smem32<kMaxK>),
                              stream>>>(x, idx, ok, w, bias, out, work, N, K,
                                        Cin, Cout, splits);
  } else {
    static const cudaError_t attr = r3dl::allow_smem(
        subm_conv16_kernel<kMaxK, TX>, sizeof(Smem16<kMaxK, TX>));
    if (attr != cudaSuccess) return attr;
    subm_conv16_kernel<kMaxK, TX><<<grid, kThreads,
                                    sizeof(Smem16<kMaxK, TX>), stream>>>(
        x, idx, ok, w, bias, out, work, N, K, Cin, Cout, splits);
  }
  return cudaGetLastError();
}

template <typename TX, typename TW, typename TO>
int conv(const TX* x, const int* idx, const unsigned char* ok, const TW* w,
         const float* bias, TO* out, float* work, int B, int N, int K,
         int Cin, int Cout, int splits, long long work_bytes,
         cudaStream_t stream) {
  // channels in 16 bytes: Cin counts x's pieces, Cout the weight's
  constexpr int VX = 16 / sizeof(TX), VW = 16 / sizeof(TW);
  const long long n = (long long)B * N * Cout;
  if (n == 0) return (int)cudaGetLastError();
  if (K < 1 || K > kMaxTaps[1] || Cin % VX || Cout % VW || splits < 1 ||
      splits > K || (long long)B * splits > 65535 ||
      (((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) & 15) ||
      (splits > 1 && (!work || work_bytes < 4 * splits * n ||
                      ((uintptr_t)work & 15))))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      K <= kMaxTaps[0]
          ? launch_conv<kMaxTaps[0], TX, TW, TO>(x, idx, ok, w, bias, out,
                                                 work, B, N, K, Cin, Cout,
                                                 splits, stream)
          : launch_conv<kMaxTaps[1], TX, TW, TO>(x, idx, ok, w, bias, out,
                                                 work, B, N, K, Cin, Cout,
                                                 splits, stream);
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const long long n4 = n / 4, blocks = (n4 + 255) / 256;
    subm_conv_reduce_kernel<TO>
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
  return conv<float, float, float>(x, idx, ok, w, bias, out, work, B, N, K,
                                   Cin, Cout, splits, work_bytes, stream);
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
  return conv<r3dl::bf16, r3dl::bf16, r3dl::bf16>(
      x, idx, ok, w, bias, out, work, B, N, K, Cin, Cout, splits, work_bytes,
      stream);
}

// The input gradient at bf16: x fp32 (the owner sums), w the mirrored bf16
// weight, out bf16 (bias and work fp32); Cin a multiple of 4, Cout of 8.
extern "C" int r3dl_subm_conv_dx_bf16(const float* x, const int* idx,
                                      const unsigned char* ok,
                                      const r3dl::bf16* w, const float* bias,
                                      r3dl::bf16* out, float* work, int B,
                                      int N, int K, int Cin, int Cout,
                                      int splits, long long work_bytes,
                                      cudaStream_t stream) {
  return conv<float, r3dl::bf16, r3dl::bf16>(x, idx, ok, w, bias, out, work,
                                              B, N, K, Cin, Cout, splits,
                                              work_bytes, stream);
}
