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
//      groups cannot fill the card: the taps are split over blocks
//      (ops/stem.py stem_conv_plan), each block writes its partial tile to
//      scratch and stem_conv_sum_kernel adds them in a fixed order. No
//      float atomics: the result is bit-equal from launch to launch.
//   5. A row's sum order does not depend on B: the taps are cut into sum
//      ranges of kRangeTaps (16) taps, a function of K alone. Each range
//      is summed into a fresh fp32 partial (the tensor cores' chains) and
//      added to the running total at the range's end, so a row is
//      ((0 + r0) + r1) + ... whichever plan runs it. The plans that
//      stem_conv_plan picks hold the whole row in one block (the total in
//      registers, one more accumulator set) or one sum range a block (the
//      sum kernel adds the partials from 0, in order): the same bits, so
//      predict_batch of a cloud equals its predict. The cost: an add per
//      range, the 128-register cap (the second accumulator set spills a
//      little at 64 columns; keeping the total in the output rows or in
//      shared memory instead cost as much) and, at B < 32, the 8 ranges'
//      partials through scratch.
//
// bf16 (r3dl_stem_conv_bf16, under compute_dtype bfloat16): x and W bf16,
// out bf16, on the bf16 tensor cores (stem_conv16_kernel). The first bf16
// path ran the fp32 schedule on widened values: the W slice widened to fp32
// a scalar at a time (224 KB, so one 16-warp block an SM), every A element
// a 2-byte gather, one TF32 m16n8k8 a tap. Now:
//   1. x's rows are zero-padded to 8 channels (16 bytes) by a first kernel
//      of the same call (stem_pad8_kernel; none at Cin = 8), so that a
//      link is one 16-byte load.
//   2. The block stages its W slice as bf16 with 16-byte cp.async, laid
//      out [tap][n-tile][channel][8 columns] (128 bytes a tap and n-tile):
//      ldmatrix.x4.trans gives the m16n8k16 B fragments of a tap pair and
//      two n-tiles, k = 16 being two taps x 8 channels (Cin zero-padded;
//      a range's odd last tap paired with a zero tap). 125 taps x 64
//      columns are 126 KB, so one 16-warp block an SM at B = 32.
//   3. A warp owns 16 rows and walks its range in chunks of 8 tap pairs
//      (16 taps). The map's reads, not the products, set the pace: the
//      warp reads a chunk's map coalesced (a load covers two rows' runs of
//      16 taps, the next chunk's in flight) and turns it around through a
//      small per-warp tile in shared memory, so that lane l holds link
//      (row l % 16, tap 2q + l / 16) of each pair q and gathers it itself:
//      the chunk's 8 x rows as 16-byte loads issued together. A pair no
//      link of the warp's 32
//      reaches is skipped by one ballot; a live pair's links go to the
//      warp's 512-byte tile in shared memory in lane order, which is the
//      ldmatrix.x4 layout of the A fragment (rows 0-7 / 8-15 of the
//      first tap, then of the second), and J n-tiles of
//      bf16 mma.sync.m16n8k16 follow: one product a live pair where the
//      TF32 path ran one a tap. Products of bf16 values are exact in fp32.
//   4. The sums stay fp32 over every tap, through the sum ranges' partials
//      (a bf16 chunk is one sum range) and their fixed-order sum
//      (stem_conv_sum_kernel, or the block's running total), and are rounded
//      to bf16 once, as the JAX XLA conv (robot3dlotus_tpu/ops/
//      sparse_conv.py subm_conv_apply) rounds its fp32 accumulator; no
//      float atomics, so bit-equal from launch to launch. Cout is a
//      multiple of 8 (ops/stem.py pads the weight's columns).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

using r3dl::Split;
using r3dl::split;

constexpr int kCp = 8;             // channels per tap after padding
constexpr int kKT = 8;             // taps per chunk
constexpr int kRangeTaps = 16;     // taps of a sum range (step 5)
constexpr int kMaxWarps = 16;      // 16-row groups per block, at most
constexpr int kMaxK = 128;         // taps a map row may hold
constexpr int kMaxSmem = 227 * 1024;  // shared memory a block may hold
constexpr unsigned kFull = 0xffffffffu;

// tap range [kb, ke) of block range s of `splits`: the sum ranges
// [s NR / splits, (s + 1) NR / splits) of NR = ceil(K / kRangeTaps)
__host__ __device__ __forceinline__ int range_begin(int K, int s,
                                                    int splits) {
  const int nr = (K + kRangeTaps - 1) / kRangeTaps;
  return min(K, s * nr / splits * kRangeTaps);
}

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

// the fp32 path (see the header's design)
template <int kCols>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
stem_conv_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                 const unsigned char* __restrict__ ok,
                 const float* __restrict__ w, float* __restrict__ out,
                 float* __restrict__ work, int rows, int N, int K, int Cin,
                 int Cout, int splits) {
  constexpr int J = kCols / 8;               // n-tiles
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // [R][J][Cin][8]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int s = blockIdx.z, co0 = blockIdx.y * kCols;
  const int kb = range_begin(K, s, splits);
  const int ke = range_begin(K, s + 1, splits);
  const int R = ke - kb;                     // this range's taps

  // 1. the range's W slice: W[kb + t][c][co0 + 8 j + g] at
  //    ws[((t J + j) Cin + c) 8 + g]; columns past Cout zero-filled
  for (int e = tid; e < R * Cin * J * 2; e += blockDim.x) {
    const int h = e & 1, j = (e >> 1) % J, tc = (e >> 1) / J;
    const int c = tc % Cin, t = tc / Cin;
    const int col = co0 + 8 * j + 4 * h;
    const bool p = col < Cout;
    r3dl::cp_async16(ws + (((t * J + j) * Cin + c) * 8 + 4 * h),
                     p ? w + ((long long)(kb + t) * Cin + c) * Cout + col : w,
                     p);
  }
  r3dl::cp_async_commit();
  r3dl::cp_async_wait<0>();
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
    const float* xb0 = x + (long long)(r0 / N) * N * Cin;
    const float* xb1 = x + (long long)(r1 / N) * N * Cin;

    unsigned char o_next[4];
    int i_next[4];
    load_map(o_next, i_next, ok, idx, my_off, my_in, kb, ke, lane);

    // acc: the current sum range's partial; total: the ranges' sum
    float acc[J][4], total[J][4];
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = total[j][e] = 0.f;

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
        const float* x0 = xb0 + (long long)src0[t] * Cin;
        const float* x1 = xb1 + (long long)src1[t] * Cin;
        a[t][0] = src0[t] >= 0 && tig < Cin ? x0[tig] : 0.f;
        a[t][1] = src1[t] >= 0 && tig < Cin ? x1[tig] : 0.f;
        a[t][2] = src0[t] >= 0 && tig + 4 < Cin ? x0[tig + 4] : 0.f;
        a[t][3] = src1[t] >= 0 && tig + 4 < Cin ? x1[tig + 4] : 0.f;
      }
      // 3. the live taps' products
#pragma unroll
      for (int t = 0; t < kKT; ++t) {
        if (!__any_sync(kFull, src0[t] >= 0 || src1[t] >= 0)) continue;
        const float* wt = ws + (c0 + t) * J * Cin * 8;
        const Split af[4] = {split(a[t][0]), split(a[t][1]), split(a[t][2]),
                             split(a[t][3])};
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float* wj = wt + j * Cin * 8 + gid;
          const Split bf[2] = {split(tig < Cin ? wj[tig * 8] : 0.f),
                               split(tig + 4 < Cin ? wj[(tig + 4) * 8] : 0.f)};
          r3dl::mma3(acc[j], af, bf);
        }
      }
      // 5. a sum range ends (kb is a multiple of kRangeTaps): its partial
      //    into the total
      if ((c0 + kKT) % kRangeTaps == 0 || c0 + kKT >= R) {
#pragma unroll
        for (int j = 0; j < J; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            total[j][e] += acc[j][e];
            acc[j][e] = 0.f;
          }
      }
    }

    // 4. the group's rows out, or the block's fp32 partial to scratch
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int col = co0 + 8 * j + 2 * tig;
      if (col >= Cout) break;
      const long long o0 = (long long)r0 * Cout + col;
      const long long o1 = (long long)r1 * Cout + col;
      float* dst = splits > 1 ? part : out;
      if (r0 < rows) store2(dst + o0, total[j][0], total[j][1]);
      if (r1 < rows) store2(dst + o1, total[j][2], total[j][3]);
    }
  }
}

// ---- bf16 (see the header) ----

constexpr int kPairs = 8;          // tap pairs a chunk (k = 16 each)
constexpr int kPairTile = 32;      // 16-byte links of a pair's A tile
constexpr int kMapStride = 18;     // ints a row of a warp's map tile: its
                                   // 16 taps, padded so that a pair's
                                   // 32 reads hit 32 banks
// a warp's shared memory after the W slice: its A tile, then its map tile
// (16 rows x kMapStride ints), in 16-byte units
constexpr int kWarpSmem16 = kPairTile + 16 * kMapStride / 4;

// shared memory of a bf16 block: the W slice of R taps (rounded up to a
// pair), then each warp's A tile and map tile
template <int kCols>
size_t smem_bytes16(int R, int warps) {
  return (size_t)((R + 1) / 2 * 2) * (kCols / 8) * 128 +
         (size_t)warps * kWarpSmem16 * 16;
}

// xp[r] = row r of x (Cin bf16) with zero channels up to 8
__global__ void stem_pad8_kernel(const unsigned short* __restrict__ x,
                                 uint4* __restrict__ xp, long long rows,
                                 int Cin) {
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < rows; r += (long long)gridDim.x * blockDim.x) {
    const unsigned short* xr = x + r * Cin;
    unsigned v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = c < Cin ? xr[c] : 0u;
    xp[r] = make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16,
                       v[4] | v[5] << 16, v[6] | v[7] << 16);
  }
}

// a chunk's map entries (ok, idx) of a warp's 16 rows x 16 taps, read
// coalesced: lane l reads tap k0 + l % 16 of rows n0 + 2 e + l / 16 (row
// offsets off0 + 2 e K), e < 8, so that a load covers two rows' runs of 16
// taps; taps from ke on and rows from `rows` on read as dead. ok and idx
// are read together, not one after the other.
__device__ __forceinline__ void load_links(
    unsigned char (&o)[kPairs], int (&i)[kPairs],
    const unsigned char* __restrict__ ok, const int* __restrict__ idx,
    long long off0, int r0, int rows, int K, int k, int ke) {
#pragma unroll
  for (int e = 0; e < kPairs; ++e) {
    const bool p = r0 + 2 * e < rows && k < ke;
    const long long at = off0 + (long long)(2 * e) * K + k;
    o[e] = p ? __ldg(ok + at) : 0;
    i[e] = p ? __ldg(idx + at) : 0;
  }
}

template <int kCols>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
stem_conv16_kernel(const uint4* __restrict__ x, const int* __restrict__ idx,
                   const unsigned char* __restrict__ ok,
                   const r3dl::bf16* __restrict__ w,
                   r3dl::bf16* __restrict__ out, float* __restrict__ work,
                   int rows, int N, int K, int Cin, int Cout, int splits) {
  constexpr int J = kCols / 8;               // n-tiles, an even count
  extern __shared__ uint4 smem16[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int s = blockIdx.z, co0 = blockIdx.y * kCols;
  const int kb = range_begin(K, s, splits);
  const int ke = range_begin(K, s + 1, splits);
  const int R = ke - kb, R2 = (R + 1) / 2 * 2;
  uint4* ws = smem16;   // [R2][J][8 channels]: 8 columns of bf16 a row
  uint4* tile = smem16 + R2 * J * 8 + warp * kWarpSmem16;
  int* map = reinterpret_cast<int*>(tile + kPairTile);   // [16][kMapStride]

  // 1. the range's W slice: W[kb + t][c][co0 + 8 j .. + 7] at
  //    ws[(t J + j) 8 + c]; channels past Cin, taps past ke and columns
  //    past Cout zero-filled
  for (int e = tid; e < R2 * 8 * J; e += blockDim.x) {
    const int j = e % J, tc = e / J;
    const int c = tc & 7, t = tc >> 3;
    const int col = co0 + 8 * j;
    const bool p = kb + t < ke && c < Cin && col < Cout;
    r3dl::cp_async16(ws + (t * J + j) * 8 + c,
                     p ? w + ((long long)(kb + t) * Cin + c) * Cout + col : w,
                     p);
  }
  r3dl::cp_async_commit();
  r3dl::cp_async_wait<0>();
  __syncthreads();

  float* part = work + (long long)s * rows * Cout;
  const int groups = (rows + 15) / 16;
  // this lane's link of a pair: row n0 + lane % 16, the pair's tap h
  const int h = lane >> 4;
  // its ldmatrix.x4.trans row of a pair's W: tap h' = (lane / 8) % 2,
  // n-tile offset lane / 16, channel lane % 8
  const int w_lane = (((lane >> 3) & 1) * J + (lane >> 4)) * 8 + (lane & 7);
  for (int grp = blockIdx.x * warps + warp; grp < groups;
       grp += gridDim.x * warps) {
    const int n0 = grp * 16;
    const int my_row = n0 + (lane & 15);
    const uint4* xb = x + (long long)(my_row < rows ? my_row / N : 0) * N;
    // the coalesced map reads: this lane's rows n0 + 2 e + h, tap
    // k0 + lane % 16
    const int mr0 = n0 + h;
    const long long off0 = (long long)mr0 * K;

    unsigned char o_next[kPairs];
    int i_next[kPairs];
    load_links(o_next, i_next, ok, idx, off0, mr0, rows, K,
               kb + (lane & 15), ke);

    // acc: the chunk's partial (a chunk is one sum range); total: the
    // ranges' sum
    float acc[J][4], total[J][4];
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = total[j][e] = 0.f;

    static_assert(2 * kPairs == kRangeTaps, "a chunk is one sum range");
    for (int c0 = 0; c0 < R; c0 += 2 * kPairs) {
      // 2. this chunk's links through the warp's map tile (row 2 e + h,
      //    tap lane % 16 in; this lane's link of pair q, row lane % 16,
      //    tap 2 q + h, out: the source row, or -1 where the link is
      //    dead), the next chunk's map in flight, the chunk's x rows
      //    loaded together
#pragma unroll
      for (int e = 0; e < kPairs; ++e)
        map[(2 * e + h) * kMapStride + (lane & 15)] =
            o_next[e] && (unsigned)i_next[e] < (unsigned)N ? i_next[e] : -1;
      __syncwarp();
      int src[kPairs];
#pragma unroll
      for (int q = 0; q < kPairs; ++q)
        src[q] = map[(lane & 15) * kMapStride + 2 * q + h];
      __syncwarp();
      if (c0 + 2 * kPairs < R)
        load_links(o_next, i_next, ok, idx, off0, mr0, rows, K,
                   kb + c0 + 2 * kPairs + (lane & 15), ke);
      uint4 v[kPairs];
#pragma unroll
      for (int q = 0; q < kPairs; ++q)
        v[q] = src[q] >= 0 ? __ldg(xb + src[q]) : make_uint4(0u, 0u, 0u, 0u);
      // 3. a live pair: its A tile, then J products of m16n8k16
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        if (!__any_sync(kFull, src[q] >= 0)) continue;
        tile[lane] = v[q];
        __syncwarp();
        uint32_t a[4];
        r3dl::ldmatrix_x4(a, tile + lane);
        const uint4* wt = ws + (c0 + 2 * q) * J * 8 + w_lane;
#pragma unroll
        for (int j = 0; j < J; j += 2) {
          uint32_t b[4];
          r3dl::ldmatrix_x4_trans(b, wt + j * 8);
          r3dl::mma_bf16(acc[j], a, b[0], b[1]);
          r3dl::mma_bf16(acc[j + 1], a, b[2], b[3]);
        }
      }
      // 5. the chunk's sum range ends: its partial into the total
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          total[j][e] += acc[j][e];
          acc[j][e] = 0.f;
        }
    }

    // 4. the group's rows out (rounded to bf16), or the block's fp32
    //    partial to scratch
    const int r0 = n0 + gid, r1 = r0 + 8;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int col = co0 + 8 * j + 2 * tig;
      if (col >= Cout) break;
      const long long o0 = (long long)r0 * Cout + col;
      const long long o1 = (long long)r1 * Cout + col;
      if (splits > 1) {
        if (r0 < rows) store2(part + o0, total[j][0], total[j][1]);
        if (r1 < rows) store2(part + o1, total[j][2], total[j][3]);
      } else {
        if (r0 < rows) store2(out + o0, total[j][0], total[j][1]);
        if (r1 < rows) store2(out + o1, total[j][2], total[j][3]);
      }
    }
  }
}

// out = the sum of the block ranges' partials, in order from 0 (the
// running total of step 5), rounded to T once; float4 lanes
template <typename T>
__global__ void stem_conv_sum_kernel(const float4* __restrict__ work,
                                     T* __restrict__ out, long long n4,
                                     int splits) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n4; e += (long long)gridDim.x * blockDim.x) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
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

// the longest block range's taps
int range_taps(int K, int splits) {
  int most = 0;
  for (int s = 0; s < splits; ++s)
    most = max(most,
               range_begin(K, s + 1, splits) - range_begin(K, s, splits));
  return most;
}

template <int kCols>
int launch(const float* x, const int* idx, const unsigned char* ok,
           const float* w, float* out, float* work, int B, int N, int K,
           int Cin, int Cout, int warps, int splits, int blocks,
           cudaStream_t stream) {
  static const cudaError_t attr =
      r3dl::allow_smem(stem_conv_kernel<kCols>, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = smem_bytes<kCols>(range_taps(K, splits), Cin);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, (Cout + kCols - 1) / kCols, splits);
  stem_conv_kernel<kCols><<<grid, 32 * warps, smem, stream>>>(
      x, idx, ok, w, out, work, B * N, N, K, Cin, Cout, splits);
  return (int)cudaGetLastError();
}

template <int kCols>
int launch16(const uint4* x, const int* idx, const unsigned char* ok,
             const r3dl::bf16* w, r3dl::bf16* out, float* work, int B, int N,
             int K, int Cin, int Cout, int warps, int splits, int blocks,
             cudaStream_t stream) {
  static const cudaError_t attr =
      r3dl::allow_smem(stem_conv16_kernel<kCols>, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = smem_bytes16<kCols>(range_taps(K, splits), warps);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, (Cout + kCols - 1) / kCols, splits);
  stem_conv16_kernel<kCols><<<grid, 32 * warps, smem, stream>>>(
      x, idx, ok, w, out, work, B * N, N, K, Cin, Cout, splits);
  return (int)cudaGetLastError();
}

// the plan's and the buffers' checks shared by both paths
bool bad_args(long long n, int B, int N, int K, int Cin, int Cout, int cols,
              int warps, int splits, int blocks, const void* w,
              const void* out, const float* work, long long work_bytes,
              int cout_unit) {
  const int ranges = (K + kRangeTaps - 1) / kRangeTaps;
  return K < 1 || K > kMaxK || Cin < 1 || Cin > kCp || Cout % cout_unit ||
         (cols != 64 && cols != 32) || warps < 1 || warps > kMaxWarps ||
         splits < 1 || splits > ranges || blocks < 1 ||
         (long long)B * N > 0x7fffffffLL || ((uintptr_t)w & 15) ||
         ((uintptr_t)out & 15) ||
         (splits > 1 && (!work || work_bytes < 4 * splits * n ||
                         ((uintptr_t)work & 15)));
}

template <typename T>
int sum_ranges(const float* work, T* out, long long n, int splits,
               cudaStream_t stream) {
  const long long n4 = n / 4, sum_blocks = (n4 + 255) / 256;
  stem_conv_sum_kernel<T>
      <<<(unsigned)(sum_blocks < 4096 ? sum_blocks : 4096), 256, 0,
         stream>>>(reinterpret_cast<const float4*>(work), out, n4, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// cols: output channels per block (64, or 32: the fp32 W slice of 125 taps
// at Cin = 8 fits shared memory only so); warps: 16-row groups per block
// (1..16); blocks: blocks per column tile and range (each walks row groups
// blockIdx.x + i gridDim.x); splits: block ranges of taps, range s the
// 16-tap sum ranges [s NR / splits, (s + 1) NR / splits) of NR =
// ceil(K / 16) (1 or NR keep every row's sum order, step 5); work:
// (splits, B, N, Cout) fp32 scratch of work_bytes bytes, unused (may be
// NULL) when splits == 1 (ops/stem.py stem_conv_plan).
extern "C" int r3dl_stem_conv(const float* x, const int* idx,
                              const unsigned char* ok, const float* w,
                              float* out, float* work, int B, int N, int K,
                              int Cin, int Cout, int cols, int warps,
                              int splits, int blocks, long long work_bytes,
                              cudaStream_t stream) {
  const long long n = (long long)B * N * Cout;
  if (n == 0) return (int)cudaGetLastError();
  if (bad_args(n, B, N, K, Cin, Cout, cols, warps, splits, blocks, w, out,
               work, work_bytes, 4))
    return (int)cudaErrorInvalidValue;
  const int err = cols == 64
                      ? launch<64>(x, idx, ok, w, out, work, B, N, K, Cin,
                                   Cout, warps, splits, blocks, stream)
                      : launch<32>(x, idx, ok, w, out, work, B, N, K, Cin,
                                   Cout, warps, splits, blocks, stream);
  if (err != cudaSuccess || splits == 1) return err;
  return sum_ranges(work, out, n, splits, stream);
}

// The same with bf16 x (B, N, Cin), w and out (work fp32), Cout a multiple
// of 8; xp: (B, N, 8) bf16 scratch that x's rows are padded into when
// Cin < 8 (16-byte aligned; unused, may be NULL, at Cin = 8, where x
// itself must be 16-byte aligned).
extern "C" int r3dl_stem_conv_bf16(const r3dl::bf16* x, r3dl::bf16* xp,
                                   const int* idx, const unsigned char* ok,
                                   const r3dl::bf16* w, r3dl::bf16* out,
                                   float* work, int B, int N, int K, int Cin,
                                   int Cout, int cols, int warps, int splits,
                                   int blocks, long long work_bytes,
                                   cudaStream_t stream) {
  const long long n = (long long)B * N * Cout;
  if (n == 0) return (int)cudaGetLastError();
  const r3dl::bf16* rows8 = Cin < kCp ? xp : x;
  if (bad_args(n, B, N, K, Cin, Cout, cols, warps, splits, blocks, w, out,
               work, work_bytes, 8) ||
      !rows8 || ((uintptr_t)rows8 & 15))
    return (int)cudaErrorInvalidValue;
  if (Cin < kCp) {
    const long long r = (long long)B * N, pad_blocks = (r + 255) / 256;
    stem_pad8_kernel<<<(unsigned)(pad_blocks < 4096 ? pad_blocks : 4096),
                       256, 0, stream>>>(
        reinterpret_cast<const unsigned short*>(x),
        reinterpret_cast<uint4*>(xp), r, Cin);
  }
  const uint4* x8 = reinterpret_cast<const uint4*>(rows8);
  const int err = cols == 64
                      ? launch16<64>(x8, idx, ok, w, out, work, B, N, K, Cin,
                                     Cout, warps, splits, blocks, stream)
                      : launch16<32>(x8, idx, ok, w, out, work, B, N, K, Cin,
                                     Cout, warps, splits, blocks, stream);
  if (err != cudaSuccess || splits == 1) return err;
  return sum_ranges(work, out, n, splits, stream);
}
