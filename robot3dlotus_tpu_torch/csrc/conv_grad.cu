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
// Bound: operations, 2 Cin Cout flops per live link (ok true) against
// Cin + Cout floats per row. The products run on the tensor cores as
// 3xTF32 mma.sync.m16n8k8 (tc_common.cuh): 3 TF32 products per fp32 one.
//
// Design, the CPE path (Cin and Cout multiples of 4): dW[k] = A_k^T g
// with A_k the gathered rows of tap k, a reduction over the live links of
// that tap only. The rows are split into `splits` fixed ranges.
//   1. wgrad_compact_kernel, one block per (tap, row range): a warp ballot
//      and a prefix sum over the block write the range's live rows, in
//      ascending order, as (row, source row) pairs into scratch, and their
//      count. Dead links cost one byte read here and nothing after.
//   2. wgrad_tc_kernel, one block of 4 warps per (64 input channels x 64
//      output channels, tap, row range): walks the range's live list in
//      stages of 64 rows. Each stage gathers x[source] and g[row] of those
//      rows with 16-byte cp.async (zero-fill past the list's end) into a
//      ring of 2 stages, their indices read into shared memory a stage
//      earlier, so that loads stay in flight while a stage multiplies; each
//      warp accumulates a 32 x 32 tile of dW, 8 rows per mma step (the
//      mma's k dimension runs over rows), in registers that start from
//      zero every stage and are added to the fp32 totals.
//   3. With more than one range each block writes its partial tile to
//      scratch and sum_splits_kernel adds the ranges in a fixed order.
// No float atomics: the sum order is fixed and the result bit-equal from
// run to run. The split count makes (tiles x taps x ranges) fill the card.
//
// The stem path (Cin = 7 is not a 16-byte multiple, and 7 of 64 tile
// columns would waste the rest): dW is viewed as a (K * Cin, Cout) matrix,
// A[r, a] = ok[r, k] x[b, idx[r, k], c] with a = k * Cin + c, so the stem's
// 125 x 7 (tap, channel) columns pack 64 to a tile. wgrad_taps_kernel
// stages 32 rows at a time with scalar loads (zeros where !ok), skips a
// stage in which no row has a live link in the tile's columns, and runs the
// same 3xTF32 warp tiles. Dead links inside a live stage are multiplied.
//
// bf16 (r3dl_conv_weight_grad_bf16, training under compute_dtype
// bfloat16): x and g bf16, dW fp32 sums, the JAX kernel's own arithmetic
// at bf16 (single-pass products with fp32 sums, pallas_conv.py `_dw_kernel`;
// the caller rounds each tap's sum to bf16 once, as the Pallas VJP's
// `dW.astype(weight.dtype)` does). Both operands are bf16 values, so one
// bf16 mma.sync.m16n8k16 with fp32 sums is exact per product: both paths
// keep bf16 rows in shared memory at the 144-byte stride (8-row ldmatrix
// conflict-free) and load the fragments with ldmatrix .x4.trans (the mma's
// k dimension runs over rows, so A = X^T and B = G are both read
// transposed), 16 rows a step. Nothing is widened before its product:
// against the earlier bf16 design (rows widened scalar by scalar as each
// fragment was read, one TF32 m16n8k8 per 8 rows) that is half the mma
// instructions, 4 ldmatrix a step in place of 32 scalar loads and
// conversions. The CPE path (channel counts multiples of 8, the 16-byte
// cp.async pieces; ops/conv.py pads the Concat stem's 263 inputs to 264)
// keeps the live lists, the fixed row ranges and sum_splits_kernel, and
// stages 128 listed rows a stage (the fp32 stage's bytes; few, full
// stages, 2 in flight): a list's last step multiplies the zero rows that
// cp.async filled past its end. Each stage's sums (8 mma a chain) are
// added to the fp32 totals in registers, as the fp32 path does, in the
// same fixed order: bit-equal from run to run. The stem path (125 x 7
// (tap, channel) columns) runs the same step on bf16 rows in
// wgrad_taps16_kernel (below), whose staging reads each (row, tap) map
// entry once and issues a stage's loads together.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"

namespace {

using r3dl::Split;
using r3dl::split;

using r3dl::bf16;

constexpr int kT = 64;         // dW tile: 64 input x 64 output channels
constexpr int kStages = 2;     // pipeline stages in flight
constexpr int kRK = 32;        // cloud rows per stage (stem path)
constexpr int kS = kT + 8;     // shared row stride: fp32 8 mod 32, so the
                               // fragment loads (row c, col r) hit 32
                               // banks; bf16 144 bytes, an odd multiple of
                               // 16, so ldmatrix's 8 rows do
constexpr int kThreads = 128;  // 4 warps, a 32 x 32 dW tile each
constexpr int kCompactThreads = 256;
// live rows per pipeline stage (CPE path): 64 fp32 rows; 128 bf16 rows,
// the same bytes
template <typename T>
__host__ __device__ constexpr int rows_per_stage() {
  return std::is_same<T, float>::value ? 64 : 128;
}
// the ring of x and g rows (T: fp32 or bf16, rows of kS elements), and of
// their indices: 74,752 B (fp32) and 75,776 B (bf16) at 2 stages, three
// blocks an SM
template <typename T>
constexpr size_t tc_smem() {
  return kStages * rows_per_stage<T>() *
         (2 * kS * sizeof(T) + 2 * sizeof(int));
}

// One step of a warp's 32 x 32 tile: A = X^T (rows of xr are cloud rows,
// columns channels), B = G; xr / gr point at the step's first row.
// fp32 rows: 8 rows, 3xTF32 m16n8k8 on split fragments.
__device__ __forceinline__ void step(float (&acc)[2][4][4], const float* xr,
                                     const float* gr, int cm, int on,
                                     int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  const float* x0 = xr + tig * kS;
  const float* x4 = x0 + 4 * kS;
  const float* g0 = gr + tig * kS;
  const float* g4 = g0 + 4 * kS;
  Split a[2][4], b[4][2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int c = cm + 16 * m + gid;
    a[m][0] = split(x0[c]);
    a[m][1] = split(x0[c + 8]);
    a[m][2] = split(x4[c]);
    a[m][3] = split(x4[c + 8]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = on + 8 * j + gid;
    b[j][0] = split(g0[o]);
    b[j][1] = split(g4[o]);
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) r3dl::mma3(acc[m][j], a[m], b[j]);
}

// bf16 rows: 16 rows, one bf16 m16n8k16 per 16 x 8 tile, exact products
// in fp32 sums. The mma's k dimension runs over rows, so both operands
// are read transposed by ldmatrix .trans: A matrix i holds rows 8 (i / 2)..
// of channels cm + 16 m + 8 (i % 2).. (a0..a3 of the 16 x 16 A), B matrix
// i rows 8 (i % 2).. of outputs on + 16 jj + 8 (i / 2).. (b0, b1 of tile
// 2 jj, then of 2 jj + 1).
__device__ __forceinline__ void step(float (&acc)[2][4][4], const bf16* xr,
                                     const bf16* gr, int cm, int on,
                                     int lane) {
  const int lm = lane >> 3, lr = lane & 7;
  uint32_t a[2][4], b[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
    r3dl::ldmatrix_x4_trans(
        a[m], xr + (8 * (lm >> 1) + lr) * kS + cm + 16 * m + 8 * (lm & 1));
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
    r3dl::ldmatrix_x4_trans(
        b[jj], gr + (8 * (lm & 1) + lr) * kS + on + 16 * jj + 8 * (lm >> 1));
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r3dl::mma_bf16(acc[m][j], a[m], b[j / 2][2 * (j % 2)],
                     b[j / 2][2 * (j % 2) + 1]);
}

// rows a step of T's products takes
template <typename T>
__host__ __device__ constexpr int step_rows() {
  return std::is_same<T, float>::value ? 8 : 16;
}

__device__ __forceinline__ void zero(float (&t)[2][4][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[m][j][e] = 0.f;
}

// acc += part, rounded to nearest: the tensor cores' own fp32 sums are
// kept to one stage (at most 24 products a chain), since over the
// thousands of rows of a range their rounding drifts past 1e-4
__device__ __forceinline__ void add(float (&acc)[2][4][4],
                                   const float (&part)[2][4][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] += part[m][j][e];
}

// the warp tile (rows a0 + cm.., columns o0 + on..) into dst (A, Cout)
__device__ __forceinline__ void store_tile(const float (&acc)[2][4][4],
                                           float* dst, int a_base, int A,
                                           int o_base, int Cout, int gid,
                                           int tig) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o_base + 8 * j + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = a_base + 16 * m + gid + 8 * h;
        if (a >= A) continue;
        float* p = dst + (long long)a * Cout + o;
        if (o < Cout) p[0] = acc[m][j][2 * h];
        if (o + 1 < Cout) p[1] = acc[m][j][2 * h + 1];
      }
    }
}

__global__ void __launch_bounds__(kCompactThreads)
wgrad_compact_kernel(const int* __restrict__ idx,
                     const unsigned char* __restrict__ ok,
                     int* __restrict__ rows, int* __restrict__ srcs,
                     int* __restrict__ counts, int N, int K, long long R,
                     long long per, int splits) {
  constexpr int kWarps = kCompactThreads / 32;
  __shared__ int wsum[kWarps];
  const int k = blockIdx.y, s = blockIdx.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long r0 = (long long)s * per;
  const long long r1 = r0 + per < R ? r0 + per : R;
  const long long base = (long long)k * R + r0;
  int count = 0;
  for (long long c = r0; c < r1; c += kCompactThreads) {
    const long long r = c + threadIdx.x;
    const bool live = r < r1 && ok[r * K + k];
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (lane == 0) wsum[w] = __popc(m);
    __syncthreads();
    int off = count, total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int v = wsum[i];
      off += i < w ? v : 0;
      total += v;
    }
    if (live) {
      const int j = off + __popc(m & ((1u << lane) - 1u));
      rows[base + j] = (int)r;
      srcs[base + j] = (int)r / N * N + idx[r * K + k];
    }
    count += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) counts[k * splits + s] = count;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_tc_kernel(const T* __restrict__ x, const T* __restrict__ g,
                const int* __restrict__ rows, const int* __restrict__ srcs,
                const int* __restrict__ counts, float* __restrict__ out,
                int K, int Cin, int Cout, long long R, long long per,
                int splits, int ctiles) {
  constexpr int V = 16 / sizeof(T);              // channels in 16 bytes
  constexpr int kRB = rows_per_stage<T>();
  constexpr int kSR = step_rows<T>();
  extern __shared__ float4 smem4[];
  T* xs = reinterpret_cast<T*>(smem4);           // [kStages][kRB][kS]
  T* gs = xs + kStages * kRB * kS;               // [kStages][kRB][kS]
  int* sidx = reinterpret_cast<int*>(gs + kStages * kRB * kS);
  int* srow = sidx + kStages * kRB;              // [kStages][kRB] each
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int c0 = (blockIdx.x % ctiles) * kT, o0 = (blockIdx.x / ctiles) * kT;
  const int k = blockIdx.y, s = blockIdx.z;
  const int cm = 32 * (w & 1), on = 32 * (w >> 1);
  const long long base = (long long)k * R + (long long)s * per;
  const int n = counts[k * splits + s];
  const int stages = (n + kRB - 1) / kRB;

  float acc[2][4][4];
  zero(acc);

  // the list entries of stage st: thread t < kRB reads entry st kRB + t
  static_assert(kRB <= kThreads, "one list entry a thread");
  auto fetch = [&](int st, int& src, int& row) {
    const int entry = st * kRB + tid;
    src = -1;
    row = 0;
    if (tid < kRB && st < stages && entry < n) {
      src = srcs[base + entry];
      row = rows[base + entry];
    }
  };
  // stage st's rows into its ring slot: x[source] (channels c0..c0+63)
  // and g[row] (outputs o0..o0+63), 16 bytes (V channels) per cp.async,
  // the indices from shared memory (fetched a stage ahead)
  auto load = [&](int st) {
    const int buf = st % kStages;
    T* xb = xs + buf * kRB * kS;
    T* gb = gs + buf * kRB * kS;
    const int* si = sidx + buf * kRB;
    const int* sr = srow + buf * kRB;
#pragma unroll 4
    for (int e = tid; e < 2 * kRB * (kT / V); e += kThreads) {
      const int which = e / (kRB * (kT / V));
      const int j = (e / (kT / V)) % kRB, q = e % (kT / V);
      const int src = si[j];
      if (which == 0) {
        const int col = c0 + V * q;
        const bool p = src >= 0 && col < Cin;
        r3dl::cp_async16(xb + j * kS + V * q,
                         p ? x + (long long)src * Cin + col : x, p);
      } else {
        const int col = o0 + V * q;
        const bool p = src >= 0 && col < Cout;
        r3dl::cp_async16(gb + j * kS + V * q,
                         p ? g + (long long)sr[j] * Cout + col : g, p);
      }
    }
  };

  // prologue: the indices of the first kStages stages, the data of the
  // first kStages - 1
  for (int st = 0; st < kStages; ++st) {
    int src, row;
    fetch(st, src, row);
    if (tid < kRB) {
      sidx[st * kRB + tid] = src;
      srow[st * kRB + tid] = row;
    }
  }
  __syncthreads();
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < stages) load(st);
    r3dl::cp_async_commit();
  }
  for (int st = 0; st < stages; ++st) {
    if (st + kStages - 1 < stages) load(st + kStages - 1);
    r3dl::cp_async_commit();
    int src, row;                 // the indices of stage st + kStages,
    fetch(st + kStages, src, row);   // in flight while this one computes
    r3dl::cp_async_wait<kStages - 1>();
    __syncthreads();
    const int buf = st % kStages;
    const T* xb = xs + buf * kRB * kS;
    const T* gb = gs + buf * kRB * kS;
    const int live = n - st * kRB < kRB ? n - st * kRB : kRB;
    float part[2][4][4];
    zero(part);
    // bf16: 16-row steps; the rows past the list's end are zero-filled
    for (int r = 0; r < live; r += kSR)
      step(part, xb + r * kS, gb + r * kS, cm, on, lane);
    add(acc, part);
    if (tid < kRB) {              // slot buf: stage st's indices, done
      sidx[buf * kRB + tid] = src;
      srow[buf * kRB + tid] = row;
    }
    __syncthreads();
  }
  store_tile(acc, out + ((long long)s * K + k) * Cin * Cout, c0 + cm, Cin,
             o0 + on, Cout, gid, tig);
}

__global__ void __launch_bounds__(kThreads)
wgrad_taps_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                  const unsigned char* __restrict__ ok,
                  const float* __restrict__ g, float* __restrict__ out,
                  int N, int K, int Cin, int Cout, long long R,
                  long long per) {
  __shared__ float as[kRK * kS];
  __shared__ float gsm[kRK * kS];
  __shared__ int colk[kT], colc[kT], rbase[kRK];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int a0 = blockIdx.x * kT, o0 = blockIdx.y * kT;
  const int cm = 32 * (w & 1), on = 32 * (w >> 1);
  const int KC = K * Cin;
  const long long r_begin = (long long)blockIdx.z * per;
  const long long r_end = r_begin + per < R ? r_begin + per : R;
  if (tid < kT) {                  // the tile's (tap, channel) columns
    const int a = a0 + tid;
    colk[tid] = a < KC ? a / Cin : -1;
    colc[tid] = a < KC ? a % Cin : 0;
  }

  float acc[2][4][4];
  zero(acc);

  for (long long r0 = r_begin; r0 < r_end; r0 += kRK) {
    if (tid < kRK) {               // each row's first row of its cloud
      const long long r = r0 + tid;
      rbase[tid] = r < r_end ? (int)r / N * N : -1;
    }
    __syncthreads();
    int live = 0;
    for (int e = tid; e < kRK * kT; e += kThreads) {
      const int rr = e / kT, aa = e % kT;
      const int k = colk[aa], rb = rbase[rr];
      float val = 0.f;
      if (rb >= 0 && k >= 0) {
        const long long off = (r0 + rr) * K + k;
        if (ok[off]) {
          val = x[((long long)rb + idx[off]) * Cin + colc[aa]];
          live = 1;
        }
      }
      as[rr * kS + aa] = val;
    }
    for (int e = tid; e < kRK * kT; e += kThreads) {
      const int rr = e / kT, cc = e % kT;
      const long long r = r0 + rr;
      const int co = o0 + cc;
      gsm[rr * kS + cc] = (r < r_end && co < Cout) ? g[r * Cout + co] : 0.f;
    }
    if (__syncthreads_or(live)) {
      float part[2][4][4];
      zero(part);
#pragma unroll
      for (int r = 0; r < kRK; r += 8)
        step(part, as + r * kS, gsm + r * kS, cm, on, lane);
      add(acc, part);
    }
    __syncthreads();
  }
  store_tile(acc, out + (long long)blockIdx.z * KC * Cout, a0 + cm, KC,
             o0 + on, Cout, gid, tig);
}

// The stem path at bf16 (the header): the same tile of 64 (tap, channel)
// columns and the same step; a stage is 64 rows, staged in three passes
// whose loads are independent of each other within a pass (the fp32
// kernel's staging chains ok -> idx -> x load by load, element by element,
// and took nearly all of its time): the ok and idx entries of the stage's
// rows and the tile's taps, each read once into shared memory (the fp32
// staging reads them once per channel); the g rows, 16 bytes a load; then
// the x values, kPer independent loads a thread.
constexpr int kRK16 = 64;      // cloud rows per stage (stem path, bf16)

__global__ void __launch_bounds__(kThreads)
wgrad_taps16_kernel(const bf16* __restrict__ x, const int* __restrict__ idx,
                    const unsigned char* __restrict__ ok,
                    const bf16* __restrict__ g, float* __restrict__ out,
                    int N, int K, int Cin, int Cout, long long R,
                    long long per) {
  constexpr int kPer = kRK16 * kT / kThreads;   // x values a thread a stage
  __shared__ __align__(16) bf16 as[kRK16 * kS];
  __shared__ __align__(16) bf16 gsm[kRK16 * kS];
  __shared__ int ssrc[kRK16 * kT];   // (row, tap): the source row, or -1
  __shared__ int colk[kT], colc[kT];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int a0 = blockIdx.x * kT, o0 = blockIdx.y * kT;
  const int cm = 32 * (w & 1), on = 32 * (w >> 1);
  const int KC = K * Cin;
  // the tile's taps kb .. kb + ntaps - 1
  const int kb = a0 / Cin;
  const int ntaps = (min(a0 + kT, KC) - 1) / Cin - kb + 1;
  const int r_begin = (int)(blockIdx.z * per);
  const int r_end = (int)min((long long)r_begin + per, R);
  if (tid < kT) {                  // the tile's (tap, channel) columns
    const int a = a0 + tid;
    colk[tid] = a < KC ? a / Cin - kb : -1;
    colc[tid] = a < KC ? a % Cin : 0;
  }
  __syncthreads();
  // this thread's column and its rows tid / kT + i kThreads / kT
  const int aa = tid % kT, kt = colk[aa], cc = colc[aa];

  float acc[2][4][4];
  zero(acc);

  for (int r0 = r_begin; r0 < r_end; r0 += kRK16) {
    int live = 0;
#pragma unroll 4
    for (int e = tid; e < kRK16 * ntaps; e += kThreads) {
      const int rr = e / ntaps, t = e - rr * ntaps;
      const int r = r0 + rr;
      int src = -1;
      if (r < r_end) {
        const long long off = (long long)r * K + kb + t;
        const unsigned char o = ok[off];
        const int i = idx[off];
        src = o ? r / N * N + i : -1;
        live |= o;
      }
      ssrc[rr * ntaps + t] = src;
    }
    for (int e = tid; e < kRK16 * (kT / 8); e += kThreads) {
      const int rr = e / (kT / 8), q = e % (kT / 8);
      const int r = r0 + rr, co = o0 + 8 * q;
      bf16* dst = gsm + rr * kS + 8 * q;
      if (Cout % 8 == 0) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < r_end && co < Cout)
          v = *reinterpret_cast<const uint4*>(g + (long long)r * Cout + co);
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = r < r_end && co + j < Cout
                       ? g[(long long)r * Cout + co + j]
                       : r3dl::narrow<bf16>(0.f);
      }
    }
    if (!__syncthreads_or(live)) continue;   // no live link in the tile
    bf16 v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int rr = tid / kT + i * (kThreads / kT);
      const int src = kt >= 0 ? ssrc[rr * ntaps + kt] : -1;
      v[i] = src >= 0 ? x[(long long)src * Cin + cc]
                      : r3dl::narrow<bf16>(0.f);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      as[(tid / kT + i * (kThreads / kT)) * kS + aa] = v[i];
    __syncthreads();
    float part[2][4][4];
    zero(part);
#pragma unroll
    for (int r = 0; r < kRK16; r += 16)
      step(part, as + r * kS, gsm + r * kS, cm, on, lane);
    add(acc, part);
    __syncthreads();
  }
  store_tile(acc, out + (long long)blockIdx.z * KC * Cout, a0 + cm, KC,
             o0 + on, Cout, gid, tig);
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

template <typename T>
int weight_grad(const T* x, const int* idx, const unsigned char* ok,
                const T* g, void* work, float* dw, int B, int N, int K,
                int Cin, int Cout, int splits, long long rows_per_split,
                long long work_bytes, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);   // channels in 16 bytes
  const long long R = (long long)B * N;
  const long long n = (long long)K * Cin * Cout;
  if (n == 0) return (int)cudaGetLastError();
  const bool compacted = Cin % V == 0 && Cout % V == 0;
  const long long list_bytes =
      compacted ? ((4 * (2 * K * R + (long long)K * splits) + 15) / 16) * 16
                : 0;
  const long long part_bytes = splits > 1 ? 4 * splits * n : 0;
  if (R >= (1LL << 31) || splits < 1 || rows_per_split < 1 ||
      (long long)splits * rows_per_split < R ||
      list_bytes + part_bytes > work_bytes ||
      (list_bytes + part_bytes > 0 && !work) ||
      (compacted && (((uintptr_t)x | (uintptr_t)g) & 15)) ||
      (!compacted && sizeof(T) == 2 && Cout % 8 == 0 &&
       ((uintptr_t)g & 15)))
    return (int)cudaErrorInvalidValue;
  float* part = splits > 1
                    ? reinterpret_cast<float*>(static_cast<char*>(work) +
                                               list_bytes)
                    : dw;
  if (compacted) {
    static const cudaError_t attr =
        r3dl::allow_smem(wgrad_tc_kernel<T>, tc_smem<T>());
    if (attr != cudaSuccess) return (int)attr;
    int* rows = static_cast<int*>(work);
    int* srcs = rows + K * R;
    int* counts = srcs + K * R;
    wgrad_compact_kernel<<<dim3((unsigned)splits, (unsigned)K),
                           kCompactThreads, 0, stream>>>(
        idx, ok, rows, srcs, counts, N, K, R, rows_per_split, splits);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int ctiles = (Cin + kT - 1) / kT, otiles = (Cout + kT - 1) / kT;
    wgrad_tc_kernel<T><<<dim3((unsigned)(ctiles * otiles), (unsigned)K,
                              (unsigned)splits),
                         kThreads, tc_smem<T>(), stream>>>(
        x, g, rows, srcs, counts, part, K, Cin, Cout, R, rows_per_split,
        splits, ctiles);
  } else {
    const dim3 grid((unsigned)((K * Cin + kT - 1) / kT),
                    (unsigned)((Cout + kT - 1) / kT), (unsigned)splits);
    if constexpr (std::is_same<T, float>::value)
      wgrad_taps_kernel<<<grid, kThreads, 0, stream>>>(
          x, idx, ok, g, part, N, K, Cin, Cout, R, rows_per_split);
    else
      wgrad_taps16_kernel<<<grid, kThreads, 0, stream>>>(
          x, idx, ok, g, part, N, K, Cin, Cout, R, rows_per_split);
  }
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (n + 255) / 256;
    sum_splits_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                        stream>>>(part, dw, n, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// work: scratch of work_bytes bytes. The CPE path (Cin % 4 == 0 and
// Cout % 4 == 0) puts there the live lists, 2 K B N + K splits int32
// (rounded up to 16 bytes), then, with splits > 1, the partial dW
// (splits, K, Cin, Cout) fp32; the stem path only the partial dW.
// x and g 16-byte aligned on the CPE path (g also on the bf16 stem path
// where Cout % 8 == 0). rows_per_split * splits >= B N.
extern "C" int r3dl_conv_weight_grad(const float* x, const int* idx,
                                     const unsigned char* ok, const float* g,
                                     void* work, float* dw, int B, int N,
                                     int K, int Cin, int Cout, int splits,
                                     long long rows_per_split,
                                     long long work_bytes,
                                     cudaStream_t stream) {
  return weight_grad<float>(x, idx, ok, g, work, dw, B, N, K, Cin, Cout,
                            splits, rows_per_split, work_bytes, stream);
}

// The same with bf16 x and g (dW fp32); the CPE path where Cin % 8 == 0
// and Cout % 8 == 0.
extern "C" int r3dl_conv_weight_grad_bf16(const r3dl::bf16* x,
                                          const int* idx,
                                          const unsigned char* ok,
                                          const r3dl::bf16* g, void* work,
                                          float* dw, int B, int N, int K,
                                          int Cin, int Cout, int splits,
                                          long long rows_per_split,
                                          long long work_bytes,
                                          cudaStream_t stream) {
  return weight_grad<r3dl::bf16>(x, idx, ok, g, work, dw, B, N, K, Cin, Cout,
                                 splits, rows_per_split, work_bytes, stream);
}
