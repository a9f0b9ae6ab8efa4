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
// one-hot across row tiles. A row whose index is outside [0, N) is dropped
// (the cotangent of K4's zero row).
//
// Bound: bytes for both. Neither does arithmetic beyond the adds; the least
// time is (rows read + rows written + indices) over the 3.35 TB/s memory
// rate. A release forward's K4 calls move well under a megabyte each, so
// at B = 1 a call costs its launch, and the wrapper's host path
// (ops/gather.py) is kept to one check, one allocation and one ctypes call.
// Design of K4: a grid of (row tiles, B), so no thread divides to find its
// cloud; row arithmetic in 32 bits, 64-bit offsets only in the final
// addresses. A group of L lanes moves one row: with D % 4 == 0 and 16-byte
// aligned pointers, D/4 float4 per row and L = min(D/4, 32), so at D = 64
// two rows share a warp and at D = 768 each lane moves 6 float4; otherwise
// 4-byte words with L = min(D, 32). x is read through the read-only path.
// Indices are int32 or int64 (a template), so the wrapper never casts them.
//
// bf16 rows (r3dl_gather_rows16, under compute_dtype bfloat16): the same
// kernel moves 2-byte elements, each row as 16-byte words when its bytes
// (2 D) are a multiple of 16 and the pointers are 16-byte aligned (D = 64
// bf16 is 128 bytes, 8 words a row), else 4-byte words (D even), else
// 2-byte ones. A copy: bit-equal to its plain version.
//
// Design of K8 (scatter_rows_sum_kernel, both dtypes): destination tiles.
// The first design added each cotangent row into fp32 sums with fp32
// atomicAdd after a memset of the sums, and at bf16 a second kernel
// rounded them: three passes over the sums, a read-modify-write in L2 for
// every element, and an order of adds that changed from run to run. Here
// a block owns T <= 256 destination rows, in passes of up to 8192 sums
// (1024 16-byte pieces of g at bf16, 2048 at fp32 or where a bf16 g sums
// into fp32, read 8 bytes a lane; T is cut so that a row takes at most two
// passes where the card stays full), and writes each of their elements
// once, with no memset and no atomics on device memory:
//   1. It reads its cloud's index in chunks of 4096 entries (the step's
//      clouds have at most 4096 rows: one chunk, 16 KB a block, from L2)
//      and compacts the entries that land in its tile, in row order
//      (ballot + prefix sum); a sentinel lands in no tile, and a chunk
//      with no entry for the tile ends there.
//   2. A stable counting sort in shared memory (counts, their prefix sum,
//      one warp placing the entries 32 at a time by __match_any_sync)
//      lists each tile row's sources in increasing row order. (A path
//      that skips it where no row has two sources did not make the
//      pooled stages' owner sums faster on an H100.)
//   3. Round k adds the k-th source of every tile row: each thread owns 4
//      (pieces of 8 elements) or 8 (row, piece) items of a pass, so a
//      round's loads are independent of each other (at 4 items two
//      rounds' loads are issued together, then added in order) and the
//      sums stay in fp32 registers; a row with one source (the common
//      case: an owner of itself, a one-point cluster) is a widened copy.
//   4. The sums are written once: rounded to bf16 (to nearest even) for a
//      bf16 result, or as fp32 (the conv's owner sum, which sums on).
// Every destination adds its sources in increasing row order, from 0, in
// fp32: the result is bit-equal from launch to launch, whatever the index
// (sentinels, duplicates, unsorted). What the design relies on for speed:
// a cloud's index is short enough to scan once a tile (O(M n / T) index
// reads from L2), and a row has few sources (a round per source of the
// most-collided row of a chunk). At bf16 this is the rule of
// pallas_gather.py `_permute_op_bwd` (dx summed in fp32, cast to the
// input's dtype once).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerGroup = 2;   // rows each lane group moves per tile
constexpr int kMaxGridY = 65535;
constexpr unsigned kFull = 0xffffffffu;
// K8
constexpr int kSumThreads = 256;
constexpr int kSumWarps = kSumThreads / 32;
constexpr int kSumChunk = 4096;    // index entries compacted at a time
constexpr int kSumPer = kSumChunk / kSumThreads;
constexpr int kSumMaxRows = 256;   // destination rows a block owns, at most
constexpr int kSumTargetBlocks = 2 * 132;  // two blocks on each SM

// (row, piece) items a K8 thread sums, for pieces of E elements: 4 of 8
// elements, 8 of fewer (at most 32 fp32 sums a thread)
template <int E>
__host__ __device__ constexpr int sum_items() {
  return E >= 8 ? 4 : 8;
}

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

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// acc[0..E) += the E elements of G in the piece v
template <typename G, typename V>
__device__ __forceinline__ void add_piece(float* acc, const V& v) {
  constexpr int E = sizeof(V) / sizeof(G);
  const G* e = reinterpret_cast<const G*>(&v);
#pragma unroll
  for (int k = 0; k < E; ++k) acc[k] += widen(e[k]);
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// E sums to dst as O (fp32, or bf16 rounded to nearest even), in words of
// up to 16 bytes
template <typename O, int E>
__device__ __forceinline__ void store_piece(O* dst, const float* a) {
  if constexpr (std::is_same<O, float>::value) {
    if constexpr (E % 4 == 0) {
#pragma unroll
      for (int k = 0; k < E / 4; ++k)
        reinterpret_cast<float4*>(dst)[k] =
            make_float4(a[4 * k], a[4 * k + 1], a[4 * k + 2], a[4 * k + 3]);
    } else if constexpr (E == 2) {
      *reinterpret_cast<float2*>(dst) = make_float2(a[0], a[1]);
    } else {
      dst[0] = a[0];
    }
  } else if constexpr (E == 8) {
    static_assert(std::is_same<O, __nv_bfloat16>::value, "fp32 or bf16");
    *reinterpret_cast<uint4*>(dst) = make_uint4(
        pack2(a[0], a[1]), pack2(a[2], a[3]), pack2(a[4], a[5]),
        pack2(a[6], a[7]));
  } else if constexpr (E == 2) {
    *reinterpret_cast<unsigned*>(dst) = pack2(a[0], a[1]);
  } else {
    static_assert(E == 1, "bf16 pieces of 8, 2 or 1 elements");
    dst[0] = __float2bfloat16_rn(a[0]);
  }
}

// K8 (see the header). g (B, M, P pieces V of E = sizeof(V) / sizeof(G)
// elements), out (B, n, P E) of O. Block (x, b): rows [d0, d0 + T) of cloud
// b, T <= kSumMaxRows, in passes over PC pieces of them, T PC <=
// kSumThreads sum_items<E>().
template <typename G, typename V, typename I, typename O>
__global__ void __launch_bounds__(kSumThreads, 2)
    scatter_rows_sum_kernel(const G* __restrict__ g,
                            const I* __restrict__ idx, O* __restrict__ out,
                            int n, int M, int P, int T, int PC) {
  constexpr int E = sizeof(V) / sizeof(G);
  constexpr int kItems = sum_items<E>();
  __shared__ int lst_m[kSumChunk];            // compacted source rows
  __shared__ unsigned short lst_d[kSumChunk];  // and their tile rows
  __shared__ int srt[kSumChunk];              // sources by tile row
  __shared__ int cnt[kSumMaxRows], start[kSumMaxRows];
  __shared__ int part[kSumPer * kSumWarps];   // compaction offsets
  __shared__ int listed, rounds;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, d0 = blockIdx.x * T;
  const int rows = min(T, n - d0);
  const I* ib = idx + (long long)b * M;
  const V* gb = reinterpret_cast<const V*>(g) + (long long)b * M * P;
  const unsigned lt = (1u << lane) - 1u;

  // this thread's items of a pass: tile row it_d, piece it_p of the pass
  int it_d[kItems], it_p[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = tid + j * kSumThreads;
    it_d[j] = i / PC;
    it_p[j] = i - it_d[j] * PC;
  }

  // 1.-2. the tile rows' sources in the index entries [c0, c0 + chunk), by
  // row, in row order: srt[start[r] .. + cnt[r]), `rounds` the most;
  // listed == 0 where no entry lands in the tile
  auto list_sources = [&](int c0) {
    __syncthreads();   // the last round's reads of the lists are done
    if (tid < rows) cnt[tid] = 0;
    int my_d[kSumPer];
    unsigned bal[kSumPer];
#pragma unroll
    for (int e = 0; e < kSumPer; ++e) {
      const int m = c0 + e * kSumThreads + tid;
      const long long dl = m < M ? (long long)__ldg(ib + m) - d0 : -1LL;
      const bool in = dl >= 0 && dl < rows;
      my_d[e] = in ? (int)dl : -1;
      bal[e] = __ballot_sync(kFull, in);
      if (lane == 0) part[e * kSumWarps + warp] = __popc(bal[e]);
    }
    __syncthreads();
    if (warp == 0) {   // exclusive prefix over (entry round, warp)
      constexpr int kPer = kSumPer * kSumWarps / 32;
      int v[kPer], sum = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        v[k] = part[kPer * lane + k];
        sum += v[k];
      }
      int inc = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += u;
      }
      int run = inc - sum;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        part[kPer * lane + k] = run;
        run += v[k];
      }
      if (lane == 31) listed = inc;
    }
    __syncthreads();
    if (listed == 0) return;   // no entry of this chunk lands here
#pragma unroll
    for (int e = 0; e < kSumPer; ++e)
      if (my_d[e] >= 0) {
        const int pos = part[e * kSumWarps + warp] + __popc(bal[e] & lt);
        lst_m[pos] = c0 + e * kSumThreads + tid;
        lst_d[pos] = (unsigned short)my_d[e];
        atomicAdd(&cnt[my_d[e]], 1);
      }
    __syncthreads();
    const int L = listed;
    if (warp == 0) {
      // start = the counts' exclusive prefix sum (8 rows a lane), the
      // most sources of a row; then each entry to its place, stable
      int c[kSumMaxRows / 32], sum = 0, most = 0;
#pragma unroll
      for (int k = 0; k < kSumMaxRows / 32; ++k) {
        const int r = 8 * lane + k;
        c[k] = r < rows ? cnt[r] : 0;
        sum += c[k];
        most = max(most, c[k]);
      }
      int inc = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += u;
      }
      int run = inc - sum;
#pragma unroll
      for (int k = 0; k < kSumMaxRows / 32; ++k) {
        const int r = 8 * lane + k;
        if (r < rows) {
          start[r] = run;
          cnt[r] = run;   // reused as the next free slot of row r
        }
        run += c[k];
      }
      most = __reduce_max_sync(kFull, most);
      if (lane == 0) rounds = most;
      __syncwarp();
      for (int base = 0; base < L; base += 32) {
        const int k = base + lane;
        const int d = k < L ? (int)lst_d[k] : -1 - lane;
        const unsigned peers = __match_any_sync(kFull, d);
        const int rank = __popc(peers & lt);
        const int slot = k < L ? cnt[d] + rank : 0;
        __syncwarp();
        if (k < L) {
          srt[slot] = lst_m[k];
          if (rank == __popc(peers) - 1) cnt[d] = slot + 1;
        }
        __syncwarp();
      }
      // cnt back to the counts
#pragma unroll
      for (int k = 0; k < kSumMaxRows / 32; ++k) {
        const int r = 8 * lane + k;
        if (r < rows) cnt[r] -= start[r];
      }
    }
    __syncthreads();
  };

  // one chunk (the step's clouds): the lists serve every pass
  const bool one_chunk = M <= kSumChunk;
  if (one_chunk) list_sources(0);
  for (int p0 = 0; p0 < P; p0 += PC) {
    float acc[kItems][E];
    bool mine[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      mine[j] = it_d[j] < rows && p0 + it_p[j] < P;
#pragma unroll
      for (int k = 0; k < E; ++k) acc[j][k] = 0.f;
    }
    for (int c0 = 0; c0 < M; c0 += kSumChunk) {
      if (!one_chunk) list_sources(c0);
      if (listed == 0) continue;
      // 3. round k: the k-th source of every tile row, loads issued
      //    together
      const int R = rounds;
      int n_src[kItems], at[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        n_src[j] = mine[j] ? cnt[it_d[j]] : 0;
        at[j] = mine[j] ? start[it_d[j]] : 0;
      }
      // kRounds rounds' loads in flight (8 a thread), added in order
      constexpr int kRounds = 8 / kItems;
      for (int k = 0; k < R; k += kRounds) {
        V v[kRounds][kItems];
#pragma unroll
        for (int r = 0; r < kRounds; ++r)
#pragma unroll
          for (int j = 0; j < kItems; ++j)
            if (k + r < n_src[j])
              v[r][j] = __ldg(gb + (long long)srt[at[j] + k + r] * P + p0 +
                              it_p[j]);
#pragma unroll
        for (int r = 0; r < kRounds; ++r)
#pragma unroll
          for (int j = 0; j < kItems; ++j)
            if (k + r < n_src[j]) add_piece<G>(acc[j], v[r][j]);
      }
    }
    // 4. the pass's sums written once
    O* ob = out + ((long long)b * n + d0) * P * E + (long long)p0 * E;
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (mine[j])
        store_piece<O, E>(ob + ((long long)it_d[j] * P + it_p[j]) * E,
                          acc[j]);
  }
}

template <typename G, typename V, typename O, typename I>
int launch_sum(const G* g, const I* idx, O* out, int B, int n, int M, int D,
               cudaStream_t stream) {
  constexpr int E = sizeof(V) / sizeof(G);
  constexpr int kPieces = kSumThreads * sum_items<E>();
  const int P = D / E;
  // tiles as long as two passes over the row allow (the index is scanned
  // once a tile; each pass repeats the rounds), at most kSumMaxRows rows,
  // shorter where the clouds' tiles would leave SMs idle; passes of PC
  // pieces
  int T = kSumMaxRows;
  while (T > 16 && ((long long)T * P > 2LL * kPieces ||
                    (long long)B * ((n + T - 1) / T) < kSumTargetBlocks))
    T /= 2;
  const int PC = P < kPieces / T ? P : kPieces / T;
  const int tiles = (n + T - 1) / T;
  scatter_rows_sum_kernel<G, V, I, O>
      <<<dim3(tiles, B), kSumThreads, 0, stream>>>(g, idx, out, n, M, P, T,
                                                   PC);
  return (int)cudaGetLastError();
}

// K8 on any dtype pair: the widest piece the row bytes and the pointers'
// alignment allow (16 bytes of g; 4-byte pairs; single elements)
template <typename G, typename O>
int scatter_sum(const G* g, const void* idx, O* out, int B, int n, int M,
                int D, int idx64, cudaStream_t stream) {
  if (B == 0 || n == 0 || D == 0) return (int)cudaGetLastError();
  if (B > kMaxGridY) return (int)cudaErrorInvalidValue;
  // 16 bytes of g a piece; 8 bytes of a bf16 g whose sums are fp32, so
  // that a lane stores its 4 sums as one 16-byte word, next to its
  // neighbour's
  constexpr bool kHalf = sizeof(G) == 2 && std::is_same<O, float>::value;
  constexpr int E16 = (kHalf ? 8 : 16) / sizeof(G);
  const uintptr_t a = (uintptr_t)g | (uintptr_t)out;
  const bool w16 = D % E16 == 0 && a % 16 == 0;
  const bool w2 = sizeof(G) == 2 && D % 2 == 0 && a % 8 == 0;
  using V16 = typename std::conditional<
      sizeof(G) == 2, typename std::conditional<kHalf, uint2, uint4>::type,
      float4>::type;
  using V1 = typename std::conditional<sizeof(G) == 2, unsigned short,
                                       float>::type;
#define R3DL_SUM(V, I)                                                      \
  launch_sum<G, V, O, I>(g, static_cast<const I*>(idx), out, B, n, M, D, \
                         stream)
  if (idx64)
    return w16 ? R3DL_SUM(V16, long long)
               : w2 ? R3DL_SUM(unsigned, long long) : R3DL_SUM(V1, long long);
  return w16 ? R3DL_SUM(V16, int)
             : w2 ? R3DL_SUM(unsigned, int) : R3DL_SUM(V1, int);
#undef R3DL_SUM
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

// dx: (B, N, D), every element written; g: (B, M, D); idx: (B, M) int32 or
// int64, rows outside [0, N) dropped
extern "C" int r3dl_scatter_rows_add(const float* g, const void* idx,
                                     float* dx, int B, int N, int M, int D,
                                     int idx64, cudaStream_t stream) {
  return scatter_sum<float, float>(g, idx, dx, B, N, M, D, idx64, stream);
}

// The same for a bf16 cotangent g (B, M, D): out (B, N, D) the fp32 sums
// rounded to bf16 once, or, with out_f32, the fp32 sums themselves.
extern "C" int r3dl_scatter_rows_add_bf16(const __nv_bfloat16* g,
                                          const void* idx, void* out,
                                          int out_f32, int B, int N, int M,
                                          int D, int idx64,
                                          cudaStream_t stream) {
  if (out_f32)
    return scatter_sum<__nv_bfloat16, float>(
        g, idx, static_cast<float*>(out), B, N, M, D, idx64, stream);
  return scatter_sum<__nv_bfloat16, __nv_bfloat16>(
      g, idx, static_cast<__nv_bfloat16*>(out), B, N, M, D, idx64, stream);
}
