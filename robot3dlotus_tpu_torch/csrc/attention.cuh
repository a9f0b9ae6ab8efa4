// K1: serialized patch attention, forward (inference)
//   out[g, h] = softmax(where(key_valid[g], (q[g, h] * scale) k[g, h]^T,
//                             -1e9)) v[g, h]
// q, k, v, out: (G, H, P <= 128, Dh in {8, 16, 24, 32}) fp32, k and v
// 16-byte aligned; key_valid: (G, P) bool (1 byte each).
//
// Replaces robot3dlotus_tpu/ops/pallas_attention.py `patch_attention`
// (_forward / _attn_kernel), where one grid step held one (patch, head)
// tile in VMEM and ran both products on the MXU.
//
// Bound: 4 P^2 Dh flops per (g, h) against 16 P Dh bytes of q/k/v/out.
// The products run on the tensor cores as 3xTF32 (3 TF32 products for
// each fp32 one, 494.7 TFLOP/s), where the bytes bound a release call.
// At B = 1 a call holds only G H = 64-72 patches: one block per patch, as
// the first SIMT design had, leaves half the 132 SMs idle and is
// latency-bound.
//
// Design: each (g, h) patch's query rows are split over `splits` blocks
// of `warps` warps (ops/attention.py attention_query_split picks them so
// that a B = 1 call launches two blocks or more per SM). Block s stages
// the patch's K and V rows (32 KB at Dh = 32) in shared memory with
// 16-byte cp.async (each lane prefetching its two q rows into L1 as they
// land), and its warp w runs attention_tile.cuh's attend_rows,
// the tile K5 runs, on query rows 16 (warps s + w) .. + 15: S for all P
// keys in registers on the tensor cores, one max/exp/sum pass, then the
// exps times v. Each block writes only its own rows: no reduction, no
// atomics, the result bit-equal from launch to launch.
//
// bf16 (r3dl_patch_attention_bf16, under compute_dtype bfloat16): q, k,
// v and out bf16, the JAX package's XLA semantics at that dtype. The block
// stages its patch's k and v rows as they are (bf16, 16-byte cp.async,
// attention_tile.cuh stage_rows16: 20 KB at Dh = 32, P rounded up to 16
// rows) and its warps run attend_rows16, the tile K5 runs at bf16: both
// products on the bf16 tensor cores (mma.sync.m16n8k16 with ldmatrix
// fragments), a quarter of the mma instructions of the fp32 tile and half
// the bytes of the fp32 call.
//
// Options (attention_opts.cuh, ops/attention.py head_scale and rpe): the
// kernel's Opts (attention_opts.cuh InlineOpts) scales each head's fp32
// products and, on the inline plan, adds the relative position bias
// looked up from the patch's grid coordinates and the head's table
// column, which each block stages in shared memory after its k and v
// rows (attention_opts.cuh has the bias-warp plan's kernel); the release
// entry points (attention.cu) instantiate NoOpts.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"

namespace {

using r3dl::kMaxP;
using r3dl::Layout;
using r3dl::OptArgs;

constexpr int kMaxWarps = kMaxP / 16;
constexpr int kMaxThreads = 32 * kMaxWarps;

// k and v rows: fp32 at Layout's stride, P rounded up to 8; bf16 at
// Layout16's, P rounded up to 16
template <int Dh, typename T>
__host__ __device__ size_t smem_bytes(int P) {
  if constexpr (std::is_same<T, float>::value)
    return 2 * (size_t)((P + 7) & ~7) * Layout<Dh>::S * sizeof(float);
  else
    return 2 * (size_t)((P + 15) & ~15) * r3dl::Layout16<Dh>::S * sizeof(T);
}

template <int Dh, typename T, class Opts>
__global__ void __launch_bounds__(kMaxThreads, 2)
patch_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const unsigned char* __restrict__ kv,
                       T* __restrict__ out, int H, int P, int splits,
                       float scale, OptArgs oa) {
  extern __shared__ float4 smem4[];
  __shared__ unsigned char smask[kMaxP];

  const long long gh = blockIdx.x / splits;
  const int s = blockIdx.x % splits;
  const long long base = gh * P * Dh;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  // the patch's k and v rows; rows P..P8-1 (P16-1 at bf16) zero-filled
  const int P8 = (P + 7) & ~7, P16 = (P + 15) & ~15;
  float* sk = reinterpret_cast<float*>(smem4);
  float* sv = sk + P8 * Layout<Dh>::S;
  r3dl::bf16* sk16 = reinterpret_cast<r3dl::bf16*>(smem4);
  r3dl::bf16* sv16 = sk16 + P16 * r3dl::Layout16<Dh>::S;
  if constexpr (std::is_same<T, float>::value) {
    constexpr int S = Layout<Dh>::S;
    constexpr int Q = Dh / 4;              // 16-byte pieces of a row
    for (int i = tid; i < P8 * Q; i += nthreads) {
      const int r = i / Q, c = (i - r * Q) * 4;
      const bool in = r < P;
      const long long off = base + (long long)r * Dh + c;
      r3dl::cp_async16(sk + r * S + c, in ? k + off : k, in);
      r3dl::cp_async16(sv + r * S + c, in ? v + off : v, in);
    }
  } else {
    r3dl::stage_rows16<Dh>(sk16, k + base, P, P16, tid, nthreads);
    r3dl::stage_rows16<Dh>(sv16, v + base, P, P16, tid, nthreads);
  }
  r3dl::cp_async_commit();
  for (int j = tid; j < P; j += nthreads) smask[j] = kv[gh / H * P + j];
  // this lane's two q rows into L1 while k and v land
  const int row0 = (s * (nthreads >> 5) + (tid >> 5)) * 16;
  const int lane = tid & 31;
  const int qc = min(8 * (lane & 3), Dh - 1);
  for (int r = row0 + (lane >> 2); r < min(P, row0 + 16); r += 8)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(q + base + r * Dh + qc));
  Opts opt;
  if constexpr (Opts::kAny)   // the options' shared memory after k and v
    opt.stage(oa, gh / H, (int)(gh % H), H, P, tid, nthreads,
              reinterpret_cast<char*>(smem4) + smem_bytes<Dh, T>(P));
  r3dl::cp_async_wait<0>();
  __syncthreads();

  if (row0 >= P) return;
  if constexpr (std::is_same<T, float>::value)
    r3dl::attend_rows<Dh, false>(q + base, out + base, nullptr, sk, sv,
                                 smask, nullptr, 0, row0, P, scale, 1.f,
                                 opt);
  else
    r3dl::attend_rows16<Dh, false>(q + base, out + base, nullptr, sk16,
                                   sv16, smask, nullptr, 0, row0, P, scale,
                                   1.f, opt);
}

template <int Dh, typename T, class Opts>
int launch(const T* q, const T* k, const T* v, const unsigned char* kv,
           T* out, int G, int H, int P, int warps, int splits, float scale,
           const OptArgs& oa, cudaStream_t stream) {
  static const cudaError_t attr = r3dl::allow_smem(
      patch_attention_kernel<Dh, T, Opts>,
      smem_bytes<Dh, T>(kMaxP) + Opts::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  patch_attention_kernel<Dh, T, Opts>
      <<<(unsigned)((long long)G * H * splits), 32 * warps,
         smem_bytes<Dh, T>(P) + Opts::kSmem, stream>>>(
          q, k, v, kv, out, H, P, splits, scale, oa);
  return (int)cudaGetLastError();
}

// K1 with the options of oa (Opts) at head dim Dh
template <typename T, class Opts>
int attention(const T* q, const T* k, const T* v, const unsigned char* kv,
              T* out, int G, int H, int P, int Dh, int warps, int splits,
              float scale, const OptArgs& oa, cudaStream_t stream) {
  if (P < 1 || P > kMaxP || warps < 1 || warps > kMaxWarps || splits < 1 ||
      16 * warps * splits < P ||
      (long long)G * H * splits > 0x7fffffffLL ||
      (((uintptr_t)k | (uintptr_t)v) & 15) || ((uintptr_t)q & 3) ||
      (Opts::kRpe && (oa.b < 0 || oa.b > r3dl::kMaxPosBound)))
    return (int)cudaErrorInvalidValue;
  if ((long long)G * H == 0) return (int)cudaGetLastError();
  switch (Dh) {
    case 8: return launch<8, T, Opts>(q, k, v, kv, out, G, H, P, warps,
                                      splits, scale, oa, stream);
    case 16: return launch<16, T, Opts>(q, k, v, kv, out, G, H, P, warps,
                                        splits, scale, oa, stream);
    case 24: return launch<24, T, Opts>(q, k, v, kv, out, G, H, P, warps,
                                        splits, scale, oa, stream);
    case 32: return launch<32, T, Opts>(q, k, v, kv, out, G, H, P, warps,
                                        splits, scale, oa, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
