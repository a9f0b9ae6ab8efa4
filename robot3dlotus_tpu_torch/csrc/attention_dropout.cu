// K5 / K6: serialized patch attention with attention dropout, training
//   a   = softmax(where(key_valid[g], (q[g, h] * scale) k[g, h]^T, -1e9))
//   out = where(keep, a / (1 - rate), 0) v[g, h]
// q, k, v, out, g, dq, dk, dv: (G, H, P, Dh) fp32; key_valid: (G, P) bool.
//
// Replaces robot3dlotus_tpu/ops/pallas_attention.py
// `patch_attention_dropout`: `_drop_forward` (_attn_drop_fwd_kernel, K5)
// and `_drop_backward` (_attn_drop_bwd_kernel, K6). As there, the
// probabilities are fp32, keep = bits >= rate * 2^32, kept probabilities
// are scaled by 1 / (1 - rate), and the backward recomputes the
// probabilities and the keep mask instead of reading a (G, H, P, P) tensor
// from memory.
//
// Random bits: the TPU seeded its hardware generator per (patch, head).
// Here a Philox4x32-10 counter-based generator is written into the kernels:
// key (seed, g * H + h), counter (e / 4, 0, 0, 0) with e = i * P + j the
// element's index in the (P, P) tile, word e % 4 of the output. Any kernel
// that evaluates element (g, h, i, j) gets the same bits, so K6 regenerates
// K5's mask exactly, and r3dl_attention_dropout_mask writes that mask out
// (ops/attention.py has the same generator in PyTorch for CPU tensors).
//
// Bound: operations (fp32 outside the tensor cores), as for K1: the
// forward does 4 P Dh flops per query row, the backward 8 P Dh, against
// 16 (forward) or 28 (backward) Dh bytes per row of q/k/v/g/out traffic.
// Design (simple first): one block per (g, h), one thread per row.
// K5 is K1's two passes over the keys with the keep bits inside the second.
// K6 holds q * scale, k, v, g of the patch in shared memory (64 KB at
// P = 128, Dh = 32, so dynamic shared memory above 48 KB). Phase 1, thread
// i = query row: row max, row sum, D_i = g_i . out_i and the keep bits
// (P x P bits in shared memory), then dq_i. Phase 2, thread j = key:
// dk_j and dv_j, recomputing each logit in the same operation order as
// phase 1 so both phases see bit-identical probabilities. Nothing of
// size P x P leaves the block and there are no atomics. Dh is a template
// (8/16/24/32). wgmma tiles are later work.
//
// A masked key's logit is the constant -1e9, so its ds is 0: the exact
// gradient. The JAX kernel leaves ds = a (da - D) there, which differs only
// in a patch with no valid key (uniform a); the model never sends a
// cotangent into such a patch (its rows are dead slots).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxP = 128;
constexpr float kNegInf = -1e9f;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += W0;
    k1 += W1;
  }
  return c;
}

// Keep bits of row i, walked j = 0..P-1: one Philox call per 4 elements.
struct KeepStream {
  uint32_t seed, stream, thresh;
  long long cur;
  uint4 r;
  __device__ KeepStream(uint32_t seed_, uint32_t stream_, uint32_t thresh_)
      : seed(seed_), stream(stream_), thresh(thresh_), cur(-1) {}
  __device__ __forceinline__ bool keep(long long e) {
    const long long c = e >> 2;
    if (c != cur) {
      r = philox4x32_10(make_uint4((uint32_t)c, (uint32_t)(c >> 32), 0u, 0u),
                        seed, stream);
      cur = c;
    }
    const int w = (int)(e & 3);
    const uint32_t bits = w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
    return bits >= thresh;
  }
};

template <int Dh>
__global__ void __launch_bounds__(kMaxP)
attn_drop_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const unsigned char* __restrict__ kv,
                     float* __restrict__ out, int H, int P, float scale,
                     uint32_t seed, uint32_t thresh, float inv_keep) {
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = smem + P * Dh;
  __shared__ unsigned char smask[kMaxP];

  const long long gh = blockIdx.x;
  const long long g = gh / H;
  const long long base = gh * P * Dh;
  for (int i = threadIdx.x; i < P * Dh; i += blockDim.x) {
    sk[i] = k[base + i];
    sv[i] = v[base + i];
  }
  if (threadIdx.x < P) smask[threadIdx.x] = kv[g * P + threadIdx.x];
  __syncthreads();

  const int p = threadIdx.x;
  float qr[Dh];
#pragma unroll
  for (int d = 0; d < Dh; ++d) qr[d] = q[base + (long long)p * Dh + d] * scale;

  float mx = -INFINITY;
  for (int j = 0; j < P; ++j) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < Dh; ++d) s = fmaf(qr[d], sk[j * Dh + d], s);
    mx = fmaxf(mx, smask[j] ? s : kNegInf);
  }

  KeepStream bits(seed, (uint32_t)gh, thresh);
  float acc[Dh];
#pragma unroll
  for (int d = 0; d < Dh; ++d) acc[d] = 0.f;
  float l = 0.f;
  for (int j = 0; j < P; ++j) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < Dh; ++d) s = fmaf(qr[d], sk[j * Dh + d], s);
    const float e = expf((smask[j] ? s : kNegInf) - mx);
    l += e;
    if (bits.keep((long long)p * P + j)) {
#pragma unroll
      for (int d = 0; d < Dh; ++d) acc[d] = fmaf(e, sv[j * Dh + d], acc[d]);
    }
  }
  const float f = inv_keep / l;
#pragma unroll
  for (int d = 0; d < Dh; ++d) out[base + (long long)p * Dh + d] = acc[d] * f;
}

template <int Dh>
__global__ void __launch_bounds__(kMaxP)
attn_drop_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const unsigned char* __restrict__ kv,
                     const float* __restrict__ gout, float* __restrict__ dq,
                     float* __restrict__ dk, float* __restrict__ dv, int H,
                     int P, float scale, uint32_t seed, uint32_t thresh,
                     float inv_keep) {
  extern __shared__ float smem[];
  const int W = (P + 31) / 32;          // bit words per row
  float* sq = smem;                      // q * scale
  float* sk = sq + P * Dh;
  float* sv = sk + P * Dh;
  float* sg = sv + P * Dh;
  float* smx = sg + P * Dh;
  float* sl = smx + P;
  float* sD = sl + P;
  uint32_t* sbits = reinterpret_cast<uint32_t*>(sD + P);
  __shared__ unsigned char smask[kMaxP];

  const long long gh = blockIdx.x;
  const long long g = gh / H;
  const long long base = gh * P * Dh;
  for (int i = threadIdx.x; i < P * Dh; i += blockDim.x) {
    sq[i] = q[base + i] * scale;
    sk[i] = k[base + i];
    sv[i] = v[base + i];
    sg[i] = gout[base + i];
  }
  if (threadIdx.x < P) smask[threadIdx.x] = kv[g * P + threadIdx.x];
  __syncthreads();

  // ---- phase 1: thread i = query row ----
  const int i = threadIdx.x;
  {
    float qr[Dh], gr[Dh], acc[Dh];
#pragma unroll
    for (int d = 0; d < Dh; ++d) {
      qr[d] = sq[i * Dh + d];
      gr[d] = sg[i * Dh + d];
    }
    float mx = -INFINITY;
    for (int j = 0; j < P; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < Dh; ++d) s = fmaf(qr[d], sk[j * Dh + d], s);
      mx = fmaxf(mx, smask[j] ? s : kNegInf);
    }
    // row sum, the dropped output (unnormalised) and the keep bits
    KeepStream bits(seed, (uint32_t)gh, thresh);
#pragma unroll
    for (int d = 0; d < Dh; ++d) acc[d] = 0.f;
    float l = 0.f;
    uint32_t word = 0u;
    for (int j = 0; j < P; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < Dh; ++d) s = fmaf(qr[d], sk[j * Dh + d], s);
      const float e = expf((smask[j] ? s : kNegInf) - mx);
      l += e;
      const bool kp = bits.keep((long long)i * P + j);
      if (kp) {
        word |= 1u << (j & 31);
#pragma unroll
        for (int d = 0; d < Dh; ++d) acc[d] = fmaf(e, sv[j * Dh + d], acc[d]);
      }
      if ((j & 31) == 31 || j == P - 1) {
        sbits[i * W + (j >> 5)] = word;
        word = 0u;
      }
    }
    // D_i = g_i . out_i = sum_j da_ij a_ij (the softmax-vjp row term)
    float Di = 0.f;
#pragma unroll
    for (int d = 0; d < Dh; ++d) Di = fmaf(gr[d], acc[d], Di);
    Di *= inv_keep / l;
    smx[i] = mx;
    sl[i] = l;
    sD[i] = Di;
    // dq_i = scale * sum_j ds_ij k_j, ds = a (da - D_i)
#pragma unroll
    for (int d = 0; d < Dh; ++d) acc[d] = 0.f;
    for (int j = 0; j < P; ++j) {
      float s = 0.f, dad = 0.f;
#pragma unroll
      for (int d = 0; d < Dh; ++d) {
        s = fmaf(qr[d], sk[j * Dh + d], s);
        dad = fmaf(gr[d], sv[j * Dh + d], dad);
      }
      const float a = expf((smask[j] ? s : kNegInf) - mx) / l;
      const bool kp = (sbits[i * W + (j >> 5)] >> (j & 31)) & 1u;
      const float ds =
          smask[j] ? a * ((kp ? dad * inv_keep : 0.f) - Di) : 0.f;
#pragma unroll
      for (int d = 0; d < Dh; ++d) acc[d] = fmaf(ds, sk[j * Dh + d], acc[d]);
    }
#pragma unroll
    for (int d = 0; d < Dh; ++d)
      dq[base + (long long)i * Dh + d] = acc[d] * scale;
  }
  __syncthreads();

  // ---- phase 2: thread j = key ----
  const int j = threadIdx.x;
  float kr[Dh], vr[Dh], dka[Dh], dva[Dh];
#pragma unroll
  for (int d = 0; d < Dh; ++d) {
    kr[d] = sk[j * Dh + d];
    vr[d] = sv[j * Dh + d];
    dka[d] = 0.f;
    dva[d] = 0.f;
  }
  const bool valid = smask[j] != 0;
  for (int r = 0; r < P; ++r) {
    float s = 0.f, dad = 0.f;
#pragma unroll
    for (int d = 0; d < Dh; ++d) {
      s = fmaf(sq[r * Dh + d], kr[d], s);
      dad = fmaf(sg[r * Dh + d], vr[d], dad);
    }
    const float a = expf((valid ? s : kNegInf) - smx[r]) / sl[r];
    const bool kp = (sbits[r * W + (j >> 5)] >> (j & 31)) & 1u;
    const float ad = kp ? a * inv_keep : 0.f;
    const float ds = valid ? a * ((kp ? dad * inv_keep : 0.f) - sD[r]) : 0.f;
#pragma unroll
    for (int d = 0; d < Dh; ++d) {
      dva[d] = fmaf(ad, sg[r * Dh + d], dva[d]);
      dka[d] = fmaf(ds, sq[r * Dh + d], dka[d]);
    }
  }
#pragma unroll
  for (int d = 0; d < Dh; ++d) {
    dk[base + (long long)j * Dh + d] = dka[d];
    dv[base + (long long)j * Dh + d] = dva[d];
  }
}

__global__ void attn_drop_mask_kernel(unsigned char* __restrict__ keep,
                                      int P, uint32_t seed, uint32_t thresh) {
  const long long gh = blockIdx.x;
  const int i = threadIdx.x;
  KeepStream bits(seed, (uint32_t)gh, thresh);
  unsigned char* row = keep + (gh * P + i) * P;
  for (int j = 0; j < P; ++j) row[j] = bits.keep((long long)i * P + j);
}

size_t bwd_smem(int P, int Dh) {
  return (4 * (size_t)P * Dh + 3 * (size_t)P) * sizeof(float) +
         (size_t)P * ((P + 31) / 32) * sizeof(uint32_t);
}

template <int Dh>
int launch_fwd(const float* q, const float* k, const float* v,
               const unsigned char* kv, float* out, int G, int H, int P,
               float scale, uint32_t seed, uint32_t thresh, float inv_keep,
               cudaStream_t stream) {
  const size_t smem = 2 * (size_t)P * Dh * sizeof(float);
  attn_drop_fwd_kernel<Dh><<<(unsigned)((long long)G * H), P, smem,
                             stream>>>(q, k, v, kv, out, H, P, scale, seed,
                                       thresh, inv_keep);
  return (int)cudaGetLastError();
}

template <int Dh>
int launch_bwd(const float* q, const float* k, const float* v,
               const unsigned char* kv, const float* gout, float* dq,
               float* dk, float* dv, int G, int H, int P, float scale,
               uint32_t seed, uint32_t thresh, float inv_keep,
               cudaStream_t stream) {
  const size_t smem = bwd_smem(P, Dh);
  cudaError_t err = cudaFuncSetAttribute(
      attn_drop_bwd_kernel<Dh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_drop_bwd_kernel<Dh><<<(unsigned)((long long)G * H), P, smem,
                             stream>>>(q, k, v, kv, gout, dq, dk, dv, H, P,
                                       scale, seed, thresh, inv_keep);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int r3dl_attention_dropout_fwd(
    const float* q, const float* k, const float* v, const unsigned char* kv,
    float* out, int G, int H, int P, int Dh, float scale, unsigned seed,
    unsigned thresh, float inv_keep, cudaStream_t stream) {
  if (P < 1 || P > kMaxP) return (int)cudaErrorInvalidValue;
  if ((long long)G * H == 0) return (int)cudaGetLastError();
  switch (Dh) {
    case 8: return launch_fwd<8>(q, k, v, kv, out, G, H, P, scale, seed,
                                 thresh, inv_keep, stream);
    case 16: return launch_fwd<16>(q, k, v, kv, out, G, H, P, scale, seed,
                                   thresh, inv_keep, stream);
    case 24: return launch_fwd<24>(q, k, v, kv, out, G, H, P, scale, seed,
                                   thresh, inv_keep, stream);
    case 32: return launch_fwd<32>(q, k, v, kv, out, G, H, P, scale, seed,
                                   thresh, inv_keep, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int r3dl_attention_dropout_bwd(
    const float* q, const float* k, const float* v, const unsigned char* kv,
    const float* gout, float* dq, float* dk, float* dv, int G, int H, int P,
    int Dh, float scale, unsigned seed, unsigned thresh, float inv_keep,
    cudaStream_t stream) {
  if (P < 1 || P > kMaxP) return (int)cudaErrorInvalidValue;
  if ((long long)G * H == 0) return (int)cudaGetLastError();
  switch (Dh) {
    case 8: return launch_bwd<8>(q, k, v, kv, gout, dq, dk, dv, G, H, P,
                                 scale, seed, thresh, inv_keep, stream);
    case 16: return launch_bwd<16>(q, k, v, kv, gout, dq, dk, dv, G, H, P,
                                   scale, seed, thresh, inv_keep, stream);
    case 24: return launch_bwd<24>(q, k, v, kv, gout, dq, dk, dv, G, H, P,
                                   scale, seed, thresh, inv_keep, stream);
    case 32: return launch_bwd<32>(q, k, v, kv, gout, dq, dk, dv, G, H, P,
                                   scale, seed, thresh, inv_keep, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// keep: (G, H, P, P) uint8, the mask K5 and K6 regenerate for these
// arguments (1 = kept)
extern "C" int r3dl_attention_dropout_mask(unsigned char* keep, int G, int H,
                                           int P, unsigned seed,
                                           unsigned thresh,
                                           cudaStream_t stream) {
  if (P < 1 || P > kMaxP) return (int)cudaErrorInvalidValue;
  if ((long long)G * H == 0) return (int)cudaGetLastError();
  attn_drop_mask_kernel<<<(unsigned)((long long)G * H), P, 0, stream>>>(
      keep, P, seed, thresh);
  return (int)cudaGetLastError();
}
