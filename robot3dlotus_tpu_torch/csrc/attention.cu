// K1: serialized patch attention, forward (inference)
//   out[g, h] = softmax(where(key_valid[g], (q[g, h] * scale) k[g, h]^T,
//                             -1e9)) v[g, h]
// q, k, v, out: (G, H, P, Dh) fp32; key_valid: (G, P) bool (1 byte each).
//
// Replaces robot3dlotus_tpu/ops/pallas_attention.py `patch_attention`
// (_forward / _attn_kernel), where one grid step held one (patch, head)
// tile in VMEM and ran both products on the MXU.
//
// Bound: at the release shapes (P = 128, Dh = 32 or 24) the kernel does
// 4 P Dh flops per query row against 16 Dh bytes of q/k/v/out traffic, so
// on the fp32 (non-tensor-core) rate of 67 TFLOP/s it is bound by
// operations, not by the 3.35 TB/s memory. Design (simple first): one
// block per (g, h) with one thread per query row. K and V of the patch
// (2 x 128 x 32 x 4 B = 32 KB) and the key mask sit in shared memory and
// every thread walks the keys in lockstep, so each shared read is a
// broadcast. Two passes over the keys (max, then exp-sum and the P.V
// accumulation) keep the softmax max-subtracted in fp32 without holding
// 128 logits in registers. A fully masked patch gives uniform weights, as
// the plain version does (every logit is -1e9). wgmma tiles and one block
// per patch for all heads are later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxP = 128;
constexpr float kNegInf = -1e9f;

template <int Dh>
__global__ void patch_attention_kernel(const float* __restrict__ q,
                                       const float* __restrict__ k,
                                       const float* __restrict__ v,
                                       const unsigned char* __restrict__ kv,
                                       float* __restrict__ out, int H, int P,
                                       float scale) {
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
#pragma unroll
    for (int d = 0; d < Dh; ++d) acc[d] = fmaf(e, sv[j * Dh + d], acc[d]);
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < Dh; ++d) out[base + (long long)p * Dh + d] = acc[d] * inv;
}

template <int Dh>
int launch(const float* q, const float* k, const float* v,
           const unsigned char* kv, float* out, int G, int H, int P,
           float scale, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)P * Dh * sizeof(float);
  patch_attention_kernel<Dh><<<(unsigned)((long long)G * H), P, smem,
                               stream>>>(q, k, v, kv, out, H, P, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int r3dl_patch_attention(const float* q, const float* k,
                                    const float* v, const unsigned char* kv,
                                    float* out, int G, int H, int P, int Dh,
                                    float scale, cudaStream_t stream) {
  if (P < 1 || P > kMaxP) return (int)cudaErrorInvalidValue;
  if ((long long)G * H == 0) return (int)cudaGetLastError();
  switch (Dh) {
    case 8: return launch<8>(q, k, v, kv, out, G, H, P, scale, stream);
    case 16: return launch<16>(q, k, v, kv, out, G, H, P, scale, stream);
    case 24: return launch<24>(q, k, v, kv, out, G, H, P, scale, stream);
    case 32: return launch<32>(q, k, v, kv, out, G, H, P, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
