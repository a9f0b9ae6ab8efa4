// K5 / K6's release entry points (no attention options): the kernels and
// their design are in attention_dropout.cuh.
#include "attention_dropout.cuh"

using r3dl::NoOpts;

extern "C" int r3dl_attention_dropout_fwd(
    const float* q, const float* k, const float* v, const unsigned char* kv,
    float* out, float* lse, unsigned* bits, int G, int H, int P, int Dh,
    float scale, unsigned seed, unsigned thresh, float inv_keep,
    cudaStream_t stream) {
  return fwd<float, NoOpts>(q, k, v, kv, out, lse, bits, G, H, P, Dh, scale,
                            seed, thresh, inv_keep, OptArgs{}, stream);
}

extern "C" int r3dl_attention_dropout_bwd(
    const float* q, const float* k, const float* v, const unsigned char* kv,
    const float* out, const float* lse, const unsigned* bits,
    const float* gout, float* dq, float* dk, float* dv, int G, int H, int P,
    int Dh, float scale, float inv_keep, cudaStream_t stream) {
  return bwd<float, NoOpts>(q, k, v, kv, out, lse, bits, gout, dq, dk, dv, G,
                            H, P, Dh, scale, inv_keep, OptArgs{}, OptGrads{},
                            stream);
}

// The same with bf16 q, k, v, out (and g, dq, dk, dv); lse and bits as
// above; scale a bf16 value; the forward takes k and v 16-byte aligned, q
// and out 4-byte; the backward q, k, v, out and g 16-byte aligned, dq, dk
// and dv 4-byte.
extern "C" int r3dl_attention_dropout_fwd_bf16(
    const r3dl::bf16* q, const r3dl::bf16* k, const r3dl::bf16* v,
    const unsigned char* kv, r3dl::bf16* out, float* lse, unsigned* bits,
    int G, int H, int P, int Dh, float scale, unsigned seed, unsigned thresh,
    float inv_keep, cudaStream_t stream) {
  return fwd<r3dl::bf16, NoOpts>(q, k, v, kv, out, lse, bits, G, H, P, Dh,
                                 scale, seed, thresh, inv_keep, OptArgs{},
                                 stream);
}

extern "C" int r3dl_attention_dropout_bwd_bf16(
    const r3dl::bf16* q, const r3dl::bf16* k, const r3dl::bf16* v,
    const unsigned char* kv, const r3dl::bf16* out, const float* lse,
    const unsigned* bits, const r3dl::bf16* gout, r3dl::bf16* dq,
    r3dl::bf16* dk, r3dl::bf16* dv, int G, int H, int P, int Dh, float scale,
    float inv_keep, cudaStream_t stream) {
  return bwd<r3dl::bf16, NoOpts>(q, k, v, kv, out, lse, bits, gout, dq, dk,
                                 dv, G, H, P, Dh, scale, inv_keep, OptArgs{},
                                 OptGrads{}, stream);
}
