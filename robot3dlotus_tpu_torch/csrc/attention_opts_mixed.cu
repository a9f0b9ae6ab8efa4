// K1 with the options under upcast_attention at bf16 (the JAX XLA path):
// q and k fp32, v a bf16 tensor widened to fp32 by the wrapper, the
// probabilities rounded to bf16 before P v (kRoundP). The kernels and
// their design are in attention_opts.cuh.
#include "attention_opts.cuh"

// arguments as r3dl_patch_attention_opts
extern "C" int r3dl_patch_attention_opts_mixed(
    const float* q, const float* k, const float* v, const unsigned char* kv,
    float* out, const float* hs, const int* gc, const float* table, int b,
    int G, int H, int P, int Dh, int warps, int splits, int tile,
    float scale, cudaStream_t stream) {
  return attention_opts<float, true>(q, k, v, kv, out, hs, gc, table, b, G,
                                     H, P, Dh, warps, splits, tile, scale,
                                     stream);
}
