// K1 with the backbone's attention options at fp32: the kernels and their
// design are in attention_opts.cuh.
#include "attention_opts.cuh"

// q, k, v, key_valid, out as r3dl_patch_attention; hs | NULL, gc | NULL,
// table (with gc), b; G, H, P, Dh, warps, splits as r3dl_patch_attention;
// tile: with the bias, the bias-warp plan (at most kBiasWarps warps,
// ops/attention.py OPTS_MAX_WARPS), else the inline plan; scale, stream
extern "C" int r3dl_patch_attention_opts(
    const float* q, const float* k, const float* v, const unsigned char* kv,
    float* out, const float* hs, const int* gc, const float* table, int b,
    int G, int H, int P, int Dh, int warps, int splits, int tile,
    float scale, cudaStream_t stream) {
  return attention_opts<float, false>(q, k, v, kv, out, hs, gc, table, b, G,
                                      H, P, Dh, warps, splits, tile, scale,
                                      stream);
}
