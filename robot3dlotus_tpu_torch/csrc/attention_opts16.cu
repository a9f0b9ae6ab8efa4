// K1 with the backbone's attention options at bf16 (compute_dtype
// bfloat16): the kernels and their design are in attention_opts.cuh.
#include "attention_opts.cuh"

// arguments as r3dl_patch_attention_opts, q, k, v and out bf16
extern "C" int r3dl_patch_attention_opts_bf16(
    const r3dl::bf16* q, const r3dl::bf16* k, const r3dl::bf16* v,
    const unsigned char* kv, r3dl::bf16* out, const float* hs, const int* gc,
    const float* table, int b, int G, int H, int P, int Dh, int warps,
    int splits, int tile, float scale, cudaStream_t stream) {
  return attention_opts<r3dl::bf16, false>(q, k, v, kv, out, hs, gc, table, b,
                                           G, H, P, Dh, warps, splits, tile,
                                           scale, stream);
}
