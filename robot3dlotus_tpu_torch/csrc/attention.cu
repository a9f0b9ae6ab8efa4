// K1's release entry points (no attention options): the kernel and its
// design are in attention.cuh.
#include "attention.cuh"

// warps: 1..8 warps of 16 query rows a block; splits: blocks per (g, h),
// with 16 warps splits >= P (ops/attention.py attention_query_split).
extern "C" int r3dl_patch_attention(const float* q, const float* k,
                                    const float* v, const unsigned char* kv,
                                    float* out, int G, int H, int P, int Dh,
                                    int warps, int splits, float scale,
                                    cudaStream_t stream) {
  return attention<float, r3dl::NoOpts>(q, k, v, kv, out, G, H, P, Dh, warps,
                                        splits, scale, OptArgs{}, stream);
}

// The same with bf16 q, k, v and out (k and v 16-byte aligned, q and out
// 4-byte); scale is a bf16 value.
extern "C" int r3dl_patch_attention_bf16(const r3dl::bf16* q,
                                         const r3dl::bf16* k,
                                         const r3dl::bf16* v,
                                         const unsigned char* kv,
                                         r3dl::bf16* out, int G, int H,
                                         int P, int Dh, int warps, int splits,
                                         float scale, cudaStream_t stream) {
  return attention<r3dl::bf16, r3dl::NoOpts>(q, k, v, kv, out, G, H, P, Dh,
                                             warps, splits, scale, OptArgs{},
                                             stream);
}
