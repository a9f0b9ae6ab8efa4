// K1 with the backbone's attention options (ptv3_config enable_rpe,
// scaled_cosine_attn): per-head logit scales hs (H,) fp32 and the relative
// position bias from the patches' grid coordinates gc (G, P, 3) int32 and
// the table (3R, H) fp32 at position bound b (R = 2b + 1), either or both
// (NULL: off). The kernel is attention.cuh's, instantiated with
// attention_tile.cuh LogitOpts; a separate source so that nvcc builds it
// beside the release instantiations.
#include "attention.cuh"

namespace {

template <typename T, bool kRoundP>
int attention_opts(const T* q, const T* k, const T* v,
                   const unsigned char* kv, T* out, const float* hs,
                   const int* gc, const float* table, int b, int G, int H,
                   int P, int Dh, int warps, int splits, float scale,
                   cudaStream_t stream) {
  const OptArgs oa{hs, gc, table, b};
  return r3dl::with_opts<kRoundP>(hs, gc, table, [&](auto tag) {
    using Opts = typename decltype(tag)::type;
    return attention<T, Opts>(q, k, v, kv, out, G, H, P, Dh, warps, splits,
                              scale, oa, stream);
  });
}

}  // namespace

// q, k, v, key_valid, out as r3dl_patch_attention; hs | NULL, gc | NULL,
// table (with gc), b; then as r3dl_patch_attention
extern "C" int r3dl_patch_attention_opts(
    const float* q, const float* k, const float* v, const unsigned char* kv,
    float* out, const float* hs, const int* gc, const float* table, int b,
    int G, int H, int P, int Dh, int warps, int splits, float scale,
    cudaStream_t stream) {
  return attention_opts<float, false>(q, k, v, kv, out, hs, gc, table, b, G,
                                      H, P, Dh, warps, splits, scale, stream);
}

extern "C" int r3dl_patch_attention_opts_bf16(
    const r3dl::bf16* q, const r3dl::bf16* k, const r3dl::bf16* v,
    const unsigned char* kv, r3dl::bf16* out, const float* hs, const int* gc,
    const float* table, int b, int G, int H, int P, int Dh, int warps,
    int splits, float scale, cudaStream_t stream) {
  return attention_opts<r3dl::bf16, false>(q, k, v, kv, out, hs, gc, table, b,
                                           G, H, P, Dh, warps, splits, scale,
                                           stream);
}

// upcast_attention at bf16 with the options (the JAX XLA path): q and k
// fp32, v a bf16 tensor widened to fp32 by the wrapper, the probabilities
// rounded to bf16 before P v (LogitOpts kRoundP); arguments as
// r3dl_patch_attention_opts
extern "C" int r3dl_patch_attention_opts_mixed(
    const float* q, const float* k, const float* v, const unsigned char* kv,
    float* out, const float* hs, const int* gc, const float* table, int b,
    int G, int H, int P, int Dh, int warps, int splits, float scale,
    cudaStream_t stream) {
  return attention_opts<float, true>(q, k, v, kv, out, hs, gc, table, b, G,
                                     H, P, Dh, warps, splits, scale, stream);
}
