// K5 / K6 with the backbone's attention options (ptv3_config enable_rpe,
// scaled_cosine_attn) at bf16 (compute_dtype bfloat16): per-head logit scales
// hs (H,) fp32 and the relative position bias from the patches' grid
// coordinates gc (G, P, 3) int32 and the table (3R, H) fp32 at position bound
// b (R = 2b + 1), either or both (NULL: off). K6 also writes the options'
// gradient partials, dhs (G, H) and dtable (G, 3R, H) fp32, where the option
// is on. The kernels are attention_dropout.cuh's, instantiated with
// attention_tile.cuh LogitOpts; a source apart from the fp32 options
// (attention_dropout_opts.cu), so that nvcc builds the two side by side.
#include "attention_dropout.cuh"

using T = r3dl::bf16;

// q, k, v, key_valid, out, lse, bits as r3dl_attention_dropout_fwd_bf16;
// hs | NULL, gc | NULL, table (with gc), b; then as there
extern "C" int r3dl_attention_dropout_fwd_opts_bf16(
    const T* q, const T* k, const T* v, const unsigned char* kv, T* out,
    float* lse, unsigned* bits, const float* hs, const int* gc,
    const float* table, int b, int G, int H, int P, int Dh, float scale,
    unsigned seed, unsigned thresh, float inv_keep, cudaStream_t stream) {
  const OptArgs oa{hs, gc, table, b};
  return r3dl::with_opts<false>(hs, gc, table, [&](auto tag) {
    using Opts = typename decltype(tag)::type;
    return fwd<T, Opts>(q, k, v, kv, out, lse, bits, G, H, P, Dh, scale,
                        seed, thresh, inv_keep, oa, stream);
  });
}

// as r3dl_attention_dropout_bwd_bf16, with hs, gc, table, b as the forward
// took them and the partials dtable (G, 3R, H) | NULL and dhs (G, H) |
// NULL, each written where its option is on
extern "C" int r3dl_attention_dropout_bwd_opts_bf16(
    const T* q, const T* k, const T* v, const unsigned char* kv,
    const T* out, const float* lse, const unsigned* bits, const T* gout,
    T* dq, T* dk, T* dv, const float* hs, const int* gc, const float* table,
    int b, float* dtable, float* dhs, int G, int H, int P, int Dh,
    float scale, float inv_keep, cudaStream_t stream) {
  const OptArgs oa{hs, gc, table, b};
  const OptGrads og{dhs, dtable};
  return r3dl::with_opts<false>(hs, gc, table, [&](auto tag) {
    using Opts = typename decltype(tag)::type;
    return bwd<T, Opts>(q, k, v, kv, out, lse, bits, gout, dq, dk, dv, G, H,
                        P, Dh, scale, inv_keep, oa, og, stream);
  });
}

// K6's blocks an SM with the options hs (scale) and rpe (bias) on, at
// head dim Dh, into *blocks (ops/attention.py bwd_opts_blocks_per_sm)
extern "C" int r3dl_attention_dropout_bwd_opts_blocks_bf16(int Dh, int hs,
                                                           int rpe,
                                                           int* blocks,
                                                           cudaStream_t) {
  const float one = 1.f;
  const int gc = 0;
  return r3dl::with_opts<false>(
      hs ? &one : nullptr, rpe ? &gc : nullptr, rpe ? &one : nullptr,
      [&](auto tag) {
        using Opts = typename decltype(tag)::type;
        *blocks = bwd_blocks_per_sm<T, Opts>(Dh);
        return *blocks < 0 ? -*blocks : 0;
      });
}
