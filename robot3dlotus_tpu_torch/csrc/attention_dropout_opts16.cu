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

namespace {

using T = r3dl::bf16;

template <class Opts>
struct Tag {
  using type = Opts;
};

// f(Tag<Opts>()) with the LogitOpts of the options that hs and gc turn
// on; invalid when neither is
template <class F>
int with_opts(const float* hs, const int* gc, const float* table, F&& f) {
  if ((gc == nullptr) != (table == nullptr))
    return (int)cudaErrorInvalidValue;
  if (hs && gc) return f(Tag<r3dl::LogitOpts<true, true>>());
  if (hs) return f(Tag<r3dl::LogitOpts<true, false>>());
  if (gc) return f(Tag<r3dl::LogitOpts<false, true>>());
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, key_valid, out, lse, bits as r3dl_attention_dropout_fwd_bf16;
// hs | NULL, gc | NULL, table (with gc), b; then as there
extern "C" int r3dl_attention_dropout_fwd_opts_bf16(
    const T* q, const T* k, const T* v, const unsigned char* kv, T* out,
    float* lse, unsigned* bits, const float* hs, const int* gc,
    const float* table, int b, int G, int H, int P, int Dh, float scale,
    unsigned seed, unsigned thresh, float inv_keep, cudaStream_t stream) {
  const OptArgs oa{hs, gc, table, b};
  return with_opts(hs, gc, table, [&](auto tag) {
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
  return with_opts(hs, gc, table, [&](auto tag) {
    using Opts = typename decltype(tag)::type;
    return bwd<T, Opts>(q, k, v, kv, out, lse, bits, gout, dq, dk, dv, G, H,
                        P, Dh, scale, inv_keep, oa, og, stream);
  });
}
