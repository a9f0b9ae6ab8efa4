// K5 with the attention options under upcast_attention at bf16: the JAX
// package's XLA attention there (models/layers.py:351-392 of the JAX
// package), q and k fp32 after the qk norms and v a bf16 tensor, which the
// wrapper (ops/attention.py) widens to fp32 for this entry point: fp32
// logits, the dropped probabilities rounded to bf16 before P v (LogitOpts
// kRoundP). Its backward is the fp32 K6 with the options
// (r3dl_attention_dropout_bwd_opts). The arguments are
// r3dl_attention_dropout_fwd_opts'; a source of its own, so that nvcc
// builds it beside the other options.
#include "attention_dropout.cuh"

using T = float;

extern "C" int r3dl_attention_dropout_fwd_opts_mixed(
    const T* q, const T* k, const T* v, const unsigned char* kv, T* out,
    float* lse, unsigned* bits, const float* hs, const int* gc,
    const float* table, int b, int G, int H, int P, int Dh, float scale,
    unsigned seed, unsigned thresh, float inv_keep, cudaStream_t stream) {
  const OptArgs oa{hs, gc, table, b};
  return r3dl::with_opts<true>(hs, gc, table, [&](auto tag) {
    using Opts = typename decltype(tag)::type;
    return fwd<T, Opts>(q, k, v, kv, out, lse, bits, G, H, P, Dh, scale,
                        seed, thresh, inv_keep, oa, stream);
  });
}
