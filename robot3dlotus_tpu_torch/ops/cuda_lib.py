"""Build, load and launch the port's hand-written Hopper kernels.

The sources in robot3dlotus_tpu_torch/csrc/*.cu have a plain C interface:
each entry point takes raw device pointers, sizes and a cudaStream_t and
returns cudaGetLastError(). At first use every source is compiled by its
own nvcc process, all started together, for sm_90a; the objects are linked
into one shared library under build/kernels/ (named by a hash of the
sources and flags, so an edited source rebuilds; `nvcc -Xptxas -v`'s
register and spill counts beside it, in a .ptxas.txt) and loaded with
ctypes
as a PyDLL: a call holds the GIL for its few microseconds of launch
instead of releasing and taking it back.
Nothing here runs at import time, and nothing falls back: a failed build
or launch raises.

LAUNCHES counts, per kernel, the launches made through `launch`; a caller
that counts one run sets the counts to 0 with reset_launches just before
it. `launch` is on every kernel's hot path: it calls a C function object
bound once when the library loads, on the raw handle of the current
stream, and nothing else.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_L = ctypes.c_longlong
# C signatures: every entry point returns cudaGetLastError() as int
_GATHER = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
_ATTENTION = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]
_ATTENTION_OPTS = _ATTENTION[:5] + [_P, _P, _P, _I] + _ATTENTION[5:]
_DROP_FWD_OPTS = [_P] * 7 + [_P, _P, _P, _I] + [_I, _I, _I, _I, _F, _U, _U,
                                                _F, _P]
_DROP_BWD_OPTS = [_P] * 11 + [_P, _P, _P, _I, _P, _P] + [_I, _I, _I, _I, _F,
                                                         _F, _P]
_CONV = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _P]
_STEM = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _L,
         _P]
# Entry points ending in _bf16 / 16 take bf16 (2-byte) activations and
# weights (and cotangents): the kernels' paths under compute_dtype
# bfloat16.
SIGNATURES = {
    # x or g, idx, out, B, N, M, D, idx64 (int64 indices, else int32),
    # stream
    "r3dl_gather_rows": _GATHER,
    "r3dl_gather_rows16": _GATHER,
    "r3dl_scatter_rows_add": _GATHER,
    # g (bf16), idx, out (bf16, or fp32 with out_f32), out_f32, B, N, M,
    # D, idx64, stream
    "r3dl_scatter_rows_add_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "r3dl_gather_smallc": _GATHER,
    "r3dl_gather_smallc16": _GATHER,
    # g, idx, dx, work|NULL, B, n, M, C, idx64, ranges, window, work_bytes,
    # stream
    "r3dl_scatter_smallc_add": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _L, _P],
    # the same with g and dx bf16 (work fp32)
    "r3dl_scatter_smallc_add_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _I, _L, _P],
    # q, k, v, key_valid, out, G, H, P, Dh, warps, splits, scale, stream
    "r3dl_patch_attention": _ATTENTION,
    "r3dl_patch_attention_bf16": _ATTENTION,
    # q, k, v, key_valid, out, lse, bits, G, H, P, Dh, scale, seed, thresh,
    # inv_keep, stream
    "r3dl_attention_dropout_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _F, _U, _U, _F, _P],
    "r3dl_attention_dropout_fwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                        _I, _I, _F, _U, _U, _F, _P],
    # q, k, v, key_valid, out, lse, bits, g, dq, dk, dv, G, H, P, Dh, scale,
    # inv_keep, stream
    "r3dl_attention_dropout_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _I, _I, _I, _I, _F, _F, _P],
    "r3dl_attention_dropout_bwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _P, _P, _I, _I, _I, _I, _F, _F, _P],
    # the attention options (ops/attention.py head_scale, rpe): after the
    # outputs, hs|NULL, gc|NULL, table|NULL, b (and in K6 the partials
    # dtable|NULL, dhs|NULL), then as above
    "r3dl_patch_attention_opts": _ATTENTION_OPTS,
    "r3dl_patch_attention_opts_bf16": _ATTENTION_OPTS,
    "r3dl_attention_dropout_fwd_opts": _DROP_FWD_OPTS,
    "r3dl_attention_dropout_fwd_opts_bf16": _DROP_FWD_OPTS,
    "r3dl_attention_dropout_bwd_opts": _DROP_BWD_OPTS,
    "r3dl_attention_dropout_bwd_opts_bf16": _DROP_BWD_OPTS,
    # upcast_attention at bf16 with the options: K1 and K5's fp32 _opts
    # kernels rounding the probabilities to bf16 (v a bf16 tensor widened
    # by the wrapper); counted with the fp32 _opts kernels
    "r3dl_patch_attention_opts_mixed": _ATTENTION_OPTS,
    "r3dl_attention_dropout_fwd_opts_mixed": _DROP_FWD_OPTS,
    # K6 with the options: its blocks an SM (Dh, hs on, rpe on, *blocks,
    # stream unused); a query, no launch
    "r3dl_attention_dropout_bwd_opts_blocks": [_I, _I, _I, _P, _P],
    "r3dl_attention_dropout_bwd_opts_blocks_bf16": [_I, _I, _I, _P, _P],
    # x, idx, ok, w, bias|NULL, out, work|NULL, B, N, K, Cin, Cout,
    # splits, work_bytes, stream
    "r3dl_subm_conv": _CONV,
    "r3dl_subm_conv_bf16": _CONV,
    # the input gradient at bf16: x the fp32 owner sums, w the mirrored bf16
    # weight, out bf16
    "r3dl_subm_conv_dx_bf16": _CONV,
    # x, idx, ok, g, work|NULL, dw, B, N, K, Cin, Cout, splits,
    # rows_per_split, work_bytes, stream
    "r3dl_conv_weight_grad": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _L, _L, _P],
    "r3dl_conv_weight_grad_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _L, _L, _P],
    # x, idx, ok, w, out, work|NULL, B, N, K, Cin, Cout, cols, warps,
    # splits, blocks, work_bytes, stream
    "r3dl_stem_conv": _STEM,
    # x, xp (x padded to 8 channels; NULL at Cin = 8), then as above
    "r3dl_stem_conv_bf16": _STEM[:1] + [_P] + _STEM[1:],
}

# K1-K10 by wrapper name; their bf16 paths count apart (K2's input
# gradient at bf16 as subm_conv_dx_bf16), and so do K1, K5 and K6 with the
# attention options (_opts)
LAUNCHES = {"patch_attention": 0, "subm_conv": 0, "stem_conv": 0,
            "gather_rows": 0, "patch_attention_dropout": 0,
            "patch_attention_dropout_bwd": 0, "conv_weight_grad": 0,
            "scatter_rows_add": 0, "gather_rows_smallc": 0,
            "scatter_rows_smallc_add": 0, "patch_attention_bf16": 0,
            "subm_conv_bf16": 0, "stem_conv_bf16": 0, "gather_rows_bf16": 0,
            "gather_rows_smallc_bf16": 0, "subm_conv_dx_bf16": 0,
            "patch_attention_dropout_bf16": 0,
            "patch_attention_dropout_bwd_bf16": 0,
            "conv_weight_grad_bf16": 0, "scatter_rows_add_bf16": 0,
            "scatter_rows_smallc_add_bf16": 0,
            # K1, K5 and K6 with the attention options, both dtypes
            "patch_attention_opts": 0, "patch_attention_opts_bf16": 0,
            "patch_attention_dropout_opts": 0,
            "patch_attention_dropout_opts_bf16": 0,
            "patch_attention_dropout_bwd_opts": 0,
            "patch_attention_dropout_bwd_opts_bf16": 0}

_LIB = None
_FNS = {}       # C entry point name -> its ctypes function object, bound once
_STREAMS = {}   # raw cudaStream_t -> its ctypes.c_void_p argument


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _tag():
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sorted(glob.glob(os.path.join(CSRC, "*"))):
        with open(f, "rb") as fh:
            h.update(os.path.basename(f).encode() + fh.read())
    return h.hexdigest()[:12]


def _nvcc():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build():
    """Compile every csrc/*.cu in parallel and link one .so, unless the
    build of these sources exists; returns its path."""
    so = os.path.join(BUILD_DIR, f"libr3dl_kernels-{_tag()}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs, objs = [], []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", CSRC, "-c", src,
                 "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed, logs = [], []
        for src, p in procs:
            out, _ = p.communicate()
            logs.append(out)
            if p.returncode != 0:
                failed.append(f"{src} (rc={p.returncode}):\n{out[-4000:]}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        with open(so[:-3] + ".ptxas.txt", "w") as f:
            f.write("".join(logs))
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *objs,
                               "-o", tmp_so], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr[-4000:]}")
        os.replace(tmp_so, so)
    return so


def library():
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.PyDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FNS[name] = fn
        _LIB = lib
    return _LIB


def current_stream():
    """The ctypes argument of the current device's current stream: the raw
    cudaStream_t that torch.cuda.current_stream().cuda_stream gives,
    without building a Stream object (device index -1: the current
    device)."""
    raw = torch._C._cuda_getCurrentRawStream(-1)
    stream = _STREAMS.get(raw)
    if stream is None:
        stream = _STREAMS[raw] = _P(raw)
    return stream


def launch(kernel, c_name, *args):
    """Call one C entry point on the current stream, raise on a launch
    error, and count the launch under `kernel`."""
    fn = _FNS.get(c_name)
    if fn is None:
        library()
        fn = _FNS[c_name]
    err = fn(*args, current_stream())
    if err:
        raise RuntimeError(f"{c_name} launch failed: cudaError {err}")
    LAUNCHES[kernel] += 1


def query(c_name, *args):
    """Call one C entry point that launches nothing (an occupancy query);
    raise on its error; nothing is counted."""
    fn = _FNS.get(c_name)
    if fn is None:
        library()
        fn = _FNS[c_name]
    err = fn(*args, current_stream())
    if err:
        raise RuntimeError(f"{c_name} failed: cudaError {err}")


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_cuda_tensor(name, t, dtype, ndim):
    """Validate what a kernel takes: a contiguous CUDA tensor of dtype (one
    dtype, or a tuple of the dtypes it accepts) and rank; raises instead of
    letting the kernel read garbage."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: expected {' or '.join(map(str, dtypes))}"
                         f", got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
