#!/usr/bin/env python3
"""Time variants of the training attention kernels K5 and K6
(robot3dlotus_tpu_torch/csrc/attention_dropout.cu) on one card.

    python3 scripts/attention_dropout_variants.py

Each variant is the source with its tuning constants rewritten: K6's
query chunk (kChunk, 8-query tiles per phase-1 step) and the blocks per
SM that each kernel's __launch_bounds__ asks for (which caps its
registers). Every variant is built by its own nvcc (all started together,
`-Xptxas -v` kept) into its own library under build/variants/, held
against the plain versions (ops/attention.py) on the first shape at 1e-4
of max|plain|, and timed over the nine attention calls of one release
policy training step (B = 32 clouds x 4096 points, patch 128; (G, H, Dh)
per call from simple_policy_ptv3.yaml: the encoder's (1024, 2, 32),
(576, 4, 32), (256, 8, 32), (128, 16, 32), (64, 32, 24) and the decoder's
(1024, 4, 32), (576, 4, 32), (256, 8, 32), (128, 16, 32); rate 0.1).
CUDA events around the nine calls, median of 7 rounds after a warm-up.
Prints the card, one JSON line per variant and writes
chiprun_out/attention_variants.json.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from robot3dlotus_tpu_torch.ops import attention, cuda_lib  # noqa: E402

SRC = os.path.join(cuda_lib.CSRC, "attention_dropout.cu")
OUT = os.path.join(ROOT, "build", "variants")
STEP = [(1024, 2, 32), (576, 4, 32), (256, 8, 32), (128, 16, 32),
        (64, 32, 24), (1024, 4, 32), (576, 4, 32), (256, 8, 32),
        (128, 16, 32)]
P, RATE, SEED = 128, 0.1, 12345
# name: (K6 chunk, K5 blocks per SM, K6 blocks per SM)
VARIANTS = {"chunk1": (1, 2, 2), "chunk2": (2, 2, 2), "chunk4": (4, 2, 2),
            "bwd_1block": (2, 2, 1), "bwd_1block_chunk4": (4, 2, 1),
            "fwd_1block": (2, 1, 2)}


def variant_source(chunk, fwd_blocks, bwd_blocks):
    src = open(SRC).read()
    src, n = re.subn(r"constexpr int kChunk = \d+;",
                     f"constexpr int kChunk = {chunk};", src)
    head, fwd, bwd = src.split("__launch_bounds__(kThreads, 2)")
    assert n == 1
    return (head + f"__launch_bounds__(kThreads, {fwd_blocks})" + fwd +
            f"__launch_bounds__(kThreads, {bwd_blocks})" + bwd)


def build_all():
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, knobs in VARIANTS.items():
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(*knobs))
        so = os.path.join(OUT, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v",
             "-shared", cu, "-o", so], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {name}:\n{out[-3000:]}")
        # registers and spills of the Dh = 32 instances
        lines = out.splitlines()
        ptxas[name] = [f"{'bwd' if 'bwd' in lines[i] else 'fwd'}: "
                       f"{lines[i + 1].strip()}; {lines[i + 2].strip()}"
                       for i in range(len(lines) - 2)
                       if "Compiling entry" in lines[i] and "ILi32E" in
                       lines[i]]
        lib = ctypes.CDLL(so)
        for fn in ("r3dl_attention_dropout_fwd", "r3dl_attention_dropout_bwd"):
            getattr(lib, fn).argtypes = cuda_lib.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, ptxas


def inputs():
    g = torch.Generator(device="cuda").manual_seed(0)
    calls = []
    for G, H, Dh in STEP:
        q, k, v = (torch.randn(G, H, P, Dh, device="cuda", generator=g)
                   for _ in range(3))
        gout = 1e-3 * torch.randn(G, H, P, Dh, device="cuda", generator=g)
        kv = torch.rand(G, P, device="cuda", generator=g) > 0.1
        kv[0] = False
        out, lse = torch.empty_like(q), q.new_empty(G, H, P)
        bits = torch.empty(G, H, P, P // 32, dtype=torch.int32, device="cuda")
        grads = [torch.empty_like(q) for _ in range(3)]
        calls.append((q, k, v, kv, gout, out, lse, bits, grads, Dh ** -0.5))
    return calls


def launchers(lib, calls):
    stream = cuda_lib.current_stream()
    thresh, inv_keep = attention.keep_threshold(RATE), 1.0 / (1.0 - RATE)

    def fwd():
        for q, k, v, kv, _, out, lse, bits, _, scale in calls:
            G, H, _, Dh = q.shape
            err = lib.r3dl_attention_dropout_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), kv.data_ptr(),
                out.data_ptr(), lse.data_ptr(), bits.data_ptr(), G, H, P, Dh,
                scale, SEED, thresh, inv_keep, stream)
            assert err == 0, err

    def bwd():
        for q, k, v, kv, gout, out, lse, bits, grads, scale in calls:
            G, H, _, Dh = q.shape
            err = lib.r3dl_attention_dropout_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), kv.data_ptr(),
                out.data_ptr(), lse.data_ptr(), bits.data_ptr(),
                gout.data_ptr(), *(t.data_ptr() for t in grads), G, H, P, Dh,
                scale, inv_keep, stream)
            assert err == 0, err
    return fwd, bwd


def events_ms(fn, rounds=7):
    fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def check(calls):
    """The first call's outputs against the plain versions."""
    q, k, v, kv, gout, out, lse, bits, grads, scale = calls[0]
    p_out, p_lse, p_bits = attention.patch_attention_dropout_fwd_plain(
        q, k, v, kv, scale, RATE, SEED)
    want = attention.patch_attention_dropout_bwd_plain(
        q, k, v, kv, out, lse, bits, gout, scale, RATE)
    errs = [float((a - b).abs().max()) / float(b.abs().max())
            for a, b in zip((out, *grads), (p_out, *want))]
    if not torch.equal(bits, p_bits) or max(errs) > 1e-4:
        raise AssertionError(f"variant differs from the plain version: "
                             f"{errs}, bits equal {torch.equal(bits, p_bits)}")
    return max(errs)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    libs, ptxas = build_all()
    calls = inputs()
    rows = {name: {"variant": name, "knobs": VARIANTS[name],
                   "k5_ms_per_step": [], "k6_ms_per_step": [],
                   "ptxas_dh32": ptxas[name]} for name in libs}
    for name, lib in libs.items():
        fwd, bwd = launchers(lib, calls)
        fwd()
        bwd()
        rows[name]["max_rel_err"] = check(calls)
    # two passes, the second in reverse order
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            fwd, bwd = launchers(libs[name], calls)
            rows[name]["k5_ms_per_step"].append(events_ms(fwd))
            rows[name]["k6_ms_per_step"].append(events_ms(bwd))
    rows = list(rows.values())
    for row in rows:
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "attention_variants.json"),
              "w") as f:
        json.dump({"device": smi, "variants": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
