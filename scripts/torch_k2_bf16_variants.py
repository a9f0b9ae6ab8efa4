#!/usr/bin/env python3
"""Time variants of K2's bf16 kernel (robot3dlotus_tpu_torch/csrc/conv.cu
subm_conv16_kernel: the bf16 forward and the input gradient on the fp32
owner sums) on one card.

    python3 scripts/torch_k2_bf16_variants.py

Each variant is the source with the tuning constants of `Tc16` rewritten:
for the forward (bf16 x) and the dx (fp32 x) apart the input channels a
stage holds (KC), the ring's stages (NS) and the listed rows a stage
holds (RC); for both the warps' row lanes (WR: WR x 8 / WR warps, 8 WR
output columns each). Every variant is built by its own nvcc
(all started together, `-Xptxas -v` kept) into its own library under
build/k2_variants/; its two entry points stand in for the built library's
(cuda_lib's bound functions), so each call goes through ops/conv.py as
the model's does. The calls are those of one release policy training
step at compute_dtype bfloat16 (B = 32 x 4096; the 9 CPE convs' forwards
and, on their captured cotangents' fp32 owner sums, the mirrored dx) and
of one bf16 predict at B = 1 (the 9 forwards), captured once as
scripts/torch_bf16_kernels_ab.py captures them. Each variant's first
forward and first dx are held to the bf16 bar of ops/bf16.py against the
plain versions and bit-equal across two launches; then CUDA events time
the 9 forwards, the 9 dx and the 9 B = 1 forwards (chip_smoke.cuda_ms:
5 rounds of 2 after a warm-up, 21 of 10 at B = 1), in turns over the
variants twice (v1 .. vn, vn .. v1). Also the share of each dx call's
owner-sum rows that bf16 does not hold (voxels shared by several points,
whose mid and lo pieces are not zero). Prints the card, one JSON line per
variant and writes chiprun_out/k2_bf16_variants.json.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
from robot3dlotus_tpu_torch.ops import conv, cuda_lib, gather  # noqa: E402
from robot3dlotus_tpu_torch.ops.bf16 import bf16_excess  # noqa: E402
from torch_bf16_kernels_ab import CAPTURE  # noqa: E402

SRC = os.path.join(cuda_lib.CSRC, "conv.cu")
OUT = os.path.join(ROOT, "build", "k2_variants")
ENTRIES = ("r3dl_subm_conv_bf16", "r3dl_subm_conv_dx_bf16")
# name: ((forward KC, NS, RC), (dx KC, NS, RC), WR); g1 the release values
VARIANTS = {
    "g1": ((64, 2, 128), (64, 2, 64), 4),
    "g2": ((64, 2, 128), (64, 2, 64), 2),
    "g3": ((32, 3, 128), (32, 3, 64), 4),
    "g4": ((64, 2, 128), (32, 2, 128), 4),
}


def variant_source(fwd, dx, wr):
    src = open(SRC).read()
    for i, name in enumerate(("KC", "NS")):
        src, n = re.subn(rf"static constexpr int {name} = \d+;",
                         f"static constexpr int {name} = kFp32 ? {dx[i]} : "
                         f"{fwd[i]};", src)
        assert n == 1, name
    src, n = re.subn(r"static constexpr int RC = kFp32 \? \d+ : \d+;",
                     f"static constexpr int RC = kFp32 ? {dx[2]} : "
                     f"{fwd[2]};", src)
    assert n == 1, "RC"
    src, n = re.subn(r"static constexpr int WR = \d+;",
                     f"static constexpr int WR = {wr};", src)
    assert n == 1, "WR"
    return src


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
             "-I", cuda_lib.CSRC, "-shared", cu, "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {name}:\n{out[-3000:]}")
        lines = out.splitlines()
        ptxas[name] = [f"{lines[i].split('subm_conv16_kernel')[1][:24]}: "
                       f"{lines[i + 2].strip()}; {lines[i + 3].strip()}"
                       for i in range(len(lines) - 3)
                       if "Compiling entry" in lines[i] and
                       "subm_conv16_kernel" in lines[i]]
        lib = ctypes.CDLL(so)
        fns = {}
        for fn in ENTRIES:
            f = getattr(lib, fn)
            f.argtypes = cuda_lib.SIGNATURES[fn]
            f.restype = ctypes.c_int
            fns[fn] = f
        libs[name] = (lib, fns)
    return libs, ptxas


def dx_args(call):
    (x, idx, ok, w, _), g = call
    centre = idx.shape[-1] // 2
    gv = torch.where(ok[..., centre, None], g, torch.zeros_like(g))
    gsum = gather.scatter_rows_add(gv, idx[..., centre], x.shape[1],
                                   torch.float32)
    return gsum, idx, ok, conv.mirror_weight(w), None


def check(run, plain, what, relative):
    a, b = run(), run()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: two launches differ")
    excess = bf16_excess(a, plain(), relative=relative)
    if excess > 0:
        raise AssertionError(f"{what}: {excess} past the bf16 bar")
    return excess


def main():
    cuda_lib.library()
    path = os.path.join(OUT, "calls.pt")
    os.makedirs(OUT, exist_ok=True)
    subprocess.run([sys.executable, "-c", CAPTURE, ROOT, path], check=True)
    calls = torch.load(path)
    libs, ptxas = build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    fwd = [c[0] for c in calls["k2_step"]]
    dx = [dx_args(c) for c in calls["k2_step"]]
    b1 = calls["k2_b1"]
    # the share of each dx call's owner sums that bf16 does not hold: rows
    # where several points share a voxel (the mid and lo pieces' rows)
    residual = [float((a[0] != a[0].to(torch.bfloat16).float()).any(-1)
                      .float().mean()) for a in dx]
    print(json.dumps({"dx_rows_with_residual": residual}), flush=True)
    groups = {
        "forward_step": (lambda: [conv.subm_conv(*a) for a in fwd],
                         cs.TRAIN_TIMING),
        "dx_step": (lambda: [conv._conv_forward(*a) for a in dx],
                    cs.TRAIN_TIMING),
        "forward_b1": (lambda: [conv.subm_conv(*a) for a in b1], {})}
    res = {name: {"knobs": VARIANTS[name], "ptxas": ptxas[name]}
           for name in VARIANTS}
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for turn, name in enumerate(order):
        cuda_lib._FNS.update(libs[name][1])
        r = res[name]
        if turn < len(VARIANTS):
            r["excess"] = [
                check(lambda: conv.subm_conv(*fwd[0]),
                      lambda: conv.subm_conv_plain(*fwd[0]),
                      f"{name} forward", False),
                check(lambda: conv._conv_forward(*dx[0]),
                      lambda: conv.subm_conv_plain(*dx[0]).to(
                          torch.bfloat16), f"{name} dx", True)]
        for g, (fn, timing) in groups.items():
            r.setdefault(g, []).append(cs.cuda_ms(fn, **timing))
    for name, r in res.items():
        print(json.dumps(r), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k2_bf16_variants.json"),
              "w") as f:
        json.dump({"card": smi, "dx_rows_with_residual": residual,
                   "variants": res}, f, indent=1)
    os.remove(path)
    print(smi)


if __name__ == "__main__":
    main()
