#!/usr/bin/env python3
"""Time variants of K7's and K6's bf16 kernels on one card.

    python3 scripts/torch_k7_k6_bf16_variants.py

K7 (robot3dlotus_tpu_torch/csrc/conv_grad.cu, r3dl_conv_weight_grad_bf16):
each variant is the source with its constants rewritten: the listed rows a
CPE stage holds at bf16 (rows_per_stage), the ring's stages (kStages) and
the cloud rows a stem stage holds (kRK16), with the wrapper's plan aiming
at a multiple of WGRAD_TARGET_BLOCKS (ops/conv.py
WGRAD_BF16_TARGET_BLOCKS, set for the variant's turns). K6
(csrc/attention_dropout.cuh, r3dl_attention_dropout_bwd_bf16): the bf16 pieces of p and ds that its dv,
dk and dq products take (mma_pieces: 3, the release; 2 without lo; 1, hi
alone), so that the cost of each piece shows. Every variant is built by
its own nvcc (all started together, `-Xptxas -v` kept) into its own
library under build/k7_k6_variants/; its entry point stands in for the
built library's (cuda_lib's bound functions), so each call goes through
ops/conv.py and ops/attention.py as the model's does. The calls are those
of one release policy training step at compute_dtype bfloat16 (B = 32 x
4096: K7 on the 9 CPE convs and on the stem; K6 on the 9 attention calls,
from one K5 launch and the captured cotangents), captured once as
scripts/torch_bf16_kernels_ab.py captures them. Each K7 variant's first
CPE and stem calls are held within 1e-4 of the plain version's largest
value and bit-equal across two launches, each K6 variant's first call
against the bf16 bar of ops/bf16.py (its excess reported: fewer pieces
may not hold it); then CUDA events time the 9 CPE calls, the stem call
and the 9 K6 calls (chip_smoke.cuda_ms, 5 rounds of 2 after a warm-up),
in turns over the variants twice (v1 .. vn, vn .. v1). Prints the card,
one JSON line per variant and writes
chiprun_out/k7_k6_bf16_variants.json.
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
from robot3dlotus_tpu_torch.ops import attention, conv, cuda_lib  # noqa
from robot3dlotus_tpu_torch.ops.bf16 import bf16_excess  # noqa: E402
from torch_bf16_kernels_ab import CAPTURE  # noqa: E402

OUT = os.path.join(ROOT, "build", "k7_k6_variants")
K7_ENTRY = "r3dl_conv_weight_grad_bf16"
K6_ENTRY = "r3dl_attention_dropout_bwd_bf16"
# K7: name -> (CPE rows a stage, stages in the ring, stem rows a stage,
# the plan's blocks in WGRAD_TARGET_BLOCKS); k7a the release values
K7_VARIANTS = {"k7a": (128, 2, 64, 6), "k7b": (64, 2, 64, 6),
               "k7c": (64, 3, 64, 6), "k7d": (128, 2, 32, 6),
               "k7e": (128, 2, 64, 1), "k7f": (128, 2, 64, 2),
               "k7g": (128, 2, 64, 4), "k7h": (128, 2, 64, 8)}
# K6: name -> the pieces of p and ds; k6a the release
K6_VARIANTS = {"k6a": 3, "k6b": 2, "k6c": 1}
PIECES = ("  r3dl::mma_bf16(d, lo, b0, b1);\n",
          "  r3dl::mma_bf16(d, mid, b0, b1);\n")


def k7_source(rows, stages, stem_rows):
    src = open(os.path.join(cuda_lib.CSRC, "conv_grad.cu")).read()
    for pat, new in (
            (r"std::is_same<T, float>::value \? 64 : \d+;",
             f"std::is_same<T, float>::value ? 64 : {rows};"),
            (r"constexpr int kStages = \d+;",
             f"constexpr int kStages = {stages};"),
            (r"constexpr int kRK16 = \d+;",
             f"constexpr int kRK16 = {stem_rows};")):
        src, n = re.subn(pat, new, src)
        assert n == 1, pat
    return src


def k6_source(pieces):
    """The release entry points with the kernels' header inlined, K6 bf16
    with `pieces` bf16 pieces of p and ds."""
    src = open(os.path.join(cuda_lib.CSRC, "attention_dropout.cu")).read(
    ).replace('#include "attention_dropout.cuh"', open(os.path.join(
        cuda_lib.CSRC, "attention_dropout.cuh")).read())
    for line in PIECES[:3 - pieces]:
        assert src.count(line) == 1, line
        src = src.replace(line, "")
    return src


def build_all():
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    sources = {**{n: (k7_source(*v[:3]), K7_ENTRY, "wgrad")
                  for n, v in K7_VARIANTS.items()},
               **{n: (k6_source(v), K6_ENTRY, "attn_drop_bwd16")
                  for n, v in K6_VARIANTS.items()}}
    for name, (src, entry, kernel) in sources.items():
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(OUT, f"{name}.so")
        procs[name] = (so, entry, kernel, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v",
             "-I", cuda_lib.CSRC, "-shared", cu, "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns, ptxas = {}, {}
    for name, (so, entry, kernel, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {name}:\n{out[-3000:]}")
        lines = out.splitlines()
        ptxas[name] = [f"{lines[i].split(kernel)[1][:30]}: "
                       f"{lines[i + 2].strip()}; {lines[i + 3].strip()}"
                       for i in range(len(lines) - 3)
                       if "Compiling entry" in lines[i] and
                       kernel in lines[i] and "bfloat16" in lines[i]]
        f = getattr(ctypes.CDLL(so), entry)
        f.argtypes = cuda_lib.SIGNATURES[entry]
        f.restype = ctypes.c_int
        fns[name] = (entry, f)
    return fns, ptxas


def main():
    cuda_lib.library()
    path = os.path.join(OUT, "calls.pt")
    os.makedirs(OUT, exist_ok=True)
    subprocess.run([sys.executable, "-c", CAPTURE, ROOT, path], check=True)
    calls = torch.load(path)
    fns, ptxas = build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cpe = [(*c[0][:3], c[1]) for c in calls["k2_step"]]
    stem = [(*c[0][:3], c[1]) for c in calls["stem_step"]]
    k6 = calls["k6"]
    release = {e: cuda_lib._FNS[e] for e in (K7_ENTRY, K6_ENTRY)}
    target = conv.WGRAD_BF16_TARGET_BLOCKS
    res = {}
    for variants, groups in (
            (K7_VARIANTS, {"cpe_step": cpe, "stem_step": stem}),
            (K6_VARIANTS, {"k6_step": k6})):
        order = list(variants) + list(variants)[::-1]
        for turn, name in enumerate(order):
            entry, fn = fns[name]
            cuda_lib._FNS[entry] = fn
            r = res.setdefault(name, {"knobs": variants[name],
                                      "ptxas": ptxas[name]})
            if variants is K7_VARIANTS:
                conv.WGRAD_BF16_TARGET_BLOCKS = \
                    variants[name][3] * conv.WGRAD_TARGET_BLOCKS
            if turn < len(variants):
                r["check"] = check(name, groups)
            for g, args in groups.items():
                run = (attention.patch_attention_dropout_bwd
                       if g == "k6_step" else conv.conv_weight_grad)
                r.setdefault(g, []).append(cs.cuda_ms(
                    lambda: [run(*a) for a in args], **cs.TRAIN_TIMING))
        cuda_lib._FNS.update(release)
        conv.WGRAD_BF16_TARGET_BLOCKS = target
    for name, r in res.items():
        print(json.dumps({name: r}), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k7_k6_bf16_variants.json"),
              "w") as f:
        json.dump({"card": smi, "variants": res}, f, indent=1)
    os.remove(path)
    print(smi)


def check(name, groups):
    """K7: fp32 sums bit-equal across two launches, within 1e-4 of the
    plain version's largest value; K6: bit-equal across two launches, the
    excess over the bf16 bar of each gradient (<= 0 holds it)."""
    out = {}
    for g, args in groups.items():
        a = args[0]
        if g == "k6_step":
            got = [attention.patch_attention_dropout_bwd(*a) for _ in "ab"]
            want = attention.patch_attention_dropout_bwd_plain(*a)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(*got)), name
            out[g] = [bf16_excess(x, y.to(torch.bfloat16), relative=True)
                      for x, y in zip(got[0], want)]
        else:
            got = [conv.conv_weight_grad(*a) for _ in "ab"]
            want = conv.conv_weight_grad_plain(*a)
            torch.cuda.synchronize()
            assert torch.equal(*got), name
            err = float((got[0] - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), (name, g, err)
            out[g] = err
    return out


if __name__ == "__main__":
    main()
