#!/usr/bin/env python3
"""Time the bf16 paths of K1, K5, K2, K6, K7, K8, K3, K9 and K10 of two
trees of the PyTorch port on one card, in turns, on the same captured
main-path calls.

    python3 scripts/torch_bf16_kernels_ab.py PARENT_ROOT CHANGE_ROOT \
        [--order pccp] [--yardsticks] [--rows all|smallc]

Each root is a checkout of the repo (e.g. `git archive` of a commit
unpacked into a git-ignored directory). First a process of the second
root captures, with chip_smoke.py's recorders, the kernel calls of one
`Actioner.predict` of the release policy at compute_dtype bfloat16 (B = 1,
seed-0 weights, chip_smoke's first synthetic observation: K1's and K2's
calls) and of one training step of the release trainer at bf16 (B = 32 x
4096 on synthetic_reach, release dropout: K5's calls, and K2's, the
stem's and the unpools' K4 calls with their cotangents; K6's calls are
K5's with the outputs of one K5 launch of that tree and the captured
cotangent), and saves them under build/bf16_ab/. Each turn of --order
(p: the first root, c: the second) is then a fresh Python process with
that root first on sys.path, which loads the calls and times that tree's
kernels on them: CUDA events (chip_smoke.cuda_ms; the B = 1 calls the
median of 21 rounds of 10, the training calls of 5 rounds of 2) and the
profiler's device time (chip_smoke.device_ms), summed per forward or per
step: K1 and K2 at B = 1; K5 (patch_attention_dropout_fwd), K2's forward
and the mirrored K2 on the fp32 owner sums (the input gradient's launch,
conv._conv_forward), K6 (patch_attention_dropout_bwd), K7 on the 9 CPE
convs and K7 on the stem call apart (conv.conv_weight_grad; its device
time with and without the CPE path's live-list compaction) per training
step; K8 (gather.scatter_rows_add) on the 4 unpools' backwards (the
captured K4 calls' bf16 cotangents) and on the 9 conv owner sums (fp32
sums, as each tree's conv_input_grad prepares them: the parent's masked
copy of the cotangent is timed with it), and the same 13
calls on the cotangents widened to fp32 (the fp32 K8); K3 at bf16
(stem.stem_conv) on the step's B = 32 call, on that call with no link
live and with every link live (what skipping dead tap pairs saves and
what multiplying every pair costs), and on the predict's B = 1 call.
The K8 and K3 rows' device time is every kernel of the call (a memset, a
rounding pass, a mask pass or a padding pass included), also split by
kernel. The capture also records, for each K8 call, how its indices
collide (chip_smoke.k8_collisions: the share of live rows whose index is
not their own row, of destinations with more than one source, the most
sources of one destination, runs) and K3's and K8's bytes bounds; the
second root must have chip_smoke.k8_collisions. With --yardsticks the
first turn also times the plain versions, index_add_ in bf16 (K8) and
the im2col gather + matmul in bf16 (K3).

The small-C rows (all of them with --rows all, only them with --rows
smallc): a second capture, of the motion planner at bf16, takes K9's bf16
calls (gather.gather_rows_smallc, the categorical stem's) of one GT
pipeline request (B = 1) and of one training step (B = 32 x 512,000 rows,
C = 5), and the step's categorical stem call; K10 bf16
(gather.scatter_rows_smallc_add) then runs on the two stems' input
gradients as chip_smoke's bf16-stem-vjp and bf16-mp-stem-vjp phases make
them: the policy stem's G = g W^T (stem.stem_grad_rows, C = 7) and a
seeded bf16 cotangent at the planner stem's index (C = 5), each also with
no link live (every index the sentinel n) and with every link live (each
sentinel replaced by a seeded index in [0, n)), so that the stream of g
and the adds are timed apart. Each turn checks K9 bit-equal to its plain
version and K10 within the bar of ops/bf16.py, times every kernel of the
call (a padding pass or the ranges' sum included) by events and by the
profiler, and records, from that tree's built library, the `nvcc -Xptxas
-v` registers and spills of the small-C kernels and the shared-memory,
global and atomic instructions of their SASS (`cuobjdump -sass`).

The options rows (--rows opts, alone): a capture of one training step
of the release trainer with chip_smoke's ATTN_OPTS (fp32) and one with
BF16_ATTN_OPTS (bf16) takes K5's calls with the attention options (K6's
from one K5 launch of the second root and the captured cotangent); each
turn times K5 and K6 with the options on them and the release K5 and K6
on the same tensors without the options (the options' cost in one run),
times each with the head scale alone and the bias alone, records K6's
blocks an SM where the tree has the query
(attention.bwd_opts_blocks_per_sm), and times K3 and K2 on the calls of
one predict at fp32 and at bf16 (B = 1) and K3 on the step's B = 32 stem
call at both dtypes (what a row's fixed order of sums costs). Every
kernel of a call is timed (the ranges' sum included). K1's options rows:
the K1 calls of one predict (B = 1) of the options policy at fp32, at
bf16 and on the mixed route (bf16 with upcast_attention), and of one
eval-mode forward of each options trainer's model on the step's B = 32
batch (the mixed route's from the bf16 calls, q and k widened): each
timed with both options, the head scale alone, the bias alone and as
the release K1 (v widened for the mixed route), and, in a tree with two
plans for the bias (attention.attention_opts_plan), with both options
under each plan forced. With --yardsticks the
first turn adds, per B = 32 call set, the plain version, SDPA with the
bias as its mask and that mask's build, and the bound. Turn `s` (in
--order) is the first root with K1's bias lookups replaced by a
constant (attention_tile.cuh LogitOpts::bias returns 0: the options'
staging and the scale's product stay), made under build/k1_stage from
that root; it times the K1 rows alone.

One JSON line per turn is printed and all of them are written to
chiprun_out/bf16_kernels_ab.json, with the card's name and power limit.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CAPTURE = r"""
import json, os, sys
import numpy as np
import torch
root, path, rows = sys.argv[1], sys.argv[2], sys.argv[3]
sys.path.insert(0, root)
os.chdir(root)
import chip_smoke as cs
from robot3dlotus_tpu_torch.ops import stem
torch.backends.cuda.matmul.allow_tf32 = False


def policy_step(sites):
    trainer, batches, _ = cs.build_trainer(cs.train_config(*cs.BF16_OPTS),
                                           cs.SPEC, device="cuda")
    host, _ = cs.host_batches(batches, 1)
    if hasattr(batches, "close"):
        batches.close()
    return cs.capture(lambda: trainer.step(cs.batch_to_device(host[0],
                                                               "cuda")),
                      sites)


def policy_calls():
    actioner = cs.Actioner(cs.CONFIG, cli_opts=cs.CLI_OPTS + cs.BF16_OPTS,
                           device="cuda", seed=0)
    actioner.rng = np.random.default_rng(0)
    obs = [cs.synthetic_observation(100)]
    serving = cs.capture_main_path(
        lambda: actioner.predict(**cs.requests(obs)[0]))
    del actioner
    step = policy_step(cs.TRAIN_SITES)
    k6 = []
    for (q, k, v, kv, scale, rate, seed), g in step["attention"]:
        out, lse, bits = cs.attention.patch_attention_dropout_fwd(
            q, k, v, kv, scale, rate, seed)
        k6.append((q, k, v, kv, out, lse, bits, g, scale, rate))
    calls = {"k1": serving["patch_attention"], "k2_b1": serving["subm_conv"],
             "k5": [c for c, _ in step["attention"]], "k6": k6,
             "k2_step": [c for c in step["subm_conv"] if c[1] is not None],
             "stem_step": [c for c in step["stem_conv"] if c[1] is not None],
             "k3_b1": serving["stem_conv"],
             "k8_unpool": [(g, idx, x.shape[1])
                           for (x, idx), g in step["gather_rows"]
                           if g is not None]}
    meta = {"k8_unpool": [], "k8_owner": [], "k3": []}
    for g, idx, n in calls["k8_unpool"]:
        B, M, D = g.shape
        meta["k8_unpool"].append(dict(
            cs.k8_collisions(idx, n), shape=[B, M, D, n],
            bound_ms=1e3 * (2 * g.numel() + 2 * B * n * D + idx.numel() *
                            idx.element_size()) / cs.HBM_BYTES_PER_S))
    for (x, idx, ok, w, _), g in calls["k2_step"]:
        B, N, D = g.shape
        c = idx.shape[-1] // 2
        meta["k8_owner"].append(dict(
            cs.k8_collisions(idx[..., c], N, ok[..., c]), shape=[B, N, D, N],
            bound_ms=1e3 * (2 * g.numel() + 4 * B * N * D + 4 * B * N +
                            B * N) / cs.HBM_BYTES_PER_S))
    for key, cc in (("k3_step", [c for c, _ in calls["stem_step"]]),
                    ("k3_b1", calls["k3_b1"])):
        for x, idx, ok, w in cc:
            B, N, _ = x.shape
            K, cin, cout = w.shape
            meta["k3"].append(dict(
                call=key, shape=[B, N, K, cin, cout],
                shares=cs.stem_shares(ok), live_links=int(ok.sum()),
                bound_ms=cs._bound(2 * (x.numel() + w.numel() + B * N * cout)
                                   + 5 * idx.numel(), 2 * cin * cout *
                                   int(ok.sum()), cs.BF16_FLOPS_PER_S)[0]))
    return calls, meta


def smallc_calls(calls, meta):
    # K9 bf16 on the planner's categorical stem: one GT pipeline request
    # (B = 1) and one training step (B = 32), whose stem call gives K10
    # its C = 5 index; K10 bf16 as bf16_stem_vjp_phase and
    # bf16_mp_stem_vjp_phase make its calls
    e16 = cs.MotionPlannerEngine(cs.MP_CONFIG, cli_opts=cs.BF16_OPTS,
                                 device="cuda", seed=0)
    req = cs.capture(lambda: cs.mp_episode(
        cs.mp_pipeline(e16), [cs.synthetic_observation(200)], 0),
        cs.SMALLC_SITES)
    del e16
    trainer, batches, _ = cs.build_trainer(cs.mp_config(*cs.BF16_OPTS),
                                           cs.train_motion_planner.SPEC,
                                           device="cuda")
    host, _ = cs.host_batches(batches, 1)
    if hasattr(batches, "close"):
        batches.close()
    mstep = cs.capture(lambda: trainer.step(cs.batch_to_device(host[0],
                                                                "cuda")),
                       cs.SMALLC_SITES + cs.MP_STEM_SITES)
    del trainer, host
    for key, cap in (("k9_b1", req), ("k9_step", mstep)):
        calls[key] = [a for a, _ in cap["gather_rows_smallc"]
                      if a[0].dtype == torch.bfloat16]
    (x, idx, ok, w), g = calls["stem_step"][0]
    x, w, g = (t.to(torch.bfloat16) for t in (x, w, g))
    G, flat = stem.stem_grad_rows(g, idx, ok, w, x.shape[1])
    calls["k10_c7"] = [(G.contiguous(), flat.contiguous(), x.shape[1])]
    (feat, nmap, w, _), _ = mstep["categorical_conv"][0]
    B, N, C = feat.shape
    flat = torch.where(nmap.ok, nmap.idx, N).reshape(B, -1)
    calls["k10_c5"] = [(cs._seeded((B, flat.shape[1], C + 1), 16).to(
        torch.bfloat16), flat.contiguous(), N)]
    meta["smallc"] = {}
    for key in ("k9_b1", "k9_step"):
        meta["smallc"][key] = [dict(
            shape=[*x.shape, idx.shape[1]], index=str(idx.dtype),
            live_share=float(((idx >= 0) & (idx < x.shape[1])).float()
                             .mean()),
            bound_ms=1e3 * (2 * (x.numel() + x.shape[0] * idx.shape[1] *
                                 x.shape[2]) + idx.numel() *
                            idx.element_size()) / cs.HBM_BYTES_PER_S)
            for x, idx in calls[key]]
    for key in ("k10_c7", "k10_c5"):
        meta["smallc"][key] = [dict(
            shape=[*g.shape, n], index=str(idx.dtype),
            live_share=float(((idx >= 0) & (idx < n)).float().mean()),
            bound_ms=1e3 * (2 * (g.numel() + g.shape[0] * n * g.shape[2]) +
                            idx.numel() * idx.element_size())
            / cs.HBM_BYTES_PER_S) for g, idx, n in calls[key]]


def opts_calls():
    # K5 / K6 with the options on one options step at each dtype; K3 and
    # K2 at B = 1 (one predict) and K3 on the B = 32 step, each dtype
    calls, meta = {}, {"opts": {}}
    for tag, opts in (("fp32", cs.ATTN_OPTS), ("bf16", cs.BF16_ATTN_OPTS)):
        trainer, batches, _ = cs.build_trainer(cs.train_config(*opts),
                                               cs.SPEC, device="cuda")
        host, _ = cs.host_batches(batches, 1)
        if hasattr(batches, "close"):
            batches.close()
        step = cs.capture(
            lambda: trainer.step(cs.batch_to_device(host[0], "cuda")),
            [(cs.layers, "patch_attention_dropout", "attention")] +
            [s for s in cs.TRAIN_SITES if s[2] == "stem_conv"])
        # K1 with the options on one eval forward at B = 32
        trainer.model.eval()
        with torch.no_grad():
            fwd = cs.capture(lambda: trainer.model(cs.batch_to_device(
                host[0], "cuda")), [(cs.layers, "patch_attention", "k1")])
        calls["k1_b32_" + tag] = [c for c, _ in fwd["k1"]]
        del trainer, host, fwd
        k5, k6 = [], []
        for (q, k, v, kv, scale, rate, seed, hs, rpe), g in \
                step["attention"]:
            out, lse, bits = cs.attention.patch_attention_dropout_fwd(
                q, k, v, kv, scale, rate, seed, hs, rpe)
            k5.append((q, k, v, kv, scale, rate, seed, hs, rpe))
            k6.append((q, k, v, kv, out, lse, bits, g, scale, rate, hs, rpe))
        calls["k5_opts_" + tag], calls["k6_opts_" + tag] = k5, k6
        calls["k3_step_" + tag] = [c for c, _ in step["stem_conv"]
                                   if c is not None]
        meta["opts"][tag] = [list(c[0].shape) for c in k5]
        del step
        base = cs.CLI_OPTS + (cs.BF16_OPTS if tag == "bf16" else [])
        actioner = cs.Actioner(cs.CONFIG, cli_opts=base, device="cuda",
                               seed=0)
        actioner.rng = np.random.default_rng(0)
        serving = cs.capture_main_path(lambda: actioner.predict(
            **cs.requests([cs.synthetic_observation(100)])[0]))
        calls["k3_b1_" + tag] = serving["stem_conv"]
        calls["k2_b1_" + tag] = serving["subm_conv"]
        del actioner, serving
    # K1 with the options: one predict of the options policy (B = 1), at
    # fp32, bf16 and on the mixed route; the mixed route's B = 32 calls
    # are the bf16 ones with q and k widened
    for tag, opts in (("fp32", cs.ATTN_OPTS), ("bf16", cs.BF16_ATTN_OPTS),
                      ("mixed", cs.BF16_ATTN_OPTS + cs.UPCAST_OPTS)):
        actioner = cs.Actioner(cs.CONFIG, cli_opts=cs.CLI_OPTS + opts,
                               device="cuda", seed=0)
        actioner.rng = np.random.default_rng(0)
        calls["k1_b1_" + tag] = cs.capture_main_path(lambda: actioner.predict(
            **cs.requests([cs.synthetic_observation(100)])[0]))[
                "patch_attention"]
        del actioner
    calls["k1_b32_mixed"] = [(q.float(), k.float(), v, *c)
                             for q, k, v, *c in calls["k1_b32_bf16"]]
    meta["k1"] = {key: [list(c[0].shape) for c in calls[key]]
                  for key in calls if key.startswith("k1_")}
    return calls, meta


if rows == "opts":
    calls, meta = opts_calls()
    torch.save(calls, path)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    print({k: len(v) for k, v in calls.items()}, flush=True)
    sys.exit(0)
if rows == "smallc":
    step = policy_step([s for s in cs.TRAIN_SITES if s[2] == "stem_conv"])
    calls = {"stem_step": [c for c in step["stem_conv"] if c[1] is not None]}
    meta = {}
    del step
else:
    calls, meta = policy_calls()
smallc_calls(calls, meta)
torch.save(calls, path)
with open(path + ".json", "w") as f:
    json.dump(meta, f)
print({k: len(v) for k, v in calls.items()}, flush=True)
"""

TURN = r"""
import json, os, subprocess, sys
import torch
root, path, only_k1 = sys.argv[1], sys.argv[2], sys.argv[4] == "1"
sys.path.insert(0, root)
os.chdir(root)
import chip_smoke as cs
from robot3dlotus_tpu_torch.ops import attention, conv, gather, stem
torch.backends.cuda.matmul.allow_tf32 = False
cs.cuda_lib.library()
calls = torch.load(path)
yardsticks = sys.argv[3] == "1"
train = dict(rounds=5, reps=2, warmup=1)


def timed(runs, name, also=(), timing=None):
    ms = [cs.cuda_ms(r, **(timing or {})) for r in runs]
    dev = [cs.device_ms(r, name, reps=4, also=also) for r in runs]
    return {"ms": sum(ms), "device_ms": None if None in dev else sum(dev),
            "calls": len(runs), "ms_per_call": ms, "device_per_call": dev}


def dx_run(call):
    (x, idx, ok, w, _), g = call
    centre = idx.shape[-1] // 2
    gv = torch.where(ok[..., centre, None], g, torch.zeros_like(g))
    gsum = gather.scatter_rows_add(gv, idx[..., centre], x.shape[1],
                                   torch.float32)
    wm = conv.mirror_weight(w)
    return lambda: conv._conv_forward(gsum, idx, ok, wm, None)


def device_all(fn, reps=4, windows=5):
    # Device time per call of every kernel (memset and copies included)
    # that fn launches, from one profiler window: each kernel's mean time
    # times its launches per call (the profiler may drop some records);
    # and that time by kernel name.
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = cs._device_events(prof.key_averages())
        if ev:
            by = {e.key[:60]: cs._dev_us(e) / e.count * max(
                1, round(e.count / reps)) / 1e3 for e in ev}
            return sum(by.values()), by
    return None, {}


def timed_all(runs, timing):
    ms = [cs.cuda_ms(r, **timing) for r in runs]
    dev, by = [], {}
    for r in runs:
        t, names = device_all(r)
        dev.append(t)
        for k, v in names.items():
            by[k] = by.get(k, 0.0) + v
    return {"ms": sum(ms), "device_ms": None if None in dev else sum(dev),
            "calls": len(runs), "ms_per_call": ms, "device_per_call": dev,
            "device_by_kernel": by}


def owner_run(call, dtype):
    # The owner sum of one conv's input gradient as this tree's
    # conv_input_grad prepares it, on the cotangent in `dtype`.
    (x, idx, ok, w, _), g = call
    g, N = g.to(dtype), x.shape[1]
    if hasattr(conv, "owner_index"):   # the sentinel owner, no mask pass
        return lambda: gather.scatter_rows_add(g, conv.owner_index(idx, ok),
                                               N, torch.float32)
    centre = idx.shape[-1] // 2
    valid, owner = ok[..., centre], idx[..., centre]
    return lambda: gather.scatter_rows_add(
        torch.where(valid[..., None], g, torch.zeros_like(g)).contiguous(),
        owner, N, torch.float32)


def policy_rows(res):
    res.update({
        "k1_b1": timed([lambda a=c: attention.patch_attention(*a)
                        for c in calls["k1"]], "patch_attention_kernel"),
        "k2_b1": timed([lambda a=c: conv.subm_conv(*a)
                        for c in calls["k2_b1"]], *cs.K2_PROFILE),
        "k5_step": timed([lambda a=c: attention.patch_attention_dropout_fwd(
            *a) for c in calls["k5"]], "attn_drop_fwd", timing=train),
        "k2_forward_step": timed([lambda a=c[0]: conv.subm_conv(*a)
                                  for c in calls["k2_step"]],
                                 *cs.K2_PROFILE, timing=train),
        "k2_dx_step": timed([dx_run(c) for c in calls["k2_step"]],
                            *cs.K2_PROFILE, timing=train),
        "k6_step": timed([lambda a=c: attention.patch_attention_dropout_bwd(
            *a) for c in calls["k6"]], "attn_drop_bwd", timing=train)})
    for key, cs_calls in (("k7_cpe_step", calls["k2_step"]),
                          ("k7_stem_step", calls["stem_step"])):
        runs = [lambda a=c[0][:3], g=c[1]: conv.conv_weight_grad(*a, g)
                for c in cs_calls]
        res[key] = timed(runs, *cs.K7_PROFILE, timing=train)
        prod = [cs.device_ms(r, cs.K7_PROFILE[0], reps=4) for r in runs]
        res[key]["product_device_ms"] = None if None in prod else sum(prod)
    for dtype, tag in ((torch.bfloat16, ""), (torch.float32, "_fp32")):
        unpool = [lambda a=(g.to(dtype), idx, n): gather.scatter_rows_add(*a)
                  for g, idx, n in calls["k8_unpool"]]
        owner = [owner_run(c, dtype) for c in calls["k2_step"]]
        res["k8_unpool_step" + tag] = timed_all(unpool, train)
        res["k8_owner_step" + tag] = timed_all(owner, train)
    res["k3_step"] = timed_all([lambda a=c[0]: stem.stem_conv(*a)
                                for c in calls["stem_step"]], train)
    # the same call with no link live (the map's reads and the pairs' tests
    # alone) and with every link live (every pair multiplied): what
    # skipping or compacting dead pairs could save
    for key, live in (("k3_step_dead", False), ("k3_step_live", True)):
        runs = []
        for (x, idx, ok, w), _ in calls["stem_step"]:
            okv = torch.full_like(ok, live)
            idc = idx.clamp(0, x.shape[1] - 1)
            runs.append(lambda a=(x, idc, okv, w): stem.stem_conv(*a))
        res[key] = timed_all(runs, train)
    res["k3_b1"] = timed_all([lambda a=c: stem.stem_conv(*a)
                              for c in calls["k3_b1"]], {})
    if yardsticks:
        ys = {}
        k8 = [(g, idx, n) for g, idx, n in calls["k8_unpool"]] + [
            (g, idx[..., idx.shape[-1] // 2], x.shape[1])
            for (x, idx, ok, w, _), g in calls["k2_step"]]
        ys["k8_plain_ms"] = sum(cs.cuda_ms(
            lambda a=c: gather.scatter_rows_add_plain(*a), **cs.PLAIN_TIMING)
            for c in k8)
        ys["k8_index_add_bf16_ms"] = sum(cs.cuda_ms(cs._index_add(*c),
                                                    **train) for c in k8)
        for key, cc, timing in (("k3_step", [c[0] for c in
                                             calls["stem_step"]], train),
                                ("k3_b1", calls["k3_b1"], {})):
            ys[key + "_plain_ms"] = sum(cs.cuda_ms(
                lambda a=c: stem.stem_conv_plain(*a), **timing) for c in cc)
            ys[key + "_im2col_bf16_ms"] = sum(cs.cuda_ms(cs._im2col(*c),
                                                         **timing)
                                              for c in cc)
        res["yardsticks"] = ys


def sass_counts():
    # What this tree's small-C kernels compiled to: per kernel (demangled
    # name), the count of each shared-memory, global, atomic, shuffle,
    # vote and barrier instruction in `cuobjdump -sass` of the library,
    # and ptxas's registers and spills.
    import re
    import shutil
    so = cs.cuda_lib.build()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True).stdout
    counts, fn = {}, None
    keep = re.compile(r"^(ATOMS|ATOM|RED|LDS|STS|LDG|STG|LDL|STL|SHFL|VOTE|"
                      r"BAR|POPC|FLO|MATCH)\b")
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "smallc" in m.group(1) else None
            if fn:
                counts[fn] = {}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]+)",
                      line)
        if fn and m and keep.match(m.group(1)):
            counts[fn][m.group(1)] = counts[fn].get(m.group(1), 0) + 1
    usage = {k: v for k, v in cs.ptxas_usage().items() if "smallc" in k}
    return {"sass": counts, "ptxas": usage}


def smallc_rows(res):
    # K9 bf16 (bit-equal to its plain version) and K10 bf16 (within the
    # bar of ops/bf16.py) on the captured calls; every kernel of a call
    # timed by events and by the profiler; K10 also with no link live and
    # with every link live
    gen = torch.Generator(device="cuda").manual_seed(5)
    for key in ("k9_b1", "k9_step"):
        runs = []
        for x, idx in calls[key]:
            if not torch.equal(gather.gather_rows_smallc(x, idx),
                               gather.gather_rows_smallc_plain(x, idx)):
                raise AssertionError(f"{key}: K9 not bit-equal to plain")
            runs.append(lambda a=(x, idx): gather.gather_rows_smallc(*a))
        res[key] = timed_all(runs, train if key == "k9_step" else {})
    for key in ("k10_c7", "k10_c5"):
        variants = {key: calls[key], key + "_dead": [], key + "_live": []}
        for g, idx, n in calls[key]:
            live = (idx >= 0) & (idx < n)
            variants[key + "_dead"].append((g, torch.full_like(idx, n), n))
            variants[key + "_live"].append((g, torch.where(
                live, idx, torch.randint(0, n, idx.shape, generator=gen,
                                         device="cuda", dtype=idx.dtype)),
                n))
        for name, cc in variants.items():
            runs = []
            for g, idx, n in cc:
                cs._bf16_err(gather.scatter_rows_smallc_add(g, idx, n),
                             gather.scatter_rows_smallc_add_plain(
                                 g, idx, n).to(g.dtype), f"{name}: K10")
                runs.append(lambda a=(g, idx, n):
                            gather.scatter_rows_smallc_add(*a))
            res[name] = timed_all(runs, train)
    res["smallc_build"] = sass_counts()


def digest(outs):
    # a digest of the bits of every tensor of outs (None left out): two
    # trees' outputs on the same calls are bit-equal iff their digests are
    import hashlib
    h = hashlib.sha1()
    for t in outs:
        if torch.is_tensor(t):
            h.update(t.detach().contiguous().view(torch.uint8).cpu()
                     .numpy().tobytes())
        elif isinstance(t, tuple):
            h.update(digest(t).encode())
    return h.hexdigest()


def opts_rows(res):
    # K5 / K6 with the options and the release K5 / K6 on the same
    # tensors (and the digests of their outputs); K6's blocks an SM; K3 /
    # K2 at B = 1 and K3 at B = 32
    for tag in ("fp32", "bf16"):
        k5, k6 = calls["k5_opts_" + tag], calls["k6_opts_" + tag]
        res["bits_" + tag] = {
            "k5_opts": digest(attention.patch_attention_dropout_fwd(*c)
                              for c in k5),
            "k5_release": digest(attention.patch_attention_dropout_fwd(
                *c[:7]) for c in k5),
            "k6_opts": digest(attention.patch_attention_dropout_bwd(*c)
                              for c in k6),
            "k6_release": digest(attention.patch_attention_dropout_bwd(
                *c[:10]) for c in k6)}
        res["k5_opts_" + tag] = timed(
            [lambda a=c: attention.patch_attention_dropout_fwd(*a)
             for c in k5], "attn_drop_fwd", timing=train)
        res["k5_release_" + tag] = timed(
            [lambda a=c[:7]: attention.patch_attention_dropout_fwd(*a)
             for c in k5], "attn_drop_fwd", timing=train)
        res["k6_opts_" + tag] = timed(
            [lambda a=c: attention.patch_attention_dropout_bwd(*a)
             for c in k6], "attn_drop_bwd", timing=train)
        res["k6_release_" + tag] = timed(
            [lambda a=c[:10]: attention.patch_attention_dropout_bwd(*a)
             for c in k6], "attn_drop_bwd", timing=train)
        # each option alone: what the head scale and the bias cost apart
        for part, keep in (("scale", (True, False)), ("rpe", (False, True))):
            res[f"k5_{part}_{tag}"] = timed(
                [lambda a=c[:7], o=(c[7] if keep[0] else None,
                                    c[8] if keep[1] else None):
                 attention.patch_attention_dropout_fwd(*a, *o) for c in k5],
                "attn_drop_fwd", timing=train)
            res[f"k6_{part}_{tag}"] = timed(
                [lambda a=c[:10], o=(c[10] if keep[0] else None,
                                     c[11] if keep[1] else None):
                 attention.patch_attention_dropout_bwd(*a, *o) for c in k6],
                "attn_drop_bwd", timing=train)
        if hasattr(attention, "bwd_opts_blocks_per_sm"):
            dt = torch.bfloat16 if tag == "bf16" else torch.float32
            res["k6_opts_blocks_per_sm_" + tag] = {
                str(Dh): attention.bwd_opts_blocks_per_sm(dt, Dh)
                for Dh in (8, 16, 24, 32)}
        res["k3_step_" + tag] = timed_all(
            [lambda a=c: stem.stem_conv(*a) for c in calls["k3_step_" + tag]],
            train)
        res["k3_b1_" + tag] = timed_all(
            [lambda a=c: stem.stem_conv(*a) for c in calls["k3_b1_" + tag]],
            {})
        res["k2_b1_" + tag] = timed_all(
            [lambda a=c: conv.subm_conv(*a) for c in calls["k2_b1_" + tag]],
            {})


K1_NAMES = ("patch_attention_kernel", "patch_attention_bias_kernel")


def k1_rows(res):
    # K1 on the options calls: both options, each alone, and the release
    # K1 on the same tensors (v widened on the mixed route); with
    # --yardsticks, per B = 32 set, the plain version, SDPA with the bias
    # as its mask, the mask's build and the bound
    # a tree with two plans for the bias also times each one forced
    plans = ("tile", "inline") if hasattr(attention,
                                          "attention_opts_plan") else ()
    for key in sorted(k for k in calls if k.startswith("k1_")):
        timing = train if "b32" in key else {}
        for part in ("opts", "scale", "rpe", "release") + plans:
            runs = []
            for q, k, v, kv, scale, hs, rpe in calls[key]:
                if part == "release" and q.dtype != v.dtype:
                    v = v.float()
                if part in plans:
                    tile = part == "tile"
                    split = attention.attention_query_split(
                        *q.shape[:3], attention.OPTS_MAX_WARPS if tile
                        else attention.ATTN_MAX_WARPS)
                    runs.append(lambda a=(q, k, v, kv, scale, *split),
                                o=dict(head_scale=hs, rpe=rpe, tile=tile):
                                attention.patch_attention_split(*a, **o))
                    continue
                o = {"opts": (hs, rpe), "scale": (hs, None),
                     "rpe": (None, rpe), "release": (None, None)}[part]
                runs.append(lambda a=(q, k, v, kv, scale) + o:
                            attention.patch_attention(*a))
            res[f"{key}_{part}"] = timed(runs, K1_NAMES, timing=timing)
            res[f"{key}_{part}"]["bits"] = digest(r() for r in runs)
        if yardsticks and "b32" in key:
            ys, bound = {"plain_ms": 0.0, "library_ms": 0.0,
                         "bias_build_ms": 0.0}, 0.0
            for q, k, v, kv, scale, hs, rpe in calls[key]:
                ys["plain_ms"] += cs.cuda_ms(
                    lambda a=(q, k, v, kv, scale, hs, rpe):
                    attention.patch_attention_plain(*a), **cs.PLAIN_TIMING)
                build, mask, qs, sc = cs._library_attention(
                    q, k, v.to(q.dtype), kv, scale, hs, rpe)
                ys["library_ms"] += cs.cuda_ms(
                    lambda a=(qs, k, v.to(q.dtype)), m=mask, s=sc:
                    torch.nn.functional.scaled_dot_product_attention(
                        *a, attn_mask=m, scale=s), **train)
                ys["bias_build_ms"] += cs.cuda_ms(build, **train)
                G, H, P, Dh = q.shape
                nbytes = 3 * q.element_size() * q.numel() + \
                    v.element_size() * v.numel() + cs._opt_nbytes(
                        q, kv, hs, rpe)
                flops = 4 * G * H * P * P * Dh
                bound += (cs._bound(nbytes, flops, cs.BF16_FLOPS_PER_S)
                          if q.dtype == torch.bfloat16 else
                          cs._bound(nbytes, 3 * flops,
                                    cs.TF32_FLOPS_PER_S))[0]
            ys["bound_ms"] = bound
            res[key + "_yardsticks"] = ys


res = {}
if only_k1:
    k1_rows(res)
elif "k5_opts_fp32" in calls:
    opts_rows(res)
    k1_rows(res)
else:
    if "k1" in calls:
        policy_rows(res)
    smallc_rows(res)
print(json.dumps(res), flush=True)
"""


def stage_tree(root, here):
    """A copy of root's port and chip_smoke.py under build/k1_stage with
    LogitOpts::bias returning 0 (K1's options staging without its
    lookups)."""
    import shutil
    dst = os.path.join(here, "build", "k1_stage")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "robot3dlotus_tpu_torch"),
                    os.path.join(dst, "robot3dlotus_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(root, "chip_smoke.py"), dst)
    tile = os.path.join(dst, "robot3dlotus_tpu_torch", "csrc",
                        "attention_tile.cuh")
    with open(tile) as f:
        src = f.read()
    lookup = "return __fadd_rn(__fadd_rn(tab[r.x], tab[r.y]), tab[r.z]);"
    if lookup not in src:
        raise SystemExit(f"{tile}: no bias lookup to replace")
    with open(tile, "w") as f:
        f.write(src.replace(lookup, "return 0.f;"))
    return dst


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--order", default="pccp",
                    help="turns: p the first root, c the second, s the "
                    "first with K1's bias lookups replaced (--rows opts)")
    ap.add_argument("--yardsticks", action="store_true",
                    help="also time the plain versions and the library "
                    "calls of K8 and K3 in the first turn")
    ap.add_argument("--rows", choices=("all", "smallc", "opts"),
                    default="all",
                    help="smallc: only the K9 and K10 rows; opts: the "
                    "options' K5 / K6 rows and K3 / K2 at B = 1 and 32")
    args = ap.parse_args()
    roots = {"p": os.path.abspath(args.parent),
             "c": os.path.abspath(args.change)}
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if "s" in args.order:
        roots["s"] = stage_tree(roots["p"], here)
    store = os.path.join(here, "build", "bf16_ab")
    os.makedirs(store, exist_ok=True)
    path = os.path.join(store, "calls.pt")
    subprocess.run([sys.executable, "-c", CAPTURE, roots["c"], path,
                    args.rows], check=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    with open(path + ".json") as f:
        meta = json.load(f)
    print(json.dumps(meta), flush=True)
    turns = []
    for i, t in enumerate(args.order):
        out = subprocess.run([sys.executable, "-c", TURN, roots[t], path,
                              "1" if args.yardsticks and i == 0 else "0",
                              "1" if t == "s" else "0"],
                             check=True, capture_output=True, text=True)
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["turn"] = t
        turns.append(res)
        print(json.dumps({k: (v if not isinstance(v, dict) or
                              "ms" not in v else
                              {x: v[x] for x in ("ms", "device_ms")})
                          for k, v in res.items() if k != "smallc_build"}),
              flush=True)
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "bf16_kernels_ab.json"),
              "w") as f:
        json.dump({"card": smi, "roots": roots, "calls": meta,
                   "turns": turns}, f, indent=1)
    os.remove(path)
    os.remove(path + ".json")
    print(smi)


if __name__ == "__main__":
    main()
