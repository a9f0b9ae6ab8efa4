#!/usr/bin/env python3
"""Where the policy's card-vs-CPU step check differs on the heatmap head.

    python3 scripts/torch_step_check_diag.py [--slices 0 1 2 3 4 5]

Runs chip_smoke.py's card-vs-CPU training step (dropout 0, injected
order permutations, seeded weights, B = 2 slices of the trainer's first
host batch) and records, on both devices, what the position head reads
and computes:
  * the inputs of the position targets (`final_coord`, `final_mask`,
    `gt_pos`, the robot mask in the sorted frame) and the targets
    themselves (`build_disc_pos_targets`), with the candidates that lie
    within 1e-6 of the 1 cm support radius or under the 1e-4 clamp;
  * the head's input rows, the pre-activation z of `heatmap_mlp_fc1` and
    its cotangent dz, and the leaky-ReLU decisions (z > 0) that differ;
  * the gradient of `heatmap_mlp_fc1.weight` in fp32 on each device, the
    same sum dz^T x in float64 from each device's own rows, and the head
    and position loss recomputed in float64 from each device's rows.
Prints one JSON line per slice and writes chiprun_out/step_check_diag.json.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from robot3dlotus_tpu_torch.models import simple_policy  # noqa: E402

LEAF = "act_proj_head.heatmap_mlp_fc1.weight"


def _rel(a, b, scale=None):
    """max |a - b| over max |b| (or scale)."""
    a, b = a.double(), b.double()
    s = float(b.abs().max()) if scale is None else scale
    return float((a - b).abs().max()) / max(s, 1e-300)


def run_step(cfg, batch, dev):
    """chip_smoke._one_step with recorders on the position head."""
    rec = {}
    build = simple_policy.build_disc_pos_targets

    def targets(batch_, gt_pos, pos_bins, act_cfg, preds):
        out = build(batch_, gt_pos, pos_bins, act_cfg, preds)
        robot = batch_.get("pc_robot_mask")
        if robot is not None:
            robot = torch.gather(robot, 1, preds["sort0"])
        rec.update(coord=preds["final_coord"].detach().cpu(),
                   mask=preds["final_mask"].detach().cpu(),
                   robot=None if robot is None else robot.cpu(),
                   gt_pos=gt_pos.detach().cpu(), target=out.detach().cpu(),
                   sort0=preds["sort0"].detach().cpu())
        return out

    act_cfg = dict(cfg.MODEL.action_config, pos_heatmap_type=cfg.TRAIN_DATASET
                   .get("pos_heatmap_type", "dist"))
    loss_cfg = dict(cfg.MODEL.loss_config)
    model = cs.build_model(cfg.MODEL, device=dev, seed=1)
    opt, _ = cs.build_optimizer(model, dict(cfg.TRAIN))
    trainer = cs.Trainer(model, lambda p, b: cs.compute_loss(p, b, act_cfg,
                                                             loss_cfg),
                         opt, cs.Randomness(0, dev, perms=cs.CHECK_PERMS))
    head = model.act_proj_head
    head0 = copy.deepcopy(head).cpu()          # weights before the update

    def pre(mod, args):
        rec["x"] = args[0].detach().cpu()
        rec["head_mask"] = args[1].detach().cpu()

    def fc1_out(mod, args, out):
        rec["z"] = out.detach().cpu()
        out.register_hook(lambda g: rec.__setitem__("dz", g.detach().cpu()))

    hs = [head.register_forward_pre_hook(pre),
          head.heatmap_mlp_fc1.register_forward_hook(fc1_out)]
    simple_policy.build_disc_pos_targets = targets
    try:
        losses = cs._losses(trainer.step(cs.batch_to_device(batch, dev)))
    finally:
        simple_policy.build_disc_pos_targets = build
        for h in hs:
            h.remove()
    rec["losses"] = losses
    rec["grads"] = {n: p.grad.detach().cpu()
                    for n, p in model.named_parameters()}
    rec["head0"] = head0
    rec["act_cfg"], rec["loss_cfg"] = act_cfg, loss_cfg
    return rec


def head_grad64(rec, batch):
    """The gradient of LEAF from the position and rotation losses
    recomputed in float64 on the CPU from this device's head input rows,
    its targets' inputs and the head's weights before the update."""
    head = copy.deepcopy(rec["head0"]).double()
    head.train()
    x = rec["x"].double()
    xt, xr, xo = head(x, rec["head_mask"])
    preds = {"pos": xt, "rot": xr, "open": xo,
             "final_coord": rec["coord"], "final_mask": rec["mask"],
             "sort0": rec["sort0"]}
    b = cs.batch_to_device(batch, "cpu")
    b["gt_actions"] = b["gt_actions"].double()
    total = cs.compute_loss(preds, b, rec["act_cfg"], rec["loss_cfg"])["total"]
    total.backward()
    return head.heatmap_mlp_fc1.weight.grad


def compare(card, cpu, batch):
    out = {}
    for k in ("coord", "gt_pos"):
        out[f"{k}_max_diff"] = float((card[k].double() -
                                      cpu[k].double()).abs().max())
    out["mask_equal"] = bool(torch.equal(card["mask"], cpu["mask"]))
    out["sort0_equal"] = bool(torch.equal(card["sort0"], cpu["sort0"]))
    out["robot_equal"] = (card["robot"] is None and cpu["robot"] is None) or \
        bool(torch.equal(card["robot"], cpu["robot"]))
    tc, tr = card["target"], cpu["target"]
    out["target_max_diff"] = float((tc - tr).abs().max())
    out["target_support_differs"] = int(((tc > 0) != (tr > 0)).sum())
    # candidates near the 1 cm cut and under the 1e-4 clamp (CPU's inputs)
    pb = rec_bins(cpu)
    shift = (torch.arange(2 * pb, dtype=torch.float32) - pb) * 0.01
    cands = cpu["coord"].float()[..., None] + shift
    d = (cpu["gt_pos"].float()[:, None, :, None] - cands).abs()
    live = cpu["mask"][..., None, None].expand_as(d)
    out["cands_within_1e-6_of_radius"] = int(
        (((d - 0.01).abs() < 1e-6) & live).sum())
    out["cands_under_clamp"] = int(((d < 1e-4) & live).sum())
    # the head's rows and the fc1 kink
    out["x_rel"] = _rel(card["x"], cpu["x"])
    zc, zr = card["z"], cpu["z"]
    m = cpu["head_mask"][..., None].expand_as(zr)
    flip = ((zc > 0) != (zr > 0)) & m
    out["fc1_kink_flips"] = int(flip.sum())
    out["fc1_min_abs_z"] = float(zr[m].abs().min())
    out["z_rel"] = _rel(zc, zr)
    out["dz_rel"] = _rel(card["dz"], cpu["dz"])
    if flip.any():
        rows = flip.nonzero()[:8].tolist()
        out["flips"] = [{"at": r, "z_card": float(zc[tuple(r)]),
                         "z_cpu": float(zr[tuple(r)]),
                         "dz_cpu": float(cpu["dz"][tuple(r)])} for r in rows]
    # the gradient: fp32 on each device, the same rows summed in float64,
    # the head recomputed in float64
    gc, gr = card["grads"][LEAF], cpu["grads"][LEAF]
    gmax = max(float(g.abs().max()) for g in cpu["grads"].values())
    scale = max(float(gr.abs().max()), 1e-3 * gmax)
    s64 = {}
    for name, rec in (("card", card), ("cpu", cpu)):
        dz = rec["dz"].double().reshape(-1, rec["dz"].shape[-1])
        x = rec["x"].double().reshape(-1, rec["x"].shape[-1])
        s64[name] = dz.t() @ x
    h64 = {"card": head_grad64(card, batch), "cpu": head_grad64(cpu, batch)}
    out.update(
        grad_scale=scale,
        card_vs_cpu=_rel(gc, gr, scale),
        card_vs_own_rows_f64=_rel(gc, s64["card"], scale),
        cpu_vs_own_rows_f64=_rel(gr, s64["cpu"], scale),
        rows_f64_card_vs_cpu=_rel(s64["card"], s64["cpu"], scale),
        card_vs_head_f64_cpu_rows=_rel(gc, h64["cpu"], scale),
        cpu_vs_head_f64_cpu_rows=_rel(gr, h64["cpu"], scale),
        card_vs_head_f64_card_rows=_rel(gc, h64["card"], scale),
        cpu_vs_head_f64_card_rows=_rel(gr, h64["card"], scale),
        head_f64_card_vs_cpu_rows=_rel(h64["card"], h64["cpu"], scale))
    rel = {n: float((card["grads"][n] - g).abs().max()) /
           max(float(g.abs().max()), 1e-3 * gmax)
           for n, g in cpu["grads"].items()}
    out["worst"] = sorted(rel.items(), key=lambda t: -t[1])[:5]
    return out


def rec_bins(rec):
    return rec["target"].shape[-1] // rec["coord"].shape[1] // 2


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slices", type=int, nargs="+", default=list(range(6)))
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trainer, batches, _ = cs.build_trainer(cs.train_config(), cs.SPEC,
                                           device="cuda")
    host = next(batches)
    del trainer, batches
    cfg = cs.train_config("MODEL.ptv3_config.attn_drop", "0.0",
                          "MODEL.ptv3_config.proj_drop", "0.0",
                          "MODEL.action_config.dropout", "0.0")
    rows = []
    for i in args.slices:
        batch = {k: v[2 * i:2 * i + 2] for k, v in host.items()}
        card = run_step(cfg, batch, "cuda")
        cpu = run_step(cfg, batch, "cpu")
        row = dict(slice=i, **compare(card, cpu, batch))
        rows.append(row)
        print(json.dumps(row), flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "step_check_diag.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
