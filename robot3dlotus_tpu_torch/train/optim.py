"""Learning-rate schedule and the AdamW update (port of
robot3dlotus_tpu/train/optim.py `lr_decay_rate`, `decay_mask`,
`flat_adamw` and `build_optimizer` for optim='adamw').

The update is the JAX package's flat_adamw, elementwise: one flat fp32
buffer for the first and one for the second moment, the global-norm clip
over the concatenated gradient, bias-corrected Adam, decoupled weight decay
on the leaves the mask selects, then -lr times a per-leaf multiplier
(lr_multi, 0 for frozen leaves). The schedule is evaluated at the 1-based
step, and the lr is floored at 1e-8 after the decay rate's 1e-5 floor.
"""
from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn as nn

from ..models.layers import MaskedBatchNorm


def lr_decay_rate(step, lr_sched, warmup_steps, num_train_steps,
                  num_cosine_cycles=None, lr_decay_step_size=None,
                  lr_decay_gamma=None):
    """Decay rate at `step` with the 1e-5 floor, in float32 as the JAX
    package evaluates it."""
    f32 = np.float32
    step = f32(step)
    w = f32(max(warmup_steps, 1))
    t = f32(max(num_train_steps, 1))
    if step < w:
        rate = step / w
    elif lr_sched == "linear":
        rate = max(f32(0.0), (t - step) / f32(max(t - w, 1.0)))
    elif lr_sched in ("inverse_sqrt", "noam"):
        rate = np.sqrt(w) * f32(max(step, 1.0)) ** f32(-0.5)
    elif lr_sched == "cosine":
        progress = (step - w) / f32(max(t - w, 1.0))
        rate = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * progress))
    elif lr_sched == "cosine_cycle":
        c = f32(num_cosine_cycles or 1)
        progress = (step - w) / f32(max(t - w, 1.0))
        rate = f32(0.0) if progress >= 1.0 else f32(0.5) * (
            f32(1.0) + np.cos(f32(np.pi) * ((c * progress) % f32(1.0))))
    elif lr_sched == "stepwise":
        rate = f32(lr_decay_gamma) ** np.floor(step / f32(lr_decay_step_size))
    else:
        raise NotImplementedError(lr_sched)
    return float(max(f32(rate), f32(1e-5)))


def lr_schedule(train_cfg):
    """step (1-based, as the training loop logs it) -> lr, floored at
    1e-8."""
    lr = float(train_cfg.get("learning_rate", 1e-4))

    def schedule(step):
        rate = lr_decay_rate(
            step, train_cfg.get("lr_sched", "cosine"),
            train_cfg.get("warmup_steps", 2000),
            train_cfg.get("num_train_steps", 100000),
            num_cosine_cycles=train_cfg.get("num_cosine_cycles"),
            lr_decay_step_size=train_cfg.get("lr_decay_step_size"),
            lr_decay_gamma=train_cfg.get("lr_decay_gamma"))
        return float(max(np.float32(lr) * np.float32(rate), np.float32(1e-8)))

    return schedule


def no_decay_names(model):
    """Parameters without weight decay: every bias and the norms' weight
    (flax `scale`)."""
    names = {n for n, _ in model.named_parameters() if n.endswith("bias")}
    for mname, mod in model.named_modules():
        if isinstance(mod, (nn.LayerNorm, MaskedBatchNorm)):
            names.add(f"{mname}.weight" if mname else "weight")
    return names


def _flax_path(name):
    """'ptv3_model.enc0_block0.attn.qkv.weight' -> the '/'-joined path
    lr_multi fragments and the freeze rule are written against."""
    return name.replace(".", "/")


def lr_multipliers(model, train_cfg):
    """Per-parameter update multiplier: the last matching lr_multi
    fragment, 0 for a leaf of a frozen backbone half (freeze_params
    encoder / decoder)."""
    lr_multi = dict(train_cfg.get("lr_multi") or {})
    freeze = dict(train_cfg.get("freeze_params") or {})
    out = {}
    for name, _ in model.named_parameters():
        path = _flax_path(name)
        m = 1.0
        for frag, mult in lr_multi.items():
            if frag in path:
                m = float(mult)
        if "ptv3_model" in path:
            is_dec = re.search(r"dec\d+_", path) is not None
            if freeze.get("decoder" if is_dec else "encoder"):
                m = 0.0
        out[name] = m
    return out


class FlatAdamW:
    """AdamW over one flat buffer, elementwise the JAX flat_adamw. step()
    reads each parameter's .grad and updates the parameters in place."""

    def __init__(self, named_params, lr_fn, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0, no_decay=(), mults=None, max_norm=None):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.lr_fn, self.b1, self.b2, self.eps = lr_fn, b1, b2, eps
        self.weight_decay, self.max_norm = weight_decay, max_norm
        self.sizes = [p.numel() for p in self.params]
        dev = self.params[0].device
        total = sum(self.sizes)
        self.mu = torch.zeros(total, dtype=torch.float32, device=dev)
        self.nu = torch.zeros(total, dtype=torch.float32, device=dev)
        self.count = 0
        self.wd_mask = self._piecewise(
            [0.0 if n in no_decay else 1.0 for n in self.names], dev)
        mults = mults or {}
        self.mult = self._piecewise([mults.get(n, 1.0) for n in self.names],
                                    dev)

    def _piecewise(self, vals, dev):
        """Per-leaf scalars as a per-element vector; None when all are 1."""
        if all(v == 1.0 for v in vals):
            return None
        return torch.cat([torch.full((s,), float(v), device=dev)
                          for v, s in zip(vals, self.sizes)])

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def _flat(self, tensors):
        return torch.cat([t.reshape(-1).float() for t in tensors])

    @torch.no_grad()
    def step(self):
        g = self._flat([p.grad if p.grad is not None else torch.zeros_like(p)
                        for p in self.params])
        if self.max_norm:
            gnorm = g.square().sum().sqrt()
            g = g * (self.max_norm / gnorm.clamp(min=self.max_norm))
        lr = self.lr_fn(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        self.mu.mul_(b1).add_((1.0 - b1) * g)
        self.nu.mul_(b2).add_((1.0 - b2) * g.square())
        c = np.float32(self.count)
        mhat = self.mu / float(1.0 - np.float32(b1) ** c)
        nuhat = self.nu / float(1.0 - np.float32(b2) ** c)
        u = mhat / (nuhat.sqrt() + self.eps)
        if self.weight_decay:
            dec = self.weight_decay * self._flat(self.params)
            u = u + (dec if self.wd_mask is None else dec * self.wd_mask)
        u = -lr * u
        if self.mult is not None:
            u = u * self.mult
        torch._foreach_add_(self.params, [
            t.view_as(p) for t, p in zip(u.split(self.sizes), self.params)])


def build_optimizer(model, train_cfg):
    """(FlatAdamW over the model's parameters, schedule(step) -> lr). The
    optimizer evaluates the schedule at the 1-based step: its k-th update
    uses schedule(k)."""
    if train_cfg.get("optim", "adamw") != "adamw":
        raise NotImplementedError(
            f"optim={train_cfg.get('optim')!r}: the port has AdamW only")
    if int(train_cfg.get("gradient_accumulation_steps", 1) or 1) > 1:
        raise NotImplementedError("gradient accumulation is not ported")
    schedule = lr_schedule(train_cfg)
    betas = train_cfg.get("betas", [0.9, 0.98])
    grad_norm = train_cfg.get("grad_norm", None)
    opt = FlatAdamW(
        list(model.named_parameters()), lambda count: schedule(count + 1),
        b1=float(betas[0]), b2=float(betas[1]),
        weight_decay=float(train_cfg.get("weight_decay", 0.05)),
        no_decay=no_decay_names(model),
        mults=lr_multipliers(model, train_cfg),
        max_norm=float(grad_norm) if grad_norm else None)
    return opt, schedule
