"""Learning-rate schedule and the optimizers (port of
robot3dlotus_tpu/train/optim.py: `lr_decay_rate`, `decay_mask`,
`flat_adamw`, `scale_by_radam_ref`, `scale_by_ralamb_ref`,
`lookahead_ref` and `build_optimizer` with its whole menu, and
optax.MultiSteps for TRAIN.gradient_accumulation_steps).

Every optimizer keeps its state in flat fp32 buffers over the parameters
in named_parameters() order and runs a handful of whole-buffer ops a
step; per-leaf quantities (weight-decay mask, lr multipliers, freeze) are
per-element vectors built once, and per-tensor norms (Ralamb's trust
ratio) come from one torch._foreach_norm over views of a buffer (summed
in fp64), with no host sync. Each step is the JAX chain in its order: the
global-norm clip, the core transformation, the lr multipliers, the freeze
mask (a multiplier of 0). The schedule is evaluated at the 1-based update count,
and the lr is floored at 1e-8 after the decay rate's 1e-5 floor.

  adamw (fused_optim, the default): the JAX flat_adamw, elementwise (its
    clip g * max_norm / max(|g|, max_norm)); fused_optim False is the
    optax chain, which gives the same update, so the port runs the same
    FlatAdamW and writes the chain's checkpoint layout;
  adam, adamax: optax.adam / optax.adamax (no weight decay, eps 1e-8);
  radam: upstream's RAdam, N_SMA rectification, decoupled decay under
    the mask, then -lr;
  ralamb: the RAdam step with a per-tensor trust ratio clamp(|p|, 0, 10) /
    |candidate p|, 1 where either norm is 0; the lr lives inside it;
  rangerlars: Lookahead over ralamb (every lookahead_k updates the slow
    weights move lookahead_alpha of the way to the fast ones and the fast
    ones snap to them; the slow weights are first taken at the first
    sync, which is then a no-op);
  gradient_accumulation_steps k > 1: MultiSteps, the running mean of k
    micro-step gradients handed to the optimizer every k-th micro-step;
    the parameters and the optimizer's count (so the lr schedule) stay
    put in between.

Each optimizer writes and reads its state in the JAX build_optimizer's
layout (state_tree / load_tree, the buffers moved by convert.StateLayout).
"""
from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn as nn

from ..models.layers import MaskedBatchNorm


def _count(n):
    return np.asarray(n, np.int32)


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


class _FlatOptimizer:
    """The parameter list, its flat views and per-leaf vectors; step()
    reads each parameter's .grad and updates the parameters in place.
    Subclasses give _update (flat fp32 gradient -> flat update, advancing
    count) and _core_tree / _load_core (the core transformation's optax
    state); chain_tail names the JAX chain's links after the core
    ("lr_multi", "freeze"), whose states are empty."""

    def __init__(self, named_params, lr_fn, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0, no_decay=(), mults=None, max_norm=None,
                 chain_tail=()):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.lr_fn, self.b1, self.b2, self.eps = lr_fn, b1, b2, eps
        self.weight_decay, self.max_norm = weight_decay, max_norm
        self.chain_tail = tuple(chain_tail)
        self.sizes = [p.numel() for p in self.params]
        self.total = sum(self.sizes)
        self.device = self.params[0].device
        self._sizes = torch.as_tensor(self.sizes, device=self.device)
        self.count = 0
        self.wd_mask = self._piecewise(
            [0.0 if n in no_decay else 1.0 for n in self.names])
        mults = mults or {}
        self.mult = self._piecewise([mults.get(n, 1.0) for n in self.names])

    def _zeros(self):
        return torch.zeros(self.total, dtype=torch.float32,
                           device=self.device)

    def _piecewise(self, vals):
        """Per-leaf scalars as a per-element vector; None when all are 1."""
        if all(v == 1.0 for v in vals):
            return None
        return torch.cat([torch.full((s,), float(v), device=self.device)
                          for v, s in zip(vals, self.sizes)])

    def _leaf_norms(self, flat):
        """Each leaf's L2 norm of a flat buffer, (L,) fp32, from one
        multi-tensor norm over the views accumulated in fp64 (an fp32
        norm of a 16M-element leaf is off by ~1e-3 on the CPU)."""
        return torch.stack(torch._foreach_norm(
            list(flat.double().split(self.sizes)))).float()

    def _per_leaf(self, vec):
        """(L,) per-leaf values -> the per-element vector."""
        return torch.repeat_interleave(vec, self._sizes,
                                       output_size=self.total)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def _flat(self, tensors):
        return torch.cat([t.reshape(-1).float() for t in tensors])

    def grads(self):
        """The parameters' gradients as one flat fp32 vector (zeros where
        a parameter has none)."""
        return self._flat([p.grad if p.grad is not None
                           else torch.zeros_like(p) for p in self.params])

    def _decay(self):
        """wd * p on the leaves the mask selects, None without decay."""
        if not self.weight_decay:
            return None
        dec = self.weight_decay * self._flat(self.params)
        return dec if self.wd_mask is None else dec * self.wd_mask

    def _clip(self, g):
        """optax.clip_by_global_norm."""
        if not self.max_norm:
            return g
        gnorm = g.square().sum().sqrt()
        return torch.where(gnorm < self.max_norm, g,
                           g / gnorm * self.max_norm)

    @torch.no_grad()
    def step(self):
        self.apply(self.grads())

    @torch.no_grad()
    def apply(self, g):
        """One update from the flat gradient g: clip, core, multipliers,
        then added to the parameters."""
        u = self._update(self._clip(g))
        if self.mult is not None:
            u = u * self.mult
        torch._foreach_add_(self.params, [
            t.view_as(p) for t, p in zip(u.split(self.sizes), self.params)])

    def state_tree(self, layout):
        """The optax chain's state as flax writes it (numpy leaves): the
        clip's when max_norm, the core's, then chain_tail's."""
        links = ([{}] if self.max_norm else []) + [self._core_tree(layout)]
        links += [{"inner_state": {}} if name == "freeze" else {}
                  for name in self.chain_tail]
        return {str(i): v for i, v in enumerate(links)}

    def load_tree(self, state, layout):
        self._load_core(state["1" if self.max_norm else "0"], layout)


class _Moments(_FlatOptimizer):
    """A flat optimizer with fp32 first and second moments mu, nu; its
    core state is optax's moments then the schedule's count."""

    def __init__(self, named_params, lr_fn, **kw):
        super().__init__(named_params, lr_fn, **kw)
        self.mu, self.nu = self._zeros(), self._zeros()

    def _bias1(self):
        return float(1.0 - np.float32(self.b1) ** np.float32(self.count))

    def _moments_tree(self, layout):
        return {"count": _count(self.count), "mu": layout.tree(self.mu),
                "nu": layout.tree(self.nu)}

    def _load_moments(self, state, layout):
        self.count = int(state["count"])
        layout.load_tree(state["mu"], self.mu)
        layout.load_tree(state["nu"], self.nu)

    def _core_tree(self, layout):
        return {"0": self._moments_tree(layout),
                "1": {"count": _count(self.count)}}

    def _load_core(self, core, layout):
        self._load_moments(core["0"], layout)


class Adam(_Moments):
    """optax.adam: bias-corrected moments, no weight decay."""

    def _adam(self, g):
        """Advances the count and the moments -> mhat / (sqrt(nuhat) +
        eps)."""
        self.count += 1
        self.mu.mul_(self.b1).add_((1.0 - self.b1) * g)
        self.nu.mul_(self.b2).add_((1.0 - self.b2) * g.square())
        c = np.float32(self.count)
        nuhat = self.nu / float(1.0 - np.float32(self.b2) ** c)
        return self.mu / self._bias1() / (nuhat.sqrt() + self.eps)

    def _update(self, g):
        lr = self.lr_fn(self.count)
        return -lr * self._adam(g)


class FlatAdamW(Adam):
    """AdamW over one flat buffer, elementwise the JAX flat_adamw (its clip
    g * max_norm / max(|g|, max_norm)); `fused` names the checkpoint
    layout, flat_adamw's flat one or the optax chain's."""

    def __init__(self, named_params, lr_fn, fused=True, **kw):
        super().__init__(named_params, lr_fn, **kw)
        self.fused = fused

    def _clip(self, g):
        if not self.max_norm:
            return g
        gnorm = g.square().sum().sqrt()
        return g * (self.max_norm / gnorm.clamp(min=self.max_norm))

    def _update(self, g):
        lr = self.lr_fn(self.count)
        u = self._adam(g)
        dec = self._decay()
        return -lr * (u if dec is None else u + dec)

    def state_tree(self, layout):
        if self.fused:
            return layout.flat_adamw(self)
        return super().state_tree(layout)

    def load_tree(self, state, layout):
        if self.fused:
            layout.load_flat_adamw(state, self)
        else:
            super().load_tree(state, layout)

    def _core_tree(self, layout):
        """optax.adamw: the moments, the decay mask's, the schedule's."""
        return {"0": self._moments_tree(layout), "1": {"inner_state": {}},
                "2": {"count": _count(self.count)}}


class Adamax(_Moments):
    """optax.adamax: the first moment bias-corrected over an infinity-norm
    second moment max(|g| + eps, b2 * nu)."""

    def _update(self, g):
        lr = self.lr_fn(self.count)
        self.count += 1
        self.mu.mul_(self.b1).add_((1.0 - self.b1) * g)
        torch.maximum(g.abs() + self.eps, self.nu * self.b2, out=self.nu)
        return -lr * (self.mu / self._bias1() / self.nu)


def radam_coeffs(count, b1, b2):
    """(n_sma, step_size) of upstream's RAdam at the 1-based count, in
    float32 as the JAX _radam_coeffs: step_size folds the rectification
    and 1 / (1 - b1^t) when n_sma >= 5, else is 1 / (1 - b1^t)."""
    f32 = np.float32
    t = f32(count)
    b2t = f32(b2) ** t
    n_max = f32(2.0 / (1.0 - b2) - 1.0)
    n_sma = n_max - f32(2.0) * t * b2t / (f32(1.0) - b2t)
    bias1 = f32(1.0) - f32(b1) ** t
    if n_sma < 5.0:
        return float(n_sma), float(f32(1.0) / bias1)
    rect = np.sqrt(
        (f32(1.0) - b2t) * (n_sma - f32(4.0)) / (n_max - f32(4.0))
        * (n_sma - f32(2.0)) / n_sma * n_max / (n_max - f32(2.0)))
    step_size = rect / bias1
    return float(n_sma), float(f32(step_size))


class RAdam(_Moments):
    """Upstream's RAdam (the JAX scale_by_radam_ref, then -lr)."""

    def _moments(self, g):
        """Moments at the next count -> (rectified step, step size)."""
        self.mu.mul_(self.b1).add_((1.0 - self.b1) * g)
        self.nu.mul_(self.b2).add_((1.0 - self.b2) * g * g)
        n_sma, step_size = radam_coeffs(self.count + 1, self.b1, self.b2)
        step = self.mu / (self.nu.sqrt() + self.eps) if n_sma >= 5.0 \
            else self.mu
        return step, step_size

    def _update(self, g):
        lr = self.lr_fn(self.count)
        step, step_size = self._moments(g)
        self.count += 1
        out = step_size * step
        dec = self._decay()
        if dec is not None:
            out = out + dec
        return -lr * out


class Ralamb(RAdam):
    """Upstream's Ralamb (the JAX scale_by_ralamb_ref): the RAdam step
    scaled per tensor by the trust ratio clamp(|p|, 0, 10) / |p_dec -
    lr * ss * step|; the update is new_p - p."""

    def _update(self, g):
        f32 = np.float32
        lr = f32(self.lr_fn(self.count))
        step, step_size = self._moments(g)
        self.count += 1
        p = self._flat(self.params)
        p_dec = p
        if self.weight_decay:
            dec = float(f32(self.weight_decay) * lr) * p
            p_dec = p - (dec if self.wd_mask is None else dec * self.wd_mask)
        lr_ss = float(lr * f32(step_size))
        cand = p_dec - lr_ss * step
        radam_norm = self._leaf_norms(cand)
        weight_norm = self._leaf_norms(p).clamp(0.0, 10.0)
        trust = torch.where((weight_norm == 0.0) | (radam_norm == 0.0),
                            torch.ones_like(weight_norm),
                            weight_norm / radam_norm)
        new_p = p_dec - lr_ss * self._per_leaf(trust) * step
        return new_p - p

    def _core_tree(self, layout):
        return self._moments_tree(layout)

    def _load_core(self, core, layout):
        self._load_moments(core, layout)


class Lookahead:
    """Upstream's Lookahead over a flat optimizer (the JAX lookahead_ref):
    fast = p + the base's update; every k-th update slow += alpha * (fast
    - slow) and the update becomes slow - p. Until the first sync the slow
    weights follow the fast ones (the JAX state's copy), so that sync
    takes them as they are."""

    def __init__(self, base, alpha=0.5, k=6):
        self.base, self.alpha, self.k = base, float(alpha), int(k)
        self.count = 0
        self.initialized = False
        self.slow = base._flat(base.params).detach()

    def _update(self, g):
        du = self.base._update(g)
        p = self.base._flat(self.base.params)
        fast = p + du
        self.count += 1
        if self.count % self.k:
            if not self.initialized:
                self.slow.copy_(fast)
            return du
        if self.initialized:
            self.slow.add_(self.alpha * (fast - self.slow))
        else:                      # slow = fast: the first sync moves nothing
            self.slow.copy_(fast)
            self.initialized = True
        return self.slow - p

    def _core_tree(self, layout):
        return {"count": _count(self.count),
                "initialized": np.asarray(self.initialized, bool),
                "slow": layout.tree(self.slow),
                "inner": self.base._core_tree(layout)}

    def _load_core(self, core, layout):
        self.count = int(core["count"])
        self.initialized = bool(core["initialized"])
        layout.load_tree(core["slow"], self.slow)
        self.base._load_core(core["inner"], layout)


class RangerLars(Lookahead, _FlatOptimizer):
    """Lookahead over Ralamb: the wrapper holds the chain's clip and
    multipliers, the Ralamb base the moments and the decay mask."""

    def __init__(self, named_params, lr_fn, alpha=0.5, k=6, b1=0.9,
                 b2=0.999, eps=1e-8, weight_decay=0.0, no_decay=(), **kw):
        _FlatOptimizer.__init__(self, named_params, lr_fn, **kw)
        base = Ralamb(named_params, lr_fn, b1=b1, b2=b2, eps=eps,
                      weight_decay=weight_decay, no_decay=no_decay)
        Lookahead.__init__(self, base, alpha, k)


class MultiSteps:
    """optax.MultiSteps(every_k_schedule=k) around a flat optimizer: each
    micro-step folds its gradient into the fp32 running mean acc += (g -
    acc) / (mini_step + 1); the k-th hands the mean to the optimizer and
    clears it. The parameters and the optimizer's count stay put on the
    micro-steps in between."""

    def __init__(self, inner, every_k):
        self.inner, self.k = inner, int(every_k)
        self.mini_step = 0
        self.gradient_step = 0
        self.acc = inner._zeros()

    def __getattr__(self, name):   # names, params, sizes, count, ...
        return getattr(self.__dict__["inner"], name)

    def zero_grad(self):
        self.inner.zero_grad()

    @torch.no_grad()
    def step(self):
        g = self.inner.grads()
        self.acc.add_((g - self.acc) / float(self.mini_step + 1))
        if self.mini_step == self.k - 1:
            self.inner.apply(self.acc)
            self.acc.zero_()
            self.gradient_step += 1
        self.mini_step = (self.mini_step + 1) % self.k

    def state_tree(self, layout):
        return {"mini_step": _count(self.mini_step),
                "gradient_step": _count(self.gradient_step),
                "inner_opt_state": self.inner.state_tree(layout),
                "acc_grads": layout.tree(self.acc), "skip_state": {}}

    def load_tree(self, state, layout):
        self.mini_step = int(state["mini_step"])
        self.gradient_step = int(state["gradient_step"])
        layout.load_tree(state["acc_grads"], self.acc)
        self.inner.load_tree(state["inner_opt_state"], layout)


OPTIMIZERS = ("adamw", "adam", "adamax", "radam", "ralamb", "rangerlars")


def build_optimizer(model, train_cfg):
    """(optimizer over the model's parameters, schedule(step) -> lr) for
    TRAIN.optim in OPTIMIZERS, wrapped in MultiSteps when
    gradient_accumulation_steps > 1. The optimizer evaluates the schedule
    at the 1-based update count: its k-th update uses schedule(k)."""
    name = train_cfg.get("optim", "adamw")
    if name not in OPTIMIZERS:
        raise ValueError(f"optim={name!r}: one of {OPTIMIZERS}")
    schedule = lr_schedule(train_cfg)
    betas = train_cfg.get("betas", [0.9, 0.98])
    grad_norm = train_cfg.get("grad_norm", None)
    freeze = dict(train_cfg.get("freeze_params") or {})
    tail = ((["lr_multi"] if train_cfg.get("lr_multi") else [])
            + (["freeze"] if freeze.get("encoder") or freeze.get("decoder")
               else []))
    kw = dict(b1=float(betas[0]), b2=float(betas[1]),
              mults=lr_multipliers(model, train_cfg),
              max_norm=float(grad_norm) if grad_norm else None,
              chain_tail=tail)
    if name in ("adamw", "radam", "ralamb", "rangerlars"):
        kw.update(weight_decay=float(train_cfg.get("weight_decay", 0.05)),
                  no_decay=no_decay_names(model))
    named = list(model.named_parameters())
    lr_fn = lambda count: schedule(count + 1)  # noqa: E731
    if name == "adamw":
        opt = FlatAdamW(named, lr_fn,
                        fused=bool(train_cfg.get("fused_optim", True)), **kw)
    elif name == "rangerlars":
        opt = RangerLars(
            named, lr_fn, alpha=float(train_cfg.get("lookahead_alpha", 0.5)),
            k=int(train_cfg.get("lookahead_k", 6)), **kw)
    else:
        opt = {"adam": Adam, "adamax": Adamax, "radam": RAdam,
               "ralamb": Ralamb}[name](named, lr_fn, **kw)
    accum = int(train_cfg.get("gradient_accumulation_steps", 1) or 1)
    if accum > 1:
        opt = MultiSteps(opt, accum)
    return opt, schedule
