"""Helpers of the bf16 paths (ptv3_config compute_dtype bfloat16): the
bf16 value of a Python float, and the bar a bf16 kernel is held to
against its plain version.

The kernels K1, K2 and K3 sum in fp32 and round to bf16 once per output
(K1 also rounds q * scale and its probabilities where the reference
does); their plain versions do the same arithmetic with the sums taken in
another order. So an output may land on the neighbouring bf16 value: the
bar is one bf16 ulp of the larger of the two values, plus `slack` (the
fp32 kernels' bar, 1e-4) times max(1, max |plain|) for the fp32 sums'
order before the rounding, which is what a value near zero can show.
K1 also rounds each probability to bf16 before P v, and a probability
computed in another order may land on the neighbouring bf16 value: its
bar adds one bf16 ulp of every probability's share, 2^-7 sum_j p_j |v_j|
(ops/attention.py bf16_probability_allowance). The backward kernels at
bf16 (K2's input gradient, K5 / K6, K8's rounded sums) are held to the
same bar, with the slack taken of the gradient's own scale.
"""
from __future__ import annotations

import functools

import torch

BF16_SLACK = 1e-4


@functools.lru_cache(maxsize=None)
def bf16_value(x):
    """The Python float x rounded to bf16 (to nearest even)."""
    return float(torch.tensor(x, dtype=torch.bfloat16))


def bf16_ulp(t):
    """The spacing of bf16 values at |t| (elementwise, fp32): 2^(e - 8) for
    |t| in [2^(e - 1), 2^e); that of the smallest normal at 0."""
    a = t.float().abs().clamp(min=torch.finfo(torch.bfloat16).tiny)
    _, e = torch.frexp(a)
    return torch.ldexp(torch.ones_like(a), e - 8)


def bf16_excess(got, want, slack=BF16_SLACK, extra=None, relative=False):
    """max(|got - want| - bar) over the elements, bar = one bf16 ulp of
    max(|got|, |want|) + slack * max(1, max |want|) (+ `extra`, an
    elementwise allowance); <= 0 where the bar holds everywhere. With
    `relative` the slack is taken of max |want| itself: gradients, whose
    scale is far below 1 in training, are held to their own scale."""
    got, want = got.float(), want.float()
    if want.numel() == 0:
        return 0.0
    top = float(want.abs().max())
    scale = top if relative else max(1.0, top)
    bar = bf16_ulp(torch.maximum(got.abs(), want.abs())) + slack * scale
    if extra is not None:
        bar = bar + extra
    return float(((got - want).abs() - bar).max())
