"""The card-vs-CPU step check and the leaky-ReLU kink of the action head.

chip_smoke.py runs one training step of the policy on the card and on the
CPU and holds every gradient at 1e-3 of its scale. On some slices the
heatmap head's `heatmap_mlp_fc1.weight` gradient differed by up to 1.7e-3:
the two devices round the backbone differently (~1e-6 relative), and a
pre-activation of that layer within rounding of 0 then falls on either side
of the leaky ReLU's kink, which moves that element's gradient by a factor
of 50 (slope 0.02). These tests show the cause on the CPU, with the action
head of both packages on the same weights, and hold the step check's
repair (chip_smoke.LeakyReluDecisions: the CPU run takes the card's branch
at such a tie) against the JAX package's gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GRAD_TOL, KINK_TOL, MAX_KINKS, LeakyReluDecisions
from robot3dlotus_tpu.models.heads import ActionHead as JaxActionHead
from robot3dlotus_tpu_torch.models.heads import ActionHead

HID, PB, RES, B, N = 16, 3, 30, 2, 24
FC = ("heatmap_mlp_fc1", "heatmap_mlp_fc2", "action_mlp_fc1",
      "action_mlp_fc2")
TIE = (0, 5, 3)      # (cloud, point, hidden unit) put on the kink


def _head():
    gen = torch.Generator().manual_seed(0)
    head = ActionHead(gen, hidden_size=HID, euler_resolution=RES,
                      pos_bins=PB)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    params = {"params": {n: {
        "kernel": jnp.asarray(getattr(head, n).weight.detach().numpy().T),
        "bias": jnp.asarray(getattr(head, n).bias.detach().numpy())}
        for n in FC}}
    return head, params


def _inputs(head, side):
    """x with pre-activation TIE of heatmap_mlp_fc1 at side * 1e-6 (in
    float64): two such inputs differ by ~1e-7 relative, below the card's
    and the CPU's backbone rounding difference."""
    rng = np.random.RandomState(1)
    x = rng.randn(B, N, HID)
    mask = np.arange(N)[None] < np.array([[N], [N - 4]])
    w = head.heatmap_mlp_fc1.weight.detach().double().numpy()
    bias = head.heatmap_mlp_fc1.bias.detach().double().numpy()
    b, n, j = TIE
    u = w[j] / np.dot(w[j], w[j])
    x[b, n] += (side * 1e-6 - (x[b, n] @ w[j] + bias[j])) * u
    cts = [rng.randn(B, 3, N, 2 * PB), rng.randn(B, 360 // RES, 3),
           rng.randn(B)]
    return x.astype(np.float32), mask, [c.astype(np.float32) for c in cts]


def _loss(xt, xr, xo, mask, cts, where):
    return (where(mask[:, None, :, None], xt, 0.0) * cts[0]).sum() + \
        (xr * cts[1]).sum() + (xo * cts[2]).sum()


def _port_grad(head, x, mask, cts, follow=None):
    head.zero_grad()
    with LeakyReluDecisions(follow) as rec:
        xt, xr, xo = head(torch.from_numpy(x), torch.from_numpy(mask))
        _loss(xt, xr, xo, torch.from_numpy(mask),
              [torch.from_numpy(c) for c in cts], torch.where).backward()
    return head.heatmap_mlp_fc1.weight.grad.clone().numpy(), rec


def _jax_grad(params, x, mask, cts):
    def f(p):
        xt, xr, xo = JaxActionHead(hidden_size=HID, euler_resolution=RES,
                                   pos_bins=PB).apply(p, jnp.asarray(x),
                                                      jnp.asarray(mask))
        return _loss(xt, xr, xo, jnp.asarray(mask),
                     [jnp.asarray(c) for c in cts], jnp.where)
    return np.asarray(jax.grad(f)(params)["params"]["heatmap_mlp_fc1"]
                      ["kernel"]).T


def _rel(a, b):
    return float(np.abs(a - b).max()) / float(np.abs(b).max())


def test_kink_tie_moves_the_fc1_gradient_past_the_bar():
    """The cause: both packages agree on either side of the kink, but the
    two sides' gradients differ by more than the step check's bar while
    their inputs differ by ~1e-7."""
    head, params = _head()
    (xa, mask, cts), (xb, _, _) = _inputs(head, 1), _inputs(head, -1)
    assert np.abs(xa - xb).max() <= 1e-6 * np.abs(xa).max()
    ga, rec_a = _port_grad(head, xa, mask, cts)
    gb, rec_b = _port_grad(head, xb, mask, cts)
    assert bool(rec_a.decisions[0][TIE]) and not bool(rec_b.decisions[0][TIE])
    assert int((rec_a.decisions[0] != rec_b.decisions[0]).sum()) == 1
    assert _rel(ga, _jax_grad(params, xa, mask, cts)) <= 1e-5
    assert _rel(gb, _jax_grad(params, xb, mask, cts)) <= 1e-5
    assert _rel(gb, ga) > GRAD_TOL


def test_following_the_recorded_branch_matches_jax():
    """The repair: the run at xb that follows xa's decisions keeps its own
    forward values and gives xa's gradient, as the JAX head computes it."""
    head, params = _head()
    (xa, mask, cts), (xb, _, _) = _inputs(head, 1), _inputs(head, -1)
    _, rec_a = _port_grad(head, xa, mask, cts)
    gb, rec_b = _port_grad(head, xb, mask, cts, follow=rec_a.decisions)
    assert rec_b.forced == 1 and rec_b.worst <= KINK_TOL
    assert _rel(gb, _jax_grad(params, xa, mask, cts)) <= 1e-5
    with torch.no_grad():
        plain = head(torch.from_numpy(xb), torch.from_numpy(mask))
        with LeakyReluDecisions(rec_a.decisions):
            followed = head(torch.from_numpy(xb), torch.from_numpy(mask))
    for p, f in zip(plain, followed):
        assert torch.equal(p, f)


def test_a_differing_decision_that_is_no_tie_raises():
    head, _ = _head()
    xa, mask, cts = _inputs(head, 1)
    _, rec = _port_grad(head, xa, mask, cts)
    flipped = [~d for d in rec.decisions]
    with pytest.raises(ValueError, match="not a tie"):
        _port_grad(head, xa, mask, cts, follow=flipped)


def test_following_more_than_the_limit_raises():
    """Ties stay a bounded exception: a run that would follow more than
    MAX_KINKS differing decisions raises, even if each were a tie."""
    head, _ = _head()
    xa, mask, cts = _inputs(head, 1)
    _, rec = _port_grad(head, xa, mask, cts)
    flipped = [~d for d in rec.decisions]
    assert int(rec.decisions[0].numel()) > MAX_KINKS
    with pytest.raises(ValueError, match=f"more than {MAX_KINKS}"):
        head.zero_grad()
        with LeakyReluDecisions(flipped, tol=1.0):
            head(torch.from_numpy(xa), torch.from_numpy(mask))
