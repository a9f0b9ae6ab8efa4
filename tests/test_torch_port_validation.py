"""PyTorch port vs the JAX package: validation.

Validation: the port's make_val_step + driver._run_validation against the
JAX make_val_step + _run_validation, both families (the tiny models of
test_torch_port_train_step.py and test_torch_port_motion_planner.py with
JAX-initialised, perturbed weights), on the same synthetic validation
batches (the port's stores and collates, which equal the JAX ones): losses
within 1e-4 * max(1, |ref|), accuracies equal unless a decision sits within
1e-6 of a sigmoid's 0.5 (named by the test).

Run control and serving from checkpoints: test_torch_port_run_control.py.
"""
import collections

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from robot3dlotus_tpu.models.motion_planner import (
    compute_mp_loss as jmp_loss)
from robot3dlotus_tpu.models.simple_policy import (SimplePolicyTPU,
                                                   compute_loss as jloss)
from robot3dlotus_tpu.train import driver as jdriver
from robot3dlotus_tpu.train import train_motion_planner as jtmp
from robot3dlotus_tpu.train import train_simple_policy as jtsp
from robot3dlotus_tpu.train.trainer import make_val_step as jmake_val_step
from robot3dlotus_tpu_torch.convert import params_from_jax
from robot3dlotus_tpu_torch.models.factory import build_model
from robot3dlotus_tpu_torch.models.motion_planner import compute_mp_loss
from robot3dlotus_tpu_torch.models.simple_policy import compute_loss
from robot3dlotus_tpu_torch.train import driver, train_motion_planner
from robot3dlotus_tpu_torch.train import train_simple_policy
from robot3dlotus_tpu_torch.train.datasets.collate import (
    collate_keystep_samples)
from robot3dlotus_tpu_torch.train.datasets.keystep_dataset import (
    KeystepDataset)
from robot3dlotus_tpu_torch.train.datasets.loader import KeystepBatchLoader
from robot3dlotus_tpu_torch.train.datasets.motion_dataset import (
    MotionPlannerDataset, collate_motion_samples)
from robot3dlotus_tpu_torch.train.datasets.store import open_store
from robot3dlotus_tpu_torch.train.trainer import make_val_step
import test_torch_port_motion_planner as tmp_mp
import test_torch_port_train_step as tmp_ts

# what make_val_step reads of a TrainState (a namedtuple is a pytree)
JState = collections.namedtuple("JState", "params batch_stats")
ATOL = 1e-4
SIGMOID_TIE = 1e-6   # a decision this close to 0.5 may go either way
POLICY = {"model_class": "SimplePolicyPTV3CA", "ptv3_config": tmp_ts.PTV3,
          "action_config": tmp_ts.ACT}


def _policy_variables():
    batch = tmp_ts._batch()
    model = SimplePolicyTPU(ptv3_cfg=dict(tmp_ts.PTV3, attn_impl="xla",
                                          conv_impl="xla"),
                            act_cfg=tmp_ts.ACT, variant="ca")
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda b: model.init(
        {"params": key, "dropout": key, "shuffle": key}, b,
        deterministic=True))({k: jnp.asarray(v) for k, v in batch.items()})
    return model, tmp_ts._perturb(
        jax.tree_util.tree_map(np.asarray, dict(variables)))


FAMILIES = {
    "policy": dict(
        jax_model=lambda: _policy_variables(), model=POLICY,
        act=tmp_ts.ACT, loss=tmp_ts.LOSS, jloss=jloss, loss_fn=compute_loss,
        jspec=jtsp.SPEC, spec=train_simple_policy.SPEC,
        dataset=lambda: KeystepDataset(
            open_store("synthetic_reach2"), num_points=128, txt_embed_dim=64,
            augment_pc=False, rng=np.random.RandomState(0)),
        collate=lambda s: collate_keystep_samples(s, 128, num_clouds=4)),
    "motion_planner": dict(
        jax_model=lambda: (tmp_mp.jax_model(),
                           tmp_mp.jax_variables(tmp_mp.mp_batch())),
        model=tmp_mp.MP_MODEL, act=tmp_mp.ACT, loss=tmp_mp.LOSS,
        jloss=jmp_loss, loss_fn=compute_mp_loss, jspec=jtmp.SPEC,
        spec=train_motion_planner.SPEC,
        dataset=lambda: MotionPlannerDataset(
            open_store("synthetic_motion"), num_points=128, max_traj_len=5,
            txt_embed_dim=64, augment_pc=False,
            rng=np.random.RandomState(0)),
        collate=lambda s: collate_motion_samples(s, 128, 5, num_clouds=4)),
}


class _FirstEpisodes:
    """The first n episodes of a dataset: a validation set of a few
    batches."""

    def __init__(self, dataset, n):
        self.dataset, self.n = dataset, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.dataset[i]


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def validation_pair(request):
    """Both packages' _run_validation on the same batches and weights, and
    the decoded actions of each batch."""
    fam = FAMILIES[request.param]
    jmodel, variables = fam["jax_model"]()
    dataset = _FirstEpisodes(fam["dataset"](), 3)
    batches = list(KeystepBatchLoader(dataset, 4, 128,
                                      collate_fn=fam["collate"],
                                      one_pass=True))
    assert len(batches) >= 2 and not batches[-1]["batch_valid"].all()
    act, loss = fam["act"], fam["loss"]

    jacts = []
    jval = jmake_val_step(jmodel, lambda p, b: fam["jloss"](p, b, act, loss),
                          lambda preds: fam["jspec"].decode_fn(preds, act))

    def jfn(state, b):
        losses, actions = jval(state, b)
        jacts.append(np.asarray(actions))
        return losses, actions
    want = jdriver._run_validation(
        jfn, JState(**variables), lambda: iter(batches),
        fam["jspec"], None)

    port = build_model(fam["model"], device="cpu")
    port.load_state_dict(params_from_jax(variables), strict=True)
    acts = []
    val = make_val_step(port, lambda p, b: fam["loss_fn"](p, b, act, loss),
                        lambda preds: fam["spec"].decode_fn(preds, act))

    def fn(b):
        losses, actions = val(b)
        acts.append(actions.numpy())
        return losses, actions
    got = driver._run_validation(fn, lambda: iter(batches), fam["spec"],
                                 torch.device("cpu"))
    return dict(family=request.param, got=got, want=want, acts=acts,
                jacts=jacts, batches=batches)


def _open_stop_logits(actions, family):
    """The sigmoid logits that the accuracies threshold."""
    return actions[..., -1:] if family == "policy" else actions[..., -2:]


def test_validation_matches_jax(validation_pair):
    got, want = validation_pair["got"], validation_pair["want"]
    family = validation_pair["family"]
    assert set(got) == set(want)
    accs = {"open_acc", "stop_acc"}
    for k, v in want.items():
        if k in accs:
            continue
        assert abs(got[k] - v) <= ATOL * max(1.0, abs(v)), (k, got[k], v)
    ties = []
    for b, (a, ja) in enumerate(zip(validation_pair["acts"],
                                    validation_pair["jacts"])):
        np.testing.assert_allclose(a, ja, atol=ATOL * max(
            1.0, float(np.abs(ja).max())), rtol=0)
        p = 1.0 / (1.0 + np.exp(-_open_stop_logits(a, family)))
        jp = 1.0 / (1.0 + np.exp(-_open_stop_logits(ja, family)))
        differ = (p > 0.5) != (jp > 0.5)
        for idx in zip(*np.nonzero(differ)):
            assert min(abs(p[idx] - 0.5), abs(jp[idx] - 0.5)) <= \
                SIGMOID_TIE, (b, idx, p[idx], jp[idx])
            ties.append((b, idx))
    print(f"{family}: {len(validation_pair['batches'])} batches, "
          f"{len(ties)} sigmoid decisions within {SIGMOID_TIE} of 0.5: "
          f"{ties}")
    for k in accs & set(want):
        if not ties:
            assert got[k] == want[k], k


def test_validation_metric_names(validation_pair):
    """The val_ keys the loop writes are the JAX driver's names."""
    family = validation_pair["family"]
    want = {"policy": {"total_loss", "pos_loss", "rot_loss", "open_loss",
                       "open_acc", "pos_l1_loss"},
            "motion_planner": {"total_loss", "pos_loss", "rot_loss",
                               "open_loss", "stop_loss", "open_acc",
                               "stop_acc"}}[family]
    assert want <= set(validation_pair["want"])
    assert set(validation_pair["got"]) == set(validation_pair["want"])
