"""PyTorch port vs the JAX package: checkpoints move between them.

The port's msgpack codec against flax's (every type, chunked arrays with a
small chunk size); model files and the flat AdamW train state written by
one package and read by the other, bit for bit (the tiny policy of
test_torch_port_train_step.py, dropout 0, the SFC order permutations handed
to both sides); a step after a cross-package resume within that test's
bars; a resumed port trainer's next step bit-equal to the uninterrupted
one's; warm starts (plain, encoder_only, strict) against the JAX
warm_start_variables; upstream-layout .pt files from the JAX
save_torch_checkpoint, and the name map.
"""
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import serialization as flax_ser

from robot3dlotus_tpu.models.simple_policy import (SimplePolicyTPU,
                                                   compute_loss as jloss)
from robot3dlotus_tpu.train import checkpoint as jckpt
from robot3dlotus_tpu.train import torch_convert as jtc
from robot3dlotus_tpu.train.optim import build_optimizer as jbuild_optimizer
from robot3dlotus_tpu.train.trainer import TrainState, make_train_step
from robot3dlotus_tpu_torch.convert import (adam_state_to_jax,
                                            params_from_jax, params_to_jax)
from robot3dlotus_tpu_torch.models.factory import build_model
from robot3dlotus_tpu_torch.models.layers import Randomness
from robot3dlotus_tpu_torch.models.simple_policy import compute_loss
from robot3dlotus_tpu_torch.train import checkpoint as ckpt
from robot3dlotus_tpu_torch.train import serialization
from robot3dlotus_tpu_torch.train import torch_convert as tc
from robot3dlotus_tpu_torch.train.optim import build_optimizer
from robot3dlotus_tpu_torch.train.trainer import Trainer, batch_to_device
from test_torch_port_motion_planner import MP_MODEL
from test_torch_port_train_step import (ACT, LOSS, PERMS, PTV3, TRAIN, _batch,
                                        _close, _perturb)

MODEL = {"model_class": "SimplePolicyPTV3CA", "ptv3_config": PTV3,
         "action_config": ACT}


# ------------------------------------------------------------- the codec ---

def _same(a, b, path="tree"):
    """Equal trees: same keys, types, dtypes, shapes and bits."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert type(a) is type(b) and a.dtype == b.dtype, path
        assert np.shape(a) == np.shape(b), path
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), path
    else:
        assert type(a) is type(b) and a == b, path


def _codec_tree(seed):
    rng = np.random.RandomState(seed)
    return {
        "f32": rng.randn(3, 5).astype(np.float32),
        "f64": rng.randn(7),
        "i32": np.asarray(rng.randint(-9, 9), np.int32),      # 0-d (count)
        "step": np.int64(150000),                            # ext 3
        "u8": rng.randint(0, 255, (4, 2, 3)).astype(np.uint8),
        "bool": rng.rand(6) > 0.5,
        "empty": np.zeros((0, 4), np.float32),
        "nested": {"deeper": {"x": rng.randn(2).astype(np.float32)}},
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32,
                 -33, -128, -129, -2 ** 15 - 1, -2 ** 31 - 1, 2 ** 63],
        "float": 1.25, "true": True, "false": False, "nil": None,
        "str": "x" * 40, "long_str": "y" * 300, "bin": b"\x00\xff" * 200,
        "map20": {str(i): i for i in range(20)},
        "list20": list(range(20)),
    }


def _sorted(tree):
    """The tree with its map keys in sorted order, the order flax's
    msgpack_serialize writes them in (it rebuilds the tree with
    jax.tree_util)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def test_codec_round_trips_through_flax():
    """Port bytes decode in flax and in the port; flax bytes decode in the
    port; both write the same bytes for the same tree."""
    tree = _codec_tree(0)
    ours = serialization.dumps(_sorted(tree))
    theirs = flax_ser.msgpack_serialize(_codec_tree(0))
    assert ours == theirs
    restored = flax_ser.msgpack_restore(ours)
    restored["ints"] = list(restored["ints"])
    restored["list20"] = list(restored["list20"])
    _same(tree, restored)
    _same(tree, serialization.loads(bytearray(theirs)))


@pytest.mark.parametrize("chunk", [64, 100, 4096])
def test_codec_chunked_arrays(chunk, monkeypatch):
    """Arrays over the chunk size go as flax's __msgpack_chunked_array__
    maps, both ways (flax with its MAX_CHUNK_SIZE patched to the same
    size)."""
    tree = {"big": np.random.RandomState(1).randn(50, 31).astype(np.float32),
            "small": np.arange(3, dtype=np.int64)}
    ours = serialization.dumps(tree, chunk_size=chunk)
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", chunk)
    theirs = flax_ser.msgpack_serialize(
        {k: v.copy() for k, v in tree.items()})
    assert ours == theirs
    _same(tree, flax_ser.msgpack_restore(ours))
    _same(tree, serialization.loads(bytearray(theirs)))


def test_codec_loads_views_of_the_buffer(tmp_path):
    """load reads the file once: arrays are writable views of one buffer."""
    path = str(tmp_path / "t.msgpack")
    serialization.save(path, {"a": np.arange(1000, dtype=np.float32),
                              "b": np.ones(7, np.float32)})
    out = serialization.load(path)
    assert out["a"].flags.writeable
    assert out["a"].base is not None and \
        np.shares_memory(out["a"], np.frombuffer(out["a"].base, np.uint8))
    assert not os.path.exists(path + ".tmp")


# --------------------------------------------------- model files both ways --

@pytest.fixture(scope="module")
def jax_setup():
    """The JAX model, perturbed variables, and its state after 2 steps on
    the test batch (order permutations patched, dropout 0)."""
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = SimplePolicyTPU(ptv3_cfg=dict(PTV3, attn_impl="xla",
                                          conv_impl="xla"),
                            act_cfg=ACT, variant="ca")
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda b: model.init(
        {"params": key, "dropout": key, "shuffle": key}, b,
        deterministic=True))(jb)
    variables = _perturb(jax.tree_util.tree_map(np.asarray, dict(variables)))
    mp = pytest.MonkeyPatch()
    calls = []

    def permutation(rng, n):
        calls.append(n)
        return jnp.asarray(PERMS[(len(calls) - 1) % len(PERMS)])
    mp.setattr(jax.random, "permutation", permutation)
    loss_fn = lambda p, b: jloss(p, b, ACT, LOSS)  # noqa: E731
    tx, _ = jbuild_optimizer(variables["params"], TRAIN)
    state = TrainState.create(apply_fn=model.apply,
                              params=variables["params"], tx=tx,
                              batch_stats=variables["batch_stats"])
    step_fn = make_train_step(model, loss_fn, donate=False)
    for _ in range(2):
        state, _ = step_fn(state, jb, key)
    yield dict(batch=batch, jb=jb, model=model, key=key, variables=variables,
               state=state, step_fn=step_fn)
    mp.undo()


def _port_model(variables=None):
    port = build_model(MODEL, device="cpu")
    if variables is not None:
        port.load_state_dict(params_from_jax(variables), strict=True)
    return port


def _host(state):
    return jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats})


def _bit_equal_sd(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_jax_model_file_loads_in_port(jax_setup, tmp_path):
    """JAX ModelSaver -> port load_any_model_ckpt: bit-equal to
    params_from_jax; the eval forward within 1e-4 of the JAX one."""
    state = jax_setup["state"]
    path = jckpt.ModelSaver(str(tmp_path)).save(state, 2)
    port = _port_model()
    sd = ckpt.load_any_model_ckpt(path, port)
    _bit_equal_sd(sd, params_from_jax(_host(state)))
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(batch_to_device(jax_setup["batch"], "cpu"))
    want = jax.jit(lambda v, b: jax_setup["model"].apply(
        v, b, deterministic=True))(_host(state), jax_setup["jb"])
    for k in ("pos", "rot", "open"):
        _close(got[k], want[k], k)


def test_port_model_file_loads_in_jax(jax_setup, tmp_path):
    """Port ModelSaver -> JAX load_model_ckpt on the JAX template:
    bit-equal to the port's params_to_jax; params_to_jax inverts
    params_from_jax."""
    variables = _host(jax_setup["state"])
    port = _port_model(variables)
    tree = params_to_jax(port)
    _same(jax.tree_util.tree_map(lambda a: a, tree), variables)
    path = ckpt.ModelSaver(str(tmp_path)).save(port, 7)
    assert os.path.basename(path) == "model_step_7.msgpack"
    template = _host(jax_setup["state"])
    loaded = jckpt.load_model_ckpt(path, template)
    _same(jax.tree_util.tree_map(np.asarray, loaded), variables)


def _port_trainer(variables):
    port = _port_model(variables)
    opt, _ = build_optimizer(port, TRAIN)
    return Trainer(port, lambda p, b: compute_loss(p, b, ACT, LOSS), opt,
                   Randomness(0, perms=PERMS * 8))


def test_train_state_moves_both_ways(jax_setup, tmp_path):
    """After 2 JAX steps: the JAX run directory resumes in the port with
    parameters, statistics, mu / nu / count and step bit-equal; one more
    step on each side agrees within the train-step test's bars; the port's
    directory then resumes in JAX resume_or_init, bit-equal again, and
    JAX steps from it."""
    state, step_fn = jax_setup["state"], jax_setup["step_fn"]
    jdir = str(tmp_path / "jax_run")
    jckpt.ModelSaver(jdir).save(state, 2)
    trainer = _port_trainer(jax_setup["variables"])
    assert ckpt.resume_or_init(trainer, jdir) == 2
    assert trainer.global_step == 2 and trainer.optimizer.count == 2
    _bit_equal_sd(trainer.model.state_dict(), params_from_jax(_host(state)))
    _same(adam_state_to_jax(trainer.optimizer, trainer.model),
          jax.tree_util.tree_map(np.asarray, dict(state.opt_state._asdict())))

    jstate, jlosses = step_fn(state, jax_setup["jb"], jax_setup["key"])
    losses = trainer.step(batch_to_device(jax_setup["batch"], "cpu"))
    for k in jlosses:
        _close(losses[k], jlosses[k], k)
    sd = trainer.model.state_dict()
    grads = {k: float(p.grad.abs().max())
             for k, p in trainer.model.named_parameters()}
    for k, v in params_from_jax(_host(jstate)).items():
        if grads.get(k, 1.0) < 1e-6:   # Adam scales a ~0 gradient to ~lr
            assert float((sd[k] - v).abs().max()) <= \
                2 * TRAIN["learning_rate"], k
            continue
        _close(sd[k], v, k)

    pdir = str(tmp_path / "port_run")
    ckpt.ModelSaver(pdir).save(trainer.model, 3, trainer.optimizer)
    assert ckpt.find_resume_step(pdir) == jckpt.find_resume_step(pdir) == 3
    resumed, step = jckpt.resume_or_init(state, pdir)
    assert step == 3 and resumed.step == 3
    _same(jax.tree_util.tree_map(np.asarray, {
        "params": resumed.params, "batch_stats": resumed.batch_stats}),
        params_to_jax(trainer.model))
    opt = dict(resumed.opt_state._asdict())
    assert opt["count"].dtype == np.int32 and opt["count"].shape == ()
    _same(jax.tree_util.tree_map(np.asarray, opt),
          adam_state_to_jax(trainer.optimizer, trainer.model))
    latest = jckpt.load_train_state_latest(pdir, state.opt_state)
    assert type(latest["step"]) is np.int64
    after, _ = step_fn(resumed, jax_setup["jb"], jax_setup["key"])
    assert int(after.step) == 4 and int(after.opt_state.count) == 4


def test_resumed_step_equals_uninterrupted(tmp_path):
    """The port alone, dropout and attention dropout on, orders drawn: a
    trainer resumed at step 2 takes a step 3 bit-equal to the trainer that
    ran on (losses, parameters, statistics, moments, count)."""
    cfg = dict(MODEL, ptv3_config=dict(PTV3, attn_drop=0.1, proj_drop=0.1,
                                       drop_path=0.1),
               action_config=dict(ACT, dropout=0.1))
    batch = batch_to_device(_batch(seed=4), "cpu")

    def trainer():
        model = build_model(cfg, device="cpu", seed=3)
        opt, _ = build_optimizer(model, TRAIN)
        return Trainer(model, lambda p, b: compute_loss(p, b, ACT, LOSS),
                       opt, Randomness(11))
    a = trainer()
    for _ in range(2):
        a.step(batch)
    ckpt.ModelSaver(str(tmp_path)).save(a.model, 2, a.optimizer)
    want = a.step(batch)
    b = trainer()
    assert ckpt.resume_or_init(b, str(tmp_path)) == 2
    got = b.step(batch)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _bit_equal_sd(b.model.state_dict(), a.model.state_dict())
    for key in ("mu", "nu"):
        assert torch.equal(getattr(b.optimizer, key),
                           getattr(a.optimizer, key)), key
    assert b.optimizer.count == a.optimizer.count == 3
    assert b.global_step == 3


def test_missing_or_misshapen_tensors_raise(jax_setup, tmp_path):
    """No fallback: a file without a model tensor, or with another shape,
    raises instead of leaving the seeded init."""
    variables = _host(jax_setup["state"])
    port = _port_model()
    short = {"params": dict(variables["params"]),
             "batch_stats": variables["batch_stats"]}
    del short["params"]["txt_fc"]
    serialization.save(str(tmp_path / "short.msgpack"), short)
    with pytest.raises(KeyError, match="missing"):
        ckpt.load_any_model_ckpt(str(tmp_path / "short.msgpack"), port)
    bad = jax.tree_util.tree_map(lambda a: a, variables)
    bad["params"]["txt_fc"]["kernel"] = np.zeros((3, 3), np.float32)
    serialization.save(str(tmp_path / "bad.msgpack"), bad)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_any_model_ckpt(str(tmp_path / "bad.msgpack"), port)


# ------------------------------------------------------------ warm starts --

@pytest.fixture(scope="module")
def warm_source(jax_setup, tmp_path_factory):
    """A JAX model file of a model with a narrower text projection (its
    txt_fc cannot load) and other weights; the port model and the JAX
    variables it starts from."""
    src = _perturb(_host(jax_setup["state"]), seed=5)
    src["params"]["txt_fc"]["kernel"] = np.ones((8, 32), np.float32)
    path = str(tmp_path_factory.mktemp("warm") / "src.msgpack")
    with open(path, "wb") as f:
        f.write(flax_ser.to_bytes(src))
    return path, jax_setup["variables"]


@pytest.mark.parametrize("encoder_only,strict",
                         [(False, False), (True, False), (True, True),
                          (False, True)],
                         ids=["plain", "encoder_only", "encoder_only_strict",
                              "strict"])
def test_warm_start_matches_jax(warm_source, encoder_only, strict):
    path, variables = warm_source
    port = _port_model(variables)
    kw = dict(encoder_only=encoder_only, strict=strict)
    if strict and not encoder_only:      # txt_fc stays uncovered
        with pytest.raises(ValueError, match="uninitialized"):
            jckpt.warm_start_variables(variables, path, **kw)
        with pytest.raises(ValueError, match="uninitialized"):
            ckpt.warm_start_variables(port, path, **kw)
        return
    merged, n_loaded, n_skipped = jckpt.warm_start_variables(
        variables, path, **kw)
    assert (n_loaded, n_skipped) == ckpt.warm_start_variables(port, path, **kw)
    assert n_skipped >= 1 and n_loaded >= 1
    _bit_equal_sd(port.state_dict(), params_from_jax(merged))


def test_warm_start_from_upstream_pt(warm_source, tmp_path):
    path, variables = warm_source
    src = serialization.load(path)
    pt = str(tmp_path / "src.pt")
    jtc.save_torch_checkpoint(pt, src["params"], src["batch_stats"], MODEL)
    port = _port_model(variables)
    merged, n_loaded, n_skipped = jckpt.warm_start_variables(
        variables, pt, MODEL)
    assert (n_loaded, n_skipped) == ckpt.warm_start_variables(port, pt, MODEL)
    _bit_equal_sd(port.state_dict(), params_from_jax(merged))


# -------------------------------------------------------- upstream names --

@pytest.mark.parametrize("model_cfg", [MODEL, MP_MODEL],
                         ids=["policy", "motion_planner"])
def test_name_map_matches_jax(model_cfg):
    assert tc.build_name_map(model_cfg) == jtc.build_name_map(model_cfg)


def test_upstream_pt_loads_in_port(jax_setup, tmp_path):
    """JAX save_torch_checkpoint on the perturbed variables (upstream torch
    names, spconv layout) -> port load_any_model_ckpt: bit-equal to
    params_from_jax; a .pt missing a tensor raises."""
    variables = _host(jax_setup["state"])
    pt = str(tmp_path / "model_step_2.pt")
    jtc.save_torch_checkpoint(pt, variables["params"],
                              variables["batch_stats"], MODEL)
    port = _port_model()
    _bit_equal_sd(ckpt.load_any_model_ckpt(pt, port, MODEL),
                  params_from_jax(variables))
    sd = torch.load(pt, weights_only=True)
    del sd["txt_fc.bias"]
    torch.save(sd, str(tmp_path / "short.pt"))
    with pytest.raises(KeyError, match="missing"):
        ckpt.load_any_model_ckpt(str(tmp_path / "short.pt"), port, MODEL)
