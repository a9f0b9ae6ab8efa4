"""The port's mesh and tensor-parallel rules (robot3dlotus_tpu_torch/
parallel/mesh.py) against the JAX package's parallel/mesh.py, with no
process group: parse_mesh_spec's results and errors on the same strings;
the leaves each model class shards over tp (Megatron's MLP and CPE
pairs, on the port's torch layouts) against JAX's tp_leaf_spec on the
same flax names and shapes (tests/test_tensor_parallel.py mirrored);
the meshes one process can and cannot make (sp > 1 raises, naming the
roadmap; tp > 1 needs tp processes); the one-process mesh's helpers
reduce nothing. The two-process cases are in
test_torch_port_zero1_tp.py."""
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from robot3dlotus_tpu.parallel.mesh import parse_mesh_spec as jparse
from robot3dlotus_tpu.parallel.mesh import tp_leaf_spec
from robot3dlotus_tpu_torch.convert import flax_leaves
from robot3dlotus_tpu_torch.models.factory import build_model
from robot3dlotus_tpu_torch.parallel import dist
from robot3dlotus_tpu_torch.parallel.mesh import (SP_NOT_PORTED, eval_rows,
                                                  gather_rows, make_mesh,
                                                  mesh_from_spec,
                                                  parse_mesh_spec, rule_dim,
                                                  shard_model, tp_plan)
from robot3dlotus_tpu_torch.parallel.zero import flat_shard
from test_tensor_parallel import TINY_ACT, TINY_PTV3
from test_torch_port_motion_planner import MP_MODEL

SPECS = ["dp=2, tp=2", "sp=2;tp=4", "tp=4", "dp=1,tp=2,", "ep=2", "tp",
         "dp=0", "tp=x", "dp=-1", ""]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_mesh_spec_matches_jax(spec):
    try:
        want = jparse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_mesh_spec(spec)
        assert str(got.value) == str(e)
        return
    assert parse_mesh_spec(spec) == want


class _Key:
    def __init__(self, k):
        self.key = k


class _Leaf:
    def __init__(self, shape):
        self.shape, self.ndim = tuple(shape), len(shape)


def _models():
    policy = {"ptv3_config": dict(TINY_PTV3),
              "action_config": dict(TINY_ACT, pos_heatmap_type="dist")}
    return {"ca": dict(policy, model_class="SimplePolicyPTV3CA"),
            "adanorm": dict(policy, model_class="SimplePolicyPTV3AdaNorm"),
            "planner": MP_MODEL}


@pytest.mark.parametrize("tp", [2, 4, 3])
@pytest.mark.parametrize("name", ["ca", "adanorm", "planner"])
def test_tp_plan_matches_jax_tp_leaf_spec(name, tp):
    """Every parameter: sharded by the port on the torch dim that maps to
    the flax dim JAX's tp_leaf_spec shards (a Dense weight mirrored), or
    whole where JAX keeps it replicated."""
    model = build_model(_models()[name], device="cpu")
    plan = tp_plan(model, tp)
    params = dict(model.named_parameters())
    n_tp = 0
    for torch_name, (coll, path, transposed) in flax_leaves(model).items():
        if coll != "params":
            continue
        t = params[torch_name]
        shape = tuple(t.shape[::-1]) if transposed else tuple(t.shape)
        spec = tp_leaf_spec([_Key(p) for p in path], _Leaf(shape), tp)
        if spec == P():
            assert torch_name not in plan, torch_name
            continue
        n_tp += 1
        d = list(spec).index("tp")
        assert plan[torch_name] == (t.ndim - 1 - d if transposed else d), \
            torch_name
    assert n_tp == len(plan)
    if tp in (2, 4):     # the widths 16, 32 and 64, 128 divide
        assert n_tp >= 8


def test_rule_dims_mirror_jax_rules():
    """tests/test_tensor_parallel.py's leaves on the torch layouts."""
    assert rule_dim("enc0/block0/mlp/fc1/kernel", 2, True) == 0
    assert rule_dim("enc0/block0/mlp/fc1/bias", 1, False) == 0
    assert rule_dim("enc0/block0/cpe_conv/weight", 3, False) == 2
    assert rule_dim("enc0/block0/cpe_conv/bias", 1, False) == 0
    assert rule_dim("enc0/block0/mlp/fc2/kernel", 2, True) == 1
    assert rule_dim("enc0/block0/cpe_fc/kernel", 2, True) == 1
    assert rule_dim("enc0/block0/attn/qkv/kernel", 2, True) is None
    assert rule_dim("enc0/block0/norm1/scale", 1, False) is None
    assert rule_dim("enc0/block0/mlp/fc2/bias", 1, False) is None


def test_one_process_meshes():
    """Without a group: the 1 x 1 mesh, whose helpers reduce nothing; sp
    raises naming the roadmap; tp and explicit sizes past one process
    raise; a model keeps its whole leaves."""
    assert not dist.joined()
    mesh = make_mesh()
    assert mesh.shape == {"dp": 1, "sp": 1, "tp": 1}
    assert mesh_from_spec("dp=1") == mesh
    with pytest.raises(ValueError) as e:
        mesh_from_spec("sp=2,tp=1")
    assert str(e.value) == SP_NOT_PORTED and "ROADMAP.md §1" in SP_NOT_PORTED
    for spec in ("tp=2", "dp=2", "dp=1,tp=2"):
        with pytest.raises(ValueError, match="processes"):
            mesh_from_spec(spec)
    assert eval_rows(4, mesh) == slice(0, 4)
    x = torch.arange(4.0)
    assert gather_rows(x, 4, mesh) is x
    model = build_model(_models()["ca"], device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    shard_model(model, mesh)
    assert model.tp_plan == {}
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())


def test_flat_shard_layout_one_process():
    """The one-process mesh's FlatShard holds the whole buffer; its norms
    are the buffer's own and whole() / local() are the identity."""
    named = [("a", torch.nn.Parameter(torch.randn(5, 3))),
             ("b", torch.nn.Parameter(torch.randn(7)))]
    shard = flat_shard(named, make_mesh())
    assert (shard.n, shard.lo, shard.hi, shard.pad) == (22, 0, 22, 0)
    assert shard.segs == [15, 7]
    g = torch.randn(22)
    assert torch.equal(shard.scatter(g), g)
    assert torch.equal(shard.sumsq(g), g.square().sum())
    assert torch.equal(shard.whole(g), g) and torch.equal(shard.local(g), g)
    np.testing.assert_allclose(
        shard.leaf_norms(g), [float(g[:15].norm()), float(g[15:].norm())],
        rtol=1e-6)


@pytest.mark.parametrize("tp", [2, 4])
def test_conv_plans_at_tp_widths(tp):
    """The plans of K2 and K7 at the tp path's widths (the release's C =
    64 … 768 over tp): the forward at Cout = C/tp and the dx's mirrored
    conv at Cin = C/tp need no channel padding at either dtype, K7 at
    Cout = C/tp takes the compacted CPE path unpadded, and the forward's
    tap ranges are one or one a tap (a row's sums in the same order as
    at full width)."""
    from robot3dlotus_tpu_torch.ops import conv
    for C in (64, 128, 256, 512, 768):
        w = C // tp
        for nbytes in (4, 2):
            assert conv.conv_channel_padding(C, w, nbytes, nbytes) == (0, 0)
            assert conv.conv_channel_padding(w, C, 4, nbytes) == (0, 0)
            unit = 16 // nbytes
            assert w % unit == 0 and C % unit == 0   # no K7 x padding
            for B, N in ((32, 4096), (1, 4096), (32, 256)):
                splits, per, work = conv.weight_grad_plan(B, N, 27, C, w,
                                                          unit)
                assert splits * per >= B * N and work > 0
                assert conv.conv_tap_splits(B, N, 27, w) in (1, 27)
