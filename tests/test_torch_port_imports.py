"""The PyTorch port stands alone: no file of robot3dlotus_tpu_torch/ and not
chip_smoke.py imports jax, flax or the JAX package; importing the port
loads no jax; entry points (the Actioner, build_model, the trainer) run on
CUDA by default and raise without a card unless the caller passes
device='cpu'."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "robot3dlotus_tpu_torch")
BANNED = ("jax", "flax", "robot3dlotus_tpu")
RELEASE_CFG = os.path.join(PORT, "configs", "rlbench",
                           "simple_policy_ptv3.yaml")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_import_loads_no_jax():
    code = ("import sys, robot3dlotus_tpu_torch.eval.actioner, "
            "robot3dlotus_tpu_torch.convert, "
            "robot3dlotus_tpu_torch.train.train_simple_policy; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'robot3dlotus_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_entry_points_need_a_card_unless_cpu():
    import yaml
    from robot3dlotus_tpu_torch.eval.actioner import Actioner
    from robot3dlotus_tpu_torch.models.factory import build_model
    from robot3dlotus_tpu_torch.train import train_simple_policy
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with open(RELEASE_CFG) as f:
        model_cfg = yaml.safe_load(f)["MODEL"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(model_cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Actioner(RELEASE_CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_simple_policy.main(*train_simple_policy.build_args(
            ["--exp-config", RELEASE_CFG,
             "TRAIN_DATASET.data_dir", "synthetic_reach"]))
    tiny = dict(model_cfg, ptv3_config=dict(
        model_cfg["ptv3_config"], enc_channels=[16, 16, 16, 16, 16],
        dec_channels=[16, 16, 16, 16], enc_num_head=[2] * 5,
        dec_num_head=[2] * 4))
    assert next(build_model(tiny, device="cpu").parameters()).device.type \
        == "cpu"
