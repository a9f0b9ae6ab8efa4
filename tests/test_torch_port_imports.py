"""The PyTorch port stands alone: no file of robot3dlotus_tpu_torch/ and not
chip_smoke.py imports jax, flax, msgpack, lmdb, sklearn, open3d, requests,
filelock, flask or the JAX package (checkpoints and episode records go
through the port's own msgpack codec, LMDB files through its pure-Python
reader, the voxelizer is its own C++, HTTP through the standard library,
result files are locked with fcntl), and tensorboardX only inside a try
that lets it be absent; importing the port loads none of them; the eval
server's producer side and the loader's worker module import no torch;
entry points (the Actioner, build_model for each of the five model
classes, the trainer) run on CUDA by default and raise without a card
unless the caller passes device='cpu'; the native library builds under
build/native/, and a
failed build raises (there is no numpy fallback); chip_smoke.py ends every
process it started (the loader's forkserver, the resource tracker, orphans)
before it prints its result."""
import ast
import os
import subprocess
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "robot3dlotus_tpu_torch")
BANNED = ("jax", "flax", "robot3dlotus_tpu", "lmdb", "sklearn", "open3d",
          "requests", "filelock", "flask")
# absent on the card's machine: the port's checkpoints need neither
NO_CODEC = ("msgpack", "flax")
OPTIONAL = "tensorboardX"
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


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_msgpack_and_optional_tensorboardx(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    parents = {c: n for n in ast.walk(tree) for c in ast.iter_child_nodes(n)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        roots = {n.split(".")[0] for n in names}
        assert not roots & set(NO_CODEC), (path, names)
        if OPTIONAL in roots:
            up = node
            while up in parents and not isinstance(up, ast.Try):
                up = parents[up]
            assert isinstance(up, ast.Try) and node in [
                n for stmt in up.body for n in ast.walk(stmt)], \
                f"{path}: {OPTIONAL} imported outside a try"
            caught = [ast.unparse(h.type) for h in up.handlers if h.type]
            assert set(caught) & {"Exception", "ImportError"}, caught


def test_import_loads_no_jax():
    code = ("import sys, robot3dlotus_tpu_torch.eval.actioner, "
            "robot3dlotus_tpu_torch.eval.robot_pipeline, "
            "robot3dlotus_tpu_torch.convert, "
            "robot3dlotus_tpu_torch.train.checkpoint, "
            "robot3dlotus_tpu_torch.train.train_simple_policy, "
            "robot3dlotus_tpu_torch.train.train_motion_planner, "
            "robot3dlotus_tpu_torch.train.datasets.store, "
            "robot3dlotus_tpu_torch.ops.eval_preprocess, "
            "robot3dlotus_tpu_torch.eval.serving, "
            "robot3dlotus_tpu_torch.preprocess.evaluate_microsteps, "
            "robot3dlotus_tpu_torch.scripts.summarize_tst_results, "
            "robot3dlotus_tpu_torch.models.factory, "
            "robot3dlotus_tpu_torch.models.heads, "
            "robot3dlotus_tpu_torch.ops.rotation, "
            "robot3dlotus_tpu_torch.ops.pos_codec, "
            "robot3dlotus_tpu_torch.native; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'msgpack', 'robot3dlotus_tpu', 'lmdb', "
            "'sklearn', 'open3d', 'requests', 'filelock', 'flask')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_producer_side_and_loader_workers_import_no_torch():
    """What the eval server's producers import (the server, its CLIs and
    env builders, the summarizers) and the loader's worker module with the
    datasets and stores."""
    code = ("import sys, robot3dlotus_tpu_torch.eval.server, "
            "robot3dlotus_tpu_torch.eval.eval_simple_policy_server, "
            "robot3dlotus_tpu_torch.eval.eval_robot_pipeline_server, "
            "robot3dlotus_tpu_torch.scripts.summarize_val_results, "
            "robot3dlotus_tpu_torch.train.datasets.workers; "
            "assert 'torch' not in sys.modules")
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


MODEL_CLASSES = ("SimplePolicyPTV3AdaNorm", "SimplePolicyPTV3CA",
                 "SimplePolicyPTV3Concat", "MotionPlannerPTV3AdaNorm",
                 "MotionPlannerPTV3CA")


@pytest.mark.parametrize("cls", MODEL_CLASSES)
def test_every_model_class_builds_on_cpu_and_needs_a_card(cls):
    """build_model maps all five classes of the JAX factory: each builds
    on the CPU when asked (the AdaNorm ones with adaptive norms, the Concat
    stem 7 + context channels wide) and raises without a card by
    default."""
    import yaml
    from robot3dlotus_tpu_torch.models.factory import build_model
    with open(RELEASE_CFG) as f:
        model_cfg = yaml.safe_load(f)["MODEL"]
    tiny = dict(model_cfg, model_class=cls, ptv3_config=dict(
        model_cfg["ptv3_config"], enc_channels=[16, 16, 16, 16, 16],
        dec_channels=[16, 16, 16, 16], enc_num_head=[2] * 5,
        dec_num_head=[2] * 4, pdnorm_adaptive=True))
    model = build_model(tiny, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert any(".modulation." in n for n in names) == cls.endswith("AdaNorm")
    assert any("_cablock" in n for n in names) == cls.endswith("CA")
    ctx = model_cfg["action_config"]["context_channels"]
    stem = model.ptv3_model.embedding_stem_conv.weight.shape[1]
    if cls.startswith("SimplePolicy"):
        assert stem == 7 + (ctx if cls.endswith("Concat") else 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(tiny)


def test_native_library_builds_under_build_native():
    from robot3dlotus_tpu_torch import native
    path = native.build()
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "native")
    assert os.path.exists(path) and native.cpu_tag() in path
    assert native.get_lib() is not None


def test_failed_native_build_raises(tmp_path):
    from robot3dlotus_tpu_torch import native
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" long voxelize_trace( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(src=str(bad), build_dir=str(tmp_path / "out"))
    assert os.listdir(tmp_path / "out") == []    # nothing half-written


def test_smoke_stops_every_process_it_started(monkeypatch):
    """chip_smoke.stop_processes: a forkserver pool's server and the
    resource tracker are stopped and reaped; an orphan the run left is
    killed and named; a process started before the run's mark is left
    alone."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import forkserver
    import chip_smoke

    def alive(pid):
        try:
            with open(f"/proc/{pid}/stat") as f:
                return f.read().rsplit(")", 1)[1].split()[0] != "Z"
        except OSError:
            return False

    bystander = subprocess.Popen([sys.executable, "-c",
                                  "import time; time.sleep(60)"])
    try:
        monkeypatch.setenv(chip_smoke.RUN_MARK, f"test.{os.getpid()}")
        with ProcessPoolExecutor(1, mp_context=mp.get_context(
                "forkserver")) as pool:
            worker = pool.submit(os.getpid).result()
        server = forkserver._forkserver._forkserver_pid
        orphan = int(subprocess.run(
            [sys.executable, "-c",
             "import subprocess as s, sys; print(s.Popen([sys.executable, "
             "'-c', 'import time; time.sleep(60)'], stdout=s.DEVNULL, "
             "stderr=s.DEVNULL).pid)"],
            capture_output=True, text=True, check=True, timeout=60).stdout)
        assert alive(server) and alive(orphan)
        left = chip_smoke.stop_processes(wait_s=1.0)
        assert [pid for pid, _ in left] == [orphan]
        assert "time.sleep(60)" in left[0][1]
        assert forkserver._forkserver._forkserver_pid is None
        assert not alive(server) and not alive(worker)
        for _ in range(100):
            if not alive(orphan):
                break
            time.sleep(0.05)
        assert not alive(orphan)
        assert bystander.poll() is None
    finally:
        bystander.kill()
        bystander.wait()
