"""PyTorch port vs the JAX package: one whole training step of the
3D-LOTUS++ motion planner at ptv3_config compute_dtype bfloat16.

The tiny MotionPlannerPTV3CA of test_torch_port_motion_planner.py (2
stages, the k=5 stem with its categorical label channel: K9 gathers the
bf16 rows, the label table's gradient comes through the product after the
gather), dropout 0, the same injected order permutations on both sides,
against the JAX make_train_step at bf16 compiled with XLA's excess
precision off; the bars and the discriminating check (the port at bf16
nearer the JAX step at bf16 than the port at fp32) are those of
test_torch_port_bf16_train_step.py, whose helper runs the step.
"""
from robot3dlotus_tpu.models.motion_planner import compute_mp_loss as jloss
from robot3dlotus_tpu_torch.models.motion_planner import compute_mp_loss
from test_torch_port_bf16_train_step import check_bf16_step
from test_torch_port_motion_planner import LOSS, mp_batch
from test_torch_port_variants_mp import jax_mp, mp_cfg


def test_motion_planner_bf16_train_step_matches_jax(monkeypatch):
    cfg = mp_cfg("MotionPlannerPTV3CA", {"compute_dtype": "bfloat16"})
    act = cfg["action_config"]
    check_bf16_step(
        cfg, jax_mp(cfg), lambda p, b: jloss(p, b, act, LOSS),
        lambda p, b: compute_mp_loss(p, b, act, LOSS), mp_batch(seed=5),
        [[3, 1, 0, 2], [1, 2, 3, 0]], monkeypatch,
        must_learn=("pc_label_embedding.weight",
                    "act_proj_head.traj_embedding.weight",
                    "ptv3_model.embedding_stem_conv.weight"))
