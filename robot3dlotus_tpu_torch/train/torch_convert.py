"""Checkpoint conversion between the upstream PyTorch layout
(`model_step_{N}.pt` flat state_dict, reference train/utils/save.py:20-45)
and flax-named variables ({params, batch_stats}): the port's copy of
robot3dlotus_tpu/train/torch_convert.py (numpy only). The port's models
carry the flax names, so convert.params_from_jax takes a converted tree on
to a state_dict.

Name correspondence (torch module path -> flax tree path) follows the
construction order of the reference models (simple_policy_ptv3.py:376-431,
model_ca.py:155-412) and the flax module names. Torch tensors are read
and written with `torch.load(..., weights_only=True)` / `torch.save` on
the CPU.

Layout conventions:
  * nn.Linear.weight (out, in)     <-> Dense kernel (in, out): transpose
  * nn.Embedding.weight            <-> Embed embedding: identical
  * LayerNorm/BatchNorm weight/bias <-> scale/bias
  * spconv.SubMConv3d.weight (out, kx, ky, kz, in)
        <-> SubMConv weight (K, in, out) with K enumerated in
        stencil_offsets order (x-major ascending). spconv's native layout is
        documented as (out, *kernel_size, in); if a checkpoint uses the
        transposed variant, pass spconv_layout='k_in_out'.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


# --------------------------------------------------------------------------
# name mapping
# --------------------------------------------------------------------------

def _ln(flax_prefix, torch_prefix):
    return {
        f"{torch_prefix}.weight": (f"{flax_prefix}/scale", "copy"),
        f"{torch_prefix}.bias": (f"{flax_prefix}/bias", "copy"),
    }


def _bn(flax_prefix, torch_prefix):
    m = _ln(flax_prefix, torch_prefix)
    m[f"{torch_prefix}.running_mean"] = (f"BS:{flax_prefix}/mean", "copy")
    m[f"{torch_prefix}.running_var"] = (f"BS:{flax_prefix}/var", "copy")
    return m


def _dense(flax_prefix, torch_prefix, bias=True):
    m = {f"{torch_prefix}.weight": (f"{flax_prefix}/kernel", "t")}
    if bias:
        m[f"{torch_prefix}.bias"] = (f"{flax_prefix}/bias", "copy")
    return m


def _conv(flax_prefix, torch_prefix, bias=True):
    m = {f"{torch_prefix}.weight": (f"{flax_prefix}/weight", "spconv")}
    if bias:
        m[f"{torch_prefix}.bias"] = (f"{flax_prefix}/bias", "copy")
    return m


def _norm(flax_mod, torch_mod, kind="ln", adaptive=False):
    """One AdaptiveNorm site. Non-adaptive reference: a bare BN/LN at
    torch_mod. Adaptive reference (PDNorm, model.py:257-304 with
    decouple=False): the inner norm lives at `<torch_mod>.norm` and the
    SiLU+Linear modulation at `<torch_mod>.modulation.1`."""
    inner = f"{torch_mod}.norm" if adaptive else torch_mod
    m = (_bn if kind == "bn" else _ln)(f"{flax_mod}/norm", inner)
    if adaptive:
        m.update(_dense(f"{flax_mod}/modulation", f"{torch_mod}.modulation.1"))
    return m


def _block_map(flax_p, torch_p, qk_norm=True, adaptive=False,
               add_coords="none", enable_rpe=False, cosine=False):
    m = {}
    m.update(_conv(f"{flax_p}/cpe_conv", f"{torch_p}.cpe.0"))
    m.update(_dense(f"{flax_p}/cpe_fc", f"{torch_p}.cpe.1"))
    m.update(_norm(f"{flax_p}/cpe_norm", f"{torch_p}.cpe.2", "ln", adaptive))
    m.update(_norm(f"{flax_p}/norm1", f"{torch_p}.norm1.0", "ln", adaptive))
    m.update(_norm(f"{flax_p}/norm2", f"{torch_p}.norm2.0", "ln", adaptive))
    m.update(_dense(f"{flax_p}/attn/qkv", f"{torch_p}.attn.qkv"))
    m.update(_dense(f"{flax_p}/attn/proj", f"{torch_p}.attn.proj"))
    if qk_norm:
        m.update(_ln(f"{flax_p}/attn/q_norm", f"{torch_p}.attn.q_norm"))
        m.update(_ln(f"{flax_p}/attn/k_norm", f"{torch_p}.attn.k_norm"))
    if add_coords in ("qk", "qkv"):
        # Linear(3, C, bias=False), reference model.py:397
        m.update(_dense(f"{flax_p}/attn/coords_proj",
                        f"{torch_p}.attn.coords_proj", bias=False))
    if enable_rpe:  # RPE table parameter, reference model.py:314
        m[f"{torch_p}.attn.rpe.rpe_table"] = (
            f"{flax_p}/attn/rpe_table", "copy")
    if cosine:  # per-head temperature, reference model.py:363
        m[f"{torch_p}.attn.logit_scale"] = (
            f"{flax_p}/attn/logit_scale", "copy")
    m.update(_dense(f"{flax_p}/mlp/fc1", f"{torch_p}.mlp.0.fc1"))
    m.update(_dense(f"{flax_p}/mlp/fc2", f"{torch_p}.mlp.0.fc2"))
    return m


def _ca_block_map(flax_p, torch_p, qk_norm=True, adaptive=False):
    m = {}
    m.update(_norm(f"{flax_p}/norm1", f"{torch_p}.norm1.0", "ln", adaptive))
    m.update(_norm(f"{flax_p}/norm2", f"{torch_p}.norm2.0", "ln", adaptive))
    m.update(_dense(f"{flax_p}/attn/q", f"{torch_p}.attn.q"))
    m.update(_dense(f"{flax_p}/attn/kv", f"{torch_p}.attn.kv"))
    m.update(_dense(f"{flax_p}/attn/proj", f"{torch_p}.attn.proj"))
    if qk_norm:
        m.update(_ln(f"{flax_p}/attn/q_norm", f"{torch_p}.attn.q_norm"))
        m.update(_ln(f"{flax_p}/attn/k_norm", f"{torch_p}.attn.k_norm"))
    m.update(_dense(f"{flax_p}/mlp/fc1", f"{torch_p}.mlp.0.fc1"))
    m.update(_dense(f"{flax_p}/mlp/fc2", f"{torch_p}.mlp.0.fc2"))
    return m


def build_name_map(model_cfg) -> Dict[str, Tuple[str, str]]:
    """torch name -> (flax path, transform). Flax paths are '/'-joined under
    params; 'BS:' prefix marks batch_stats entries."""
    ptv3 = model_cfg["ptv3_config"]
    act = model_cfg["action_config"]
    cls = model_cfg["model_class"]
    use_ca = cls.endswith("CA")
    qk_norm = bool(ptv3.get("qk_norm", False))
    # AdaNorm variants train with PDNorm everywhere a norm_layer is used
    # (simple_policy_ptv3.yaml:122-128: pdnorm_bn/ln + adaptive, decouple
    # False); the released CA script disables it
    # (train_3dlotus_policy.sh:87-89). Mirrors SimplePolicyTPU's
    # norm_adaptive rule so converted trees always line up.
    adaptive = cls.endswith("AdaNorm") and \
        bool(ptv3.get("pdnorm_adaptive", True))
    # pdnorm_only_decoder (reference model.py:954,975,996): encoder
    # stem/pool/block norms are vanilla except the last encoder stage
    only_dec = bool(ptv3.get("pdnorm_only_decoder", False))
    add_coords = ptv3.get("add_coords_in_attn", "none")
    enable_rpe = bool(ptv3.get("enable_rpe", False))
    cosine = bool(ptv3.get("scaled_cosine_attn", False))
    enc_depths = list(ptv3["enc_depths"])
    dec_depths = list(ptv3["dec_depths"])
    num_stages = len(enc_depths)

    m = {}
    m.update(_dense("txt_fc", "txt_fc"))
    if act.get("txt_reduce") == "attn" and not use_ca:
        m.update(_dense("txt_attn_fc", "txt_attn_fc"))
    if act.get("use_ee_pose"):
        p = "pose_embedding"
        m.update(_dense(f"{p}/pos_embedding", f"{p}.pos_embedding"))
        m.update(_dense(f"{p}/rot_embedding", f"{p}.rot_embedding"))
        m[f"{p}.open_embedding.weight"] = (
            f"{p}/open_embedding/embedding", "copy")
        m.update(_ln(f"{p}/layer_norm", f"{p}.layer_norm"))
    if act.get("use_step_id"):
        m["stepid_embedding.weight"] = ("stepid_embedding/embedding", "copy")
    if cls.startswith("MotionPlanner"):
        m["pc_label_embedding.weight"] = (
            "pc_label_embedding/embedding", "copy")

    # backbone
    bp = "ptv3_model"
    m.update(_conv(f"{bp}/embedding_stem_conv", f"{bp}.embedding.stem.conv",
                   bias=False))
    # pdnorm_only_decoder is variant-specific (see models/ptv3.py): the
    # plain/AdaNorm backbone turns encoder norms vanilla (model.py:954-996)
    # while the CA backbone keeps norms adaptive but omits encoder CABlocks
    # except in the last stage (model_ca.py:296)
    only_dec_norms = only_dec and not use_ca
    m.update(_norm(f"{bp}/embedding_norm", f"{bp}.embedding.stem.norm",
                   "bn", adaptive and not only_dec_norms))
    for s in range(num_stages):
        if s > 0:
            m.update(_dense(f"{bp}/enc{s}_down/proj",
                            f"{bp}.enc.enc{s}.down.proj"))
            m.update(_norm(f"{bp}/enc{s}_down/norm",
                           f"{bp}.enc.enc{s}.down.norm.0", "bn",
                           adaptive and not only_dec_norms))
        blk_adaptive = adaptive and (
            not only_dec_norms or s == num_stages - 1)
        for i in range(enc_depths[s]):
            m.update(_block_map(f"{bp}/enc{s}_block{i}",
                                f"{bp}.enc.enc{s}.block{i}", qk_norm,
                                blk_adaptive, add_coords, enable_rpe,
                                cosine))
            if use_ca and (not only_dec or s == num_stages - 1):
                m.update(_ca_block_map(f"{bp}/enc{s}_cablock{i}",
                                       f"{bp}.enc.enc{s}.ca_block{i}",
                                       qk_norm))
    for s in range(num_stages - 1):
        up_f, up_t = f"{bp}/dec{s}_up", f"{bp}.dec.dec{s}.up"
        m.update(_dense(f"{up_f}/proj_fc", f"{up_t}.proj.0"))
        m.update(_norm(f"{up_f}/proj_norm", f"{up_t}.proj.1", "bn", adaptive))
        m.update(_dense(f"{up_f}/proj_skip_fc", f"{up_t}.proj_skip.0"))
        m.update(_norm(f"{up_f}/proj_skip_norm", f"{up_t}.proj_skip.1",
                       "bn", adaptive))
        for i in range(dec_depths[s]):
            m.update(_block_map(f"{bp}/dec{s}_block{i}",
                                f"{bp}.dec.dec{s}.block{i}", qk_norm,
                                adaptive, add_coords, enable_rpe, cosine))
            if use_ca:
                m.update(_ca_block_map(f"{bp}/dec{s}_cablock{i}",
                                       f"{bp}.dec.dec{s}.ca_block{i}",
                                       qk_norm))

    # head
    hp, ht = "act_proj_head", "act_proj_head"
    m.update(_dense(f"{hp}/heatmap_mlp_fc1", f"{ht}.heatmap_mlp.0"))
    m.update(_dense(f"{hp}/heatmap_mlp_fc2", f"{ht}.heatmap_mlp.3"))
    m.update(_dense(f"{hp}/action_mlp_fc1", f"{ht}.action_mlp.0"))
    m.update(_dense(f"{hp}/action_mlp_fc2", f"{ht}.action_mlp.3"))
    if cls.startswith("MotionPlanner") and act.get("traj_embed_size", 0) > 0:
        m[f"{ht}.traj_embedding.weight"] = (
            f"{hp}/traj_embedding/embedding", "copy")
    return m


# --------------------------------------------------------------------------
# tree <-> flat helpers
# --------------------------------------------------------------------------

def flatten_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def unflatten_tree(flat):
    root = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _spconv_to_flax(w, layout="out_k_in"):
    w = np.asarray(w)
    if layout == "out_k_in":  # (out, kx, ky, kz, in) -> (K, in, out)
        out_c, kx, ky, kz, in_c = w.shape
        return w.reshape(out_c, kx * ky * kz, in_c).transpose(1, 2, 0)
    if layout == "k_in_out":  # already (kx, ky, kz, in, out)
        kx, ky, kz, in_c, out_c = w.shape
        return w.reshape(kx * ky * kz, in_c, out_c)
    raise ValueError(layout)


def _flax_to_spconv(w, layout="out_k_in"):
    w = np.asarray(w)  # (K, in, out)
    K, in_c, out_c = w.shape
    k = round(K ** (1.0 / 3.0))  # stencil edge from K = k^3
    assert k ** 3 == K, (K, k)
    if layout == "out_k_in":
        return w.transpose(2, 0, 1).reshape(out_c, k, k, k, in_c)
    return w.reshape(k, k, k, in_c, out_c)


def torch_to_flax(state_dict, model_cfg, spconv_layout="out_k_in"):
    """Flat torch state_dict {name: np/torch tensor} -> (params, batch_stats)
    flat dicts keyed by '/'-joined paths."""
    name_map = build_name_map(model_cfg)
    params, batch_stats = {}, {}
    missing, unexpected = [], []
    for tname, (fpath, tf) in name_map.items():
        if tname not in state_dict:
            missing.append(tname)
            continue
        w = state_dict[tname]
        w = w.numpy() if hasattr(w, "numpy") else np.asarray(w)
        if tf == "t":
            w = w.T
        elif tf == "spconv":
            w = _spconv_to_flax(w, spconv_layout)
        if fpath.startswith("BS:"):
            batch_stats[fpath[3:]] = w
        else:
            params[fpath] = w
    mapped = set(name_map.keys())
    # dead reference params: CA-variant reference models construct
    # txt_attn_fc whenever txt_reduce == 'attn' but never call it (the CA
    # conditioning path uses ragged token context instead,
    # motion_planner_ptv3.py:420-421 + :437-463); tolerate those keys.
    dead = set()
    if model_cfg["model_class"].endswith("CA") and \
            model_cfg["action_config"].get("txt_reduce") == "attn":
        dead = {"txt_attn_fc.weight", "txt_attn_fc.bias"}
    for k in state_dict:
        if k not in mapped and k not in dead and \
                "num_batches_tracked" not in k:
            unexpected.append(k)
    return (unflatten_tree(params), unflatten_tree(batch_stats),
            missing, unexpected)


def flax_to_torch(params, batch_stats, model_cfg, spconv_layout="out_k_in"):
    """-> flat dict of numpy arrays with reference torch names."""
    name_map = build_name_map(model_cfg)
    flat_p = flatten_tree(params)
    flat_b = flatten_tree(batch_stats)
    out = {}
    for tname, (fpath, tf) in name_map.items():
        if fpath.startswith("BS:"):
            src = flat_b.get(fpath[3:])
        else:
            src = flat_p.get(fpath)
        if src is None:
            continue
        w = np.asarray(src)
        if tf == "t":
            w = w.T
        elif tf == "spconv":
            w = _flax_to_spconv(w, spconv_layout)
        out[tname] = w
    return out


def save_torch_checkpoint(path, params, batch_stats, model_cfg):
    """Writes an upstream-layout .pt."""
    state = flax_to_torch(params, batch_stats, model_cfg)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in state.items()}, path)


def load_torch_checkpoint(path, model_cfg):
    """-> (params, batch_stats, missing, unexpected) of torch_to_flax."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return torch_to_flax(sd, model_cfg)
