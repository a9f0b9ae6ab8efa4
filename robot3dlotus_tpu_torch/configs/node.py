"""Minimal YACS-style hierarchical config.

A copy of robot3dlotus_tpu/configs/node.py, kept so that the PyTorch port
imports nothing of the JAX package: a yacs-like CfgNode with yaml merge of
';'-separated files, a CLI `KEY VALUE` opt list, and freeze.
"""
from __future__ import annotations

import ast
import copy
import yaml


class ConfigNode(dict):
    """Attribute-accessible nested dict with freeze semantics."""

    def __init__(self, init=None):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        if init:
            for k, v in init.items():
                self[k] = self._convert(v)

    @staticmethod
    def _convert(v):
        if isinstance(v, dict) and not isinstance(v, ConfigNode):
            return ConfigNode(v)
        return v

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"ConfigNode is frozen; cannot set {name}")
        self[name] = self._convert(value)

    def __setitem__(self, key, value):
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"ConfigNode is frozen; cannot set {key}")
        super().__setitem__(key, self._convert(value))

    # -- yacs-like API -------------------------------------------------------
    def freeze(self):
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()

    def defrost(self):
        object.__setattr__(self, "_frozen", False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()

    def is_frozen(self):
        return object.__getattribute__(self, "_frozen")

    def clone(self):
        return ConfigNode(copy.deepcopy(self.to_dict()))

    def to_dict(self):
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, ConfigNode) else copy.deepcopy(v)
        return out

    def merge_from_dict(self, other):
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), ConfigNode):
                self[k].merge_from_dict(v)
            else:
                self[k] = self._convert(v)

    def merge_from_file(self, path):
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        self.merge_from_dict(data)

    def merge_from_list(self, opts):
        """opts: flat list [KEY1, VALUE1, KEY2, VALUE2, ...]; dotted keys."""
        assert len(opts) % 2 == 0, f"odd-length opt list: {opts}"
        for key, raw in zip(opts[::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], ConfigNode):
                    node[p] = ConfigNode()
                node = node[p]
            node[parts[-1]] = _parse_value(raw)

    def dump(self, stream=None):
        return yaml.safe_dump(self.to_dict(), stream, default_flow_style=False)


def _parse_value(raw):
    if not isinstance(raw, str):
        return raw
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        lowered = raw.lower()
        if lowered in ("true", "false"):
            return lowered == "true"
        if lowered in ("null", "none"):
            return None
        return raw


def _default_config():
    # Mirrors reference defaults (configs/default.py:18-47).
    return ConfigNode({
        "SEED": 42,
        "output_dir": None,
        "tfboard_log_dir": None,
        "checkpoint": None,
        "checkpoint_strict_load": False,
        "world_size": 0,
        "local_rank": -1,
        "node_rank": 0,
        "TRAIN": {
            "resume_training": True,
            "resume_encoder_only": False,
            "train_batch_size": 16,
            "val_batch_size": 16,
            "gradient_accumulation_steps": 1,
            "num_epochs": None,
            "num_train_steps": 100000,
            "warmup_steps": 2000,
            "log_steps": 1000,
            "save_steps": 5000,
            "val_steps": 5000,
            "optim": "adamw",
            "learning_rate": 5e-4,
            "lr_sched": "linear",
            "num_cosine_cycles": None,
            "betas": [0.9, 0.98],
            "weight_decay": 0.01,
            "grad_norm": 5.0,
            "n_workers": 0,
            "pin_mem": True,
        },
    })


def get_config(exp_config=None, cli_opts=None):
    """Build a frozen config: defaults <- yaml file(s) (';'-separated) <- CLI opts.

    Parity with reference get_config (configs/default.py:60-92).
    """
    config = _default_config()
    if exp_config:
        for fname in str(exp_config).split(";"):
            fname = fname.strip()
            if fname:
                config.merge_from_file(fname)
    if cli_opts:
        config.merge_from_list(list(cli_opts))
    config.freeze()
    return config
