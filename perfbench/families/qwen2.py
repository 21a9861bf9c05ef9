"""The Qwen2 family: a configuration file (Hugging Face's key names) ->
the program's decoder and the benchmark's seeded weights, in the layout
the program's entry points take.

A family file gives ``program_config(config)``, ``params(config, seed,
device, served)`` and ``train_program(config, settings, seed, device)``;
the runners find it by the configuration's ``family``.
"""
from __future__ import annotations

from typing import Dict

import torch

from harness.weights import fill_tree

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def program_config(config: Dict):
    """The program's ``ArchConfig``: a dense decoder with q, k and v
    biases and a SwiGLU MLP."""
    from repro_torch.configs.base import ArchConfig
    d, h = int(config["hidden_size"]), int(config["num_attention_heads"])
    return ArchConfig(
        name=config["name"], arch_type="dense",
        num_layers=int(config["num_hidden_layers"]), d_model=d, num_heads=h,
        num_kv_heads=int(config["num_key_value_heads"]),
        d_ff=int(config["intermediate_size"]),
        vocab_size=int(config["vocab_size"]),
        head_dim=int(config.get("head_dim", d // h)), qkv_bias=True,
        rope_theta=float(config["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]),
        tie_embeddings=bool(config.get("tie_word_embeddings", False)),
        act="swiglu", param_dtype=config["param_dtype"],
        compute_dtype=config["compute_dtype"],
        source=config.get("source", ""))


def _std(config: Dict):
    d, h = int(config["hidden_size"]), int(config["num_attention_heads"])
    hd = int(config.get("head_dim", d // h))
    f = int(config["intermediate_size"])
    table = {"tok": 0.02, "unembed": d ** -0.5, "wq": d ** -0.5,
             "wk": d ** -0.5, "wv": d ** -0.5, "wo": (h * hd) ** -0.5,
             "bq": 0.02, "bk": 0.02, "bv": 0.02, "w_up": d ** -0.5,
             "w_gate": d ** -0.5, "w_down": f ** -0.5}

    def std(path, m) -> float:
        key = path[-1]
        if str(key).startswith("ln"):
            return 0.02                    # the (1 + scale) offsets
        return table[key]
    return std


def params(config: Dict, seed: int, device, served: bool = False):
    """Seeded weights in the program's tree. ``served``: the matrices in
    the compute type, as served (norm offsets keep the parameter type);
    otherwise every leaf in the parameter type."""
    from repro_torch.models import transformer as M
    wd = _DTYPES[config["compute_dtype"]] if served else None
    meta = M.init_params(torch.Generator(), program_config(config),
                         weight_dtype=wd, device=torch.device("meta"))
    return fill_tree(meta, _std(config), seed, device)


def train_program(config: Dict, settings: Dict, seed: int, device):
    """-> (loss function, head filter, initial weights) for ``Engine``."""
    from repro_torch.models import transformer as M
    cfg = program_config(config)
    return (lambda p, b: M.lm_loss(p, b, cfg)), None, \
        params(config, seed, device)
