"""The Granite 4.0-H family (``granitemoehybrid``): a configuration file
(Hugging Face's key names) -> the program's hybrid_moe decoder and the
benchmark's seeded weights, in the layout the program's entry points
take.

The program runs ``layer_types[:num_hidden_layers]``. Its attention has
no rotary embedding (``position_embedding_type`` "nope": ``rope_theta``
0 in the program) and the softmax scale ``attention_multiplier``; the
shared expert is one SwiGLU of ``shared_intermediate_size``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from harness.weights import fill_tree

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: the embedding's scale. The head is the embedding (tied), and the
#: residual stream starts as 12 x the token's row: at 0.02 that row's own
#: logit stands ~11 standard deviations above the others' at full width,
#: and greedy decoding repeats the input token. At 0.002 it stands about
#: one above, and the served tokens spread over the vocabulary.
TOK_STD = 0.002


def program_config(config: Dict):
    """The program's ``ArchConfig``."""
    from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig
    d, h = int(config["hidden_size"]), int(config["num_attention_heads"])
    n_heads, p = int(config["mamba_n_heads"]), int(config["mamba_d_head"])
    assert n_heads * p % d == 0 and int(config["mamba_n_groups"]) == 1
    assert config["position_embedding_type"] == "nope"
    return ArchConfig(
        name=config["name"], arch_type="hybrid_moe",
        num_layers=int(config["num_hidden_layers"]), d_model=d, num_heads=h,
        num_kv_heads=int(config["num_key_value_heads"]),
        d_ff=int(config["intermediate_size"]),
        vocab_size=int(config["vocab_size"]), head_dim=d // h,
        qkv_bias=bool(config["attention_bias"]), rope_theta=0.0,
        norm_eps=float(config["rms_norm_eps"]),
        tie_embeddings=bool(config["tie_word_embeddings"]), act="swiglu",
        moe=MoEConfig(num_experts=int(config["num_local_experts"]),
                      top_k=int(config["num_experts_per_tok"]),
                      d_ff_expert=int(config["intermediate_size"]),
                      num_shared_experts=1),
        ssm=SSMConfig(state_dim=int(config["mamba_d_state"]), head_dim=p,
                      expand=n_heads * p // d,
                      chunk=int(config["mamba_chunk_size"]),
                      conv_width=int(config["mamba_d_conv"])),
        shared_d_ff=int(config["shared_intermediate_size"]),
        ssm_gated_norm=True,
        layer_types=tuple(config["layer_types"]),
        embedding_multiplier=float(config["embedding_multiplier"]),
        residual_multiplier=float(config["residual_multiplier"]),
        logits_scaling=float(config["logits_scaling"]),
        attention_multiplier=float(config["attention_multiplier"]),
        param_dtype=config["param_dtype"],
        compute_dtype=config["compute_dtype"],
        source=config.get("source", ""))


def _std(config: Dict):
    d, h = int(config["hidden_size"]), int(config["num_attention_heads"])
    f, fs = int(config["intermediate_size"]), \
        int(config["shared_intermediate_size"])
    d_inner = int(config["mamba_n_heads"]) * int(config["mamba_d_head"])
    table = {"tok": TOK_STD, "wq": d ** -0.5, "wk": d ** -0.5,
             "wv": d ** -0.5, "wo": d ** -0.5, "router": d ** -0.5,
             "in_proj": d ** -0.5, "conv_w": int(config["mamba_d_conv"])
             ** -0.5, "conv_b": 0.02, "out_proj": d_inner ** -0.5}

    def std(path, m) -> float:
        key = path[-1]
        if str(key).startswith("ln"):
            return 0.02                    # the (1 + scale) offsets
        if key in ("A_log", "D", "dt_bias"):
            return 1.0                     # set after the draw
        if key in ("w_gate", "w_up"):
            return d ** -0.5
        if key == "w_down":
            return (fs if "shared" in path else f) ** -0.5
        return table[key]
    return std


def _mamba_constants(blocks: Dict, config: Dict) -> None:
    """Mamba-2's initial values, the same in every layer: A in [1, 16]
    (``A_log = log A``), D = 1, and ``dt_bias`` the inverse softplus of dt
    spaced log-uniformly over [0.001, 0.1]."""
    ssm = blocks["ssm"]
    n = int(config["mamba_n_heads"])
    dev = ssm["A_log"].device
    a = torch.linspace(1.0, 16.0, n, device=dev)
    dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), n,
                                  device=dev))
    ssm["A_log"].copy_(torch.log(a).expand_as(ssm["A_log"]))
    ssm["D"].fill_(1.0)
    ssm["dt_bias"].copy_((dt + torch.log(-torch.expm1(-dt)))
                         .expand_as(ssm["dt_bias"]))


def params(config: Dict, seed: int, device, served: bool = False):
    """Seeded weights in the program's tree. ``served``: the matrices in
    the compute type, as served (norm offsets and the fp32 leaves keep
    their type); otherwise every leaf in the parameter type."""
    from repro_torch.models import transformer as M
    wd = _DTYPES[config["compute_dtype"]] if served else None
    meta = M.init_params(torch.Generator(), program_config(config),
                         weight_dtype=wd, device=torch.device("meta"))
    tree = fill_tree(meta, _std(config), seed, device)
    _mamba_constants(tree["mamba_blocks"], config)
    return tree
