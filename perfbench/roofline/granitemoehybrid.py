"""The Granite 4.0-H family's counts (Hugging Face's key names): the layers
of ``layer_types[:num_hidden_layers]``, Mamba-2 or grouped-query attention,
each followed by a dropless top-k MoE and a shared expert, served in bf16
(the router and the Mamba-2 state in fp32).

A token's necessary work is its active weights: every layer's mixer,
router and shared expert, its top-k experts, and the tied head (the
embedding is a gather). Mamba-2's scan counts the recurrent form, 4 FLOPs
an element of the (heads, head size, state) state a token (the decay and
the input, then the read-out). A decode step reads every dense weight
once, the experts its live rows route to once (``live_experts`` a layer;
by default the number that k distinct choices a row, uniform over the
experts, reach in expectation, which the counter
``serving.moe_expert_hits`` can be held to), each live row's fp32 state
and conv tail once each way, and each live row's K and V pages.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from roofline.counts import BF16, F32


def dims(cfg: Dict) -> Dict:
    d, h = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    L = int(cfg["num_hidden_layers"])
    kinds = list(cfg["layer_types"][:L])
    H, P = int(cfg["mamba_n_heads"]), int(cfg["mamba_d_head"])
    N = int(cfg["mamba_d_state"])
    return {"d": d, "h": h, "k": int(cfg["num_key_value_heads"]),
            "hd": d // h, "f": int(cfg["intermediate_size"]),
            "fs": int(cfg["shared_intermediate_size"]),
            "E": int(cfg["num_local_experts"]),
            "topk": int(cfg["num_experts_per_tok"]), "L": L,
            "V": int(cfg["vocab_size"]), "n_m": kinds.count("mamba"),
            "n_a": kinds.count("attention"), "H": H, "P": P, "N": N,
            "d_inner": H * P, "C": H * P + 2 * N,
            "Kc": int(cfg["mamba_d_conv"])}


def expert_params(cfg: Dict) -> int:
    m = dims(cfg)
    return 3 * m["d"] * m["f"]


def layer_matmul_params(cfg: Dict, kind: str = "mamba") -> int:
    """The weights a token multiplies in one layer of ``kind``: the mixer,
    the router, the shared expert and its top-k experts."""
    m = dims(cfg)
    if kind == "mamba":
        mixer = m["d"] * (2 * m["d_inner"] + 2 * m["N"] + m["H"]) \
            + m["d_inner"] * m["d"]
    else:
        mixer = m["d"] * (m["h"] + 2 * m["k"]) * m["hd"] \
            + m["h"] * m["hd"] * m["d"]
    return (mixer + m["d"] * m["E"] + 3 * m["d"] * m["fs"]
            + m["topk"] * expert_params(cfg))


def matmul_params(cfg: Dict) -> int:
    """Weights that multiply every token: the layers' active ones and the
    head's."""
    m = dims(cfg)
    return (m["n_m"] * layer_matmul_params(cfg, "mamba")
            + m["n_a"] * layer_matmul_params(cfg, "attention")
            + m["d"] * m["V"])


def params(cfg: Dict) -> int:
    m = dims(cfg)
    moe = m["d"] * m["E"] + m["E"] * expert_params(cfg) \
        + 3 * m["d"] * m["fs"]
    norms = 2 * m["d"]
    mamba = (m["d"] * (2 * m["d_inner"] + 2 * m["N"] + m["H"])
             + m["d_inner"] * m["d"] + m["Kc"] * m["C"] + m["C"]
             + 3 * m["H"] + m["d_inner"])
    attn = m["d"] * (m["h"] + 2 * m["k"]) * m["hd"] + m["h"] * m["hd"] * m["d"]
    return (m["n_m"] * (mamba + moe + norms) + m["n_a"] * (attn + moe + norms)
            + m["d"] * m["V"] + m["d"])


def scan_flops(cfg: Dict, tokens: float) -> float:
    """Mamba-2's recurrence over ``tokens`` tokens, every Mamba layer."""
    m = dims(cfg)
    return m["n_m"] * 4.0 * m["H"] * m["P"] * m["N"] * tokens


def attention_flops(cfg: Dict, seq: int) -> float:
    """Causal attention of one sequence, both products, every attention
    layer."""
    m = dims(cfg)
    return m["n_a"] * 2.0 * m["h"] * m["hd"] * seq * seq


def forward_flops(cfg: Dict, lengths: Sequence[int]) -> float:
    return sum(2.0 * n * matmul_params(cfg) + attention_flops(cfg, n)
               + scan_flops(cfg, n) for n in lengths)


def train_round_flops(cfg: Dict, mix: Dict) -> float:
    """A round of ``mix["batch"]`` sequences of ``mix["seq"]`` tokens:
    forward and backward (twice the forward), no recomputation."""
    return 3.0 * forward_flops(cfg, [int(mix["seq"])] * int(mix["batch"]))


def live_experts(cfg: Dict, rows: int) -> float:
    """Experts a layer's ``rows`` live rows reach in expectation, each row
    choosing k distinct experts uniformly."""
    m = dims(cfg)
    return m["E"] * (1.0 - (1.0 - m["topk"] / m["E"]) ** rows)


def decode_step_work(cfg: Dict, contexts: Sequence[int],
                     live: Optional[float] = None):
    """(FLOPs, bytes) of one decode step over the active rows, whose
    contexts (cached tokens, the new one included) are ``contexts``.
    ``live``: experts a layer reads (default ``live_experts``)."""
    m = dims(cfg)
    rows = len(contexts)
    flops = 2.0 * rows * matmul_params(cfg) + scan_flops(cfg, rows) \
        + paged_flops(cfg, contexts)
    if live is None:
        live = live_experts(cfg, rows)
    dense = matmul_params(cfg) - m["L"] * (m["topk"] * expert_params(cfg)
                                           + m["d"] * m["E"])
    dense += m["n_m"] * m["Kc"] * m["C"]                     # conv weights
    nbytes = (BF16 * dense + F32 * m["L"] * m["d"] * m["E"]
              + BF16 * m["L"] * live * expert_params(cfg)
              + state_bytes(cfg, rows) + paged_bytes(cfg, contexts))
    return flops, nbytes


def state_bytes(cfg: Dict, rows: int) -> float:
    """Each live row's fp32 SSM state and bf16 conv tail, read and
    written, every Mamba layer."""
    m = dims(cfg)
    per = F32 * m["H"] * m["P"] * m["N"] + BF16 * (m["Kc"] - 1) * m["C"]
    return 2.0 * m["n_m"] * rows * per


def paged_bytes(cfg: Dict, contexts: Sequence[int]) -> float:
    """B6: each row's K and V pages read once (bf16), its query read and
    its output written, every attention layer."""
    m = dims(cfg)
    kv = 2.0 * m["k"] * m["hd"] * BF16 * float(sum(contexts))
    qo = 2.0 * m["h"] * m["hd"] * BF16 * len(contexts)
    return m["n_a"] * (kv + qo)


def paged_flops(cfg: Dict, contexts: Sequence[int]) -> float:
    m = dims(cfg)
    return m["n_a"] * 4.0 * m["h"] * m["hd"] * float(sum(contexts))


def flash_work(cfg: Dict, rows: int, seq: int):
    """B5 over ``rows`` causal sequences of ``seq`` tokens, every attention
    layer: (FLOPs, bytes of q, k, v read and the output written)."""
    m = dims(cfg)
    flops = m["n_a"] * rows * 2.0 * m["h"] * m["hd"] * seq * seq
    nbytes = m["n_a"] * rows * seq * (2 * m["h"] + 2 * m["k"]) * m["hd"] \
        * BF16
    return flops, nbytes
