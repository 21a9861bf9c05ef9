"""The Qwen2 family's counts (Hugging Face's key names): a dense decoder
with grouped-query attention and a SwiGLU MLP, served in bf16."""
from __future__ import annotations

from typing import Dict, Sequence

from roofline.counts import BF16


def dims(cfg: Dict) -> Dict[str, int]:
    d = int(cfg["hidden_size"])
    h = int(cfg["num_attention_heads"])
    return {"d": d, "h": h, "k": int(cfg["num_key_value_heads"]),
            "hd": int(cfg.get("head_dim", d // h)),
            "f": int(cfg["intermediate_size"]),
            "L": int(cfg["num_hidden_layers"]), "V": int(cfg["vocab_size"])}


def layer_matmul_params(cfg: Dict) -> int:
    m = dims(cfg)
    return (m["d"] * (m["h"] + 2 * m["k"]) * m["hd"] + m["h"] * m["hd"] * m["d"]
            + 3 * m["d"] * m["f"])


def matmul_params(cfg: Dict) -> int:
    """Weights that multiply every token: the layers' and the head's (the
    embedding is a gather)."""
    m = dims(cfg)
    return m["L"] * layer_matmul_params(cfg) + m["d"] * m["V"]


def params(cfg: Dict) -> int:
    m = dims(cfg)
    per = (layer_matmul_params(cfg) + (m["h"] + 2 * m["k"]) * m["hd"]
           + 2 * m["d"])
    head = m["d"] * m["V"] * (1 if cfg.get("tie_word_embeddings") else 2)
    return m["L"] * per + head + m["d"]


def attention_flops(cfg: Dict, seq: int) -> float:
    """Causal attention of one sequence, both products, every layer."""
    m = dims(cfg)
    return m["L"] * 2.0 * m["h"] * m["hd"] * seq * seq


def forward_flops(cfg: Dict, lengths: Sequence[int]) -> float:
    return sum(2.0 * n * matmul_params(cfg) + attention_flops(cfg, n)
               for n in lengths)


def train_round_flops(cfg: Dict, mix: Dict) -> float:
    """A round of ``mix["batch"]`` sequences of ``mix["seq"]`` tokens:
    forward and backward (twice the forward), no recomputation."""
    return 3.0 * forward_flops(cfg, [int(mix["seq"])] * int(mix["batch"]))


def decode_step_work(cfg: Dict, contexts: Sequence[int]):
    """(FLOPs, bytes) of one decode step over the active rows, whose
    contexts (cached tokens, the new one included) are ``contexts``:
    every bf16 weight read once, every row's cache read once."""
    m = dims(cfg)
    rows, ctx = len(contexts), float(sum(contexts))
    flops = 2.0 * rows * matmul_params(cfg) \
        + m["L"] * 4.0 * m["h"] * m["hd"] * ctx
    nbytes = BF16 * matmul_params(cfg) + paged_bytes(cfg, contexts)
    return flops, nbytes


def paged_bytes(cfg: Dict, contexts: Sequence[int]) -> float:
    """B6: each row's K and V pages read once (bf16), its query read and
    its output written, every layer."""
    m = dims(cfg)
    kv = 2.0 * m["k"] * m["hd"] * BF16 * float(sum(contexts))
    qo = 2.0 * m["h"] * m["hd"] * BF16 * len(contexts)
    return m["L"] * (kv + qo)


def paged_flops(cfg: Dict, contexts: Sequence[int]) -> float:
    m = dims(cfg)
    return m["L"] * 4.0 * m["h"] * m["hd"] * float(sum(contexts))


def flash_work(cfg: Dict, rows: int, seq: int):
    """B5 over ``rows`` causal sequences of ``seq`` tokens, every layer:
    (FLOPs, bytes of q, k, v read and the output written)."""
    m = dims(cfg)
    flops = m["L"] * rows * 2.0 * m["h"] * m["hd"] * seq * seq
    nbytes = m["L"] * rows * seq * (2 * m["h"] + 2 * m["k"]) * m["hd"] * BF16
    return flops, nbytes
