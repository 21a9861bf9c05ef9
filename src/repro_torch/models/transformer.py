"""Language-model assembly, dense stacks: (norm, GQA attn, norm, MLP) x L.

Port of the JAX package's ``models/transformer.py`` for ``arch_type ==
"dense"``; the JAX ``lax.scan`` over stacked layer params becomes a Python
loop over layers. Params keep the JAX tree: ``{"embed", "ln_f", "blocks"}``
with every ``blocks`` leaf stacked on a leading layer axis, so
``models.convert.params_from_jax`` is a leaf-by-leaf copy. Caches are
updated in place (the JAX functions return new ones).

API:
  init_params(generator, cfg)                   -> params
  forward(params, batch, cfg, return_cache=...) -> (logits, aux, cache|None)
  init_cache(cfg, batch, seq_len)               -> cache (decode)
  decode_step(params, cache, tokens, pos, cfg)  -> (logits, cache)
  prefill(params, cache, tokens, cfg)           -> (logits, cache)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

#: arch families of the JAX package the port does not run yet, and the
#: ROADMAP entry that ports each
UNPORTED = {
    "moe": "models/moe.py (ROADMAP Queue A: MoE/SSM serving families)",
    "ssm": "models/ssm.py (ROADMAP Queue A: MoE/SSM serving families)",
    "hybrid": "models/rglru.py (ROADMAP Queue A: MoE/SSM serving families)",
    "vlm": "the cross-attention blocks (ROADMAP Queue A: LM families)",
    "encdec": "the encoder-decoder blocks (ROADMAP Queue A: LM families)",
}


def require_dense(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port lacks."""
    t = cfg.arch_type
    if t == "dense":
        return
    if t in UNPORTED:
        raise NotImplementedError(
            f"arch_type {t!r} ({cfg.name}) is not ported yet: it needs "
            f"{UNPORTED[t]}")
    raise ValueError(t)


def layer(blocks, i: int):
    """Layer ``i``'s params: the stacked ``blocks`` tree indexed at ``i``."""
    if isinstance(blocks, dict):
        return {k: layer(v, i) for k, v in blocks.items()}
    return blocks[i]


# ---------------------------------------------------------------------------
# init_params
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: ArchConfig, *,
                weight_dtype: Optional[torch.dtype] = None):
    """Random params on ``generator.device``. Each weight is drawn in fp32
    and stored in ``weight_dtype`` (default: the config's param dtype) one
    tensor at a time; norm scales stay in the param dtype. Passing the
    compute dtype gives what ``convert.to_compute_dtype`` would, without
    the full fp32 copy ever existing."""
    require_dense(cfg)
    dev = generator.device
    pdt = cfg.dtype("param")
    n = cfg.num_layers
    return {
        "embed": L.init_embed(cfg, generator, dtype=weight_dtype),
        "ln_f": L.init_rms_norm(cfg.d_model, pdt, dev),
        "blocks": {
            "ln1": L.init_rms_norm(cfg.d_model, pdt, dev, lead=(n,)),
            "attn": L.init_attention(cfg, generator, dtype=weight_dtype,
                                     lead=(n,)),
            "ln2": L.init_rms_norm(cfg.d_model, pdt, dev, lead=(n,)),
            "mlp": L.init_mlp(cfg, generator, dtype=weight_dtype,
                              lead=(n,)),
        },
    }


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _dense_block(bp, x, cfg, *, window=None, attn_impl="torch"):
    h, kv = L.attention_forward(bp["attn"],
                                L.rms_norm(x, bp["ln1"], cfg.norm_eps),
                                cfg, window=window, attn_impl=attn_impl)
    x = x + h
    x = x + L.mlp_forward(bp["mlp"], L.rms_norm(x, bp["ln2"], cfg.norm_eps),
                          cfg)
    return x, kv


def forward(params, batch, cfg: ArchConfig, *, return_cache: bool = False,
            attn_impl: str = "torch", window: Optional[int] = None):
    """batch: {"tokens": (B,S) int}. Returns (logits fp32 (B,S,V), aux_loss
    scalar, cache-or-None); the cache is {"blocks": {"k","v": (L,B,S,K,hd)}}."""
    require_dense(cfg)
    if window is None:
        window = cfg.sliding_window
    x = L.embed(params["embed"], batch["tokens"], cfg)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, (k, v) = _dense_block(layer(params["blocks"], i), x, cfg,
                                 window=window, attn_impl=attn_impl)
        if return_cache:
            ks.append(k)
            vs.append(v)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = ({"blocks": {"k": torch.stack(ks), "v": torch.stack(vs)}}
             if return_cache else None)
    return logits, aux, cache


# ---------------------------------------------------------------------------
# Decode (one token, cached)
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               window: Optional[int] = None, device="cpu"):
    """Decode state: (L, B, W, K, hd) ring buffers, W = min(window-or-
    sliding-window, seq_len)."""
    require_dense(cfg)
    if window is None:
        window = cfg.sliding_window
    one = L.init_attn_cache(batch, cfg, seq_len, window, device=device)
    return {"blocks": {name: a.repeat(cfg.num_layers, 1, 1, 1, 1)
                       for name, a in one.items()}}


def decode_step(params, cache, tokens, pos: int, cfg: ArchConfig,
                window: Optional[int] = None):
    """tokens: (B,1) int; pos: int. Returns (logits (B,1,V), cache), the
    cache updated in place."""
    require_dense(cfg)
    if window is None:
        window = cfg.sliding_window
    x = L.embed(params["embed"], tokens, cfg)
    for i in range(cfg.num_layers):
        bp = layer(params["blocks"], i)
        c = {name: cache["blocks"][name][i] for name in ("k", "v")}
        a, _ = L.attention_decode(bp["attn"],
                                  L.rms_norm(x, bp["ln1"], cfg.norm_eps),
                                  c, pos, cfg, window=window)
        x = x + a
        x = x + L.mlp_forward(bp["mlp"],
                              L.rms_norm(x, bp["ln2"], cfg.norm_eps), cfg)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg), cache


def prefill(params, cache, tokens, cfg: ArchConfig,
            window: Optional[int] = None):
    """Prompt prefill as a loop of ``decode_step`` over prompt positions
    (cache-consistent with decode, ring buffers included). Returns the
    logits at the last prompt position (B,1,V) and the cache."""
    P = tokens.shape[1]
    for t in range(P - 1):
        _, cache = decode_step(params, cache, tokens[:, t:t + 1], t, cfg,
                               window)
    return decode_step(params, cache, tokens[:, P - 1:P], P - 1, cfg, window)
