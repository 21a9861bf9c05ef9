"""Language-model assembly, dense stacks: (norm, GQA attn, norm, MLP) x L.

Port of the JAX package's ``models/transformer.py`` for ``arch_type ==
"dense"``; the JAX ``lax.scan`` over stacked layer params becomes a Python
loop over layers. Params keep the JAX tree: ``{"embed", "ln_f", "blocks"}``
with every ``blocks`` leaf stacked on a leading layer axis, so
``models.convert.params_from_jax`` is a leaf-by-leaf copy. Each forward
splits every stacked leaf once (``unstack``), so under autograd a leaf's
gradient is stacked once, as the scan's is. Under autograd each block is
rematerialised when ``cfg.remat`` (JAX's ``jax.checkpoint`` around the scan
body): ``torch.utils.checkpoint`` keeps only its inputs and recomputes the
block in the backward pass. Caches are updated in place (the JAX functions
return new ones).

API:
  init_params(generator, cfg)                   -> params
  forward(params, batch, cfg, return_cache=...) -> (logits, aux, cache|None)
  lm_loss(params, batch, cfg)                   -> scalar next-token loss
  init_cache(cfg, batch, seq_len)               -> cache (decode)
  decode_step(params, cache, tokens, pos, cfg)  -> (logits, cache)
  prefill(params, cache, tokens, cfg)           -> (logits, cache)
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tree as T
from repro_torch.models import layers as L

#: arch families of the JAX package the port does not run yet, and the
#: ROADMAP entry that ports each
UNPORTED = {
    "moe": "models/moe.py (ROADMAP Queue A item 11: MoE/SSM serving "
           "families)",
    "ssm": "models/ssm.py (ROADMAP Queue A item 11: MoE/SSM serving "
           "families)",
    "hybrid": "models/rglru.py (ROADMAP Queue A item 11: MoE/SSM serving "
              "families)",
    "vlm": "the cross-attention blocks (ROADMAP Queue A item 11: LM "
           "families)",
    "encdec": "the encoder-decoder blocks (ROADMAP Queue A item 11: LM "
              "families)",
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


def unstack(blocks, n: int):
    """The stacked ``blocks`` tree as ``n`` per-layer trees, with one
    ``torch.unbind`` per leaf (views). Under autograd each leaf's gradient
    is then one stack of its n slices; indexing the leaf once per layer
    would make each select's backward write a zero-filled tensor the size
    of the whole leaf."""
    if isinstance(blocks, dict):
        per = {k: unstack(v, n) for k, v in blocks.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    parts = torch.unbind(blocks, 0)
    if len(parts) != n:
        raise ValueError(f"stacked leaf has {len(parts)} layers, not {n}")
    return parts


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
    # remat only where a backward pass will follow
    remat = cfg.remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in T.leaves(params))
    ks, vs = [], []
    for bp in unstack(params["blocks"], cfg.num_layers):
        if remat:
            # the blocks draw no random numbers: no RNG state to replay
            x, (k, v) = checkpoint(_dense_block, bp, x, cfg, window=window,
                                   attn_impl=attn_impl, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            x, (k, v) = _dense_block(bp, x, cfg, window=window,
                                     attn_impl=attn_impl)
        if return_cache:
            ks.append(k)
            vs.append(v)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = ({"blocks": {"k": torch.stack(ks), "v": torch.stack(vs)}}
             if return_cache else None)
    return logits, aux, cache


def lm_loss(params, batch, cfg: ArchConfig, *, attn_impl: str = "torch",
            window: Optional[int] = None):
    """Next-token cross-entropy: batch needs "tokens" and "labels" (B,S)
    int. fp32 logits, ``log_softmax`` in fp32, mean over all positions
    (plus the aux loss, zero for dense stacks)."""
    logits, aux, _ = forward(params, batch, cfg, attn_impl=attn_impl,
                             window=window)
    logp = torch.log_softmax(logits, dim=-1)
    labels = batch["labels"].long()          # gather takes int64 indices
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return nll.mean() + aux


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
    for i, bp in enumerate(unstack(params["blocks"], cfg.num_layers)):
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
