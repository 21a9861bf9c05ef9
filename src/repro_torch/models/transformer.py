"""Language-model assembly for the families the port runs:

  dense  — (norm, GQA attn, norm, MLP) x L
  moe    — (norm, GQA attn, norm, MoE) x L
  ssm    — (norm, SSD) x L                              (attention-free)
  hybrid — Griffin super-blocks (rec, rec, local-attn) cyclic, the
           remainder layers recurrent

Port of the JAX package's ``models/transformer.py``; the JAX ``lax.scan``
over stacked layer params becomes a Python loop over layers. Params keep
the JAX tree: ``{"embed", "ln_f", "blocks"}`` with every ``blocks`` leaf
stacked on a leading layer axis, and for the hybrid ``{"super": {"rec":
leaves stacked (n_super, n_rec, ...), "attn": (n_super, ...)}, "rem"}``,
so ``models.convert.params_from_jax`` is a leaf-by-leaf copy. Each forward
splits every stacked leaf once (``unstack``), so under autograd a leaf's
gradient is stacked once, as the scan's is. Under autograd each block (a
hybrid super-block as a whole) is rematerialised when ``cfg.remat`` (JAX's
``jax.checkpoint`` around the scan body): ``torch.utils.checkpoint`` keeps
only its inputs and recomputes the block in the backward pass. Caches are
updated in place (the JAX functions return new ones).

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
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S

#: the arch families the port runs
PORTED = ("dense", "moe", "ssm", "hybrid")

#: arch families of the JAX package the port does not run yet, and the
#: ROADMAP entry that ports each
UNPORTED = {
    "vlm": "the cross-attention blocks (ROADMAP Queue A item 11: the vlm "
           "and encdec families)",
    "encdec": "the encoder-decoder blocks (ROADMAP Queue A item 11: the "
              "vlm and encdec families)",
}


def require_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port lacks."""
    t = cfg.arch_type
    if t in PORTED:
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

def _hybrid_counts(cfg: ArchConfig):
    """(super-blocks, remainder layers, rec blocks a super-block)."""
    pattern = cfg.hybrid.pattern
    n_super, n_rem = divmod(cfg.num_layers, len(pattern))
    return n_super, n_rem, sum(1 for x in pattern if x == "rec")


def _init_block(kind: str, cfg: ArchConfig, gen, wdt, lead: tuple):
    """One block's tree, its leaves stacked on ``lead``: the JAX
    ``_init_{dense,moe,ssm,rec}_block``."""
    pdt = cfg.dtype("param")
    ln = lambda: L.init_rms_norm(cfg.d_model, pdt, gen.device, lead=lead)
    if kind == "ssm":
        return {"ln": ln(), "ssm": S.init_ssm(cfg, gen, dtype=wdt, lead=lead)}
    if kind == "rec":
        return {"ln1": ln(),
                "rec": R.init_rglru_block(cfg, gen, dtype=wdt, lead=lead),
                "ln2": ln(),
                "mlp": L.init_mlp(cfg, gen, dtype=wdt, lead=lead)}
    mixer = L.init_attention(cfg, gen, dtype=wdt, lead=lead)
    ffn = (M.init_moe(cfg, gen, dtype=wdt, lead=lead) if kind == "moe"
           else L.init_mlp(cfg, gen, dtype=wdt, lead=lead))
    return {"ln1": ln(), "attn": mixer, "ln2": ln(),
            ("moe" if kind == "moe" else "mlp"): ffn}


def init_params(generator: torch.Generator, cfg: ArchConfig, *,
                weight_dtype: Optional[torch.dtype] = None):
    """Random params on ``generator.device``. Each weight is drawn in fp32
    and stored in ``weight_dtype`` (default: the config's param dtype) one
    tensor at a time (a stacked expert leaf one layer at a time); norm
    scales stay in the param dtype and ``convert.FP32_LEAVES`` in fp32.
    Passing the compute dtype gives what ``convert.to_compute_dtype``
    would, without the full fp32 copy ever existing."""
    require_ported(cfg)
    pdt = cfg.dtype("param")
    params = {"embed": L.init_embed(cfg, generator, dtype=weight_dtype),
              "ln_f": L.init_rms_norm(cfg.d_model, pdt, generator.device)}
    t = cfg.arch_type
    if t == "hybrid":
        n_super, n_rem, n_rec = _hybrid_counts(cfg)
        params["super"] = {
            "rec": _init_block("rec", cfg, generator, weight_dtype,
                               (n_super, n_rec)),
            "attn": _init_block("dense", cfg, generator, weight_dtype,
                                (n_super,))}
        if n_rem:
            params["rem"] = _init_block("rec", cfg, generator, weight_dtype,
                                        (n_rem,))
    else:
        params["blocks"] = _init_block(t, cfg, generator, weight_dtype,
                                       (cfg.num_layers,))
    return params


# ---------------------------------------------------------------------------
# Block applications (x -> x)
# ---------------------------------------------------------------------------

def _dense_block(bp, x, cfg, *, window=None, attn_impl="torch"):
    h, kv = L.attention_forward(bp["attn"],
                                L.rms_norm(x, bp["ln1"], cfg.norm_eps),
                                cfg, window=window, attn_impl=attn_impl)
    x = x + h
    x = x + L.mlp_forward(bp["mlp"], L.rms_norm(x, bp["ln2"], cfg.norm_eps),
                          cfg)
    return x, kv


def _moe_block(bp, x, cfg, *, window=None, attn_impl="torch"):
    h, kv = L.attention_forward(bp["attn"],
                                L.rms_norm(x, bp["ln1"], cfg.norm_eps),
                                cfg, window=window, attn_impl=attn_impl)
    x = x + h
    y, aux = M.moe_forward(bp["moe"], L.rms_norm(x, bp["ln2"], cfg.norm_eps),
                           cfg)
    return x + y, aux, kv


def _ssm_block(bp, x, cfg):
    y, hf = S.ssm_forward(bp["ssm"], L.rms_norm(x, bp["ln"], cfg.norm_eps),
                          cfg)
    return x + y, hf


def _rec_block(bp, x, cfg):
    y, hf = R.rglru_forward(bp["rec"], L.rms_norm(x, bp["ln1"], cfg.norm_eps),
                            cfg)
    x = x + y
    x = x + L.mlp_forward(bp["mlp"], L.rms_norm(x, bp["ln2"], cfg.norm_eps),
                          cfg)
    return x, hf


def _super_block(sp, x, cfg, n_rec: int, *, attn_impl="torch"):
    """A hybrid super-block: ``n_rec`` recurrent blocks, then the local
    attention block at the hybrid's window. Returns (x, states, (k, v))."""
    states = []
    for bp in unstack(sp["rec"], n_rec):
        x, st = _rec_block(bp, x, cfg)
        states.append(st)
    x, kv = _dense_block(sp["attn"], x, cfg, window=cfg.hybrid.local_window,
                         attn_impl=attn_impl)
    return x, torch.stack(states), kv


def _remat(on: bool):
    """``fn(*args, **kw)`` under ``torch.utils.checkpoint`` when ``on``
    (the blocks draw no random numbers: no RNG state to replay)."""
    if not on:
        return lambda fn, *a, **kw: fn(*a, **kw)
    return lambda fn, *a, **kw: checkpoint(fn, *a, use_reentrant=False,
                                           preserve_rng_state=False, **kw)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def forward(params, batch, cfg: ArchConfig, *, return_cache: bool = False,
            attn_impl: str = "torch", window: Optional[int] = None):
    """batch: {"tokens": (B,S) int}. Returns (logits fp32 (B,S,V), aux_loss
    scalar (the MoE load-balance term summed over layers, else 0),
    cache-or-None). The cache is the JAX one: {"blocks": {"k","v":
    (L,B,S,K,hd)}} (dense, moe); {"blocks": (L,B,H,P,N)} the final SSD
    states (ssm); {"super": {"rec": (n_super,n_rec,B,d_rnn), "k","v":
    (n_super,B,S,K,hd)}, "rem": (n_rem,B,d_rnn)} (hybrid)."""
    require_ported(cfg)
    if window is None:
        window = cfg.sliding_window
    x = L.embed(params["embed"], batch["tokens"], cfg)
    # remat only where a backward pass will follow
    run = _remat(cfg.remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in T.leaves(params)))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = {}
    t = cfg.arch_type
    if t in ("dense", "moe"):
        ks, vs, auxs = [], [], []
        for bp in unstack(params["blocks"], cfg.num_layers):
            if t == "dense":
                x, (k, v) = run(_dense_block, bp, x, cfg, window=window,
                                attn_impl=attn_impl)
            else:
                x, a, (k, v) = run(_moe_block, bp, x, cfg, window=window,
                                   attn_impl=attn_impl)
                auxs.append(a)
            if return_cache:
                ks.append(k)
                vs.append(v)
        if auxs:
            aux = torch.stack(auxs).sum()
        if return_cache:
            cache["blocks"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    elif t == "ssm":
        hfs = []
        for bp in unstack(params["blocks"], cfg.num_layers):
            x, hf = run(_ssm_block, bp, x, cfg)
            hfs.append(hf)
        if return_cache:
            cache["blocks"] = torch.stack(hfs)
    else:                                                   # hybrid
        n_super, n_rem, n_rec = _hybrid_counts(cfg)
        recs, ks, vs = [], [], []
        for sp in unstack(params["super"], n_super):
            x, st, (k, v) = run(_super_block, sp, x, cfg, n_rec,
                                attn_impl=attn_impl)
            if return_cache:
                recs.append(st)
                ks.append(k)
                vs.append(v)
        if return_cache:
            cache["super"] = {"rec": torch.stack(recs), "k": torch.stack(ks),
                              "v": torch.stack(vs)}
        if n_rem:
            rems = []
            for bp in unstack(params["rem"], n_rem):
                x, st = _rec_block(bp, x, cfg)
                rems.append(st)
            if return_cache:
                cache["rem"] = torch.stack(rems)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg)
    return logits, aux, (cache if return_cache else None)


def lm_loss(params, batch, cfg: ArchConfig, *, attn_impl: str = "torch",
            window: Optional[int] = None):
    """Next-token cross-entropy: batch needs "tokens" and "labels" (B,S)
    int. fp32 logits, ``log_softmax`` in fp32, mean over all positions,
    plus the aux loss (the MoE load-balance term; zero otherwise)."""
    logits, aux, _ = forward(params, batch, cfg, attn_impl=attn_impl,
                             window=window)
    logp = torch.log_softmax(logits, dim=-1)
    labels = batch["labels"].long()          # gather takes int64 indices
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return nll.mean() + aux


# ---------------------------------------------------------------------------
# Decode (one token, cached)
# ---------------------------------------------------------------------------

def _stacked(one: dict, lead: tuple) -> dict:
    """Each leaf of a one-layer cache repeated over ``lead`` layers."""
    return {k: a.expand(lead + a.shape).clone() for k, a in one.items()}


def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               window: Optional[int] = None, device="cpu"):
    """Decode state, the JAX layout: attention caches are (B, W, K, hd)
    ring buffers, W = min(window-or-sliding-window, seq_len) (the hybrid's
    attention at its local window), stacked per layer like the params;
    SSD states {"h", "conv"} (ssm), RG-LRU states {"h", "conv"} (hybrid's
    "rec" and "rem")."""
    require_ported(cfg)
    if window is None:
        window = cfg.sliding_window
    t = cfg.arch_type
    n = cfg.num_layers
    if t in ("dense", "moe"):
        one = L.init_attn_cache(batch, cfg, seq_len, window, device=device)
        return {"blocks": _stacked(one, (n,))}
    if t == "ssm":
        return {"blocks": _stacked(S.init_ssm_cache(batch, cfg, device),
                                   (n,))}
    n_super, n_rem, n_rec = _hybrid_counts(cfg)
    rec_one = R.init_rglru_cache(batch, cfg, device)
    attn_one = L.init_attn_cache(batch, cfg, seq_len,
                                 cfg.hybrid.local_window, device=device)
    out = {"super": {"rec": _stacked(rec_one, (n_super, n_rec)),
                     "attn": _stacked(attn_one, (n_super,))}}
    if n_rem:
        out["rem"] = _stacked(rec_one, (n_rem,))
    return out


def _layer(cache: dict, *idx) -> dict:
    """One layer's views of a stacked cache (writes land in the stack)."""
    return {k: a[idx] for k, a in cache.items()}


def _rec_decode(bp, x, c, cfg):
    y, _ = R.rglru_decode(bp["rec"], L.rms_norm(x, bp["ln1"], cfg.norm_eps),
                          c, cfg)
    x = x + y
    return x + L.mlp_forward(bp["mlp"], L.rms_norm(x, bp["ln2"], cfg.norm_eps),
                             cfg)


def decode_step(params, cache, tokens, pos: int, cfg: ArchConfig,
                window: Optional[int] = None):
    """tokens: (B,1) int; pos: int. Returns (logits (B,1,V), cache), the
    cache updated in place."""
    require_ported(cfg)
    if window is None:
        window = cfg.sliding_window
    x = L.embed(params["embed"], tokens, cfg)
    t = cfg.arch_type
    if t in ("dense", "moe"):
        for i, bp in enumerate(unstack(params["blocks"], cfg.num_layers)):
            a, _ = L.attention_decode(bp["attn"],
                                      L.rms_norm(x, bp["ln1"], cfg.norm_eps),
                                      _layer(cache["blocks"], i), pos, cfg,
                                      window=window)
            x = x + a
            h2 = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
            if t == "dense":
                x = x + L.mlp_forward(bp["mlp"], h2, cfg)
            else:
                x = x + M.moe_forward(bp["moe"], h2, cfg)[0]
    elif t == "ssm":
        for i, bp in enumerate(unstack(params["blocks"], cfg.num_layers)):
            y, _ = S.ssm_decode(bp["ssm"],
                                L.rms_norm(x, bp["ln"], cfg.norm_eps),
                                _layer(cache["blocks"], i), cfg)
            x = x + y
    else:                                                   # hybrid
        n_super, n_rem, n_rec = _hybrid_counts(cfg)
        csup = cache["super"]
        for i, sp in enumerate(unstack(params["super"], n_super)):
            for j, bp in enumerate(unstack(sp["rec"], n_rec)):
                x = _rec_decode(bp, x, _layer(csup["rec"], i, j), cfg)
            bp = sp["attn"]
            a, _ = L.attention_decode(
                bp["attn"], L.rms_norm(x, bp["ln1"], cfg.norm_eps),
                _layer(csup["attn"], i), pos, cfg,
                window=cfg.hybrid.local_window)
            x = x + a
            x = x + L.mlp_forward(bp["mlp"],
                                  L.rms_norm(x, bp["ln2"], cfg.norm_eps), cfg)
        if n_rem:
            for i, bp in enumerate(unstack(params["rem"], n_rem)):
                x = _rec_decode(bp, x, _layer(cache["rem"], i), cfg)
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
