"""Language-model assembly for every arch family of the JAX package:

  dense  — (norm, GQA attn, norm, MLP) x L
  moe    — (norm, GQA attn, norm, MoE) x L
  ssm    — (norm, SSD) x L                              (attention-free)
  hybrid — Griffin super-blocks (rec, rec, local-attn) cyclic, the
           remainder layers recurrent
  vlm    — decoder with a cross-attention block every ``cross_attn_every``
           layers, over stub image embeddings ``batch["img_emb"]``
  encdec — Whisper: encoder (non-causal) over stub audio-frame embeddings
           ``batch["enc_emb"]`` + decoder (causal + cross), sinusoidal
           positions, no RoPE
  hybrid_moe — Granite 4.0-H (the port alone): per ``cfg.layer_kinds``,
           (norm, Mamba-2 SSD or GQA attention, norm, dropless MoE with a
           shared expert), each branch scaled by ``residual_multiplier``;
           decoded only through ``serving.decode.paged_decode_step``

Port of the JAX package's ``models/transformer.py``; the JAX ``lax.scan``
over stacked layer params becomes a Python loop over layers. Params keep
the JAX tree: ``{"embed", "ln_f", "blocks"}`` with every ``blocks`` leaf
stacked on a leading layer axis; for the hybrid ``{"super": {"rec":
leaves stacked (n_super, n_rec, ...), "attn": (n_super, ...)}, "rem"}``;
for the vlm ``{"super": {"self": (n_super, per - 1, ...), "cross":
(n_super, ...)}, "rem"}``; for encdec ``{"enc", "enc_ln", "blocks"}``;
for hybrid_moe ``{"mamba_blocks", "attn_blocks"}``, each stacked over its
own kind's layers in order.
So ``models.convert.params_from_jax`` is a leaf-by-leaf copy. Each
forward splits every stacked leaf once (``unstack``), so under autograd a
leaf's gradient is stacked once, as the scan's is. Under autograd each
block (a hybrid or vlm super-block as a whole) is rematerialised when
``cfg.remat`` (JAX's ``jax.checkpoint`` around the scan body):
``torch.utils.checkpoint`` keeps only its inputs and recomputes the block
in the backward pass. Caches are updated in place (the JAX functions
return new ones).

Two facts of the reference are kept, not repaired: Whisper's
``decode_step`` adds the sinusoid of position 0 at every step where
``forward`` adds positions 0..S-1, so prefill + decode does not give the
encdec forward's logits; and the vlm forward's cache ``{"super": {"k",
"v", "ck", "cv"}}`` is not ``init_cache``'s tree (which nests the self
caches under ``"self"`` and has ``"rem"``). Cross-attention runs
``full_attention`` in plain PyTorch, as the reference runs it outside its
Pallas kernel; only self-attention takes ``attn_impl``.

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

#: the arch families the port runs: all of the JAX package's, and
#: hybrid_moe
PORTED = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec", "hybrid_moe")


def require_ported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for an arch family the JAX package lacks."""
    if cfg.arch_type not in PORTED:
        raise ValueError(cfg.arch_type)


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


def _hybrid_moe_counts(cfg: ArchConfig):
    """(Mamba layers, attention layers)."""
    kinds = cfg.layer_kinds
    return kinds.count("mamba"), kinds.count("attention")


def hybrid_moe_layers(params, cfg: ArchConfig):
    """[(kind, index within its kind, the layer's tree)] in layer order."""
    n_m, n_a = _hybrid_moe_counts(cfg)
    stacks = {"mamba": unstack(params["mamba_blocks"], n_m),
              "attention": unstack(params["attn_blocks"], n_a)}
    seen = {"mamba": 0, "attention": 0}
    out = []
    for kind in cfg.layer_kinds:
        out.append((kind, seen[kind], stacks[kind][seen[kind]]))
        seen[kind] += 1
    return out


def _vlm_counts(cfg: ArchConfig):
    """(blocks a super-block (per - 1 self + 1 cross), super-blocks,
    remainder dense layers)."""
    per = cfg.cross_attn_every
    n_super, n_rem = divmod(cfg.num_layers, per)
    return per, n_super, n_rem


def _init_block(kind: str, cfg: ArchConfig, gen, wdt, lead: tuple, dev):
    """One block's tree, its leaves stacked on ``lead``: the JAX
    ``_init_{dense,moe,ssm,rec,cross,encdec_dec}_block``."""
    pdt = cfg.dtype("param")
    kw = dict(dtype=wdt, lead=lead, device=dev)
    ln = lambda: L.init_rms_norm(cfg.d_model, pdt, dev, lead=lead)
    attn = lambda cross=False: L.init_attention(cfg, gen, cross=cross, **kw)
    mlp = lambda: L.init_mlp(cfg, gen, **kw)
    if kind == "ssm":
        return {"ln": ln(), "ssm": S.init_ssm(cfg, gen, **kw)}
    if kind in ("mamba", "attention"):                      # hybrid_moe
        mixer = (S.init_ssm(cfg, gen, **kw) if kind == "mamba"
                 else attn())
        return {"ln1": ln(), ("ssm" if kind == "mamba" else "attn"): mixer,
                "ln2": ln(), "moe": M.init_moe(cfg, gen, **kw)}
    if kind == "rec":
        return {"ln1": ln(), "rec": R.init_rglru_block(cfg, gen, **kw),
                "ln2": ln(), "mlp": mlp()}
    if kind == "cross":
        return {"ln1": ln(), "cross": attn(cross=True), "ln2": ln(),
                "mlp": mlp()}
    if kind == "encdec_dec":
        return {"ln1": ln(), "attn": attn(), "ln2": ln(),
                "cross": attn(cross=True), "ln3": ln(), "mlp": mlp()}
    mixer = attn()
    ffn = M.init_moe(cfg, gen, **kw) if kind == "moe" else mlp()
    return {"ln1": ln(), "attn": mixer, "ln2": ln(),
            ("moe" if kind == "moe" else "mlp"): ffn}


def init_params(generator: torch.Generator, cfg: ArchConfig, *,
                weight_dtype: Optional[torch.dtype] = None, device=None):
    """Random params on ``device`` (default ``generator.device``). Each
    weight is drawn in fp32 and stored in ``weight_dtype`` (default: the
    config's param dtype) one tensor at a time, a stacked leaf one layer at
    a time; norm scales stay in the param dtype and ``convert.FP32_LEAVES``
    in fp32. Passing the compute dtype gives what
    ``convert.to_compute_dtype`` would, without the full fp32 copy ever
    existing. On ``torch.device("meta")`` the tree has every shape and
    dtype, and nothing is allocated or drawn."""
    require_ported(cfg)
    pdt = cfg.dtype("param")
    dev = L.init_device(generator, device)
    params = {"embed": L.init_embed(cfg, generator, dtype=weight_dtype,
                                    device=dev),
              "ln_f": L.init_rms_norm(cfg.d_model, pdt, dev)}
    block = lambda kind, *lead: _init_block(kind, cfg, generator,
                                            weight_dtype, lead, dev)
    t = cfg.arch_type
    if t == "hybrid":
        n_super, n_rem, n_rec = _hybrid_counts(cfg)
        params["super"] = {"rec": block("rec", n_super, n_rec),
                           "attn": block("dense", n_super)}
        if n_rem:
            params["rem"] = block("rec", n_rem)
    elif t == "vlm":
        per, n_super, n_rem = _vlm_counts(cfg)
        params["super"] = {"self": block("dense", n_super, per - 1),
                           "cross": block("cross", n_super)}
        if n_rem:
            params["rem"] = block("dense", n_rem)
    elif t == "hybrid_moe":
        n_m, n_a = _hybrid_moe_counts(cfg)
        params["mamba_blocks"] = block("mamba", n_m)
        params["attn_blocks"] = block("attention", n_a)
    elif t == "encdec":
        params["enc"] = block("dense", cfg.encoder_layers)
        params["enc_ln"] = L.init_rms_norm(cfg.d_model, pdt, dev)
        params["blocks"] = block("encdec_dec", cfg.num_layers)
    else:
        params["blocks"] = block(t, cfg.num_layers)
    return params


# ---------------------------------------------------------------------------
# Block applications (x -> x)
# ---------------------------------------------------------------------------

def _dense_block(bp, x, cfg, *, window=None, attn_impl="torch",
                 causal=True):
    h, kv = L.attention_forward(bp["attn"],
                                L.rms_norm(x, bp["ln1"], cfg.norm_eps),
                                cfg, causal=causal, window=window,
                                attn_impl=attn_impl)
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


def _cross_block(bp, x, src, cfg):
    """A vlm cross block: attention from ``x`` to ``src`` (no RoPE, no
    mask; plain PyTorch), then the MLP. Returns (x, (k, v) of ``src``)."""
    h, kv = L.attention_forward(bp["cross"],
                                L.rms_norm(x, bp["ln1"], cfg.norm_eps),
                                cfg, causal=False, kv_src=src)
    x = x + h
    x = x + L.mlp_forward(bp["mlp"], L.rms_norm(x, bp["ln2"], cfg.norm_eps),
                          cfg)
    return x, kv


def _vlm_super_block(sp, x, img, cfg, per: int, *, window=None,
                     attn_impl="torch"):
    """A vlm super-block: ``per - 1`` dense blocks, then the cross block
    over the image embeddings. Returns (x, k, v stacked over the dense
    blocks, (ck, cv))."""
    ks, vs = [], []
    for bp in unstack(sp["self"], per - 1):
        x, (k, v) = _dense_block(bp, x, cfg, window=window,
                                 attn_impl=attn_impl)
        ks.append(k)
        vs.append(v)
    x, ckv = _cross_block(sp["cross"], x, img, cfg)
    return x, torch.stack(ks), torch.stack(vs), ckv


def _encdec_block(bp, x, enc, cfg, *, attn_impl="torch"):
    """A Whisper decoder block: causal self-attention (full window), cross
    attention to the encoder output, MLP. Returns (x, (k, v), (ck, cv))."""
    h, kv = L.attention_forward(bp["attn"],
                                L.rms_norm(x, bp["ln1"], cfg.norm_eps), cfg,
                                attn_impl=attn_impl)
    x = x + h
    c, ckv = L.attention_forward(bp["cross"],
                                 L.rms_norm(x, bp["ln2"], cfg.norm_eps), cfg,
                                 causal=False, kv_src=enc)
    x = x + c
    x = x + L.mlp_forward(bp["mlp"], L.rms_norm(x, bp["ln3"], cfg.norm_eps),
                          cfg)
    return x, kv, ckv


def moe_ffn(bp, x, cfg, valid=None, stats=None):
    """A hybrid_moe layer's second half: x + r * moe(norm(x)). ``valid``
    (x's leading shape, bool): the rows routed to experts (default all).
    Up to ``moe.DENSE_MAX_ROWS`` rows the dense dispatch runs over every
    row, the others unrouted (no host read); above, the valid rows alone,
    gathered (one host read) and grouped by expert. ``stats``:
    ``moe_dropless``'s."""
    h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    shape = h.shape
    h2 = h.reshape(-1, shape[-1])
    if valid is not None and h2.shape[0] > M.DENSE_MAX_ROWS:
        vidx = valid.reshape(-1).nonzero()[:, 0]
        y = torch.zeros_like(h2).index_copy(
            0, vidx, M.moe_dropless(bp["moe"], h2[vidx], cfg))
    else:
        y = M.moe_dropless(bp["moe"], h2, cfg, stats=stats, live=(
            None if valid is None else valid.reshape(-1)))
    return x + cfg.residual_multiplier * y.reshape(shape)


def _mamba_moe_block(bp, x, cfg, state, valid):
    y, st = S.ssm_prefill(bp["ssm"], L.rms_norm(x, bp["ln1"], cfg.norm_eps),
                          cfg, state=state, valid=valid)
    x = x + cfg.residual_multiplier * y
    return moe_ffn(bp, x, cfg, valid), st


def _attn_moe_block(bp, x, cfg, valid, attn_impl="torch"):
    h, kv = L.attention_forward(bp["attn"],
                                L.rms_norm(x, bp["ln1"], cfg.norm_eps),
                                cfg, attn_impl=attn_impl)
    x = x + cfg.residual_multiplier * h
    return moe_ffn(bp, x, cfg, valid), kv


def _add_positions(x):
    """``x`` (B, S, d) plus the sinusoid of positions 0..S-1."""
    return x + L.sinusoidal_positions(x.shape[1], x.shape[2],
                                      x.device).to(x.dtype)


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
    """batch: {"tokens": (B,S) int}, plus "enc_emb" (B,S_enc,d) for
    encdec and "img_emb" (B,n_img,d) for vlm (the stub modality
    frontends' outputs). Returns (logits fp32 (B,S,V), aux_loss scalar
    (the MoE load-balance term summed over layers, else 0),
    cache-or-None). The cache is the JAX one: {"blocks": {"k","v":
    (L,B,S,K,hd)}} (dense, moe); {"blocks": (L,B,H,P,N)} the final SSD
    states (ssm); {"super": {"rec": (n_super,n_rec,B,d_rnn), "k","v":
    (n_super,B,S,K,hd)}, "rem": (n_rem,B,d_rnn)} (hybrid); {"super":
    {"k","v": (n_super,per-1,B,S,K,hd), "ck","cv": (n_super,B,n_img,K,
    hd)}} (vlm: nothing of the "rem" layers); {"blocks": {"k","v":
    (L,B,S,K,hd), "ck","cv": (L,B,S_enc,K,hd)}} (encdec); {"blocks":
    {"k","v": (n_attn,B,S,K,hd)}, "ssm": {"h": (n_mamba,B,H,P,N), "conv":
    (n_mamba,B,K-1,d_conv)}} (hybrid_moe).

    hybrid_moe also reads, where given: ``batch["valid"]`` (B,S) bool,
    each row's real positions, a prefix (right padding; the others are not
    routed to experts and leave the Mamba states as they were; ``moe_ffn``),
    and ``batch["ssm_h"]`` /
    ``batch["ssm_conv"]``, the Mamba states to start from, stacked like
    the cache's."""
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
    elif t == "hybrid":
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
    elif t == "hybrid_moe":
        valid = batch.get("valid")
        ks, vs, hs, convs = [], [], [], []
        for kind, i, bp in hybrid_moe_layers(params, cfg):
            if kind == "mamba":
                state = ({"h": batch["ssm_h"][i], "conv": batch["ssm_conv"][i]}
                         if "ssm_h" in batch else None)
                x, st = run(_mamba_moe_block, bp, x, cfg, state, valid)
                hs.append(st["h"])
                convs.append(st["conv"])
            else:
                x, (k, v) = run(_attn_moe_block, bp, x, cfg, valid,
                                attn_impl=attn_impl)
                ks.append(k)
                vs.append(v)
        if return_cache:
            cache["blocks"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
            cache["ssm"] = {"h": torch.stack(hs), "conv": torch.stack(convs)}
    elif t == "vlm":
        per, n_super, n_rem = _vlm_counts(cfg)
        img = batch["img_emb"].to(x.dtype)
        ks, vs, cks, cvs = [], [], [], []
        for sp in unstack(params["super"], n_super):
            x, k, v, (ck, cv) = run(_vlm_super_block, sp, x, img, cfg, per,
                                    window=window, attn_impl=attn_impl)
            if return_cache:
                ks.append(k)
                vs.append(v)
                cks.append(ck)
                cvs.append(cv)
        if return_cache:
            cache["super"] = {"k": torch.stack(ks), "v": torch.stack(vs),
                              "ck": torch.stack(cks),
                              "cv": torch.stack(cvs)}
        if n_rem:
            for bp in unstack(params["rem"], n_rem):
                x, _ = _dense_block(bp, x, cfg, window=window,
                                    attn_impl=attn_impl)
    else:                                                   # encdec
        x = _add_positions(x)
        enc = _add_positions(batch["enc_emb"].to(x.dtype))
        for bp in unstack(params["enc"], cfg.encoder_layers):
            enc, _ = run(_dense_block, bp, enc, cfg, causal=False,
                         attn_impl=attn_impl)
        enc = L.rms_norm(enc, params["enc_ln"], cfg.norm_eps)
        caches = []
        for bp in unstack(params["blocks"], cfg.num_layers):
            x, (k, v), (ck, cv) = run(_encdec_block, bp, x, enc, cfg,
                                      attn_impl=attn_impl)
            if return_cache:
                caches.append({"k": k, "v": v, "ck": ck, "cv": cv})
        if return_cache:
            cache["blocks"] = {key: torch.stack([c[key] for c in caches])
                               for key in ("k", "v", "ck", "cv")}
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
    "rec" and "rem"). The vlm's {"super": {"self": {"k","v"}, "ck", "cv"},
    "rem"} and encdec's {"blocks": {"k", "v", "ck", "cv"}} carry the image
    / encoder K/V of each cross block as zeros (B, n_img or S_enc, K, hd),
    which the caller may fill (e.g. from ``forward(return_cache=True)``);
    decode reads them and never writes them."""
    require_ported(cfg)
    _no_dense_decode(cfg)
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
    if t in ("vlm", "encdec"):
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        zeros = lambda lead, s: torch.zeros(lead + (batch, s, kv, hd),
                                            dtype=cfg.dtype("compute"),
                                            device=device)
        if t == "encdec":
            one = L.init_attn_cache(batch, cfg, seq_len, None, device=device)
            return {"blocks": dict(_stacked(one, (n,)),
                                   ck=zeros((n,), cfg.encoder_seq),
                                   cv=zeros((n,), cfg.encoder_seq))}
        per, n_super, n_rem = _vlm_counts(cfg)
        one = L.init_attn_cache(batch, cfg, seq_len, window, device=device)
        out = {"super": {"self": _stacked(one, (n_super, per - 1)),
                         "ck": zeros((n_super,), cfg.num_image_tokens),
                         "cv": zeros((n_super,), cfg.num_image_tokens)}}
        if n_rem:
            out["rem"] = _stacked(one, (n_rem,))
        return out
    n_super, n_rem, n_rec = _hybrid_counts(cfg)
    rec_one = R.init_rglru_cache(batch, cfg, device)
    attn_one = L.init_attn_cache(batch, cfg, seq_len,
                                 cfg.hybrid.local_window, device=device)
    out = {"super": {"rec": _stacked(rec_one, (n_super, n_rec)),
                     "attn": _stacked(attn_one, (n_super,))}}
    if n_rem:
        out["rem"] = _stacked(rec_one, (n_rem,))
    return out


def _no_dense_decode(cfg: ArchConfig) -> None:
    if cfg.arch_type == "hybrid_moe":
        raise ValueError("hybrid_moe decodes through the paged cache "
                         "(serving.decode.paged_decode_step), not a dense "
                         "per-batch cache")


def _layer(cache: dict, *idx) -> dict:
    """One layer's views of a stacked cache (writes land in the stack)."""
    return {k: a[idx] for k, a in cache.items()}


def _dense_decode(bp, x, c, pos: int, cfg, window):
    a, _ = L.attention_decode(bp["attn"],
                              L.rms_norm(x, bp["ln1"], cfg.norm_eps), c, pos,
                              cfg, window=window)
    x = x + a
    return x + L.mlp_forward(bp["mlp"], L.rms_norm(x, bp["ln2"], cfg.norm_eps),
                             cfg)


def _cross_decode(p, x, ck, cv, pos: int, cfg):
    """Cross-attention of one decode token over a static K/V cache."""
    a, _ = L.attention_decode(p, x, None, pos, cfg,
                              kv_src_cache={"k": ck, "v": cv})
    return a


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
    _no_dense_decode(cfg)
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
    elif t == "hybrid":
        n_super, n_rem, n_rec = _hybrid_counts(cfg)
        csup = cache["super"]
        for i, sp in enumerate(unstack(params["super"], n_super)):
            for j, bp in enumerate(unstack(sp["rec"], n_rec)):
                x = _rec_decode(bp, x, _layer(csup["rec"], i, j), cfg)
            x = _dense_decode(sp["attn"], x, _layer(csup["attn"], i), pos,
                              cfg, cfg.hybrid.local_window)
        if n_rem:
            for i, bp in enumerate(unstack(params["rem"], n_rem)):
                x = _rec_decode(bp, x, _layer(cache["rem"], i), cfg)
    elif t == "vlm":
        per, n_super, n_rem = _vlm_counts(cfg)
        csup = cache["super"]
        for i, sp in enumerate(unstack(params["super"], n_super)):
            for j, bp in enumerate(unstack(sp["self"], per - 1)):
                x = _dense_decode(bp, x, _layer(csup["self"], i, j), pos,
                                  cfg, window)
            bp = sp["cross"]
            x = x + _cross_decode(bp["cross"],
                                  L.rms_norm(x, bp["ln1"], cfg.norm_eps),
                                  csup["ck"][i], csup["cv"][i], pos, cfg)
            x = x + L.mlp_forward(bp["mlp"],
                                  L.rms_norm(x, bp["ln2"], cfg.norm_eps), cfg)
        if n_rem:
            for i, bp in enumerate(unstack(params["rem"], n_rem)):
                x = _dense_decode(bp, x, _layer(cache["rem"], i), pos, cfg,
                                  window)
    else:                                                   # encdec
        # the sinusoid of position 0 at every step, as the reference adds
        x = x + L.sinusoidal_positions(1, cfg.d_model, x.device).to(x.dtype)
        for i, bp in enumerate(unstack(params["blocks"], cfg.num_layers)):
            c = _layer(cache["blocks"], i)
            a, _ = L.attention_decode(
                bp["attn"], L.rms_norm(x, bp["ln1"], cfg.norm_eps), c, pos,
                cfg)
            x = x + a
            x = x + _cross_decode(bp["cross"],
                                  L.rms_norm(x, bp["ln2"], cfg.norm_eps),
                                  c["ck"], c["cv"], pos, cfg)
            x = x + L.mlp_forward(bp["mlp"],
                                  L.rms_norm(x, bp["ln3"], cfg.norm_eps), cfg)
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
