"""Core transformer layers: RMSNorm, RoPE, sinusoidal positions, GQA
attention (full / chunked / cross / decode-with-cache), SwiGLU & GeLU
MLPs, embedding.

Port of the JAX package's ``models/layers.py`` with its numerics kept:

- ``rms_norm`` scales by ``(1 + scale)`` in fp32 (scales start at zero);
- RoPE rotates *interleaved* pairs ``x[..., 0::2], x[..., 1::2]``;
- weights are cast to the compute dtype at every use (``.to(cd)``, a
  no-op once ``models.convert.to_compute_dtype`` has cast them at load);
- scores are taken in the compute dtype, softmaxed in fp32 with ``-1e30``
  masking, and cast back before the value product;
- logits are the compute-dtype product cast to fp32;
- Granite's scalings where the config sets them: embeddings times
  ``embedding_multiplier``, logits over ``logits_scaling``, and q times
  ``attention_multiplier * sqrt(hd)`` so that every attention path's
  ``1/sqrt(hd)`` gives the configured softmax scale (NoPE is
  ``rope_theta = 0``, where ``rope`` is the identity).

Params are nested dicts of tensors with the JAX package's key names. The
JAX sharding hooks (``constrain_batch``, ``maybe_replicate_for_decode``,
``constrain_kv_seq``) are the identity on one device and are dropped.
``attn_impl="cuda"`` routes prefill attention through the flash kernel
(``repro_torch.kernels.flash_attention``), which is forward-only: asked for
gradients, it raises. Training takes ``full_attention`` or, from
``CHUNKED_ATTN_THRESHOLD`` tokens on, ``chunked_attention`` (a Python loop
over KV chunks where JAX has a ``lax.scan``) under autograd.
"""
from __future__ import annotations

import itertools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import check_attn_impl
from repro_torch.kernels.flash_attention import ops as fa_ops

# Threshold at/above which train/prefill attention switches to the chunked
# (flash-semantics) implementation to avoid materializing S^2 scores.
CHUNKED_ATTN_THRESHOLD = 4096
KV_CHUNK = 1024


def init_device(generator: torch.Generator, device=None) -> torch.device:
    """Where an ``init_*`` puts its params: ``device``, default the
    generator's. ``torch.device("meta")`` gives the tree's shapes and
    dtypes without allocating or drawing (``launch/steps.params_specs``)."""
    return generator.device if device is None else torch.device(device)


def _randn(shape, generator: torch.Generator, std: float,
           dtype: torch.dtype, lead: tuple = (), device=None) -> torch.Tensor:
    """Normal(0, std) drawn in fp32 on ``init_device(generator, device)``,
    stored in ``dtype``, one leading index of ``lead + shape`` at a time in
    row-major order: the fp32 draw of a stacked leaf (30 GB for
    llama-3.2-vision's ``w_up`` at 40 layers) never exists whole. On the
    CPU the numbers are those of one draw of the whole leaf wherever a
    layer holds a multiple of 16 values (the generator fills normals in
    blocks of 16). On the meta device nothing is drawn."""
    dev = init_device(generator, device)
    out = torch.empty(lead + tuple(shape), dtype=dtype, device=dev)
    if dev.type == "meta":
        return out
    for idx in itertools.product(*map(range, lead)):
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        out[idx] = x.mul_(std)
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dtype)


def init_rms_norm(d: int, dtype, device, lead: tuple = ()) -> torch.Tensor:
    return torch.zeros(lead + (d,), dtype=dtype, device=device)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal position embeddings (fp32), (seq, d)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp(-math.log(10_000.0) * dim / d)
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd); positions: (..., S)."""
    if theta <= 0.0:
        return x
    hd = x.shape[-1]
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    angles = positions[..., :, None].float() * freqs      # (..., S, hd/2)
    angles = angles[..., None, :]                          # over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.stack([r1, r2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(cfg: ArchConfig, generator: torch.Generator, *,
                   dtype: Optional[torch.dtype] = None, lead: tuple = (),
                   cross: bool = False, device=None):
    """``dtype`` overrides the stored dtype (default: the param dtype);
    ``lead`` prepends axes, e.g. ``(num_layers,)`` for a stacked block.
    A ``cross`` (cross-attention) block has no qkv biases. ``device``:
    ``init_device``."""
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    dt = dtype or cfg.dtype("param")
    std = d ** -0.5
    dev = init_device(generator, device)
    p = {"wq": _randn((d, h, hd), generator, std, dt, lead, dev),
         "wk": _randn((d, kv, hd), generator, std, dt, lead, dev),
         "wv": _randn((d, kv, hd), generator, std, dt, lead, dev),
         "wo": _randn((h, hd, d), generator, std, dt, lead, dev)}
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros(lead + (h, hd), dtype=dt, device=dev)
        p["bk"] = torch.zeros(lead + (kv, hd), dtype=dt, device=dev)
        p["bv"] = torch.zeros(lead + (kv, hd), dtype=dt, device=dev)
    return p


def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(p, x, kv_src, cfg: ArchConfig):
    cd = cfg.dtype("compute")
    q = _proj(x, p["wq"].to(cd))
    src = x if kv_src is None else kv_src
    k = _proj(src, p["wk"].to(cd))
    v = _proj(src, p["wv"].to(cd))
    if "bq" in p:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    if cfg.attention_multiplier is not None:
        # every attention path divides the scores by sqrt(hd) (B5 and B6
        # take no scale): q carries the rest of the configured scale
        q = q * (cfg.attention_multiplier * math.sqrt(q.shape[-1]))
    return q, k, v


def _out_proj(out, wo):
    """einsum("bshk,hkd->bsd") as one matmul over the flattened heads."""
    h, k, d = wo.shape
    return out.flatten(-2) @ wo.reshape(h * k, d)


def _grouped_scores(q, k):
    """q (B,Sq,H,hd), k (B,Sk,K,hd) with H = K*G -> scores (B,K,G,Sq,Sk)."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, hd)
    return torch.einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(hd)


def _apply_scores(w, v):
    """w (B,K,G,Sq,Sk), v (B,Sk,K,hd) -> (B,Sq,H,hd)."""
    b, kh, g, sq, sk = w.shape
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(b, sq, kh * g, v.shape[-1])


def _mask_bias(sq, sk, q_offset, *, causal: bool, window: Optional[int],
               device=None):
    """Additive mask bias (Sq,Sk) in fp32. q position i attends to k
    position j."""
    qpos = torch.arange(sq, device=device) + q_offset
    kpos = torch.arange(sk, device=device)
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        ok &= kpos[None, :] > (qpos[:, None] - window)
    return torch.where(ok, 0.0, -1e30).float()


def full_attention(q, k, v, *, causal: bool, window: Optional[int] = None,
                   q_offset: int = 0):
    """Reference O(S^2)-memory attention (grouped-query)."""
    scores = _grouped_scores(q, k).float()
    bias = _mask_bias(q.shape[1], k.shape[1], q_offset, causal=causal,
                      window=window, device=q.device)
    w = torch.softmax(scores + bias, dim=-1).to(q.dtype)
    return _apply_scores(w, v)


def chunked_attention(q, k, v, *, causal: bool, window: Optional[int] = None,
                      kv_chunk: int = KV_CHUNK):
    """Flash-semantics attention: a loop over KV chunks with running
    max/denominator. O(Sq * kv_chunk) live score memory."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    kh = k.shape[2]
    g = h // kh
    if sk % kv_chunk != 0:
        return full_attention(q, k, v, causal=causal, window=window)
    qg = q.reshape(b, sq, kh, g, hd)
    qpos = torch.arange(sq, device=q.device)
    m = torch.full((b, kh, g, sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kh, g, sq, hd), dtype=q.dtype, device=q.device)
    for idx in range(sk // kv_chunk):
        kb = k[:, idx * kv_chunk:(idx + 1) * kv_chunk]
        vb = v[:, idx * kv_chunk:(idx + 1) * kv_chunk]
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg, kb).float()
        scores = scores / math.sqrt(hd)
        kpos = idx * kv_chunk + torch.arange(kv_chunk, device=q.device)
        ok = torch.ones((sq, kv_chunk), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            ok &= kpos[None, :] > (qpos[:, None] - window)
        scores = scores + torch.where(ok, 0.0, -1e30)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(q.dtype), vb)
        acc = acc * alpha[..., None].to(q.dtype) + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None].to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)


def attention_forward(p, x, cfg: ArchConfig, *, positions=None, causal=True,
                      window: Optional[int] = None, kv_src=None,
                      attn_impl: str = "torch"):
    """Train/prefill attention over a whole sequence. Returns (out, (k, v))
    so prefill can populate a cache."""
    cd = cfg.dtype("compute")
    check_attn_impl(attn_impl, x.device)
    q, k, v = _project_qkv(p, x, kv_src, cfg)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    if kv_src is None:  # self-attention gets RoPE
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if attn_impl == "cuda":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            raise NotImplementedError(
                "attn_impl='cuda': the flash kernel is forward-only, as the "
                "reference's Pallas kernel is, so it cannot carry "
                "gradients; train with attn_impl='torch' (an attention "
                "backward kernel is not ported: ROADMAP Queue A item 10)")
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    elif x.shape[1] >= CHUNKED_ATTN_THRESHOLD and kv_src is None:
        out = chunked_attention(q, k, v, causal=causal, window=window)
    else:
        out = full_attention(q, k, v, causal=causal, window=window)
    y = _out_proj(out, p["wo"].to(cd))
    return y, (k, v)


def attention_decode(p, x, cache, pos: int, cfg: ArchConfig, *,
                     window: Optional[int] = None, kv_src_cache=None):
    """Single-token decode. x: (B,1,D). cache: {"k","v"}: (B,W,K,hd) ring
    buffer (W = window or full seq), updated in place. pos: absolute
    position (int). With ``kv_src_cache`` ({"k","v"}: (B,Sk,K,hd), the
    image or encoder K/V) it is cross-attention over that static cache:
    no update, no RoPE, ``full_attention``. Returns (out, cache)."""
    cd = cfg.dtype("compute")
    if kv_src_cache is not None:
        q = _proj(x, p["wq"].to(cd))
        if "bq" in p:
            q = q + p["bq"].to(cd)
        out = full_attention(q, kv_src_cache["k"], kv_src_cache["v"],
                             causal=False)
        return _out_proj(out, p["wo"].to(cd)), cache
    q, k, v = _project_qkv(p, x, None, cfg)
    posb = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                      device=x.device)
    q = rope(q, posb, cfg.rope_theta)
    k = rope(k, posb, cfg.rope_theta)
    W = cache["k"].shape[1]
    slot = pos % W if window is not None else pos
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    # validity: absolute position of ring slot s
    slots = torch.arange(W, device=x.device)
    if window is not None:
        base = pos - (pos % W)
        abs_pos = torch.where(slots <= (pos % W), base + slots,
                              base - W + slots)
    else:
        abs_pos = slots
    valid = (abs_pos <= pos) & (abs_pos >= 0)
    if window is not None:
        valid &= abs_pos > (pos - window)
    scores = _grouped_scores(q, cache["k"].to(cd)).float()
    scores = scores + torch.where(valid, 0.0, -1e30)[None, None, None, None, :]
    w = torch.softmax(scores, dim=-1).to(cd)
    out = _apply_scores(w, cache["v"].to(cd))
    y = _out_proj(out, p["wo"].to(cd))
    return y, cache


def init_attn_cache(batch: int, cfg: ArchConfig, seq_len: int,
                    window: Optional[int] = None, device="cpu"):
    W = min(window, seq_len) if window is not None else seq_len
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = cfg.dtype("compute")
    return {"k": torch.zeros((batch, W, kv, hd), dtype=dt, device=device),
            "v": torch.zeros((batch, W, kv, hd), dtype=dt, device=device)}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(cfg: ArchConfig, generator: torch.Generator,
             d_ff: Optional[int] = None, *,
             dtype: Optional[torch.dtype] = None, lead: tuple = (),
             device=None):
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    dt = dtype or cfg.dtype("param")
    p = {"w_up": _randn((d, f), generator, d ** -0.5, dt, lead, device),
         "w_down": _randn((f, d), generator, f ** -0.5, dt, lead, device)}
    if cfg.act == "swiglu":
        p["w_gate"] = _randn((d, f), generator, d ** -0.5, dt, lead, device)
    return p


def mlp_forward(p, x, cfg: ArchConfig):
    cd = cfg.dtype("compute")
    up = x @ p["w_up"].to(cd)
    if cfg.act == "swiglu":
        h = F.silu(x @ p["w_gate"].to(cd)) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ p["w_down"].to(cd)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def init_embed(cfg: ArchConfig, generator: torch.Generator, *,
               dtype: Optional[torch.dtype] = None, device=None):
    dt = dtype or cfg.dtype("param")
    p = {"tok": _randn((cfg.vocab_size, cfg.d_model), generator, 0.02, dt,
                       device=device)}
    if not cfg.tie_embeddings:
        p["unembed"] = _randn((cfg.d_model, cfg.vocab_size), generator,
                              cfg.d_model ** -0.5, dt, device=device)
    return p


def embed(p, tokens, cfg: ArchConfig):
    x = p["tok"].to(cfg.dtype("compute"))[tokens.long()]
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    return x


def unembed(p, x, cfg: ArchConfig):
    w = p["unembed"] if "unembed" in p else p["tok"].T
    logits = (x @ w.to(cfg.dtype("compute"))).float()
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return logits
