"""Paged decode: ``models.layers.attention_decode`` generalized to a
per-request position vector over a page-table-indirected cache.

Port of the JAX package's ``serving/decode.py``: dense and MoE stacks
(the attention-free and Griffin hybrid families keep a recurrent state,
not a KV cache, and raise ``ValueError`` as the JAX function does), and
the port's hybrid_moe (Granite 4.0-H): its attention layers read and
write the pool, its Mamba layers advance the per-slot state held beside
it (``pages["ssm_h"]``, ``pages["ssm_conv"]``, ``paged_cache.init_state``)
for the active slots only, and its MoE is the dropless layer's dense
dispatch, every expert over every slot with the inactive slots unrouted:
fixed shapes and no host read, so the step captures as one graph.

Bitwise contract (pinned in ``tests/test_torch_serving.py``): gathering a
slot's pages yields exactly the dense ``(B, W, K, hd)`` ring buffer, the
validity mask is the reference mask evaluated per batch row, and every
einsum/softmax runs the same shapes in the same order — so on the plain
arm at full gather width, logits from ``paged_decode_step`` bit-match
``models.transformer.decode_step`` on the dense cache whenever the per-row
positions agree. Masked (out-of-range / never-written / scratch-backed)
cache entries cannot leak: their scores sit at ``-1e30`` so ``exp``
underflows to exactly ``0.0`` in fp32 before the value product.

Writes are recycle-safe and in place (the JAX version donates the pool
instead): gather the old page entry, ``where(active, new, old)``, scatter
back with ``index_put_``. Inactive slots' tables point at the reserved
scratch page 0, so colliding scatter indices always carry identical
payloads and the step stays deterministic as requests join and leave.

Attention implementations (``attn_impl``, see ``repro_torch.device``):

- ``"cuda"`` — the in-kernel paged flash-decode
  (``repro_torch.kernels.paged_attention``): the kernel walks the page
  table itself, pages are consumed in place with no dense copy, per-row
  ``pos`` bounds the live page walk, and a ring-aware mask covers sliding
  windows — no fallback.
- ``"torch"`` — the masked dense-gather reference. ``gather_pages``
  narrows the gather to the batch's live high-water page count: the view
  becomes the FIRST ``gather_pages`` ring slots and the mask its matching
  columns. ``gather_pages=None`` (or ``= max_pages``) is the full-width
  bitwise baseline arm.
- ``"cuda_gather"`` — the flash kernel over the gathered copy
  (``q_offsets=pos``). It needs a full (non-ring) cache: under a sliding
  window the ring wraps and slot order no longer equals position order,
  so this arm falls back to the masked plain path, and the server says so.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import ATTN_IMPLS, check_attn_impl
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import valid_mask
from repro_torch.kernels.ssm_decode import ops as sd_ops
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.transformer import (hybrid_moe_layers, moe_ffn,
                                            require_ported, unstack)

__all__ = ["ATTN_IMPLS", "PAGED_FAMILIES", "DecodeGraph",
           "check_paged_family", "paged_attention_decode",
           "paged_decode_step"]

#: the kernel wrappers whose ``launches`` a ``DecodeGraph`` replay adds to,
#: in the order of its ``launches``, ``flash_launches``, ``ssm_launches``
_COUNTED = (pa_ops.paged_attention, fa_ops.flash_attention, sd_ops.ssm_decode)

#: the arch families whose decode state is a KV cache that pages (with
#: per-slot recurrent state beside it for hybrid_moe)
PAGED_FAMILIES = ("dense", "moe", "hybrid_moe")


def check_paged_family(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a family paged decode does not serve."""
    if cfg.arch_type not in PAGED_FAMILIES:
        raise ValueError(f"paged decode supports "
                         f"{'/'.join(PAGED_FAMILIES)}, not "
                         f"{cfg.arch_type!r}")


def _write(pool, pid, in_page, new, act) -> None:
    """Recycle-safe in-place write of one row per slot: old -> where ->
    scatter, so inactive slots write back exactly what they read."""
    old = pool[pid, in_page]
    pool[pid, in_page] = torch.where(act, new, old)


def paged_attention_decode(p, x, k_pages, v_pages, table, pos, active,
                           cfg: ArchConfig, *, window: Optional[int] = None,
                           attn_impl: str = "torch",
                           gather_pages: Optional[int] = None):
    """One layer's decode over the paged pool.

    x: (B,1,D) hidden; k_pages/v_pages: (P, page, K, hd) this layer's pool
    (updated in place); table: (B, max_pages) int32 page ids (0 =
    scratch); pos: (B,) int32 absolute position per slot; active: (B,)
    bool live-request mask. ``gather_pages`` (plain path only): gather just
    the first ``gather_pages`` table columns — must cover every live row's
    pages (the server's bucket ladder guarantees it).
    Returns (out (B,1,D), (k_pages, v_pages)).
    """
    cd = cfg.dtype("compute")
    B = x.shape[0]
    _, page, K, hd = k_pages.shape
    max_pages = table.shape[1]
    W = max_pages * page

    q, k, v = L._project_qkv(p, x, None, cfg)
    posb = pos[:, None]                               # (B, 1)
    q = L.rope(q, posb, cfg.rope_theta)
    k = L.rope(k, posb, cfg.rope_theta)

    slot = (pos % W if window is not None else pos).long()
    page_idx = slot // page
    in_page = slot % page
    pid = table.long().gather(1, page_idx[:, None])[:, 0]      # (B,)

    act = active[:, None, None]
    _write(k_pages, pid, in_page, k[:, 0].to(k_pages.dtype), act)
    _write(v_pages, pid, in_page, v[:, 0].to(v_pages.dtype), act)

    if attn_impl == "cuda":
        out = pa_ops.paged_attention(q, k_pages, v_pages, table, pos,
                                     window=window)
    else:
        gp = max_pages if gather_pages is None else min(gather_pages,
                                                        max_pages)
        tb = (table if gp == max_pages else table[:, :gp]).long()
        Wb = gp * page
        ck = k_pages[tb].reshape(B, Wb, K, hd)       # the dense ring view
        cv = v_pages[tb].reshape(B, Wb, K, hd)
        if attn_impl == "cuda_gather" and window is None:
            out = fa_ops.flash_attention(q, ck.to(cd), cv.to(cd),
                                         causal=True, q_offsets=pos)
        else:
            # the mask is the full-ring reference evaluated per row, cut
            # to the gathered columns (the first Wb ring slots)
            valid = valid_mask(pos, W, window)[:, :Wb]
            scores = L._grouped_scores(q, ck.to(cd)).float()
            scores = scores + torch.where(valid, 0.0,
                                          -1e30)[:, None, None, None, :]
            w = torch.softmax(scores, dim=-1).to(cd)
            out = L._apply_scores(w, cv.to(cd))
    y = L._out_proj(out, p["wo"].to(cd))
    return y, (k_pages, v_pages)


def paged_decode_step(params, pages, table, tokens, pos, active,
                      cfg: ArchConfig, *, window: Optional[int] = None,
                      attn_impl: str = "torch",
                      gather_pages: Optional[int] = None, moe_stats=None):
    """One continuous-batching decode step for dense, MoE and hybrid_moe
    stacks.

    pages: {"k","v"}: (L, P, page, K, hd), updated in place (hybrid_moe:
    the attention layers', and the per-slot state); table: (B,
    max_pages) int32 shared by all layers; tokens: (B,1) int; pos: (B,)
    int32; active: (B,) bool. ``moe_stats`` (hybrid_moe): the dense
    dispatch's device counters, and ``steps``, the steps with an active
    row (``moe.moe_dropless``). Returns (logits (B,1,V) fp32, pages).
    Dense and MoE mirror ``transformer.decode_step``'s layer loop so the
    math bit-matches.
    """
    if window is None:
        window = cfg.sliding_window
    check_attn_impl(attn_impl, tokens.device)
    check_paged_family(cfg)
    require_ported(cfg)
    x = L.embed(params["embed"], tokens, cfg)
    if cfg.arch_type == "hybrid_moe":
        x = _hybrid_moe_layers(params, pages, x, table, pos, active, cfg,
                               attn_impl=attn_impl,
                               gather_pages=gather_pages, stats=moe_stats)
        x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
        return L.unembed(params["embed"], x, cfg), pages
    for i, bp in enumerate(unstack(params["blocks"], cfg.num_layers)):
        a, _ = paged_attention_decode(
            bp["attn"], L.rms_norm(x, bp["ln1"], cfg.norm_eps),
            pages["k"][i], pages["v"][i], table, pos, active, cfg,
            window=window, attn_impl=attn_impl, gather_pages=gather_pages)
        x = x + a
        h2 = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
        if cfg.arch_type == "dense":
            x = x + L.mlp_forward(bp["mlp"], h2, cfg)
        else:
            x = x + M.moe_forward(bp["moe"], h2, cfg)[0]
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg)
    return logits, pages


def _hybrid_moe_layers(params, pages, x, table, pos, active,
                       cfg: ArchConfig, *, attn_impl, gather_pages, stats):
    r = cfg.residual_multiplier
    if stats is not None:
        stats["steps"] += active.any().to(stats["steps"].dtype)
    for kind, i, bp in hybrid_moe_layers(params, cfg):
        h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
        if kind == "mamba":
            y, _ = S.ssm_decode(bp["ssm"], h, {"h": pages["ssm_h"][i],
                                               "conv": pages["ssm_conv"][i]},
                                cfg, active=active)
        else:
            y, _ = paged_attention_decode(
                bp["attn"], h, pages["k"][i], pages["v"][i], table, pos,
                active, cfg, attn_impl=attn_impl, gather_pages=gather_pages)
        x = moe_ffn(bp, x + r * y, cfg, active[:, None], stats=stats)
    return x


class DecodeGraph:
    """A decode step recorded once as a CUDA graph and replayed a step at a
    time.

    ``step(*operands) -> (logits, tokens)`` must hold no host read and
    keep its shapes, as ``paged_decode_step`` does at ``attn_impl="cuda"``
    (S slots, one token, the full table, the page walk in-kernel).
    ``operands`` are the graph's static inputs, all-inactive when handed
    in: ``step`` runs on them once eagerly on ``stream`` (an all-inactive
    step writes back exactly what it reads), which readies that stream's
    library handles, and is then captured on ``stream``, which executes
    nothing. The graph holds the addresses of whatever ``step`` reads and
    writes: a new page pool needs a new graph.

    ``replay`` copies a step's operands into the static ones (device
    copies, no host sync) and replays the graph on the current stream;
    ``logits`` and ``tokens`` are then that step's outputs, overwritten by
    the next replay. Each replay adds the B6, B5 and Mamba-2 decode
    launches the capture recorded (``launches``, ``flash_launches``,
    ``ssm_launches``) to ``paged_attention.launches``,
    ``flash_attention.launches`` and ``ssm_decode.launches``, which count
    kernel runs.

    The server records hybrid_moe's parallel prefill the same way, one
    graph a shape (``logits`` None), all of them in one memory ``pool``:
    they replay one at a time on one stream, and each keeps its outputs.
    """

    def __init__(self, step, operands, stream: torch.cuda.Stream,
                 pool=None):
        self.operands = operands
        current = torch.cuda.current_stream(stream.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            step(*operands)
        current.wait_stream(stream)
        before = [k.launches for k in _COUNTED]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream, pool=pool):
            self.logits, self.tokens = step(*operands)
        (self.launches, self.flash_launches, self.ssm_launches) = (
            k.launches - n for k, n in zip(_COUNTED, before))
        for k, n in zip(_COUNTED, before):
            k.launches = n

    def replay(self, *operands) -> None:
        for static, x in zip(self.operands, operands, strict=True):
            static.copy_(x)
        self.graph.replay()
        for k, n in zip(_COUNTED, (self.launches, self.flash_launches,
                                   self.ssm_launches)):
            k.launches += n
