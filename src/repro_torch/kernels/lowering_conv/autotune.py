"""Per-layer tile autotuning of the lowering-conv kernels (the JAX
package's ``kernels/lowering_conv/autotune.py``: the paper's Fig. 4 b_p
sweep, automated).

The TPU kernels share one (b_p, r_b) grid tile across their three passes.
The CUDA kernels have other knobs, each its own pass's (``bwd.ConvTiles``):
the forward's (B2) tile width in output channels, wgrad's (B3) width and
the number of blocks its split over M aims at, and dgrad's (B4) width in
input channels. ``autotune_tiles`` times each pass's candidates that fit
the shared-memory budget (``lowering_conv.smem_bytes``) on the kernel
itself with ``engine.timing.probe`` (which synchronizes the card), one
pass at a time, and caches the fastest per layer geometry.
``models.cnn._conv`` looks the choice up (``cached_tiles``) on the
``lowering_cuda`` arm and runs ``DEFAULT_TILES`` (the fixed rule,
``bwd.default_tiles``) for a layer never probed. On the CPU the wrappers
run their plain versions, so a probe there times those.

Every candidate's launches are the kernel's: one that fails to build or
launch raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from repro_torch.engine import timing
from repro_torch.kernels.lowering_conv import bwd
from repro_torch.kernels.lowering_conv.lowering_conv import (
    BLOCK_N, lowering_conv_cuda, out_hw, smem_bytes)
from repro_torch.kernels.lowering_conv.ref import lower

#: a layer never probed runs the fixed rule, a function of its kernel shape
#: (the JAX constant (8, 8) has no counterpart: the widths follow the
#: channels)
DEFAULT_TILES = bwd.default_tiles
#: None: the card's opt-in shared memory per block (``budget_bytes_of``)
DEFAULT_BUDGET_BYTES = None
#: the sm_90 opt-in maximum (227 KiB), the budget off the card, where the
#: plain versions run and no tile is launched
SM90_SMEM_OPTIN_BYTES = 227 * 1024
#: wgrad's block targets probed: 1-6 blocks an SM of the H100's 132,
#: around ``bwd.WGRAD_TARGET_BLOCKS`` (3); one wgmma block is resident on
#: an SM at a time, so these are waves
WGRAD_BLOCKS = tuple(n * 132 for n in (1, 2, 3, 4, 6))
PASSES = ("fwd", "wgrad", "dgrad")

# geometry key -> (tiles, budget_bytes the probe ran under)
_TILE_CACHE: Dict[tuple, Tuple[bwd.ConvTiles, int]] = {}


def _cache_key(x_shape, w_shape, stride: int, device) -> tuple:
    """Keyed on the layer geometry WITHOUT the batch dimension: the engine
    runs the same conv at batch/g (a group) or batch/(g*k) (a rank's
    shard). The cache holds wgrad's block target, not its slice count, so
    each batch derives its own split (``bwd.wgrad_slices``)."""
    return (tuple(x_shape)[1:], tuple(w_shape), int(stride),
            torch.device(device).type)


def clear_tile_cache() -> None:
    _TILE_CACHE.clear()


def cached_tiles(x_shape, w_shape, stride: int,
                 device="cuda") -> bwd.ConvTiles:
    """The autotuned tiles for this layer geometry (batch-agnostic, see
    ``_cache_key``), or ``DEFAULT_TILES(w_shape)`` if it was never
    probed."""
    hit = _TILE_CACHE.get(_cache_key(x_shape, w_shape, stride, device))
    return hit[0] if hit is not None else DEFAULT_TILES(w_shape)


def put_tiles(x_shape, w_shape, stride: int, tiles: bwd.ConvTiles, *,
              device="cuda") -> None:
    """Cache ``tiles`` as if probed here (a rank taking rank 0's choice:
    every rank must run the same tiles, since wgrad's split sets the order
    of its sums)."""
    _TILE_CACHE[_cache_key(x_shape, w_shape, stride, device)] = (
        tiles, budget_bytes_of(device))


def budget_bytes_of(device="cuda") -> int:
    """The shared memory one block may ask for on ``device``: the card's
    opt-in maximum per block (232,448 bytes on an H100)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return SM90_SMEM_OPTIN_BYTES
    return torch.cuda.get_device_properties(
        dev).shared_memory_per_block_optin


def _max_smem(tiles: bwd.ConvTiles) -> int:
    """The largest block footprint among the three kernels' tiles."""
    return max(smem_bytes(pass_="fwd", block_n=tiles.fwd_bn),
               smem_bytes(pass_="wgrad", block_n=tiles.wgrad_bn),
               smem_bytes(pass_="dgrad", block_n=tiles.dgrad_bn))


def tile_candidates(x_shape, w_shape, stride: int, *,
                    budget_bytes=DEFAULT_BUDGET_BYTES,
                    device="cuda") -> Dict[str, List]:
    """Each pass's candidates whose block fits ``budget_bytes``, the
    default rule's first (the probe keeps it on a tie): ``{"fwd": [bn,
    ...], "wgrad": [(bn, blocks), ...], "dgrad": [bn, ...]}``. wgrad's
    (width, block target) pairs that give the same split over this
    batch's M rows are one launch, kept once. Raises if a pass has
    none."""
    if budget_bytes is None:
        budget_bytes = budget_bytes_of(device)
    b, h, w, _ = x_shape
    kh, kw, cin, cout = w_shape
    ho, wo = out_hw(h, w, kh, kw, stride)
    m, k = b * ho * wo, kh * kw * cin
    dflt = DEFAULT_TILES(w_shape)

    def widths(pass_, first):
        order = (first, *(bn for bn in BLOCK_N if bn != first))
        return [bn for bn in order
                if smem_bytes(pass_=pass_, block_n=bn) <= budget_bytes]

    out = {"fwd": widths("fwd", dflt.fwd_bn),
           "dgrad": widths("dgrad", dflt.dgrad_bn), "wgrad": []}
    seen = set()
    for bn in widths("wgrad", dflt.wgrad_bn):
        for blocks in (dflt.wgrad_blocks, *WGRAD_BLOCKS):
            split = (bn, bwd.wgrad_slices(m, k, cout, bn, blocks))
            if split not in seen:
                seen.add(split)
                out["wgrad"].append((bn, blocks))
    for pass_, cands in out.items():
        if not cands:
            raise ValueError(f"no {pass_} tile fits {budget_bytes} bytes of "
                             f"shared memory (smallest: "
                             f"{smem_bytes(pass_=pass_, block_n=64)})")
    return out


def autotune_tiles(x_shape, w_shape, stride: int = 1, *,
                   budget_bytes=DEFAULT_BUDGET_BYTES, device="cuda",
                   needs_dgrad: bool = True, warmup: int = 1,
                   iters: int = 5) -> bwd.ConvTiles:
    """Probe every in-budget candidate of each pass on its kernel (the
    forward with its residual, wgrad on that residual, dgrad unless
    ``needs_dgrad`` is false: a data-fed layer keeps the default dgrad
    width, or the first that fits) and cache the fastest of each.
    Idempotent per layer: a cache hit returns without probing, unless the
    cached choice no longer fits a (smaller) ``budget_bytes``. (A larger
    budget keeps the cached choice: still valid, possibly
    conservative.)"""
    budget = budget_bytes_of(device) if budget_bytes is None \
        else budget_bytes
    ck = _cache_key(x_shape, w_shape, stride, device)
    hit = _TILE_CACHE.get(ck)
    if hit is not None:
        tiles, probed_budget = hit
        if budget >= probed_budget or _max_smem(tiles) <= budget:
            return tiles
    from repro_torch.obs import spans

    cands = tile_candidates(x_shape, w_shape, stride, budget_bytes=budget,
                            device=device)
    probed = PASSES if needs_dgrad else ("fwd", "wgrad")
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(x_shape, generator=gen, device=dev)
    w = torch.randn(w_shape, generator=gen, device=dev) * 0.1
    kh, kw, _, cout = w_shape
    ho, wo = out_hw(x_shape[1], x_shape[2], kh, kw, stride)
    low = lower(x, kh, kw, stride).reshape(x_shape[0], ho, wo, -1)
    dy = torch.randn((x_shape[0], ho, wo, cout), generator=gen, device=dev)
    dflt = DEFAULT_TILES(w_shape)

    def call(pass_, cand):
        if pass_ == "fwd":
            t = dataclasses.replace(dflt, fwd_bn=cand)
            return lambda: lowering_conv_cuda(x, w, stride=stride,
                                              return_lowered=True, tiles=t)
        if pass_ == "wgrad":
            t = dataclasses.replace(dflt, wgrad_bn=cand[0],
                                    wgrad_blocks=cand[1])
            return lambda: bwd.wgrad_cuda(low, dy, w_shape, tiles=t)
        t = dataclasses.replace(dflt, dgrad_bn=cand)
        return lambda: bwd.dgrad_cuda(dy, w, x_shape, stride=stride,
                                      tiles=t)

    best = {p: c[0] for p, c in cands.items()}
    with spans.span("autotune.conv_tiles",
                    candidates=sum(len(cands[p]) for p in probed),
                    x_shape=tuple(x_shape), w_shape=tuple(w_shape),
                    stride=stride, budget_bytes=budget) as outer:
        for pass_ in probed:
            best_t = float("inf")
            for cand in cands[pass_]:
                bn, blocks = cand if pass_ == "wgrad" else (cand, None)
                with spans.span("autotune.candidate", pass_=pass_,
                                block_n=bn, wgrad_blocks=blocks,
                                launches=warmup + iters) as sp:
                    stats = timing.probe(call(pass_, cand), warmup=warmup,
                                         iters=iters)
                    sp.set(min_us=stats.min_s * 1e6)
                if stats.min_s < best_t:
                    best[pass_], best_t = cand, stats.min_s
        tiles = bwd.ConvTiles(best["fwd"], *best["wgrad"], best["dgrad"])
        outer.set(**dataclasses.asdict(tiles))
    _TILE_CACHE[ck] = (tiles, budget)
    return tiles
