"""Mixture-of-Experts layer: top-k router with capacity-based dispatch
(Switch/GShard style), optional shared experts (Qwen-MoE), and the router
load-balance auxiliary loss.

Port of the JAX package's ``models/moe.py`` with its formulation kept:

- dispatch is batch-local and sequence-chunked (a Python loop over chunks
  of ``MOE_CHUNK`` tokens where JAX has a ``lax.scan``): the position of a
  (token, choice) in its expert's buffer is a cumulative sum inside its
  own batch row, so a row's output never depends on the other rows;
- capacity is ``top_k * tokens * CAPACITY_FACTOR / num_experts``, capped
  at ``MAX_CAPACITY``; choices past an expert's capacity are dropped;
- every expert is computed densely on its ``(B, E, C, D)`` buffer, and the
  combine weights each (token, choice) by its renormalised gate.

``moe_dropless`` is Granite 4.0-H's layer: top-k of the router's logits,
the softmax over those k, every choice computed (no capacity, nothing
dropped), plus the shared expert. Its rows are given flat, (N, D). Two
dispatches:

- grouped: the (row, choice) pairs sorted by expert, the per-expert
  counts read to the host once, each expert's rows one GEMM, and the
  outputs put back in pair order and summed over a row's choices in a
  fixed order (no atomics: the same rows give the same bits). Every row
  is routed: a caller leaves out the rows it must not route;
- dense: every expert over every row as three batched
  GEMMs over the experts, combined by a (N, E) weight matrix that holds
  each row's k gates and zeros, so that a step has fixed shapes and no
  host read (a captured CUDA graph). ``live`` (N,) zeroes the weights of
  rows that are not routed (empty slots). ``stats`` accumulates on the
  device: ``hits`` (E,), the live rows' choices per expert, and ``live``,
  the experts that some live row chose, summed over calls.

The dense dispatch runs up to ``DENSE_MAX_ROWS`` rows, where reading
every expert's weights once costs less than the grouped loop's launches
(216 GEMMs a layer at Granite's 72 experts) and a step keeps fixed
shapes (the decode step, a captured prefill); the grouped one above.

The router is fp32 (``models.convert.FP32_LEAVES``) and the router
softmax runs in fp32. ``jax.lax.top_k`` and ``torch.topk`` break ties in
other orders; on fp32 probabilities of seeded inputs ties do not occur,
and the parity tests rely on that.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

CAPACITY_FACTOR = 1.25
MOE_CHUNK = 4096
MAX_CAPACITY = 1024
DENSE_MAX_ROWS = 4096


def init_moe(cfg: ArchConfig, generator: torch.Generator, *,
             dtype: Optional[torch.dtype] = None, lead: tuple = (),
             device=None):
    """The JAX tree: ``router`` (D, E) fp32, ``w_gate`` / ``w_up`` (E, D,
    F), ``w_down`` (E, F, D), and ``shared`` when the config has shared
    experts; ``lead`` prepends stacking axes."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    dt = dtype or cfg.dtype("param")
    dev = L.init_device(generator, device)
    p = {"router": L._randn((d, e), generator, d ** -0.5, torch.float32,
                            lead, dev),
         "w_gate": L._randn((e, d, f), generator, d ** -0.5, dt, lead, dev),
         "w_up": L._randn((e, d, f), generator, d ** -0.5, dt, lead, dev),
         "w_down": L._randn((e, f, d), generator, f ** -0.5, dt, lead, dev)}
    if m.num_shared_experts > 0:
        fs = cfg.shared_d_ff or m.num_shared_experts * f
        p["shared"] = {
            "w_gate": L._randn((d, fs), generator, d ** -0.5, dt, lead, dev),
            "w_up": L._randn((d, fs), generator, d ** -0.5, dt, lead, dev),
            "w_down": L._randn((fs, d), generator, fs ** -0.5, dt, lead,
                               dev)}
    return p


def capacity(tokens_per_row: int, cfg: ArchConfig) -> int:
    m = cfg.moe
    c = int(m.top_k * tokens_per_row * CAPACITY_FACTOR / m.num_experts)
    return max(1, min(c, MAX_CAPACITY))


def _chunk_moe(p, xk, cfg: ArchConfig):
    """One chunk. xk: (B, L, D) -> (y, (frac_tokens, mean_prob))."""
    m = cfg.moe
    cd = cfg.dtype("compute")
    b, n, d = xk.shape
    e, k = m.num_experts, m.top_k
    cap = capacity(n, cfg)

    logits = xk.float() @ p["router"].float()                 # (B,L,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)        # (B,L,k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    onehot = F.one_hot(gate_idx, e).to(torch.int32)          # (B,L,k,E)
    flat = onehot.reshape(b, n * k, e)
    # position within each expert's buffer (the cumsum stays in the row)
    pos = torch.cumsum(flat, dim=1) * flat - 1                # (B,Lk,E)
    keep = (pos < cap) & (flat > 0)
    # jax.nn.one_hot gives a zero row for pos = -1 and pos >= cap, where
    # F.one_hot raises: compare with arange(cap) instead
    slots = torch.arange(cap, device=xk.device)
    pos_oh = ((pos[..., None] == slots) & keep[..., None]).to(cd)  # (B,Lk,E,C)
    gates_flat = gate_vals.reshape(b, n * k).to(cd)
    x_rep = torch.repeat_interleave(xk, k, dim=1)            # (B,Lk,D)

    xin = torch.einsum("btec,btd->becd", pos_oh, x_rep)       # (B,E,C,D)
    gate = F.silu(torch.einsum("becd,edf->becf", xin, p["w_gate"].to(cd)))
    up = torch.einsum("becd,edf->becf", xin, p["w_up"].to(cd))
    out = torch.einsum("becf,efd->becd", gate * up, p["w_down"].to(cd))
    # combine back: weight each (token, choice) by its gate
    y = torch.einsum("btec,bt,becd->btd", pos_oh, gates_flat, out)
    y = y.reshape(b, n, k, d).sum(dim=2)

    # GShard load-balance stats (summed over chunks by the caller)
    frac_tokens = onehot.sum(dim=2).float().mean(dim=(0, 1))
    mean_prob = probs.mean(dim=(0, 1))
    return y, (frac_tokens, mean_prob)


def moe_forward(p, x, cfg: ArchConfig, chunk: int = MOE_CHUNK):
    """x: (B, S, D). Returns (y, aux_loss). The sequence is cut into
    chunks of ``chunk`` tokens when it is a multiple of ``chunk`` longer
    than one chunk; the load-balance stats are then averaged over the
    chunks before their product."""
    m = cfg.moe
    cd = cfg.dtype("compute")
    b, s, d = x.shape
    n = min(chunk, s)
    e = m.num_experts

    if s % n or s == n:
        y, (ft, mp) = _chunk_moe(p, x, cfg)
        aux = e * torch.sum(ft * mp)
    else:
        nc = s // n
        ft = torch.zeros((e,), dtype=torch.float32, device=x.device)
        mp = torch.zeros((e,), dtype=torch.float32, device=x.device)
        ys = []
        for c in range(nc):
            yc, (fc, mc) = _chunk_moe(p, x[:, c * n:(c + 1) * n], cfg)
            ft, mp = ft + fc, mp + mc
            ys.append(yc)
        y = torch.cat(ys, dim=1)
        aux = e * torch.sum((ft / nc) * (mp / nc))

    if "shared" in p:
        y = y + _shared(p["shared"], x.reshape(b * s, d), cd).reshape(b, s, d)

    return y, aux * m.router_aux_weight


def _shared(sp, xt, cd):
    h = F.silu(xt @ sp["w_gate"].to(cd)) * (xt @ sp["w_up"].to(cd))
    return h @ sp["w_down"].to(cd)


def route_topk(p, xt, cfg: ArchConfig):
    """(N, k) gates (the softmax over the k largest router logits, fp32)
    and expert ids of rows ``xt`` (N, D)."""
    logits = xt.float() @ p["router"].float()
    top, idx = torch.topk(logits, cfg.moe.top_k, dim=-1)
    return torch.softmax(top, dim=-1), idx


def _experts_grouped(p, xt, gates, idx, cd):
    n, k = idx.shape
    order = torch.argsort(idx.reshape(-1), stable=True)
    counts = torch.bincount(idx.reshape(-1), minlength=p["w_up"].shape[0])
    xs = xt[order // k]
    out = torch.empty_like(xs)
    start = 0
    for e, c in enumerate(counts.tolist()):       # the layer's one host read
        if c:
            seg = xs[start:start + c]
            h = F.silu(seg @ p["w_gate"][e].to(cd)) * (seg @ p["w_up"][e].to(cd))
            out[start:start + c] = h @ p["w_down"][e].to(cd)
            start += c
    pairs = torch.empty_like(out)
    pairs[order] = out
    w = gates.to(cd).reshape(-1, 1)
    return (pairs * w).reshape(n, k, xt.shape[-1]).sum(dim=1)


def _experts_dense(p, xt, gates, idx, cd, live, stats):
    e = p["w_up"].shape[0]
    w = torch.zeros((xt.shape[0], e), dtype=torch.float32, device=xt.device)
    w.scatter_(1, idx, gates)
    if live is not None:
        w = w * live[:, None]
    if stats is not None:
        chosen = torch.zeros_like(w).scatter_(1, idx, 1.0)
        if live is not None:
            chosen = chosen * live[:, None]
        per = chosen.sum(dim=0)
        stats["hits"] += per.to(stats["hits"].dtype)
        stats["live"] += (per > 0).sum().to(stats["live"].dtype)
    h = F.silu(torch.matmul(xt, p["w_gate"].to(cd))) \
        * torch.matmul(xt, p["w_up"].to(cd))                    # (E, N, F)
    out = torch.matmul(h, p["w_down"].to(cd))                    # (E, N, D)
    return torch.einsum("ne,end->nd", w.to(cd), out)


def moe_dropless(p, xt, cfg: ArchConfig, *, live=None, stats=None):
    """Dropless top-k MoE plus the shared expert over rows ``xt`` (N, D)
    (module docstring). ``live`` and ``stats``: the dense dispatch only."""
    cd = cfg.dtype("compute")
    gates, idx = route_topk(p, xt, cfg)
    if xt.shape[0] <= DENSE_MAX_ROWS:
        y = _experts_dense(p, xt, gates, idx, cd, live, stats)
    else:
        y = _experts_grouped(p, xt, gates, idx, cd)
    if "shared" in p:
        y = y + _shared(p["shared"], xt, cd)
    return y
