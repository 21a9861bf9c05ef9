"""Griffin / RecurrentGemma recurrent block: gated temporal conv + RG-LRU.
[arXiv:2402.19427]

RG-LRU:  a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x_t))
         h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (sigmoid(W_x x_t) * x_t)

Port of the JAX package's ``models/rglru.py``. Training and prefill
evaluate the linear recurrence in fp32 with a log-depth doubling scan
(``linear_scan``; JAX: ``lax.associative_scan``, which sums in another
order); decode is the O(1) step, the decode state updated in place.
``lambda_raw`` is fp32 and read in fp32 (``models.convert.FP32_LEAVES``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

RG_C = 8.0


def _d_rnn(cfg: ArchConfig) -> int:
    return cfg.hybrid.d_rnn or cfg.d_model


def init_rglru_block(cfg: ArchConfig, generator: torch.Generator, *,
                     dtype: Optional[torch.dtype] = None, lead: tuple = (),
                     device=None):
    """The JAX tree of one recurrent block; ``lead`` prepends stacking
    axes."""
    d = cfg.d_model
    dr = _d_rnn(cfg)
    k = cfg.hybrid.conv_width
    dt = dtype or cfg.dtype("param")
    dev = L.init_device(generator, device)
    return {
        "w_gate_branch": L._randn((d, dr), generator, d ** -0.5, dt, lead,
                                  dev),
        "w_rec_in": L._randn((d, dr), generator, d ** -0.5, dt, lead, dev),
        "conv_w": L._randn((k, dr), generator, 0.1, dt, lead, dev),
        "conv_b": torch.zeros(lead + (dr,), dtype=dt, device=dev),
        "w_a": L._randn((dr, dr), generator, dr ** -0.5, dt, lead, dev),
        "w_x": L._randn((dr, dr), generator, dr ** -0.5, dt, lead, dev),
        "lambda_raw": torch.full(lead + (dr,), 0.65, dtype=torch.float32,
                                 device=dev),
        "w_out": L._randn((dr, d), generator, dr ** -0.5, dt, lead, dev),
    }


def _rg_lru_coeffs(p, x, cd):
    """x: (..., d_rnn) conv output. Returns (a, b) of h = a*h_prev + b."""
    r = torch.sigmoid((x @ p["w_a"].to(cd)).float())
    i = torch.sigmoid((x @ p["w_x"].to(cd)).float())
    log_a = -RG_C * F.softplus(p["lambda_raw"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-8)) \
        * (i * x.float())
    return a, b


def _causal_conv(x, w, b, cd):
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i].to(cd) for i in range(k))
    return out + b.to(cd)


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along dim 1, by doubling:
    after the step of stride k, (a_t, b_t) compose the (up to) 2k steps
    ending at t, so log2(S) steps of elementwise products and sums."""
    s = a.shape[1]
    k = 1
    while k < s:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b


def rglru_forward(p, u, cfg: ArchConfig, state=None):
    """Full-sequence recurrent block. u: (B,S,D). Returns (y, final_state)."""
    cd = cfg.dtype("compute")
    gate = F.gelu(u @ p["w_gate_branch"].to(cd), approximate="tanh")
    x = u @ p["w_rec_in"].to(cd)
    x = _causal_conv(x, p["conv_w"], p["conv_b"], cd)
    a, bb = _rg_lru_coeffs(p, x, cd)
    if state is not None:
        # fold the incoming state into the first step
        bb = torch.cat([bb[:, :1] + a[:, :1] * state[:, None], bb[:, 1:]],
                       dim=1)
    h = linear_scan(a, bb)
    y = (h.to(cd) * gate) @ p["w_out"].to(cd)
    return y, h[:, -1, :]


def init_rglru_cache(batch: int, cfg: ArchConfig, device="cpu"):
    dr = _d_rnn(cfg)
    return {
        "h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.hybrid.conv_width - 1, dr),
                            dtype=cfg.dtype("compute"), device=device),
    }


def rglru_decode(p, u, cache, cfg: ArchConfig):
    """Single-token step. u: (B,1,D); cache {"h": (B,dr) fp32, "conv":
    (B,K-1,dr)}, updated in place. Returns (y, cache)."""
    cd = cfg.dtype("compute")
    gate = F.gelu(u @ p["w_gate_branch"].to(cd), approximate="tanh")
    x = u @ p["w_rec_in"].to(cd)
    hist = torch.cat([cache["conv"], x.to(cache["conv"].dtype)], dim=1)
    w = p["conv_w"].to(cd)
    xt = (hist * w[None]).sum(dim=1, keepdim=True) + p["conv_b"].to(cd)
    a, bb = _rg_lru_coeffs(p, xt, cd)
    h = a[:, 0, :] * cache["h"] + bb[:, 0, :]
    y = (h[:, None, :].to(cd) * gate) @ p["w_out"].to(cd)
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:, :])
    return y, cache
