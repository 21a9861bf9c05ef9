"""Mamba-2 SSD (state-space duality) block. [arXiv:2405.21060]

Port of the JAX package's ``models/ssm.py``. Training and prefill use the
chunked SSD algorithm: a Python loop over chunks (JAX: ``lax.scan``)
carrying an (H, P, N) fp32 state, the intra-chunk terms as dense einsums
(the "dual", attention-like form). Decode is the O(1) single-step
recurrence, with the decode state updated in place (JAX returns a new
one). ngroups = 1 (B/C shared across heads).

Recurrence per head (state h in R^{P x N}):
    h_t = exp(dt_t * A) h_{t-1} + dt_t * x_t B_t^T
    y_t = h_t C_t + D * x_t

``A_log``, ``D`` and ``dt_bias`` are fp32 and read in fp32
(``models.convert.FP32_LEAVES``).

With ``ArchConfig.ssm_gated_norm`` (Granite 4.0-H) the output is
``rms(y * silu(z))`` scaled by ``1 + ln_out`` over all d_inner channels
(one group) before ``out_proj``; without it, ``y * silu(z)``.

``ssm_prefill`` runs a right-padded batch from a given state: ``dt`` is 0
at padded positions, so the state passes them unchanged, and the conv
tail is each row's last K-1 real inputs. ``ssm_decode`` with ``active``
leaves inactive rows' state exactly as it was (decay 1, nothing added).
Its recurrence runs in ``kernels/ssm_decode``: a CUDA state is updated by
the hand-written kernel, which reads and writes each live slot's state
once and does not touch an inactive one's; a CPU state by its plain
version (``kernels/ssm_decode/ref.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssm_decode import ops as SD
from repro_torch.models import layers as L


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    d_conv = d_inner + 2 * s.state_dim   # conv runs over (x, B, C)
    return d_inner, nheads, d_conv


def init_ssm(cfg: ArchConfig, generator: torch.Generator, *,
             dtype: Optional[torch.dtype] = None, lead: tuple = (),
             device=None):
    """The JAX tree (``in_proj``, ``conv_w``, ``conv_b``, ``A_log``, ``D``,
    ``dt_bias``, ``out_proj``); ``lead`` prepends stacking axes."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nheads, d_conv = _dims(cfg)
    proj_out = 2 * d_inner + 2 * s.state_dim + nheads   # z, x, B, C, dt
    dt = dtype or cfg.dtype("param")
    dev = L.init_device(generator, device)
    f32 = dict(dtype=torch.float32, device=dev)
    a_log = torch.log(torch.linspace(1.0, 16.0, nheads, **f32))
    extra = {}
    if cfg.ssm_gated_norm:
        extra["ln_out"] = L.init_rms_norm(d_inner, cfg.dtype("param"), dev,
                                          lead=lead)
    return {**extra,
        "in_proj": L._randn((d, proj_out), generator, d ** -0.5, dt, lead,
                            dev),
        "conv_w": L._randn((s.conv_width, d_conv), generator, 0.1, dt, lead,
                           dev),
        "conv_b": torch.zeros(lead + (d_conv,), dtype=dt, device=dev),
        "A_log": a_log.expand(lead + (nheads,)).clone(),
        "D": torch.ones(lead + (nheads,), **f32),
        "dt_bias": torch.zeros(lead + (nheads,), **f32),
        "out_proj": L._randn((d_inner, d), generator,
                             d_inner ** -0.5, dt, lead, dev),
    }


def _split_proj(p, u, cfg: ArchConfig):
    s = cfg.ssm
    d_inner, nheads, _ = _dims(cfg)
    proj = u @ p["in_proj"].to(cfg.dtype("compute"))
    return torch.split(proj, [d_inner, d_inner + 2 * s.state_dim, nheads],
                       dim=-1)


def _causal_conv(xbc, w, b, cd, conv0=None):
    """Depthwise causal conv over time. xbc: (B,S,C); w: (K,C); ``conv0``
    (B,K-1,C): the inputs before the first (default zeros). Returns the
    activation and the padded input (B,K-1+S,C)."""
    k = w.shape[0]
    if conv0 is None:
        pad = F.pad(xbc, (0, 0, k - 1, 0))
    else:
        pad = torch.cat([conv0.to(xbc.dtype), xbc], dim=1)
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i].to(cd) for i in range(k))
    return F.silu(out + b.to(cd)), pad


def _gate(p, y, z, cfg: ArchConfig):
    """The output gate: ``y * silu(z)``, RMS-normalised with the gated
    norm."""
    y = y * F.silu(z)
    if cfg.ssm_gated_norm:
        y = L.rms_norm(y, p["ln_out"], cfg.norm_eps)
    return y


def ssd_scan(x, dt, A, B, C, chunk: int, h0=None):
    """Chunked SSD. x: (B,S,H,P); dt: (B,S,H); A: (H,) (positive, decay =
    exp(-dt*A)); B, C: (B,S,N). Returns (y, h_final)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    L_ = min(chunk, s)
    if s % L_:
        raise ValueError(f"seq {s} not divisible by chunk {L_}")
    nc = s // L_
    xc = x.reshape(b, nc, L_, h, p)
    dtc = dt.reshape(b, nc, L_, h)
    Bc = B.reshape(b, nc, L_, n).float()
    Cc = C.reshape(b, nc, L_, n).float()
    hprev = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0)
    tri = torch.tril(torch.ones((L_, L_), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    ys = []
    for c in range(nc):
        xk, dtk, Bk, Ck = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        a = (-dtk * A).float()                     # (B,L,H) log decay
        cum = torch.cumsum(a, dim=1)               # inclusive
        xdt = (xk * dtk[..., None]).float()
        # intra-chunk (the "dual" quadratic form, L x L); mask inside the
        # exp so upper-triangle entries never overflow (exp(+big) * 0 is
        # NaN, and so would be its gradient)
        ldiff = cum[:, :, None, :] - cum[:, None, :, :]           # (B,L,L,H)
        decay = torch.exp(torch.where(tri, ldiff, -torch.inf))
        cb = torch.einsum("bln,bsn->bls", Ck, Bk)
        y_intra = torch.einsum("bls,blsh,bshp->blhp", cb, decay, xdt)
        # inter-chunk from the carried state
        y_inter = torch.einsum("bln,blh,bhpn->blhp", Ck, torch.exp(cum),
                               hprev)
        # state update
        sdecay = torch.exp(cum[:, -1:, :] - cum)                  # (B,L,H)
        hprev = (torch.exp(cum[:, -1, :])[:, :, None, None] * hprev
                 + torch.einsum("blh,bln,blhp->bhpn", sdecay, Bk, xdt))
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y, hprev


def _ssm_seq(p, u, cfg: ArchConfig, h0=None, conv0=None, valid=None):
    """-> (y, h_final, padded conv input (B,K-1+S,C))."""
    s = cfg.ssm
    d_inner, nheads, _ = _dims(cfg)
    cd = cfg.dtype("compute")
    z, xbc, dt_raw = _split_proj(p, u, cfg)
    act, pad = _causal_conv(xbc, p["conv_w"], p["conv_b"], cd, conv0)
    x, B, C = torch.split(act, [d_inner, s.state_dim, s.state_dim], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    if valid is not None:
        dt = torch.where(valid[..., None], dt, 0.0)
    A = torch.exp(p["A_log"])
    xh = x.reshape(*x.shape[:2], nheads, s.head_dim)
    y, hf = ssd_scan(xh, dt, A, B, C, s.chunk, h0=h0)
    y = y + p["D"][:, None].to(cd) * xh
    y = _gate(p, y.reshape(*u.shape[:2], d_inner), z, cfg)
    return y @ p["out_proj"].to(cd), hf, pad


def ssm_forward(p, u, cfg: ArchConfig, h0=None):
    """Full-sequence SSD block. u: (B,S,D). Returns (y, h_final)."""
    y, hf, _ = _ssm_seq(p, u, cfg, h0=h0)
    return y, hf


def ssm_prefill(p, u, cfg: ArchConfig, state=None, valid=None):
    """A right-padded batch u (B,S,D) from ``state`` ({"h", "conv"} as
    ``init_ssm_cache``; default zeros); ``valid`` (B,S) bool marks each
    row's real positions, a prefix. Returns (y, {"h", "conv"}): the state
    after each row's last real position."""
    state = state or {}
    y, hf, pad = _ssm_seq(p, u, cfg, h0=state.get("h"),
                          conv0=state.get("conv"), valid=valid)
    k1 = cfg.ssm.conv_width - 1
    b, s = u.shape[:2]
    n = (torch.full((b,), s, device=u.device) if valid is None
         else valid.sum(dim=1))
    # the padded input holds K-1 rows before position 0: row n..n+K-2 are
    # the K-1 inputs up to position n-1
    idx = (n[:, None] + torch.arange(k1, device=u.device))[..., None]
    tail = pad.gather(1, idx.expand(b, k1, pad.shape[-1]))
    return y, {"h": hf, "conv": tail}


def init_ssm_cache(batch: int, cfg: ArchConfig, device="cpu"):
    s = cfg.ssm
    _, nheads, d_conv = _dims(cfg)
    return {
        "h": torch.zeros((batch, nheads, s.head_dim, s.state_dim),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, d_conv),
                            dtype=cfg.dtype("compute"), device=device),
    }


def ssm_decode(p, u, cache, cfg: ArchConfig, active=None):
    """Single-token step. u: (B,1,D); cache {"h": (B,H,P,N) fp32, "conv":
    (B,K-1,d_conv)}, updated in place; ``active`` (B,) bool: the rows
    whose state advances (default all). Returns (y, cache)."""
    s = cfg.ssm
    d_inner, nheads, _ = _dims(cfg)
    cd = cfg.dtype("compute")
    z, xbc, dt_raw = _split_proj(p, u, cfg)
    # the causal-conv ring: the cache holds the previous K-1 inputs
    hist = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)
    w = p["conv_w"].to(cd)
    conv = (hist * w[None]).sum(dim=1, keepdim=True) + p["conv_b"].to(cd)
    xbc_t = F.silu(conv)
    x, B, C = torch.split(xbc_t, [d_inner, s.state_dim, s.state_dim],
                          dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])[:, 0]          # (B,H)
    if active is not None:
        dt = torch.where(active[:, None], dt, 0.0)
    A = torch.exp(p["A_log"])
    xh = x.reshape(x.shape[0], nheads, s.head_dim)
    y = SD.ssm_decode(cache["h"], xh, B[:, 0], C[:, 0], dt, A, p["D"],
                      active)
    y = y.reshape(u.shape[0], 1, d_inner).to(cd)
    y = _gate(p, y, z, cfg)
    tail = hist[:, 1:, :]
    if active is not None:
        tail = torch.where(active[:, None, None], tail, cache["conv"])
    cache["conv"].copy_(tail)
    return y @ p["out_proj"].to(cd), cache
