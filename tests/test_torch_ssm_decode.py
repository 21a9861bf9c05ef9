"""The Mamba-2 decode recurrence (``kernels/ssm_decode``) on the CPU.

- ``models.ssm.ssm_decode`` on CPU tensors gives bit for bit what its
  inline tensor code gave before the recurrence moved to
  ``kernels/ssm_decode/ref.py`` (the code is copied here as the oracle),
  over several chained steps, with and without an ``active`` mask, in fp32
  and bf16 compute, at Granite 4.0-H's smoke shapes and mamba2-2.7b's;
- a CPU call launches no kernel;
- the wrapper's checks raise on what the CUDA kernel refuses: shapes that
  do not fit the state, dtypes, a state size off its multiple of 4 or past
  256, unpacked strides, an unaligned state.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.ssm_decode import ops as SD
from repro_torch.models import ssm as S


def _old_ssm_decode(p, u, cache, cfg, active=None):
    """``ssm_decode`` as it was written before its recurrence moved to
    ``kernels/ssm_decode/ref.py``, line for line."""
    s = cfg.ssm
    d_inner, nheads, _ = S._dims(cfg)
    cd = cfg.dtype("compute")
    z, xbc, dt_raw = S._split_proj(p, u, cfg)
    hist = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)
    w = p["conv_w"].to(cd)
    conv = (hist * w[None]).sum(dim=1, keepdim=True) + p["conv_b"].to(cd)
    xbc_t = F.silu(conv)
    x, B, C = torch.split(xbc_t, [d_inner, s.state_dim, s.state_dim],
                          dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])[:, 0]
    if active is not None:
        dt = torch.where(active[:, None], dt, 0.0)
    A = torch.exp(p["A_log"])
    xh = x.reshape(x.shape[0], nheads, s.head_dim).float()
    decay = torch.exp(-dt * A)[:, :, None, None]
    inject = torch.einsum("bh,bhp,bn->bhpn", dt, xh, B[:, 0].float())
    h = cache["h"].mul_(decay).add_(inject)
    y = torch.einsum("bhpn,bn->bhp", h, C[:, 0].float())
    y = y + p["D"][:, None] * xh
    y = y.reshape(u.shape[0], 1, d_inner).to(cd)
    y = S._gate(p, y, z, cfg)
    tail = hist[:, 1:, :]
    if active is not None:
        tail = torch.where(active[:, None, None], tail, cache["conv"])
    cache["conv"].copy_(tail)
    return y @ p["out_proj"].to(cd), cache


def _setup(arch, dtype, batch, seed):
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype,
                              param_dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    p = S.init_ssm(cfg, g)
    for k in ("D", "dt_bias", "conv_b"):
        p[k] = (p[k].float() + 0.3 * torch.randn(p[k].shape, generator=g)
                ).to(p[k].dtype)
    cache = S.init_ssm_cache(batch, cfg)
    cache["h"].normal_(generator=g)
    cache["conv"].copy_(torch.randn(cache["conv"].shape, generator=g))
    u = torch.randn(batch, 4, cfg.d_model, generator=g).to(
        cfg.dtype("compute"))
    return cfg, p, cache, u


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite-4.0-h-small", "mamba2-2.7b"])
def test_cpu_decode_is_the_old_code_bitwise(arch, dtype, masked):
    cfg, p, cache, u = _setup(arch, dtype, 5, seed=11)
    old = {k: v.clone() for k, v in cache.items()}
    active = (torch.tensor([True, False, True, True, False]) if masked
              else None)
    before = SD.ssm_decode.launches
    for t in range(u.shape[1]):
        got, _ = S.ssm_decode(p, u[:, t:t + 1], cache, cfg, active=active)
        want, _ = _old_ssm_decode(p, u[:, t:t + 1], old, cfg, active=active)
        assert got.dtype == want.dtype
        assert torch.equal(got, want), t
        for k in cache:
            assert torch.equal(cache[k], old[k]), (k, t)
    assert SD.ssm_decode.launches == before


def _operands(S_=3, H=2, P=4, N=8, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    h = torch.randn(S_, H, P, N, generator=g)
    xbc = torch.randn(S_, H * P + 2 * N, generator=g).to(dtype)
    x = xbc[:, :H * P].reshape(S_, H, P)
    B, C = xbc[:, H * P:H * P + N], xbc[:, H * P + N:]
    dt = torch.rand(S_, H, generator=g)
    A = torch.rand(H, generator=g)
    D = torch.rand(H, generator=g)
    active = torch.tensor([True, False, True])[:S_]
    return dict(h=h, x=x, B=B, C=C, dt=dt, A=A, D=D, active=active)


def test_check_takes_the_served_operands():
    """Views of the conv's output, as ``ssm_decode`` hands them over (rows
    strided, channels packed), pass the checks in both types."""
    for dtype in (torch.float32, torch.bfloat16):
        SD._check(**_operands(dtype=dtype))
    SD._check(**dict(_operands(), active=None))


def _unaligned_state():
    buf = torch.zeros(3 * 2 * 4 * 8 + 1)
    return buf[1:].view(3, 2, 4, 8)


@pytest.mark.parametrize("change,err,match", [
    (dict(x=torch.zeros(3, 2, 5)), ValueError, "do not fit the state"),
    (dict(B=torch.zeros(3, 4)), ValueError, "do not fit the state"),
    (dict(dt=torch.zeros(2, 2)), ValueError, "do not fit the state"),
    (dict(D=torch.zeros(3)), ValueError, "do not fit the state"),
    (dict(active=torch.ones(4, dtype=torch.bool)), ValueError, "active"),
    (dict(x=torch.zeros(3, 2, 4, dtype=torch.float16)), TypeError,
     "x dtype"),
    (dict(C=torch.zeros(3, 8, dtype=torch.bfloat16)), TypeError,
     "B/C dtypes"),
    (dict(h=torch.zeros(3, 2, 4, 8, dtype=torch.float64)), TypeError,
     "h must be float32"),
    (dict(dt=torch.zeros(3, 2, dtype=torch.bfloat16)), TypeError,
     "dt must be float32"),
    (dict(active=torch.ones(3, dtype=torch.int32)), TypeError,
     "active must be bool"),
    (dict(h=torch.zeros(3, 2, 4, 6), B=torch.zeros(3, 6),
          C=torch.zeros(3, 6)), ValueError, "multiple of 4"),
    (dict(h=torch.zeros(3, 2, 4, 260), B=torch.zeros(3, 260),
          C=torch.zeros(3, 260)), ValueError, "multiple of 4"),
    (dict(h=torch.zeros(3, 2, 8, 4).transpose(2, 3)), ValueError,
     "h must be contiguous"),
    (dict(x=torch.zeros(3, 4, 2).transpose(1, 2)), ValueError,
     "must be packed"),
    (dict(B=torch.zeros(3, 16)[:, ::2]), ValueError, "must be packed"),
    (dict(h=_unaligned_state()), ValueError, "16-byte aligned"),
])
def test_check_refuses_what_the_kernel_refuses(change, err, match):
    with pytest.raises(err, match=match):
        SD._check(**{**_operands(), **change})
