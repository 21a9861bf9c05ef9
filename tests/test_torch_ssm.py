"""Port parity: the SSD block (``models/ssm.py``) and the RG-LRU block
(``models/rglru.py``) against the JAX package.

At the mamba2-2.7b and recurrentgemma-2b smoke widths, fp32 compute,
params from the JAX inits through ``params_from_jax`` (the zero or
constant biases, ``D``, ``dt_bias`` and ``lambda_raw`` perturbed in numpy
so those paths carry signal) and inputs from numpy seeds, everything
within 1e-5 relative and 1e-5 x max|JAX| absolute (the frameworks sum in
other orders, the RG-LRU's doubling scan against JAX's associative scan
too; a whole 32-step chunk of the SSD's dual form, outputs up to ~5 in
size, differs by up to 2.3e-5 on outputs near 0):

- ``ssd_scan`` at chunk = S and chunk < S, with and without an incoming
  state; its gradients (the mask is inside the exp, so the upper
  triangle neither overflows nor gives NaN gradients) against
  ``jax.grad``; the ``seq % chunk`` check;
- ``ssm_forward`` (output and final state) and ``ssm_decode`` over 6
  steps (outputs and both states, the cache updated in place);
- ``linear_scan`` against a sequential loop; ``rglru_forward`` with and
  without an incoming state, ``rglru_decode`` over 6 steps;
- the inits' trees (keys, shapes; the fp32 leaves under bf16 weights)
  equal to JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro_torch.configs import get_smoke_config
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models.convert import FP32_LEAVES, params_from_jax

PERTURB = ("conv_b", "D", "dt_bias", "lambda_raw")


def _cfgs(arch):
    return tuple(dataclasses.replace(f(arch), compute_dtype="float32")
                 for f in (j_get_smoke_config, get_smoke_config))


def _params(init, jcfg, seed=0):
    tree = jax.device_get(init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    tree = {k: ((v + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
                if k in PERTURB else v) for k, v in tree.items()}
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree)


def _np(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=1e-5,
                               atol=1e-5 * float(np.abs(j).max()))


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

def _ssd_inputs(s=32, seed=0):
    b, h, p, n = 2, 4, 8, 16
    x = _np(seed, b, s, h, p)
    dt = np.log1p(np.exp(_np(seed + 1, b, s, h)))          # softplus > 0
    A = np.linspace(1.0, 16.0, h).astype(np.float32)
    return x, dt.astype(np.float32), A, _np(seed + 2, b, s, n), \
        _np(seed + 3, b, s, n), _np(seed + 4, b, h, p, n)


@pytest.mark.parametrize("chunk", [32, 8])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_matches_jax(chunk, with_h0):
    x, dt, A, B, C, h0 = _ssd_inputs()
    h0 = h0 if with_h0 else None
    jy, jh = JS.ssd_scan(*map(jnp.asarray, (x, dt, A, B, C)), chunk,
                         h0=None if h0 is None else jnp.asarray(h0))
    ty, th = S.ssd_scan(*map(torch.from_numpy, (x, dt, A, B, C)), chunk,
                        h0=None if h0 is None else torch.from_numpy(h0))
    _close(ty, jy)
    _close(th, jh)


def test_ssd_scan_gradients_match_jax_and_are_finite():
    """Decays large enough that exp(ldiff) overflows in the upper
    triangle if taken before the mask."""
    x, dt, A, B, C, _ = _ssd_inputs(seed=5)
    dt = dt * 40.0
    cot = _np(9, *x.shape)

    def jf(x, dt, B, C):
        return jnp.sum(JS.ssd_scan(x, dt, jnp.asarray(A), B, C, 16)[0] * cot)

    jg = jax.grad(jf, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, dt, B, C)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, dt, B, C)]
    y, _ = S.ssd_scan(ts[0], ts[1], torch.from_numpy(A), ts[2], ts[3], 16)
    tg = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), ts)
    for a, b in zip(tg, jg):
        assert torch.isfinite(a).all()
        _close(a, b)


def test_ssd_scan_rejects_a_ragged_chunk():
    x, dt, A, B, C, _ = _ssd_inputs(s=30)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        S.ssd_scan(*map(torch.from_numpy, (x, dt, A, B, C)), 8)


@pytest.mark.parametrize("seq", [32, 64])
def test_ssm_forward_matches_jax(seq):
    jcfg, tcfg = _cfgs("mamba2-2.7b")
    jp, tp = _params(JS.init_ssm, jcfg)
    u = _np(1, 2, seq, 128)
    jy, jh = JS.ssm_forward(jp, jnp.asarray(u), jcfg)
    ty, th = S.ssm_forward(tp, torch.from_numpy(u), tcfg)
    _close(ty, jy)
    _close(th, jh)


def test_ssm_decode_matches_jax():
    jcfg, tcfg = _cfgs("mamba2-2.7b")
    jp, tp = _params(JS.init_ssm, jcfg)
    jc, tc = JS.init_ssm_cache(2, jcfg), S.init_ssm_cache(2, tcfg)
    h_before = tc["h"]
    for t in range(6):
        u = _np(10 + t, 2, 1, 128)
        jy, jc = JS.ssm_decode(jp, jnp.asarray(u), jc, jcfg)
        ty, tc = S.ssm_decode(tp, torch.from_numpy(u), tc, tcfg)
        _close(ty, jy)
    assert tc["h"] is h_before                  # updated in place
    for name in ("h", "conv"):
        _close(tc[name], jc[name])


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def test_linear_scan_matches_a_sequential_loop():
    a = torch.from_numpy(np.random.default_rng(0).uniform(
        0.5, 1.0, (2, 37, 8)).astype(np.float32))
    b = torch.from_numpy(_np(1, 2, 37, 8))
    h, want = torch.zeros(2, 8), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(R.linear_scan(a, b), torch.stack(want, 1).numpy())


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_forward_matches_jax(with_state):
    jcfg, tcfg = _cfgs("recurrentgemma-2b")
    jp, tp = _params(JR.init_rglru_block, jcfg)
    u = _np(2, 2, 48, 128)
    st = _np(3, 2, 128) if with_state else None
    jy, jh = JR.rglru_forward(jp, jnp.asarray(u), jcfg,
                              state=None if st is None else jnp.asarray(st))
    ty, th = R.rglru_forward(tp, torch.from_numpy(u), tcfg,
                             state=None if st is None
                             else torch.from_numpy(st))
    _close(ty, jy)
    _close(th, jh)


def test_rglru_decode_matches_jax():
    jcfg, tcfg = _cfgs("recurrentgemma-2b")
    jp, tp = _params(JR.init_rglru_block, jcfg)
    jc, tc = JR.init_rglru_cache(2, jcfg), R.init_rglru_cache(2, tcfg)
    for t in range(6):
        u = _np(20 + t, 2, 1, 128)
        jy, jc = JR.rglru_decode(jp, jnp.asarray(u), jc, jcfg)
        ty, tc = R.rglru_decode(tp, torch.from_numpy(u), tc, tcfg)
        _close(ty, jy)
    for name in ("h", "conv"):
        _close(tc[name], jc[name])


# ---------------------------------------------------------------------------
# init trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,jinit,init", [
    ("mamba2-2.7b", JS.init_ssm, S.init_ssm),
    ("recurrentgemma-2b", JR.init_rglru_block, R.init_rglru_block)])
def test_init_tree_equals_jax(arch, jinit, init):
    jcfg, tcfg = _cfgs(arch)
    want = jax.eval_shape(lambda k: jinit(k, jcfg), jax.random.PRNGKey(0))
    got = init(tcfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
               lead=(2, 3))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == (2, 3) + tuple(w.shape), k
        want_dt = torch.float32 if k in FP32_LEAVES else torch.bfloat16
        assert got[k].dtype == want_dt, k
    # the fp32 leaves the JAX init makes fp32 even when the param dtype
    # is bf16 are exactly the ones the port keeps fp32
    b16 = dataclasses.replace(jcfg, param_dtype="bfloat16")
    jb = jax.eval_shape(lambda k: jinit(k, b16), jax.random.PRNGKey(0))
    assert {k for k, w in jb.items() if w.dtype == jnp.float32} == \
        {k for k in got if k in FP32_LEAVES}
