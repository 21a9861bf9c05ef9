"""Port parity: the closed-form coefficients and the fused grouped update.

- ``optim.closed_form`` (a numpy copy) gives exactly the JAX package's
  coefficients;
- the plain fused update equals the JAX ``fused_update_ref`` and the JAX
  Pallas kernel run in interpret mode within 1e-6 in fp32 (the frameworks
  may contract a multiply-add differently), per leaf and per flat slab;
- ``fused_group_update`` with a merged-FC head mask, and the port's scan
  oracle, equal the JAX package's on the same numpy trees;
- inside the port, both strategies at g=1 reduce to ``sgd_update`` within
  rtol 1e-6 / atol 1e-7 (the reference's own pin).

The kernel itself runs only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``: bitwise against the plain version).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.async_sgd import scan_grouped_update as j_scan
from repro.kernels.fused_update.fused_update import fused_update_pallas
from repro.kernels.fused_update.ops import fused_group_update as j_fgu
from repro.kernels.fused_update.ref import fused_update_ref as j_fu_ref
from repro.optim import closed_form as JCF
from repro_torch.core import tree as T
from repro_torch.core.async_sgd import apply_grouped_update, scan_grouped_update
from repro_torch.kernels.fused_update import ops as fu_ops
from repro_torch.kernels.fused_update.ref import fused_update_ref
from repro_torch.optim import closed_form as CF
from repro_torch.optim.sgd import init_momentum, sgd_update

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(rng):
    """A params-like tree with a merged-FC head subtree and a scalar leaf."""
    return {"conv": [{"w": rng.standard_normal((3, 3, 2, 5)).astype(np.float32),
                      "b": rng.standard_normal(5).astype(np.float32)}],
            "fc": [{"w": rng.standard_normal((37, 13)).astype(np.float32),
                    "b": rng.standard_normal(13).astype(np.float32)}],
            "s": np.float32(0.3)}


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **(tol or TOL))


def _assert_trees_close(port, ref, **tol):
    got = T.leaves(port)
    want = jax.tree.leaves(ref)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        _close(x.numpy(), y, **tol)


# ---------------------------------------------------------------------------
# closed form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("mu,wd", [(0.0, 0.0), (0.3, 0.0), (0.9, 1e-4),
                                   (0.99, 5e-3)])
def test_closed_form_equals_jax_exactly(g, mu, wd):
    for weights in (None, [float(i + 1) for i in range(g)]):
        for fn in ("grouped_coeffs", "head_coeffs"):
            kw = dict(lr=0.05, momentum=mu, weight_decay=wd,
                      group_weights=weights)
            got = getattr(CF, fn)(g, **kw)
            want = getattr(JCF, fn)(g, **kw)
            assert got.a == want.a and got.b == want.b, (fn, weights)
            assert (got.cww, got.cwv, got.cvw, got.cvv) == (
                want.cww, want.cwv, want.cvw, want.cvv)


def test_closed_form_rejects_bad_weights():
    with pytest.raises(ValueError, match="group weights"):
        CF.grouped_coeffs(2, lr=0.1, group_weights=[1.0])
    with pytest.raises(ValueError, match=">= 0"):
        CF.head_coeffs(2, lr=0.1, group_weights=[1.0, -1.0])


# ---------------------------------------------------------------------------
# the leaf and slab update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1,), (7,), (300,), (37, 53), (2, 3, 5, 7),
                                   ()])
@pytest.mark.parametrize("g", [1, 4])
def test_plain_leaf_update_matches_jax_ref(shape, g):
    rng = np.random.default_rng(len(shape) * 10 + g)
    w = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    gs = rng.standard_normal((g,) + shape).astype(np.float32)
    c = CF.grouped_coeffs(g, lr=0.05, momentum=0.9, weight_decay=1e-4)
    jw, jv = j_fu_ref(jnp.asarray(w), jnp.asarray(v), jnp.asarray(gs),
                      JCF.grouped_coeffs(g, lr=0.05, momentum=0.9,
                                         weight_decay=1e-4))
    pw, pv = fused_update_ref(_t(w), _t(v), _t(gs), c)
    assert pw.dtype == torch.float32 and pw.shape == torch.Size(shape)
    _close(pw.numpy(), jw)
    _close(pv.numpy(), jv)


def test_leaf_and_slab_match_jax_pallas_interpret():
    """The wrapper on CPU tensors (its plain version; it launches nothing)
    per leaf and on one flat slab of both leaves, against the JAX Pallas
    kernel in interpret mode; slab and per-leaf are bitwise equal."""
    rng = np.random.default_rng(3)
    g = 4
    shapes = [(37, 53), (129,)]
    ws = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    vs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    gs = [rng.standard_normal((g,) + s).astype(np.float32) for s in shapes]
    c = CF.grouped_coeffs(g, lr=0.05, momentum=0.9, weight_decay=1e-4)
    jc = JCF.grouped_coeffs(g, lr=0.05, momentum=0.9, weight_decay=1e-4)
    before = fu_ops.fused_update_cuda.launches
    per_leaf = []
    for w, v, gg in zip(ws, vs, gs):
        jw, jv = fused_update_pallas(jnp.asarray(w), jnp.asarray(v),
                                     jnp.asarray(gg), jc, interpret=True)
        pw, pv = fu_ops.fused_update_cuda(_t(w), _t(v), _t(gg), c)
        _close(pw.numpy(), jw)
        _close(pv.numpy(), jv)
        per_leaf.append((pw.reshape(-1), pv.reshape(-1)))
    slab_w = np.concatenate([w.reshape(-1) for w in ws])
    slab_v = np.concatenate([v.reshape(-1) for v in vs])
    slab_g = np.concatenate([x.reshape(g, -1) for x in gs], axis=1)
    sw, sv = fu_ops.fused_bucket_update(_t(slab_w), _t(slab_v), _t(slab_g),
                                        coeffs=c)
    jw, jv = fused_update_pallas(jnp.asarray(slab_w), jnp.asarray(slab_v),
                                 jnp.asarray(slab_g), jc, interpret=True)
    _close(sw.numpy(), jw)
    _close(sv.numpy(), jv)
    assert torch.equal(sw, torch.cat([p[0] for p in per_leaf]))
    assert torch.equal(sv, torch.cat([p[1] for p in per_leaf]))
    assert fu_ops.fused_update_cuda.launches == before


def test_bf16_momentum_leaf_matches_jax_ref():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((33, 17)).astype(np.float32)
    v = rng.standard_normal((33, 17)).astype(np.float32)
    gs = rng.standard_normal((4, 33, 17)).astype(np.float32)
    c = CF.grouped_coeffs(4, lr=0.05, momentum=0.9)
    jw, jv = j_fu_ref(jnp.asarray(w), jnp.asarray(v, jnp.bfloat16),
                      jnp.asarray(gs), JCF.grouped_coeffs(4, lr=0.05,
                                                          momentum=0.9))
    pw, pv = fused_update_ref(_t(w), _t(v).bfloat16(), _t(gs), c)
    assert pv.dtype == torch.bfloat16 and pw.dtype == torch.float32
    _close(pw.numpy(), jw)
    # one bf16 rounding of the same fp32 value on both sides
    _close(pv.float().numpy(), np.asarray(jv, np.float32), rtol=8e-3,
           atol=1e-6)


def test_update_impl_checks():
    w = torch.zeros(3)
    c = CF.grouped_coeffs(2, lr=0.1)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fu_ops.fused_update(w, w, torch.zeros(2, 3), coeffs=c, impl="cuda")
    with pytest.raises(ValueError, match="update_impl must be one of"):
        fu_ops.fused_update(w, w, torch.zeros(2, 3), coeffs=c, impl="xla")
    with pytest.raises(ValueError, match="groups"):
        fu_ops.fused_update(w, w, torch.zeros(3, 3), coeffs=c)


# ---------------------------------------------------------------------------
# tree-level update: fused (with head) and the scan oracle
# ---------------------------------------------------------------------------

def _case(g, seed=0):
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    mom = {k: (0.1 * np.ones_like(v) if not isinstance(v, list) else
               [{kk: 0.1 * np.ones_like(vv) for kk, vv in d.items()}
                for d in v]) for k, v in params.items()}
    grads = jax.tree.map(
        lambda p: rng.standard_normal((g,) + np.shape(p)).astype(np.float32),
        params)
    mask = {"conv": [{"w": False, "b": False}],
            "fc": [{"w": True, "b": True}], "s": False}
    port = [T.tree_map(lambda a: _t(np.asarray(a, np.float32)), t)
            for t in (params, grads, mom)]
    jaxt = [jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), t)
            for t in (params, grads, mom)]
    return port, jaxt, mask


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("mu,wd", [(0.0, 0.0), (0.9, 1e-4)])
def test_fused_group_update_with_head_matches_jax(g, mu, wd):
    (pp, pg, pm), (jp, jg, jm), mask = _case(g)
    kw = dict(lr=0.05, momentum=mu, weight_decay=wd)
    got = fu_ops.fused_group_update(
        pp, pg, pm, coeffs=CF.grouped_coeffs(g, **kw),
        head_coeffs=CF.head_coeffs(g, **kw), head_mask=mask)
    want = j_fgu(jp, jg, jm, coeffs=JCF.grouped_coeffs(g, **kw),
                 head_coeffs=JCF.head_coeffs(g, **kw), head_mask=mask)
    _assert_trees_close(got[0], want[0])
    _assert_trees_close(got[1], want[1])


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("weights", [None, "ramp"])
def test_scan_oracle_matches_jax_and_fused(g, weights):
    (pp, pg, pm), (jp, jg, jm), mask = _case(g, seed=1)
    gw = None if weights is None else [float(i + 1) for i in range(g)]
    kw = dict(lr=0.05, momentum=0.9, weight_decay=1e-4, head_mask=mask,
              group_weights=gw)
    got = scan_grouped_update(pp, pg, pm, **kw)
    want = j_scan(jp, jg, jm, **kw)
    _assert_trees_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    _assert_trees_close(got[1], want[1], rtol=1e-5, atol=1e-6)
    fused = apply_grouped_update(pp, pg, pm, strategy="fused", lr=0.05,
                                 momentum=0.9, weight_decay=1e-4,
                                 head_mask=mask, group_weights=gw)
    for a, b in zip(T.leaves(fused[0]), T.leaves(got[0])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_head_mask_without_head_coeffs_raises():
    params = {"fc": torch.ones(3)}
    with pytest.raises(ValueError, match="head_coeffs"):
        fu_ops.fused_group_update(params, {"fc": torch.ones(2, 3)},
                                  init_momentum(params),
                                  coeffs=CF.grouped_coeffs(2, lr=0.1),
                                  head_mask={"fc": True})


@pytest.mark.parametrize("strategy", ["fused", "scan"])
def test_g1_reduces_to_sgd_update(strategy):
    """Both strategies at g=1 are plain synchronous ``sgd_update``."""
    (pp, pg, _), (jp, _, _), _ = _case(1, seed=2)
    pm = T.tree_map(lambda p: 0.2 * torch.ones_like(p), pp)
    g0 = T.tree_map(lambda x: x[0], pg)
    kw = dict(lr=0.03, momentum=0.9, weight_decay=1e-4)
    ref_p, ref_v = sgd_update(pp, g0, pm, **kw)
    p, v = apply_grouped_update(pp, pg, pm, strategy=strategy, **kw)
    for a, b in zip(T.leaves(p) + T.leaves(v), T.leaves(ref_p) + T.leaves(ref_v)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
