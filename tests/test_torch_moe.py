"""Port parity: the MoE layer (``models/moe.py``) against the JAX package.

At the qwen2-moe-a2.7b smoke widths (d_model 128, 4 experts top-2 of
width 64, one shared expert), fp32 compute, params from the JAX
``init_moe`` through ``params_from_jax`` and inputs from numpy seeds:

- ``moe_forward``'s output and aux loss within 1e-5 of JAX's, with and
  without shared experts, in one chunk and chunked (``chunk=8`` over 32
  tokens: the load-balance stats averaged over the chunks), and with a
  router skewed towards expert 0 so that its capacity drops choices (the
  test checks that some were dropped);
- ``capacity`` equal to JAX's, and ``init_moe``'s tree (keys, shapes, the
  fp32 router under bf16 weights) equal to JAX's.

The router softmax runs in fp32 and ``torch.topk`` breaks ties in
another order than ``jax.lax.top_k``; on seeded fp32 inputs the
probabilities have no ties, which these tests rely on.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import moe as JM
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import MoEConfig
from repro_torch.core import tree as T
from repro_torch.models import moe as M
from repro_torch.models.convert import params_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(shared=1):
    """(JAX cfg, port cfg): the MoE smoke widths in fp32."""
    def one(cfg, cls):
        return dataclasses.replace(
            cfg, compute_dtype="float32",
            moe=cls(num_experts=4, top_k=2, d_ff_expert=64,
                    num_shared_experts=shared))
    from repro.configs.base import MoEConfig as JMoEConfig
    return (one(j_get_smoke_config("qwen2-moe-a2.7b"), JMoEConfig),
            one(get_smoke_config("qwen2-moe-a2.7b"), MoEConfig))


def _params(jcfg, skew: float, seed=0):
    tree = jax.device_get(JM.init_moe(jax.random.PRNGKey(seed), jcfg))
    tree["router"] = tree["router"].copy()
    # inputs carry +3 on feature 0 (``_x``): this pulls them to expert 0
    tree["router"][0, 0] += skew
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree)


def _x(seed):
    x = np.random.default_rng(seed).standard_normal((2, 32, 128))
    x[..., 0] += 3.0
    return x.astype(np.float32)


def _dropped(jp, x, jcfg) -> int:
    """Choices past an expert's capacity in one chunk of ``x``."""
    m = jcfg.moe
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, m.top_k)
    counts = np.stack([(np.asarray(idx) == e).sum(axis=(1, 2))
                       for e in range(m.num_experts)], axis=-1)   # (B, E)
    cap = JM.capacity(x.shape[1], jcfg)
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("shared,chunk,skew", [
    (1, None, 0.0), (0, None, 0.0), (1, None, 1.0), (0, 8, 0.0),
    (1, 8, 1.0)], ids=["shared", "no-shared", "shared-drops",
                       "chunked", "chunked-shared-drops"])
def test_moe_forward_matches_jax(shared, chunk, skew):
    jcfg, tcfg = _cfgs(shared)
    jp, tp = _params(jcfg, skew)
    x = _x(1)
    kw = {} if chunk is None else {"chunk": chunk}
    jy, jaux = JM.moe_forward(jp, jnp.asarray(x), jcfg, **kw)
    ty, taux = M.moe_forward(tp, torch.from_numpy(x), tcfg, **kw)
    assert ("shared" in tp) == bool(shared)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    if skew:
        n = chunk or x.shape[1]
        assert _dropped(jp, x[:, :n], jcfg) > 0


def test_chunked_aux_averages_the_chunk_stats():
    """Chunked, the aux is the product of the chunk means of the
    load-balance stats (not the mean of the chunk products)."""
    jcfg, tcfg = _cfgs(0)
    _, tp = _params(jcfg, 0.0)
    x = torch.from_numpy(_x(2))
    whole = M.moe_forward(tp, x, tcfg)
    parts = [M._chunk_moe(tp, x[:, c * 8:(c + 1) * 8], tcfg)[1]
             for c in range(4)]
    ft = sum(p[0] for p in parts) / 4
    mp = sum(p[1] for p in parts) / 4
    _, aux = M.moe_forward(tp, x, tcfg, chunk=8)
    want = tcfg.moe.num_experts * torch.sum(ft * mp) \
        * tcfg.moe.router_aux_weight
    assert torch.allclose(aux, want, rtol=1e-6, atol=0)
    assert whole[1].shape == aux.shape == ()


def test_capacity_equals_jax():
    jcfg, tcfg = _cfgs()
    for n in (1, 2, 7, 32, 100, 4096, 10 ** 6):
        assert M.capacity(n, tcfg) == JM.capacity(n, jcfg)
    assert (M.CAPACITY_FACTOR, M.MOE_CHUNK, M.MAX_CAPACITY) == (
        JM.CAPACITY_FACTOR, JM.MOE_CHUNK, JM.MAX_CAPACITY)


@pytest.mark.parametrize("shared", [0, 1])
def test_init_moe_tree_equals_jax(shared):
    jcfg, tcfg = _cfgs(shared)
    want = jax.eval_shape(lambda k: JM.init_moe(k, jcfg),
                          jax.random.PRNGKey(0))
    got = M.init_moe(tcfg, torch.Generator().manual_seed(0),
                     dtype=torch.bfloat16, lead=(3,))
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    gl = T.leaves_with_path(got)
    assert [tuple(k.key for k in p) for p, _ in wl] == [p for p, _ in gl]
    for (_, w), (path, g) in zip(wl, gl):
        assert tuple(g.shape) == (3,) + tuple(w.shape), path
        assert g.dtype == (torch.float32 if path == ("router",)
                           else torch.bfloat16), path
    # the per-layer draw: layers differ, and one seed gives one tree
    assert not torch.equal(got["w_up"][0], got["w_up"][1])
    again = M.init_moe(tcfg, torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16, lead=(3,))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(got),
                                                 T.leaves(again)))
