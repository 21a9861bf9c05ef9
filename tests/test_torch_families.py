"""Port parity: the MoE, SSM and hybrid families of ``models/transformer``
and their serving paths against the JAX package.

At the smoke widths of qwen2-moe-a2.7b (2 layers, 4 experts top-2, one
shared), mamba2-2.7b (2 layers) and recurrentgemma-2b (5 layers: one
(rec, rec, attn) super-block and two remainder rec layers, as the full
config's 26 = 8 x 3 + 2; local window 32), params from the JAX
``init_params`` with the zero or constant norm scales, biases, ``D``,
``dt_bias`` and ``lambda_raw`` perturbed in numpy (so those paths carry
signal), through ``params_from_jax``; tokens from numpy seeds; fp32
compute, within 1e-4 (the frameworks reduce in other orders and the
error grows through the layers). The loss, its gradients and bf16 are in
``test_torch_families_grad.py``, the engine and the launchers in
``test_torch_families_engine.py``.

- ``forward`` logits, aux loss and cache (the MoE KV cache, the final SSD
  states, the hybrid's {"rec", "k", "v"} and "rem" states) over 64 tokens
  (two SSD chunks; past the hybrid's window);
- ``prefill`` over 30 tokens and ``decode_step`` for 6 more (the hybrid's
  40-slot request wraps its 32-slot ring): logits at every step and the
  whole cache; ``launch/steps.py``'s prefill and decode steps (logits,
  caches, greedy tokens);
- the fp32 leaves (``convert.FP32_LEAVES``) stay fp32 under
  ``init_params(weight_dtype=bf16)`` and ``to_compute_dtype``;
- serving: the MoE arm of ``paged_decode_step`` bitwise the port's
  ``decode_step`` on the dense cache at full gather width, and within 1e-4
  of JAX's ``paged_decode_step(attn_impl="xla")``; ``ContinuousServer`` on
  MoE (scan and parallel prefill) and ``static_serve_trace`` on all three
  families serve the JAX servers' token sequences.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import transformer as JT
from repro.serving import ContinuousServer as JContinuousServer
from repro.serving import PagedCacheSpec as JPagedCacheSpec
from repro.serving import init_pages as j_init_pages
from repro.serving import paged_decode_step as j_paged_decode_step
from repro.serving import static_serve_trace as j_static
from repro_torch.configs import get_smoke_config
from repro_torch.core import tree as T
from repro_torch.models import transformer as M
from repro_torch.models.convert import (FP32_LEAVES, params_from_jax,
                                        to_compute_dtype)
from repro_torch.serving import (ContinuousServer, PageAllocator,
                                 PagedCacheSpec, init_pages,
                                 paged_decode_step, poisson_trace,
                                 sample_requests, static_serve_trace)

TOL = dict(atol=1e-4, rtol=1e-4)
FAMILIES = {"moe": "qwen2-moe-a2.7b", "ssm": "mamba2-2.7b",
            "hybrid": "recurrentgemma-2b"}
LAYERS = {"moe": 2, "ssm": 2, "hybrid": 5}
PERTURB = ("conv_b", "D", "dt_bias", "lambda_raw")
B, SEQ = 2, 64


def _cfgs(fam, compute="float32", remat=False):
    """(JAX cfg, port cfg) of a family's smoke config."""
    kw = dict(compute_dtype=compute, remat=remat, num_layers=LAYERS[fam])
    return (dataclasses.replace(j_get_smoke_config(FAMILIES[fam]), **kw),
            dataclasses.replace(get_smoke_config(FAMILIES[fam]), **kw))


@functools.lru_cache(maxsize=None)
def _np_params(fam, seed=0):
    jcfg, _ = _cfgs(fam)
    tree = jax.device_get(JT.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def perturb(t):
        return {k: (perturb(v) if isinstance(v, dict)
                    else (v + 0.1 * rng.standard_normal(v.shape)).astype(
                        v.dtype) if k.startswith(("ln", "b")) or k in PERTURB
                    else v)
                for k, v in t.items()}

    return perturb(tree)


def _params(fam, seed=0):
    """(JAX params, port params); the port's are fresh tensors each call."""
    tree = _np_params(fam, seed)
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree)


@functools.lru_cache(maxsize=None)
def _jit(name, fam, compute="float32", **kw):
    """A jitted JAX ``transformer`` function at the family's config
    (eager, the hybrid's python-unrolled super-block dispatches op by op:
    ~6x slower)."""
    jcfg = _cfgs(fam, compute)[0]
    if kw:
        jcfg = dataclasses.replace(jcfg, **dict(kw))
    if name == "grad":
        return jax.jit(jax.value_and_grad(
            functools.partial(JT.lm_loss, cfg=jcfg)))
    fn = getattr(JT, name)
    extra = {"return_cache": True} if name == "forward" else {}
    return jax.jit(functools.partial(fn, cfg=jcfg, **extra))


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(vocab, size=shape).astype(
        np.int32)


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _trees_close(got, want, what):
    tl, jl = T.leaves_with_path(got), jax.tree.leaves(want)
    assert len(tl) == len(jl), what
    for (path, a), b in zip(tl, jl):
        assert tuple(a.shape) == b.shape, (what, path)
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b),
                                   **TOL, err_msg=f"{what} {path}")


# ---------------------------------------------------------------------------
# forward, decode, prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam", FAMILIES)
def test_forward_logits_aux_and_cache_match_jax(fam):
    jcfg, tcfg = _cfgs(fam)
    jp, tp = _params(fam)
    toks = _tokens(1, (B, SEQ))
    jl, jaux, jc = _jit("forward", fam)(jp, {"tokens": jnp.asarray(toks)})
    tl, taux, tc = M.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                             return_cache=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    assert (float(taux) > 0) == (fam == "moe")
    _trees_close(tc, jc, "cache")


@pytest.mark.parametrize("fam", FAMILIES)
def test_prefill_and_decode_steps_match_jax(fam):
    jcfg, tcfg = _cfgs(fam)
    jp, tp = _params(fam)
    toks = _tokens(2, (B, 36))
    jc, tc = JT.init_cache(jcfg, B, 40), M.init_cache(tcfg, B, 40)
    _trees_close(tc, jc, "init_cache")
    lj, jc = _jit("prefill", fam)(jp, jc, jnp.asarray(toks[:, :30]))
    lt, tc = M.prefill(tp, tc, torch.from_numpy(toks[:, :30]), tcfg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for pos in range(30, 36):
        tok = toks[:, pos:pos + 1]
        lj, jc = _jit("decode_step", fam)(jp, jc, jnp.asarray(tok),
                                          jnp.int32(pos))
        lt, tc = M.decode_step(tp, tc, torch.from_numpy(tok), pos, tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL,
                                   err_msg=f"step {pos}")
    _trees_close(tc, jc, "cache")


@pytest.mark.parametrize("fam", FAMILIES)
def test_prefill_and_decode_step_factories_match_jax(fam):
    """``launch/steps.py``'s prefill step (logits and cache) and greedy
    decode step (tokens and cache) against JAX's."""
    from repro.configs.base import InputShape as JInputShape
    from repro.launch import steps as JS
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps as S
    jcfg, tcfg = _cfgs(fam)
    jp, tp = _params(fam)
    toks = _tokens(8, (B, 32))
    lj, cj = jax.jit(JS.make_prefill_step(
        jcfg, JInputShape("p", 32, B, "prefill")))(
        jp, {"tokens": jnp.asarray(toks)})
    lt, ct = S.make_prefill_step(tcfg, InputShape("p", 32, B, "prefill"))(
        tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _trees_close(ct, cj, "prefill cache")
    jstep = jax.jit(JS.make_decode_step(jcfg,
                                        JInputShape("d", 16, B, "decode")))
    tstep = S.make_decode_step(tcfg, InputShape("d", 16, B, "decode"))
    jc, tc = JT.init_cache(jcfg, B, 16), M.init_cache(tcfg, B, 16)
    jt = tt = toks[:, :1]
    for pos in range(4):
        jt, jc = jstep(jp, jc, {"tokens": jnp.asarray(jt)}, jnp.int32(pos))
        tt, tc = tstep(tp, tc, {"tokens": torch.from_numpy(np.asarray(tt))},
                       pos)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jt, tt = np.asarray(jt), tt.numpy()
    _trees_close(tc, jc, "decode cache")


@pytest.mark.parametrize("fam", FAMILIES)
def test_fp32_leaves_stay_fp32(fam):
    _, tcfg = _cfgs(fam, "bfloat16")
    p = M.init_params(torch.Generator().manual_seed(0), tcfg,
                      weight_dtype=torch.bfloat16)
    c = to_compute_dtype(params_from_jax(_np_params(fam)), tcfg)
    for tree in (p, c):
        kept = {path[-1] for path, t in T.leaves_with_path(tree)
                if t.dtype == torch.float32 and not path[-1].startswith("ln")}
        want = {path[-1] for path, _ in T.leaves_with_path(tree)
                if path[-1] in FP32_LEAVES}
        assert kept == want and want, (kept, want)
        assert all(t.dtype == torch.bfloat16 for path, t in
                   T.leaves_with_path(tree)
                   if path[-1] not in FP32_LEAVES
                   and not path[-1].startswith("ln"))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _moe_spec(cls, cfg, B=2, max_seq=16):
    return cls.for_config(cfg, num_slots=B, page_size=4, max_seq=max_seq)


def test_moe_paged_decode_bitwise_matches_dense_decode():
    _, cfg = _cfgs("moe")
    tp = _params("moe")[1]
    spec = _moe_spec(PagedCacheSpec, cfg)
    alloc = PageAllocator(spec)
    for s in range(2):
        alloc.ensure(s, spec.seq_capacity)
    table = torch.tensor(alloc.tables)
    pages, dense = init_pages(spec), M.init_cache(cfg, 2, 16)
    active = torch.ones((2,), dtype=torch.bool)
    for t in range(12):
        tok = torch.from_numpy(_tokens(10 + t, (2, 1)))
        dl, dense = M.decode_step(tp, dense, tok, t, cfg)
        pl, pages = paged_decode_step(
            tp, pages, table, tok, torch.full((2,), t, dtype=torch.int32),
            active, cfg)
        assert torch.equal(dl, pl), f"step {t}"
    for name in ("k", "v"):
        view = pages[name][:, table.long()].reshape(
            spec.num_layers, 2, spec.seq_capacity, spec.kv_heads,
            spec.head_dim)
        assert torch.equal(view, dense["blocks"][name])


def test_moe_paged_decode_step_logits_match_jax():
    jcfg, tcfg = _cfgs("moe")
    jp, tp = _params("moe")
    jspec, tspec = _moe_spec(JPagedCacheSpec, jcfg), _moe_spec(
        PagedCacheSpec, tcfg)
    alloc = PageAllocator(tspec)
    for s in range(2):
        alloc.ensure(s, tspec.seq_capacity)
    jtab, ttab = jnp.asarray(alloc.tables), torch.tensor(alloc.tables)
    jpages, tpages = j_init_pages(jspec), init_pages(tspec)
    active = np.array([True, False])
    jstep = jax.jit(lambda p, pg, tb, tok, pos, act: j_paged_decode_step(
        p, pg, tb, tok, pos, act, jcfg, attn_impl="xla"))
    for t in range(8):
        tok = _tokens(20 + t, (2, 1))
        pos = np.array([t, t + 3], np.int32)
        lj, jpages = jstep(jp, jpages, jtab, jnp.asarray(tok),
                           jnp.asarray(pos), jnp.asarray(active))
        lt, tpages = paged_decode_step(
            tp, tpages, ttab, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(active), tcfg, attn_impl="torch")
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL,
                                   err_msg=f"step {t}")
    _trees_close(tpages, jpages, "pages")


def _tokens_equal(a, b):
    assert sorted(a) == sorted(b)
    for rid in a:
        assert np.array_equal(a[rid], b[rid]), (
            f"rid {rid}: {a[rid]} != {b[rid]}")


@pytest.mark.parametrize("prefill_mode", ["scan", "parallel"])
def test_moe_continuous_server_tokens_match_jax(prefill_mode):
    """Every request arrives at 0: a parallel prefill's MoE capacity
    depends on its prompt bucket, so which requests are admitted together
    must not depend on the host clock."""
    jcfg, tcfg = _cfgs("moe")
    jp, tp = _params("moe")
    reqs = [dataclasses.replace(r, arrival=0.0) for r in sample_requests(
        poisson_trace(50.0, 5, seed=3), tcfg, prompt_range=(4, 8),
        gen_range=(3, 6), seed=3)]
    kw = dict(slots=2, page_size=4, max_seq=16, prefill_mode=prefill_mode)
    want = JContinuousServer(jcfg, jp, attn_impl="xla", **kw).run(reqs)
    got = ContinuousServer(tcfg, tp, attn_impl="torch", device="cpu",
                           **kw).run(reqs)
    _tokens_equal(got.tokens, want.tokens)
    assert got.total_tokens == want.total_tokens == sum(r.gen for r in reqs)


@pytest.mark.parametrize("fam", FAMILIES)
def test_static_serve_trace_tokens_match_jax(fam):
    jcfg, tcfg = _cfgs(fam)
    jp, tp = _params(fam)
    reqs = sample_requests(poisson_trace(30.0, 4, seed=2), tcfg,
                           prompt_range=(4, 8), gen_range=(3, 5), seed=2)
    want = j_static(jcfg, reqs, batch=2, params=jp)
    got = static_serve_trace(tcfg, reqs, batch=2, params=tp, device="cpu")
    _tokens_equal(got.tokens, want.tokens)
    assert len(got.rids) == len(reqs)
