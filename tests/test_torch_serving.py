"""The port's serving slice: parity with the JAX package, and the JAX
package's own in-framework contracts kept inside the port.

Across frameworks (fp32, same requests, params converted from the JAX
``init_params``): ``paged_decode_step`` logits agree at ``1e-4``, and the
port's ``ContinuousServer(device="cpu", attn_impl="torch")`` serves the
same token sequences as the JAX ``ContinuousServer(attn_impl="xla")``, for
scan and parallel prefill.

Inside the port (mirroring ``tests/test_serving.py``): paged decode on the
plain arm at full gather width is bitwise equal to the dense ring-buffer
``decode_step``; a slot's output is independent of its neighbours;
continuous serving equals solo decoding token for token; a run repeats
exactly after ``reset()``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.models import transformer as JT
from repro.serving import ContinuousServer as JContinuousServer
from repro.serving import PagedCacheSpec as JPagedCacheSpec
from repro.serving import PageAllocator as JPageAllocator
from repro.serving import init_pages as j_init_pages
from repro.serving import paged_decode_step as j_paged_decode_step
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import (ContinuousServer, PageAllocator,
                                 PagedCacheSpec, init_pages,
                                 paged_decode_step, poisson_trace,
                                 sample_requests, static_serve_trace)

TOL = dict(atol=1e-4, rtol=1e-4)


def _cfg(window=None, h=2, kv=2, hd=16, layers=2, arch_type="dense"):
    """The JAX serving tests' config, as (JAX cfg, port cfg)."""
    kw = dict(name=f"t-{arch_type}-kv{kv}-w{window}", arch_type=arch_type,
              num_layers=layers, d_model=h * hd, num_heads=h,
              num_kv_heads=kv, head_dim=hd, d_ff=32, vocab_size=64,
              sliding_window=window, compute_dtype="float32", remat=False)
    return JArchConfig(**kw), ArchConfig(**kw)


@functools.lru_cache(maxsize=None)
def _params(jcfg, seed=0):
    """(JAX params, the port's copy); cached, the tests only read them."""
    tree = jax.device_get(JT.init_params(jax.random.PRNGKey(seed), jcfg))
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, None)


def _full_tables(spec, alloc_cls=PageAllocator):
    alloc = alloc_cls(spec)
    for s in range(spec.num_slots):
        alloc.ensure(s, spec.seq_capacity)
    return alloc


def _tokens_equal(a, b):
    assert sorted(a) == sorted(b)
    for rid in a:
        assert np.array_equal(a[rid], b[rid]), (
            f"rid {rid}: {a[rid]} != {b[rid]}")


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,steps", [(None, 8), (8, 12)])
def test_paged_decode_step_logits_match_jax(window, steps):
    jcfg, tcfg = _cfg(window=window, kv=1)
    jp, tp = _params(jcfg)
    B = 2
    max_seq = 16
    jspec = JPagedCacheSpec.for_config(jcfg, num_slots=B, page_size=4,
                                       max_seq=max_seq, window=window)
    tspec = PagedCacheSpec.for_config(tcfg, num_slots=B, page_size=4,
                                      max_seq=max_seq, window=window)
    alloc = _full_tables(tspec)
    jtab, ttab = jnp.asarray(alloc.tables), torch.tensor(alloc.tables)
    jpages, tpages = j_init_pages(jspec), init_pages(tspec)
    active = np.array([True, True])
    jstep = jax.jit(lambda p, pg, tb, tok, pos, act: j_paged_decode_step(
        p, pg, tb, tok, pos, act, jcfg, window=window))
    rng = np.random.default_rng(1)
    for t in range(steps):
        tok = rng.integers(jcfg.vocab_size, size=(B, 1)).astype(np.int32)
        pos = np.array([t, t + 3], np.int32)
        lj, jpages = jstep(jp, jpages, jtab, jnp.asarray(tok),
                           jnp.asarray(pos), jnp.asarray(active))
        lt, tpages = paged_decode_step(
            tp, tpages, ttab, torch.tensor(tok), torch.tensor(pos),
            torch.tensor(active), tcfg, window=window)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL,
                                   err_msg=f"step {t}")
    for name in ("k", "v"):
        np.testing.assert_allclose(tpages[name].numpy(),
                                   np.asarray(jpages[name]), **TOL)


@pytest.mark.parametrize("prefill_mode,window", [("scan", None),
                                                 ("parallel", None),
                                                 ("scan", 8)])
def test_continuous_server_tokens_match_jax(prefill_mode, window):
    """Same requests, same converted params: the port's plain arm serves
    exactly the JAX xla arm's token sequences (GQA, kv=1)."""
    jcfg, tcfg = _cfg(window=window, kv=1)
    jp, tp = _params(jcfg)
    reqs = sample_requests(poisson_trace(50.0, 6, seed=3), tcfg,
                           prompt_range=(4, 8), gen_range=(3, 6), seed=3)
    kw = dict(slots=2, page_size=4, max_seq=16, window=window,
              prefill_mode=prefill_mode)
    want = JContinuousServer(jcfg, jp, attn_impl="xla", **kw).run(reqs)
    got = ContinuousServer(tcfg, tp, attn_impl="torch", device="cpu",
                           **kw).run(reqs)
    _tokens_equal(got.tokens, want.tokens)
    assert got.total_tokens == want.total_tokens == sum(r.gen for r in reqs)


def test_static_baseline_tokens_match_jax():
    from repro.serving import static_serve_trace as j_static
    jcfg, tcfg = _cfg()
    jp, tp = _params(jcfg)
    reqs = sample_requests(poisson_trace(30.0, 5, seed=2), tcfg,
                           prompt_range=(4, 8), gen_range=(3, 5), seed=2)
    want = j_static(jcfg, reqs, batch=2, params=jp)
    got = static_serve_trace(tcfg, reqs, batch=2, params=tp, device="cpu")
    _tokens_equal(got.tokens, want.tokens)
    assert len(got.rids) == len(reqs)
    assert (got.latencies > 0).all() and 0 < got.occupancy_mean <= 1.0


# ---------------------------------------------------------------------------
# in-framework contracts, kept by the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,steps", [(None, 12), (8, 20)])
def test_paged_decode_bitwise_matches_dense(window, steps):
    """Same batch width, same positions: logits and cache content are
    bit-identical to ``T.decode_step`` — with window=8 the ring wraps."""
    _, cfg = _cfg(window=window)
    B = 2
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    seq = steps if window is None else 32
    spec = PagedCacheSpec.for_config(cfg, num_slots=B, page_size=4,
                                     max_seq=seq, window=window)
    alloc = _full_tables(spec)
    table = torch.tensor(alloc.tables)
    pages = init_pages(spec)
    dense = T.init_cache(cfg, B, seq, window)
    active = torch.ones((B,), dtype=torch.bool)
    rng = np.random.default_rng(1)
    for t in range(steps):
        tok = torch.tensor(rng.integers(cfg.vocab_size, size=(B, 1)))
        dl, dense = T.decode_step(params, dense, tok, t, cfg, window)
        pl, pages = paged_decode_step(
            params, pages, table, tok, torch.full((B,), t, dtype=torch.int32),
            active, cfg, window=window)
        assert torch.equal(dl, pl), f"step {t}"
    for name in ("k", "v"):
        view = pages[name][:, table.long()].reshape(
            spec.num_layers, B, spec.seq_capacity, spec.kv_heads,
            spec.head_dim)
        assert torch.equal(view, dense["blocks"][name])


def test_paged_decode_rows_are_independent():
    """Row 0's logits do not change by a bit when row 1 flips between
    active (other position, other tokens) and inactive."""
    _, cfg = _cfg()
    B = 2
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    spec = PagedCacheSpec.for_config(cfg, num_slots=B, page_size=4,
                                     max_seq=16)
    rng = np.random.default_rng(2)
    logs = {True: [], False: []}
    for neighbor_active in (True, False):
        table = torch.tensor(_full_tables(spec).tables)
        pages = init_pages(spec)
        rng0 = np.random.default_rng(3)
        for t in range(8):
            toks = np.zeros((B, 1), np.int64)
            toks[0, 0] = rng0.integers(cfg.vocab_size)
            toks[1, 0] = rng.integers(cfg.vocab_size)
            pos = torch.tensor([t, 2 * t + 1], dtype=torch.int32)
            active = torch.tensor([True, neighbor_active])
            logits, pages = paged_decode_step(
                params, pages, table, torch.tensor(toks), pos, active, cfg)
            logs[neighbor_active].append(logits[0].clone())
    for t, (x, y) in enumerate(zip(logs[True], logs[False])):
        assert torch.equal(x, y), f"row-0 leak at step {t}"


def test_inactive_slots_leave_scratch_page_untouched():
    _, cfg = _cfg()
    spec = PagedCacheSpec.for_config(cfg, num_slots=2, page_size=4,
                                     max_seq=8)
    pages = init_pages(spec)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    paged_decode_step(params, pages,
                      torch.tensor(PageAllocator(spec).tables),
                      torch.zeros((2, 1), dtype=torch.int64),
                      torch.zeros((2,), dtype=torch.int32),
                      torch.zeros((2,), dtype=torch.bool), cfg)
    assert not pages["k"].any() and not pages["v"].any()


def _solo_tokens(cfg, params, req, window, cache_len):
    """The request alone: prefill the exact-length prompt, then greedy
    decode — the reference token sequence."""
    cache = T.init_cache(cfg, 1, cache_len, window)
    logits, cache = T.prefill(params, cache,
                              torch.tensor(req.prompt[None, :]), cfg, window)
    toks = [int(torch.argmax(logits[0, -1]))]
    pos = len(req.prompt)
    for _ in range(req.gen - 1):
        logits, cache = T.decode_step(
            params, cache, torch.tensor([[toks[-1]]]), pos, cfg, window)
        toks.append(int(torch.argmax(logits[0, -1])))
        pos += 1
    return np.array(toks, np.int32)


@pytest.mark.parametrize("kv,window", [(2, None), (1, 8)])
def test_continuous_matches_solo(kv, window):
    _, cfg = _cfg(kv=kv, window=window)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    reqs = sample_requests(poisson_trace(50.0, 6, seed=3), cfg,
                           prompt_range=(4, 8), gen_range=(3, 6), seed=3)
    srv = ContinuousServer(cfg, params, slots=2, page_size=4, max_seq=16,
                           window=window, device="cpu")
    rep = srv.run(reqs)
    assert len(rep.rids) == len(reqs)
    for r in reqs:
        want = _solo_tokens(cfg, params, r, window,
                            srv.spec.seq_capacity if window is None else 16)
        assert np.array_equal(rep.tokens[r.rid], want), r.rid
    assert rep.total_tokens == sum(r.gen for r in reqs)
    assert (rep.queue_waits >= 0).all() and (rep.latencies > 0).all()


def test_continuous_run_is_reproducible_after_reset():
    _, cfg = _cfg()
    reqs = sample_requests(poisson_trace(30.0, 5, seed=1), cfg,
                           prompt_range=(4, 8), gen_range=(3, 5), seed=1)
    srv = ContinuousServer(cfg, slots=2, page_size=4, max_seq=16,
                           device="cpu")
    rep1 = srv.run(reqs)
    srv.reset()
    _tokens_equal(srv.run(reqs).tokens, rep1.tokens)


def test_parallel_prefill_matches_scan_tokens():
    _, cfg = _cfg()
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    reqs = sample_requests(poisson_trace(30.0, 4, seed=5), cfg,
                           prompt_range=(4, 8), gen_range=(3, 5), seed=5)
    tok = {mode: ContinuousServer(cfg, params, slots=2, page_size=4,
                                  max_seq=16, prefill_mode=mode,
                                  device="cpu").run(reqs).tokens
           for mode in ("scan", "parallel")}
    _tokens_equal(tok["scan"], tok["parallel"])


@pytest.mark.parametrize("window", [None, 8])
def test_bucketed_gather_matches_full_tokens(window):
    _, cfg = _cfg(window=window)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    reqs = sample_requests(poisson_trace(40.0, 6, seed=4), cfg,
                           prompt_range=(4, 8), gen_range=(3, 6), seed=4)
    toks = {}
    for gm in ("full", "bucket"):
        srv = ContinuousServer(cfg, params, slots=2, page_size=4,
                               max_seq=16, window=window, gather_mode=gm,
                               device="cpu")
        srv.warmup([8])
        toks[gm] = srv.run(reqs).tokens
    _tokens_equal(toks["full"], toks["bucket"])


def test_gather_bucket_uses_active_rows_only():
    _, cfg = _cfg()
    srv = ContinuousServer(cfg, slots=2, page_size=4, max_seq=16,
                           device="cpu")
    pos = np.array([3, 900], np.int32)        # row 1 retired, stale pos
    act = np.array([True, False])
    assert srv._gather_bucket(pos, act) == 1
    assert srv._gather_bucket(pos, ~act) is None      # capacity-clamped
    assert srv._gather_bucket(pos, np.zeros(2, bool)) is None
    assert srv._gather_ladder() == [None, 1, 2]
    full = ContinuousServer(cfg, slots=2, page_size=4, max_seq=16,
                            gather_mode="full", device="cpu")
    assert full._gather_bucket(pos, act) is None


def test_serving_metrics_land_in_registry():
    from repro_torch.obs.metrics import MetricRegistry
    _, cfg = _cfg()
    reg = MetricRegistry()
    srv = ContinuousServer(cfg, slots=2, page_size=4, max_seq=16,
                           registry=reg, device="cpu")
    reqs = sample_requests(poisson_trace(30.0, 3, seed=0), cfg,
                           prompt_range=(4, 8), gen_range=(3, 4), seed=0)
    srv.run(reqs)
    for name in ("serving.queue_wait_s", "serving.prefill_s",
                 "serving.decode_s", "serving.decode_step_s",
                 "serving.latency_s", "serving.occupancy"):
        assert len(reg.series(name).values) > 0, name
    assert reg.counter("serving.requests_completed").value == 3
    assert reg.counter("serving.tokens_generated").value == \
        sum(r.gen for r in reqs)


# ---------------------------------------------------------------------------
# storage, guards and devices
# ---------------------------------------------------------------------------

def test_allocator_is_the_jax_allocator():
    """Same call sequence, same tables and free counts as the JAX copy."""
    jcfg, tcfg = _cfg()
    specs = [cls.for_config(c, num_slots=2, page_size=4, max_seq=16)
             for cls, c in ((JPagedCacheSpec, jcfg), (PagedCacheSpec, tcfg))]
    ja, ta = JPageAllocator(specs[0]), PageAllocator(specs[1])
    for op, s, n in (("ensure", 0, 1), ("ensure", 0, 5), ("ensure", 1, 16),
                     ("release", 0, 0), ("ensure", 0, 9), ("release", 1, 0)):
        for a in (ja, ta):
            getattr(a, op)(s, n) if op == "ensure" else a.release(s)
        assert np.array_equal(ja.tables, ta.tables)
        assert ja.pages_free == ta.pages_free
    ta._free.clear()
    with pytest.raises(RuntimeError):
        ta.ensure(1, 1)


def test_pages_and_spec():
    _, cfg = _cfg()
    with pytest.raises(ValueError):
        PagedCacheSpec.for_config(cfg, num_slots=2, page_size=5, max_seq=16)
    spec = PagedCacheSpec.for_config(
        dataclasses.replace(cfg, compute_dtype="bfloat16"), num_slots=2,
        page_size=4, max_seq=16)
    pages = init_pages(spec)
    assert pages["k"].shape == (2, 9, 4, 2, 16)
    assert pages["k"].dtype == torch.bfloat16


def test_request_capacity_guard():
    _, cfg = _cfg()
    srv = ContinuousServer(cfg, slots=2, page_size=4, max_seq=8,
                           device="cpu")
    big = sample_requests(poisson_trace(10.0, 1, seed=0), cfg,
                          prompt_range=(8, 8), gen_range=(8, 8), seed=0)
    with pytest.raises(ValueError):
        srv.run(big)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is valid here")
    _, cfg = _cfg()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousServer(cfg, slots=2, page_size=4, max_seq=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        static_serve_trace(cfg, [], batch=2)


@pytest.mark.parametrize("impl", ["cuda", "cuda_gather"])
def test_kernel_impls_on_cpu_raise(impl):
    _, cfg = _cfg()
    with pytest.raises(ValueError, match="CUDA"):
        ContinuousServer(cfg, slots=2, page_size=4, max_seq=16,
                         attn_impl=impl, device="cpu")
    spec = PagedCacheSpec.for_config(cfg, num_slots=2, page_size=4,
                                     max_seq=8)
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_step(params, init_pages(spec),
                          torch.tensor(PageAllocator(spec).tables),
                          torch.zeros((2, 1), dtype=torch.int64),
                          torch.zeros((2,), dtype=torch.int32),
                          torch.ones((2,), dtype=torch.bool), cfg,
                          attn_impl=impl)


def test_server_rejects_bad_options():
    _, cfg = _cfg(window=8)
    for kw, match in (({"attn_impl": "xla"}, "attn_impl"),
                      ({"gather_mode": "nope"}, "gather_mode"),
                      ({"prefill_mode": "nope"}, "prefill_mode"),
                      ({"prefill_mode": "parallel"}, "non-ring")):
        with pytest.raises(ValueError, match=match):
            ContinuousServer(cfg, slots=2, page_size=4, max_seq=16,
                             device="cpu", **kw)
    _, ssm = _cfg(arch_type="ssm")
    with pytest.raises(ValueError, match="dense/moe"):
        ContinuousServer(ssm, slots=2, page_size=4, max_seq=16, device="cpu")
