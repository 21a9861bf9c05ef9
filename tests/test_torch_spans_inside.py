"""The spans inside the port's serving loop and grouped round
(``obs.spans``), on the CPU:

- a served run under a ``Tracer``: one ``serve.decode.upload`` and one
  ``serve.decode.dispatch`` child per ``serve.decode_step``, each the
  eager step (``graph=False``, the graph counters at 0); per admitted
  rid exactly one ``serve.admit``, one ``serve.prefill`` whose ``rids``
  hold it and one ``serve.retire``; a prefill's ``rows`` are slots x
  bucket and its ``prompt_tokens`` the sum of its ``prompt_lens``;
  ``ServeReport.first_tokens`` and the ``serving.ttft_s`` series agree
  with the ``serve.retire`` instants;
- with tracing off the server records no span and builds no ``rids``,
  ``prompt_lens`` or ``contexts`` list;
- a grouped round gives g ``round.grad``, g ``round.stack`` and one
  ``round.update`` under ``engine.dispatch``;
- every span opens a ``record_function`` range of its name.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.engine import Engine
from repro_torch.obs import spans
from repro_torch.obs.metrics import MetricRegistry
from repro_torch.serving import (ContinuousServer, poisson_trace,
                                 sample_requests)

SLOTS = 3


def _cfg():
    return ArchConfig(name="t-spans", arch_type="dense", num_layers=2,
                      d_model=32, num_heads=2, num_kv_heads=2, head_dim=16,
                      d_ff=32, vocab_size=64, sliding_window=None,
                      compute_dtype="float32", remat=False)


def _serve(tracer, prefill_mode="parallel", n=7, registry=None):
    cfg = _cfg()
    srv = ContinuousServer(cfg, slots=SLOTS, page_size=4, max_seq=32,
                           prefill_mode=prefill_mode, registry=registry,
                           device="cpu")
    reqs = sample_requests(poisson_trace(40.0, n, seed=3), cfg,
                           prompt_range=(3, 9), gen_range=(1, 6), seed=3)
    with spans.install(tracer):
        srv.warmup([9])
        rep = srv.run(reqs)
    return reqs, rep


@pytest.fixture(scope="module")
def served():
    tracer = spans.Tracer()
    reg = MetricRegistry()
    reqs, rep = _serve(tracer, registry=reg)
    return reqs, rep, tracer.records(), reg


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_decode_step_has_one_upload_and_one_dispatch(served):
    _, _, recs, _ = served
    by = _by_name(recs)
    steps = {r.index for r in by["serve.decode_step"]}
    assert steps
    for child in ("serve.decode.upload", "serve.decode.dispatch"):
        parents = Counter(r.parent for r in by[child] if r.parent in steps)
        assert set(parents) == steps and set(parents.values()) == {1}
    # the warmup's steps dispatch with no decode step around them
    assert any(r.parent is None for r in by["serve.decode.dispatch"])
    iters = {r.index for r in by["serve.iteration"]}
    assert {r.parent for r in by["serve.decode_step"]} <= iters
    for r in by["serve.decode_step"]:
        assert r.attrs["context_tokens"] == sum(r.attrs["contexts"])
        assert len(r.attrs["contexts"]) == r.attrs["occupancy"]


def test_each_request_admitted_prefilled_and_retired_once(served):
    reqs, _, recs, _ = served
    by = _by_name(recs)
    rids = sorted(r.rid for r in reqs)
    assert sorted(r.attrs["rid"] for r in by["serve.admit"]) == rids
    assert sorted(r.attrs["rid"] for r in by["serve.retire"]) == rids
    held = [rid for p in by["serve.prefill"] for rid in p.attrs["rids"]]
    assert sorted(held) == rids
    iters = {r.index for r in by["serve.iteration"]}
    for name in ("serve.admit", "serve.prefill"):
        assert {r.parent for r in by[name]} <= iters
    gen = {r.rid: r.gen for r in reqs}
    for r in by["serve.retire"]:
        assert r.attrs["tokens"] == gen[r.attrs["rid"]]
        assert r.attrs["last_token_s"] >= r.attrs["first_token_s"]
    for r in by["serve.admit"]:
        assert r.attrs["queue_wait_s"] >= 0 and 0 <= r.attrs["slot"] < SLOTS


def test_prefill_counts_rows_and_prompt_tokens(served):
    reqs, _, recs, _ = served
    plen = {r.rid: len(r.prompt) for r in reqs}
    for p in _by_name(recs)["serve.prefill"]:
        a = p.attrs
        assert a["rows"] == SLOTS * a["bucket"]
        assert a["prompt_tokens"] == sum(a["prompt_lens"])
        assert a["prompt_lens"] == [plen[rid] for rid in a["rids"]]
        assert a["lanes"] == len(a["rids"])


def test_first_tokens_match_retire_instants(served):
    reqs, rep, recs, reg = served
    retire = {r.attrs["rid"]: r.attrs for r in _by_name(recs)["serve.retire"]}
    for rid, first, arrival in zip(rep.rids, rep.first_tokens, rep.arrivals):
        assert first == retire[int(rid)]["first_token_s"]
        assert first >= arrival
    np.testing.assert_array_equal(rep.ttfts, rep.first_tokens - rep.arrivals)
    ttft = reg.series("serving.ttft_s")
    assert len(ttft.values) == len(reqs)
    got = dict(zip(ttft.steps, ttft.values))
    for rid, t in zip(rep.rids, rep.ttfts):
        assert got[int(rid)] == pytest.approx(t, abs=1e-12)


def test_cpu_server_dispatches_the_eager_step(served):
    """Only a server on the card at ``attn_impl="cuda"`` replays a CUDA
    graph: on the CPU every dispatch is the eager step and the graph
    counters stay at 0."""
    _, _, recs, reg = served
    dispatch = _by_name(recs)["serve.decode.dispatch"]
    assert dispatch and all(r.attrs["graph"] is False for r in dispatch)
    assert reg.counter("serving.decode_graph_captures").value == 0
    assert reg.counter("serving.decode_graph_replays").value == 0


def test_scan_prefill_dispatches_under_the_prefill():
    tracer = spans.Tracer()
    _serve(tracer, prefill_mode="scan", n=3)
    names = {r.index: r.name for r in tracer.records()}
    parents = Counter(names.get(r.parent) for r in tracer.records()
                      if r.name == "serve.decode.dispatch")
    assert parents["serve.prefill"] > 0 and parents["serve.decode_step"] > 0


class _Spy(spans.NullTracer):
    """A disabled tracer that keeps what it is handed."""

    def __init__(self):
        self.calls = []

    def span(self, name, **attrs):
        self.calls.append((name, attrs))
        return super().span(name, **attrs)

    def instant(self, name, **attrs):
        self.calls.append((name, attrs))


def test_tracing_off_records_nothing_and_builds_no_lists():
    spy = _Spy()
    _, rep = _serve(spy)
    assert spy.records() == ()
    names = Counter(n for n, _ in spy.calls)
    assert names["serve.decode_step"] > 0 and names["serve.prefill"] > 0
    for _, attrs in spy.calls:
        assert not {"rids", "prompt_lens", "contexts"} & set(attrs)
        assert not any(isinstance(v, list) for v in attrs.values())
    assert len(rep.first_tokens) == len(rep.rids)


def test_serving_registry_keeps_read_instruments_only():
    reg = MetricRegistry()
    _serve(spans.NullTracer(), registry=reg, n=3)
    assert reg.get("serving.batch_occupancy") is None
    assert reg.get("serving.pages_in_use") is None
    assert len(reg.series("serving.occupancy").values) > 0


# ---------------------------------------------------------------------------
# the grouped round
# ---------------------------------------------------------------------------

def _loss(p, b):
    h = torch.tanh(b["x"] @ p["w"])
    return ((h @ p["head"] - b["y"]) ** 2).mean()


@pytest.mark.parametrize("strategy,g", [("grouped-fused", 2),
                                        ("grouped-fused", 4),
                                        ("grouped-scan", 3)])
def test_grouped_round_spans(strategy, g):
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(6, 5, generator=gen),
              "head": torch.randn(5, 1, generator=gen)}
    mom = {k: torch.zeros_like(v) for k, v in params.items()}
    rng = np.random.default_rng(0)
    batches = [{"x": rng.standard_normal((4 * g, 6)).astype(np.float32),
                "y": rng.standard_normal((4 * g, 1)).astype(np.float32)}
               for _ in range(2)]
    tracer = spans.Tracer()
    with spans.install(tracer):
        eng = Engine(_loss, strategy=strategy, num_groups=g, lr=0.05,
                     momentum=0.3, update_impl="torch", exec_mode="vmap",
                     head_filter=lambda path: "head" in str(path),
                     device="cpu")
        eng.run(params, mom, iter(batches), steps=2)
    recs = tracer.records()
    names = {r.index: r.name for r in recs}
    dispatches = [r.index for r in recs if r.name == "engine.dispatch"]
    assert len(dispatches) == 2
    for d in dispatches:
        kids = Counter(r.name for r in recs if r.parent == d)
        assert kids == {"round.grad": g, "round.stack": g,
                        "round.update": 1}
    groups = sorted(r.attrs["group"] for r in recs
                    if r.name == "round.grad" and r.parent == dispatches[0])
    assert groups == list(range(g))
    upd = [r for r in recs if r.name == "round.update"][0]
    assert upd.attrs == {"g": g, "leaves": 2,
                         "impl": "torch" if strategy == "grouped-fused"
                         else "scan"}
    assert all(names[r.parent] == "engine.dispatch" for r in recs
               if r.name.startswith("round."))


# ---------------------------------------------------------------------------
# the profiler's ranges
# ---------------------------------------------------------------------------

def test_enabled_spans_open_profiler_ranges():
    from torch.profiler import ProfilerActivity, profile
    tracer = spans.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.install(tracer):
            with spans.span("outer.phase"):
                with spans.span("inner.phase"):
                    torch.ones(4).sum()
                spans.instant("a.moment")
    got = Counter(e.name for e in prof.events())
    assert got["outer.phase"] == 1 and got["inner.phase"] == 1
    assert got["a.moment"] == 0
    assert all(e.is_user_annotation for e in prof.events()
               if e.name in ("outer.phase", "inner.phase"))


def test_null_tracer_opens_no_range():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.install(spans.NullTracer()):
            with spans.span("quiet.phase"):
                torch.ones(4).sum()
    assert not any(e.name == "quiet.phase" for e in prof.events())
