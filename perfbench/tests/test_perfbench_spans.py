"""The readers of the program's spans inside the serving loop and the
grouped round, and the map of those spans onto the device trace's clock
(``harness.span_clock``), on small cells on the CPU:

- each span's ``record_function`` range in a profile covers, to within
  0.5 ms, where ``span_clock`` maps the span through the mark, and nine in
  ten lie within 0.5 ms of it at both edges;
- a ``--trace 1`` run of the small chat cell reads the four
  ``program_span`` metrics; on the small chat and training cells the two
  ``device_trace`` readers give None or a share no larger than the cell's
  ``idle_share``;
- where the program records none of these spans (as a program without
  them would), every reader returns None and none raises;
- ``span_clock``'s overlap of spans with the device's gaps, on intervals
  laid out by hand.
"""
from __future__ import annotations

import gc
import types

import pytest

import perfbench_small_cells as S

from harness import common, report, span_clock
from harness import serve as serve_runner
from harness.common import clock
from harness.trace import DeviceTrace

SEED = 2 ** 31 + 77
SPAN_READERS = ("decode_dispatch_ms.serve", "decode_wait_ms.serve",
                "loop_host_ms.serve", "queue_wait_p90_ms.serve")
TRACE_READERS = ("idle_dispatch_share.serve", "idle_grad_share.train")
NEW = SPAN_READERS + tuple(TRACE_READERS)


def _per_layer(cell_name):
    return [m for m in common.benchmark()["per_layer"]
            if cell_name in m["workloads"]]


class _LateStamps(serve_runner.Stamps):
    """The serving runner's stamps, starting the profiler once 2 s of host
    time have passed (not at a share of the server's clock, which skips
    ahead while it idles), so that requests are admitted a second and more
    before the mark on any machine."""

    def step(self, *args, **kw):
        late = clock() - self.t0 >= 2.0
        self.trace_from = 0.0 if late else float("inf")
        return super().step(*args, **kw)


def _short_stretch(mp, seconds=0.3):
    mp.setattr(serve_runner, "TRACE_SECONDS", seconds)
    mp.setattr(serve_runner, "Stamps", _LateStamps)


class _Ranges(DeviceTrace):
    """A device trace that keeps the profiler's user-annotation ranges."""

    def _read(self):
        self.ranges = [(e.name, e.time_range.start, e.time_range.end)
                       for e in self.prof.events()
                       if getattr(e, "is_user_annotation", False)]
        super()._read()


@pytest.fixture(scope="module")
def chat_run():
    """One traced run of the small chat cell with a short profiled
    stretch, so that spans lie on both sides of it. The collector is off
    meanwhile: a collection between a range's start and its span's clock
    read would part the two by its own length, which is no clock's error."""
    mp = pytest.MonkeyPatch()
    _short_stretch(mp, seconds=1.0)
    mp.setattr(serve_runner, "DeviceTrace", _Ranges)
    gc.disable()
    try:
        cell = S.chat_cell()
        cell.per_layer = _per_layer("qwen2-7b.chat")
        drv = report.make_runner(cell, SEED, 3.0, True, device="cpu")
        out = drv.run()
    finally:
        gc.enable()
        mp.undo()
    return cell, out


def _ctx(cell, out, trace="run", spans=None):
    tr = out["trace"] if trace == "run" else trace
    return report.Context(cell=cell, out=out, trace=tr,
                          spans=(out["tracer"].records() if spans is None
                                 else spans))


def test_record_function_ranges_lie_where_the_mark_maps_the_spans(chat_run):
    _, out = chat_run
    tr = out["trace"]
    ranges = {}
    for name, a, b in tr.ranges:
        if a >= tr.lo and b <= tr.hi:
            ranges.setdefault(name, []).append((a, b))
    inside = [r for r in out["tracer"].records()
              if r.t1 > r.t0 and r.t0 >= tr.t_mark and r.t1 <= tr.t_end]
    assert {r.name for r in inside} >= {"serve.decode_step",
                                        "serve.decode.dispatch",
                                        "serve.iteration"}
    starts, ends = [], []
    for r in inside:
        a = span_clock.to_trace_us(tr, r.t0)
        b = span_clock.to_trace_us(tr, r.t1)
        got = ranges.get(r.name, [])
        assert got, r.name
        ra, rb = min(got, key=lambda x: abs(x[0] - a))
        starts.append(ra - a)
        ends.append(rb - b)
    # every range covers its mapped span to within 0.5 ms: a range opens
    # before its span reads the clock and closes after, and the host being
    # preempted between the two only widens it
    assert max(starts) < 500.0 and min(ends) > -500.0, (max(starts),
                                                         min(ends))
    # and nine in ten lie within 0.5 ms of it at both edges
    for d in (starts, ends):
        assert sorted(map(abs, d))[int(0.9 * len(d))] < 500.0


def test_traced_chat_run_reads_the_span_metrics():
    mp = pytest.MonkeyPatch()
    _short_stretch(mp)
    try:
        cell = S.chat_cell()
        cell.per_layer = _per_layer("qwen2-7b.chat")
        line, checks = report.run_cell(cell, SEED, 3.0, True, device="cpu")
    finally:
        mp.undo()
    assert line["correct"], checks
    got = line["metrics"]
    assert set(SPAN_READERS) <= set(got)
    for name in SPAN_READERS:
        assert got[name]["value"] >= 0
    # a pass's own host work and the wait are small against the dispatch
    assert got["decode_dispatch_ms.serve"]["value"] > \
        got["decode_wait_ms.serve"]["value"]
    share = got.get("idle_dispatch_share.serve")
    assert share is None or \
        share["value"] <= got["idle_share.serve"]["value"] + 1e-9


def test_traced_train_run_reads_idle_grad_share():
    cell = S.lm_train_cell()
    cell.per_layer = _per_layer("qwen2-7b.train-g4")
    line, checks = report.run_cell(cell, SEED, 0.5, True, device="cpu")
    assert line["correct"], checks
    got = line["metrics"]
    share = got.get("idle_grad_share.train")
    assert share is None or \
        0 <= share["value"] <= got["idle_share.train"]["value"] + 1e-9


@pytest.mark.parametrize("device_trace", ["run", None],
                         ids=["profiled", "unprofiled"])
def test_readers_agree_with_the_spans_they_read(chat_run, device_trace):
    cell, out = chat_run
    ctx = _ctx(cell, out, trace=device_trace)
    recs = ctx.spans
    names = {r.index: r.name for r in recs}
    steps = [r for r in recs if r.name == "serve.decode_step"
             and (device_trace is None or r.t1 <= out["trace"].t_mark - 1.0
                  or r.t0 >= out["trace"].t_end)]
    if not steps:
        pytest.fail("no decode step outside the profiled stretch")
    disp = common.load_reader("decode_dispatch_ms.serve")(ctx)
    wait = common.load_reader("decode_wait_ms.serve")(ctx)
    whole = common.load_reader("decode_step_ms.serve")(ctx)
    kids = [r for r in recs if names.get(r.parent) == "serve.decode_step"
            and r.parent in {s.index for s in steps}]
    assert len(kids) == 2 * len(steps)
    # medians of the parts against the median of the whole (each reader
    # picks its own spans outside the stretch, so the sets differ a little)
    assert disp > 0 and wait > 0
    assert 0.9 * whole <= disp + wait <= 1.05 * whole
    qw = common.load_reader("queue_wait_p90_ms.serve")(ctx)
    assert qw is not None and qw >= 0


def test_readers_find_nothing_without_the_spans(chat_run):
    """A program without the new spans: the parent's ``serve.decode_step``
    and ``serve.prefill`` only. Every new reader returns None."""
    cell, out = chat_run
    old = tuple(r for r in out["tracer"].records()
                if r.name in ("serve.decode_step", "serve.prefill"))
    for spans in (old, ()):
        for trace in ("run", None):
            ctx = _ctx(cell, out, trace=trace, spans=spans)
            for name in NEW:
                assert common.load_reader(name)(ctx) is None, name
    # the old reader still reads the old spans
    assert common.load_reader("decode_step_ms.serve")(
        _ctx(cell, out, trace=None, spans=old)) > 0


def _trace(intervals, lo=0.0, hi=100.0, t_mark=10.0):
    tr = DeviceTrace()
    tr.intervals = [(a, b, "k") for a, b in intervals]
    tr.lo, tr.hi, tr.t_mark, tr.t_end = lo, hi, t_mark, \
        t_mark + (hi - lo) * 1e-6
    return tr


def _rec(t0_us, t1_us, t_mark=10.0):
    return types.SimpleNamespace(t0=t_mark + t0_us * 1e-6,
                                 t1=t_mark + t1_us * 1e-6)


@pytest.mark.parametrize("spans,busy,want_us", [
    ([(0, 100)], [(10, 20), (50, 60)], 80.0),       # idle = all gaps
    ([(15, 55)], [(10, 20), (50, 60)], 30.0),       # exact, not midpoints
    ([(12, 18)], [(10, 20)], 0.0),                  # inside a kernel
    ([(-50, 5), (95, 150)], [], 10.0),              # clipped to the stretch
    ([(20, 40), (30, 45)], [(0, 25)], 20.0),        # overlapping spans once
])
def test_idle_overlap_on_hand_laid_intervals(spans, busy, want_us):
    tr = _trace(busy)
    recs = [_rec(a, b) for a, b in spans]
    got = span_clock.idle_overlap_s(tr, recs)
    assert got == pytest.approx(want_us * 1e-6, abs=1e-12)
    idle = tr.window_s - tr.busy_s
    assert got <= idle + 1e-12


def test_idle_share_in_needs_a_span_in_the_stretch():
    tr = _trace([(10, 20)])
    assert span_clock.idle_share_in(tr, [_rec(200, 300)]) is None
    assert span_clock.idle_share_in(None, [_rec(0, 5)]) is None
    assert span_clock.idle_share_in(tr, [_rec(0, 5)]) == pytest.approx(5.0)
