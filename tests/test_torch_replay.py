"""Port parity: trace replay (``exec/replay.py``), the engine's
``trace-replay`` strategy and ``launch/train.py --replay-trace`` against
the JAX package.

Both sides get the same numpy parameters and batches (the JAX
``mlp_classify`` workload's, through ``params_from_jax``) and the same
traces: the golden fixtures ``tests/golden/queue_sim_g4.npz`` and
``hetero_g3.npz`` (which the port's simulators reproduce bit for bit),
traces from ``queue_sim.simulate`` and ``EventTrace.round_robin``.

- the ring slots of ``_read_slots`` are exactly JAX's, at every depth;
- python and scan replays agree within the port (1e-6) and each lies
  within 1e-5 relative of JAX's, on stochastic and golden traces, with
  momentum and weight decay, recording the parameter trace;
- a delayed round-robin trace reduces to the port's ``delayed_sgd_run``;
  on grouped round-robin traces python, scan and fused agree with JAX's
  fused replay within 2e-5; fused refuses traces without run structure
  and a depth cap;
- ``replayed_momentum_experiment``: the run-averaged trajectory within
  1e-5 absolute of JAX's (fp32 sums over runs in other orders), and its
  fitted modulus within 10% of Theorem 1's 1 - 1/g;
- ``Engine(strategy="trace-replay")`` on smoke lenet and qwen2-7b against
  the JAX ``Engine(exec_mode="vmap")``: per-commit losses and final
  params within 1e-4 (fp32), with the ``staleness`` series, the
  ``replay_max_staleness`` gauge and the ``replay_commits`` counter;
- the launcher's ``--replay-trace`` losses against the JAX launcher's on
  the same argv within 1e-4.
"""
import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.core.workload import mlp_classify as j_mlp
from repro.exec import EventTrace as JEventTrace
from repro.exec import replay as JR
from repro_torch.cluster.sim import simulate_hetero
from repro_torch.core import queue_sim
from repro_torch.core import tree as T
from repro_torch.core.async_sgd import delayed_sgd_run
from repro_torch.core.workload import mlp_classify
from repro_torch.exec import EventTrace
from repro_torch.exec import replay as R
from repro_torch.models.convert import params_from_jax

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
RTOL, ATOL = 1e-5, 1e-6
TOL = 1e-4
LR, MU, WD = 0.05, 0.3, 0.01


def _golden(name):
    return EventTrace.load(GOLDEN / name)


def _jtrace(tr):
    return JEventTrace(num_groups=tr.num_groups, group=tr.group,
                       read_version=tr.read_version,
                       commit_time=tr.commit_time)


def _workload(n, seed=0):
    """(JAX params, batches), (port params, batches): the JAX
    ``mlp_classify``'s numbers on both sides."""
    wl = j_mlp()
    params = jax.device_get(wl.init(jax.random.PRNGKey(seed)))
    batches = jax.device_get(wl.sample_batches(jax.random.PRNGKey(seed + 1),
                                               n, wl.batch_size))
    return ((params, batches),
            (params_from_jax(params), params_from_jax(batches)))


def _close(got, want, rtol=RTOL, atol=ATOL):
    gl = got if isinstance(got, list) else [
        x.numpy() for x in T.leaves(got)]
    wl = want if isinstance(want, list) else [
        np.asarray(x) for x in jax.tree.leaves(want)]
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


def _sim_trace(g, iters, seed):
    return queue_sim.simulate(g=g, t_conv=1.0, t_fc=0.1, iters=iters,
                              seed=seed, return_trace=True)[1]


# ---------------------------------------------------------------------------
# traces and slots
# ---------------------------------------------------------------------------

def test_port_simulators_reproduce_the_golden_traces():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_golden", GOLDEN / "make_golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, fresh in (
            ("queue_sim_g4.npz", queue_sim.simulate(
                **mod.QUEUE_ARGS, return_trace=True)[1]),
            ("hetero_g3.npz", simulate_hetero(
                **mod.HETERO_ARGS, return_trace=True)[1])):
        golden = _golden(name)
        assert fresh.num_groups == golden.num_groups
        for f in ("group", "read_version", "commit_time"):
            assert np.array_equal(getattr(fresh, f), getattr(golden, f))


@pytest.mark.parametrize("depth", [None, 1, 2, 3, 5, 64])
def test_read_slots_are_jax_slots(depth):
    traces = [_golden("queue_sim_g4.npz"), _golden("hetero_g3.npz"),
              _sim_trace(3, 40, 13),
              EventTrace.round_robin(4, 12, "delayed"),
              EventTrace.round_robin(3, 9, "grouped")]
    for tr in traces:
        R_port, s_port = R._read_slots(tr, depth)
        R_jax, s_jax = JR._read_slots(_jtrace(tr), depth)
        assert R_port == R_jax
        assert s_port.dtype == s_jax.dtype and np.array_equal(s_port, s_jax)
    with pytest.raises(ValueError, match="depth"):
        R._read_slots(traces[0], 0)


# ---------------------------------------------------------------------------
# python / scan / fused against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["sim", "golden_queue", "golden_hetero",
                                   "depth2"])
def test_python_and_scan_match_each_other_and_jax(which):
    tr = {"sim": lambda: _sim_trace(3, 24, 13),
          "golden_queue": lambda: _golden("queue_sim_g4.npz").truncate(24),
          "golden_hetero": lambda: _golden("hetero_g3.npz").truncate(24),
          "depth2": lambda: _sim_trace(4, 20, 23)}[which]()
    depth = 2 if which == "depth2" else None
    (jp, jb), (tp, tb) = _workload(len(tr), seed=2)
    kw = dict(lr=LR, momentum=MU, weight_decay=WD, depth=depth,
              record_params=True)
    py = R.replay_trace_python(mlp_classify().loss_fn, tp, tb, tr, **kw)
    sc = R.replay_trace_scan(mlp_classify().loss_fn, tp, tb, tr, **kw)
    want = JR.replay_trace_scan(j_mlp().loss_fn, jp, jb, _jtrace(tr), **kw)
    for a, b in ((py[0], sc[0]), (py[2], sc[2])):
        _close(a, [x.numpy() for x in T.leaves(b)], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(py[1], sc[1], rtol=1e-6, atol=1e-7)
    for got in (py, sc):
        _close(got[0], want[0])
        _close(got[2], want[2])
        np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=RTOL,
                                   atol=ATOL)
    assert T.leaves(sc[2])[0].shape[0] == len(tr)


@pytest.mark.parametrize("g", [2, 4])
def test_delayed_round_robin_reduces_to_delayed_sgd(g):
    (jp, jb), (tp, tb) = _workload(3 * g)
    tr = EventTrace.round_robin(g, 3 * g, mode="delayed")
    ref_p, ref_l, _ = delayed_sgd_run(mlp_classify().loss_fn, tp, tb,
                                      staleness=g - 1, lr=LR, momentum=0.6)
    want = JR.replay_trace(j_mlp().loss_fn, jp, jb, _jtrace(tr), lr=LR,
                           momentum=0.6, impl="scan")
    for impl in ("python", "scan"):
        got_p, got_l, _ = R.replay_trace(mlp_classify().loss_fn, tp, tb, tr,
                                         lr=LR, momentum=0.6, impl=impl)
        _close(got_p, [x.numpy() for x in T.leaves(ref_p)])
        np.testing.assert_allclose(got_l, ref_l.numpy(), rtol=RTOL,
                                   atol=ATOL)
        _close(got_p, want[0])


@pytest.mark.parametrize("g", [1, 2, 4])
def test_grouped_round_robin_all_impls_match_jax(g):
    (jp, jb), (tp, tb) = _workload(3 * g)
    tr = EventTrace.round_robin(g, 3 * g, mode="grouped")
    kw = dict(lr=LR, momentum=0.6, weight_decay=WD)
    want = JR.replay_trace(j_mlp().loss_fn, jp, jb, _jtrace(tr),
                           impl="fused", **kw)
    for impl in ("python", "scan", "fused"):
        got_p, got_l, _ = R.replay_trace(mlp_classify().loss_fn, tp, tb, tr,
                                         impl=impl, **kw)
        _close(got_p, want[0], rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(got_l, np.asarray(want[1]), rtol=RTOL,
                                   atol=ATOL)


def test_fused_refuses_traces_without_run_structure_and_a_depth():
    tr = _sim_trace(3, 20, 17)
    assert tr.equal_read_runs() is None
    _, (tp, tb) = _workload(len(tr))
    with pytest.raises(ValueError, match="equal-read-run"):
        R.replay_trace_fused(mlp_classify().loss_fn, tp, tb, tr, lr=LR)
    grouped = EventTrace.round_robin(4, 20, mode="grouped")
    with pytest.raises(ValueError, match="no parameter history"):
        R.replay_trace(mlp_classify().loss_fn, tp, tb, grouped, lr=LR,
                       impl="fused", depth=2)
    with pytest.raises(ValueError, match="record"):
        R.replay_trace(mlp_classify().loss_fn, tp, tb, grouped, lr=LR,
                       impl="fused", record_params=True)
    with pytest.raises(ValueError, match="unknown replay impl"):
        R.replay_trace(mlp_classify().loss_fn, tp, tb, grouped, lr=LR,
                       impl="vmap")
    with pytest.raises(ValueError, match="batches only"):
        R.replay_trace(mlp_classify().loss_fn, tp,
                       T.tree_map(lambda x: x[:3], tb), grouped, lr=LR)


def test_depth_one_reads_the_live_version():
    """depth=1 keeps only the live version: the zero-staleness replay."""
    tr = _sim_trace(4, 16, 23)
    assert tr.max_staleness >= 1
    _, (tp, tb) = _workload(len(tr), seed=4)
    fresh = EventTrace(num_groups=tr.num_groups, group=tr.group,
                       read_version=np.arange(len(tr)),
                       commit_time=tr.commit_time)
    ref = R.replay_trace_scan(mlp_classify().loss_fn, tp, tb, fresh, lr=LR,
                              momentum=MU)
    got = R.replay_trace_scan(mlp_classify().loss_fn, tp, tb, tr, lr=LR,
                              momentum=MU, depth=1)
    _close(got[0], [x.numpy() for x in T.leaves(ref[0])], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Theorem 1, executed
# ---------------------------------------------------------------------------

def test_replayed_momentum_trajectory_matches_jax():
    kw = dict(eta=0.2, steps=120, runs=64, seed=5)
    got = R.replayed_momentum_experiment(4, **kw)
    want = JR.replayed_momentum_experiment(4, **kw)
    assert got.shape == want.shape == (121,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("g,runs", [(2, 2000), (4, 600), (8, 600)])
def test_replayed_momentum_recovers_one_minus_inv_g(g, runs):
    """As the reference's own test: the fitted modulus of the replayed
    trajectory within 10% of Theorem 1's 1 - 1/g."""
    from repro_torch.core.implicit_momentum import measure_effective_momentum
    traj = R.replayed_momentum_experiment(g, eta=0.2, steps=300, runs=runs,
                                          seed=g)
    w = traj[3:]
    keep = np.nonzero(np.abs(w) >= 1e-3)[0]   # drop the MC-noise tail
    if keep.size:
        w = w[:keep[-1] + 1]
    mu = measure_effective_momentum(w[:, None], w[:, None], lr=0.2,
                                    fit_lr=True)
    th = 1.0 - 1.0 / g
    assert abs(mu - th) / th < 0.10, (g, mu, th)


# ---------------------------------------------------------------------------
# the engine's strategy and the launcher
# ---------------------------------------------------------------------------

def _lenet():
    from repro.models import cnn as JC
    from repro_torch.models import cnn as C
    jcfg = JC.get_cnn_smoke_config("lenet")
    cfg = dataclasses.replace(C.get_cnn_smoke_config("lenet"),
                              conv_impl="lowering")
    jp = JC.init_params(jax.random.PRNGKey(0), jcfg)
    from repro.data import pipeline as JP
    from repro_torch.data import pipeline as P
    data = dict(batch_size=8, image_size=jcfg.image_size,
                channels=jcfg.in_channels, num_classes=jcfg.num_classes,
                seed=0)
    return ((lambda p, b: JC.loss_fn(p, b, jcfg), jp,
             lambda n: JP.SyntheticImages(JP.DataConfig(**data)).batches(n)),
            (lambda p, b: C.loss_fn(p, b, cfg),
             lambda n: P.SyntheticImages(P.DataConfig(**data)).batches(n)))


def _qwen():
    from repro.configs import get_smoke_config as j_smoke
    from repro.data import pipeline as JP
    from repro.models import transformer as JT
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import pipeline as P
    from repro_torch.models import transformer as M
    jcfg = dataclasses.replace(j_smoke("qwen2-7b"), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke_config("qwen2-7b"),
                              compute_dtype="float32")
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    data = dict(batch_size=2, seq_len=16, vocab_size=cfg.vocab_size, seed=0)
    return ((lambda p, b: JT.lm_loss(p, b, jcfg), jp,
             lambda n: JP.SyntheticLM(JP.DataConfig(**data)).batches(n)),
            (lambda p, b: M.lm_loss(p, b, cfg),
             lambda n: P.SyntheticLM(P.DataConfig(**data)).batches(n)))


@pytest.mark.parametrize("impl", ["scan", "python", "fused"])
@pytest.mark.parametrize("model", ["lenet", "qwen2-7b"])
def test_engine_trace_replay_matches_jax_engine(model, impl):
    from repro.engine import Engine as JEngine
    from repro.optim.sgd import init_momentum as j_init_momentum
    from repro_torch.engine import Engine
    from repro_torch.optim.sgd import init_momentum
    (jloss, jparams, jdata), (loss, data) = {"lenet": _lenet,
                                             "qwen2-7b": _qwen}[model]()
    steps = 8
    tr = (EventTrace.round_robin(4, 12, "grouped") if impl == "fused"
          else _sim_trace(4, 12, 2))
    kw = dict(strategy="trace-replay", lr=LR, momentum=MU, weight_decay=WD,
              replay_impl=impl)
    jeng = JEngine(jloss, exec_mode="vmap", trace=_jtrace(tr), **kw)
    jp, _, jl = jeng.run(jparams, j_init_momentum(jparams), jdata(steps),
                         steps=steps)
    params = params_from_jax(jax.device_get(jparams))
    before = T.leaves(params)[0].clone()
    eng = Engine(loss, trace=tr, device="cpu", update_impl="torch", **kw)
    tp, tm, tl = eng.run(params, init_momentum(params), data(steps),
                         steps=steps)
    assert torch.equal(T.leaves(params)[0], before)    # caller's untouched
    assert len(tl) == len(jl) == steps
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    _close(tp, jp, rtol=TOL, atol=TOL)
    assert all(float(x.abs().max()) == 0 for x in T.leaves(tm))
    reg = eng.telemetry.registry
    assert reg.series("staleness").values == [
        float(s) for s in tr.truncate(steps).staleness]
    assert reg.gauge("replay_max_staleness").value == \
        tr.truncate(steps).max_staleness
    assert reg.counter("replay_commits").value == steps
    assert "engine[trace-replay]" in eng.describe()


def test_engine_replay_refusals():
    from repro_torch.engine import Engine
    eng = Engine(lambda p, b: 0.0, strategy="trace-replay", device="cpu",
                 update_impl="torch")
    with pytest.raises(ValueError, match="needs Engine\\(trace"):
        eng.replay({}, {})
    with pytest.raises(ValueError, match="no per-round step"):
        eng.step({}, {}, {"x": torch.zeros(2)})
    with pytest.raises(ValueError, match="not a Runner"):
        eng(({}, 0), g=1, mu=0.0, eta=0.1, steps=1, probe=True)
    eng.trace = EventTrace.round_robin(2, 4, "grouped")
    with pytest.raises(ValueError, match="stream ended after 1"):
        eng.run({"w": torch.zeros(2)}, {"w": torch.zeros(2)},
                [{"x": np.zeros(2, np.float32)}], steps=3)


def test_launcher_replay_losses_match_the_jax_launcher(tmp_path,
                                                       monkeypatch):
    """Both launchers from the JAX init's lenet params (the port's own init
    draws from ``torch.Generator``), replaying one saved trace."""
    from repro.launch import train as JTR
    from repro.models import cnn as JC
    from repro_torch.launch import train as TR
    from repro_torch.models import cnn as C
    path = tmp_path / "trace.npz"
    _sim_trace(4, 16, 2).save(path)
    init = JC.init_params
    monkeypatch.setattr(C, "init_params", lambda gen, cfg: params_from_jax(
        jax.device_get(init(jax.random.PRNGKey(0),
                            JC.get_cnn_smoke_config("lenet")))))
    argv = ["--arch", "lenet", "--smoke", "--steps", "12", "--batch", "8",
            "--lr", "0.05", "--momentum", "0.3", "--replay-trace", str(path)]
    want = JTR.main(argv)
    got = TR.main(argv + ["--device", "cpu", "--conv-impl", "lowering",
                          "--update-impl", "torch"])
    assert len(got) == len(want) == 12
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
