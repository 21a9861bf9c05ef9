"""Port parity: the host-side copies of the optimizer path against the JAX
package, on the inputs of the reference's own tests (``test_cluster.py``,
``test_stat_model.py``, ``test_auto_optimizer.py``,
``test_rnn_schedules.py`` and ``test_obs.py``'s report cases).

Each port function returns exactly the reference's values: ``==`` on
floats, and on plans, allocations, simulation results and optimizer
decisions compared field by field (``dataclasses.asdict``). The port's
``hardware_model`` defaults to the H100's figures; it is fed the
reference's own ``V5E`` values here, so both compute the same thing.
``profile_device`` and ``Telemetry.drift`` run on the CPU.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro import cluster as JC
from repro.core import auto_optimizer as JA
from repro.core import bayesian as JB
from repro.core import hardware_model as JH
from repro.core import implicit_momentum as JI
from repro.core import queue_sim as JQ
from repro.core import stat_model as JS
from repro.engine import timing as JTM
from repro.obs import report as JR
from repro.obs.metrics import MetricRegistry as JRegistry
from repro.optim import schedules as JSch
from repro_torch import cluster as C
from repro_torch.core import auto_optimizer as A
from repro_torch.core import bayesian as B
from repro_torch.core import hardware_model as H
from repro_torch.core import implicit_momentum as I
from repro_torch.core import queue_sim as Q
from repro_torch.core import stat_model as S
from repro_torch.engine import timing as TM
from repro_torch.obs import report as R
from repro_torch.obs.metrics import MetricRegistry
from repro_torch.optim import schedules as Sch

MIXED = "8xgpu-g2.2xlarge,8xcpu-c4.4xlarge"
COST = dict(flops_per_example=2e9, bytes_per_example=2e8, grad_bytes=4e6)
BIG = dict(COST, state_bytes=6e9)


def _d(x):
    """A dataclass (nested ones too) as plain values, numpy arrays as
    lists, for ``==`` across the two packages."""
    if dataclasses.is_dataclass(x):
        return _d(dataclasses.asdict(x))
    if isinstance(x, dict):
        return {k: _d(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_d(v) for v in x]
    if isinstance(x, np.ndarray):
        return [x.dtype.str, x.tolist()]
    return x


def _cost(mod, **kw):
    return mod.WorkloadCost(**kw)


# ---------------------------------------------------------------------------
# devices, allocator, simulators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [MIXED, "tpu-v5e", "4xgpu-titan-x,"
                                  "4xcpu-c4.4xlarge", "2xgpu-g2.2xlarge,"
                                  "2xcpu-c4.4xlarge"])
def test_parse_cluster_spec_and_roofline_equal_jax(spec):
    got, want = C.parse_cluster_spec(spec), JC.parse_cluster_spec(spec)
    assert _d(got) == _d(want)
    for a, b in zip(got, want):
        assert (a.predict_throughput(_cost(C, **COST))
                == b.predict_throughput(_cost(JC, **COST)))
    assert set(JC.list_devices()) | {"gpu-h100-sxm"} == set(C.list_devices())
    for bad, exc in (("4xno-such-device", KeyError), ("", ValueError),
                     ("0xcpu-c4.4xlarge", ValueError)):
        with pytest.raises(exc):
            C.parse_cluster_spec(bad)
        with pytest.raises(exc):
            JC.parse_cluster_spec(bad)


def test_h100_entry_mirrors_the_hardware_model():
    h = C.get_device("gpu-h100-sxm")
    assert (h.kind, h.peak_flops, h.mem_bw, h.net_bw) == (
        "gpu", H.H100.peak_flops, H.H100.hbm_bw, H.H100.link_bw)
    assert (H.H100.peak_flops, H.H100.hbm_bw, H.H100.link_bw) == (
        989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("g", [1, 2, 3, 5, 8, 16])
def test_allocate_equals_jax(g):
    got = C.allocate(C.parse_cluster_spec(MIXED), g, 64,
                     cost=_cost(C, **COST))
    want = JC.allocate(JC.parse_cluster_spec(MIXED), g, 64,
                       cost=_cost(JC, **COST))
    assert _d(got) == _d(want) and got.weights == want.weights


def test_rebalance_equals_jax():
    spec = "2xgpu-g2.2xlarge,2xcpu-c4.4xlarge"
    a = C.allocate(C.parse_cluster_spec(spec), 2, 32, cost=_cost(C, **COST))
    ja = JC.allocate(JC.parse_cluster_spec(spec), 2, 32,
                     cost=_cost(JC, **COST))
    times = [3.0 * a.microbatches[0] / a.throughputs[0],
             1.0 * a.microbatches[1] / a.throughputs[1]]
    assert _d(C.rebalance(a, times)) == _d(JC.rebalance(ja, times))
    for mod, alloc in ((C, a), (JC, ja)):
        with pytest.raises(ValueError):
            mod.rebalance(alloc, [1.0])
        with pytest.raises(ValueError):
            mod.allocate(mod.parse_cluster_spec(spec), 8, 4)


@pytest.mark.parametrize("exponential,cv", [(True, None), (False, None),
                                            (False, 0.5)])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_simulators_equal_jax(g, exponential, cv):
    kw = dict(t_fc=0.05, iters=800, exponential=exponential, cv=cv, seed=g,
              return_trace=True)
    got, gtr = Q.simulate(g=g, t_conv=0.7, **kw)
    want, wtr = JQ.simulate(g=g, t_conv=0.7, **kw)
    assert _d(got) == _d(want) and _d(gtr) == _d(wtr)
    het = C.simulate_hetero(t_conv=[0.7] * g, **kw)
    jhet = JC.simulate_hetero(t_conv=[0.7] * g, **kw)
    assert _d(het) == _d(jhet) and _d(het[0]) == _d(got)
    slow = [1.0] * (g - 1) + [4.0]
    assert (_d(C.simulate_hetero(t_conv=[0.5] * g, t_fc=0.05, iters=500,
                                 slowdown=slow, seed=1))
            == _d(JC.simulate_hetero(t_conv=[0.5] * g, t_fc=0.05, iters=500,
                                     slowdown=slow, seed=1)))


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

def _plans(mod, spec, **kw):
    devs = mod.parse_cluster_spec(spec)
    if "cost" in kw:
        kw["cost"] = _cost(mod, **kw["cost"])
    return mod.best_allocation(devs, global_batch=64, t_fc=kw.pop("t_fc"),
                               **kw)


@pytest.mark.parametrize("spec,kw", [
    (MIXED, dict(t_fc=0.002, cost=COST, mu_star_total=0.9)),
    ("8xgpu-g2.2xlarge", dict(t_fc=1e-6, cost=COST, mu_star_total=0.0,
                              se_sharpness=16.0)),
    ("8xgpu-g2.2xlarge", dict(t_fc=0.05, cost=COST, mu_star_total=0.9)),
    ("8xgpu-g2.2xlarge", dict(t_fc=0.002, cost=BIG,
                              mp_candidates=(1, 2, 4))),
    ("8xgpu-g2.2xlarge", dict(t_fc=0.002, cost=COST,
                              mp_candidates=(1, 2, 4))),
    ("4xgpu-g2.2xlarge,4xcpu-c4.4xlarge", dict(t_fc=0.001, cost=COST,
                                               mu_star_total=0.9)),
    (MIXED, dict(t_fc=0.002, cost=COST, se_penalties={1: 1.0, 2: 1.3})),
    ("2xgpu-g2.2xlarge,2xcpu-c4.4xlarge", dict(t_fc=0.002)),
])
def test_best_allocation_equals_jax(spec, kw):
    if "cost" not in kw:     # measured devices: the black-box throughput
        got = C.best_allocation(
            [dataclasses.replace(d, throughput=10.0 * (i + 1))
             for i, d in enumerate(C.parse_cluster_spec(spec))],
            global_batch=64, t_fc=kw["t_fc"])
        want = JC.best_allocation(
            [dataclasses.replace(d, throughput=10.0 * (i + 1))
             for i, d in enumerate(JC.parse_cluster_spec(spec))],
            global_batch=64, t_fc=kw["t_fc"])
    else:
        got, want = _plans(C, spec, **dict(kw)), _plans(JC, spec, **dict(kw))
    assert _d(got) == _d(want)
    assert got.weights == want.weights
    assert got.describe() == want.describe()


def test_planner_terms_equal_jax():
    devs = C.parse_cluster_spec(MIXED)
    jdevs = JC.parse_cluster_spec(MIXED)
    for g in (1, 2, 4):
        assert (_d(C.plan_for_g(devs, g, global_batch=64, t_fc=0.002,
                                cost=_cost(C, **COST)))
                == _d(JC.plan_for_g(jdevs, g, global_batch=64, t_fc=0.002,
                                    cost=_cost(JC, **COST))))
        assert (_d(C.plan_for_g_mp(devs, g, 2, global_batch=64, t_fc=0.002,
                                   cost=_cost(C, **COST)))
                == _d(JC.plan_for_g_mp(jdevs, g, 2, global_batch=64,
                                       t_fc=0.002, cost=_cost(JC, **COST))))
    for ts in ([0.8] * 4, [0.1, 0.5, 2.0]):
        assert (C.hetero_time_per_iteration(ts, 0.05)
                == JC.hetero_time_per_iteration(ts, 0.05))
    d = [C.DeviceSpec("d", "gpu", 1e12, 1e11, 1e9, mem_bytes=4e9)]
    jd = [JC.DeviceSpec("d", "gpu", 1e12, 1e11, 1e9, mem_bytes=4e9)]
    for mp in (1, 2, 4):
        assert C.mp_collective_time(d, 1e9, mp) == JC.mp_collective_time(
            jd, 1e9, mp)
        assert C.mp_feasible(d, _cost(C, **BIG), mp) == JC.mp_feasible(
            jd, _cost(JC, **BIG), mp)
    for mod, dv in ((C, devs), (JC, jdevs)):
        with pytest.raises(ValueError, match="no feasible"):
            mod.best_allocation(
                mod.parse_cluster_spec("8xgpu-g2.2xlarge"), global_batch=64,
                t_fc=0.002, cost=_cost(mod, **dict(BIG, state_bytes=1e12)),
                mp_candidates=(1, 2, 4))


def _sim_kwargs(n=24, rate=20.0):
    rng = np.random.default_rng(0)
    return dict(arrivals=list(np.cumsum(rng.exponential(1 / rate, n))),
                prompt_lens=list(rng.integers(8, 33, n)),
                gen_lens=list(rng.integers(4, 33, n)))


def test_serving_planner_equals_jax():
    kw = _sim_kwargs()
    for rates in (([500.0], [200.0]), ([500.0], [200.0, 200.0]),
                  ([300.0, 100.0], [50.0])):
        got = C.simulate_serving(**kw, prefill_rates=rates[0],
                                 decode_rates=rates[1], slots=8)
        want = JC.simulate_serving(**kw, prefill_rates=rates[0],
                                   decode_rates=rates[1], slots=8)
        assert _d(got) == _d(want)
        assert got.goodput(0.5) == want.goodput(0.5)

    def devs(mod):
        gpu = mod.DeviceSpec("gpu", "gpu", peak_flops=4e12, mem_bw=2e11,
                             net_bw=1e10, throughput=400.0)
        cpu = mod.DeviceSpec("cpu", "cpu", peak_flops=5e11, mem_bw=5e10,
                             net_bw=1e10, throughput=80.0)
        nomeas = dataclasses.replace(gpu, throughput=None)
        return [gpu, gpu, cpu, cpu, nomeas]
    got = C.plan_serving(devs(C), slo_p99_s=1.0, **kw)
    want = JC.plan_serving(devs(JC), slo_p99_s=1.0, **kw)
    assert _d(got) == _d(want) and got.describe() == want.describe()


# ---------------------------------------------------------------------------
# the HE / SE models
# ---------------------------------------------------------------------------

def test_hardware_model_equals_jax_at_its_spec():
    spec = H.GPUSpec(name=JH.V5E.name, peak_flops=JH.V5E.peak_flops,
                     hbm_bw=JH.V5E.hbm_bw, link_bw=JH.V5E.ici_bw)
    for ph_kw in (dict(t_conv_compute_1=1.0, t_fc=0.5, conv_grad_bytes=0.0),
                  dict(t_conv_compute_1=0.3, t_fc=0.01,
                       conv_grad_bytes=4e8)):
        ph, jph = H.PhaseTimes(**ph_kw), JH.PhaseTimes(**ph_kw)
        assert H.smallest_saturating_g(16, ph, spec) == \
            JH.smallest_saturating_g(16, jph, JH.V5E)
        for g in (1, 2, 4, 8, 16):
            assert H.he_time_per_iteration(g, 16, ph, spec) == \
                JH.he_time_per_iteration(g, 16, jph, JH.V5E)
            assert H.he_penalty(g, 16, ph, spec) == JH.he_penalty(
                g, 16, jph, JH.V5E)
            assert H.fc_saturated(g, 16, ph, spec) == JH.fc_saturated(
                g, 16, jph, JH.V5E)
            assert H.t_conv(g, ph, spec) == JH.t_conv(g, jph, JH.V5E)
            assert H.collective_time(3e8, g, spec) == JH.collective_time(
                3e8, g, JH.V5E)
    kw = dict(backbone_flops=3e12, head_flops=2e11, backbone_bytes=5e10,
              head_bytes=9e11, grad_bytes_per_chip=1e8)
    assert _d(H.phase_times_from_roofline(**kw, spec=spec)) == _d(
        JH.phase_times_from_roofline(**kw, spec=JH.V5E))
    with pytest.raises(ValueError):
        H.he_time_per_iteration(3, 16, ph, spec)
    # the default is the card's
    ph = H.PhaseTimes(t_conv_compute_1=0.3, t_fc=0.01, conv_grad_bytes=4e8)
    assert H.collective_time(4e8, 4) == 2.0 * 4e8 * 3 / 4 / 450e9
    assert H.he_time_per_iteration(4, 16, ph) == H.he_time_per_iteration(
        4, 16, ph, H.H100)


def test_implicit_momentum_equals_jax():
    for g in (1, 2, 4, 8):
        assert I.implicit_momentum(g) == JI.implicit_momentum(g)
        for mu in (0.0, 0.5, 0.9):
            assert I.total_momentum(g, mu) == JI.total_momentum(g, mu)
            assert (I.optimal_explicit_momentum(g, mu)
                    == JI.optimal_explicit_momentum(g, mu))
        kw = dict(g=g, eta=0.3, steps=40, runs=30, seed=g, noise=0.1)
        traj = I.async_quadratic_sim(**kw)
        assert np.array_equal(traj, JI.async_quadratic_sim(**kw))
        assert I.fit_ar2_momentum(traj) == JI.fit_ar2_momentum(traj)
    rng = np.random.default_rng(0)
    w, gr = rng.standard_normal((20, 6)), rng.standard_normal((20, 6))
    for fit_lr in (False, True):
        assert (I.measure_effective_momentum(w, gr, 0.1, fit_lr=fit_lr)
                == JI.measure_effective_momentum(w, gr, 0.1, fit_lr=fit_lr))
    assert (I.measure_momentum_from_updates(w)
            == JI.measure_momentum_from_updates(w))
    with pytest.raises(ValueError, match="too short"):
        I.measure_effective_momentum(w[:3], gr[:3], 0.1)


def test_stat_model_equals_jax():
    for a, b in ((None, 10), (10, None), (10, 0), (0, 0), (0, 10), (30, 10)):
        assert S.penalty_ratio(a, b) == JS.penalty_ratio(a, b)

    def pts(mod, rows):
        return {g: mod.TradeoffPoint(g=g, mu=0.9, eta=0.1, he_time=he,
                                     se_iters=se) for g, he, se in rows}
    for rows in ([(1, 1.0, 0), (4, 0.5, 20)], [(1, 1.0, 100), (2, 0.6, 0)],
                 [(1, 1.0, 100), (8, 0.2, None), (2, 0.7, 130)]):
        assert S.penalties(pts(S, rows)) == JS.penalties(pts(JS, rows))
    for mod in (S, JS):
        with pytest.raises(ValueError):
            mod.penalties(pts(mod, [(2, 0.5, 10)]))
    losses = np.concatenate([np.linspace(2.0, 0.4, 50), np.full(10, 0.4)])
    for target, smooth in ((0.5, 5), (0.5, 1), (0.3, 5)):
        assert (S.iterations_to_loss(losses, target, smooth)
                == JS.iterations_to_loss(losses, target, smooth))
    for g in (1, 4, 32, 64):
        for sh in (2.0, 4.0, 8.0):
            assert (S.predict_se_penalty(g, 0.9, sh)
                    == JS.predict_se_penalty(g, 0.9, sh))
    curves = {1: np.linspace(2.0, 0.2, 80), 2: np.linspace(2.0, 0.3, 80),
              4: np.linspace(2.0, 0.9, 80)}
    assert (S.measured_se_from_replay(curves, 0.5)
            == JS.measured_se_from_replay(curves, 0.5))
    with pytest.raises(ValueError, match="sync baseline"):
        S.measured_se_from_replay({2: curves[2]}, 0.5)
    assert S.TradeoffPoint(1, 0.0, 0.1, 0.5, 40).total_time == 20.0


def test_schedules_equal_jax():
    pairs = [(Sch.constant(0.1), JSch.constant(0.1)),
             (Sch.step_decay(1.0, drop=10, every=100),
              JSch.step_decay(1.0, drop=10, every=100)),
             (Sch.cosine(1.0, total_steps=100), JSch.cosine(1.0,
                                                           total_steps=100)),
             (Sch.warmup_then(Sch.cosine(0.5, total_steps=50), 10),
              JSch.warmup_then(JSch.cosine(0.5, total_steps=50), 10))]
    for a, b in pairs:
        assert [a(s) for s in range(0, 400, 7)] == [b(s) for s in
                                                    range(0, 400, 7)]


# ---------------------------------------------------------------------------
# Algorithm 1 over numpy Runners, and GP-EI
# ---------------------------------------------------------------------------

def _toy_runner(seen):
    """A deterministic Runner: converging losses whose floor depends on
    (g, mu, eta), diverging at the largest eta."""
    def runner(state, *, g, mu, eta, steps, probe):
        seen.append((g, mu, eta, steps, probe))
        if eta >= 0.1:
            return state, np.full(steps, np.inf)
        floor = 0.1 + abs(np.log10(eta) + 2.0) * 0.05 + (mu - 0.6) ** 2 \
            + 0.02 * g
        losses = np.linspace(1.0, floor, steps)
        return (state if probe else state + steps), losses
    return runner


@pytest.mark.parametrize("kw", [
    dict(n_devices=16, epochs=2, epoch_steps=20, probe_steps=5, g0=8),
    dict(n_devices=16, epochs=2, epoch_steps=20, probe_steps=5),
    dict(n_devices=16, epochs=1, epoch_steps=10, probe_steps=5,
         phase_times=True),
    dict(n_devices=8, epochs=1, epoch_steps=10, probe_steps=5, plan=True)])
def test_algorithm1_equals_jax(kw):
    out = []
    for mod, hm, cl in ((A, H, C), (JA, JH, JC)):
        k = dict(kw)
        if k.pop("phase_times", False):
            k["phase_times"] = hm.PhaseTimes(t_conv_compute_1=1.0, t_fc=0.5,
                                             conv_grad_bytes=0.0)
        if k.pop("plan", False):
            k["plan"] = cl.best_allocation(
                cl.parse_cluster_spec("8xgpu-g2.2xlarge"), global_batch=64,
                t_fc=0.002, cost=_cost(cl, **BIG), mp_candidates=(1, 2, 4))
        seen = []
        res = mod.algorithm1(_toy_runner(seen), 0, **k)
        out.append((seen, _d(res)))
    assert out[0] == out[1]
    seen = []
    assert (A.grid_search(_toy_runner(seen), 0, g=4, etas=(0.01, 0.001),
                          mus=A.DEFAULT_MUS, probe_steps=5, mu_cap=0.3,
                          eta_cap_at=0.01)
            == JA.grid_search(_toy_runner([]), 0, g=4, etas=(0.01, 0.001),
                              mus=JA.DEFAULT_MUS, probe_steps=5, mu_cap=0.3,
                              eta_cap_at=0.01))
    assert A.cold_start(_toy_runner([]), 0, probe_steps=5) == JA.cold_start(
        _toy_runner([]), 0, probe_steps=5)
    for mod in (A, JA):
        with pytest.raises(RuntimeError, match="diverged"):
            mod.grid_search(_toy_runner([]), 0, g=2, etas=(0.1,),
                            mus=(0.0,), probe_steps=3)


def test_gp_ei_equals_jax():
    def bowl(eta, mu, g):
        return ((np.log10(eta) + 2) ** 2 + (mu - 0.6) ** 2
                + (np.log2(g) - 2) ** 2)

    def diverging(eta, mu, g):
        if eta > 0.05:
            return float("inf")
        return (mu - 0.3) ** 2 + np.log10(eta) ** 2
    for obj, kw in ((bowl, dict(etas=(0.1, 0.01, 0.001),
                                mus=(0.0, 0.3, 0.6, 0.9), gs=(1, 2, 4, 8),
                                budget=18, seed=0)),
                    (diverging, dict(etas=(0.1, 0.01), mus=(0.0, 0.3),
                                     gs=(1, 2), budget=8, seed=1))):
        got, want = B.gp_ei_minimize(obj, **kw), JB.gp_ei_minimize(obj, **kw)
        assert _d(got) == _d(want)
    assert B.gp_ei_minimize(bowl, etas=(0.1, 0.01, 0.001),
                            mus=(0.0, 0.3, 0.6, 0.9), gs=(1, 2, 4, 8),
                            budget=18, seed=0).best_x == (0.01, 0.6, 4)


# ---------------------------------------------------------------------------
# the report, the artifact gate, telemetry
# ---------------------------------------------------------------------------

STEPS_S = [0.9, 0.11, 0.1, 0.12, 0.105, 0.13, 0.098, 0.14]
WAITS_S = [0.5, 0.01, 0.02, 0.015, 0.01, 0.03, 0.02, 0.01]


def _registry(mod):
    reg = mod()
    for i, (s, w) in enumerate(zip(STEPS_S, WAITS_S)):
        reg.series("step_s").append(s, step=i)
        reg.series("data_wait_s").append(w, step=i)
    reg.counter("checkpoints").inc(2)
    reg.note("stranded devices: example")
    return reg


@pytest.mark.parametrize("g,batch,window,dpg", [(2, 32, None, 1),
                                                (4, 64, 3, 2)])
def test_report_equals_jax(g, batch, window, dpg):
    reg, jreg = _registry(MetricRegistry), _registry(JRegistry)
    plan = R.calibrated_plan(reg, g=g, global_batch=batch, window=window,
                             devices_per_group=dpg)
    jplan = JR.calibrated_plan(jreg, g=g, global_batch=batch, window=window,
                               devices_per_group=dpg)
    assert _d(plan) == _d(jplan)
    rep, jrep = R.hexse_report(reg, plan), JR.hexse_report(jreg, jplan)
    assert _d(rep) == _d(jrep) and rep.render() == jrep.render()
    assert rep.within(0.15) == jrep.within(0.15)
    assert R.summarize(reg, {"arch": "lenet"}) == JR.summarize(
        jreg, {"arch": "lenet"})
    assert _d(R.measured_step_stats(reg)) == _d(JR.measured_step_stats(jreg))
    with pytest.raises(ValueError, match="step_s"):
        R.measured_step_stats(MetricRegistry())
    with pytest.raises(ValueError, match="calibrate"):
        R.calibrated_plan(MetricRegistry(), g=2, global_batch=32)


def test_report_cli_and_validate_gate(tmp_path, capsys):
    from repro_torch.obs import spans, validate as V
    from repro_torch.obs.chrome_trace import export_chrome_trace
    from repro_torch.obs.meta import run_metadata
    reg = _registry(MetricRegistry)
    mpath, tpath = tmp_path / "m.jsonl", tmp_path / "t.json"
    reg.to_jsonl(mpath, run_metadata(device="cpu"))
    assert R.main([str(mpath), "--groups", "2", "--batch", "32"]) == 0
    out = capsys.readouterr().out
    assert "HE x SE decomposition (g=2, 7 steady steps)" in out
    tr = spans.Tracer()
    with tr.span("engine.run"):
        pass
    export_chrome_trace(tpath, tracer=tr, metrics=reg)
    assert V.main(["--metrics", str(mpath), "--trace", str(tpath),
                   "--expect-spans", "engine.run",
                   "--expect-series", "step_s"]) == 0
    assert V.main(["--trace", str(tpath),
                   "--expect-spans", "engine.run,engine.missing"]) == 1
    assert V.main(["--metrics", str(mpath),
                   "--expect-series", "not_there"]) == 1
    bad = tmp_path / "bad.jsonl"
    bad.write_text("{}\n")
    assert V.main(["--metrics", str(bad)]) == 1
    capsys.readouterr()


def test_telemetry_drift_and_calibration_equal_jax():
    tel, jtel = TM.Telemetry(), JTM.Telemetry()
    for s, w in zip(STEPS_S, WAITS_S):
        tel.record(step_s=s, data_s=w)
        jtel.record(step_s=s, data_s=w)
    for window in (1, 3, 7):
        assert tel.drift(window) == jtel.drift(window)
    with pytest.raises(ValueError):
        tel.drift(0)
    spec = C.spec_from_telemetry(C.get_device("gpu-h100-sxm"), tel,
                                 batch_size=256, window=3)
    jspec = JC.spec_from_telemetry(JC.get_device("tpu-v5e"), jtel,
                                   batch_size=256, window=3)
    assert spec.throughput == jspec.throughput == 256 / tel.median_step_s(3)


def test_profile_device_synchronizes_nothing_on_the_cpu_and_stamps_spans():
    import torch
    from repro_torch.obs import spans
    tr = spans.Tracer()
    calls = []
    x = torch.ones(8)
    with spans.install(tr):
        thr = C.profile_device(lambda a: calls.append(a * 2.0), (x,),
                               batch_size=8, warmup=1, iters=3,
                               device="cpu")
    assert thr > 0 and len(calls) == 4
    rec = {r.name: r for r in tr.records()}["cluster.profile_device"]
    assert rec.attrs["examples_per_s"] == thr
    assert rec.attrs["torch"] == torch.__version__
    spec = C.profiled_spec(C.DeviceSpec("probe", "cpu", 1e12, 1e11, 1e9),
                           lambda: None, (), batch_size=4, iters=2,
                           device="cpu")
    assert spec.throughput > 0 and spec.predict_throughput() == \
        spec.throughput
    with pytest.raises(ValueError):
        C.profile_device(lambda: None, (), batch_size=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            C.profile_device(lambda: None, (), batch_size=1)
    assert math.isfinite(thr)
