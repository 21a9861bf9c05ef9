"""Port parity: the optimizer path that runs tensors — delayed SGD, the
planner's shares in the engine, the Algorithm-1 Runner and the launcher's
``--plan`` — against the JAX package on the CPU.

- The workloads' losses and gradients (quadratic, MLP, the small CNN, the
  LSTM) on the same numpy params and batches within 1e-5 relative.
- ``delayed_sgd_run`` for the quadratic and MLP workloads at S in
  {0, 1, 3}, 30 steps, mu 0.6, lr 0.05: losses and final parameters
  within 1e-5 relative of the JAX run (fp32; the frameworks reduce in
  other orders).
- ``Engine`` with ``group_weights`` and ``micro_sizes`` against the JAX
  ``Engine(exec_mode="vmap")`` (never "auto": the test session forces 8
  host devices, so "auto" would go SPMD): smoke lenet and cifarnet at
  g in {2, 4}, equal and unequal shares of a batch of 16, 3 rounds,
  losses and final params within 1e-4.
- The Runner: ``algorithm1(make_runner(wl, strategy=s), ...)`` on both
  sides for ``quadratic`` (``delayed``) and the small CNN
  (``grouped-fused``), both engines fed the same numpy batches in call
  order from the same JAX-initialised params: identical ``Decision``
  lists (phase, g, mu, eta) and losses within 1e-4.
- The launcher: ``--arch lenet --smoke --cluster-spec
  2xgpu-g2.2xlarge,2xcpu-c4.4xlarge --plan`` prints the JAX launcher's
  plan (g, mp, shares, microbatches) and, from the JAX init's params,
  its losses within 1e-4.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import async_sgd as JS
from repro.core import auto_optimizer as JA
from repro.core import workload as JW
from repro.data import pipeline as JP
from repro.engine import Engine as JEngine
from repro.models import cnn as JC
from repro.optim.sgd import init_momentum as j_init_momentum
from repro_torch.core import auto_optimizer as A
from repro_torch.core import tree as T
from repro_torch.core import workload as W
from repro_torch.core.async_sgd import (delayed_sgd_run,
                                        make_grouped_train_step,
                                        value_and_grad)
from repro_torch.core.compute_groups import group_batch_split
from repro_torch.data import pipeline as P
from repro_torch.engine import Engine
from repro_torch.models import cnn as C
from repro_torch.models.convert import params_from_jax, state_from_jax
from repro_torch.optim.sgd import init_momentum

TOL = 1e-4
DELAYED_RTOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _t(tree):
    return T.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _workloads(name):
    """(JAX workload, port workload) of one name, the CNN on the CPU's
    conv arm."""
    if name == "cnn":
        return JW.cnn_classify(), W.cnn_classify(conv_impl="lowering")
    ctor = {"quadratic": "quadratic", "mlp": "mlp_classify",
            "lstm": "rnn_classify"}[name]
    return getattr(JW, ctor)(), getattr(W, ctor)()


def _rel_close(got, want, rtol, what):
    """Every element within ``rtol`` of the largest magnitude of ``want``
    (a relative error that stays defined at elements near zero)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (what, err,
                                              np.abs(want).max())


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["quadratic", "mlp", "cnn", "lstm"])
def test_workload_loss_and_grads_equal_jax(name):
    jwl, wl = _workloads(name)
    jparams = jwl.init(jax.random.PRNGKey(0))
    jb = jax.tree.map(lambda x: x[0], jwl.sample_batches(
        jax.random.PRNGKey(1), 2, jwl.batch_size))
    jl, jg = jax.value_and_grad(jwl.loss_fn)(jparams, jb)
    loss, grads = value_and_grad(wl.loss_fn, params_from_jax(_np(jparams)),
                                 _t(_np(jb)))
    _rel_close(float(loss), float(jl), DELAYED_RTOL, f"{name} loss")
    for a, b in zip(grads, jax.tree.leaves(jg)):
        _rel_close(a.numpy(), b, DELAYED_RTOL, f"{name} grad")
    # the port's own draws: shapes and dtypes of the JAX ones, on the
    # generator's device, the same numbers for the same seed
    gen = torch.Generator().manual_seed(3)
    mine = wl.sample_batches(gen, 2, wl.batch_size)
    again = wl.sample_batches(torch.Generator().manual_seed(3), 2,
                              wl.batch_size)
    jfull = jwl.sample_batches(jax.random.PRNGKey(1), 2, jwl.batch_size)
    for k in jfull:
        assert tuple(mine[k].shape) == tuple(jfull[k].shape)
        assert str(mine[k].dtype).split(".")[-1] == str(jfull[k].dtype)
        assert torch.equal(mine[k], again[k])
    p = wl.init(torch.Generator().manual_seed(0))
    assert [tuple(x.shape) for x in T.leaves(p)] == [
        tuple(x.shape) for x in jax.tree.leaves(jparams)]
    assert np.isfinite(float(wl.loss_fn(p, T.tree_map(lambda x: x[0],
                                                      mine))))


# ---------------------------------------------------------------------------
# delayed SGD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [0, 1, 3])
@pytest.mark.parametrize("name", ["quadratic", "mlp"])
def test_delayed_sgd_run_matches_jax(name, S):
    jwl, wl = _workloads(name)
    jparams = jwl.init(jax.random.PRNGKey(0))
    jb = jwl.sample_batches(jax.random.PRNGKey(1), 30, jwl.batch_size)
    kw = dict(staleness=S, lr=0.05, momentum=0.6, weight_decay=0.01)
    jfinal, jlosses, jtrace = JS.delayed_sgd_run(
        jwl.loss_fn, jparams, jb, record_params=True, **kw)
    params = params_from_jax(_np(jparams))
    before = [x.clone() for x in T.leaves(params)]
    final, losses, trace = delayed_sgd_run(wl.loss_fn, params, _t(_np(jb)),
                                           record_params=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(params), before))
    assert losses.shape == (30,)
    _rel_close(losses.numpy(), jlosses, DELAYED_RTOL, "losses")
    for a, b in zip(T.leaves(final), jax.tree.leaves(jfinal)):
        _rel_close(a.numpy(), b, DELAYED_RTOL, "final params")
    for a, b in zip(T.leaves(trace), jax.tree.leaves(jtrace)):
        _rel_close(a.numpy(), b, DELAYED_RTOL, "params trace")
    with pytest.raises(ValueError, match="staleness"):
        delayed_sgd_run(wl.loss_fn, params, _t(_np(jb)), staleness=-1,
                        lr=0.1)


# ---------------------------------------------------------------------------
# the planner's shares in the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,sizes", [(2, (8, 8)), (2, (11, 5)),
                                     (4, (4, 4, 4, 4)), (4, (6, 4, 3, 3))])
@pytest.mark.parametrize("arch", ["lenet", "cifarnet"])
def test_weighted_sized_engine_matches_jax_vmap_engine(arch, g, sizes):
    steps, batch = 3, sum(sizes)
    weights = tuple(s / batch for s in sizes)
    jcfg = JC.get_cnn_smoke_config(arch)
    cfg = dataclasses.replace(C.get_cnn_smoke_config(arch),
                              conv_impl="lowering")
    jparams = JC.init_params(jax.random.PRNGKey(0), jcfg)
    data = dict(batch_size=batch, image_size=jcfg.image_size,
                channels=jcfg.in_channels, num_classes=jcfg.num_classes,
                seed=0)
    kw = dict(num_groups=g, lr=0.05, momentum=0.3, group_weights=weights,
              micro_sizes=sizes)
    jeng = JEngine(lambda p, b: JC.loss_fn(p, b, jcfg), exec_mode="vmap",
                   head_filter=JC.head_filter, **kw)
    jp, _, jlosses = jeng.run(jparams, j_init_momentum(jparams),
                              JP.SyntheticImages(JP.DataConfig(**data))
                              .batches(steps), steps=steps)
    eng = Engine(lambda p, b: C.loss_fn(p, b, cfg), device="cpu",
                 update_impl="torch", head_filter=C.head_filter, **kw)
    params = params_from_jax(_np(jparams))
    pp, _, losses = eng.run(params, init_momentum(params),
                            P.SyntheticImages(P.DataConfig(**data))
                            .batches(steps), steps=steps)
    assert eng._built_step(max(sizes)).sizes == sizes
    np.testing.assert_allclose(losses, jlosses, rtol=TOL, atol=TOL)
    for a, b in zip(T.leaves(pp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


def test_weights_and_sizes_apply_only_at_their_g():
    eng = Engine(lambda p, b: 0.0, device="cpu", update_impl="torch",
                 group_weights=(0.75, 0.25), micro_sizes=(12, 4))
    assert eng._weights_for(2) == (0.75, 0.25) and eng._weights_for(4) is None
    assert eng._sizes_for(2) == (12, 4) and eng._sizes_for(1) is None
    assert eng._per_group_batch(2, 16) == 12
    assert eng._per_group_batch(4, 16) == 4
    with pytest.raises(ValueError, match="not divisible"):
        eng._per_group_batch(3, 16)


@pytest.mark.parametrize("strategy", ["fused", "scan"])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_uniform_weights_are_bitwise_the_equal_share_step(g, strategy):
    wl = W.mlp_classify()
    params = wl.init(torch.Generator().manual_seed(0))
    mom = init_momentum(params)
    batches = wl.sample_batches(torch.Generator().manual_seed(1), 3, 32)
    base = make_grouped_train_step(wl.loss_fn, num_groups=g, lr=0.05,
                                   momentum=0.9, strategy=strategy)
    weighted = make_grouped_train_step(wl.loss_fn, num_groups=g, lr=0.05,
                                       momentum=0.9, strategy=strategy,
                                       group_weights=(1.0 / g,) * g)
    p1 = p2 = params
    m1 = m2 = mom
    for t in range(3):
        gb = group_batch_split(T.tree_map(lambda x: x[t], batches), g)
        p1, m1, _ = base(p1, m1, gb)
        p2, m2, _ = weighted(p2, m2, gb)
    for a, b in zip(T.leaves(p1) + T.leaves(m1), T.leaves(p2) + T.leaves(m2)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the Runner
# ---------------------------------------------------------------------------

def _call_order_sampler(jwl, calls):
    """A sampler returning, at its i-th call, the JAX workload's draw under
    ``PRNGKey(1000 + i)`` as numpy (the same on both sides)."""
    def sample(_key, steps, batch_size):
        i = calls[0]
        calls[0] += 1
        return _np(jwl.sample_batches(jax.random.PRNGKey(1000 + i), steps,
                                      batch_size))
    return sample


@pytest.mark.parametrize("name,strategy,kw", [
    ("quadratic", "delayed", dict(n_devices=8, epochs=2, epoch_steps=12,
                                  probe_steps=6, g0=4)),
    ("cnn", "grouped-fused", dict(n_devices=2, epochs=1, epoch_steps=4,
                                  probe_steps=3, g0=2))])
def test_algorithm1_over_the_runner_matches_jax(name, strategy, kw):
    jwl, wl = _workloads(name)
    jcalls, calls = [0], [0]
    jwl = dataclasses.replace(jwl, sample_batches=_call_order_sampler(
        jwl, jcalls))
    wl = dataclasses.replace(wl, sample_batches=_call_order_sampler(
        _workloads(name)[0], calls))
    jrunner = JW.make_runner(jwl, strategy=strategy)
    jrunner.exec_mode = "vmap"          # not SPMD over the 8 host devices
    jstate = JW.init_state(jwl, seed=0)
    want = JA.algorithm1(jrunner, jstate, **kw)
    runner = W.make_runner(wl, strategy=strategy, device="cpu",
                           update_impl="torch")
    got = A.algorithm1(runner, state_from_jax(_np(jstate)), **kw)
    assert calls[0] == jcalls[0] > 5
    assert ([(d.phase, d.g, d.mu, d.eta) for d in got.decisions]
            == [(d.phase, d.g, d.mu, d.eta) for d in want.decisions])
    np.testing.assert_allclose([d.loss for d in got.decisions],
                               [d.loss for d in want.decisions], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.losses, want.losses, rtol=TOL, atol=TOL)
    assert (got.g, got.mu, got.eta, got.mp) == (want.g, want.mu, want.eta,
                                                want.mp)
    params, t = got.state
    assert t == want.state[1]
    for a, b in zip(T.leaves(params), jax.tree.leaves(want.state[0])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


def test_runner_probes_restart_and_never_move_the_stream():
    wl = W.mlp_classify()
    runner = W.make_runner(wl, strategy="grouped-scan", seed=7,
                           device="cpu", update_impl="torch")
    state = W.init_state(wl, seed=0, device="cpu")
    s1, l1 = runner(state, g=2, mu=0.3, eta=0.05, steps=5, probe=True)
    s2, l2 = runner(state, g=2, mu=0.3, eta=0.05, steps=5, probe=True)
    assert s1 is state and s2 is state and np.array_equal(l1, l2)
    assert l1.shape == (5,) and l1.dtype == np.float32
    (p3, t3), l3 = runner(state, g=2, mu=0.3, eta=0.05, steps=5,
                          probe=False)
    assert t3 == 5 and not np.array_equal(l3, l1)    # its own stream
    _, l4 = runner((p3, t3), g=2, mu=0.3, eta=0.05, steps=5, probe=True)
    assert not np.array_equal(l4, l1)
    # one built step per (strategy, g, lr, mu, per-group batch), reused
    n = len(runner._steps)
    runner(state, g=2, mu=0.3, eta=0.05, steps=2, probe=True)
    runner(state, g=1, mu=0.3, eta=0.05, steps=2, probe=True)
    assert len(runner._steps) == n + 1
    # the caller's params are never changed
    assert all(torch.equal(a, b) for a, b in zip(
        T.leaves(state[0]), T.leaves(W.init_state(wl, 0, "cpu")[0])))


def test_runner_and_delayed_refusals():
    wl = W.quadratic()
    eng = Engine(wl.loss_fn, strategy="delayed", device="cpu",
                 update_impl="torch")
    state = W.init_state(wl, seed=0, device="cpu")
    with pytest.raises(ValueError, match="sample_batches"):
        eng(state, g=2, mu=0.0, eta=0.1, steps=2, probe=True)
    with pytest.raises(ValueError, match="no per-round step"):
        eng.run(state[0], init_momentum(state[0]),
                [{"xi": np.zeros((1, 32), np.float32)}], steps=1)
    sync = W.make_runner(wl, strategy="sync", device="cpu",
                         update_impl="torch")
    with pytest.raises(ValueError, match="pinned to g=1"):
        sync(state, g=2, mu=0.0, eta=0.1, steps=2, probe=True)
    _, losses = sync(state, g=1, mu=0.0, eta=0.1, steps=3, probe=True)
    assert losses.shape == (3,) and np.isfinite(losses).all()


# ---------------------------------------------------------------------------
# the engine's black-box probe
# ---------------------------------------------------------------------------

def test_engine_profile_and_profiled_spec_on_cpu():
    from repro_torch import cluster
    cfg = dataclasses.replace(C.get_cnn_smoke_config("lenet"),
                              conv_impl="lowering")
    eng = Engine(lambda p, b: C.loss_fn(p, b, cfg), num_groups=2,
                 group_weights=(0.75, 0.25), micro_sizes=(12, 4),
                 head_filter=C.head_filter, device="cpu",
                 update_impl="torch")
    params = C.init_params(torch.Generator().manual_seed(0), cfg)
    mom = init_momentum(params)
    batch = next(P.SyntheticImages(P.DataConfig(
        batch_size=16, image_size=cfg.image_size, num_classes=4,
        channels=1)).batches(1))
    thr = eng.profile(params, mom, batch, warmup=1, iters=2)
    assert thr > 0
    spec = eng.profiled_spec(cluster.get_device("gpu-h100-sxm"), params,
                             mom, batch, iters=2)
    assert spec.throughput > 0 and spec.name == "gpu-h100-sxm"


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

ARGV = ["--arch", "lenet", "--smoke", "--steps", "3", "--batch", "16",
        "--lr", "0.05", "--momentum", "0.3",
        "--cluster-spec", "2xgpu-g2.2xlarge,2xcpu-c4.4xlarge", "--plan"]
PORT_ONLY = ["--device", "cpu", "--conv-impl", "lowering",
             "--update-impl", "torch"]


def _plan_lines(out):
    lines = out.splitlines()
    i = next(i for i, x in enumerate(lines) if x.startswith("plan g="))
    return [lines[i]] + [x for x in lines[i + 1:] if x.startswith(
        "  group ")]


def test_launcher_plan_matches_the_jax_launcher(monkeypatch, capsys):
    from repro.launch import train as JTR
    from repro_torch.launch import train as TR
    init = JC.init_params
    monkeypatch.setattr(C, "init_params", lambda gen, cfg: params_from_jax(
        _np(init(jax.random.PRNGKey(0), JC.get_cnn_smoke_config("lenet")))))
    want = JTR.main(ARGV + ["--exec-mode", "vmap"])
    jout = capsys.readouterr().out
    got = TR.main(ARGV + PORT_ONLY)
    out = capsys.readouterr().out
    assert _plan_lines(out) == _plan_lines(jout)
    assert _plan_lines(out)[0].startswith("plan g=4 mp=1 ")
    assert "(planned)" in out and "g=4 S=3" in out
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_launcher_plan_needs_a_cluster_spec():
    from repro_torch.launch import train as TR
    with pytest.raises(SystemExit):
        TR.main(["--arch", "lenet", "--smoke", "--plan"] + PORT_ONLY)


def test_full_caffenet_plan_equals_the_jax_launchers():
    """The plan the card's smoke test trains under: full-width CaffeNet
    at batch 256 over the paper's g2/c4 nodes, planned from the parameter
    shapes alone (no values drawn) by both launchers."""
    import argparse
    from repro.launch import train as JTR
    from repro_torch.launch import train as TR
    shapes = jax.eval_shape(lambda: JC.init_params(jax.random.PRNGKey(0),
                                                   JC.CAFFENET))
    meta = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                        shapes)
    ns = argparse.Namespace(cluster_spec="2xgpu-g2.2xlarge,2xcpu-c4.4xlarge",
                            seq=64, batch=256)
    lines = []
    plan = TR._plan(ns, meta, C.CAFFENET, say=lines.append)
    want = JTR._plan(ns, shapes, JC.CAFFENET)
    assert lines == [want.describe()] == [plan.describe()]
    assert (plan.g, plan.mp, plan.allocation.microbatches, plan.weights) == (
        want.g, want.mp, want.allocation.microbatches, want.weights)
    assert plan.allocation.microbatches == (93, 93, 35, 35)
