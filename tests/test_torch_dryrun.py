"""The port's dry-run on meta tensors (``repro_torch.launch.dryrun``)
against the JAX package on the same shapes.

- ``steps.batch_specs`` / ``cache_specs_struct`` give the JAX functions'
  shapes and dtypes leaf for leaf, for every arch x ``INPUT_SHAPES``
  entry ``supports_shape`` allows (train shapes with the arch's
  ``GRAD_ACCUM`` microbatch axis too).
- ``python -m repro_torch.launch.dryrun --host-smoke`` exits 0 and writes
  one JSON file per ``HOST_SMOKE_ARCHS`` config, status "ok", some leaves
  sharded over mp, a non-empty exchange; its param counts and bytes, the
  mp-sharded leaf count and the per-rank argument bytes at (1, 4, 2)
  equal what the JAX ``params_specs`` + ``rules.engine_param_specs`` give
  (the port engine's divisor: mp, not data·mp).
- ``Roofline`` / ``analytic_hbm_bytes`` / ``model_flops_6nd`` equal the
  JAX ``hlo_analysis`` ones when fed the JAX v5e figures.
- ``engine.spmd.exchange_bytes`` equals the bytes and the count of the
  ``dist.all_gather`` calls one ``SpmdStep`` round makes under gloo, at
  (g, k, mp) = (2, 1, 1), (1, 2, 1) and (1, 2, 2), bucketed, one leaf a
  bucket and ``bucket_bytes = 0`` (``test_torch_spmd_mesh``'s harness).
- Mutation: with ``engine_param_specs`` replicating every leaf,
  ``host_smoke_one`` raises and the CLI exits 1.
- The counterpart of ``test_dryrun_small.py::
  test_algorithm1_plan_accepted_by_dryrun``: the port's planner and
  Algorithm 1 pick mp = 2 for a 405B-class state, and ``host_smoke_one``
  accepts llama3-405b on the planned layout, every check at full size
  (the step count included: ~11 s on the CPU).

The step FLOPs against the JAX HLO walk are in
``test_torch_dryrun_flops.py``.
"""
import json
import math

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
from repro.launch import hlo_analysis as JH
from repro.launch import steps as JS
from repro.sharding import rules as JR
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.core import tree as T
from repro_torch.launch import dryrun as DR
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps as S
from repro_torch.sharding import rules as SH

from test_torch_spmd_mesh import case, exchange_case, spawn

V5E = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)


def jax_tree(t) -> dict:
    return {tuple(str(k.key) for k in path):
            (tuple(x.shape), str(np.dtype(x.dtype)))
            for path, x in jax.tree_util.tree_flatten_with_path(t)[0]}


def torch_tree(t) -> dict:
    return {tuple(str(k) for k in path):
            (tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for path, x in T.leaves_with_path(t)}


@pytest.mark.parametrize("arch", list_archs())
def test_batch_and_cache_specs_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    checked = 0
    for name, shape in INPUT_SHAPES.items():
        jshape = JAX_SHAPES[name]
        assert S.supports_shape(cfg, shape) == JS.supports_shape(jcfg, jshape)
        if not S.supports_shape(cfg, shape):
            continue
        accums = (1, DR.GRAD_ACCUM[arch]) if shape.kind == "train" else (1,)
        for a in accums:
            got = S.batch_specs(cfg, shape, grad_accum=a)
            assert all(x.device.type == "meta" for x in T.leaves(got))
            assert torch_tree(got) == jax_tree(
                JS.batch_specs(jcfg, jshape, grad_accum=a)), (name, a)
        if shape.kind == "decode":
            got = S.cache_specs_struct(cfg, shape)
            assert all(x.device.type == "meta" for x in T.leaves(got))
            assert torch_tree(got) == jax_tree(
                JS.cache_specs_struct(jcfg, jshape)), name
        checked += 1
    assert checked == (3 if cfg.arch_type == "encdec" else 4)


# ---------------------------------------------------------------------------
# the host-smoke lane, run once through the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_smoke(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    DR.main(["--host-smoke", "--out", str(out)])
    return {p.name: json.loads(p.read_text()) for p in out.glob("*.json")}


def test_host_smoke_cli_writes_one_ok_result_per_arch(host_smoke):
    assert sorted(host_smoke) == sorted(
        f"{a}__hostsmoke__1x4x2.json" for a in DR.HOST_SMOKE_ARCHS)
    for res in host_smoke.values():
        assert res["status"] == "ok", res
        assert res["device"] == "meta"
        assert res["mp_sharded_param_leaves"] > 0
        assert res["collectives"]["received"] > 0
        assert res["collectives"]["gathers"] > 0
        assert math.isfinite(res["flops"]) and res["flops"] > 0
        m = res["memory"]
        assert m["argument_bytes"] <= m["argument_bound_bytes"]


@pytest.mark.parametrize("arch", DR.HOST_SMOKE_ARCHS)
def test_host_smoke_state_matches_jax_engine_specs(host_smoke, arch):
    """Counts, bytes, the mp-sharded leaves and the per-rank argument bytes
    (param and momentum shards plus the rank's batch) from the JAX
    ``params_specs`` and ``engine_param_specs`` on a (1, 4, 2) mesh."""
    res = host_smoke[f"{arch}__hostsmoke__1x4x2.json"]
    jcfg = jax_config(arch)
    jp = JS.params_specs(jcfg)
    mesh = jax.make_mesh((1, 4, 2), ("group", "data", "mp"))
    specs = jax.tree.leaves(JR.engine_param_specs(jp, mesh),
                            is_leaf=lambda x: isinstance(
                                x, jax.sharding.PartitionSpec))
    leaves = jax.tree.leaves(jp)
    assert len(specs) == len(leaves) == res["param_leaves"]
    mom = np.dtype(jcfg.dtype("mom")).itemsize
    sharded, arg = 0, 0
    for x, spec in zip(leaves, specs):
        split = 2 if "mp" in tuple(spec) else 1
        sharded += split > 1
        arg += math.prod(x.shape) // split * (np.dtype(x.dtype).itemsize
                                              + mom)
    arg += 2 * (8 // 4) * 128 * 4          # the rank's tokens and labels
    n = sum(math.prod(x.shape) for x in leaves)
    pbytes = sum(math.prod(x.shape) * np.dtype(x.dtype).itemsize
                 for x in leaves)
    assert res["params_total"] == n
    assert res["state_bytes_global"] == pbytes + n * mom
    assert res["mp_sharded_param_leaves"] == sharded > 0
    assert res["memory"]["argument_bytes"] == arg
    assert res["memory"]["argument_bound_bytes"] == pytest.approx(
        (pbytes + n * mom) / 2 * 1.3 + 2.0**30)


def test_host_smoke_fails_when_every_leaf_is_replicated(monkeypatch,
                                                         tmp_path):
    def replicated(params, mesh, **kw):
        return T.tree_map(lambda x: (None,) * len(x.shape), params)

    monkeypatch.setattr(SH, "engine_param_specs", replicated)
    with pytest.raises(AssertionError, match="no param leaf is sharded"):
        DR.host_smoke_one("mamba2-2.7b", verbose=False)
    with pytest.raises(SystemExit) as exc:
        DR.main(["--host-smoke", "--out", str(tmp_path)])
    assert exc.value.code == 1
    for p in tmp_path.glob("*.json"):
        assert json.loads(p.read_text())["status"] == "FAILED"
    assert len(list(tmp_path.glob("*.json"))) == len(DR.HOST_SMOKE_ARCHS)


def test_algorithm1_plan_accepted_by_host_smoke():
    """A 405B-class state does not fit one 4 GB device: the 2-D search of
    the port's planner returns mp > 1, Algorithm 1 keeps it, and the
    host-smoke lane accepts llama3-405b on the planned (g, data, mp)
    layout of 8 ranks, at full size."""
    from repro_torch import cluster
    from repro_torch.core.auto_optimizer import algorithm1
    devs = cluster.parse_cluster_spec("8xgpu-g2.2xlarge")
    cost = cluster.WorkloadCost(flops_per_example=2e9,
                                bytes_per_example=2e8, grad_bytes=4e6,
                                state_bytes=6e9)
    plan = cluster.best_allocation(devs, global_batch=64, t_fc=0.002,
                                   cost=cost, g_candidates=(1, 2),
                                   mp_candidates=(1, 2))

    def runner(state, *, g, mu, eta, steps, probe):
        return state, np.linspace(1.0, 0.1 - 0.05 * mu, steps)

    res = algorithm1(runner, None, n_devices=8, epochs=1, epoch_steps=10,
                     probe_steps=5, plan=plan)
    assert (res.g, res.mp) == (plan.g, plan.mp)
    assert res.mp == 2
    out = DR.host_smoke_one("llama3-405b", groups=res.g,
                            data=8 // (res.g * res.mp), mp=res.mp,
                            verbose=False)
    assert out["status"] == "ok"
    assert out["chips"] == 8
    assert out["mp_sharded_param_leaves"] > 0


# ---------------------------------------------------------------------------
# the roofline arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(INPUT_SHAPES))
def test_roofline_and_traffic_model_match_jax(name):
    for arch in ("qwen2-7b", "whisper-base", "mamba2-2.7b"):
        cfg, jcfg = get_config(arch), jax_config(arch)
        kw = dict(grad_accum=8, params_bytes_global=3.5e10,
                  cache_bytes_global=7.0e9)
        got = RL.analytic_hbm_bytes(cfg, INPUT_SHAPES[name], 8, **kw)
        assert got == JH.analytic_hbm_bytes(jcfg, JAX_SHAPES[name], 8, **kw)
        want = JH.Roofline(flops=3.3e15, hbm_bytes=got,
                           collective_bytes=2.1e10, chips=8)
        mine = RL.Roofline(flops=3.3e15, hbm_bytes=got,
                           collective_bytes=2.1e10, chips=8, **V5E)
        assert mine.as_dict() == want.as_dict()
    assert RL.model_flops_6nd(7.6e9, 1 << 20) == \
        JH.model_flops_6nd(7.6e9, 1 << 20)


def test_roofline_defaults_are_the_h100_data_sheet():
    r = RL.Roofline(flops=989e12, hbm_bytes=3.35e12 / 2,
                    collective_bytes=450e9 / 4, chips=1)
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 0.5, 0.25)
    assert r.bottleneck == "compute" and r.step_time == 1.0


# ---------------------------------------------------------------------------
# the exchange, against the gathers SpmdStep makes under gloo
# ---------------------------------------------------------------------------

EX_CASES = {2: [case("caffenet", 2, 1, 1), case("caffenet", 2, 1, 1,
                                                 bucket_bytes=0),
                case("caffenet", 1, 2, 1), case("caffenet", 1, 2, 1,
                                                 bucket_bytes=1),
                case("caffenet", 1, 2, 1, bucket_bytes=0)],
            4: [case("caffenet", 1, 2, 2), case("caffenet", 1, 2, 2,
                                                 bucket_bytes=0)]}


@pytest.fixture(scope="module")
def exchanged(tmp_path_factory):
    return {w: spawn(tmp_path_factory.mktemp(f"exchange{w}"), w, cs,
                     run=exchange_case) for w, cs in EX_CASES.items()}


@pytest.mark.parametrize("world,c", [(w, c) for w, cs in EX_CASES.items()
                                     for c in cs],
                         ids=[c["name"] for cs in EX_CASES.values()
                              for c in cs])
def test_exchange_bytes_equal_spmd_gathers(exchanged, world, c):
    for rank, res in enumerate(exchanged[world]):
        got = res[c["name"]]
        seen = sum((s - 1) * n for n, s in got["seen"])
        want = got["reckoned"]
        assert want["gathers"] == len(got["seen"]), rank
        assert want["received"] == want["sent"] == seen > 0, rank
        assert sum(want["by_axis"].values()) == seen
        if c["mp"] == 1:
            assert want["by_axis"]["mp"] == 0
