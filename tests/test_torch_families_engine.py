"""Port parity: the MoE, SSM and hybrid families through the engine, across
ranks and through the launchers (the smoke configs of
qwen2-moe-a2.7b, mamba2-2.7b and recurrentgemma-2b, the hybrid at 5
layers so that it has remainder layers; the ``SyntheticLM`` stream).

- ``Engine.run`` (batch 8, seq 32, 2 rounds, mu 0.3, lr 0.05) at g = 1
  ``sync`` and g = 4 ``grouped-fused`` against the JAX
  ``Engine(exec_mode="vmap")`` from the same JAX-initialised params, fp32:
  per-round losses and final params within 1e-4.
- ``exec_mode="spmd"`` over two gloo ranks, bf16 compute and remat as the
  configs have them: MoE at (g, k, mp) = (1, 1, 2) (the stacked expert
  leaves (L, E, D, F) sliced over mp) and the hybrid at (2, 1, 1) (the
  two-level ``super.rec`` stacks): every rank's params, momentum, losses
  and per-shard losses bitwise its ``"reference"`` twin, with one update
  launch per gradient bucket.
- The launchers on the CPU: ``launch/train.py --smoke --device cpu`` trains
  each family (finite losses, a step line a round) and
  ``launch/serve.py --smoke --device cpu`` serves each (tokens in the
  vocabulary); continuous serving of an SSM arch raises as in JAX.

The rank workers here import nothing of JAX: spawned ranks import this
module, and the JAX package is imported inside the tests that use it.
"""
import dataclasses
import functools
import os
import pickle

import numpy as np
import pytest
import torch

STEPS, BATCH, SEQ, LR, MU = 2, 8, 32, 0.05, 0.3
TOL = 1e-4
ARCHS = {"moe": "qwen2-moe-a2.7b", "ssm": "mamba2-2.7b",
         "hybrid": "recurrentgemma-2b"}
LAYERS = {"moe": 2, "ssm": 2, "hybrid": 5}


def _tcfg(fam, compute="float32"):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(ARCHS[fam]),
                               num_layers=LAYERS[fam], compute_dtype=compute)


def _stream(cfg, seed=0):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    return SyntheticLM(DataConfig(batch_size=BATCH, seq_len=SEQ,
                                  vocab_size=cfg.vocab_size,
                                  seed=seed)).batches(STEPS)


def _engine(cfg, g, strategy, exec_mode, **kw):
    from repro_torch.engine import Engine
    from repro_torch.models import transformer as M
    return Engine(lambda p, b: M.lm_loss(p, b, cfg), strategy=strategy,
                  num_groups=g, lr=LR, momentum=MU, update_impl="torch",
                  exec_mode=exec_mode, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _jax_params(fam):
    import jax
    from repro.configs import get_smoke_config
    from repro.models import transformer as JT
    cfg = dataclasses.replace(get_smoke_config(ARCHS[fam]),
                              num_layers=LAYERS[fam])
    return jax.device_get(JT.init_params(jax.random.PRNGKey(0), cfg))


def _jax_run(fam, g, strategy):
    """Final params (numpy leaves) and losses of the JAX vmap engine."""
    import jax
    from repro.configs import get_smoke_config
    from repro.data import pipeline as JP
    from repro.engine import Engine as JEngine
    from repro.models import transformer as JT
    from repro.optim.sgd import init_momentum
    jcfg = dataclasses.replace(get_smoke_config(ARCHS[fam]),
                               num_layers=LAYERS[fam],
                               compute_dtype="float32")
    params = _jax_params(fam)
    eng = JEngine(lambda p, b: JT.lm_loss(p, b, jcfg), exec_mode="vmap",
                  strategy=strategy, num_groups=g, lr=LR, momentum=MU)
    data = JP.SyntheticLM(JP.DataConfig(batch_size=BATCH, seq_len=SEQ,
                                        vocab_size=jcfg.vocab_size,
                                        seed=0)).batches(STEPS)
    jp, _, losses = eng.run(params, init_momentum(params), data, steps=STEPS)
    return [np.asarray(x) for x in jax.tree.leaves(jp)], losses


@pytest.mark.parametrize("fam", ARCHS)
@pytest.mark.parametrize("g,strategy", [(1, "sync"), (4, "grouped-fused")])
def test_engine_run_matches_jax_vmap(fam, g, strategy):
    from repro_torch.core import tree as T
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.sgd import init_momentum
    cfg = _tcfg(fam)
    params = params_from_jax(_jax_params(fam))
    pp, _, losses = _engine(cfg, g, strategy, "vmap").run(
        params, init_momentum(params), _stream(cfg), steps=STEPS)
    want_p, want_l = _jax_run(fam, g, strategy)
    np.testing.assert_allclose(losses, want_l, rtol=TOL, atol=TOL)
    assert len(T.leaves(pp)) == len(want_p)
    for a, b in zip(T.leaves(pp), want_p):
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the SPMD engine over two gloo ranks
# ---------------------------------------------------------------------------

SPMD_CASES = [dict(name="moe-g1k1mp2-sync", fam="moe", g=1, k=1, mp=2,
                   strategy="sync"),
              dict(name="hybrid-g2k1mp1-grouped-fused", fam="hybrid", g=2,
                   k=1, mp=1, strategy="grouped-fused")]


def _spmd_case(c, world):
    """One case on this rank: spmd, then the reference; what differs."""
    from repro_torch.core import tree as T
    from repro_torch.engine import spmd as S
    from repro_torch.models import transformer as M
    from repro_torch.configs import get_smoke_config
    cfg = dataclasses.replace(get_smoke_config(ARCHS[c["fam"]]),
                              num_layers=LAYERS[c["fam"]])
    gen = torch.Generator().manual_seed(0)
    params = M.init_params(gen, cfg)
    mom = T.tree_map(lambda t: torch.randn(t.shape, generator=gen) * 1e-3,
                     params)
    eng = _engine(cfg, c["g"], c["strategy"], "spmd", mp=c["mp"])
    calls = []
    real = S.fused_bucket_update

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    S.fused_bucket_update = counted
    try:
        p, v, losses = eng.run(params, mom, _stream(cfg), steps=STEPS)
    finally:
        S.fused_bucket_update = real
    built = eng._built_step(BATCH // c["g"])
    sharded = [d for d in built.fn.mp_dims if d is not None]
    ref = _engine(cfg, c["g"], c["strategy"], "reference", mp=c["mp"],
                  num_devices=world)
    rp, rv, rlosses = ref.run(params, mom, _stream(cfg), steps=STEPS)
    bad = [str(path) for (path, a), b in zip(
        T.leaves_with_path(p) + T.leaves_with_path(v),
        T.leaves(rp) + T.leaves(rv))
        if not (a.dtype == b.dtype and torch.equal(a, b))]
    if losses != rlosses:
        bad.append(f"losses {losses} != {rlosses}")
    if not all(np.array_equal(a, b) for a, b in
               zip(eng.shard_losses, ref.shard_losses)):
        bad.append("per-shard losses")
    experts = [d for (path, _), d in zip(T.leaves_with_path(params),
                                         built.fn.mp_dims)
               if path[-1] in ("w_gate", "w_up", "w_down")
               and "moe" in path and "shared" not in path]
    return dict(bad=bad, mesh=built.fn.mesh_shape, launches=len(calls),
                buckets=len(built.fn.buckets), sharded=len(sharded),
                experts=experts, finite=all(np.isfinite(losses)))


def rank_main(rank, world, rdv, out_dir, cases):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world)
    try:
        res = {c["name"]: _spmd_case(c, world) for c in cases}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("families_spmd2")
    mp.spawn(rank_main, args=(2, str(d / "rdv"), str(d), SPMD_CASES),
             nprocs=2, join=True)
    out = []
    for r in range(2):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.parametrize("c", SPMD_CASES, ids=[c["name"] for c in
                                               SPMD_CASES])
def test_spmd_bitwise_reference_two_ranks(world2, c):
    for r, res in enumerate(world2):
        got = res[c["name"]]
        assert got["bad"] == [], f"rank {r}: {got['bad']}"
        assert got["mesh"] == (c["g"], c["k"], c["mp"])
        assert got["finite"]
        assert got["launches"] == got["buckets"] * STEPS
        if c["mp"] > 1:
            # the 4-D expert leaves (w_down (L, E, F, D), w_gate and w_up
            # (L, E, D, F), in leaf order) are stored as mp shards of their
            # expert width F
            assert got["experts"] == [2, 3, 3], got["experts"]
        else:
            assert got["sharded"] == 0


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

PORT_ONLY = ["--device", "cpu", "--update-impl", "torch"]


@pytest.mark.parametrize("fam", ARCHS)
def test_train_launcher_trains_each_family_on_cpu(fam, capsys):
    from repro_torch.launch import train as TR
    losses = TR.main(["--arch", ARCHS[fam], "--smoke", "--groups", "2",
                      "--seq", "32", "--batch", "4", "--steps", "2",
                      *PORT_ONLY])
    out = capsys.readouterr().out
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert f"arch={ARCHS[fam]}" in out and "final loss" in out


@pytest.mark.parametrize("fam", ARCHS)
def test_serve_launcher_serves_each_family_on_cpu(fam, capsys):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as SV
    toks = SV.main(["--arch", ARCHS[fam], "--smoke", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert toks.shape == (2, 4)
    assert ((toks >= 0) & (toks < get_smoke_config(ARCHS[fam]).vocab_size)
            ).all()
    assert f"arch={ARCHS[fam]} generated" in capsys.readouterr().out


def test_serve_launcher_continuous_refuses_an_ssm_arch():
    from repro_torch.launch import serve as SV
    with pytest.raises(ValueError, match="dense/moe"):
        SV.main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu",
                 "--mode", "continuous", "--requests", "2"])
