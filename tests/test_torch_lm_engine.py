"""Port parity: LM training through the engine, across ranks and through
the launcher (qwen2-7b smoke widths, the ``SyntheticLM`` stream).

- ``Engine.run`` (batch 8, seq 32, 3 rounds, mu 0.3, lr 0.05, no head
  filter) at g = 1 ``sync``, g = 2 and 4 ``grouped-fused``, and g = 2
  under ``exec_mode="reference"``, against the JAX
  ``Engine(exec_mode="vmap")`` (never "auto": the test session forces 8
  host devices) from the same JAX-initialised params: per-round losses and
  final params within 1e-4 (fp32; the frameworks reduce in other orders).
- ``exec_mode="spmd"`` over two gloo ranks at (g, k, mp) = (2, 1, 1) and
  (1, 1, 2), bf16 compute and remat as the config has them: every rank's
  params, momentum, losses and per-shard losses bitwise its
  ``"reference"`` twin, with one update launch per gradient bucket.
- Bucket assignment over the full-width qwen2-7b tree (2 layers): the
  JAX package's layout, with the 2.18 GB embedding, larger than any
  bucket target, a bucket of its own.
- The launcher on the CPU: ``--arch qwen2-7b --smoke`` prints a step line
  a round; with the JAX init's params and fp32 compute on both sides its
  losses are the JAX launcher's on the same argv within 1e-4; ``encdec``
  and ``vlm`` archs exit with the JAX launcher's message.

The rank workers here import nothing of JAX: spawned ranks import this
module, and the JAX package is imported inside the tests that use it.
"""
import dataclasses
import functools
import os
import pathlib
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS, BATCH, SEQ, LR, MU, WD = 3, 8, 32, 0.05, 0.3, 0.05
TOL = 1e-4


def _tcfg(compute="float32"):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("qwen2-7b"),
                               compute_dtype=compute)


def _stream(cfg, seed=0):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    return SyntheticLM(DataConfig(batch_size=BATCH, seq_len=SEQ,
                                  vocab_size=cfg.vocab_size,
                                  seed=seed)).batches(STEPS)


def _engine(cfg, g, strategy, exec_mode, wd=0.0, **kw):
    from repro_torch.engine import Engine
    from repro_torch.models import transformer as M
    return Engine(lambda p, b: M.lm_loss(p, b, cfg), strategy=strategy,
                  num_groups=g, lr=LR, momentum=MU, weight_decay=wd,
                  update_impl="torch", exec_mode=exec_mode, device="cpu",
                  **kw)


@functools.lru_cache(maxsize=None)
def _jax_params():
    import jax
    from repro.configs import get_smoke_config
    from repro.models import transformer as JT
    return jax.device_get(JT.init_params(jax.random.PRNGKey(0),
                                         get_smoke_config("qwen2-7b")))


@functools.lru_cache(maxsize=None)
def _jax_run(g, strategy):
    """Final params (numpy leaves) and losses of the JAX vmap engine."""
    import jax
    from repro.configs import get_smoke_config
    from repro.data import pipeline as JP
    from repro.engine import Engine as JEngine
    from repro.models import transformer as JT
    from repro.optim.sgd import init_momentum
    jcfg = dataclasses.replace(get_smoke_config("qwen2-7b"),
                               compute_dtype="float32")
    params = _jax_params()
    eng = JEngine(lambda p, b: JT.lm_loss(p, b, jcfg), exec_mode="vmap",
                  strategy=strategy, num_groups=g, lr=LR, momentum=MU)
    data = JP.SyntheticLM(JP.DataConfig(batch_size=BATCH, seq_len=SEQ,
                                        vocab_size=jcfg.vocab_size,
                                        seed=0)).batches(STEPS)
    jp, _, losses = eng.run(params, init_momentum(params), data, steps=STEPS)
    return [np.asarray(x) for x in jax.tree.leaves(jp)], losses


@pytest.mark.parametrize("g,strategy,exec_mode", [
    (1, "sync", "vmap"), (2, "grouped-fused", "vmap"),
    (4, "grouped-fused", "vmap"), (2, "grouped-fused", "reference")])
def test_engine_run_lm_matches_jax_vmap(g, strategy, exec_mode):
    from repro_torch.core import tree as T
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.sgd import init_momentum
    cfg = _tcfg()
    params = params_from_jax(_jax_params())
    eng = _engine(cfg, g, strategy, exec_mode)
    pp, _, losses = eng.run(params, init_momentum(params), _stream(cfg),
                            steps=STEPS)
    assert eng._built_step(BATCH // g).mode == exec_mode
    want_p, want_l = _jax_run(g, strategy)
    np.testing.assert_allclose(losses, want_l, rtol=TOL, atol=TOL)
    assert len(T.leaves(pp)) == len(want_p) == 15
    for a, b in zip(T.leaves(pp), want_p):
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the SPMD engine over gloo ranks
# ---------------------------------------------------------------------------

SPMD_CASES = [dict(name="g2k1mp1-grouped-fused-wd", g=2, k=1, mp=1,
                   strategy="grouped-fused", wd=WD, bucket_bytes=None),
              dict(name="g1k1mp2-sync-b4096", g=1, k=1, mp=2,
                   strategy="sync", wd=0.0, bucket_bytes=4096)]


def _spmd_case(c, world):
    """One case on this rank: spmd, then the reference; what differs."""
    from repro_torch.core import tree as T
    from repro_torch.engine import spmd as S
    from repro_torch.models import transformer as M
    cfg = _tcfg("bfloat16")
    gen = torch.Generator().manual_seed(0)
    params = M.init_params(gen, cfg)
    mom = T.tree_map(lambda t: torch.randn(t.shape, generator=gen) * 1e-3,
                     params)
    kw = {} if c["bucket_bytes"] is None else {
        "bucket_bytes": c["bucket_bytes"]}
    eng = _engine(cfg, c["g"], c["strategy"], "spmd", c["wd"], mp=c["mp"],
                  **kw)
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
    ref = _engine(cfg, c["g"], c["strategy"], "reference", c["wd"],
                  mp=c["mp"], num_devices=world)
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
    return dict(bad=bad, mesh=built.fn.mesh_shape,
                launches=len(calls), buckets=len(built.fn.buckets),
                finite=all(np.isfinite(losses)))


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
    d = tmp_path_factory.mktemp("lm_spmd2")
    mp.spawn(rank_main, args=(2, str(d / "rdv"), str(d), SPMD_CASES),
             nprocs=2, join=True)
    out = []
    for r in range(2):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.parametrize("c", SPMD_CASES, ids=[c["name"] for c in
                                               SPMD_CASES])
def test_spmd_lm_bitwise_reference_two_ranks(world2, c):
    for r, res in enumerate(world2):
        got = res[c["name"]]
        assert got["bad"] == [], f"rank {r}: {got['bad']}"
        assert got["mesh"] == (c["g"], c["k"], c["mp"])
        assert got["finite"]
        assert got["buckets"] >= 1
        assert got["launches"] == got["buckets"] * STEPS


def test_buckets_of_the_full_width_lm_tree_equal_jax():
    import jax
    from repro.configs import get_config as j_get_config
    from repro.engine.buckets import assign_buckets as j_assign
    from repro.models import transformer as JT
    from repro_torch.engine.buckets import assign_buckets
    from repro_torch.engine.spmd import DEFAULT_BUCKET_BYTES
    jcfg = dataclasses.replace(j_get_config("qwen2-7b"), num_layers=2)
    avals = jax.tree.leaves(jax.eval_shape(
        lambda k: JT.init_params(k, jcfg), jax.random.PRNGKey(0)))
    leaves = [torch.empty(a.shape, dtype=torch.float32, device="meta")
              for a in avals]
    assert sum(t.numel() for t in leaves) == 1_556_113_920
    flags = [False] * len(leaves)
    for target in (1, DEFAULT_BUCKET_BYTES, 1 << 30):
        got = assign_buckets(leaves, flags, target)
        want = j_assign(avals, flags, target)
        assert [(b.indices, b.shapes, b.dtype, b.is_head) for b in got] \
            == [(b.indices, tuple(map(tuple, b.shapes)), str(b.dtype),
                 b.is_head) for b in want]
        embed = [b for b in got if (152_064, 3584) in b.shapes]
        assert len(embed) == 1 and embed[0].nbytes == 152_064 * 3584 * 4
        if target < embed[0].nbytes:
            assert len(embed[0].indices) == 1       # a bucket of its own


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

ARGV = ["--arch", "qwen2-7b", "--smoke", "--groups", "2", "--seq", "32",
        "--batch", "8", "--steps", "3"]
PORT_ONLY = ["--device", "cpu", "--update-impl", "torch"]


def test_launcher_trains_smoke_qwen2_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGV,
         *PORT_ONLY], env=env, capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "arch=qwen2-7b" in out.stdout and "seq=32" in out.stdout
    assert len(re.findall(r"^step +\d+ loss ", out.stdout, re.M)) == 3
    assert "final loss" in out.stdout


def test_launcher_losses_match_the_jax_launcher(monkeypatch):
    """Both launchers from the JAX init's params (the port's own init
    draws from ``torch.Generator``) at fp32 compute (in bf16 the two
    round at other places: their losses differ by ~1e-3)."""
    import jax
    from repro.configs import get_smoke_config as j_smoke
    from repro.launch import train as JTR
    from repro.models import transformer as JT
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train as TR
    from repro_torch.models import transformer as M
    from repro_torch.models.convert import params_from_jax
    monkeypatch.setattr(JTR, "get_smoke_config", lambda a: dataclasses.replace(
        j_smoke(a), compute_dtype="float32"))
    monkeypatch.setattr(TR, "get_smoke_config", lambda a: dataclasses.replace(
        get_smoke_config(a), compute_dtype="float32"))
    init = JT.init_params
    monkeypatch.setattr(M, "init_params", lambda gen, cfg: params_from_jax(
        jax.device_get(init(jax.random.PRNGKey(0), j_smoke("qwen2-7b")))))
    want = JTR.main(ARGV + ["--exec-mode", "vmap"])
    got = TR.main(ARGV + PORT_ONLY)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-90b"])
def test_launcher_exits_for_modality_archs_as_jax(arch):
    from repro.launch import train as JTR
    from repro_torch.launch import train as TR
    argv = ["--arch", arch, "--smoke", "--steps", "1"]
    with pytest.raises(SystemExit) as want:
        JTR.main(argv)
    with pytest.raises(SystemExit) as got:
        TR.main(argv + PORT_ONLY)
    assert str(got.value) == str(want.value) and "token-LM" in str(
        got.value)


def test_launcher_targets_the_card_by_default():
    from repro_torch.launch import train as TR
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.main(ARGV + ["--update-impl", "torch"])
