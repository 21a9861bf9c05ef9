"""The port's SPMD grouped step under gloo on the CPU, four ranks.

One spawn of four ranks (``torch.multiprocessing``, a ``file://``
rendezvous under ``tmp_path``) runs every case below through
``Engine(exec_mode="spmd")``, then, on each rank, the same rounds through
the single-process ``Engine(exec_mode="reference")`` over the same (g, k)
shard structure. Each rank's final params and momentum, its per-round
losses and the (g, k) per-shard losses must be **bitwise** the
reference's. Cases: (g, k, mp) in {(4, 1, 1), (2, 2, 1), (2, 1, 2)},
``grouped-fused`` and ``grouped-scan``, ``bucket_bytes`` in {0, 1, the
default, 1 << 30}, the merged-FC head filter throughout, weight decay 0
and ``WD``. Every round also launches the update once per bucket, the
tracer holds one ``exchange.bucket`` instant per bucket, and the
checkpoint rank 0 saves after the last round restores into each rank's mp
shards as the bits the rank stores.

Rank 0's final params of the lenet and cifarnet runs at g = 4 are then
held to the JAX ``Engine(exec_mode="vmap")`` on the same numpy-seeded
inputs within 1e-4 (fp32; the frameworks reduce in other orders, and at
lambda > 0 the JAX package itself allows one ulp between programs).

The worker functions here import nothing of JAX: spawned ranks import
this module (``test_torch_spmd_small.py`` reuses them).
"""
import os
import pickle

import numpy as np
import pytest
import torch

STEPS, BATCH, LR, MU = 3, 8, 0.05, 0.3
TOL = 1e-4
#: weight decay of the lambda > 0 cases: large enough that dropping it
#: moves the params by far more than TOL in three rounds
#: (``test_torch_spmd.py::test_weight_decay_cases_see_the_decay``)
WD = 0.05


def case(arch, g, k, mp, strategy="grouped-fused", bucket_bytes=None,
         wd=0.0, seed=0, exec_mode="spmd"):
    name = (f"{arch}-g{g}k{k}mp{mp}-{strategy}-b{bucket_bytes}-wd{wd}"
            f"-s{seed}" + ("" if exec_mode == "spmd" else f"-{exec_mode}"))
    return dict(name=name, arch=arch, g=g, k=k, mp=mp, strategy=strategy,
                bucket_bytes=bucket_bytes, wd=wd, seed=seed,
                exec_mode=exec_mode)


def np_inputs(arch, seed):
    """(cfg, params, momentum) as numpy trees, drawn from ``seed``: the
    port's smoke geometry with fan-in scaled weights, small biases and a
    small non-zero momentum (so every closed-form coefficient matters)."""
    from repro_torch.core import tree as T
    from repro_torch.models import cnn as C
    import dataclasses
    cfg = dataclasses.replace(C.get_cnn_smoke_config(arch),
                              conv_impl="lowering")
    shapes = C.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(seed)

    def draw(t):
        shape = tuple(t.shape)
        scale = 0.1 if len(shape) == 1 else float(np.prod(shape[:-1])) ** -0.5
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = T.tree_map(draw, shapes)
    mom = T.tree_map(lambda t: (rng.standard_normal(t.shape) * 1e-3)
                     .astype(np.float32), params)
    return cfg, params, mom


def batches(cfg, seed):
    from repro_torch.data.pipeline import DataConfig, SyntheticImages
    return SyntheticImages(DataConfig(
        batch_size=BATCH, image_size=cfg.image_size,
        channels=cfg.in_channels, num_classes=cfg.num_classes,
        seed=seed)).batches(STEPS)


def _engine(c, cfg, exec_mode, **kw):
    from repro_torch.engine import Engine
    from repro_torch.engine.spmd import DEFAULT_BUCKET_BYTES
    from repro_torch.models import cnn as C
    bb = DEFAULT_BUCKET_BYTES if c["bucket_bytes"] is None \
        else c["bucket_bytes"]
    return Engine(lambda p, b: C.loss_fn(p, b, cfg), strategy=c["strategy"],
                  num_groups=c["g"], lr=LR, momentum=MU,
                  weight_decay=c["wd"], head_filter=C.head_filter,
                  update_impl="torch", exec_mode=exec_mode, mp=c["mp"],
                  bucket_bytes=bb, device="cpu", **kw)


def run_case(c, rank: int, world: int, out_dir: str) -> dict:
    """One case on this rank: the SPMD run, then the reference run; the
    bitwise comparison and what the parent checks further."""
    from repro_torch.checkpoint import checkpointing as CK
    from repro_torch.core import tree as T
    from repro_torch.engine import spmd as S
    from repro_torch.obs import spans
    cfg, params, mom = np_inputs(c["arch"], c["seed"])
    params = T.tree_map(torch.from_numpy, params)
    mom = T.tree_map(torch.from_numpy, mom)
    tracer = spans.Tracer()
    eng = _engine(c, cfg, c["exec_mode"], tracer=tracer, checkpoint_dir=os.path.join(
        out_dir, c["name"]), checkpoint_every=STEPS)
    calls = []
    real = S.fused_bucket_update

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    S.fused_bucket_update = counted         # counts the slab updates
    try:
        p, v, losses = eng.run(params, mom, batches(cfg, c["seed"]),
                               steps=STEPS)
    finally:
        S.fused_bucket_update = real
    built = eng._built_step(BATCH // c["g"])
    ref = _engine(c, cfg, "reference", num_devices=world)
    rp, rv, rlosses = ref.run(params, mom, batches(cfg, c["seed"]),
                              steps=STEPS)
    bad = [f"leaf {i}" for i, (a, b) in enumerate(
        zip(T.leaves(p) + T.leaves(v), T.leaves(rp) + T.leaves(rv)))
        if not (a.dtype == b.dtype and torch.equal(a, b))]
    if losses != rlosses:
        bad.append(f"losses {losses} != {rlosses}")
    if not all(np.array_equal(a, b) for a, b in
               zip(eng.shard_losses, ref.shard_losses)):
        bad.append("per-shard losses differ")
    # the checkpoint rank 0 saved restores into this rank's mp shards
    import torch.distributed as dist
    dist.barrier()
    saved = CK.latest(os.path.join(out_dir, c["name"]))
    local, step = CK.restore(saved, built.shard({"params": params,
                                                 "mom": mom}),
                             shards=eng.shard_layout({"params": params,
                                                      "mom": mom},
                                                     BATCH // c["g"]))
    want = built.shard({"params": p, "mom": v})
    if step != STEPS or not all(torch.equal(a, b) for a, b in zip(
            T.leaves(local), T.leaves(want))):
        bad.append("checkpoint restored into the shards differs")
    n_buckets = 0 if built.idle or not built.fn.buckets else len(
        built.fn.buckets)
    out = dict(bad=bad, mode=built.mode,
               mesh=None if built.idle else built.fn.mesh_shape,
               instants=[r.name for r in tracer.records()
                         if r.name == "exchange.bucket"],
               ref_k=ref._built_step(BATCH // c["g"]).k,
               shard_losses=[x.shape for x in eng.shard_losses],
               bucket_launches=len(calls), n_buckets=n_buckets,
               describe=eng.describe(BATCH // c["g"]))
    if rank == 0:
        out.update(params=[t.numpy() for t in T.leaves(p)], losses=losses)
    return out


def rank_main(rank: int, world: int, rdv: str, out_dir: str, cases,
              run=run_case) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world)
    try:
        res = {c["name"]: run(c, rank, world, out_dir) for c in cases}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def exchange_case(c, rank: int, world: int, out_dir: str) -> dict:
    """One ``SpmdStep`` round of case ``c`` with ``dist.all_gather``
    wrapped: the (bytes, group size) of each gather this rank made, beside
    ``engine.spmd.exchange_bytes``'s reckoning from the full trees."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch.core import tree as T
    from repro_torch.engine import spmd as S
    from repro_torch.launch.mesh import make_group_mesh
    from repro_torch.models import cnn as C
    cfg, params, mom = np_inputs(c["arch"], c["seed"])
    params = T.tree_map(torch.from_numpy, params)
    mom = T.tree_map(torch.from_numpy, mom)
    bb = S.DEFAULT_BUCKET_BYTES if c["bucket_bytes"] is None \
        else c["bucket_bytes"]
    mesh = make_group_mesh(c["g"], c["k"], c["mp"], device_type="cpu")
    step = S.make_spmd_grouped_step(lambda p, b: C.loss_fn(p, b, cfg), mesh,
                                    lr=LR, momentum=MU,
                                    head_filter=C.head_filter,
                                    bucket_bytes=bb)
    p, v = step.shard(params), step.shard(mom)
    n = BATCH // (c["g"] * c["k"])
    local = {k: torch.from_numpy(x[:n])
             for k, x in next(iter(batches(cfg, c["seed"]))).items()}
    real, seen = dist.all_gather, []

    def counted(parts, t, *a, **kw):
        seen.append((t.numel() * t.element_size(), len(parts)))
        return real(parts, t, *a, **kw)

    dist.all_gather = counted
    try:
        step(p, v, local)
    finally:
        dist.all_gather = real
    ex = S.exchange_bytes(params, {"group": c["g"], "data": c["k"],
                                   "mp": c["mp"]},
                          bucket_bytes=bb, head_filter=C.head_filter)
    return dict(seen=seen, reckoned=dataclasses.asdict(ex))


def spawn(tmp_path, world: int, cases, run=run_case):
    """Run ``cases`` on ``world`` gloo ranks, each through ``run(case,
    rank, world, out_dir)``; -> per-rank result dicts."""
    import torch.multiprocessing as mp
    mp.spawn(rank_main, args=(world, str(tmp_path / "rdv"), str(tmp_path),
                              cases, run), nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def check_bitwise(results, c, world):
    size = c["g"] * c["k"] * c["mp"]
    assert len(results) == world >= size
    for r, res in enumerate(results):
        got = res[c["name"]]
        assert got["mode"] == "spmd"
        assert got["ref_k"] == c["k"]
        assert got["bad"] == [], f"rank {r}: {got['bad']}"
        assert got["shard_losses"] == [(c["g"], c["k"])] * STEPS
        if r >= size:
            # past the mesh: no round, no update, no exchange; the bits
            # above are rank 0's, handed over at the end
            assert got["mesh"] is None
            assert got["bucket_launches"] == 0 and got["instants"] == []
            continue
        assert got["mesh"] == (c["g"], c["k"], c["mp"])
        if c["bucket_bytes"] != 0 and c["strategy"] != "grouped-scan":
            assert got["n_buckets"] >= 1
            assert got["bucket_launches"] == got["n_buckets"] * STEPS
        else:
            assert got["bucket_launches"] == 0
        want = got["n_buckets"] if c["bucket_bytes"] != 0 else 0
        assert len(got["instants"]) == want     # exchange.bucket, once
    assert f"exec=spmd({c['g']}x{c['k']}" in results[0][c["name"]]["describe"]


def jax_vmap(c):
    """Final params and losses of the JAX ``Engine(exec_mode="vmap")`` on
    the case's numpy inputs and stream."""
    import jax
    from repro.data import pipeline as JP
    from repro.engine import Engine as JEngine
    from repro.models import cnn as JC
    cfg, params, mom = np_inputs(c["arch"], c["seed"])
    jcfg = JC.get_cnn_smoke_config(c["arch"])
    eng = JEngine(lambda p, b: JC.loss_fn(p, b, jcfg), exec_mode="vmap",
                  strategy=c["strategy"], num_groups=c["g"], lr=LR,
                  momentum=MU, weight_decay=c["wd"],
                  head_filter=JC.head_filter)
    data = JP.SyntheticImages(JP.DataConfig(
        batch_size=BATCH, image_size=jcfg.image_size,
        channels=jcfg.in_channels, num_classes=jcfg.num_classes,
        seed=c["seed"])).batches(STEPS)
    jp, _, losses = eng.run(params, mom, data, steps=STEPS)
    return [np.asarray(x) for x in jax.tree.leaves(jp)], losses


def check_jax(results, c):
    got = results[0][c["name"]]
    want_p, want_l = jax_vmap(c)
    np.testing.assert_allclose(got["losses"], want_l, rtol=TOL, atol=TOL)
    assert len(got["params"]) == len(want_p)
    for a, b in zip(got["params"], want_p):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


CASES = [
    case("lenet", 4, 1, 1),
    case("cifarnet", 4, 1, 1, bucket_bytes=1),
    case("lenet", 4, 1, 1, bucket_bytes=0, wd=WD),
    case("cifarnet", 4, 1, 1, wd=WD, seed=1),
    case("caffenet", 4, 1, 1, "grouped-scan", bucket_bytes=1 << 30),
    case("caffenet", 2, 2, 1, bucket_bytes=1, wd=WD),
    case("caffenet", 2, 2, 1, "grouped-scan", bucket_bytes=0),
    case("caffenet", 2, 1, 2, wd=WD),
    case("caffenet", 2, 1, 2, "grouped-scan", bucket_bytes=1),
    case("lenet", 2, 1, 2, bucket_bytes=0),
]
JAX_CASES = [c for c in CASES if c["arch"] in ("lenet", "cifarnet")
             and c["mp"] == 1]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("spmd4"), 4, CASES)


@pytest.mark.parametrize("c", CASES, ids=[c["name"] for c in CASES])
def test_spmd_bitwise_reference_four_ranks(world4, c):
    check_bitwise(world4, c, 4)


@pytest.mark.parametrize("c", JAX_CASES, ids=[c["name"] for c in JAX_CASES])
def test_spmd_matches_jax_vmap_four_ranks(world4, c):
    check_jax(world4, c)
