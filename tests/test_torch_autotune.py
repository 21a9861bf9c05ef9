"""Port parity: the conv-tile autotuner (``kernels/lowering_conv/
autotune.py``), the kernels' shared-memory footprint model
(``lowering_conv.smem_bytes``) and ``models.cnn``'s tile lookup and
``autotune_conv_tiles``, on the CPU — the JAX package's autotuner and
``vmem_bytes`` tests (``tests/test_lowering_vjp.py``) mirrored onto the
CUDA kernels' own knobs (``bwd.ConvTiles``).

- ``smem_bytes`` gives each kernel's ``smem_bytes<BN>()`` (the table of
  the three ring layouts) and refuses an unknown pass or width; the
  compiled kernels' own values are held to it on the card
  (``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 17);
- every candidate fits the budget, the default rule's first; the three
  kernels share one ring layout, so a budget under the 96-wide block
  leaves every pass the 64-wide tile (and forces a re-probe of a cached
  choice that no longer fits), one under the 64-wide block leaves none;
- the cache ignores the batch and respects the stride and the device
  type; a layer never probed runs ``DEFAULT_TILES``, which is the rule
  the kernels ran before the autotuner (the same widths and wgrad split);
- the probe emits ``autotune.conv_tiles`` / ``autotune.candidate`` spans
  (no dgrad candidates on the data-fed layer 0);
- ``conv_layer_shapes`` equals the JAX one for lenet, cifarnet, caffenet;
- under two gloo ranks the launcher's autotune step caches rank 0's
  choice on every rank, and rank 1 probes nothing.

``timing.probe`` is replaced by a fake clock wherever the winner matters:
on the CPU the wrappers run their plain versions, whatever the tiles.
"""
import argparse
import os
import pickle

import pytest
import torch

from repro_torch.engine import timing
from repro_torch.kernels.lowering_conv import autotune as A
from repro_torch.kernels.lowering_conv import bwd
from repro_torch.kernels.lowering_conv.lowering_conv import (lowering_conv_cuda,
                                                             smem_bytes)
from repro_torch.models import cnn as C
from repro_torch.obs import spans

CPU = torch.device("cpu")
BLOCK_64 = 132_160         # every pass's 64-wide block (one ring layout)
BLOCK_96 = 164_928         # every pass's 96-wide block


@pytest.fixture(autouse=True)
def _clean_cache():
    A.clear_tile_cache()
    yield
    A.clear_tile_cache()


def _fake_probe(monkeypatch, favor_last=True):
    """``timing.probe`` on a fake clock: each call faster than the last
    (the last candidate of each pass wins), or slower (the first wins).
    Returns the list of calls made."""
    calls = []

    def probe(fn, *, warmup=1, iters=5):
        calls.append(fn)
        t = 1.0 / len(calls) if favor_last else float(len(calls))
        return timing.TimeStats(min_s=t, median_s=t, iqr_s=0.0,
                                iters=iters)
    monkeypatch.setattr(A.timing, "probe", probe)
    return calls


# ---------------------------------------------------------------------------
# the footprint model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pass_,block_n,want", [
    ("fwd", 64, BLOCK_64), ("fwd", 96, BLOCK_96),
    ("wgrad", 64, BLOCK_64), ("wgrad", 96, BLOCK_96),
    ("dgrad", 64, BLOCK_64), ("dgrad", 96, BLOCK_96)])
def test_smem_model_is_the_kernels_ring_layout(pass_, block_n, want):
    assert smem_bytes(pass_=pass_, block_n=block_n) == want


def test_smem_model_unknown_pass_or_width_rejected():
    with pytest.raises(ValueError, match="unknown pass_"):
        smem_bytes(pass_="bogus", block_n=64)
    with pytest.raises(ValueError, match="built for"):
        smem_bytes(pass_="fwd", block_n=128)
    with pytest.raises(ValueError, match="built for"):
        bwd.ConvTiles(fwd_bn=80, wgrad_bn=64, wgrad_blocks=792, dgrad_bn=64)
    with pytest.raises(ValueError, match="wgrad_blocks"):
        bwd.ConvTiles(fwd_bn=64, wgrad_bn=64, wgrad_blocks=0, dgrad_bn=64)


# ---------------------------------------------------------------------------
# candidates and the default rule
# ---------------------------------------------------------------------------

def test_default_tiles_are_the_fixed_rule():
    """An unprobed layer runs the fixed rule: the forward's and wgrad's
    width the one that takes the fewest tiles of Cout, dgrad's the one
    that pads Cin least, wgrad's split from ``WGRAD_TARGET_BLOCKS``."""
    for xs, ws, s in C.conv_layer_shapes(C.CAFFENET, 64):
        t = A.DEFAULT_TILES(ws)
        kh, kw, cin, cout = ws
        assert t == bwd.default_tiles(ws) == A.cached_tiles(xs, ws, s)
        assert (t.fwd_bn, t.wgrad_bn, t.dgrad_bn) == (
            bwd.out_block_n(cout), bwd.out_block_n(cout),
            bwd.dgrad_block_n(cin))
        ho = (xs[1] - kh) // s + 1
        m, k = xs[0] * ho * ho, kh * kw * cin
        assert bwd.wgrad_slices(m, k, cout) == bwd.wgrad_slices(
            m, k, cout, t.wgrad_bn, t.wgrad_blocks)
    assert [A.DEFAULT_TILES(ws).fwd_bn for _, ws, _ in
            C.conv_layer_shapes(C.CAFFENET, 64)] == [96, 96, 96, 96, 96]
    assert [A.DEFAULT_TILES(ws).dgrad_bn for _, ws, _ in
            C.conv_layer_shapes(C.CAFFENET, 64)] == [64, 96, 64, 96, 96]


@pytest.mark.parametrize("layer", range(5))
def test_tile_candidates_fit_the_budget_default_first(layer):
    xs, ws, s = C.conv_layer_shapes(C.CAFFENET, 64)[layer]
    dflt = A.DEFAULT_TILES(ws)
    for budget in (A.budget_bytes_of(CPU), BLOCK_96, BLOCK_64):
        cands = A.tile_candidates(xs, ws, s, budget_bytes=budget,
                                  device=CPU)
        for p in ("fwd", "dgrad"):
            assert all(smem_bytes(pass_=p, block_n=bn) <= budget
                       for bn in cands[p])
        assert all(smem_bytes(pass_="wgrad", block_n=bn) <= budget
                   for bn, _ in cands["wgrad"])
        if budget >= BLOCK_96:
            assert cands["fwd"][0] == dflt.fwd_bn
            assert cands["dgrad"][0] == dflt.dgrad_bn
            assert cands["wgrad"][0] == (dflt.wgrad_bn, dflt.wgrad_blocks)
            assert sorted(cands["fwd"]) == sorted(cands["dgrad"]) == [64, 96]
        # each wgrad candidate is another launch at this batch
        kh, kw, cin, cout = ws
        ho = (xs[1] - kh) // s + 1
        splits = [(bn, bwd.wgrad_slices(xs[0] * ho * ho, kh * kw * cin,
                                        cout, bn, blocks))
                  for bn, blocks in cands["wgrad"]]
        assert len(set(splits)) == len(splits)
    # the three wgmma rings are one layout: a budget under the 96-wide
    # block leaves every pass the 64-wide one, and under that none fits
    tiny = A.tile_candidates(xs, ws, s, budget_bytes=BLOCK_64, device=CPU)
    assert tiny["dgrad"] == tiny["fwd"] == [64]
    assert {bn for bn, _ in tiny["wgrad"]} == {64}
    with pytest.raises(ValueError, match="no fwd tile fits"):
        A.tile_candidates(xs, ws, s, budget_bytes=BLOCK_64 - 1, device=CPU)


def test_budget_off_the_card_is_the_sm90_opt_in():
    assert A.budget_bytes_of(CPU) == 232_448 == A.SM90_SMEM_OPTIN_BYTES
    assert A.DEFAULT_BUDGET_BYTES is None


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def test_autotune_caches_per_shape_stride_and_device(monkeypatch):
    x_shape, w_shape = (4, 12, 12, 8), (3, 3, 8, 70)
    calls = _fake_probe(monkeypatch)
    t1 = A.autotune_tiles(x_shape, w_shape, 1, device=CPU, iters=1)
    cands = A.tile_candidates(x_shape, w_shape, 1, device=CPU)
    assert len(calls) == sum(len(c) for c in cands.values())
    # the last candidate of each pass was fastest on the fake clock
    assert t1 == bwd.ConvTiles(cands["fwd"][-1], *cands["wgrad"][-1],
                               cands["dgrad"][-1])
    assert t1 != A.DEFAULT_TILES(w_shape)
    assert A.cached_tiles(x_shape, w_shape, 1, CPU) == t1
    # a second call must hit the cache: probing again would retime
    monkeypatch.setattr(A.timing, "probe", lambda *a, **k: (_ for _ in ()
                        ).throw(AssertionError("re-probed")))
    assert A.autotune_tiles(x_shape, w_shape, 1, device=CPU) == t1
    # the key ignores the batch: the engine runs the same layer at
    # batch/g (a group) or batch/(g*k) (a rank's shard)
    assert A.cached_tiles((1,) + x_shape[1:], w_shape, 1, CPU) == t1
    assert A.cached_tiles((64,) + x_shape[1:], w_shape, 1, CPU) == t1
    # another stride, geometry or device type is another line: default
    for key in ((x_shape, w_shape, 2, CPU),
                (x_shape, (3, 3, 8, 64), 1, CPU),
                (x_shape, w_shape, 1, "cuda")):
        assert A.cached_tiles(*key) == A.DEFAULT_TILES(key[1])
    # a SMALLER budget the cached choice does not fit forces a re-probe
    calls = _fake_probe(monkeypatch)
    assert A._max_smem(t1) > BLOCK_64
    t2 = A.autotune_tiles(x_shape, w_shape, 1, budget_bytes=BLOCK_64,
                          device=CPU, iters=1)
    assert calls and A._max_smem(t2) <= BLOCK_64
    assert A.cached_tiles(x_shape, w_shape, 1, CPU) == t2
    # a larger one keeps the cached choice
    monkeypatch.setattr(A.timing, "probe", lambda *a, **k: (_ for _ in ()
                        ).throw(AssertionError("re-probed")))
    assert A.autotune_tiles(x_shape, w_shape, 1, device=CPU) == t2


def test_data_fed_layer_probes_no_dgrad(monkeypatch):
    """A data-fed layer probes no dgrad and keeps its default width."""
    x_shape, w_shape = (4, 12, 12, 8), (3, 3, 8, 70)
    calls = _fake_probe(monkeypatch)
    t = A.autotune_tiles(x_shape, w_shape, 1, device=CPU, iters=1,
                         needs_dgrad=False)
    cands = A.tile_candidates(x_shape, w_shape, 1, device=CPU)
    assert len(calls) == len(cands["fwd"]) + len(cands["wgrad"])
    assert t.dgrad_bn == A.DEFAULT_TILES(w_shape).dgrad_bn
    assert (t.fwd_bn, t.wgrad_bn, t.wgrad_blocks) == (
        cands["fwd"][-1], *cands["wgrad"][-1])


def test_probe_times_each_pass_on_its_wrapper():
    """On the CPU the wrappers run their plain versions whatever the
    tiles; the real probe runs and caches a valid choice."""
    x_shape, w_shape = (2, 9, 9, 4), (3, 3, 4, 6)
    t = A.autotune_tiles(x_shape, w_shape, 2, device=CPU, warmup=0,
                         iters=1)
    assert t.fwd_bn in (64, 96) and t.wgrad_blocks in A.WGRAD_BLOCKS
    g = torch.Generator().manual_seed(0)
    x = torch.randn(x_shape, generator=g)
    w = torch.randn(w_shape, generator=g)
    y, low = lowering_conv_cuda(x, w, stride=2, return_lowered=True,
                                tiles=t)
    assert torch.equal(y, lowering_conv_cuda(x, w, stride=2))
    dy = torch.randn(y.shape, generator=g)
    assert torch.equal(bwd.wgrad_cuda(low, dy, w_shape, tiles=t),
                       bwd.wgrad_ref(low, dy, w_shape))
    assert torch.equal(bwd.dgrad_cuda(dy, w, x_shape, stride=2, tiles=t),
                       bwd.dgrad_ref(dy, w, x_shape, 2))


# ---------------------------------------------------------------------------
# the model's lookup and autotune_conv_tiles
# ---------------------------------------------------------------------------

def test_conv_reads_the_cache_on_the_kernel_arm(monkeypatch):
    """``_conv``'s ``lowering_cuda`` arm hands the kernels the cached tiles
    (the default rule where the layer was never probed); the kernel arm
    itself is recorded here and run as its plain twin."""
    import dataclasses
    seen = []

    def kernel_arm(x, w, *, stride, needs_dgrad, tiles):
        seen.append(tiles)
        return C.lc_ops.lowering_conv_torch(x, w, stride=stride,
                                            needs_dgrad=needs_dgrad)
    monkeypatch.setattr(C.lc_ops, "lowering_conv", kernel_arm)
    cfg = dataclasses.replace(C.get_cnn_smoke_config("cifarnet"),
                              conv_impl="lowering_cuda")
    params = C.init_params(torch.Generator().manual_seed(0), cfg)
    images = torch.randn((3, cfg.image_size, cfg.image_size,
                          cfg.in_channels))
    layers = C.conv_layer_shapes(cfg, 3)
    C.forward(params, images, cfg)
    assert seen == [A.DEFAULT_TILES(ws) for _, ws, _ in layers]
    probed = bwd.ConvTiles(96, 64, 264, 96)
    xs, ws, s = layers[1]
    A.put_tiles((64,) + xs[1:], ws, s, probed, device=CPU)
    seen.clear()
    C.forward(params, images, cfg)
    assert seen == [A.DEFAULT_TILES(layers[0][1]), probed]


def test_autotune_conv_tiles_spans_every_layer(monkeypatch):
    _fake_probe(monkeypatch, favor_last=False)
    cfg = C.get_cnn_smoke_config("caffenet")
    tracer = spans.Tracer()
    with spans.install(tracer):
        tiles = C.autotune_conv_tiles(cfg, 4, device=CPU, iters=2)
    layers = C.conv_layer_shapes(cfg, 4)
    # the first candidate (the default rule's) wins every pass
    assert tiles == {i: A.DEFAULT_TILES(ws)
                     for i, (_, ws, _) in enumerate(layers)}
    recs = tracer.records()
    outer = [r for r in recs if r.name == "autotune.conv_tiles"]
    assert [r.attrs["w_shape"] for r in outer] == [ws for _, ws, _ in layers]
    for i, r in enumerate(outer):
        cand = [c for c in recs if c.name == "autotune.candidate"
                and c.parent == r.index]
        passes = {c.attrs["pass_"] for c in cand}
        assert passes == ({"fwd", "wgrad", "dgrad"} if i else
                          {"fwd", "wgrad"})      # layer 0: no dgrad
        assert len(cand) == r.attrs["candidates"]
        assert all(c.attrs["launches"] == 1 + 2 and "min_us" in c.attrs
                   for c in cand)
        assert r.attrs["fwd_bn"] == tiles[i].fwd_bn


@pytest.mark.parametrize("arch", ["lenet", "cifarnet", "caffenet"])
def test_conv_layer_shapes_match_jax(arch):
    from repro.models import cnn as JC
    for batch in (1, 64):
        assert C.conv_layer_shapes(C.get_cnn_config(arch), batch) == \
            JC.conv_layer_shapes(JC.get_cnn_config(arch), batch)
        assert C.conv_layer_shapes(C.get_cnn_smoke_config(arch), batch) == \
            JC.conv_layer_shapes(JC.get_cnn_smoke_config(arch), batch)


# ---------------------------------------------------------------------------
# the launcher's autotune step across ranks
# ---------------------------------------------------------------------------

def _rank_autotune(rank: int, world: int, rdv: str, out_dir: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch import train as TR
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world)
    try:
        calls = []

        def probe(fn, *, warmup=1, iters=5):
            if rank:
                raise AssertionError("rank 1 probed")
            calls.append(fn)
            t = 1.0 / len(calls)
            return timing.TimeStats(t, t, 0.0, iters)
        A.timing.probe = probe
        cfg = C.get_cnn_smoke_config("caffenet")
        TR._autotune(argparse.Namespace(batch=8, groups=2), cfg, CPU,
                     say=lambda m: None)
        got = [A.cached_tiles(xs, ws, s, CPU)
               for xs, ws, s in C.conv_layer_shapes(cfg, 4)]
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump((got, len(calls)), f)


def test_launcher_autotune_caches_rank0_choice_on_every_rank(tmp_path):
    import torch.multiprocessing as mp
    mp.spawn(_rank_autotune, args=(2, str(tmp_path / "rdv"),
                                   str(tmp_path)), nprocs=2, join=True)
    res = [pickle.load(open(tmp_path / f"rank{r}.pkl", "rb"))
           for r in range(2)]
    (t0, n0), (t1, n1) = res
    assert n0 > 0 and n1 == 0
    assert t0 == t1
    layers = C.conv_layer_shapes(C.get_cnn_smoke_config("caffenet"), 4)
    assert t0 != [A.DEFAULT_TILES(ws) for _, ws, _ in layers]
