"""Port parity: the multi-device engine's host-side pieces, checkpoints,
and the single-process reference engine, against the JAX package.

- ``assign_buckets`` gives exactly the JAX buckets (indices, shapes, dtype,
  head flag) on the lenet / cifarnet / caffenet trees (smoke and full
  width) and a mixed-dtype tree, at several targets; ``pack_bucket`` and
  ``unpack_bucket`` give the JAX slabs and stacks;
- ``choose_data_parallel`` (with its ``StrandedDevicesWarning``) and
  ``device_batch_split`` give the JAX results;
- ``engine_param_specs`` gives, as tuples, the JAX ``PartitionSpec`` of
  every leaf of the CNN trees and of the dense-transformer smoke tree at
  mp in {2, 4}, also with explicit rules;
- checkpoints: the same escaped names as the JAX ``save``; a port
  checkpoint restores in the JAX package and the other way round with the
  same keys and values; restore raises on a dtype mismatch unless
  ``allow_cast``, and hands each mp shard its slice;
- ``Engine(exec_mode="reference")`` matches the JAX
  ``Engine(exec_mode="vmap")`` within 1e-4 (fp32; the frameworks reduce in
  other orders) for lenet and cifarnet at g in {1, 2, 4}, weight decay 0
  and ``WD`` (the JAX package allows one ulp between its own programs at
  lambda > 0, ``tests/test_engine.py``; 1e-4 is far above that), and over
  a (g, k) = (2, 2) shard structure; at ``WD`` the JAX params move by more
  than ten times that tolerance against lambda = 0, so a port that drops
  the decay fails these cases.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointing as JCK
from repro.configs import get_smoke_config
from repro.engine import buckets as JB
from repro.engine import spmd as JS
from repro.launch.mesh import make_group_mesh as j_group_mesh
from repro.models import cnn as JC
from repro.models import transformer as JTR
from repro.sharding import rules as JR
from repro_torch.checkpoint import checkpointing as CK
from repro_torch.core import tree as T
from repro_torch.engine import buckets as B
from repro_torch.engine import spmd as S
from repro_torch.models import cnn as C
from repro_torch.sharding import rules as R
from test_torch_spmd_mesh import (BATCH, LR, MU, STEPS, TOL, WD, batches,
                                  case, jax_vmap, np_inputs)


def _meta(tree):
    """A numpy/JAX shape tree -> the port's tree of meta tensors."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_meta(v) for v in tree]
    dtype = getattr(torch, np.dtype(tree.dtype).name)
    return torch.empty(tuple(tree.shape), dtype=dtype, device="meta")


def _cnn_shapes(name, smoke):
    cfg = JC.get_cnn_smoke_config(name) if smoke else JC.get_cnn_config(name)
    return jax.eval_shape(lambda: JC.init_params(jax.random.PRNGKey(0), cfg))


def _lm_shapes():
    cfg = get_smoke_config("qwen2-7b")
    return jax.eval_shape(lambda: JTR.init_params(jax.random.PRNGKey(0), cfg))


# full-width cifarnet pools its 1x1 conv3 map to nothing (an empty FC
# input in both packages), so only its smoke tree is held
TREES = {f"{n}{'-smoke' if s else ''}": (n, s)
         for n in ("lenet", "cifarnet", "caffenet") for s in (True, False)
         if s or n != "cifarnet"}


def _tree(name):
    return _cnn_shapes(*TREES[name])


def _head_flags(jtree):
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    return [bool(JC.head_filter(p)) for p, _ in flat]


def _jbucket(b):
    return (b.indices, b.shapes, b.dtype, b.is_head)


@pytest.mark.parametrize("name", sorted(TREES))
@pytest.mark.parametrize("target", [1, 1000, 1 << 16, 4 << 20, 1 << 30])
def test_assign_buckets_equals_jax(name, target):
    jtree = _tree(name)
    flags = _head_flags(jtree)
    want = JB.assign_buckets(jax.tree.leaves(jtree), flags, target)
    got = B.assign_buckets(T.leaves(_meta(jtree)), flags, target)
    assert [_jbucket(b) for b in got] == [_jbucket(b) for b in want]
    assert [b.nbytes for b in got] == [b.nbytes for b in want]


def test_assign_buckets_mixed_dtypes_and_errors():
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in
              ((3, 4), (5,), (2, 2), (7,), (6, 2))]
    leaves[1] = leaves[1].astype(jax.numpy.bfloat16)
    leaves[2] = leaves[2].astype(jax.numpy.bfloat16)
    flags = [False, False, False, True, True]
    tl = [torch.from_numpy(x) if x.dtype == np.float32 else
          torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
          for x in leaves]
    for target in (1, 16, 40, 1 << 20):
        want = JB.assign_buckets(leaves, flags, target)
        got = B.assign_buckets(tl, flags, target)
        assert [_jbucket(b) for b in got] == [_jbucket(b) for b in want]
    with pytest.raises(ValueError, match="must be > 0"):
        B.assign_buckets(tl, flags, 0)
    with pytest.raises(ValueError, match="head flags"):
        B.assign_buckets(tl, flags[:-1], 8)


@pytest.mark.parametrize("target", [1, 200, 1 << 20])
def test_pack_and_unpack_equal_jax(target):
    rng = np.random.default_rng(1)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in
              ((3, 4), (5,), (2, 3, 2), (7,))]
    flags = [False, True, False, False]
    tl = [torch.from_numpy(x) for x in leaves]
    for b, jb in zip(B.assign_buckets(tl, flags, target),
                     JB.assign_buckets(leaves, flags, target)):
        slab = B.pack_bucket(b, tl)
        np.testing.assert_array_equal(slab.numpy(),
                                      np.asarray(JB.pack_bucket(jb, leaves)))
        stack = torch.stack([slab, 2 * slab, -slab])
        for x, y in zip(B.unpack_bucket(b, stack),
                        JB.unpack_bucket(jb, jax.numpy.asarray(stack.numpy()))):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        for x, i in zip(B.unpack_bucket(b, slab), b.indices):
            assert torch.equal(x, tl[i])
        with pytest.raises(ValueError, match="bucket expects"):
            B.unpack_bucket(b, torch.zeros(b.num_elements + 1))


def test_choose_data_parallel_equals_jax():
    for pgb in range(0, 13):
        for max_k in range(0, 9):
            with warnings.catch_warnings(record=True) as jw:
                warnings.simplefilter("always")
                want = JS.choose_data_parallel(pgb, max_k)
            with warnings.catch_warnings(record=True) as pw:
                warnings.simplefilter("always")
                got = S.choose_data_parallel(pgb, max_k)
            assert got == want, (pgb, max_k)
            assert len(pw) == len(jw)
            assert all(issubclass(w.category, S.StrandedDevicesWarning)
                       for w in pw)
            assert S.choose_data_parallel(pgb, max_k, warn=False) == want
    with pytest.warns(S.StrandedDevicesWarning, match="k=3 < 4"):
        S.choose_data_parallel(6, 4)


def test_device_batch_split_equals_jax():
    rng = np.random.default_rng(2)
    batch = {"images": rng.standard_normal((2, 6, 3, 2)).astype(np.float32),
             "labels": rng.integers(9, size=(2, 6)).astype(np.int32)}
    for k in (1, 2, 3, 6):
        want = JS.device_batch_split(batch, k)
        got = S.device_batch_split(
            {n: torch.from_numpy(v) for n, v in batch.items()}, k)
        for n in batch:
            np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    with pytest.raises(ValueError, match="not divisible by k=4"):
        S.device_batch_split({"x": torch.zeros(2, 6)}, 4)


RULES = ((("fc", "0", "w"), (None, "mp")),
         (("conv", "0", "w"), (None, None, None, "mp")),
         (("attn", "wq"), (None, None, None, "mp")),
         (("mlp", "w_up"), (None, "mp", None)))


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("rules", [None, RULES], ids=["derived", "rules"])
@pytest.mark.parametrize("name", sorted(TREES) + ["qwen2-7b-smoke"])
def test_engine_param_specs_equal_jax(name, mp, rules):
    jtree = _lm_shapes() if name == "qwen2-7b-smoke" else _tree(name)
    want = JR.engine_param_specs(jtree, j_group_mesh(1, 1, mp), rules=rules)
    want = [tuple(s) for s in jax.tree.leaves(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    got = T.leaves(R.engine_param_specs(
        _meta(jtree), {"group": 1, "data": 1, "mp": mp}, rules=rules))
    assert got == want
    assert [R.spec_mp_dim(s, "mp") for s in got] == [
        JR.spec_mp_dim(jax.sharding.PartitionSpec(*s), "mp") for s in want]


def test_engine_param_specs_reject_an_indivisible_rule():
    tree = {"fc": [{"w": torch.empty(5, 3, device="meta")}]}
    with pytest.raises(ValueError, match="does not divide"):
        R.engine_param_specs(tree, {"mp": 2},
                             rules=((("fc", "0", "w"), ("mp", None)),))
    assert R.default_axes({"group": 1, "data": 2, "mp": 2}) == ("mp",
                                                                ("data",))
    with pytest.raises(TypeError, match="not a mesh"):
        R.mesh_axes(3)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_tree(rng):
    return {"params": {"conv": [{"w": rng.standard_normal((3, 2)).astype(
                np.float32), "b": rng.standard_normal(2).astype(np.float32)}],
                       "a/b": rng.standard_normal(4).astype(np.float32),
                       "a\\b": rng.integers(5, size=3).astype(np.int32)},
            "mom": [rng.standard_normal((2, 2)).astype(np.float32)]}


def test_checkpoint_names_equal_jax():
    tree = _ckpt_tree(np.random.default_rng(3))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = JCK._leaf_names(flat)
    assert CK._leaf_names(T.tree_map(torch.from_numpy, tree)) == want
    assert "params/a\\/b" in want and "params/a\\\\b" in want


def test_checkpoints_cross_load_both_ways(tmp_path):
    rng = np.random.default_rng(4)
    tree = _ckpt_tree(rng)
    port = T.tree_map(torch.from_numpy, tree)
    CK.save(tmp_path / "p" / "ckpt_0000003", port, step=3)
    got, step = JCK.restore(tmp_path / "p" / "ckpt_0000003", tree)
    assert step == 3
    assert sorted(np.load(tmp_path / "p" / "ckpt_0000003.npz").files) == \
        sorted(JCK._flatten_with_names(tree))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    other = jax.tree.map(lambda x: x + 1, tree)
    JCK.save(tmp_path / "j" / "ckpt_0000007", other, step=7)
    back, step = CK.restore(tmp_path / "j" / "ckpt_0000007", port)
    assert step == 7
    for a, b in zip(T.leaves(back), jax.tree.leaves(other)):
        assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert CK.latest(tmp_path / "j").name == "ckpt_0000007"
    assert CK.latest(tmp_path / "none") is None


def test_checkpoint_restore_dtype_and_shards(tmp_path):
    w = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    CK.save(tmp_path / "c", {"w": w, "b": torch.ones(3)}, step=1)
    with pytest.raises(ValueError, match="dtype mismatch"):
        CK.restore(tmp_path / "c", {"w": w.double(), "b": torch.ones(3)})
    cast, _ = CK.restore(tmp_path / "c", {"w": w.double(), "b": torch.ones(3)},
                         allow_cast=True)
    assert cast["w"].dtype == torch.float64 and torch.equal(cast["w"],
                                                            w.double())
    with pytest.raises(ValueError, match="shape mismatch"):
        CK.restore(tmp_path / "c", {"w": w[:2], "b": torch.ones(3)})
    for index in range(3):
        part, _ = CK.restore(tmp_path / "c", {"w": w[:, :2], "b": torch.ones(3)},
                             shards={"w": (1, index, 3), "b": None})
        assert torch.equal(part["w"], w[:, 2 * index:2 * index + 2])
        assert part["w"].is_contiguous()
    with pytest.raises(TypeError, match="no numpy dtype"):
        CK.save(tmp_path / "bf", {"w": w.bfloat16()})


# ---------------------------------------------------------------------------
# the reference engine against JAX vmap
# ---------------------------------------------------------------------------

def _port_reference(c, num_devices):
    from repro_torch.engine import Engine
    cfg, params, mom = np_inputs(c["arch"], c["seed"])
    eng = Engine(lambda p, b: C.loss_fn(p, b, cfg), strategy=c["strategy"],
                 num_groups=c["g"], lr=LR, momentum=MU, weight_decay=c["wd"],
                 head_filter=C.head_filter, update_impl="torch",
                 exec_mode="reference", num_devices=num_devices,
                 device="cpu")
    p, _, losses = eng.run(T.tree_map(torch.from_numpy, params),
                           T.tree_map(torch.from_numpy, mom),
                           batches(cfg, c["seed"]), steps=STEPS)
    assert [x.shape for x in eng.shard_losses] == [
        (c["g"], eng._built_step(BATCH // c["g"]).k)] * STEPS
    return [t.numpy() for t in T.leaves(p)], losses


REF_CASES = [case(a, g, 1, 1, wd=wd) for a in ("lenet", "cifarnet")
             for g in (1, 2, 4) for wd in (0.0, WD)]


@pytest.mark.parametrize("c", REF_CASES, ids=[c["name"] for c in REF_CASES])
def test_reference_engine_matches_jax_vmap(c):
    got_p, got_l = _port_reference(c, num_devices=c["g"])
    want_p, want_l = jax_vmap(c)
    np.testing.assert_allclose(got_l, want_l, rtol=TOL, atol=TOL)
    for a, b in zip(got_p, want_p):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_reference_engine_over_k2_shards_matches_jax_vmap():
    c = case("cifarnet", 2, 2, 1, "grouped-scan", wd=WD)
    got_p, got_l = _port_reference(c, num_devices=4)
    want_p, want_l = jax_vmap(c)
    np.testing.assert_allclose(got_l, want_l, rtol=TOL, atol=TOL)
    for a, b in zip(got_p, want_p):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["lenet", "cifarnet"])
def test_weight_decay_cases_see_the_decay(arch):
    """The lambda > 0 parity cases can fail: at ``WD`` the JAX params move
    by more than ten times the parity tolerance against lambda = 0, at the
    least-moved g (1)."""
    with_wd, _ = jax_vmap(case(arch, 1, 1, 1, wd=WD))
    without, _ = jax_vmap(case(arch, 1, 1, 1, wd=0.0))
    moved = max(float(np.abs(a - b).max()) for a, b in zip(with_wd, without))
    assert moved > 10 * TOL, moved
