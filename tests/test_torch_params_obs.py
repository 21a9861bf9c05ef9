"""Port parity: ``launch/params_util.py`` over ``launch/steps.params_specs``,
the run stamp's comparability rule (``obs.meta.STRICT_KEYS``,
``env_mismatches``), ``engine.timing.TimeStats.row`` and
``launch/train.py --trace-out`` against the JAX package.

- ``param_count``, ``param_bytes`` and ``active_param_count`` of the
  port's meta tree equal the JAX values on ``jax.eval_shape(init_params)``
  for every arch of ``configs/`` at full size, exactly; neither side
  allocates;
- ``env_mismatches`` and ``TimeStats.row`` give the JAX answers on the same
  inputs (``tests/test_obs.py``'s stamp test, mirrored);
- the launcher's Chrome trace of smoke lenet has the JAX launcher's span
  names (the autotune spans, which only the card's kernel arm emits, and
  the grouped round's ``round.*`` spans, which only the port has, apart)
  and, on ``--replay-trace``, its commit events. The JAX launcher
  runs ``--exec-mode vmap``: the test session forces 8 host devices, under
  which its "auto" goes SPMD (ROADMAP Queue C).
"""
import jax
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs
from repro.engine import timing as JT
from repro.launch import params_util as JPU
from repro.launch import steps as JS
from repro.obs import meta as JM
from repro_torch.configs import get_config
from repro_torch.core import queue_sim
from repro_torch.core import tree as T
from repro_torch.engine import timing
from repro_torch.launch import params_util as PU
from repro_torch.launch import steps
from repro_torch.obs import meta
from repro_torch.obs.chrome_trace import PID_EXEC, load_span_names


# ---------------------------------------------------------------------------
# parameter counts at full size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_match_jax_eval_shape(arch):
    cfg = get_config(arch)
    specs = steps.params_specs(cfg)
    assert all(leaf.is_meta for leaf in T.leaves(specs))
    j_cfg = j_get_config(arch)
    j_specs = JS.params_specs(j_cfg)
    assert len(T.leaves(specs)) == len(jax.tree.leaves(j_specs))
    assert PU.param_count(specs) == JPU.param_count(j_specs)
    assert PU.param_bytes(specs) == JPU.param_bytes(j_specs)
    assert PU.active_param_count(specs, cfg) == \
        JPU.active_param_count(j_specs, j_cfg)
    if cfg.moe is not None:
        assert PU.active_param_count(specs, cfg) < PU.param_count(specs)


def test_params_specs_are_init_params_shapes():
    """The meta tree is ``init_params``'s: same paths, shapes and dtypes
    (smoke size, where the real init is cheap)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as M
    for arch in ("qwen2-moe-a2.7b", "recurrentgemma-2b", "whisper-base"):
        cfg = get_smoke_config(arch)
        real = M.init_params(torch.Generator().manual_seed(0), cfg)
        spec = steps.params_specs(cfg)
        got = [(p, tuple(x.shape), x.dtype) for p, x in
               T.leaves_with_path(spec)]
        want = [(p, tuple(x.shape), x.dtype) for p, x in
                T.leaves_with_path(real)]
        assert got == want


# ---------------------------------------------------------------------------
# run stamps and timing rows
# ---------------------------------------------------------------------------

def test_run_metadata_and_mismatches():
    md = meta.run_metadata("cpu", extra={"arch": "lenet"},
                           mesh_shape=(2, 4))
    for key in (*meta.STRICT_KEYS, "python", "machine"):
        assert key in md
    assert meta.STRICT_KEYS[0] == "torch"
    assert md["mesh_shape"] == "2x4" and md["arch"] == "lenet"
    other = dict(md, torch="99.0", device_count=md["device_count"] + 1)
    mism = meta.env_mismatches(md, other)
    assert len(mism) == 2 and any("torch" in m for m in mism)
    assert meta.env_mismatches(md, dict(md)) == ()
    assert meta.env_mismatches(None, md) == ()   # a baseline with no stamp
    assert meta.env_mismatches(md, {}) == ()
    assert "mesh_shape" not in meta.run_metadata("cpu")


@pytest.mark.parametrize("which", ["port", "jax", "backend"])
def test_env_mismatches_give_the_jax_answers(which):
    """The port's defaults (its ``STRICT_KEYS``), and any keys passed, give
    what the JAX ``env_mismatches`` gives on the same stamps."""
    keys = {"port": meta.STRICT_KEYS, "jax": JM.STRICT_KEYS,
            "backend": ("backend",)}[which]
    base = meta.run_metadata("cpu", mesh_shape=(4, 1))
    cases = [dict(base), dict(base, torch="0.0"), dict(base, cuda="12.9"),
             dict(base, device_kind="NVIDIA H100 80GB HBM3",
                  backend="cuda"),
             {k: v for k, v in base.items() if k != "device_count"},
             dict(base, jax="0.4", device_count=8), {}, None]
    for fresh in cases:
        for a, b in ((base, fresh), (fresh, base)):
            got = (meta.env_mismatches(a, b) if which == "port"
                   else meta.env_mismatches(a, b, keys=keys))
            assert got == JM.env_mismatches(a, b, keys=keys)


def test_timestats_row_gives_the_jax_row():
    samples = [3e-3, 1e-3, 2.5e-3, 7e-3, 1.25e-3]
    got, want = timing.stats_of(samples), JT.stats_of(samples)
    assert got.row() == want.row()
    assert got.row(1e3) == want.row(1e3)
    assert set(got.row()) == {"min_us", "median_us", "iqr_us", "iters"}


# ---------------------------------------------------------------------------
# launch/train.py --trace-out
# ---------------------------------------------------------------------------

ARGV = ["--arch", "lenet", "--smoke", "--batch", "8", "--lr", "0.05",
        "--momentum", "0.3"]


def _trace(path):
    import json
    names = {n for n in load_span_names(path)
             if not n.startswith(("autotune.", "commit "))}
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    commits = [e for e in events if e.get("pid") == PID_EXEC
               and e.get("ph") == "X"]
    return names, len(commits)


ROUND_SPANS = ("round.grad", "round.stack", "round.update")


@pytest.mark.parametrize("replay", [False, True])
def test_trace_out_has_the_jax_launchers_spans(tmp_path, replay):
    from repro.launch import train as JTR
    from repro_torch.launch import train as TR
    from repro_torch.obs import validate
    argv = ARGV + ["--steps", "4", "--groups", "2"]
    if replay:
        path = tmp_path / "trace.npz"
        queue_sim.simulate(g=2, t_conv=1.0, t_fc=0.1, iters=8, seed=0,
                           return_trace=True)[1].save(path)
        argv += ["--replay-trace", str(path)]
    jpath, path = tmp_path / "jax.json", tmp_path / "port.json"
    JTR.main(argv + ["--exec-mode", "vmap", "--trace-out", str(jpath)])
    TR.main(argv + ["--device", "cpu", "--conv-impl", "lowering",
                    "--update-impl", "torch", "--trace-out", str(path),
                    "--metrics-out", str(tmp_path / "m.jsonl")])
    names, commits = _trace(path)
    want_names, want_commits = _trace(jpath)
    spans = ["engine.replay"] if replay else ["engine.run", "engine.step"]
    # the port's grouped round has spans of its own inside engine.dispatch
    assert names - set(ROUND_SPANS) == want_names and set(spans) <= names
    assert commits == want_commits == (4 if replay else 0)
    assert validate.check_trace(path, spans) == []
    assert validate.check_metrics(tmp_path / "m.jsonl", ["step_s"]) == []
