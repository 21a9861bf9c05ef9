"""The port's SPMD grouped step under gloo on the CPU, one and two ranks,
and the launcher across ranks.

- One spawn of two ranks and one of a single rank run their cases through
  ``Engine(exec_mode="spmd")`` and the reference on each rank, as
  ``test_torch_spmd_mesh.py`` does: bitwise params, momentum, losses and
  per-shard losses, at (g, k, mp) in {(2, 1, 1), (1, 2, 1), (1, 1, 2),
  (1, 1, 1)}, both strategies, ``bucket_bytes`` in {0, 1, the default,
  1 << 30}, weight decay 0 and ``WD``; rank 0's lenet and cifarnet runs at
  g = 1 and 2 against the JAX ``Engine(exec_mode="vmap")`` within 1e-4.
- A world of three ranks, larger than the mesh: ``exec_mode="auto"`` at
  g = 2 and ``"spmd"`` at g = 1 with k = 2 (the per-group batch has no
  divisor 3) build the mesh over the first ranks; rank 2 runs no round
  and ends on rank 0's bits, which are the reference's.
- The launcher: ``--exec-mode reference --groups 2`` on one process, and
  ``torchrun`` over two gloo ranks with ``--mp 2`` (storage sharded over
  the "mp" axis) and with ``--groups 2 --ckpt``, whose losses and saved
  params are the single-process reference's; ``--ckpt`` saves, and a run
  resumed from a middle checkpoint ends on the same params bitwise.
"""
import dataclasses
import itertools
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_spmd_mesh import WD, case, check_bitwise, check_jax, spawn

ROOT = pathlib.Path(__file__).resolve().parents[1]

CASES2 = [
    case("lenet", 2, 1, 1),
    case("cifarnet", 2, 1, 1, bucket_bytes=0, wd=WD),
    case("caffenet", 2, 1, 1, "grouped-scan", bucket_bytes=1),
    case("caffenet", 1, 2, 1, "sync", wd=WD),
    case("cifarnet", 1, 2, 1, "grouped-scan", bucket_bytes=1 << 30),
    case("caffenet", 1, 1, 2, bucket_bytes=1),
    case("caffenet", 1, 1, 2, "grouped-scan", bucket_bytes=0, wd=WD),
]
CASES1 = [
    case("lenet", 1, 1, 1),
    case("cifarnet", 1, 1, 1, bucket_bytes=1, wd=WD),
    case("caffenet", 1, 1, 1, "grouped-scan"),
]
CASES3 = [
    case("lenet", 2, 1, 1, exec_mode="auto"),
    case("caffenet", 1, 2, 1, "sync", wd=WD),
]
JAX_CASES = [(w, c) for w, cs in ((2, CASES2), (1, CASES1)) for c in cs
             if c["arch"] in ("lenet", "cifarnet") and c["mp"] == 1
             and c["k"] == 1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {2: spawn(tmp_path_factory.mktemp("spmd2"), 2, CASES2),
            1: spawn(tmp_path_factory.mktemp("spmd1"), 1, CASES1),
            3: spawn(tmp_path_factory.mktemp("spmd3"), 3, CASES3)}


@pytest.mark.parametrize("world,c", [(2, c) for c in CASES2]
                         + [(1, c) for c in CASES1]
                         + [(3, c) for c in CASES3],
                         ids=[c["name"] for c in CASES2 + CASES1 + CASES3])
def test_spmd_bitwise_reference_small_worlds(worlds, world, c):
    check_bitwise(worlds[world], c, world)


@pytest.mark.parametrize("world,c", JAX_CASES,
                         ids=[c["name"] for _, c in JAX_CASES])
def test_spmd_matches_jax_vmap_small_worlds(worlds, world, c):
    check_jax(worlds[world], c)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

ARGV = ["--arch", "lenet", "--smoke", "--device", "cpu", "--conv-impl",
        "lowering", "--update-impl", "torch", "--batch", "8", "--lr", "0.05",
        "--momentum", "0.3"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _reference(steps, groups, ckpt_dir="", every=0):
    """The launcher's workload through ``Engine(exec_mode="reference")``
    in this process: (params, mom, losses)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticImages
    from repro_torch.engine import Engine
    from repro_torch.models import cnn as C
    from repro_torch.optim.sgd import init_momentum
    cfg = dataclasses.replace(C.get_cnn_smoke_config("lenet"),
                              conv_impl="lowering")
    params = C.init_params(torch.Generator().manual_seed(0), cfg)
    data = SyntheticImages(DataConfig(
        batch_size=8, image_size=cfg.image_size, channels=cfg.in_channels,
        num_classes=cfg.num_classes, seed=0))
    eng = Engine(lambda p, b: C.loss_fn(p, b, cfg), num_groups=groups,
                 lr=0.05, momentum=0.3, head_filter=C.head_filter,
                 update_impl="torch", exec_mode="reference", device="cpu",
                 checkpoint_dir=ckpt_dir, checkpoint_every=every)
    return eng, params, init_momentum(params), data


def _losses(stdout):
    return [float(x) for x in re.findall(r"^step +\d+ loss (\S+)", stdout,
                                         re.M)]


def test_launcher_reference_exec_mode_runs(capsys):
    from repro_torch.launch import train
    losses = train.main(ARGV + ["--exec-mode", "reference", "--groups", "2",
                                "--steps", "2"])
    out = capsys.readouterr().out
    assert "exec=reference" in out and len(losses) == 2
    eng, params, mom, data = _reference(2, 2)
    _, _, want = eng.run(params, mom, data.batches(2), steps=2)
    assert losses == want


def _torchrun(extra, tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *ARGV,
         "--exec-mode", "spmd", *extra],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_torchrun_launcher_mp2_runs_sharded_storage(tmp_path):
    stdout = _torchrun(["--groups", "1", "--mp", "2", "--steps", "2"],
                       tmp_path)
    assert "exec=spmd(1x1x2 mesh)" in stdout
    assert stdout.count("final loss") == 1          # rank 0 prints alone
    eng, params, mom, data = _reference(2, 1)
    _, _, want = eng.run(params, mom, data.batches(2), steps=2)
    assert _losses(stdout) == [float(f"{x:.4f}") for x in want]


def test_torchrun_launcher_ckpt_saves_resumes_same_params(tmp_path):
    from repro_torch.checkpoint import checkpointing as CK
    stdout = _torchrun(["--groups", "2", "--steps", "4", "--ckpt",
                        str(tmp_path / "run")], tmp_path)
    assert "exec=spmd(2x1 mesh)" in stdout
    assert "checkpointed to" in stdout
    saved = CK.latest(tmp_path / "run")
    assert saved is not None and saved.name == "ckpt_0000004"
    # one process, 4 rounds with a checkpoint every 2; resume from round 2
    eng, params, mom, data = _reference(4, 2, str(tmp_path / "ref"), 2)
    p4, v4, _ = eng.run(params, mom, data.batches(4), steps=4)
    mid, step = CK.restore(tmp_path / "ref" / "ckpt_0000002",
                           {"params": params, "mom": mom})
    assert step == 2
    eng2, _, _, data2 = _reference(2, 2)
    rp, rv, _ = eng2.run(mid["params"], mid["mom"],
                         itertools.islice(data2.batches(4), 2, None),
                         steps=2)
    got, _ = CK.restore(saved, {"params": params, "mom": mom})
    from repro_torch.core import tree as T
    for a, b, c in zip(T.leaves(got["params"]) + T.leaves(got["mom"]),
                       T.leaves(p4) + T.leaves(v4),
                       T.leaves(rp) + T.leaves(rv)):
        assert torch.equal(a, b) and torch.equal(b, c)
    assert np.isfinite(_losses(stdout)).all()

