"""``correct`` is decided by a comparison that fails when it should.

Each test drives the rest of a run (skipping the look for a card) on a
small cell on the CPU, through the program's plain paths, with the timed
path broken underneath: a step that returns its state unchanged; half of
each group's rows left out, the mean taken over the rest; a served token
altered where it is produced. ``correct`` has to come out false, and true
on the same cells unbroken. The controls, the plain reference one
precision below the configuration's in the program's place, have to fail
the small cells' limits too.
"""
from __future__ import annotations

import subprocess
import sys

import pytest
import torch

import perfbench_small_cells as S

from harness import common, judge, report

SEED = 2 ** 31 + 99


def _run(cell, seconds=0.3):
    line, checks = report.run_cell(cell, SEED, seconds, False, device="cpu")
    return line, checks


def test_sound_training_run_is_correct():
    cell = S.lm_train_cell()
    line, checks = _run(cell)
    assert line["correct"], checks
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert line["attempted"] >= 6 and line["failed"] == 0


def test_traced_run_reads_its_metrics():
    """A ``--trace 1`` run: the per-layer readers of the training cells on
    the small cell, the device's busy and window seconds, the breakdown."""
    from harness.common import benchmark
    cell = S.lm_train_cell()
    cell.per_layer = [m for m in benchmark()["per_layer"]
                      if "qwen2-7b.train-g4" in m["workloads"]]
    line, checks = report.run_cell(cell, SEED, 0.5, True, device="cpu")
    assert line["correct"], checks
    # no device on the CPU: the host-side readers read, the device ones
    # find nothing and are left out
    assert {"data_wait_ms.train", "mfu.train"} <= set(line["metrics"])
    assert "update_roofline.train" not in line["metrics"]
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_sound_serving_run_is_correct():
    line, checks = _run(S.chat_cell(limit=0.05), seconds=1.0)
    assert line["correct"], checks
    assert line["failed"] == 0 and line["attempted"] == 20
    assert set(line["metrics"]) == {"ttft_p90_ms", "tpot_p90_ms", "setup_s"}


def test_state_left_unchanged_fails(monkeypatch):
    from repro_torch.core import async_sgd

    def unchanged(params, grads, mom, **kw):
        return params, mom
    monkeypatch.setattr(async_sgd, "apply_grouped_update", unchanged)
    line, checks = _run(S.lm_train_cell())
    assert not line["correct"]
    assert checks["change_gap"][0] == pytest.approx(1.0)


def test_half_batch_left_out_fails(monkeypatch):
    from repro_torch.engine import strategies
    split = strategies.group_batch_split

    def half(batch, g, sizes=None):
        out = split(batch, g, sizes=sizes)
        return {k: v[:, :max(1, v.shape[1] // 2)] for k, v in out.items()}
    monkeypatch.setattr(strategies, "group_batch_split", half)
    line, checks = _run(S.lm_train_cell())
    assert not line["correct"], checks


def test_served_token_altered_fails(monkeypatch):
    from repro_torch.serving.engine import ContinuousServer
    step = ContinuousServer._step
    calls = {"n": 0}

    def altered(self, *args, **kw):
        tok = step(self, *args, **kw)
        calls["n"] += 1
        if calls["n"] % 3 == 0:
            tok = (tok + 1) % self.cfg.vocab_size
        return tok
    monkeypatch.setattr(ContinuousServer, "_step", altered)
    line, checks = _run(S.chat_cell(limit=0.05), seconds=1.0)
    assert not line["correct"], checks


def test_training_control_fails():
    """The reference at fp8, put in the program's place, against the
    float32 reference: some number over its limit."""
    cell = S.lm_train_cell()
    pool = common.generator(cell.traffic)(cell.traffic, cell.config, SEED,
                                          0.0, "cpu")
    ref = judge.train_reference(cell, SEED, pool, 3, "cpu")
    ctl = judge.train_reference(cell, SEED, pool, 3, "cpu", mode="fp8")
    numbers = judge.train_numbers(ctl, ref)
    limits = cell.settings["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


def test_serving_control_fails():
    """The token the fp8 reference puts first, read against the float32
    reference, over the requests a run compares."""
    cell = S.chat_cell(limit=0.05)
    drv = report.make_runner(cell, SEED, 1.0, False, device="cpu")
    out = drv.run()
    gaps = drv.gaps(out, modes=("fp32", "fp8"))
    assert gaps["fp32"] <= cell.settings["limits"]["logit_gap"]
    assert gaps["fp8"] > cell.settings["limits"]["logit_gap"], gaps


def test_run_loads_no_jax():
    """A whole small run in a fresh process leaves no JAX module and not
    the JAX package in ``sys.modules``."""
    code = ("import sys; sys.path.insert(0, 'perfbench/tests');"
            "import perfbench_small_cells as S;"
            "from harness import common, report;"
            "report.run_cell(S.lm_train_cell(), 5, 0.2, False, device='cpu');"
            "print(common.forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=S.REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run on the card only")


@pytest.mark.gpu
def test_cell_on_the_card_is_correct(card):
    from harness.common import Cell
    line, checks = report.run_cell(Cell("qwen2-7b.train-g4"), SEED, 2.0,
                                   False, device="cuda")
    assert line["correct"], checks


def _spmd(tmp_path, fault: str):
    import json
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "rank0.json")
    mp.start_processes(S.spmd_rank, args=(4, port, out, fault, SEED),
                       nprocs=4, join=True, start_method="spawn")
    with open(out) as f:
        return json.load(f)


def test_spmd_sound_and_exchange_left_out(tmp_path):
    """Four gloo ranks, one group each: correct as it stands, not
    correct with the exchange between ranks left out."""
    sound = _spmd(tmp_path, "")
    assert sound["line"]["correct"], sound["checks"]
    broken = _spmd(tmp_path, "exchange")
    assert not broken["line"]["correct"], broken["checks"]
