"""The yardstick's counts agree with hand reckonings from the shapes:
Qwen2-7B's 15.23 GB of bf16 weights, the 4-layer training model's 2.022e9
parameters, a round's FLOPs, a decode step's bytes, B5's work."""
from __future__ import annotations

import json

import pytest

from perfbench_small_cells import BENCH

from roofline import counts

QWEN = json.loads((BENCH / "configs" / "qwen2-7b.json").read_text())
QWEN4 = json.loads((BENCH / "configs" / "qwen2-7b-4l.json").read_text())
Q = counts.of(QWEN)


def test_qwen2_weights_and_round():
    assert Q.params(QWEN4) == pytest.approx(2.022e9, rel=2e-3)
    # the bf16 weights, 15.23 GB, less the embedding table a step gathers
    # a few rows of
    embed = 2 * 3584 * 152064
    assert 2 * Q.matmul_params(QWEN) + embed == pytest.approx(15.23e9,
                                                             rel=1e-3)
    # a 16 x 512 round: 6 x matmul params per token plus attention
    flops = Q.train_round_flops(QWEN4, {"batch": 16, "seq": 512})
    assert flops == pytest.approx(
        3 * (2 * 8192 * Q.matmul_params(QWEN4)
             + 16 * 4 * 2 * 28 * 128 * 512 ** 2))


def test_qwen2_serving_work():
    fl, nb = Q.decode_step_work(QWEN, [100, 200])
    assert nb > 2 * Q.matmul_params(QWEN)
    assert fl == pytest.approx(2 * 2 * Q.matmul_params(QWEN)
                               + 28 * 4 * 28 * 128 * 300)
    assert Q.paged_bytes(QWEN, [100]) == pytest.approx(
        28 * (2 * 4 * 128 * 2 * 100 + 2 * 28 * 128 * 2))
    fl5, nb5 = Q.flash_work(QWEN, 16, 256)
    assert fl5 == pytest.approx(28 * 16 * 2 * 28 * 128 * 256 ** 2)
    assert nb5 == pytest.approx(28 * 16 * 256 * (2 * 28 + 2 * 4) * 128 * 2)


def test_update_bytes():
    # B1 over the 4-layer model at g = 4: (4 + 4) x 2.022e9 x 4 B
    nbytes = counts.update_bytes(Q.params(QWEN4), 4)
    assert nbytes == pytest.approx(64.7e9, rel=2e-3)


def test_peaks_table_has_reasons():
    table = json.loads((BENCH / "roofline" / "peaks.json").read_text())
    for name, p in table["peaks"].items():
        assert p["value"] > 0 and p["why"], name
    assert counts.flop_peak("bfloat16") == 989e12
    assert counts.bound_s(989e12, 0.0, 989e12) == pytest.approx(1.0)
    assert counts.bound_s(0.0, 3.35e12, 989e12) == pytest.approx(1.0)
