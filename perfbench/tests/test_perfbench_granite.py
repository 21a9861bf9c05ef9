"""The Granite 4.0-H family (``granitemoehybrid``) in the benchmark: its
configuration file, its counts against hand reckonings from the
published shapes, its plain reference against the program's plain path,
and ``correct`` on a small chat cell of the family on the CPU: true as the
program stands, false with a slot's state left unreset at admission or a
served token altered, and the fp8 control over the cell's limit.

The small cell computes in float32, where the sound program reads a gap
of 0.0 against the reference on every request: in bfloat16 its rounding
moves near-tied tokens by as much as a stale state does at this size.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from perfbench_small_cells import BENCH, REPO, chat_cell

from harness import common, report
from harness.common import Cell
from roofline import counts

SEED = 2 ** 31 + 99
CELL = "granite-4.0-h-small-20l.chat"
GRANITE = json.loads((BENCH / "configs" / "granite-4.0-h-small-20l.json")
                     .read_text())
FAM = common.family(GRANITE)
REF = common.reference(GRANITE)
R = counts.of(GRANITE)
SMALL = dict(GRANITE, name="small-granite", hidden_size=64,
             num_attention_heads=4, num_key_value_heads=2,
             intermediate_size=32, shared_intermediate_size=48,
             num_local_experts=8, num_experts_per_tok=3, mamba_n_heads=8,
             mamba_d_head=16, mamba_d_state=8, mamba_chunk_size=8,
             vocab_size=256, num_hidden_layers=6, attention_multiplier=1 / 16,
             param_dtype="float32", compute_dtype="float32")
LIMIT = 3e-4


def granite_chat_cell() -> Cell:
    """``chat_cell``'s traffic and settings on the small Granite, every
    finished request compared."""
    base = chat_cell()
    return Cell.build(
        "small.granite-chat", config=SMALL, traffic=base.traffic,
        settings=dict(base.settings, check_requests=20,
                      limits={"logit_gap": LIMIT}),
        end_to_end=base.end_to_end)


def test_configuration_file_is_the_published_one_cut_in_depth():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = [c for c in bench["configs"]
             if c["name"] == GRANITE["name"]][0]
    assert entry["reduced"] == GRANITE["reduced"] == ["num_hidden_layers"]
    assert GRANITE["num_hidden_layers"] == 20
    kinds = GRANITE["layer_types"]
    assert len(kinds) == 40 and [i for i, k in enumerate(kinds)
                                 if k == "attention"] == [5, 15, 25, 35]
    assert kinds[:20] == kinds[20:]              # two stages alike
    for key in ("hidden_size", "intermediate_size", "mamba_d_head",
                "mamba_d_state", "num_experts_per_tok",
                "num_local_experts", "vocab_size"):
        assert key not in GRANITE["reduced"]
    cell = Cell(CELL, bench)
    assert cell.kind == "serve" and cell.chips == 1
    assert cell.traffic["generator"] == "chat"
    assert [m["name"] for m in cell.per_layer][-1] == "moe_live_share.serve"


def test_counts_agree_with_the_published_shapes():
    full = dict(GRANITE, num_hidden_layers=40)
    # per layer: 72 experts 679.5M, the shared expert 18.9M, the Mamba
    # mixer 102.3M; all 40 layers and the embedding: 32.2B
    assert 72 * R.expert_params(GRANITE) == pytest.approx(679.5e6, rel=1e-3)
    assert R.params(full) == pytest.approx(32.2e9, rel=2e-3)
    assert R.params(GRANITE) == pytest.approx(16.31e9, rel=2e-3)
    # a token's active weights: 18 Mamba and 2 attention layers with
    # their top-10 experts, and the head
    m = R.dims(GRANITE)
    assert (m["n_m"], m["n_a"]) == (18, 2)
    assert R.layer_matmul_params(GRANITE, "mamba") - \
        R.layer_matmul_params(GRANITE, "attention") == \
        4096 * 16768 + 8192 * 4096 - (4096 * 48 * 128 + 4096 * 4096)
    # a decode step of 32 live rows: nearly every expert is then live (1 -
    # (62 / 72) ** 32 = 0.9916); the step reads those of 20 layers, the
    # fp32 state and bf16 conv tail of 32 rows both ways (2 x 2.42 GB),
    # the bf16 Mamba mixers with their conv taps, the attention layers,
    # the shared experts and the head, the fp32 routers, and the K/V
    fl, nb = R.decode_step_work(GRANITE, [100] * 32)
    assert R.live_experts(GRANITE, 32) == pytest.approx(72 * 0.99161,
                                                        rel=1e-4)
    experts = 2 * 20 * R.live_experts(GRANITE, 32) * R.expert_params(GRANITE)
    state = 2 * 18 * 32 * (4 * 128 * 64 * 128 + 2 * 3 * 8448)
    assert R.state_bytes(GRANITE, 32) == pytest.approx(state)
    dense = 2 * (18 * (4096 * 16768 + 8192 * 4096 + 4 * 8448)
                 + 2 * (4096 * 48 * 128 + 4096 * 4096)
                 + 20 * 3 * 4096 * 1536 + 4096 * 100352) \
        + 4 * 20 * 4096 * 72
    assert nb == pytest.approx(experts + state + dense
                               + R.paged_bytes(GRANITE, [100] * 32))
    assert fl > 2 * 32 * R.matmul_params(GRANITE)
    assert R.paged_bytes(GRANITE, [100]) == pytest.approx(
        2 * (2 * 8 * 128 * 2 * 100 + 2 * 32 * 128 * 2))
    fl5, nb5 = R.flash_work(GRANITE, 16, 256)
    assert fl5 == pytest.approx(2 * 16 * 2 * 32 * 128 * 256 ** 2)
    assert nb5 == pytest.approx(2 * 16 * 256 * (2 * 32 + 2 * 8) * 128 * 2)


def test_reference_matches_the_program():
    from repro_torch.models import transformer as M
    params = FAM.params(SMALL, SEED, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        SMALL["vocab_size"], size=(2, 16)))
    want, _, _ = M.forward(params, {"tokens": toks},
                           FAM.program_config(SMALL))
    out = REF.sequence_logits(params, [toks[0], toks[1, :9]], SMALL,
                              modes=("fp32", "fp8"))
    torch.testing.assert_close(out["fp32"][0], want[0], atol=2e-6,
                               rtol=1e-5)
    torch.testing.assert_close(out["fp32"][1], want[1, :9], atol=2e-6,
                               rtol=1e-5)
    assert float((out["fp8"][0] - want[0]).abs().max()) > 1e-4


def _run(cell, trace=False):
    return report.run_cell(cell, SEED, 1.0, trace, device="cpu")


def test_sound_run_is_correct_and_reads_the_expert_share():
    cell = granite_chat_cell()
    cell.per_layer = [m for m in common.benchmark()["per_layer"]
                      if m["name"] == "moe_live_share.serve"]
    line, checks = _run(cell, trace=True)
    assert line["correct"], checks
    assert line["failed"] == 0 and line["attempted"] == 20
    assert checks["logit_gap"][0] == 0.0
    share = line["metrics"]["moe_live_share.serve"]["value"]
    assert 0 < share <= 100


def test_expert_share_reads_nothing_without_the_programs_record():
    read = common.load_reader("moe_live_share.serve")
    ctx = report.Context(cell=None, out={}, trace=None, spans=())
    assert read(ctx) is None


def test_state_left_unreset_fails(monkeypatch):
    from repro_torch.serving.engine import ContinuousServer
    monkeypatch.setattr(ContinuousServer, "_reset_state",
                        lambda self, slots, rids: None)
    line, checks = _run(granite_chat_cell())
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
    line, checks = _run(granite_chat_cell())
    assert not line["correct"], checks


def test_serving_control_fails():
    cell = granite_chat_cell()
    drv = report.make_runner(cell, SEED, 1.0, False, device="cpu")
    out = drv.run()
    gaps = drv.gaps(out, modes=("fp32", "fp8"))
    assert gaps["fp32"] <= LIMIT < gaps["fp8"], gaps
