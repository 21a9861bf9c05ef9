"""Small cells for the CPU tests: the cells' settings and generators at
sizes a test run holds, on the program's plain paths."""
from __future__ import annotations

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(REPO / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.common import Cell  # noqa: E402

LM = {"name": "small-lm", "family": "qwen2", "hidden_size": 64,
      "intermediate_size": 128, "num_attention_heads": 4,
      "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 256,
      "rope_theta": 1e6, "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
      "param_dtype": "float32", "compute_dtype": "bfloat16"}

TRAIN_LIMITS = {"loss_gap": 1e-4, "grad1_gap": 1e-4, "change_gap": 1e-4}


def lm_train_cell(limits=None) -> Cell:
    return Cell.build(
        "small.lm", config=LM,
        traffic={"generator": "token_pool", "batch": 8, "seq": 16, "pool": 5},
        settings={"kind": "train", "strategy": "grouped-fused", "groups": 4,
                  "lr": 0.05, "momentum": 0.3, "update_impl": "torch",
                  "check_steps": 3,
                  "limits": dict(limits or {"loss_gap": 2e-2,
                                            "grad1_gap": 5e-2,
                                            "change_gap": 5e-2})},
        end_to_end=[{"name": "train_round_ms", "unit": "ms"},
                    {"name": "setup_s", "unit": "s"}])


def chat_cell(limit: float = 0.5) -> Cell:
    lm = dict(LM, name="small-lm-served", param_dtype="bfloat16")
    return Cell.build(
        "small.chat", config=lm,
        traffic={"generator": "chat", "rate_per_s": 20.0,
                 "arrival_shape": 1.0,
                 "prompt_tokens": {"mean": 16, "sigma": 0.5, "min": 4,
                                   "max": 40},
                 "gen_tokens": {"mean": 8, "sigma": 0.5, "min": 2,
                                "max": 20}},
        settings={"kind": "serve", "slots": 4, "page_size": 4, "max_seq": 64,
                  "attn_impl": "torch", "prefill_mode": "parallel",
                  "check_requests": 4, "limits": {"logit_gap": limit}},
        end_to_end=[{"name": "ttft_p90_ms", "unit": "ms"},
                    {"name": "tpot_p90_ms", "unit": "ms"},
                    {"name": "setup_s", "unit": "s"}])


def spmd_cell(limits=None) -> Cell:
    """The small LM training cell across 4 ranks, one group a rank."""
    cell = lm_train_cell(limits)
    cell.settings = dict(cell.settings, exec_mode="spmd")
    cell.chips = 4
    return cell


def spmd_rank(rank: int, world: int, port: int, out: str, fault: str,
              seed: int):
    """One CPU rank of the small spmd cell over gloo; rank 0 writes its
    line and checks to ``out``. ``fault="exchange"`` leaves every gather
    between ranks out (each rank sees only its own tensors)."""
    import json
    import torch.distributed as dist
    from harness import report
    if fault == "exchange":
        from repro_torch.engine import spmd

        def local(self, t, group, size, async_op=True):
            self.parts = [t.clone() for _ in range(size)]
            self.work = None
        spmd._Gather.__init__ = local
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        line, checks = report.run_cell(spmd_cell(), seed, 0.3, False,
                                       device="cpu", rank=rank, world=world)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"line": line, "checks": checks}, f)
