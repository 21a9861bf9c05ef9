"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. The cell is found by name in
``BENCHMARK.json``; its configuration, traffic mix, settings and metric
readers by name under ``perfbench/`` (``harness.common.Cell``). The
runner is the cell's ``kind``, ``harness/<kind>.py``: ``train`` or
``serve``. A cell on several cards starts one process a card
(``torch.distributed`` over NCCL, a free localhost port); rank 0 prints.

Without the cards the cell asks for, the run exits with code 3 and prints
no result. With ``--trace 0`` the line holds the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, the device's busy and
window seconds and the trace's breakdown. ``correct`` comes from the
plain reference, run after the window (``harness.judge``); every number
compared is printed with its limit, last, on standard error and under
the line's ``checks``.
"""
from __future__ import annotations

import argparse
import datetime
import os
import socket
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import common  # noqa: E402

common.prepare_environment()


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    args = parse(argv)
    cell = common.Cell(args.workload)
    common.require_cards(cell.chips)
    if cell.chips == 1:
        line, checks = execute(cell, args, rank=0, world=1)
    else:
        line, checks = spawn(cell, args)
    found = common.forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    common.emit(line, checks)
    return 0


def spawn(cell, args):
    """Ranks 1.. as child processes, rank 0 in this process; waits for
    every child."""
    import torch.multiprocessing as mp
    os.environ["MASTER_ADDR"] = "localhost"
    os.environ["MASTER_PORT"] = str(_free_port())
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, cell.chips, vars(args)))
             for r in range(1, cell.chips)]
    for p in procs:
        p.start()
    try:
        return execute(cell, args, rank=0, world=cell.chips)
    finally:
        for p in procs:
            p.join(timeout=300)
            if p.is_alive():
                p.terminate()
                p.join()


def _rank_main(rank: int, world: int, args: dict):
    common.prepare_environment()
    cell = common.Cell(args["workload"])
    execute(cell, argparse.Namespace(**args), rank=rank, world=world)


def execute(cell, args, rank: int, world: int):
    """One rank's run -> (result line, checks) (rank 0's are printed)."""
    import torch
    from harness import report
    if world > 1:
        import torch.distributed as dist
        torch.cuda.set_device(rank)
        dist.init_process_group(
            "nccl", init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=300))
    try:
        return report.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), device=f"cuda:{rank}",
                               rank=rank, world=world, t_start=T_START)
    finally:
        if world > 1:
            import torch.distributed as dist
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
