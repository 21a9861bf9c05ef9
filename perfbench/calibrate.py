"""Readings that set a cell's limits (the benchmark's own runs do not run
this): the program's compared numbers over many seeds, the control's (the
plain reference one precision below the configuration's, put in the
program's place) and, for a training cell, the planted faults'.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --what program|control|fault|knee [--seconds 4] [--rates 1,2]
        [--out FILE]

``program``: a run of the cell at each seed with a short window (the set-up
rounds are what a training cell compares; a serving cell serves
``--seconds`` of its traffic and compares as many requests as a run does),
printing the numbers compared. For a serving cell each seed's line also
holds the control's reading on the same requests (the token the lower
precision puts first, read against the float32 reference).
``control``: training cells, the reference at the lower precision in the
program's place. ``fault``: training cells, the reference with half of
each group's rows left out (the mean taken over the rest) in the
program's place, and for a cell across ranks also the reference in which
rank 0 exchanged nothing (its own group's gradient in every sub-step).
``knee``: serving cells, the cell's traffic offered at each of
``--rates`` (requests a second) for ``--seconds`` with the first seed,
no comparison: the tails, and the time to first token of the last
quarter of arrivals over the first quarter's, which grows with the queue
above the highest rate the server sustains.
One JSON line a seed (or a rate), to standard output and ``--out``.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import common  # noqa: E402

common.prepare_environment()

LOWER = {"float32": "tf32", "bfloat16": "fp8"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", choices=("program", "control", "fault",
                                       "knee"), default="program")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--rates", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from harness import judge, report
    cell = common.Cell(args.workload)
    common.require_cards(1)
    device = "cuda"
    lower = LOWER[cell.config["compute_dtype"]]
    sink = open(args.out, "a") if args.out else None
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.what == "knee":
        for rate in (float(r) for r in args.rates.split(",")):
            cell.traffic = dict(cell.traffic, rate_per_s=rate)
            _write(sink, knee_row(cell, seeds[0], args.seconds, device))
        return _done()
    for seed in seeds:
        t0 = time.perf_counter()
        row = {"workload": cell.name, "seed": seed, "what": args.what}
        if args.what == "program":
            drv = report.make_runner(cell, seed, args.seconds, False,
                                     device=device)
            out = drv.run()
            if cell.kind == "serve":
                gaps = drv.gaps(out, modes=("fp32", lower))
                row.update({"logit_gap": gaps["fp32"],
                            f"control_{lower}": gaps[lower],
                            "failed": out["failed"],
                            "requests": out["attempted"],
                            "ttft_p90_ms": out["end_to_end"]["ttft_p90_ms"],
                            "tpot_p90_ms": out["end_to_end"]["tpot_p90_ms"]})
            else:
                row.update(drv.judge(out))
            row["peak_bytes"] = out["peak"]
            del drv, out
        else:
            pool = common.generator(cell.traffic)(
                cell.traffic, cell.config, seed, 0.0, device)
            steps = int(cell.settings["check_steps"])
            ref = judge.train_reference(cell, seed, pool, steps, device)
            if args.what == "control":
                other = judge.train_reference(cell, seed, pool, steps, device,
                                              mode=lower)
                row.update(judge.train_numbers(other, ref), mode=lower)
            else:
                other = judge.train_reference(cell, seed, pool, steps, device,
                                              batch_fraction=0.5)
                row.update(judge.train_numbers(other, ref), mode="half-batch")
                if cell.settings.get("exec_mode") == "spmd":
                    other = judge.train_reference(cell, seed, pool, steps,
                                                  device, own_group=0)
                    row["exchange_left_out"] = judge.train_numbers(other, ref)
        row["seconds"] = time.perf_counter() - t0
        _write(sink, row)
    return _done()


def knee_row(cell, seed: int, seconds: float, device) -> dict:
    import numpy as np
    from harness import report
    t0 = time.perf_counter()
    drv = report.make_runner(cell, seed, seconds, False, device=device)
    out = drv.run()
    st = out["stamps"]
    reqs = sorted(drv.requests, key=lambda r: r.arrival)
    ttft = np.array([st.first.get(r.rid, np.inf) - r.arrival for r in reqs])
    q = max(1, len(reqs) // 4)
    row = {"workload": cell.name, "seed": seed, "what": "knee",
           "rate_per_s": cell.traffic["rate_per_s"],
           "requests": out["attempted"], "failed": out["failed"],
           "ttft_p50_ms": 1e3 * float(np.median(ttft)),
           "ttft_p90_ms": out["end_to_end"]["ttft_p90_ms"],
           "tpot_p90_ms": out["end_to_end"]["tpot_p90_ms"],
           "ttft_growth": float(np.mean(ttft[-q:]) / np.mean(ttft[:q])),
           "window_s": out["window_s"], "prefills": len(st.prefills),
           "decode_steps": len(st.steps), "peak_bytes": out["peak"],
           "seconds": time.perf_counter() - t0}
    del drv, out
    return row


def _write(sink, row: dict) -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    line = json.dumps(row)
    print(line, flush=True)
    if sink is not None:
        sink.write(line + "\n")
        sink.flush()


def _done() -> int:
    found = common.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
