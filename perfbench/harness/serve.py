"""The serving runner: ``ContinuousServer.run`` under open-loop arrivals.

Set-up makes the weights in the served type on the card from the seed,
builds the server, and warms the decode step and the prefill buckets
this cell's prompts fall in (and no others). The window is one
``ContinuousServer.run`` over the requests that arrive in ``--seconds``;
it drains the requests still in flight after the last arrival.

The server keeps one clock and, when no slot is busy and the next request
has not arrived, moves that clock on to the arrival instead of sleeping;
nothing runs in between, so no latency changes. The benchmark stamps the
end of every prefill and every decode step on its own clock (after a
synchronize, as the server's own read of the tokens would), and places
each arrival on that clock by the same rule: an admission into an idle
server that its arrival time has not reached yet starts at that arrival.
From those stamps:

- time to first token: arrival to the end of the prefill that produced
  the request's first token;
- time per output token: (last token - first token) / (tokens - 1).

A request that never finishes counts as missing any limit.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import common, judge
from harness.common import clock, quantile
from harness.trace import DeviceTrace

TRACE_SECONDS = 3.0


@dataclasses.dataclass
class Options:
    device: str = "cuda"
    rank: int = 0
    world: int = 1


class Stamps:
    """The benchmark's record of one ``run``: wraps the server's prefill
    and decode step (instance attributes over its methods)."""

    def __init__(self, server, requests, trace: Optional[DeviceTrace],
                 trace_from: float):
        self.server = server
        self.reqs = sorted(requests, key=lambda r: r.arrival)
        self.next = 0
        S = server.spec.num_slots
        self.slot_rid = [-1] * S
        self.left = np.zeros(S, np.int64)
        self.voff = 0.0
        self.t0 = None
        self.first: Dict[int, float] = {}
        self.last: Dict[int, float] = {}
        self.prefills: List[dict] = []
        self.steps: List[dict] = []
        self.trace, self.trace_from = trace, trace_from
        self._prefill = server._prefill
        self._step = server._step
        server._prefill = self.prefill
        server._step = self.step

    def restore(self):
        del self.server._prefill
        del self.server._step

    def now(self, t: float) -> float:
        """Host time -> the server's timeline (seconds from the start)."""
        return t - self.t0 + self.voff

    def _sync(self):
        if self.server.device.type == "cuda":
            torch.cuda.synchronize()

    def prefill(self, table, prompts, plens, admit, gather_pages=None):
        t_in = clock()
        admit_np = admit.cpu().numpy()
        if not self.left.any() and self.next < len(self.reqs):
            a = self.reqs[self.next].arrival
            if self.now(t_in) < a:              # the server moved its clock on
                self.voff = a - (t_in - self.t0)
        out = self._prefill(table, prompts, plens, admit,
                            gather_pages=gather_pages)
        self._sync()
        t = clock()
        plens_in = []
        for s in np.nonzero(admit_np)[0]:
            r = self.reqs[self.next]
            self.next += 1
            self.slot_rid[s] = r.rid
            self.first[r.rid] = self.now(t)
            self.left[s] = r.gen - 1
            plens_in.append(len(r.prompt))
            if self.left[s] == 0:
                self.last[r.rid] = self.now(t)
        self.prefills.append({"t0": t_in, "t1": t, "bucket": prompts.shape[1],
                              "rows": prompts.shape[0], "plens": plens_in})
        return out

    def step(self, table, tokens, pos, active, gather_pages=None):
        t_in = clock()
        tr = self.trace
        if tr is not None and tr.t_end is None:
            # start at trace_from, count from the next step, stop after
            # TRACE_SECONDS: each at a step's start, the device quiet
            if tr.prof is None and self.now(t_in) >= self.trace_from:
                tr.start()
            elif tr.prof is not None and tr.t_mark is None:
                tr.mark()
            elif tr.t_mark is not None and t_in - tr.t_mark >= TRACE_SECONDS:
                tr.stop()
        act = active.cpu().numpy()
        ctx = (pos.cpu().numpy() + 1)[act]
        out = self._step(table, tokens, pos, active, gather_pages)
        self._sync()
        t = clock()
        for s in np.nonzero(act)[0]:
            self.left[s] -= 1
            if self.left[s] == 0:
                self.last[self.slot_rid[s]] = self.now(t)
        self.steps.append({"t0": t_in, "t1": t, "contexts": ctx.tolist()})
        return out


class ServeRun:
    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 opts: Options, t_start: float):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.want_trace, self.opts, self.t_start = trace, opts, t_start
        self.s = cell.settings
        self.device = torch.device(opts.device)

    def run(self) -> Dict:
        from repro_torch.obs import spans
        from repro_torch.serving.engine import ContinuousServer, Request
        s, config, mix = self.s, self.cell.config, self.cell.traffic
        fam = common.family(config)
        cfg = fam.program_config(config)
        self.cfg = cfg
        self.params = fam.params(config, self.seed, self.device, served=True)
        self.requests = common.generator(mix)(mix, config, self.seed,
                                              self.seconds, self.device)
        tracer = spans.Tracer() if self.want_trace else None
        with spans.install(tracer if tracer is not None else spans.current()):
            server = ContinuousServer(
                cfg, self.params, slots=int(s["slots"]),
                page_size=int(s["page_size"]), max_seq=int(s["max_seq"]),
                attn_impl=s["attn_impl"],
                prefill_mode=s["prefill_mode"], device=self.device)
            # the buckets of this run's prompts, the same set every seed
            server.warmup(prompt_lens=sorted({len(r.prompt)
                                              for r in self.requests}))
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            reqs = [Request(rid=r.rid, arrival=r.arrival, prompt=r.prompt,
                            gen=r.gen) for r in self.requests]
            dtrace = DeviceTrace() if self.want_trace else None
            stamps = Stamps(server, self.requests, dtrace,
                            trace_from=0.4 * self.seconds)
            t_setup = clock() - self.t_start
            stamps.t0 = clock()
            report = server.run(reqs)
            t_end = clock()
            if dtrace is not None and dtrace.prof is not None:
                dtrace.stop()
            stamps.restore()
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        served = {int(r): np.asarray(report.tokens[r]) for r in report.rids}
        del server
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ttft, tpot = [], []
        for r in self.requests:
            if r.rid in stamps.first and r.rid in stamps.last \
                    and len(served.get(r.rid, ())) == r.gen:
                ttft.append(stamps.first[r.rid] - r.arrival)
                tpot.append((stamps.last[r.rid] - stamps.first[r.rid])
                            / max(1, r.gen - 1))
            else:
                ttft.append(float("inf"))
                tpot.append(float("inf"))
        failed = sum(1 for x in ttft if not np.isfinite(x))
        e2e = {"setup_s": t_setup, "ttft_p90_ms": 1e3 * quantile(ttft, 0.9),
               "tpot_p90_ms": 1e3 * quantile(tpot, 0.9)}
        return {"end_to_end": e2e, "window_s": t_end - stamps.t0,
                "attempted": len(self.requests), "failed": failed,
                "served": served, "stamps": stamps, "trace": dtrace,
                "tracer": tracer, "peak": peak}

    def judge(self, out: Dict) -> Dict[str, float]:
        """The compared numbers: ``logit_gap``."""
        return {"logit_gap": self.gaps(out)["fp32"]}

    def gaps(self, out: Dict, modes=("fp32",)) -> Dict[str, float]:
        """The widest logit gap a precision mode reads (``judge``)."""
        rids = judge.check_sample(self.requests, out["served"], self.seed,
                                  int(self.s["check_requests"]))
        return judge.served_logit_gap(self.params, self.cell.config,
                                      self.requests, out["served"], rids,
                                      self.device, modes=modes)


Run = ServeRun
