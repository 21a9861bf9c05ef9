"""Serving-mode planner: split heterogeneous devices into prefill vs
decode pools against a p50/p99 latency SLO.

The paper's planner (``cluster.planner``) searches ``T(g, alloc) =
HE x SE`` — raw speed times statistical usefulness. Serving transposes
the same tradeoff: raw speed becomes token throughput, statistical
usefulness becomes the fraction of tokens delivered inside the latency
SLO, and their product is **goodput** (``ServeReport.goodput``). The
search axis is no longer g but the pool split: prefill-heavy pools admit
fast but starve decode (queue tail explodes); decode-heavy pools decode
fast but make requests wait for first token.

``simulate_serving`` is the discrete-event validator — the serving
extension of ``cluster.sim.simulate_hetero``: FCFS prefill workers (one
request at a time, service time = prompt/rate) feeding a synchronous
continuous-batching decode pool whose step time grows with occupancy
(``(c0 + occupancy) / pooled-rate`` — a fixed dispatch overhead in
token-equivalents plus one token per live lane, matching how the real
``ContinuousServer`` amortizes a step across lanes). Devices stay black
boxes: only ``tok_rate`` (tokens/s, the measured ``throughput`` field or
a FLOPs-proportional fallback) enters the model.

``plan_serving`` sweeps every split size under both assignment policies
(fastest devices to prefill vs to decode), simulates each, and keeps the
plan with the best goodput at the SLO — p99 breaking ties.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cluster.devices import DeviceSpec

#: tokens/s assigned to a device with neither a measurement nor FLOPs.
_FALLBACK_RATE = 1.0
#: FLOPs-per-token scale for the roofline fallback (arbitrary but fixed;
#: only *relative* rates matter to the split search).
_FLOPS_PER_TOKEN = 1e9


def tok_rate(dev: DeviceSpec) -> float:
    """Black-box serving rate (tokens/s) for one device."""
    if dev.throughput is not None:
        return float(dev.throughput)
    if dev.peak_flops > 0:
        return dev.peak_flops / _FLOPS_PER_TOKEN
    return _FALLBACK_RATE


@dataclasses.dataclass(frozen=True)
class ServingSimResult:
    """Outcome of one simulated trace against one pool split."""
    latencies: np.ndarray        # (R,) finish - arrival, seconds
    queue_waits: np.ndarray      # (R,) wait before a prefill worker
    prefill_times: np.ndarray    # (R,)
    decode_times: np.ndarray     # (R,)
    gen_counts: np.ndarray       # (R,) tokens generated per request
    makespan: float
    occupancy_mean: float

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.latencies, q))

    @property
    def throughput(self) -> float:
        return float(self.gen_counts.sum()) / max(self.makespan, 1e-12)

    def goodput(self, slo_s: float) -> float:
        ok = self.latencies <= slo_s
        return float(self.gen_counts[ok].sum()) / max(self.makespan, 1e-12)


def simulate_serving(*, arrivals: Sequence[float],
                     prompt_lens: Sequence[int], gen_lens: Sequence[int],
                     prefill_rates: Sequence[float],
                     decode_rates: Sequence[float],
                     slots: int = 8, step_overhead_tokens: float = 1.0
                     ) -> ServingSimResult:
    """Discrete-event run of one trace through a prefill pool + a
    continuous-batching decode pool (module docstring).

    ``prefill_rates`` / ``decode_rates``: tokens/s per pool member.
    Decode is synchronous-stepped: a step at occupancy ``o`` takes
    ``(step_overhead_tokens + o) / sum(decode_rates)`` seconds and
    advances every live lane one token; lanes join at step boundaries
    and retire the step their generation completes.
    """
    R = len(arrivals)
    if not (len(prompt_lens) == len(gen_lens) == R):
        raise ValueError("arrivals/prompt_lens/gen_lens must align")
    if not prefill_rates or not decode_rates:
        raise ValueError("both pools need at least one device")
    if min(gen_lens) < 1:
        raise ValueError("every request must generate at least one token")
    if slots < 1:
        raise ValueError("need at least one decode slot")
    pool_rate = float(sum(decode_rates))

    # -- prefill: FCFS over parallel workers --------------------------------
    # (worker_free_time, seq, rate); arrival order is FCFS order.
    workers = [(0.0, i, float(r)) for i, r in enumerate(prefill_rates)]
    heapq.heapify(workers)
    order = np.argsort(np.asarray(arrivals, dtype=np.float64), kind="stable")
    ready = []                                    # (ready_time, seq, req idx)
    q_wait = np.zeros(R)
    pf_time = np.zeros(R)
    for seq, i in enumerate(order):
        free_t, wid, rate = heapq.heappop(workers)
        start = max(float(arrivals[i]), free_t)
        dur = float(prompt_lens[i]) / rate
        heapq.heappush(workers, (start + dur, wid, rate))
        q_wait[i] = start - float(arrivals[i])
        pf_time[i] = dur
        heapq.heappush(ready, (start + dur, seq, int(i)))

    # -- decode: synchronous continuous batching ----------------------------
    finish = np.zeros(R)
    dec_start = np.zeros(R)
    t = 0.0
    lanes: List[Tuple[int, int]] = []             # (req idx, tokens left)
    occ_num = 0.0
    occ_den = 0.0
    while ready or lanes:
        if not lanes:                             # idle: jump to next ready
            t = max(t, ready[0][0])
        while ready and len(lanes) < slots and ready[0][0] <= t:
            _, _, i = heapq.heappop(ready)
            dec_start[i] = t
            lanes.append((i, int(gen_lens[i])))
        occ = len(lanes)
        dt = (step_overhead_tokens + occ) / pool_rate
        t += dt
        occ_num += occ * dt
        occ_den += dt
        nxt = []
        for i, left in lanes:
            if left - 1 == 0:
                finish[i] = t
            else:
                nxt.append((i, left - 1))
        lanes = nxt

    lat = finish - np.asarray(arrivals, dtype=np.float64)
    return ServingSimResult(
        latencies=lat, queue_waits=q_wait, prefill_times=pf_time,
        decode_times=finish - dec_start,
        gen_counts=np.asarray(gen_lens, dtype=np.int64),
        makespan=float(finish.max(initial=0.0)),
        occupancy_mean=occ_num / occ_den if occ_den else 0.0)


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """One scored pool split."""
    prefill_devices: Tuple[DeviceSpec, ...]
    decode_devices: Tuple[DeviceSpec, ...]
    policy: str                  # "fast-prefill" | "fast-decode"
    slo_p99_s: float
    result: ServingSimResult
    goodput: float               # tokens/s inside the SLO
    meets_slo: bool              # p99 <= slo_p99_s

    def describe(self) -> str:
        def mix(devs):
            kinds = [d.kind for d in devs]
            return "+".join(f"{kinds.count(k)}{k}" for k in sorted(set(kinds)))
        r = self.result
        return (f"serving plan [{self.policy}]: "
                f"prefill={mix(self.prefill_devices)} "
                f"decode={mix(self.decode_devices)} "
                f"goodput={self.goodput:.1f} tok/s "
                f"p50={r.percentile(50) * 1e3:.1f}ms "
                f"p99={r.percentile(99) * 1e3:.1f}ms "
                f"(slo {self.slo_p99_s * 1e3:.0f}ms "
                f"{'met' if self.meets_slo else 'MISSED'}) "
                f"occ={r.occupancy_mean:.2f}")


def plan_serving(devices: Sequence[DeviceSpec], *,
                 arrivals: Sequence[float], prompt_lens: Sequence[int],
                 gen_lens: Sequence[int], slo_p99_s: float,
                 slots: int = 8, step_overhead_tokens: float = 1.0
                 ) -> ServingPlan:
    """Search every prefill/decode split of ``devices`` (both directions
    of the sorted-by-rate assignment), simulate the trace through each,
    and return the plan with the highest goodput at the p99 SLO — p99
    latency breaking ties. Raises when fewer than two devices (each pool
    needs one)."""
    if len(devices) < 2:
        raise ValueError("plan_serving needs >= 2 devices (one per pool)")
    ranked = sorted(devices, key=tok_rate, reverse=True)
    best: Optional[ServingPlan] = None
    for k in range(1, len(ranked)):               # k = prefill pool size
        for policy in ("fast-prefill", "fast-decode"):
            if policy == "fast-prefill":
                pf, dec = ranked[:k], ranked[k:]
            else:
                dec, pf = ranked[:len(ranked) - k], ranked[len(ranked) - k:]
            res = simulate_serving(
                arrivals=arrivals, prompt_lens=prompt_lens,
                gen_lens=gen_lens,
                prefill_rates=[tok_rate(d) for d in pf],
                decode_rates=[tok_rate(d) for d in dec],
                slots=slots, step_overhead_tokens=step_overhead_tokens)
            plan = ServingPlan(
                prefill_devices=tuple(pf), decode_devices=tuple(dec),
                policy=policy, slo_p99_s=slo_p99_s, result=res,
                goodput=res.goodput(slo_p99_s),
                meets_slo=res.percentile(99) <= slo_p99_s)
            if (best is None or plan.goodput > best.goodput
                    or (plan.goodput == best.goodput
                        and plan.result.percentile(99)
                        < best.result.percentile(99))):
                best = plan
    assert best is not None
    return best
