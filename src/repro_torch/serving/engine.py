"""Continuous-batching serving loop over the paged KV cache.

Port of the JAX package's ``serving/engine.py``. One decode step at a
fixed batch width (= slots) serves a changing request population —
requests are admitted into free slots as they arrive (queue), prefilled,
decoded one token per step, and retired the step their generation
completes, returning their pages to the pool. Slot membership is data
(page tables, position vector, active mask), not shape. The JAX version
compiles one step per gather width and prefill bucket; the port runs
eagerly, so ``warmup`` builds the kernels and primes the allocator and
the math libraries instead, and pool updates happen in place where JAX
donates the pool. On the card at ``attn_impl="cuda"`` the decode step's
shapes never change (S slots, one token, the full table walked
in-kernel), so ``warmup`` also records one step and its argmax as a CUDA
graph (``decode.DecodeGraph``) and every decode step after copies its
operands in and replays it: one launch where the eager step enqueues
every layer's kernels one by one. The gather arms (their width follows
the bucket ladder) and the CPU run the eager step; the graph is a
recording of it, not a second definition.

A family with recurrent state (hybrid_moe, Granite 4.0-H) keeps it per
slot beside the pool (``paged_cache.init_state``). Admission zeroes the
admitted slots' state (a ``serve.state_reset`` instant); the parallel
prefill runs the admitted slots' rows alone, from that state, and hands
each the state at its prompt's last token; decode advances the active
slots' state. Its work is then the admitted prompts', and on the card
each (lanes, bucket) shape replays a graph of its own, recorded at
``warmup``. Its MoE is dropless and routes no padded row or empty slot;
the decode step counts on the device the experts its live rows chose,
read once after ``run``.

Arrivals are an ``exec.trace.EventTrace``: ``commit_time`` carries
arrival times and ``read_version[t] = t``. ``poisson_trace`` draws
reproducible Poisson arrivals; any saved trace replays the same load.

Time is the port's one clock (``engine.timing.monotonic``), read after
the device work it times has been waited for. When every slot is empty
and the next arrival is in the future, the clock skips forward instead of
sleeping, so queueing delays stay real while a trace benches in compute
time. Per-request output is independent of batch composition (pinned in
tests), so admission timing never changes tokens.

Spans (``obs.spans``; free when no tracer is installed): one
``serve.iteration`` per pass of the loop, whose self time is the loop's
own host work; a ``serve.admit`` instant per admission (``rid``,
``slot``, ``queue_wait_s``); ``serve.prefill`` (``lanes``, ``bucket``,
``rows`` computed: slots x bucket; for hybrid_moe the admitted lanes,
to a power of two, x bucket;
admitted ``prompt_tokens``, ``rids``,
``prompt_lens``); ``serve.decode_step`` (``occupancy``, ``gather``,
``context_tokens``, ``contexts``) holding ``serve.decode.upload`` (the
step's operand copies) and ``serve.decode.dispatch`` (the host enqueueing
the step, opened in ``_step``; ``graph`` says whether it replayed the
captured step), so its self time is the wait for the token; a
``serve.retire`` instant per finished request (``rid``,
``tokens``, ``first_token_s``, ``last_token_s``). hybrid_moe adds
``serve.prefill``'s ``ssm_layers`` and ``routed_pairs`` (admitted prompt
tokens x experts a token), a ``serve.state_reset`` instant per admission
pass (``slots``, ``rids``), and one ``serve.moe_experts`` instant after
the loop (``hits`` per expert, ``live_experts`` summed over steps and
layers, ``steps``, ``layers``, ``experts``). The ``rid`` ties a
request's spans together; times in attributes are on the run's clock.

Prefill modes:
- ``"scan"`` (default): the paged decode step looped over prompt
  positions, bucketed by prompt length — bitwise-identical cache and first
  token to the sequential reference (``T.prefill``).
- ``"parallel"``: one ``T.forward`` pass over the whole prompt
  (``attn_impl="cuda"`` routes it through the flash kernel), KV rows
  scattered into the slot's pages. Full-window caches only.

Decode cost tracks live context, not pool capacity:
- ``attn_impl="cuda"`` routes decode (and the scan-prefill inner step)
  through the in-kernel paged-attention walk — no dense gather at all.
- the plain path gathers only up to the batch's live high-water page
  count, bucketed to a power-of-two page ladder (``gather_mode=
  "bucket"``); ``gather_mode="full"`` pins the full-capacity gather — the
  bitwise baseline arm.
- ``attn_impl="cuda_gather"`` (flash over a gathered copy) cannot
  represent a wrapped ring: under a sliding window it falls back to the
  plain path, and the server says so — ``warnings.warn`` +
  ``registry.note``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import check_attn_impl, resolve
from repro_torch.engine.timing import monotonic, synchronize
from repro_torch.exec.trace import EventTrace
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import to_compute_dtype
from repro_torch.obs import spans
from repro_torch.obs.metrics import MetricRegistry
from repro_torch.serving.decode import (DecodeGraph, check_paged_family,
                                        paged_decode_step)
from repro_torch.serving.paged_cache import (PagedCacheSpec, PageAllocator,
                                             init_pages, init_state)


# ---------------------------------------------------------------------------
# Offered load: traces and request sampling
# ---------------------------------------------------------------------------

def poisson_trace(rate: float, n: int, seed: int = 0) -> EventTrace:
    """Reproducible Poisson arrivals at ``rate`` req/s as an EventTrace
    (commit_time = arrival times, staleness 0)."""
    if rate <= 0:
        raise ValueError("rate must be positive")
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    t = np.arange(n, dtype=np.int64)
    return EventTrace(num_groups=1, group=np.zeros(n, np.int32),
                      read_version=t, commit_time=arrivals)


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: prompt tokens + generation budget."""
    rid: int
    arrival: float
    prompt: np.ndarray          # (P,) int32
    gen: int


def sample_requests(trace: EventTrace, cfg: ArchConfig, *,
                    prompt_range=(8, 32), gen_range=(4, 32),
                    seed: int = 0) -> List[Request]:
    """One request per trace event. Prompt tokens and lengths come from an
    RNG keyed by (seed, rid) alone, so request rid is byte-identical across
    traces/rates — the solo bit-match tests and the continuous-vs-static
    bench replay the exact same work."""
    out = []
    for rid, arrival in enumerate(np.asarray(trace.commit_time)):
        rng = np.random.default_rng((seed, rid))
        plen = int(rng.integers(prompt_range[0], prompt_range[1] + 1))
        gen = int(rng.integers(gen_range[0], gen_range[1] + 1))
        prompt = rng.integers(cfg.vocab_size, size=plen).astype(np.int32)
        out.append(Request(rid=rid, arrival=float(arrival),
                           prompt=prompt, gen=gen))
    return out


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeReport:
    """Per-request accounting for one serving run (times in seconds on the
    run's virtual clock; latency = finish - arrival; ``first_tokens``: the
    end of the prefill that produced each request's first token)."""
    mode: str
    rids: np.ndarray
    arrivals: np.ndarray
    queue_waits: np.ndarray
    latencies: np.ndarray
    first_tokens: np.ndarray
    gen_counts: np.ndarray
    tokens: Dict[int, np.ndarray]
    makespan: float
    occupancy_mean: float

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.latencies, q))

    @property
    def ttfts(self) -> np.ndarray:
        """Time to first token of each request (arrival to first token)."""
        return self.first_tokens - self.arrivals

    @property
    def total_tokens(self) -> int:
        return int(self.gen_counts.sum())

    @property
    def throughput(self) -> float:
        """Generated tokens per second of makespan."""
        return self.total_tokens / max(self.makespan, 1e-12)

    def goodput(self, slo_s: float) -> float:
        """Tokens/s counting only requests whose latency met the SLO —
        the paper's HE x SE product transposed to serving: raw throughput
        discounted by the fraction of it that was statistically useful
        (delivered within the latency target)."""
        ok = self.latencies <= slo_s
        return float(self.gen_counts[ok].sum()) / max(self.makespan, 1e-12)


def _bucket(n: int, cap: Optional[int] = None) -> int:
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap) if cap is not None else b


def random_params(cfg: ArchConfig, seed: int, device) -> dict:
    """Seeded random params on ``device``, each weight drawn in fp32 and
    stored in the compute dtype as it is made (the full-width server never
    holds an fp32 copy of the model)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return T.init_params(gen, cfg, weight_dtype=cfg.dtype("compute"))


# ---------------------------------------------------------------------------
# Continuous-batching server
# ---------------------------------------------------------------------------

class ContinuousServer:
    """Slot-recycled continuous batching (module docstring).

    ``params`` (the port's tree, e.g. from ``models.convert``) are moved to
    ``device`` and cast to the compute dtype once; ``None`` draws seeded
    random ones there. ``device`` defaults to the card and raises without
    one; the CPU runs only ``attn_impl="torch"``.

    Counters in ``registry``: ``serving.decode_graph_captures`` (graphs
    recorded) and ``serving.decode_graph_replays`` (decode steps, scan
    prefill positions included, that replayed one). hybrid_moe adds, after
    each ``run``, the series ``serving.moe_expert_hits`` (one sample an
    expert, step = its id: the live rows' choices of it over the run's
    decode steps and layers), the gauge ``serving.moe_live_share`` (the
    mean share of the experts a step's live rows chose in a layer) and the
    counter ``serving.prefill_graph_captures``.
    """

    def __init__(self, cfg: ArchConfig, params=None, *, slots: int = 8,
                 page_size: int = 16, max_seq: int = 256,
                 window: Optional[int] = "config", attn_impl: str = "torch",
                 prefill_mode: str = "scan", gather_mode: str = "bucket",
                 seed: int = 0,
                 registry: Optional[MetricRegistry] = None,
                 device="cuda"):
        self.device = resolve(device)
        if window == "config":
            window = cfg.sliding_window
        if prefill_mode not in ("scan", "parallel"):
            raise ValueError(f"unknown prefill_mode {prefill_mode!r}")
        if prefill_mode == "parallel" and window is not None:
            raise ValueError("parallel prefill needs a full (non-ring) cache")
        check_attn_impl(attn_impl, self.device)
        if gather_mode not in ("bucket", "full"):
            raise ValueError(f"unknown gather_mode {gather_mode!r}")
        check_paged_family(cfg)
        T.require_ported(cfg)
        self.cfg = cfg
        self.window = window
        self.attn_impl = attn_impl
        self.prefill_mode = prefill_mode
        self.gather_mode = gather_mode
        if params is None:
            params = random_params(cfg, seed, self.device)
        self.params = to_compute_dtype(params, cfg, device=self.device)
        self.spec = PagedCacheSpec.for_config(
            cfg, num_slots=slots, page_size=page_size, max_seq=max_seq,
            window=window)
        self.alloc = PageAllocator(self.spec)
        self.pages = self._new_pages()
        self._moe_stats = None
        if cfg.arch_type == "hybrid_moe":
            z = lambda *shape: torch.zeros(shape, dtype=torch.int64,
                                           device=self.device)
            self._moe_stats = {"hits": z(cfg.moe.num_experts), "live": z(),
                               "steps": z()}
        self.registry = registry if registry is not None else MetricRegistry()
        # the decode step as one CUDA graph: on the card at the in-kernel
        # page walk, whose shapes never change (module docstring)
        self._graphed = self.device.type == "cuda" and attn_impl == "cuda"
        self._graph: Optional[DecodeGraph] = None
        self._capture_stream: Optional[torch.cuda.Stream] = None
        self._prefill_graphs: Dict[tuple, DecodeGraph] = {}
        self._graph_pool = None

        # the one remaining impl fallback, made loud: flash-over-a-copy
        # cannot express a wrapped ring, so sliding windows run the plain
        # masked path — warn once and pin it in the metric stream's notes
        self._fallback_note: Optional[str] = None
        if attn_impl == "cuda_gather" and window is not None:
            self._fallback_note = (
                "attn_impl='cuda_gather' cannot run a sliding-window "
                f"(window={window}) ring cache: slot order != position "
                "order after wrap breaks the flash kernel's positional "
                "mask; decode falls back to the masked plain path "
                "(attn_impl='cuda' walks the page table in-kernel and "
                "has no such fallback)")
            warnings.warn(self._fallback_note, stacklevel=2)
            self.registry.note(self._fallback_note)

    # -- device operands -------------------------------------------------

    def _new_pages(self) -> dict:
        """The zero pool and, for a family with one, the per-slot state."""
        return {**init_pages(self.spec, self.device),
                **init_state(self.cfg, self.spec.num_slots, self.device)}

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a fresh device tensor (a copy: the allocator
        keeps mutating its tables)."""
        return torch.tensor(a, device=self.device)

    # -- the two compiled-step counterparts --------------------------------

    def _decode(self, table, tokens, pos, active,
                gather_pages: Optional[int] = None):
        """The eager decode step: (S, 1, V) fp32 logits and their (S,)
        int32 argmax."""
        logits, self.pages = paged_decode_step(
            self.params, self.pages, table, tokens, pos, active, self.cfg,
            window=self.window, attn_impl=self.attn_impl,
            gather_pages=gather_pages, moe_stats=self._moe_stats)
        return logits, torch.argmax(logits[:, -1], dim=-1).to(torch.int32)

    def _capture(self) -> None:
        """Record the decode step over all-inactive static operands."""
        S, dev = self.spec.num_slots, self.device
        operands = (
            torch.zeros((S, self.spec.pages_per_slot), dtype=torch.int32,
                        device=dev),
            torch.zeros((S, 1), dtype=torch.int32, device=dev),
            torch.zeros((S,), dtype=torch.int32, device=dev),
            torch.zeros((S,), dtype=torch.bool, device=dev))
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(dev)
        self._graph = DecodeGraph(self._decode, operands,
                                  self._capture_stream)
        self.registry.counter("serving.decode_graph_captures").inc()

    def _step(self, table, tokens, pos, active,
              gather_pages: Optional[int]) -> torch.Tensor:
        """One decode step over every slot; returns (S,) int32 argmax, a
        fresh tensor (the scan prefill stacks several)."""
        with spans.span("serve.decode.dispatch", graph=self._graphed):
            if not self._graphed:
                return self._decode(table, tokens, pos, active,
                                    gather_pages)[1]
            if self._graph is None:
                self._capture()
            self._graph.replay(table, tokens, pos, active)
            self.registry.counter("serving.decode_graph_replays").inc()
            return self._graph.tokens.clone()

    def _scan_prefill(self, table, prompts, plens, admit,
                      gather_pages: Optional[int]) -> torch.Tensor:
        S, Pb = prompts.shape
        toks = []
        for t in range(Pb):
            act = admit & (t < plens)
            pos = torch.full((S,), t, dtype=torch.int32, device=self.device)
            toks.append(self._step(table, prompts[:, t:t + 1], pos, act,
                                   gather_pages))
        return torch.stack(toks)                       # (Pb, S)

    def _parallel_prefill(self, table, prompts, plens, admit,
                          gather_pages: Optional[int]) -> torch.Tensor:
        del gather_pages                               # no gather here
        S, Pb = prompts.shape
        tpos = torch.arange(Pb, device=self.device)[None, :]     # (1, Pb)
        act = admit[:, None] & (tpos < plens[:, None])           # (S, Pb)
        if "ssm_h" in self.pages:
            return self._prefill_lanes(table, prompts, act, admit)
        logits, _, cache = T.forward(self.params, {"tokens": prompts},
                                     self.cfg, return_cache=True,
                                     attn_impl=self.attn_impl,
                                     window=self.window)
        self._write_kv(cache, table, act)
        toks = torch.argmax(logits, dim=-1).to(torch.int32)      # (S, Pb)
        return toks.T                                            # (Pb, S)

    def _write_kv(self, cache, table, act) -> None:
        """Scatter the prefill's K/V rows (valid positions ``act``) into
        the rows' pages (``table``)."""
        B, Pb = act.shape
        page = self.spec.page_size
        tpos = torch.arange(Pb, device=self.device)[None, :]
        pid = table.long().gather(1, (tpos // page).expand(B, Pb))
        inpg = (tpos % page).expand(B, Pb)
        actx = act[None, :, :, None, None]
        for name in ("k", "v"):
            pool = self.pages[name]                               # (L,P,pg,K,hd)
            kv = cache["blocks"][name].to(pool.dtype)             # (L,B,Pb,K,hd)
            old = pool[:, pid, inpg]
            pool[:, pid, inpg] = torch.where(actx, kv, old)

    def _lanes_step(self, table, prompts, valid, rows):
        """hybrid_moe's prefill of the slots ``rows`` (n,) alone: their
        right-padded prompts (n, Pb), valid positions ``valid``, from their
        state, which it hands back with their K/V. A row with no valid
        position writes back exactly what it read. Returns (None, (n, Pb)
        int32 argmax): ``DecodeGraph``'s step."""
        batch = {"tokens": prompts, "valid": valid,
                 "ssm_h": self.pages["ssm_h"][:, rows],
                 "ssm_conv": self.pages["ssm_conv"][:, rows]}
        logits, _, cache = T.forward(self.params, batch, self.cfg,
                                     return_cache=True,
                                     attn_impl=self.attn_impl)
        for name in ("h", "conv"):
            self.pages["ssm_" + name][:, rows] = cache["ssm"][name]
        self._write_kv(cache, table, valid)
        return None, torch.argmax(logits, dim=-1).to(torch.int32)

    def _prefill_lanes(self, table, prompts, act, admit) -> torch.Tensor:
        """The admitted slots' rows alone (the work is the admitted
        prompts', not slots x bucket), padded to a power of two with rows
        of other slots that have no valid position. On the card a shape of
        at most ``moe.DENSE_MAX_ROWS`` rows replays its captured graph (one
        a shape, recorded at ``warmup`` or first use): an eager prefill is
        ~1800 launches, bound by the host. -> (Pb, S)."""
        S, Pb = prompts.shape
        admitted = np.flatnonzero(admit.cpu().numpy())
        n = min(_bucket(max(len(admitted), 1)), S)
        rest = np.setdiff1d(np.arange(S), admitted)
        rows = torch.from_numpy(np.concatenate(
            [admitted, rest[:n - len(admitted)]])).to(self.device)
        operands = (table[rows], prompts[rows], act[rows], rows)
        if not (self._graphed and n * Pb <= M.DENSE_MAX_ROWS):
            toks = self._lanes_step(*operands)[1]
        else:
            graph = self._prefill_graphs.get((n, Pb))
            if graph is None:
                graph = self._capture_lanes(n, Pb)
            graph.replay(*operands)
            toks = graph.tokens
        out = torch.zeros((S, Pb), dtype=torch.int32, device=self.device)
        return out.index_copy(0, rows, toks).T

    def _capture_lanes(self, n: int, Pb: int) -> DecodeGraph:
        """Record the prefill of ``n`` rows at bucket ``Pb`` over static
        operands that name slot 0 with no valid position."""
        dev = self.device
        operands = (
            torch.zeros((n, self.spec.pages_per_slot), dtype=torch.int32,
                        device=dev),
            torch.zeros((n, Pb), dtype=torch.int32, device=dev),
            torch.zeros((n, Pb), dtype=torch.bool, device=dev),
            torch.zeros((n,), dtype=torch.int64, device=dev))
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(dev)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = DecodeGraph(self._lanes_step, operands,
                            self._capture_stream, pool=self._graph_pool)
        self._prefill_graphs[(n, Pb)] = graph
        self.registry.counter("serving.prefill_graph_captures").inc()
        return graph

    def _prefill(self, *args, gather_pages: Optional[int]):
        fn = (self._scan_prefill if self.prefill_mode == "scan"
              else self._parallel_prefill)
        return fn(*args, gather_pages=gather_pages)

    def reset(self, registry: Optional[MetricRegistry] = None) -> None:
        """Fresh pool/allocator (and optionally a fresh metric registry),
        so a measured run can follow a warmup run. The decode graph wrote
        the old pool: it goes, and the next warmup or step records one
        over the new pool (and so do the prefill graphs)."""
        self.alloc = PageAllocator(self.spec)
        self.pages = self._new_pages()
        self._graph = None
        self._prefill_graphs = {}
        if registry is not None:
            self.registry = registry
            if self._fallback_note is not None:
                self.registry.note(self._fallback_note)

    def _reset_state(self, slots: List[int], rids: List[int]) -> None:
        """Zero the admitted slots' recurrent state."""
        spans.instant("serve.state_reset", slots=slots, rids=rids)
        idx = torch.tensor(slots, device=self.device)
        for name in ("ssm_h", "ssm_conv"):
            self.pages[name][:, idx] = 0

    def _report_moe(self) -> None:
        """Read the decode step's expert counters once and record them."""
        st = {k: v.tolist() for k, v in self._moe_stats.items()}
        n_layers, n_exp = self.cfg.num_layers, self.cfg.moe.num_experts
        hits = self.registry.series("serving.moe_expert_hits")
        for e, n in enumerate(st["hits"]):
            hits.append(n, step=e)
        if st["steps"]:
            self.registry.gauge("serving.moe_live_share").set(
                st["live"] / (st["steps"] * n_layers * n_exp))
        spans.instant("serve.moe_experts", hits=st["hits"],
                      live_experts=st["live"], steps=st["steps"],
                      layers=n_layers, experts=n_exp)

    def _uses_gather(self) -> bool:
        """Does the decode step materialize a dense gathered view at all?
        ``"cuda"`` walks the table in-kernel; everything else gathers."""
        return self.attn_impl != "cuda"

    def _gather_bucket(self, slot_pos: np.ndarray,
                       active: np.ndarray) -> Optional[int]:
        """The batch's live high-water page count, rounded up the
        power-of-two ladder. Active rows only: retired slots keep stale
        positions that must not widen (or overrun) the gather. None means
        full width — cuda (no gather), ``gather_mode="full"``, or a batch
        already at capacity."""
        if self.gather_mode == "full" or not self._uses_gather():
            return None
        if not active.any():
            return None
        live = min(int(slot_pos[active].max()) + 1, self.spec.seq_capacity)
        gp = _bucket(-(-live // self.spec.page_size), self.spec.pages_per_slot)
        return None if gp >= self.spec.pages_per_slot else gp

    def _prefill_gather(self, Pb: int) -> Optional[int]:
        """Gather width for a scan prefill over a ``Pb``-bucket prompt:
        positions stay < Pb, and non-admitted rows' outputs are discarded,
        so the view only needs the prompt's own pages."""
        if self.gather_mode == "full" or not self._uses_gather():
            return None
        live = min(Pb, self.spec.seq_capacity)
        gp = _bucket(-(-live // self.spec.page_size), self.spec.pages_per_slot)
        return None if gp >= self.spec.pages_per_slot else gp

    def _gather_ladder(self) -> List[Optional[int]]:
        """Every gather width a run can request: the full-capacity arm
        plus (in bucket mode) each power-of-two rung below capacity."""
        ladder: List[Optional[int]] = [None]
        if self.gather_mode == "bucket" and self._uses_gather():
            gp = 1
            while gp < self.spec.pages_per_slot:
                ladder.append(gp)
                gp <<= 1
        return ladder

    def warmup(self, prompt_lens: Sequence[int] = ()) -> None:
        """Run the decode step at every gather width and the prefill at
        every bucket of the given prompt lengths without touching any
        state (an all-inactive call writes back exactly what it reads):
        builds the kernels and primes the allocator and math libraries.
        Where the step is graphed, records its graph instead (after one
        such eager step: ``DecodeGraph``)."""
        S = self.spec.num_slots
        table = self._dev(self.alloc.tables)
        off = torch.zeros((S,), dtype=torch.int32, device=self.device)
        inact = torch.zeros((S,), dtype=torch.bool, device=self.device)
        if self._graphed:
            if self._graph is None:
                self._capture()
        else:
            for gp in self._gather_ladder():
                self._step(table, torch.zeros((S, 1), dtype=torch.int32,
                                              device=self.device),
                           off, inact, gp).cpu()
        cap = self.spec.seq_capacity if self.window is None else None
        for p in sorted({_bucket(int(p), cap) for p in prompt_lens}):
            self._prefill(table, torch.zeros((S, p), dtype=torch.int32,
                                             device=self.device),
                          off, inact, gather_pages=self._prefill_gather(p)
                          ).cpu()
            if "ssm_h" in self.pages and self._graphed:
                for n in (1, 2, 4, 8):
                    if n <= S and n * p <= M.DENSE_MAX_ROWS and \
                            (n, p) not in self._prefill_graphs:
                        self._capture_lanes(n, p)

    def run(self, requests: Sequence[Request]) -> ServeReport:
        """Serve every request; returns per-request accounting."""
        spec, alloc = self.spec, self.alloc
        S = spec.num_slots
        cap = spec.seq_capacity
        reg = self.registry
        traced = spans.current().enabled     # lists and sums only if read
        queue_wait = reg.series("serving.queue_wait_s")
        prefill_s = reg.series("serving.prefill_s")
        decode_s = reg.series("serving.decode_s")
        step_s = reg.series("serving.decode_step_s")
        latency_s = reg.series("serving.latency_s")
        ttft_s = reg.series("serving.ttft_s")
        occupancy = reg.series("serving.occupancy")
        done_ctr = reg.counter("serving.requests_completed")
        tok_ctr = reg.counter("serving.tokens_generated")

        if self._moe_stats is not None:
            for v in self._moe_stats.values():
                v.zero_()
        reqs = sorted(requests, key=lambda r: r.arrival)
        if self.window is None:
            for r in reqs:
                if len(r.prompt) + r.gen > cap:
                    raise ValueError(
                        f"request {r.rid}: prompt {len(r.prompt)} + gen "
                        f"{r.gen} exceeds cache capacity {cap}")

        slot_req: List[Optional[Request]] = [None] * S
        slot_pos = np.zeros(S, np.int32)       # next decode position
        slot_tok = np.zeros(S, np.int32)       # next input token
        slot_left = np.zeros(S, np.int64)      # decode steps remaining
        slot_pf_end = np.zeros(S, np.float64)  # prefill end (virtual clock)
        out_tokens: Dict[int, List[int]] = {}
        finished: Dict[int, dict] = {}

        t0 = monotonic()
        voff = 0.0
        now = lambda: monotonic() - t0 + voff
        qi = 0
        n_active = 0
        steps = 0
        occ_samples: List[int] = []

        def retire(s: int, tnow: float) -> None:
            nonlocal n_active
            r = slot_req[s]
            lat = tnow - r.arrival
            finished[r.rid] = {
                "arrival": r.arrival, "latency": lat,
                "queue_wait": finished[r.rid]["queue_wait"],
                "first_token": slot_pf_end[s],
                "gen": len(out_tokens[r.rid])}
            spans.instant("serve.retire", rid=r.rid,
                          tokens=len(out_tokens[r.rid]),
                          first_token_s=float(slot_pf_end[s]),
                          last_token_s=tnow)
            latency_s.append(lat, step=r.rid)
            decode_s.append(tnow - slot_pf_end[s], step=r.rid)
            done_ctr.inc()
            alloc.release(s)
            slot_req[s] = None
            n_active -= 1

        while qi < len(reqs) or n_active:
            with spans.span("serve.iteration", step=steps):
                tnow = now()
                if (n_active == 0 and qi < len(reqs)
                        and reqs[qi].arrival > tnow):
                    voff += reqs[qi].arrival - tnow  # idle: skip, don't sleep
                    tnow = now()

                # -- admission: fill free slots from the arrived queue ----
                admits: List[int] = []
                for s in range(S):
                    if qi >= len(reqs) or slot_req[s] is not None:
                        continue
                    r = reqs[qi]
                    need = min(len(r.prompt), cap)
                    if r.arrival > tnow or not alloc.can_fit(need):
                        if (n_active == 0 and not admits
                                and r.arrival <= tnow):
                            raise RuntimeError(
                                f"request {r.rid} cannot fit an empty pool")
                        break
                    alloc.ensure(s, need)
                    slot_req[s] = r
                    slot_pos[s] = 0
                    slot_left[s] = r.gen
                    out_tokens[r.rid] = []
                    finished[r.rid] = {"queue_wait": tnow - r.arrival}
                    queue_wait.append(tnow - r.arrival, step=r.rid)
                    spans.instant("serve.admit", rid=r.rid, slot=s,
                                  queue_wait_s=tnow - r.arrival)
                    admits.append(s)
                    qi += 1
                    n_active += 1

                if admits and "ssm_h" in self.pages:
                    self._reset_state(admits,
                                      [slot_req[s].rid for s in admits])

                # -- prefill the admitted slots (one bucketed call) -------
                if admits:
                    plens = np.array([len(slot_req[s].prompt) if slot_req[s]
                                      else 0 for s in range(S)], np.int32)
                    pmax = max(len(slot_req[s].prompt) for s in admits)
                    Pb = _bucket(pmax, cap if self.window is None else None)
                    prompts = np.zeros((S, Pb), np.int32)
                    admit = np.zeros(S, bool)
                    for s in admits:
                        r = slot_req[s]
                        prompts[s, :len(r.prompt)] = r.prompt[:Pb]
                        admit[s] = True
                    attrs = {}
                    if traced:
                        lens = [int(plens[s]) for s in admits]
                        lanes = (S if "ssm_h" not in self.pages
                                 else min(_bucket(len(admits)), S))
                        attrs = dict(rows=lanes * Pb, prompt_tokens=sum(lens),
                                     rids=[slot_req[s].rid for s in admits],
                                     prompt_lens=lens)
                        if self._moe_stats is not None:
                            attrs.update(
                                ssm_layers=self.pages["ssm_h"].shape[0],
                                routed_pairs=sum(lens) * self.cfg.moe.top_k)
                    tpf = now()
                    with spans.span("serve.prefill", lanes=len(admits),
                                    bucket=Pb, **attrs):
                        toks = self._prefill(
                            self._dev(alloc.tables), self._dev(prompts),
                            self._dev(plens), self._dev(admit),
                            gather_pages=self._prefill_gather(Pb))
                        toks = toks.cpu().numpy()      # (Pb, S); sync
                    tnow = now()
                    for s in admits:
                        r = slot_req[s]
                        prefill_s.append(tnow - tpf, step=r.rid)
                        ttft_s.append(tnow - r.arrival, step=r.rid)
                        slot_pf_end[s] = tnow
                        first = int(toks[len(r.prompt) - 1, s])
                        out_tokens[r.rid].append(first)
                        tok_ctr.inc()
                        slot_tok[s] = first
                        slot_pos[s] = len(r.prompt)
                        slot_left[s] = r.gen - 1
                        if slot_left[s] == 0:
                            retire(s, tnow)

                if n_active == 0:
                    continue

                # -- one continuous decode step over every live slot ------
                active = np.array([r is not None for r in slot_req])
                for s in np.nonzero(active)[0]:
                    alloc.ensure(int(s), int(slot_pos[s]) + 1)
                occ_samples.append(int(active.sum()))
                occupancy.append(int(active.sum()), step=steps)
                gp = self._gather_bucket(slot_pos, active)
                attrs = {}
                if traced:
                    ctx = slot_pos[active].astype(np.int64) + 1
                    attrs = dict(context_tokens=int(ctx.sum()),
                                 contexts=ctx.tolist())
                tstep = now()
                with spans.span("serve.decode_step",
                                occupancy=int(active.sum()),
                                gather=(gp if gp is not None
                                        else spec.pages_per_slot), **attrs):
                    with spans.span("serve.decode.upload"):
                        table = self._dev(alloc.tables)
                        tokens = self._dev(slot_tok[:, None])
                        pos = self._dev(slot_pos)
                        act = self._dev(active)
                    tok = self._step(table, tokens, pos, act, gp)
                    tok = tok.cpu().numpy()            # sync
                tnow = now()
                step_s.append(tnow - tstep, step=steps)
                steps += 1
                for s in np.nonzero(active)[0]:
                    r = slot_req[s]
                    out_tokens[r.rid].append(int(tok[s]))
                    tok_ctr.inc()
                    slot_tok[s] = int(tok[s])
                    slot_pos[s] += 1
                    slot_left[s] -= 1
                    if slot_left[s] == 0:
                        retire(int(s), tnow)

        if self._moe_stats is not None:
            self._report_moe()
        rids = np.array(sorted(finished), np.int64)
        occ = np.array(occ_samples) if occ_samples else np.zeros(1)
        return ServeReport(
            mode="continuous",
            rids=rids,
            arrivals=np.array([finished[r]["arrival"] for r in rids]),
            queue_waits=np.array([finished[r]["queue_wait"] for r in rids]),
            latencies=np.array([finished[r]["latency"] for r in rids]),
            first_tokens=np.array([finished[r]["first_token"]
                                   for r in rids]),
            gen_counts=np.array([finished[r]["gen"] for r in rids]),
            tokens={r: np.array(out_tokens[r], np.int32) for r in rids},
            makespan=now(),
            occupancy_mean=float(occ.mean()))


# ---------------------------------------------------------------------------
# Static-batch baseline on the same trace
# ---------------------------------------------------------------------------

def static_serve_trace(cfg: ArchConfig, requests: Sequence[Request], *,
                       batch: int = 8, params=None, seed: int = 0,
                       window: Optional[int] = "config",
                       registry: Optional[MetricRegistry] = None,
                       device="cuda") -> ServeReport:
    """The pre-continuous ``serve()`` flow run against a trace: requests
    are chunked into arrival-order batches; each batch waits for its last
    member, prefills padded prompts, then decodes to the *longest*
    generation in the batch — no slot recycles early, every member's
    latency is the batch's end. The baseline the continuous server's
    goodput is compared against."""
    dev = resolve(device)
    T.require_ported(cfg)
    if window == "config":
        window = cfg.sliding_window
    if params is None:
        params = random_params(cfg, seed, dev)
    params = to_compute_dtype(params, cfg, device=dev)
    reg = registry if registry is not None else MetricRegistry()
    prefill_s = reg.series("serving.prefill_s")
    step_s = reg.series("serving.decode_step_s")
    latency_s = reg.series("serving.latency_s")

    reqs = sorted(requests, key=lambda r: r.arrival)
    groups = [reqs[i:i + batch] for i in range(0, len(reqs), batch)]

    finished: Dict[int, dict] = {}
    tokens: Dict[int, np.ndarray] = {}
    t0 = monotonic()
    voff = 0.0
    now = lambda: monotonic() - t0 + voff
    occ_num = 0.0
    occ_time = 0.0

    for grp in groups:
        last_arrival = max(r.arrival for r in grp)
        tnow = now()
        if last_arrival > tnow:                    # wait to fill the batch
            voff += last_arrival - tnow
            tnow = now()
        start = tnow
        pmax = _bucket(max(len(r.prompt) for r in grp))
        gmax = max(r.gen for r in grp)
        prompts = np.zeros((batch, pmax), np.int32)
        for i in range(batch):
            r = grp[min(i, len(grp) - 1)]          # pad lanes: repeat last
            prompts[i, :len(r.prompt)] = r.prompt
        total_cap = pmax + _bucket(gmax)
        cache = T.init_cache(cfg, batch, total_cap, window, device=dev)
        tpf = now()
        logits, cache = T.prefill(params, cache,
                                  torch.tensor(prompts, device=dev), cfg,
                                  window)
        synchronize()
        t_first = now()
        prefill_s.append(t_first - tpf)
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
        outs = [tok.cpu().numpy()[:, 0]]
        for t in range(pmax, pmax + gmax - 1):
            ts = now()
            logits, cache = T.decode_step(params, cache, tok, t, cfg, window)
            tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
            tok = tok.to(torch.int32)
            outs.append(tok.cpu().numpy()[:, 0])   # sync
            step_s.append(now() - ts)
        end = now()
        occ_num += len(grp) * (end - start)
        occ_time += end - start
        allt = np.stack(outs, axis=1)              # (batch, gmax)
        for i, r in enumerate(grp):
            finished[r.rid] = {"arrival": r.arrival,
                               "queue_wait": start - r.arrival,
                               "latency": end - r.arrival,
                               "first_token": t_first,
                               "gen": r.gen}
            latency_s.append(end - r.arrival, step=r.rid)
            tokens[r.rid] = allt[i, :r.gen].astype(np.int32)

    rids = np.array(sorted(finished), np.int64)
    makespan = now()
    return ServeReport(
        mode="static",
        rids=rids,
        arrivals=np.array([finished[r]["arrival"] for r in rids]),
        queue_waits=np.array([finished[r]["queue_wait"] for r in rids]),
        latencies=np.array([finished[r]["latency"] for r in rids]),
        first_tokens=np.array([finished[r]["first_token"] for r in rids]),
        gen_counts=np.array([finished[r]["gen"] for r in rids]),
        tokens=tokens,
        makespan=makespan,
        occupancy_mean=occ_num / occ_time / batch if occ_time else 0.0)
