"""Trace-driven asynchronous SGD replay — execute real model updates along
an ``EventTrace`` (the JAX package's ``exec/replay.py``).

Generalizes ``core.async_sgd.delayed_sgd_run`` from one fixed staleness S
to *per-commit* staleness: commit t applies a momentum-SGD update (paper
eq. (3)-(4)) whose gradient was evaluated at parameter version
``trace.read_version[t]``, kept in a ring of the last R parameter
versions. This is the execution half of the prediction->execution loop:
the simulators predict a staleness distribution, the replay runs SGD
along the very event schedule that produced it, and the measured implicit
momentum / statistical efficiency can be compared against Theorem 1 and
the analytic SE penalty.

Three interchangeable implementations, as in the reference:

- ``replay_trace_python`` — the semantic oracle: a list of R parameter
  trees, one ``torch.autograd.grad`` a commit;
- ``replay_trace_scan``   — the reference's ``lax.scan`` becomes a loop
  over commits on an R-deep ring of stacked parameter versions (one
  ``(R, ...)`` tensor a leaf; the stale read is a view of its slot, and
  each commit writes one version into the slot it retires), with
  staleness bucketed to the ring depth (``depth=``);
- ``replay_trace_fused``  — for run-structured traces (every run of L
  commits reads the run-start version, e.g. the grouped strategy), one
  closed-form update per run from the ``optim.closed_form`` coefficients
  instead of L sequential sub-steps, in plain PyTorch as the reference
  computes it (not the fused-update kernel).

``loss_fn(params, batch) -> scalar`` is the only model contract; each
commit's gradient runs whatever the model runs (on CaffeNet, the
lowering-conv, wgrad and dgrad kernels). ``batches`` is a tree whose
leaves have one leading commit axis ``(T, ...)``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import tree as T
from repro_torch.core.async_sgd import stacked_group_grads, value_and_grad
from repro_torch.exec.trace import EventTrace
from repro_torch.optim.closed_form import grouped_coeffs


def _momentum_update(p, g, v, *, lr, momentum, weight_decay):
    """One paper-eq-(3)/(4) leaf update in fp32 (matches ``sgd_update``)."""
    g32 = g.float()
    if weight_decay:
        g32 = g32 + weight_decay * p.float()
    v_new = momentum * v.float() - lr * g32
    p_new = p.float() + v_new
    return p_new.to(p.dtype), v_new.to(v.dtype)


def _read_slots(trace: EventTrace, depth: Optional[int]) -> tuple:
    """(ring depth R, per-commit ring slot of the read version).

    ``depth`` caps the ring: staleness is bucketed to at most R-1, i.e.
    commits that read a version older than the ring holds read the oldest
    version still alive — ``read_version[t] -> max(rv[t], t - (R-1))``.
    """
    R = trace.max_staleness + 1
    if depth is not None:
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        R = min(R, int(depth))
    t = np.arange(len(trace))
    rv = np.maximum(trace.read_version, t - (R - 1))
    return R, (rv % R).astype(np.int32)


def _slice_batches(batches, n: int):
    lead = T.leaves(batches)[0].shape[0]
    if lead < n:
        raise ValueError(f"trace has {n} commits but batches only {lead}")
    return T.tree_map(lambda x: x[:n], batches)


def _stack_trace(like, per_commit):
    """Per-commit lists of leaves -> the tree with leaves (T, ...)."""
    return T.unflatten(like, [torch.stack(xs) for xs in zip(*per_commit)])


# ---------------------------------------------------------------------------
# Python reference
# ---------------------------------------------------------------------------

def replay_trace_python(loss_fn: Callable, params, batches,
                        trace: EventTrace, *, lr: float,
                        momentum: float = 0.0, weight_decay: float = 0.0,
                        depth: Optional[int] = None,
                        record_params: bool = False):
    """Semantic oracle: per-commit loop over the trace.

    Commit t evaluates ``grad(W_{read_version[t]}, batches[t])`` and
    applies one momentum-SGD update to the current parameters. Losses are
    reported at the stale evaluation point (as in ``delayed_sgd_run``).
    The caller's ``params`` are not changed.

    Returns ``(final_params, losses (T,) numpy, params_trace or None)``.
    """
    n = len(trace)
    batches = _slice_batches(batches, n)
    R, slots = _read_slots(trace, depth)
    start = [p.detach() for p in T.leaves(params)]
    ring = [start] * R              # ring[v % R]: params at version v
    mom = [torch.zeros_like(p) for p in start]
    losses, ptrace = [], []
    for t in range(n):
        batch = T.tree_map(lambda x: x[t], batches)
        loss, grads = value_and_grad(loss_fn,
                                     T.unflatten(params, ring[int(slots[t])]),
                                     batch)
        new = [_momentum_update(p, g, v, lr=lr, momentum=momentum,
                                weight_decay=weight_decay)
               for p, g, v in zip(ring[t % R], grads, mom)]
        cur = [p for p, _ in new]
        mom = [v for _, v in new]
        ring[(t + 1) % R] = cur
        losses.append(loss)
        if record_params:
            ptrace.append(cur)
    final = T.unflatten(params, [p.clone() for p in ring[n % R]])
    out = _stack_trace(params, ptrace) if record_params else None
    return final, torch.stack(losses).float().cpu().numpy(), out


# ---------------------------------------------------------------------------
# The ring of stacked versions
# ---------------------------------------------------------------------------

def _replay_core(loss_fn, params, batches, read_slot, R: int, *, lr,
                 momentum, weight_decay, record_params):
    """The loop shared by ``replay_trace_scan`` and the batched momentum
    experiment. ``read_slot``: (T,) int ring slots; or (T, runs) for
    params whose every leaf has a leading runs axis and a ``loss_fn`` that
    sums independent per-run terms — run r then reads slot
    ``read_slot[t, r]`` (the reference ``vmap``s the scan over runs).
    Returns (final params, losses (T,) tensor, params trace or None)."""
    flat = [p.detach() for p in T.leaves(params)]
    hist = [torch.stack([f] * R) for f in flat]     # slot v % R: version v
    mom = [torch.zeros_like(f) for f in flat]
    read_slot = np.asarray(read_slot)
    if read_slot.ndim == 2:
        dev = flat[0].device
        slots = torch.as_tensor(read_slot, dtype=torch.long, device=dev)
        runs = torch.arange(read_slot.shape[1], device=dev)
    n = T.leaves(batches)[0].shape[0]
    losses, ptrace = [], []
    for t in range(n):
        if read_slot.ndim == 1:
            stale = [h[int(read_slot[t])] for h in hist]   # views
        else:
            stale = [h[slots[t], runs] for h in hist]
        loss, grads = value_and_grad(loss_fn, T.unflatten(params, stale),
                                     T.tree_map(lambda x: x[t], batches))
        new = []
        for j, (h, g) in enumerate(zip(hist, grads)):
            p_new, mom[j] = _momentum_update(
                h[t % R], g, mom[j], lr=lr, momentum=momentum,
                weight_decay=weight_decay)
            h[(t + 1) % R] = p_new      # retires version t + 1 - R
            new.append(p_new)
        losses.append(loss)
        if record_params:
            ptrace.append(new)
    final = T.unflatten(params, [h[n % R].clone() for h in hist])
    out = _stack_trace(params, ptrace) if record_params else None
    return final, torch.stack(losses), out


def replay_trace_scan(loss_fn: Callable, params, batches,
                      trace: EventTrace, *, lr: float, momentum: float = 0.0,
                      weight_decay: float = 0.0,
                      depth: Optional[int] = None,
                      record_params: bool = False):
    """Replay on an R-deep ring of stacked parameter versions (R = max
    staleness + 1, capped by ``depth`` — staleness beyond the ring is
    bucketed to R-1). Holds R versions of the params at once.

    Returns ``(final_params, losses (T,) numpy, params_trace or None)``.
    """
    n = len(trace)
    batches = _slice_batches(batches, n)
    R, slots = _read_slots(trace, depth)
    final, losses, ptrace = _replay_core(
        loss_fn, params, batches, slots, R, lr=lr, momentum=momentum,
        weight_decay=weight_decay, record_params=record_params)
    return final, losses.float().cpu().numpy(), ptrace


# ---------------------------------------------------------------------------
# Closed-form fused replay (run-structured traces)
# ---------------------------------------------------------------------------

def replay_trace_fused(loss_fn: Callable, params, batches,
                       trace: EventTrace, *, lr: float,
                       momentum: float = 0.0, weight_decay: float = 0.0):
    """Replay a run-structured trace (``trace.equal_read_runs() == L``)
    with ONE closed-form update per run: all L gradients of a run are
    evaluated at the run-start version, so the L sequential momentum
    sub-steps collapse to the ``optim.closed_form`` coefficients — no
    parameter history at all.

    Raises ``ValueError`` for traces without equal-read-run structure
    (use ``replay_trace_scan`` there).

    Returns ``(final_params, losses (T,) numpy, None)``.
    """
    L = trace.equal_read_runs()
    if L is None:
        raise ValueError(
            "fused replay needs an equal-read-run trace (every run of L "
            "commits reading the run-start version); got per-commit reads "
            "— use replay_trace_scan")
    n = len(trace)
    batches = _slice_batches(batches, n)
    c = grouped_coeffs(L, lr=lr, momentum=momentum,
                       weight_decay=weight_decay)
    p = [x.detach() for x in T.leaves(params)]
    dev = p[0].device
    a = torch.tensor(c.a, dtype=torch.float32, device=dev)
    b = torch.tensor(c.b, dtype=torch.float32, device=dev)
    v = [torch.zeros_like(x) for x in p]
    losses = []
    grad_fn = lambda q, bb: value_and_grad(loss_fn, q, bb)
    for r in range(n // L):
        run = T.tree_map(lambda x: x[r * L:(r + 1) * L], batches)
        run_losses, grads = stacked_group_grads(grad_fn,
                                                T.unflatten(params, p), run,
                                                L)
        losses.extend(run_losses)
        for j, g in enumerate(grads):
            g32 = g.float()                              # (L, ...)
            ext = (slice(None),) + (None,) * (g32.dim() - 1)
            p32, v32 = p[j].float(), v[j].float()
            p_new = c.cww * p32 + c.cwv * v32 + (a[ext] * g32).sum(dim=0)
            v_new = c.cvw * p32 + c.cvv * v32 + (b[ext] * g32).sum(dim=0)
            p[j], v[j] = p_new.to(p[j].dtype), v_new.to(v[j].dtype)
    return (T.unflatten(params, p),
            torch.stack(losses).float().cpu().numpy(), None)


def replay_trace(loss_fn: Callable, params, batches, trace: EventTrace, *,
                 lr: float, momentum: float = 0.0, weight_decay: float = 0.0,
                 impl: str = "scan", depth: Optional[int] = None,
                 record_params: bool = False):
    """Dispatch to one of the replay implementations (``impl``:
    "python" | "scan" | "fused")."""
    if impl == "python":
        return replay_trace_python(loss_fn, params, batches, trace, lr=lr,
                                   momentum=momentum,
                                   weight_decay=weight_decay, depth=depth,
                                   record_params=record_params)
    if impl == "scan":
        return replay_trace_scan(loss_fn, params, batches, trace, lr=lr,
                                 momentum=momentum,
                                 weight_decay=weight_decay, depth=depth,
                                 record_params=record_params)
    if impl == "fused":
        if record_params:
            raise ValueError("fused replay does not record parameter traces")
        if depth is not None:
            raise ValueError("fused replay keeps no parameter history — "
                             "depth bucketing only applies to python/scan")
        return replay_trace_fused(loss_fn, params, batches, trace, lr=lr,
                                  momentum=momentum,
                                  weight_decay=weight_decay)
    raise ValueError(f"unknown replay impl {impl!r}")


# ---------------------------------------------------------------------------
# Fig. 6 measured-momentum experiment (Theorem 1, executed)
# ---------------------------------------------------------------------------

def replayed_momentum_experiment(g: int, *, eta: float = 0.2,
                                 steps: int = 300, runs: int = 400,
                                 t_conv: float = 1.0, t_fc: float = 1e-3,
                                 a: float = 1.0, w0: float = 1.0,
                                 seed: int = 0,
                                 depth: Optional[int] = None,
                                 device="cpu") -> np.ndarray:
    """Run-averaged parameter trajectory (steps + 1,) of SGD (explicit mu =
    0) replayed along ``runs`` independent exponential-service traces from
    ``queue_sim.simulate`` on the 1-D quadratic ``loss = a w^2 / 2``.

    Feeding the result (with its analytic gradients ``a * w``) to
    ``implicit_momentum.measure_effective_momentum(..., fit_lr=True)``
    reproduces the paper's Fig. 6 measured-momentum panels: the fitted
    modulus approaches Theorem 1's ``1 - 1/g``.

    All runs replay at once through the ring loop with a leading runs axis
    (the reference ``vmap``s its scan over runs) and one common ring depth
    (default ``6 * g``; rare staleness beyond it is bucketed to the ring).
    """
    from repro_torch.core import queue_sim   # local: keeps exec light

    R = int(depth) if depth is not None else 6 * g
    t_idx = np.arange(steps)
    slot_rows = []
    for r in range(runs):
        _, tr = queue_sim.simulate(g=g, t_conv=t_conv, t_fc=t_fc,
                                   iters=steps, exponential=True,
                                   seed=seed + r, return_trace=True)
        # one ring depth R for every run, so the slots are computed
        # against exactly R, not the per-trace ring ``_read_slots`` picks
        rv = np.maximum(tr.read_version, t_idx - (R - 1))
        slot_rows.append((rv % R).astype(np.int32))
    slot_mat = np.stack(slot_rows, axis=1)              # (steps, runs)

    def loss_fn(p, batch):
        del batch
        return 0.5 * a * torch.sum(p["w"] ** 2)

    params = {"w": torch.full((runs,), w0, dtype=torch.float32,
                              device=device)}
    batches = torch.zeros((steps, 0), dtype=torch.float32, device=device)
    _, _, ptrace = _replay_core(loss_fn, params, batches, slot_mat, R,
                                lr=eta, momentum=0.0, weight_decay=0.0,
                                record_params=True)
    trajs = ptrace["w"].T.double().cpu().numpy()        # (runs, steps)
    full = np.concatenate(
        [np.full((runs, 1), w0, dtype=np.float64), trajs], axis=1)
    return full.mean(axis=0)
