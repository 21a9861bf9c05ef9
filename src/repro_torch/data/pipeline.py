"""Data pipeline: deterministic synthetic corpora (token LM + image
classification) behind the iterator interface a file-backed loader would
use, with per-host sharding and prefetch.

``DataConfig``, ``SyntheticLM`` and ``SyntheticImages`` are the JAX
package's ``data/pipeline.py`` as they are (numpy only), so the port draws
exactly the same token and image streams from the same seed. ``prefetch``
owns the one host-to-device copy: pinned host memory and a non-blocking
copy onto the card.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int
    seq_len: int = 0               # LM
    image_size: int = 0            # vision
    channels: int = 3
    vocab_size: int = 0
    num_classes: int = 0
    seed: int = 0
    host_index: int = 0            # per-host sharding
    host_count: int = 1


class SyntheticLM:
    """Markov-chain token stream: next token depends on the current one, so
    a model can actually reduce loss below uniform entropy.

    Sampling is the inverse-CDF over cumulative transition rows,
    precomputed once: row v of the cumulative matrix is offset by +v, so
    the flattened array is globally sorted and one vectorized
    ``searchsorted`` per timestep samples the whole batch (the old path
    re-did a (local, V) gather + cumsum + compare-sum per timestep in
    Python, which dominated small-step runs). Draws the same uniforms in
    the same order as the old loop, so token streams are unchanged.
    """

    def __init__(self, cfg: DataConfig, order_temp: float = 2.0):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        logits = rng.normal(size=(min(v, 512), min(v, 512))) * order_temp
        self._trans = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        self._v_eff = min(v, 512)
        cum = np.cumsum(self._trans, axis=-1)
        cum[:, -1] = 1.0          # exact top: u in [0,1) can never overflow
        self._cum_flat = (cum + np.arange(self._v_eff)[:, None]).ravel()

    def batches(self, steps: int) -> Iterator[dict]:
        """Yields HOST numpy batches — ``prefetch`` owns the single
        host->device copy."""
        cfg = self.cfg
        local = cfg.batch_size // cfg.host_count
        v = self._v_eff
        rng = np.random.default_rng(
            (cfg.seed, cfg.host_index, 1))
        for _ in range(steps):
            toks = np.empty((local, cfg.seq_len + 1), dtype=np.int32)
            toks[:, 0] = rng.integers(v, size=local)
            for t in range(cfg.seq_len):
                cur = toks[:, t]
                u = rng.random(local)
                nxt = np.searchsorted(self._cum_flat, cur + u) - cur * v
                # clip both ends: u == 0.0 exactly lands on the previous
                # row's terminal 1.0 (-> -1); float roundoff near 1 could
                # land past the row (-> v)
                toks[:, t + 1] = np.clip(nxt, 0, v - 1)
            yield {"tokens": np.ascontiguousarray(toks[:, :-1]),
                   "labels": np.ascontiguousarray(toks[:, 1:])}


class SyntheticImages:
    """Class-prototype images + noise (paper's CNN workloads shape)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self._protos = rng.normal(size=(cfg.num_classes, cfg.image_size,
                                        cfg.image_size, cfg.channels))

    def batches(self, steps: int) -> Iterator[dict]:
        """Yields HOST numpy batches (transfer belongs to ``prefetch``)."""
        cfg = self.cfg
        local = cfg.batch_size // cfg.host_count
        rng = np.random.default_rng((cfg.seed, cfg.host_index, 2))
        for _ in range(steps):
            y = rng.integers(cfg.num_classes, size=local)
            x = self._protos[y] + 0.5 * rng.normal(
                size=(local, cfg.image_size, cfg.image_size, cfg.channels))
            yield {"images": x.astype(np.float32),
                   "labels": y.astype(np.int32)}


def _to_device(batch: dict, device: torch.device) -> dict:
    if device.type != "cuda":          # the caller asked for the CPU
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
        device, non_blocking=True) for k, v in batch.items()}


def prefetch(it: Iterator[dict], depth: int = 2, tracer=None, metrics=None,
             device="cuda") -> Iterator[dict]:
    """Software pipeline that owns the host->device copy.

    Generators yield HOST numpy batches and ``prefetch`` issues the copy
    ``depth`` batches ahead of consumption: each array is pinned and copied
    with ``non_blocking=True`` on the current stream, so the copy of batch
    i+depth is queued behind the step computing on batch i while the host
    goes on generating. (PyTorch's pinned-memory allocator keeps a pinned
    buffer until the copy that reads it has run.) On a CPU ``device`` the
    batch is wrapped as tensors, with no copy to make.

    ``tracer`` (an ``obs.spans`` tracer; defaults to the installed one)
    wraps each copy in a ``data.h2d`` span; ``metrics`` (an
    ``obs.metrics.MetricRegistry``) records the copy's dispatch wall time
    into an ``h2d_s`` series. Both are free when disabled.
    """
    from repro_torch.obs import spans
    device = torch.device(device)
    if tracer is None:
        tracer = spans.current()
    h2d = metrics.series("h2d_s") if metrics is not None else None
    buf = collections.deque()
    for i, batch in enumerate(it):
        with tracer.span("data.h2d", index=i):
            t0 = time.perf_counter()
            dev = _to_device(batch, device)
            if h2d is not None:
                h2d.append(time.perf_counter() - t0, step=i)
        buf.append(dev)
        if len(buf) > depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
