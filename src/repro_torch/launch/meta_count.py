"""FLOPs and live bytes of one step, counted while it runs (the port's
counterpart of the JAX package's ``launch/hlo_parse.py`` walk).

The JAX dry-run compiles a step and walks its optimized HLO, weighting
each dot by its loops' trip counts. The port has no compiled program to
walk, so ``count_step`` runs the step itself, on whatever device its
inputs are on: ``torch.device("meta")`` for the dry-run (full size,
nothing allocated) and the card in ``chip_smoke.py``. Two dispatch modes
watch every ATen call:

- ``torch.utils.flop_counter.FlopCounterMode`` counts the FLOPs of the
  matrix products and convolutions (2·M·N·K per product, as the HLO walk
  counts a dot), forward, backward and rematerialised recompute alike;
- ``LiveBytes`` adds the bytes of each storage an op creates and takes
  them off when the storage is freed, so its peak is the most memory the
  step held at once beyond its inputs (the counterpart of XLA's
  ``temp_size_in_bytes``).

Both see only ATen calls. A hand-written kernel launched through
``ctypes`` is invisible to them: a prefill or decode step counted with
``attn_impl="cuda"`` would count its attention as zero FLOPs, and a
kernel's output allocated by its wrapper is seen only as that wrapper's
``torch.empty``. The dry-run counts the ``"torch"`` arms.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


@dataclasses.dataclass
class StepCount:
    flops: int                     # matrix-product and convolution FLOPs
    flops_by_op: Dict[str, int]    # ATen op name -> FLOPs
    peak_live_bytes: int           # most bytes held at once beyond inputs
    end_live_bytes: int            # bytes still held when the step returns


class LiveBytes(TorchDispatchMode):
    """Bytes of the storages created under this mode that are still alive,
    and their peak. A storage first seen as an op's input existed before
    the mode and is never counted; one first seen as an op's output is
    counted once (views and in-place results share it) until it is freed.
    Frees may run on the autograd engine's thread, hence the lock."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen: set = set()
        self._lock = threading.Lock()

    def _free(self, key: int, n: int) -> None:
        with self._lock:
            self._seen.discard(key)
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in tree_leaves((args, kwargs)):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            with self._lock:
                if st._cdata in self._seen:
                    continue
                self._seen.add(st._cdata)
            # forgotten when freed, so that a later storage at its address
            # is counted
            weakref.finalize(st, self._free, st._cdata, 0)
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            with self._lock:
                if st._cdata in self._seen:
                    continue
                self._seen.add(st._cdata)
                n = st.nbytes()
                self.live += n
                self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, st._cdata, n)
        return out


def count_step(fn: Callable, *args) -> StepCount:
    """Run ``fn(*args)`` once under ``FlopCounterMode`` and ``LiveBytes``
    and return what they counted. The inputs' own bytes are not counted;
    ``end_live_bytes`` is what the outputs (and anything the step left
    behind) hold when ``fn`` returns."""
    live = LiveBytes()
    with FlopCounterMode(display=False) as fc:
        with live:
            out = fn(*args)
        end = live.live
    del out
    by_op = {str(op): int(n) for op, n in
             fc.get_flop_counts().get("Global", {}).items()}
    return StepCount(flops=int(fc.get_total_flops()), flops_by_op=by_op,
                     peak_live_bytes=int(live.peak), end_live_bytes=int(end))
