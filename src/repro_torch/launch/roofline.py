"""Three-term roofline and the analytic traffic model (the JAX package's
``launch/hlo_analysis.py``), with the H100's data-sheet rates as the
defaults.

``Roofline``, ``analytic_hbm_bytes`` and ``model_flops_6nd`` keep the JAX
arithmetic. Only ``Roofline``'s default rates differ: those of
``core.hardware_model.H100`` (dense bf16 tensor-core peak, HBM3, NVLink),
not TPU v5e's. The JAX module's ``collective_stats`` and
``roofline_from_compiled`` read XLA artifacts (HLO text, a compiled
executable) that the port does not have: the step's FLOPs come from
``launch.meta_count.count_step`` and its exchange from
``engine.spmd.exchange_bytes``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.hardware_model import H100


@dataclasses.dataclass
class Roofline:
    """Three-term roofline (per card, seconds)."""
    flops: float                   # per-card step FLOPs
    hbm_bytes: float               # per-card bytes accessed
    collective_bytes: float        # per-card exchange bytes received
    chips: int
    peak_flops: float = H100.peak_flops
    hbm_bw: float = H100.hbm_bw
    link_bw: float = H100.link_bw

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / self.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": self.collective_bytes, "chips": self.chips,
                "t_compute": self.t_compute, "t_memory": self.t_memory,
                "t_collective": self.t_collective,
                "bottleneck": self.bottleneck, "step_time": self.step_time}


def analytic_hbm_bytes(cfg, shape, chips: int, *, grad_accum: int = 1,
                       params_bytes_global: float = 0.0,
                       cache_bytes_global: float = 0.0) -> float:
    """Per-card HBM traffic model (the roofline memory term):

    train:   3x params (fwd read, bwd read, update write) + 2x momentum +
             saved activations written+read once each (remat recomputes
             instead of storing, so only layer-boundary residuals count).
    prefill: params read once + activations + cache write.
    decode:  params read once (one token!) + full cache read + write.
    """
    act_dtype = cfg.dtype("compute").itemsize
    L = max(cfg.num_layers, 1)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        act = tokens * cfg.d_model * act_dtype * L * 2.0
        return (5.0 * params_bytes_global + act) / chips
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        act = tokens * cfg.d_model * act_dtype * L * 2.0
        return (params_bytes_global + act + cache_bytes_global) / chips
    # decode
    return (params_bytes_global + 2.0 * cache_bytes_global
            + shape.global_batch * cfg.d_model * act_dtype * L * 2.0) / chips


def model_flops_6nd(num_params: float, tokens: float) -> float:
    """MODEL_FLOPS = 6 * N * D (dense); pass N_active for MoE."""
    return 6.0 * num_params * tokens
