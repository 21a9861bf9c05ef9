"""Hardware-efficiency (HE) model — paper §IV-B, on the card's own figures.

    HE(g) = max( t_fc,  (t_conv(k) + t_fc) / g ),   k = N / g
    t_conv(k) = max( t_conv_compute(1)/k , t_conv_network(k) )

The paper's parameter-server network term ``T_n,c * k`` (Ethernet
congestion) becomes the ring reduce-scatter + all-gather time of the
backbone gradients over the group's interconnect — bandwidth-optimal and
~flat in k:
    t_coll(k) = 2 * bytes * (k-1)/k / link_bw
(per-device time; ~2*bytes/link_bw for large k).

The JAX package's ``core/hardware_model.py`` with every function and its
arithmetic kept; only the default spec differs: ``H100``, the data-sheet
figures of one NVIDIA H100 SXM (dense bf16 tensor-core peak, HBM3 rate,
NVLink rate per direction). ``phase_times_from_roofline`` fits the model
from FLOP and byte counts of the two phases.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    """One accelerator's roofline: peak FLOP/s, device-memory bytes/s and
    the per-direction rate of the link a group's collectives run over."""
    name: str = "gpu-h100-sxm"
    peak_flops: float = 989e12          # dense bf16 FLOP/s per card
    hbm_bw: float = 3.35e12             # HBM3 bytes/s per card
    link_bw: float = 450e9              # NVLink bytes/s per direction


H100 = GPUSpec()


def collective_time(bytes_per_chip: float, k: int, spec: GPUSpec = H100
                    ) -> float:
    """Ring reduce-scatter + all-gather over a group of size k."""
    if k <= 1:
        return 0.0
    return 2.0 * bytes_per_chip * (k - 1) / k / spec.link_bw


@dataclasses.dataclass(frozen=True)
class PhaseTimes:
    """One-device phase times (paper's T_c,c / t_fc) + collective volume."""
    t_conv_compute_1: float      # backbone fwd+bwd on ONE device, seconds
    t_fc: float                  # head phase service time, seconds
    conv_grad_bytes: float       # backbone grad bytes (per-chip, for t_coll)


def t_conv(k: int, ph: PhaseTimes, spec: GPUSpec = H100) -> float:
    """Group-of-k backbone time: compute shrinks /k, collectives overlap
    (paper's max(), §App D-D1)."""
    comp = ph.t_conv_compute_1 / k
    coll = collective_time(ph.conv_grad_bytes, k, spec)
    return max(comp, coll)


def he_time_per_iteration(g: int, n_devices: int, ph: PhaseTimes,
                          spec: GPUSpec = H100) -> float:
    """Predicted time per iteration for g compute groups (paper HE model)."""
    if n_devices % g:
        raise ValueError(f"g={g} must divide N={n_devices}")
    k = n_devices // g
    return max(ph.t_fc, (t_conv(k, ph, spec) + ph.t_fc) / g)


def fc_saturated(g: int, n_devices: int, ph: PhaseTimes,
                 spec: GPUSpec = H100) -> bool:
    """Paper's saturation condition: t_conv(k) + t_fc < g * t_fc."""
    k = n_devices // g
    return t_conv(k, ph, spec) + ph.t_fc < g * ph.t_fc


def smallest_saturating_g(n_devices: int, ph: PhaseTimes,
                          spec: GPUSpec = H100) -> int:
    """Optimizer short-circuit (§App E-C1): start Algorithm 1 at the smallest
    g that saturates the FC server."""
    g = 1
    while g < n_devices:
        if fc_saturated(g, n_devices, ph, spec):
            return g
        g *= 2
    return n_devices


def he_penalty(g: int, n_devices: int, ph: PhaseTimes,
               spec: GPUSpec = H100) -> float:
    """P_HE(S) = HE(S)/HE(0), normalized to sync (paper App D-D)."""
    return (he_time_per_iteration(g, n_devices, ph, spec)
            / he_time_per_iteration(1, n_devices, ph, spec))


def phase_times_from_roofline(*, backbone_flops: float, head_flops: float,
                              backbone_bytes: float, head_bytes: float,
                              grad_bytes_per_chip: float,
                              spec: GPUSpec = H100) -> PhaseTimes:
    """Derive the HE model's parameters from roofline terms (single-device
    FLOPs/bytes split between backbone and head phases)."""
    t_conv_1 = max(backbone_flops / spec.peak_flops,
                   backbone_bytes / spec.hbm_bw)
    t_fc = max(head_flops / spec.peak_flops, head_bytes / spec.hbm_bw)
    return PhaseTimes(t_conv_compute_1=t_conv_1, t_fc=t_fc,
                      conv_grad_bytes=grad_bytes_per_chip)
