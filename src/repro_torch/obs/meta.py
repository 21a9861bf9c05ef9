"""Run-environment metadata for the port's emitters.

The JAX package's ``obs/meta.py`` stamps jax/jaxlib and the XLA backend;
the port stamps what makes two of its measurements comparable instead:
the torch and CUDA versions, the device type, and the card's name and
count (and the engine mesh's shape, when given). The output is a flat
``str -> scalar`` dict, the ``meta.run`` payload of the metrics JSONL
header (``obs.metrics``).

``STRICT_KEYS`` is the comparability contract, led by the torch version
where the JAX package's leads with ``jax``: keys that must match for two
stamps' timings to be compared. Host speed (CPU model, core count) is not
in it. ``env_mismatches`` lists the differences.
"""
from __future__ import annotations

import platform
from typing import Optional, Sequence, Tuple

import torch

#: stamp keys that must be equal for two measurements to be compared
STRICT_KEYS = ("torch", "cuda", "backend", "device_kind", "device_count")


def run_metadata(device: str = "cuda", extra: Optional[dict] = None, *,
                 mesh_shape: Optional[Sequence[int]] = None) -> dict:
    """Describe the environment this process measures in on ``device``;
    ``mesh_shape`` (e.g. the engine's (g, k, mp)) is stamped as "2x4"."""
    on_card = torch.device(device).type == "cuda"
    out = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "backend": "cuda" if on_card else "cpu",
        "device_count": torch.cuda.device_count() if on_card else 1,
        "device_kind": (torch.cuda.get_device_name(torch.device(device))
                        if on_card else platform.processor() or "cpu"),
        "python": platform.python_version(),
        "machine": platform.machine(),
    }
    if mesh_shape is not None:
        out["mesh_shape"] = "x".join(str(int(d)) for d in mesh_shape)
    if extra:
        out.update(extra)
    return out


def env_mismatches(base: Optional[dict], fresh: Optional[dict],
                   keys: Sequence[str] = STRICT_KEYS) -> Tuple[str, ...]:
    """Strict-key differences between two ``run_metadata`` stamps, as
    human-readable strings; empty when comparable. An absent stamp, or a
    key absent from either, compares as unknown but compatible (the JAX
    semantics: a baseline written before stamps existed stays usable)."""
    if not base or not fresh:
        return ()
    return tuple(f"{k}: base={base[k]!r} fresh={fresh[k]!r}"
                 for k in keys
                 if k in base and k in fresh and base[k] != fresh[k])
