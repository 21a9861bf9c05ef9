"""Run-environment metadata for the port's emitters.

The JAX package's ``obs/meta.py`` stamps jax/jaxlib and the XLA backend;
the port stamps what makes two of its measurements comparable instead:
the torch and CUDA versions, the device type, and the card's name and
count. The output is a flat ``str -> scalar`` dict, the ``meta.run``
payload of the metrics JSONL header (``obs.metrics``).
"""
from __future__ import annotations

import platform
from typing import Optional

import torch


def run_metadata(device: str = "cuda", extra: Optional[dict] = None) -> dict:
    """Describe the environment this process measures in on ``device``."""
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
    if extra:
        out.update(extra)
    return out
