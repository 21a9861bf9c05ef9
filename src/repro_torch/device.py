"""Where the port runs.

Every entry point (``ContinuousServer``, ``static_serve_trace``,
``launch/serve.py``) takes ``device=`` and defaults to ``"cuda"``: the
port is written for the card, and the CPU is something a caller asks for
(the tests do). Without a card, the default raises instead of quietly
running on the CPU.

``attn_impl`` names the attention path, one to one with the JAX
package's names:

=================  ===================  ====================================
port               JAX package          path
=================  ===================  ====================================
``"torch"``        ``"xla"``            plain PyTorch, bucketed gather ladder
``"cuda"``         ``"pallas"``         in-kernel page walk; flash prefill
``"cuda_gather"``  ``"pallas_gather"``  flash kernel over the gathered copy
=================  ===================  ====================================
"""
from __future__ import annotations

from typing import Optional, Union

import torch

ATTN_IMPLS = ("torch", "cuda", "cuda_gather")
KERNEL_IMPLS = ("cuda", "cuda_gather")


def resolve(device: Optional[Union[str, torch.device]] = "cuda"
            ) -> torch.device:
    """The device an entry point runs on; raises for CUDA without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


def check_attn_impl(attn_impl: str,
                    device: Union[str, torch.device]) -> None:
    """Reject unknown names, and kernel paths on tensors off the card."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                         f"not {attn_impl!r}")
    if attn_impl in KERNEL_IMPLS and torch.device(device).type != "cuda":
        raise ValueError(
            f"attn_impl={attn_impl!r} runs CUDA kernels and needs CUDA "
            f"tensors, not {torch.device(device).type!r} ones; use "
            "attn_impl='torch' on the CPU")
