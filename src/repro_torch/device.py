"""Where the port runs.

Every entry point (``ContinuousServer``, ``static_serve_trace``,
``launch/serve.py``, ``engine.Engine``, ``launch/train.py``) takes
``device=`` and defaults to ``"cuda"``: the port is written for the card,
and the CPU is something a caller asks for (the tests do). Without a card,
the default raises instead of quietly running on the CPU.

``attn_impl`` names the attention path, one to one with the JAX
package's names:

=================  ===================  ====================================
port               JAX package          path
=================  ===================  ====================================
``"torch"``        ``"xla"``            plain PyTorch, bucketed gather ladder
``"cuda"``         ``"pallas"``         in-kernel page walk; flash prefill
``"cuda_gather"``  ``"pallas_gather"``  flash kernel over the gathered copy
=================  ===================  ====================================

``update_impl`` names the grouped update's leaf path and ``conv_impl`` the
CNN convolution in the same way (port = JAX package: path):

- update ``"torch"`` = ``"xla"``: the plain fused update;
- update ``"cuda"`` = ``"pallas"``: the fused-update kernel;
- conv ``"torch"`` = ``"xla"``: the native convolution (``F.conv2d``);
- conv ``"lowering"`` = ``"lowering"``: lowering + matmul, custom backward;
- conv ``"lowering_cuda"`` = ``"lowering_interpret"``: the lowering-conv,
  wgrad and dgrad kernels;
- conv ``"lowering_autodiff"`` = ``"lowering_autodiff"``: the lowering
  under autograd.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

ATTN_IMPLS = ("torch", "cuda", "cuda_gather")
KERNEL_IMPLS = ("cuda", "cuda_gather")
UPDATE_IMPLS = ("torch", "cuda")
CONV_IMPLS = ("torch", "lowering", "lowering_cuda", "lowering_autodiff")


def resolve(device: Optional[Union[str, torch.device]] = "cuda"
            ) -> torch.device:
    """The device an entry point runs on; raises for CUDA without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


def _check(kind: str, impl: str, names, kernels, plain: str,
           device: Union[str, torch.device]) -> None:
    if impl not in names:
        raise ValueError(f"{kind} must be one of {names}, not {impl!r}")
    if impl in kernels and torch.device(device).type != "cuda":
        raise ValueError(
            f"{kind}={impl!r} runs CUDA kernels and needs CUDA tensors, not "
            f"{torch.device(device).type!r} ones; use {kind}={plain!r} on "
            "the CPU")


def check_attn_impl(attn_impl: str,
                    device: Union[str, torch.device]) -> None:
    """Reject unknown names, and kernel paths on tensors off the card."""
    _check("attn_impl", attn_impl, ATTN_IMPLS, KERNEL_IMPLS, "torch", device)


def check_update_impl(update_impl: str,
                      device: Union[str, torch.device]) -> None:
    """The same for the grouped update's leaf path."""
    _check("update_impl", update_impl, UPDATE_IMPLS, ("cuda",), "torch",
           device)


def check_conv_impl(conv_impl: str,
                    device: Union[str, torch.device]) -> None:
    """The same for the CNN convolution."""
    _check("conv_impl", conv_impl, CONV_IMPLS, ("lowering_cuda",),
           "lowering", device)
