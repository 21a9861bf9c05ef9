"""Trainable lowering conv: one ``torch.autograd.Function`` per arm.

``lowering_conv`` (the kernels: ``csrc/lowering_conv.cu``, ``wgrad.cu``,
``dgrad.cu``) and ``lowering_conv_torch`` (the same algorithm in plain
PyTorch, the JAX ``lowering_conv_xla``) carry a custom backward that
expresses both gradients as GEMMs over the *same* lowered patch matrix the
forward built (``bwd.py``):

  wgrad = lowered(x)^T @ dy        reusing the forward's lowered residual
  dgrad = dy @ K_hat^T, col2im     one GEMM + the lifting phase transposed
                                   (the dgrad kernel computes the same sum
                                   as one implicit GEMM over the taps)

The forward saves the lowered residual and ``w`` (as the JAX
``_lc_xla_fwd`` / ``_lc_pallas_fwd`` do) whenever a gradient is wanted.
``needs_dgrad=False`` skips the input gradient (Caffe's
``propagate_down=false`` for data-fed layers): the backward returns zeros
for it and launches no dgrad kernel.

``lowering_conv_autodiff`` is the same lowering/GEMM differentiated by
plain autograd, kept as the baseline.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.lowering_conv import bwd
from repro_torch.kernels.lowering_conv.lowering_conv import lowering_conv_cuda
from repro_torch.kernels.lowering_conv.ref import lower, lowered_conv_ref


class _LoweringConvTorch(torch.autograd.Function):
    """Plain arm: lowering + one matmul, custom backward (JAX ``_lc_xla``)."""

    @staticmethod
    def forward(ctx, x, w, stride: int, needs_dgrad: bool):
        b, h, wd, cin = x.shape
        kh, kw, _, cout = w.shape
        ho = (h - kh) // stride + 1
        wo = (wd - kw) // stride + 1
        d_hat = lower(x, kh, kw, stride)                 # lowering phase
        r = d_hat @ w.reshape(kh * kw * cin, cout)       # one big GEMM
        ctx.save_for_backward(d_hat, w)                  # d_hat: the residual
        ctx.conf = (stride, needs_dgrad, tuple(x.shape))
        return r.reshape(b, ho, wo, cout)

    @staticmethod
    def backward(ctx, dy):
        d_hat, w = ctx.saved_tensors
        stride, needs_dgrad, x_shape = ctx.conf
        dw = bwd.wgrad_ref(d_hat, dy, w.shape)
        if needs_dgrad:
            dx = bwd.dgrad_ref(dy, w, x_shape, stride)
        else:
            dx = torch.zeros(x_shape, dtype=dy.dtype, device=dy.device)
        return dx, dw, None, None


class _LoweringConvCuda(torch.autograd.Function):
    """Kernel arm: the forward kernel writes the residual, the backward runs
    the wgrad and (if needed) dgrad kernels (JAX ``_lc_pallas``), each in
    its tiles of ``tiles`` (a ``bwd.ConvTiles``; None: the default
    rule)."""

    @staticmethod
    def forward(ctx, x, w, stride: int, needs_dgrad: bool, tiles):
        x, w = x.contiguous(), w.contiguous()
        ctx.conf = (stride, needs_dgrad, tuple(x.shape), tiles)
        if not any(ctx.needs_input_grad[:2]):
            return lowering_conv_cuda(x, w, stride=stride, tiles=tiles)
        y, lowered = lowering_conv_cuda(x, w, stride=stride,
                                        return_lowered=True, tiles=tiles)
        ctx.save_for_backward(lowered, w)
        return y

    @staticmethod
    def backward(ctx, dy):
        lowered, w = ctx.saved_tensors
        stride, needs_dgrad, x_shape, tiles = ctx.conf
        dy = dy.contiguous()
        dw = bwd.wgrad_cuda(lowered, dy, w.shape, tiles=tiles)
        if needs_dgrad:
            dx = bwd.dgrad_cuda(dy, w, x_shape, stride=stride, tiles=tiles)
        else:
            dx = torch.zeros(x_shape, dtype=dy.dtype, device=dy.device)
        return dx, dw.to(w.dtype), None, None, None


def lowering_conv_torch(x, w, *, stride: int = 1, needs_dgrad: bool = True):
    """Convolution via lowering + one big GEMM in plain PyTorch (the
    paper's CPU plan with b_p = b), with the custom batched-GEMM backward."""
    return _LoweringConvTorch.apply(x, w, stride, needs_dgrad)


def lowering_conv(x, w, *, stride: int = 1, needs_dgrad: bool = True,
                  tiles=None):
    """Convolution via the lowering-conv kernel, trainable through the
    wgrad and dgrad kernels, in ``tiles`` (a ``bwd.ConvTiles``; default
    ``bwd.default_tiles(w.shape)``). CUDA tensors only: the kernel
    wrappers take their plain versions for CPU tensors, but this arm is
    the kernels'."""
    if x.device.type != "cuda":
        raise ValueError("lowering_conv runs the CUDA kernels and needs CUDA "
                         "tensors; use lowering_conv_torch on the CPU")
    return _LoweringConvCuda.apply(x, w, stride, needs_dgrad, tiles)


def lowering_conv_autodiff(x, w, *, stride: int = 1):
    """The same lowering/GEMM algorithm differentiated by plain autograd —
    the baseline the custom backward is measured against."""
    return lowered_conv_ref(x, w, stride=stride)
