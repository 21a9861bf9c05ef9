"""Products of the plain references at a stated precision.

``"fp32"``: float32 with TF32 off (the references' own precision).
``"tf32"``: both operands of every product rounded to TF32 (10 mantissa
bits, to nearest), accumulated in float32, as TF32 tensor cores do.
``"fp8"``: both operands scaled per tensor into float8 (e4m3 for the
forward operands, e5m2 for gradients, the usual training recipe),
accumulated in float32.

The lower two are the controls: the reference put in the program's
place one precision below the configuration's (TF32 for a float32
configuration, fp8 for qwen2-7b's bf16). The backward products round
their operands too.
"""
from __future__ import annotations

import contextlib

import torch

MODES = ("fp32", "tf32", "fp8")


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


def round_fp8(x: torch.Tensor, grad: bool = False) -> torch.Tensor:
    dt = torch.float8_e5m2 if grad else torch.float8_e4m3fn
    top = torch.finfo(dt).max
    x = x.float()
    amax = x.abs().amax().clamp(min=1e-30)
    s = amax / top
    return (x / s).to(dt).float() * s


def quant(x: torch.Tensor, mode: str, grad: bool = False) -> torch.Tensor:
    if mode == "fp32":
        return x.float()
    if mode == "tf32":
        return round_tf32(x)
    if mode == "fp8":
        return round_fp8(x, grad)
    raise ValueError(f"unknown precision {mode!r}")


class _MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, mode):
        qa, qb = quant(a, mode), quant(b, mode)
        ctx.save_for_backward(qa, qb)
        ctx.mode = mode
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = quant(g, ctx.mode, grad=True)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.transpose(-1, -2) @ qg
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb, None


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str = "fp32"):
    """``a @ b`` with its products at ``mode`` (``b`` 2-D, or batched as
    ``a`` is)."""
    if mode == "fp32":
        return a.float() @ b.float()
    return _MatMul.apply(a.float(), b.float(), mode)
