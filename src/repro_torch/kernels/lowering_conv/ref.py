"""Plain PyTorch references for the lowering+GEMM convolution (paper §III,
Fig. 2), in the JAX package's layouts: NHWC activations, HWIO weights,
VALID padding.

Two references: the native convolution, and an explicit lowering / GEMM /
lifting pipeline that mirrors the paper's three logical steps (used to
check the kernel implements the *same algorithm*, not just the same
function).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x: (B, H, W, Cin); w: (kh, kw, Cin, Cout); VALID padding."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def lower(x: torch.Tensor, kh: int, kw: int, stride: int = 1) -> torch.Tensor:
    """Lowering phase: (B,H,W,Cin) -> D_hat (B*Ho*Wo, kh*kw*Cin).
    Data replication factor = kh*kw/stride^2 (paper App C-A1)."""
    b, h, w, cin = x.shape
    ho = (h - kh) // stride + 1
    wo = (w - kw) // stride + 1
    cols = [x[:, i:i + (ho - 1) * stride + 1:stride,
              j:j + (wo - 1) * stride + 1:stride, :]          # (B, Ho, Wo, Cin)
            for i in range(kh) for j in range(kw)]
    low = torch.stack(cols, dim=3)                # (B, Ho, Wo, kh*kw, Cin)
    return low.reshape(b * ho * wo, kh * kw * cin)


def lowered_conv_ref(x: torch.Tensor, w: torch.Tensor,
                     stride: int = 1) -> torch.Tensor:
    """Lowering -> one big GEMM -> lifting (the paper's CPU-optimal plan
    with b_p = b)."""
    b, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    ho = (h - kh) // stride + 1
    wo = (wd - kw) // stride + 1
    d_hat = lower(x, kh, kw, stride)                    # (B*Ho*Wo, khkwCin)
    k_hat = w.reshape(kh * kw * cin, cout)              # no kernel replication
    r_hat = d_hat @ k_hat                               # GEMM
    return r_hat.reshape(b, ho, wo, cout)               # lifting
