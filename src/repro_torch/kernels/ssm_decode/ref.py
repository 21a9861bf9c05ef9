"""The plain PyTorch version of the Mamba-2 decode step's state update and
read-out (``models.ssm.ssm_decode``'s recurrence): the decay
and the input term as whole-state tensors, the state updated in place,
then the read-out as a batched matrix-vector product, all in fp32."""
from __future__ import annotations

import torch


def ssm_decode_ref(h, x, B, C, dt, A, D):
    """h: (S,H,P,N) fp32 state, updated in place; x: (S,H,P); B, C: (S,N);
    dt: (S,H) fp32 (0 on a row that must not advance: decay 1, nothing
    added); A, D: (H,) fp32. Returns y (S,H,P) in x's type."""
    xh = x.float()
    decay = torch.exp(-dt * A)[:, :, None, None]                  # (S,H,1,1)
    inject = torch.einsum("bh,bhp,bn->bhpn", dt, xh, B.float())
    h.mul_(decay).add_(inject)
    y = torch.einsum("bhpn,bn->bhp", h, C.float())
    y = y + D[:, None] * xh
    return y.to(x.dtype)
