"""The plain PyTorch version of the fused grouped update (and the
``update_impl="torch"`` path): the closed-form weighted combination,
accumulated in fp32 in exactly the JAX ``fused_update_ref``'s order:
first ``cww*W + cwv*V`` and ``cvw*W + cvv*V``, then ``+ a[i]*G_i`` and
``+ b[i]*G_i`` for ``i = 0..g-1``, every product and sum rounded to fp32
on its own (a Python-float coefficient times an fp32 tensor rounds the
coefficient to fp32, as in JAX)."""
from __future__ import annotations

import torch

from repro_torch.optim.closed_form import GroupedCoeffs


def fused_update_ref(w: torch.Tensor, v: torch.Tensor, gstack: torch.Tensor,
                     coeffs: GroupedCoeffs):
    """One leaf OR one bucket slab: w/v any shape (including a flat (n,)
    packing of several leaves), gstack (g, *w.shape). The combination is
    purely elementwise, so slab and per-leaf results are bit-identical.
    Returns (w_new, v_new)."""
    if gstack.shape[0] != coeffs.num_groups:
        raise ValueError(f"gstack has {gstack.shape[0]} groups, "
                         f"coeffs {coeffs.num_groups}")
    w32 = w.float()
    v32 = v.float()
    w_new = coeffs.cww * w32 + coeffs.cwv * v32
    v_new = coeffs.cvw * w32 + coeffs.cvv * v32
    for i in range(coeffs.num_groups):
        g32 = gstack[i].float()
        w_new = w_new + coeffs.a[i] * g32
        v_new = v_new + coeffs.b[i] * g32
    return w_new.to(w.dtype), v_new.to(v.dtype)
