"""SGD with momentum exactly as paper eq. (3)-(4):

    V <- mu * V - eta * (grad + lambda * W)
    W <- W + V

Momentum buffers may live in a reduced dtype. Trees are the port's nested
dicts / lists of tensors (``core.tree``); the arithmetic is the JAX
package's ``optim/sgd.py``, op for op, in fp32."""
from __future__ import annotations

import torch

from repro_torch.core import tree as T


def init_momentum(params, dtype=None):
    return T.tree_map(lambda p: torch.zeros_like(p, dtype=dtype or p.dtype),
                      params)


def sgd_update(params, grads, momentum_buf, *, lr, momentum=0.0,
               weight_decay=0.0):
    """One paper-eq-(3)/(4) update in a single tree traversal.
    Returns (new_params, new_momentum)."""
    def leaf(p, g, v):
        g32 = g.float()
        if weight_decay:
            g32 = g32 + weight_decay * p.float()
        v_new = momentum * v.float() - lr * g32
        p_new = p.float() + v_new
        return p_new.to(p.dtype), v_new.to(v.dtype)

    # tree_map raises on a structure mismatch (a bare zip would mis-pair)
    pairs = T.tree_map(leaf, params, grads, momentum_buf)
    return T.unzip2(pairs, params)
