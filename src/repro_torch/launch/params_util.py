"""Parameter counting (total and MoE-active) over param trees — the JAX
package's ``launch/params_util.py``. Its ``eval_shape`` specs become a tree
on ``torch.device("meta")`` (``launch.steps.params_specs``: every shape
and dtype, nothing allocated); paths are ``core.tree``'s tuples of dict
keys and list indices."""
from __future__ import annotations

import math

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tree as T


def param_count(params) -> int:
    return sum(math.prod(leaf.shape) for leaf in T.leaves(params))


def param_bytes(params) -> int:
    return sum(math.prod(leaf.shape) * leaf.element_size()
               for leaf in T.leaves(params))


def active_param_count(params, cfg: ArchConfig) -> int:
    """MoE: per-token active params = non-expert params + top_k/E of routed
    expert params (+ shared experts, always active)."""
    if cfg.moe is None:
        return param_count(params)
    total = 0
    routed = 0
    for path, leaf in T.leaves_with_path(params):
        n = math.prod(leaf.shape)
        if any(k in ("w_gate", "w_up", "w_down") for k in path) \
                and "shared" not in path and "mlp" not in path \
                and leaf.dim() >= 3:
            routed += n
        else:
            total += n
    return total + routed * cfg.moe.top_k // cfg.moe.num_experts
