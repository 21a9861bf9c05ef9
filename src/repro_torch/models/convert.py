"""Parameter conversion: the JAX package's pytree -> the port's tensors,
and the one dtype cast the server does at load.

``params_from_jax`` takes the JAX params as a tree of numpy arrays (e.g.
``jax.device_get(params)``; the port itself never imports JAX) and copies
it leaf by leaf: the same nested keys and lists (the CNN's ``{"conv":
[...], "fc": [...]}``, the ``core/workload`` models' flat dicts), the same
stacked ``blocks`` leading layer axis, the same layouts and dtypes (fp32
stays fp32, bf16 stays bf16). ``state_from_jax`` does the same for a
Runner state ``(params, step_counter)`` (``core.workload.init_state``).

``to_compute_dtype`` casts every weight that the layers cast to the
compute dtype at each use (projections, biases, MLP, experts, embedding)
once, so the per-use ``.to(cd)`` becomes a no-op with identical numbers.
Norm scales are read in fp32 by ``rms_norm`` and keep their dtype, and so
do the ``FP32_LEAVES``: the MoE router, the SSD decay and skip terms and
the RG-LRU decay rate, which the layers read in fp32 (the JAX package
stores them in fp32 whatever the param dtype).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: exact through fp32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree, cfg=None, device="cpu"):
    """The JAX param tree (numpy leaves) as the port's params on ``device``
    (``cfg``, an ``ArchConfig`` or ``CNNConfig``, is not needed: the layout
    is the same for every config the port runs)."""
    del cfg
    if isinstance(tree, dict):
        return {k: params_from_jax(v, None, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, None, device) for v in tree]
    return _tensor(tree, device)


def state_from_jax(state, device="cpu"):
    """A JAX Runner state ``(params as numpy leaves, step counter)`` as the
    port's ``(params on device, int)``."""
    params, step = state
    return params_from_jax(params, None, device), int(step)


#: leaves the layers read in fp32, never cast: ``moe.router``,
#: ``ssm.A_log`` / ``D`` / ``dt_bias`` and ``rglru.lambda_raw``
FP32_LEAVES = ("router", "A_log", "D", "dt_bias", "lambda_raw")


def _keeps_dtype(key: str) -> bool:
    """Norm scales (``ln``, ``ln1``..``ln3``, ``ln_f``, Whisper's
    ``enc_ln``) and the ``FP32_LEAVES`` keep their dtype under the
    compute-dtype cast."""
    return key.startswith("ln") or key.endswith("_ln") or key in FP32_LEAVES


def to_compute_dtype(params, cfg: ArchConfig, device=None):
    """Cast every weight used in the compute dtype, once (and move the tree
    to ``device`` if given); norm scales and the ``FP32_LEAVES`` keep their
    dtype. Returns a new tree; leaves already in place are shared, not
    copied."""
    cd = cfg.dtype("compute")

    def cast(tree):
        return {k: (cast(v) if isinstance(v, dict)
                    else v.to(device=device) if _keeps_dtype(k)
                    else v.to(device=device, dtype=cd))
                for k, v in tree.items()}

    return cast(params)
