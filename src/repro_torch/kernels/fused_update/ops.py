"""Public wrappers for the fused grouped update: the kernel's wrapper
(``fused_update_cuda``), the per-leaf and per-slab entry points with the
``impl`` switch, and the single-traversal tree-level update.

``impl``: ``"torch"`` (= the JAX ``"xla"``) runs the plain version,
``ref.fused_update_ref``; ``"cuda"`` (= ``"pallas"``) runs
``csrc/fused_update.cu`` and needs CUDA tensors. The kernel's wrapper takes
the plain version for a tensor on the CPU and launches the kernel (or
raises) for a CUDA one; every launch adds one to
``fused_update_cuda.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import tree as T
from repro_torch.device import check_update_impl
from repro_torch.kernels import _build
from repro_torch.kernels.fused_update.ref import fused_update_ref
from repro_torch.optim.closed_form import GroupedCoeffs

KERNEL = "fused_update"
MAX_GROUPS = 64
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ``fused_update_launch``'s C signature, in order
ARGTYPES = [_P] * 6 + [_I, ctypes.c_longlong] + [_I] * 4 + [_P]


def _check(w, v, gstack, g: int) -> None:
    for name, t in (("v", v), ("gstack", gstack)):
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")
    for name, t in (("w", w), ("v", v), ("gstack", gstack)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} dtype {t.dtype} not in {tuple(DTYPES)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if v.shape != w.shape or gstack.shape[1:] != w.shape:
        raise ValueError(f"shapes w {tuple(w.shape)}, v {tuple(v.shape)}, "
                         f"gstack {tuple(gstack.shape)} do not match")
    if g > MAX_GROUPS:
        raise ValueError(f"g = {g} groups > {MAX_GROUPS}")


def fused_update_cuda(w, v, gstack, coeffs: GroupedCoeffs):
    """One leaf or slab through the kernel: w/v any shape, gstack
    (g, *w.shape). Returns (w_new, v_new) in w's and v's dtypes."""
    g = gstack.shape[0]
    if g != coeffs.num_groups:
        raise ValueError(f"gstack has {g} groups, coeffs {coeffs.num_groups}")
    if w.device.type != "cuda":
        return fused_update_ref(w, v, gstack, coeffs)
    _check(w, v, gstack, g)
    wo, vo = torch.empty_like(w), torch.empty_like(v)
    host = (ctypes.c_float * (4 + 2 * g))(
        coeffs.cww, coeffs.cwv, coeffs.cvw, coeffs.cvv, *coeffs.a, *coeffs.b)
    err = _build.launcher(KERNEL, ARGTYPES)(
        w.data_ptr(), v.data_ptr(), gstack.data_ptr(), wo.data_ptr(),
        vo.data_ptr(), ctypes.addressof(host), g, w.numel(), DTYPES[w.dtype],
        DTYPES[v.dtype], DTYPES[gstack.dtype], w.device.index or 0,
        torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, KERNEL)
    fused_update_cuda.launches += 1
    return wo, vo


fused_update_cuda.launches = 0


def _leaf_update(w, v, gstack, coeffs: GroupedCoeffs, *, impl: str):
    check_update_impl(impl, w.device)
    if impl == "cuda":
        return fused_update_cuda(w, v, gstack, coeffs)
    return fused_update_ref(w, v, gstack, coeffs)


def fused_update(w, v, gstack, *, coeffs: GroupedCoeffs, impl: str = "torch"):
    """One leaf: impl='cuda' runs the kernel, impl='torch' the plain
    combination."""
    return _leaf_update(w, v, gstack, coeffs, impl=impl)


def fused_bucket_update(w_slab, v_slab, gstack, *, coeffs: GroupedCoeffs,
                        impl: str = "torch"):
    """One flat slab: ``w_slab`` / ``v_slab`` (n,) packings of several
    leaves, ``gstack`` the (g, n) gradient slab. Both paths are
    shape-agnostic elementwise combinations, so the slab result is
    bit-identical to the per-leaf updates it replaces."""
    return _leaf_update(w_slab, v_slab, gstack, coeffs, impl=impl)


def fused_group_update(params, grads, mom_buf, *, coeffs: GroupedCoeffs,
                       head_coeffs: GroupedCoeffs = None, head_mask=None,
                       impl: str = "torch"):
    """Whole-tree fused update in ONE traversal.

    grads: same tree as params with a leading (g, ...) group axis per leaf.
    head_mask: optional tree of bools — True leaves (merged-FC head) use
    ``head_coeffs`` (single averaged zero-staleness update), the rest
    ``coeffs`` (g sequential sub-steps, collapsed). Returns
    (new_params, new_mom).
    """
    if head_mask is None:
        head_mask = T.tree_map(lambda _: False, params)

    def leaf(w, g, v, is_head):
        if is_head and head_coeffs is None:
            raise ValueError("head_mask marks head leaves but head_coeffs "
                             "was not provided")
        c = head_coeffs if is_head else coeffs
        return _leaf_update(w, v, g, c, impl=impl)

    # tree_map validates grads/mom/mask against the params structure
    return T.unzip2(T.tree_map(leaf, params, grads, mom_buf, head_mask),
                    params)
