"""Public wrapper: the Mamba-2 decode step's state update and read-out.

Takes one layer's per-slot state ``h`` (S, H, P, N) fp32, updated in
place, the step's ``x`` (S, H, P) after the conv and SiLU, ``B`` and ``C``
(S, N), ``dt`` (S, H) fp32 after softplus (and the mask), ``A`` and ``D``
(H,) fp32, and ``active`` (S,) bool or None, and returns y (S, H, P) in
x's type.

A CUDA tensor launches ``csrc/ssm_decode.cu`` (or raises): one block per
(slot, head) reads and writes a live slot's state once; an inactive
slot's state is not touched and its y is 0. A CPU tensor takes the plain
version, ``ref.ssm_decode_ref``, which advances every row (an inactive
row has dt 0: decay 1, nothing added) and reads every row out. Every
launch adds one to ``ssm_decode.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_decode.ref import ssm_decode_ref

KERNEL = "ssm_decode"
MAX_STATE = 256                # N the kernel takes: a multiple of 4 up to this
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: ``ssm_decode_launch``'s C signature, in order
ARGTYPES = [_P] * 9 + [_I] * 4 + [_L] * 3 + [_I, _I, _P]


def _check(h, x, B, C, dt, A, D, active) -> None:
    """What the kernel refuses: raise on it."""
    S, H, P, N = h.shape
    if x.shape != (S, H, P) or B.shape != (S, N) or C.shape != (S, N):
        raise ValueError(f"x {tuple(x.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)} do not fit the state "
                         f"{tuple(h.shape)}")
    if dt.shape != (S, H) or A.shape != (H,) or D.shape != (H,):
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, D "
                         f"{tuple(D.shape)} do not fit the state "
                         f"{tuple(h.shape)}")
    if active is not None and active.shape != (S,):
        raise ValueError(f"active {tuple(active.shape)} != ({S},)")
    for name, t in (("x", x), ("B", B), ("C", C), ("dt", dt), ("A", A),
                    ("D", D), ("active", active)):
        if t is not None and t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {tuple(DTYPES)}")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"B/C dtypes {B.dtype}/{C.dtype} != x dtype "
                        f"{x.dtype}")
    for name, t in (("h", h), ("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
    if active is not None and active.dtype != torch.bool:
        raise TypeError(f"active must be bool, not {active.dtype}")
    if N % 4 or N > MAX_STATE:
        raise ValueError(f"state size {N} is not a multiple of 4 up to "
                         f"{MAX_STATE}")
    if S > 65535:
        raise ValueError(f"{S} slots > 65535 (the grid's second axis)")
    for name, t in (("h", h), ("dt", dt), ("A", A), ("D", D),
                    ("active", active)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.stride(2) != 1 or x.stride(1) != P:
        raise ValueError(f"x's heads and head channels must be packed "
                         f"(strides {x.stride()})")
    if B.stride(1) != 1 or C.stride(1) != 1:
        raise ValueError("B's and C's state channels must be packed")
    if h.data_ptr() % 16:
        raise ValueError("h must be 16-byte aligned (16-byte loads)")


def ssm_decode(h, x, B, C, dt, A, D, active=None):
    """One decode step of every slot's state (see the module docstring).
    Returns y (S, H, P) in x's type; ``h`` is updated in place."""
    if h.device.type != "cuda":
        return ssm_decode_ref(h, x, B, C, dt, A, D)
    _check(h, x, B, C, dt, A, D, active)
    S, H, P, N = h.shape
    y = torch.empty((S, H, P), dtype=x.dtype, device=h.device)
    err = _build.launcher(KERNEL, ARGTYPES)(
        h.data_ptr(), x.data_ptr(), B.data_ptr(), C.data_ptr(),
        dt.data_ptr(), A.data_ptr(), D.data_ptr(),
        None if active is None else active.data_ptr(), y.data_ptr(), S, H,
        P, N, x.stride(0), B.stride(0), C.stride(0), DTYPES[x.dtype],
        h.device.index or 0, torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, KERNEL)
    ssm_decode.launches += 1
    return y


ssm_decode.launches = 0
