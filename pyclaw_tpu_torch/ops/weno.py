"""Wrapper of the WENO5 reconstruction kernel (the counterpart of
``pyclaw_tpu/ops/weno.py``).

:func:`weno5`, counterpart of ``weno5_pallas``: one launch of
``csrc/weno5.cu`` computes the Jiang-Shu WENO5 left and right edge values
along the last axis of q, viewed as a contiguous (rows, n) array.  Plain
version: ``limiters/recon.py:weno5`` (float32 takes its normalised-beta
weights, not ``weno5_pallas``'s float64 formula).

On a CPU tensor the wrapper computes the plain version.  On a CUDA tensor
it launches the kernel or raises; it never falls back to the plain
version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ..limiters import recon

# q, ql, qr; rows, n (the host emulation takes these, the card's entries a
# stream after them)
WENO5_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2


def bind_lib(lib):
    """Set the argument types of a ctypes handle of a build of
    ``csrc/weno5.cu``; returns it."""
    for name in ("weno5_f32", "weno5_f64"):
        fn = getattr(lib, name)
        fn.argtypes = WENO5_ARGTYPES + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _lib():
    return bind_lib(_build.load("weno5"))


def weno5(q, lib=None):
    """WENO5 edge values (ql, qr) of q (..., n) along its last axis, each
    shaped like q; the wrapped band at the two ends of a row is invalid,
    as in the plain version (callers keep num_ghost >= 3).  ``lib``: a
    handle bound by :func:`bind_lib` (another build of the kernel), or
    None for this checkout's."""
    if q.device.type == "cpu":
        return recon.weno5(q)
    if q.device.type != "cuda":
        raise ValueError(f"weno5: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"weno5: dtype {q.dtype} not supported")
    if q.dim() < 1 or q.numel() == 0:
        raise ValueError(f"weno5: need a non-empty q, got {tuple(q.shape)}")
    if not q.is_contiguous():
        raise ValueError("weno5: q must be contiguous")
    n = q.shape[-1]
    rows = q.numel() // n
    if max(rows, n) >= 2 ** 31:
        raise ValueError(f"weno5: q of shape {tuple(q.shape)} has more "
                         f"rows or a longer row than the kernel takes")
    lib = _lib() if lib is None else lib
    ql = torch.empty_like(q)
    qr = torch.empty_like(q)
    fn = lib.weno5_f64 if q.dtype == torch.float64 else lib.weno5_f32
    rc = fn(q.data_ptr(), ql.data_ptr(), qr.data_ptr(), rows, n,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"weno5 launch failed: cudaError_t {rc}")
    _build.counted(weno5)
    return ql, qr


weno5.launches = 0
weno5.device_launches = None
