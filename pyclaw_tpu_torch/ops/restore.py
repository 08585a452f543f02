"""Wrapper of the guarded restore of the solver's device loop.

:func:`restore`: after an attempted step, ``dst`` (the step's output
buffer) keeps the step's result where the device flag ``ok`` is true and
takes ``src`` (the step's input) where it is false: one launch of
``csrc/restore.cu``, which copies only when the step was rejected and
otherwise returns after one load of the flag.  It stands for the JAX
package's ``jnp.where(ok, q_new, q_)`` in ``_make_evolve_fn``'s loop body
(``pyclaw_tpu/solver.py:320``); no TPU kernel is behind it.  Plain
version: ``torch.where(ok, dst, src, out=dst)``.

On a CPU tensor the wrapper computes the plain version.  On a CUDA tensor
it launches the kernel or raises; it never falls back to the plain
version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

# dst, src, ok, nbytes (the host emulation takes these, the card's entry a
# stream after them)
RESTORE_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong]


def bind_lib(lib):
    """Set the argument types of a ctypes handle of a build of
    ``csrc/restore.cu``; returns it."""
    lib.restore.argtypes = RESTORE_ARGTYPES + [ctypes.c_void_p]
    lib.restore.restype = ctypes.c_int
    return lib


@functools.cache
def _lib():
    return bind_lib(_build.load("restore"))


def plain(dst, src, ok):
    """The plain version: ``dst`` where ``ok``, else ``src``, into dst."""
    return torch.where(ok, dst, src, out=dst)


def restore(dst, src, ok, lib=None):
    """dst = ok ? dst : src, in place; returns dst.  dst, src: contiguous
    tensors of one shape and dtype on one device; ok: a bool 0-d tensor
    there.  ``lib``: a handle bound by :func:`bind_lib`, or None for this
    checkout's build."""
    if (dst.shape != src.shape or dst.dtype != src.dtype
            or dst.device != src.device or ok.device != dst.device
            or ok.dtype != torch.bool or ok.dim() != 0):
        raise ValueError("restore: need dst and src of one shape, dtype and "
                         "device, and a bool 0-d ok on it")
    if dst.device.type == "cpu":
        return plain(dst, src, ok)
    if dst.device.type != "cuda":
        raise ValueError(f"restore: unsupported device {dst.device}")
    if not (dst.is_contiguous() and src.is_contiguous()):
        raise ValueError("restore: dst and src must be contiguous")
    lib = _lib() if lib is None else lib
    rc = lib.restore(dst.data_ptr(), src.data_ptr(), ok.data_ptr(),
                     dst.numel() * dst.element_size(),
                     torch.cuda.current_stream(dst.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"restore launch failed: cudaError_t {rc}")
    _build.counted(restore)
    return dst


restore.launches = 0
restore.device_launches = None
