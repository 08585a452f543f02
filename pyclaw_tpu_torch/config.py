"""Global configuration for pyclaw_tpu_torch.

Counterpart of ``pyclaw_tpu/config.py``.  The reference framework computes
in Fortran double precision, so the default State dtype is float64, as the
JAX package's x64 default.  float32 is opt-in:
``State(..., dtype=np.float32)``.

Device: every entry point runs on ``default_device()`` (the CUDA card)
unless the caller passes ``device="cpu"``.  No environment variable
switches it, and nothing falls back to the CPU when the card is missing:
:func:`resolve_device` raises instead.
"""

import numpy as np
import torch


def default_dtype():
    """Default floating dtype for new State arrays (numpy dtype)."""
    return np.dtype(np.float64)


def default_device():
    """Device the port's entry points run on when none is given."""
    return "cuda"


def resolve_device(device=None):
    """``torch.device`` for ``device`` (default: :func:`default_device`).
    A CUDA device gets its index ("cuda" is the current card), so that it
    equals the ``.device`` of the tensors made on it.  Raises if a CUDA
    device is asked for and no card is present."""
    dev = torch.device(default_device() if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch path")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(np_dtype):
    """torch dtype of a numpy float dtype."""
    return {np.dtype(np.float64): torch.float64,
            np.dtype(np.float32): torch.float32}[np.dtype(np_dtype)]
