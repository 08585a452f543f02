"""The 2D CTU step kernel's wrapper.

Counterpart of ``pyclaw_tpu/ops/tiled2d.py:step2_pallas_rows`` with its
SoA body: one launch of ``csrc/step2_ctu.cu`` computes the whole unsplit
CTU step of the Euler 4-wave Roe solver and one CFL maximum per block.

On a CPU tensor :func:`step2_rows` computes the plain PyTorch version
(``classic/soa.py:step2_soa``).  On a CUDA tensor it launches the kernel
or raises; it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..classic import soa
from ..limiters.tvd import CFL_LIMITER_IDS
from ..riemann import euler

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
             + [ctypes.c_double] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_void_p])
_VALID_LIMITERS = set(range(10)) | {16, 19, 20, 21} | set(CFL_LIMITER_IDS)


@functools.cache
def _lib():
    from . import _build
    lib = _build.load("step2_ctu")
    for name in ("step2_ctu_f32", "step2_ctu_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    lib.step2_ctu_blocks.argtypes = [ctypes.c_int] * 3
    lib.step2_ctu_blocks.restype = ctypes.c_int
    return lib


def check_options(mthlim, order, transverse_waves):
    """Raise on options the kernel does not take."""
    if len(mthlim) != 4 or any(int(m) not in _VALID_LIMITERS
                               for m in mthlim):
        raise ValueError(f"step2_rows: need 4 limiter ids in 0..21, got "
                         f"{mthlim}")
    if order not in (1, 2):
        raise ValueError(f"step2_rows: order must be 1 or 2, got {order}")
    if transverse_waves not in (0, 1, 2):
        raise ValueError(f"step2_rows: transverse_waves must be 0, 1 or "
                         f"2, got {transverse_waves}")


def step2_rows(qbc, dt, dx, dy, params, mthlim, order, num_ghost=2,
               transverse_waves=2):
    """One 2D CTU step of the Euler 4-wave system.

    qbc: (4, nx+4, ny+4) ghost-padded q (float32 or float64, contiguous).
    dt: step in q's dtype (a Python float that is exact in it).
    Returns (q (4, nx, ny), cfl as a 0-d tensor)."""
    check_options(mthlim, order, transverse_waves)
    if num_ghost != 2:
        raise ValueError(f"step2_rows: num_ghost must be 2, got {num_ghost}")
    if qbc.device.type == "cpu":
        return soa.step2_soa(qbc, dt, dx, dy, euler._rpn2_euler_soa,
                             euler._rpt2_euler_soa, params, mthlim, order,
                             num_ghost, transverse_waves,
                             euler._prefactor_euler_2d_soa)
    if qbc.device.type != "cuda":
        raise ValueError(f"step2_rows: unsupported device {qbc.device}")
    if qbc.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"step2_rows: dtype {qbc.dtype} not supported")
    if qbc.dim() != 3 or qbc.shape[0] != 4 or min(qbc.shape[1:]) < 5:
        raise ValueError(f"step2_rows: need qbc of shape (4, nx+4, ny+4) "
                         f"with nx, ny >= 1, got {tuple(qbc.shape)}")
    if not qbc.is_contiguous():
        raise ValueError("step2_rows: qbc must be contiguous")
    _, nxg, nyg = qbc.shape
    is_double = qbc.dtype == torch.float64
    lib = _lib()
    nblocks = lib.step2_ctu_blocks(nxg, nyg, int(is_double))
    q_out = torch.empty((4, nxg - 4, nyg - 4), dtype=qbc.dtype,
                        device=qbc.device)
    cfl_blocks = torch.empty((nblocks,), dtype=qbc.dtype, device=qbc.device)
    fn = lib.step2_ctu_f64 if is_double else lib.step2_ctu_f32
    g1 = params["gamma"] - 1.0
    lims = [int(m) for m in mthlim]
    rc = fn(qbc.data_ptr(), q_out.data_ptr(), cfl_blocks.data_ptr(),
            nxg, nyg, float(dt), float(dx), float(dy), float(g1),
            int(order), int(transverse_waves), *lims,
            torch.cuda.current_stream(qbc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"step2_ctu launch failed: cudaError_t {rc}")
    step2_rows.launches += 1
    return q_out, torch.amax(cfl_blocks)


step2_rows.launches = 0
