"""Wrapper of the 1D classic sweep kernel (the counterpart of
``pyclaw_tpu/ops/sweep.py``).

:func:`step1`, counterpart of ``step1_pallas``: one launch of
``csrc/step1.cu`` computes one classic 1D step (Riemann solve, limiter,
wave- or f-wave-form correction flux, per-cell dt/(dx kappa), update) of a
system of :data:`SYSTEMS_1D` (every 1D record of the JAX package; those
that read aux rows, :data:`AUX_ROWS_1D`, stage them beside q) and one CFL
maximum per block.  Plain version: ``classic/kernels.py:step1``.

On a CPU tensor the wrapper computes the plain version.  On a CUDA tensor
it launches the kernel or raises; it never falls back to the plain
version.  It takes dt as a Python float or a 0-d tensor; the kernel reads
it from device memory (``_build.dt_arg``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ..classic import kernels
from ..riemann.acoustics import _zc
from ..riemann.traffic import umax_of
from .tiled2d import _VALID_LIMITERS

# rp.name -> system id of csrc/step1.cu (SYS_*)
SYSTEMS_1D = {"advection_1D": 0, "acoustics_1D": 1, "euler_with_efix_1D": 2,
              "euler_roe_1D": 3, "euler_hlle_1D": 4, "sw_aug_1D": 5,
              "shallow_roe_with_efix_1D": 6, "shallow_hlle_1D": 7,
              "shallow_bathymetry_fwave_1D": 8, "psystem_1D": 9,
              "vc_advection_1D": 10, "vc_advection_fwave_1D": 11,
              "acoustics_variable_1D": 12, "burgers_1D": 13,
              "traffic_1D": 14, "mhd_1D": 15}
# aux rows a system's solver reads (its NAUX in csrc/systems1d.cuh), where
# it reads any
AUX_ROWS_1D = {"sw_aug_1D": 1, "shallow_bathymetry_fwave_1D": 1,
               "psystem_1D": 2, "vc_advection_1D": 1,
               "vc_advection_fwave_1D": 1, "acoustics_variable_1D": 2}
# qbc, aux, qout, cflb; n, g, system, capa, fwave; dt (a pointer), dx, p0,
# p1; order and three limiter ids (the host emulation takes these, the
# card's entries a stream after them)
STEP1_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p] + [ctypes.c_double] * 3
                  + [ctypes.c_int] * 4)


def bind_lib(lib):
    """Set the argument types of a ctypes handle of a build of
    ``csrc/step1.cu``; returns it."""
    _build.bind_dt(lib, ("step1_f32", "step1_f64"), STEP1_ARGTYPES, 9)
    lib.step1_blocks.argtypes = [ctypes.c_int] * 2
    lib.step1_blocks.restype = ctypes.c_int
    return lib


def system_of(rp):
    """The system id of record ``rp`` in csrc/step1.cu; raises for a
    record the kernel has no system for (its plain version runs on a CPU
    tensor only)."""
    if rp.name not in SYSTEMS_1D:
        raise NotImplementedError(
            f"step1: no system of csrc/step1.cu for the record {rp.name} "
            f"(its systems: {', '.join(SYSTEMS_1D)}); the plain version "
            f"runs it on a CPU tensor")
    return SYSTEMS_1D[rp.name]


def build_takes(lib, rp):
    """Whether a build of ``csrc/step1.cu`` (``lib``, a ctypes handle) has
    the system of ``rp``: an earlier build has fewer systems, and one
    without ``step1_num_systems`` has the first five."""
    count = getattr(lib, "step1_num_systems", None)
    return system_of(rp) < (count() if count is not None else 5)


@functools.cache
def _lib():
    return bind_lib(_build.load("step1"))


def check_options(mthlim, order, num_waves, num_ghost):
    """Raise on options the kernel does not take."""
    if len(mthlim) != num_waves or any(int(m) not in _VALID_LIMITERS
                                       for m in mthlim):
        raise ValueError(f"step1: need {num_waves} limiter ids in 0..21, "
                         f"got {mthlim}")
    if order not in (1, 2):
        raise ValueError(f"step1: order must be 1 or 2, got {order}")
    if num_ghost < 2:
        raise ValueError(f"step1: num_ghost must be >= 2, got {num_ghost}")


def system_params(rp, params):
    """The two physics scalars the kernel takes for system ``rp``: (u, 0)
    for advection, (zz, cc) for acoustics, (gamma, 0) for Euler, (grav,
    dry_tolerance) for the augmented shallow-water solver (dry_tolerance
    1e-8 when problem_data has none, as in the JAX package), (grav, 0) for
    the other shallow-water solvers (the bathymetry is an aux row), (1 for
    the linear stress law else 0, 0) for the p-system, (1 if the entropy
    fix is on else 0, 0) for Burgers, (umax, 0) for traffic, (gamma, bx)
    for MHD, and (0, 0) for the variable-coefficient systems, whose
    coefficients are aux rows."""
    name = rp.name
    if name == "advection_1D":
        return float(params["u"]), 0.0
    if name == "acoustics_1D":
        zz, cc = _zc(params)
        return float(zz), float(cc)
    if name == "sw_aug_1D":
        return (float(params["grav"]),
                float(params.get("dry_tolerance", 1e-8)))
    if name.startswith("shallow_"):
        return float(params["grav"]), 0.0
    if name == "psystem_1D":
        linear = params.get("stress_relation", "exp") == "linear"
        return float(linear), 0.0
    if name == "burgers_1D":
        return float(bool(params.get("efix", True))), 0.0
    if name == "traffic_1D":
        return float(umax_of(params)), 0.0
    if name == "mhd_1D":
        return float(params["gamma"]), float(params["bx"])
    if name in ("vc_advection_1D", "vc_advection_fwave_1D",
                "acoustics_variable_1D"):
        return 0.0, 0.0
    return float(params["gamma"]), 0.0


def step1(qbc, auxbc, dt, dx, rp, params, mthlim, order, fwave, index_capa,
          num_ghost=2, lib=None, out=None):
    """One classic 1D step (step1.f90).

    qbc: (num_eqn, mx + 2 num_ghost) ghost-padded q; auxbc: (num_aux,
    mx + 2 num_ghost) or None (float32 or float64, contiguous, q's dtype).
    ``rp`` is the RiemannSolver record; ``dt`` the step in q's dtype (a
    Python float or a 0-d tensor, exact in it); ``index_capa`` >= 0 names
    the aux row of the capacity function; ``out`` is the buffer of q or
    None.  Returns (q (num_eqn, mx), cfl as a 0-d
    tensor).  On a CPU tensor this is ``classic/kernels.py:step1``; on a
    CUDA tensor one launch of ``csrc/step1.cu`` (``lib``: a handle bound by
    :func:`bind_lib`, another build of it, or None for this checkout's)."""
    check_options(mthlim, order, rp.num_waves, num_ghost)
    if qbc.device.type == "cpu":
        return _build.plain_out(kernels.step1(
            qbc, auxbc, dt, dx, rp.rp, params, mthlim, order, fwave,
            index_capa, num_ghost), out)
    system = system_of(rp)
    if qbc.device.type != "cuda":
        raise ValueError(f"step1: unsupported device {qbc.device}")
    if qbc.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"step1: dtype {qbc.dtype} not supported")
    g = num_ghost
    if (qbc.dim() != 2 or qbc.shape[0] != rp.num_eqn
            or qbc.shape[1] < 2 * g + 1):
        raise ValueError(f"step1: need qbc of shape ({rp.num_eqn}, "
                         f"mx+{2 * g}) with mx >= 1, got {tuple(qbc.shape)}")
    if not qbc.is_contiguous():
        raise ValueError("step1: qbc must be contiguous")
    n = qbc.shape[1]
    aux_ptr = None
    naux = AUX_ROWS_1D.get(rp.name, 0)
    if index_capa >= 0 or naux:
        rows = max(naux, index_capa + 1)
        if (auxbc is None or auxbc.dim() != 2 or auxbc.shape[1] != n
                or auxbc.shape[0] < rows):
            raise ValueError(
                f"step1: {rp.name} with index_capa={index_capa} needs auxbc "
                f"of shape (num_aux >= {rows}, {n}), got "
                f"{None if auxbc is None else tuple(auxbc.shape)}")
        if auxbc.device != qbc.device or auxbc.dtype != qbc.dtype:
            raise TypeError("step1: auxbc must share qbc's device and dtype")
        if not auxbc.is_contiguous():
            raise ValueError("step1: auxbc must be contiguous")
        aux_ptr = auxbc.data_ptr()
    lib = _lib() if lib is None else lib
    q_out = _build.out_tensor("step1", out, (rp.num_eqn, n - 2 * g), qbc)
    cfl_blocks = torch.empty((lib.step1_blocks(n, g),), dtype=qbc.dtype,
                             device=qbc.device)
    fn = lib.step1_f64 if qbc.dtype == torch.float64 else lib.step1_f32
    lims = [int(m) for m in mthlim] + [0] * (3 - len(mthlim))
    dt_ptr, _dt = _build.dt_arg(dt, qbc)
    rc = fn(qbc.data_ptr(), aux_ptr, q_out.data_ptr(), cfl_blocks.data_ptr(),
            n, g, system, int(index_capa), int(bool(fwave)),
            dt_ptr, float(dx), *system_params(rp, params), int(order),
            *lims, torch.cuda.current_stream(qbc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"step1 launch failed: cudaError_t {rc}")
    _build.counted(step1)
    return q_out, torch.amax(cfl_blocks)


step1.launches = 0
step1.device_launches = None
