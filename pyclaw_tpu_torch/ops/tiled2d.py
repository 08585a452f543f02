"""Wrappers of the port's CUDA kernels (the counterpart of
``pyclaw_tpu/ops/tiled2d.py``, whose 2D and 3D kernels live there too).

* :func:`step2_rows`, counterpart of ``step2_pallas_rows`` with its SoA
  body: one launch of ``csrc/step2_ctu.cu`` computes the whole unsplit
  CTU step and one CFL maximum per block.  Plain version:
  ``classic/soa.py:step2_soa``.
* :func:`dq_rows`, counterpart of ``dq_pallas_rows``: one launch
  computes one SharpClaw semidiscrete evaluation (one RK stage's dq) and
  one CFL maximum per block, for a system of :data:`DQ_SYSTEMS` (Euler
  4-wave, Euler 5-wave with its tracer and ``acoustics_2D``) and an order
  of :data:`DQ_ORDERS`, each a template instance of its own: at WENO
  order 5 ``csrc/dq2_weno5.cu``, at orders 7-17 ``csrc/dq2_weno.cu``
  (whose launches count on :data:`dq_weno_launches`).  Plain
  version: ``sharpclaw/soa.py:dq_2d_soa`` at that order with the
  system's SoA hooks.
* :func:`step3_xy`, counterpart of ``step3_pallas_xy`` for Euler: one
  launch of ``csrc/step3_ctu.cu`` computes the whole 3D unsplit CTU step
  (normal sweeps, rpt3 and rptt3 corner transport) of the Euler system,
  with or without a capacity function, in the wave or the f-wave form,
  and one CFL maximum per block.  Plain version:
  ``classic/kernels.py:step3``.
* :func:`step2_rows_generic`, counterpart of ``step2_pallas_rows`` with
  its generic-AoS body (``rpn_soa=None``), of ``step2_pallas_tiled_generic``
  and of ``ops/sweep2d.py:step2_pallas``: one launch of
  ``csrc/step2_aos.cu`` computes the whole unsplit CTU step of a system
  of :data:`AOS_SYSTEMS` (the three shallow-water systems, ``acoustics_2D``,
  the Euler 4- and 5-wave systems, the scalar and
  variable-coefficient systems ``advection_2D``, ``vc_advection_2D``,
  ``vc_advection_fwave_2D``, ``vc_acoustics_2D``, ``kpp_2D`` and
  ``burgers_2D``, and the two systems without a transverse solver,
  ``psystem_2D`` and ``shallow_sphere_fwave_2D``, each a template
  instance of its own, given its two
  physics scalars by :func:`aos_system_params`), with aux arrays, a
  capacity function and the f-wave form, for any (nx, ny).  Plain
  version: ``classic/kernels.py:step2``.
* :func:`step3_xy_generic`, counterpart of ``step3_pallas_xy`` with its
  aux body ``kernel_aux``: one launch of ``csrc/step3_aos.cu`` computes
  the whole 3D unsplit CTU step of a system of :data:`STEP3_SYSTEMS`,
  with aux arrays, a capacity function and the f-wave form, for any
  (nx, ny, nz).  Plain version: ``classic/kernels.py:step3``.

On a CPU tensor each wrapper computes its plain PyTorch version.  On a
CUDA tensor it launches the kernel or raises; it never falls back to the
plain version.  Each takes dt as a Python float or a 0-d tensor, exact in
q's dtype; the kernel reads it from device memory (``_build.dt_arg``), so
the solver's device loop can capture the launch in a CUDA graph.  The
steps take ``out``, the output buffer of q (the device loop alternates
two).
"""

from __future__ import annotations

import ctypes
import functools
import types

import torch

from . import _build
from ..classic import kernels, soa
from ..limiters.tvd import CFL_LIMITER_IDS
from ..riemann import acoustics, euler
from ..sharpclaw import soa as sc_soa

# qbc, qout, cflb; nxg, nyg; dt (a pointer); dx, dy, gamma-1; order, tw
# and four limiter ids (the host emulation takes these, the card's entries
# a stream after them)
STEP2_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                  + [ctypes.c_void_p] + [ctypes.c_double] * 3
                  + [ctypes.c_int] * 6)
# qbc, dq, cflb; nxg, nyg; dt (a pointer); dx, dy, gamma-1 (the Euler
# entries; the acoustics entries take zz, cc in place of gamma-1)
DQ_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
               + [ctypes.c_void_p] + [ctypes.c_double] * 3)
DQ_ACOUSTICS_ARGTYPES = DQ_ARGTYPES + [ctypes.c_double]
# rp.name -> (the suffix of its entries, their argument types, its system
# id in csrc/dq2_weno.cu).  The entries are dq2_weno<order><suffix>_f32|f64
# (dq_weno_entry), at WENO order 5 in csrc/dq2_weno5.cu, at the other
# orders of DQ_ORDERS in csrc/dq2_weno.cu
DQ_SYSTEMS = {"euler_4wave_2D": ("", DQ_ARGTYPES, 0),
              "acoustics_2D": ("_acoustics", DQ_ACOUSTICS_ARGTYPES, 1),
              "euler_5wave_2D": ("_euler5", DQ_ARGTYPES, 2)}
DQ_ORDERS = (5, 7, 9, 11, 13, 15, 17)
_VALID_LIMITERS = set(range(10)) | {16, 19, 20, 21} | set(CFL_LIMITER_IDS)


def bind_step2_lib(lib):
    """Set the argument types of a ctypes handle of a build of
    ``csrc/step2_ctu.cu``; returns it."""
    _build.bind_dt(lib, ("step2_ctu_f32", "step2_ctu_f64"), STEP2_ARGTYPES, 5)
    lib.step2_ctu_blocks.argtypes = [ctypes.c_int] * 3
    lib.step2_ctu_blocks.restype = ctypes.c_int
    return lib


@functools.cache
def _lib():
    return bind_step2_lib(_build.load("step2_ctu"))


def bind_dq_lib(lib):
    """Set the argument types of a ctypes handle of a build of
    ``csrc/dq2_weno5.cu`` (the entries of each system of
    :data:`DQ_SYSTEMS` it has: an earlier build has Euler's only);
    returns it."""
    for name, (_, argtypes, _) in DQ_SYSTEMS.items():
        prefix = dq_weno_entry(name, 5)
        if getattr(lib, prefix + "_f32", None) is not None:
            _build.bind_dt(lib, (prefix + "_f32", prefix + "_f64"),
                           argtypes, 5)
    lib.dq2_weno5_blocks.argtypes = [ctypes.c_int] * 2
    lib.dq2_weno5_blocks.restype = ctypes.c_int
    return lib


def dq_build_takes(lib, rp):
    """Whether a build of ``csrc/dq2_weno5.cu`` (``lib``, a ctypes handle)
    has the entries of system ``rp`` (an earlier build lacks the later
    systems')."""
    return getattr(lib, dq_weno_entry(rp.name, 5) + "_f32",
                   None) is not None


def dq_system_params(rp, params):
    """The physics scalars of the entries of ``csrc/dq2_weno5.cu`` for
    system ``rp``: (gamma - 1,) for Euler (4- or 5-wave), (zz, cc) for
    acoustics."""
    if rp.name == "acoustics_2D":
        zz, cc = acoustics._zc(params)
        return float(zz), float(cc)
    return (float(params["gamma"] - 1.0),)


@functools.cache
def _dq_lib():
    return bind_dq_lib(_build.load("dq2_weno5"))


def dq_weno_entry(name, order):
    """The prefix of the entries for system ``name`` (a key of
    :data:`DQ_SYSTEMS`) at WENO order ``order``: of ``csrc/dq2_weno5.cu``
    at order 5, of ``csrc/dq2_weno.cu`` at the others."""
    return f"dq2_weno{order}{DQ_SYSTEMS[name][0]}"


def bind_dq_weno_lib(lib):
    """Set the argument types of a ctypes handle of a build of
    ``csrc/dq2_weno.cu`` (every system and order past 5); returns it."""
    for name, (_, argtypes, _) in DQ_SYSTEMS.items():
        for order in DQ_ORDERS[1:]:
            prefix = dq_weno_entry(name, order)
            _build.bind_dt(lib, (prefix + "_f32", prefix + "_f64"), argtypes,
                           5)
    lib.dq2_weno_blocks.argtypes = [ctypes.c_int] * 3
    lib.dq2_weno_blocks.restype = ctypes.c_int
    lib.dq2_weno_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.dq2_weno_smem_bytes.restype = ctypes.c_int
    return lib


@functools.cache
def _dq_weno_lib():
    return bind_dq_weno_lib(_build.load("dq2_weno"))


def _check_cuda_qbc(name, qbc, num_ghost, num_eqn, num_dim):
    """Raise unless qbc is a contiguous (num_eqn, n1+2g, ..., n{num_dim}+2g)
    float32/float64 CUDA tensor with every n >= 1."""
    if qbc.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {qbc.device}")
    if qbc.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {qbc.dtype} not supported")
    g = num_ghost
    if (qbc.dim() != 1 + num_dim or qbc.shape[0] != num_eqn
            or min(qbc.shape[1:]) < 2 * g + 1):
        axes = ", ".join(f"n{d}+{2 * g}" for d in range(num_dim))
        raise ValueError(f"{name}: need qbc of shape ({num_eqn}, {axes}) "
                         f"with every n >= 1, got {tuple(qbc.shape)}")
    if not qbc.is_contiguous():
        raise ValueError(f"{name}: qbc must be contiguous")


def check_options(mthlim, order, transverse_waves, num_waves=4,
                  name="step2_rows"):
    """Raise on options the kernel does not take."""
    if len(mthlim) != num_waves or any(int(m) not in _VALID_LIMITERS
                                       for m in mthlim):
        raise ValueError(f"{name}: need {num_waves} limiter ids in 0..21, "
                         f"got {mthlim}")
    if order not in (1, 2):
        raise ValueError(f"{name}: order must be 1 or 2, got {order}")
    if transverse_waves not in (0, 1, 2):
        raise ValueError(f"{name}: transverse_waves must be 0, 1 or 2, "
                         f"got {transverse_waves}")


def step2_rows(qbc, dt, dx, dy, params, mthlim, order, num_ghost=2,
               transverse_waves=2, lib=None, out=None):
    """One 2D CTU step of the Euler 4-wave system.

    qbc: (4, nx+4, ny+4) ghost-padded q (float32 or float64, contiguous).
    dt: step in q's dtype (a Python float or a 0-d tensor, exact in it).
    lib: another build of the kernel, bound by :func:`bind_step2_lib` (the
    variant timer ``ops/time_kernels.py``); None for this checkout's.
    out: the (4, nx, ny) buffer of the result, or None.
    Returns (q (4, nx, ny), cfl as a 0-d tensor)."""
    check_options(mthlim, order, transverse_waves)
    if num_ghost != 2:
        raise ValueError(f"step2_rows: num_ghost must be 2, got {num_ghost}")
    if qbc.device.type == "cpu":
        return _build.plain_out(soa.step2_soa(
            qbc, dt, dx, dy, euler._rpn2_euler_soa, euler._rpt2_euler_soa,
            params, mthlim, order, num_ghost, transverse_waves,
            euler._prefactor_euler_2d_soa), out)
    _check_cuda_qbc("step2_rows", qbc, num_ghost, 4, 2)
    _, nxg, nyg = qbc.shape
    is_double = qbc.dtype == torch.float64
    lib = _lib() if lib is None else lib
    nblocks = lib.step2_ctu_blocks(nxg, nyg, int(is_double))
    q_out = _build.out_tensor("step2_rows", out, (4, nxg - 4, nyg - 4), qbc)
    cfl_blocks = torch.empty((nblocks,), dtype=qbc.dtype, device=qbc.device)
    fn = lib.step2_ctu_f64 if is_double else lib.step2_ctu_f32
    g1 = params["gamma"] - 1.0
    lims = [int(m) for m in mthlim]
    dt_ptr, _dt = _build.dt_arg(dt, qbc)
    rc = fn(qbc.data_ptr(), q_out.data_ptr(), cfl_blocks.data_ptr(),
            nxg, nyg, dt_ptr, float(dx), float(dy), float(g1),
            int(order), int(transverse_waves), *lims,
            torch.cuda.current_stream(qbc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"step2_ctu launch failed: cudaError_t {rc}")
    _build.counted(step2_rows)
    return q_out, torch.amax(cfl_blocks)


step2_rows.launches = 0
step2_rows.device_launches = None


def dq_rows(qbc, dt, dx, dy, params, weno_order=5, num_ghost=3, lib=None,
            rp=euler.euler_4wave_2D):
    """One SharpClaw semidiscrete evaluation of a 2D system with SoA hooks
    ``rp`` (Euler 4-wave by default): componentwise WENO edge states of
    order ``weno_order`` with the system's positivity fallback (Euler's),
    Roe fluctuations, and f(qr) - f(ql) in each cell.

    qbc: (num_eqn, nx+2k, ny+2k) ghost-padded q, k = (weno_order + 1) //
    2 = num_ghost (float32 or float64, contiguous).  dt: step in q's dtype
    (a Python float or a 0-d tensor, exact in it).  lib: another build of
    the order's kernel, bound by :func:`bind_dq_lib` (order 5) or
    :func:`bind_dq_weno_lib` (the variant timer ``ops/time_kernels.py``);
    None for this checkout's.  Returns (dq (num_eqn, nx, ny) with dt
    included, cfl as a 0-d tensor).  On a CUDA tensor an order outside
    :data:`DQ_ORDERS` or a system outside :data:`DQ_SYSTEMS` raises."""
    if num_ghost != (weno_order + 1) // 2:
        raise ValueError(f"dq_rows: weno_order={weno_order} needs "
                         f"num_ghost={(weno_order + 1) // 2}, got "
                         f"{num_ghost}")
    if qbc.device.type == "cpu":
        return sc_soa.dq_2d_soa(qbc, dt, dx, dy, rp.rpn_soa, params,
                                weno_order, num_ghost,
                                positivity=rp.positivity,
                                flux_soa=rp.flux_soa)
    if weno_order not in DQ_ORDERS:
        raise ValueError(f"dq_rows: weno_order={weno_order} has no kernel "
                         f"(orders {DQ_ORDERS})")
    if rp.name not in DQ_SYSTEMS:
        raise NotImplementedError(
            f"dq_rows: {rp.name} has no kernel yet (ROADMAP.md, Queue 2 "
            f"item 12: 'SharpClaw 2D systems of dq2_weno5.cu')")
    _check_cuda_qbc("dq_rows", qbc, num_ghost, rp.num_eqn, 2)
    _, nxg, nyg = qbc.shape
    if weno_order == 5:
        lib = _dq_lib() if lib is None else lib
        nblocks = lib.dq2_weno5_blocks(nxg, nyg)
    else:
        lib = _dq_weno_lib() if lib is None else lib
        nblocks = lib.dq2_weno_blocks(nxg, nyg, weno_order)
    prefix = dq_weno_entry(rp.name, weno_order)
    g = num_ghost
    dq = torch.empty((rp.num_eqn, nxg - 2 * g, nyg - 2 * g),
                     dtype=qbc.dtype, device=qbc.device)
    cfl_blocks = torch.empty((nblocks,), dtype=qbc.dtype, device=qbc.device)
    fn = getattr(lib, prefix + ("_f64" if qbc.dtype == torch.float64
                                else "_f32"))
    dt_ptr, _dt = _build.dt_arg(dt, qbc)
    rc = fn(qbc.data_ptr(), dq.data_ptr(), cfl_blocks.data_ptr(), nxg, nyg,
            dt_ptr, float(dx), float(dy), *dq_system_params(rp, params),
            torch.cuda.current_stream(qbc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{prefix} launch failed: cudaError_t {rc}")
    # order 5's launches count here, those of csrc/dq2_weno.cu on
    # dq_weno_launches, so that a path shows which kernel it ran
    _build.counted(dq_rows if weno_order == 5 else dq_weno_launches)
    return dq, torch.amax(cfl_blocks)


dq_rows.launches = 0
dq_rows.device_launches = None


# the launch counts of csrc/dq2_weno.cu (dq_rows at WENO orders 7-17;
# ops.kernel_wrappers names them dq2_weno), kept as a wrapper keeps its own
dq_weno_launches = types.SimpleNamespace(launches=0, device_launches=None)


def bind_step3_lib(lib):
    """Set the argument types of a ctypes handle of a build of
    ``csrc/step3_ctu.cu``; returns it."""
    _build.bind_dt(lib, ("step3_ctu_f32", "step3_ctu_f64"), STEP3_ARGTYPES,
                   6)
    _build.bind_dt(lib, ("step3_ctu_aux_f32", "step3_ctu_aux_f64"),
                   STEP3_AUX_ARGTYPES, 9)
    lib.step3_ctu_blocks.argtypes = [ctypes.c_int] * 4
    lib.step3_ctu_blocks.restype = ctypes.c_int
    return lib


@functools.cache
def _step3_lib():
    return bind_step3_lib(_build.load("step3_ctu"))


# qbc, qout, cflb; nxg, nyg, nzg; dt (a pointer), dx, dy, dz, gamma-1;
# order, tw and five limiter ids (the host emulation takes these, the
# card's entries a stream after them)
STEP3_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                  + [ctypes.c_void_p] + [ctypes.c_double] * 4
                  + [ctypes.c_int] * 7)
# the aux entries: qbc, aux, qout, cflb; nxg, nyg, nzg, capa, fwave; then
# as STEP3_ARGTYPES
STEP3_AUX_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p] + [ctypes.c_double] * 4
                      + [ctypes.c_int] * 7)


def _check_cuda_aux(name, auxbc, qbc, naux, index_capa):
    """Raise unless auxbc holds the aux rows a kernel reads (``naux``
    rows, and row ``index_capa`` of the capacity function) over qbc's
    grid, on qbc's device, of its dtype, contiguous.  Returns its
    pointer, or None when the kernel reads no aux."""
    if not naux and index_capa < 0:
        return None
    grid = ", ".join(str(n) for n in qbc.shape[1:])
    if (auxbc is None or auxbc.dim() != qbc.dim()
            or auxbc.shape[1:] != qbc.shape[1:]
            or auxbc.shape[0] <= max(naux - 1, index_capa)):
        raise ValueError(
            f"{name}: index_capa={index_capa} needs auxbc of shape "
            f"(num_aux, {grid}), got "
            f"{None if auxbc is None else tuple(auxbc.shape)}")
    if auxbc.device != qbc.device or auxbc.dtype != qbc.dtype:
        raise TypeError(f"{name}: auxbc must share qbc's device and dtype")
    if not auxbc.is_contiguous():
        raise ValueError(f"{name}: auxbc must be contiguous")
    return auxbc.data_ptr()


def step3_xy(qbc, dt, dx, dy, dz, params, mthlim, order, num_ghost=2,
             transverse_waves=2, lib=None, auxbc=None, index_capa=-1,
             fwave=False, out=None):
    """One 3D CTU step of the Euler system (5 equations, 5 waves), the
    counterpart of ``pyclaw_tpu/ops/tiled2d.py:step3_pallas_xy``.

    qbc: (5, nx+4, ny+4, nz+4) ghost-padded q (float32 or float64,
    contiguous).  dt: step in q's dtype (a Python float or a 0-d tensor,
    exact in it).  ``index_capa`` >= 0 names the row of ``auxbc``
    (num_aux, nx+4, ny+4, nz+4), q's dtype, contiguous, that holds the
    capacity function (Euler reads no other aux); ``fwave`` takes the
    f-wave correction form; ``out`` is the buffer of q or None.  Returns
    (q (5, nx, ny, nz), cfl as a 0-d tensor).  On a CPU tensor this is
    ``classic/kernels.py:step3``; on a CUDA tensor one launch of
    ``csrc/step3_ctu.cu`` (``lib``: another build of it, bound by
    :func:`bind_step3_lib`, for the variant timer
    ``ops/time_kernels.py``; None for this checkout's)."""
    check_options(mthlim, order, transverse_waves, 5, "step3_xy")
    if num_ghost != 2:
        raise ValueError(f"step3_xy: num_ghost must be 2, got {num_ghost}")
    if qbc.device.type == "cpu":
        rp = euler.euler_3D
        return _build.plain_out(kernels.step3(
            qbc, auxbc, dt, dx, dy, dz, rp.rp, rp.rpt, rp.rptt, params,
            mthlim, order, fwave, index_capa, num_ghost, transverse_waves,
            rp.prefactor), out)
    _check_cuda_qbc("step3_xy", qbc, num_ghost, 5, 3)
    aux_ptr = _check_cuda_aux("step3_xy", auxbc, qbc, 0, index_capa)
    _, nxg, nyg, nzg = qbc.shape
    is_double = qbc.dtype == torch.float64
    lib = _step3_lib() if lib is None else lib
    q_out = _build.out_tensor("step3_xy", out,
                              (5, nxg - 4, nyg - 4, nzg - 4), qbc)
    cfl_blocks = torch.empty((lib.step3_ctu_blocks(nxg, nyg, nzg,
                                                   int(is_double)),),
                             dtype=qbc.dtype, device=qbc.device)
    dt_ptr, _dt = _build.dt_arg(dt, qbc)
    tail = (dt_ptr, float(dx), float(dy), float(dz),
            float(params["gamma"] - 1.0), int(order), int(transverse_waves),
            *[int(m) for m in mthlim],
            torch.cuda.current_stream(qbc.device).cuda_stream)
    if index_capa < 0 and not fwave:
        fn = lib.step3_ctu_f64 if is_double else lib.step3_ctu_f32
        rc = fn(qbc.data_ptr(), q_out.data_ptr(), cfl_blocks.data_ptr(),
                nxg, nyg, nzg, *tail)
    else:
        fn = lib.step3_ctu_aux_f64 if is_double else lib.step3_ctu_aux_f32
        rc = fn(qbc.data_ptr(), aux_ptr, q_out.data_ptr(),
                cfl_blocks.data_ptr(), nxg, nyg, nzg, int(index_capa),
                int(bool(fwave)), *tail)
    if rc != 0:
        raise RuntimeError(f"step3_ctu launch failed: cudaError_t {rc}")
    _build.counted(step3_xy)
    return q_out, torch.amax(cfl_blocks)


step3_xy.launches = 0
step3_xy.device_launches = None


# rp.name -> (system id of csrc/step2_aos.cu (SYS_*), aux rows its
# solvers need: rows 0 .. n - 1 (NAUX; shallow_sphere_fwave_2D reads its
# row 1 alone, AUX0 + NAUX))
AOS_SYSTEMS = {"shallow_roe_with_efix_2D": (0, 0),
               "shallow_bathymetry_fwave_2D": (1, 1),
               "acoustics_2D": (2, 0), "euler_4wave_2D": (3, 0),
               "euler_5wave_2D": (4, 0), "sw_aug_2D": (5, 1),
               "advection_2D": (6, 0), "vc_advection_2D": (7, 2),
               "vc_advection_fwave_2D": (8, 2), "vc_acoustics_2D": (9, 2),
               "kpp_2D": (10, 0), "burgers_2D": (11, 0),
               "psystem_2D": (12, 2), "shallow_sphere_fwave_2D": (13, 2)}
# limiter ids an entry of csrc/step2_aos.cu takes (one per wave of its
# widest system, Euler 5-wave; a build without step2_aos_limiter_ids, made
# before the Euler systems, takes three)
AOS_LIMITERS = 5


def aos_argtypes(nlim=AOS_LIMITERS):
    """The argument types of the entries of a build of ``csrc/step2_aos.cu``
    that takes ``nlim`` limiter ids: qbc, aux, qout, cflb; nxg, nyg,
    system, capa, fwave; dt (a pointer), dx, dy and the system's two
    physics scalars p0, p1 (:func:`aos_system_params`); order, tw and the
    limiter ids (the host emulation takes these, the card's entries a
    stream after them)."""
    return ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
            + [ctypes.c_void_p] + [ctypes.c_double] * 4
            + [ctypes.c_int] * (2 + nlim))


AOS_ARGTYPES = aos_argtypes()


def aos_limiter_count(lib):
    """The limiter ids the entries of a build of ``csrc/step2_aos.cu``
    (``lib``, a ctypes handle) take."""
    count = getattr(lib, "step2_aos_limiter_ids", None)
    return count() if count is not None else 3


def _bind_aos_blocks(lib):
    lib.step2_aos_blocks.argtypes = [ctypes.c_int] * 3
    lib.step2_aos_blocks.restype = ctypes.c_int
    if hasattr(lib, "step2_aos_system_blocks"):
        lib.step2_aos_system_blocks.argtypes = [ctypes.c_int] * 4
        lib.step2_aos_system_blocks.restype = ctypes.c_int
    return lib


def bind_step2_aos_lib(lib):
    """Set the argument types of a ctypes handle of a build of
    ``csrc/step2_aos.cu``; returns it."""
    _build.bind_dt(lib, ("step2_aos_f32", "step2_aos_f64"),
                   aos_argtypes(aos_limiter_count(lib)), 9)
    return _bind_aos_blocks(lib)


def bind_step2_aos_host(lib):
    """Set the argument types of a ctypes handle of the host emulation of
    ``csrc/step2_aos.cu`` (``_build.build_host_emulation``); returns
    it."""
    for name in ("step2_aos_host_f32", "step2_aos_host_f64"):
        fn = getattr(lib, name)
        fn.argtypes = AOS_ARGTYPES
        fn.restype = ctypes.c_int
    return _bind_aos_blocks(lib)


def aos_blocks(lib, system, nxg, nyg, is_double):
    """The CFL partials a build of ``csrc/step2_aos.cu`` (``lib``, bound by
    :func:`bind_step2_aos_lib`) writes for system id ``system`` on a padded
    nxg x nyg grid: ``step2_aos_system_blocks`` (the Euler systems have a
    tile of their own); an earlier build without it has one tile per type
    (``step2_aos_blocks``)."""
    if hasattr(lib, "step2_aos_system_blocks"):
        return lib.step2_aos_system_blocks(system, nxg, nyg, int(is_double))
    return lib.step2_aos_blocks(nxg, nyg, int(is_double))


@functools.cache
def _aos_lib():
    return bind_step2_aos_lib(_build.load("step2_aos"))


def aos_build_takes(lib, rp):
    """Whether a build of ``csrc/step2_aos.cu`` (``lib``, a ctypes handle)
    has the system of ``rp``: one without ``step2_aos_num_systems`` (an
    earlier build) has the two shallow-water systems."""
    count = getattr(lib, "step2_aos_num_systems", None)
    return AOS_SYSTEMS[rp.name][0] < (count() if count is not None else 2)


def aos_system_params(rp, params):
    """The two physics scalars ``csrc/step2_aos.cu`` takes for system
    ``rp``: (zz, cc) for acoustics, (gamma - 1, 0) for Euler (gamma - 1.0
    folded in double, as the plain version's Python scalar), (grav,
    dry_tolerance) for shallow water (dry_tolerance 1e-8 when problem_data
    has none, as in the JAX package), (u, v) for ``advection_2D``, (1, 0)
    or (0, 0) for Burgers with or without the entropy fix (on unless
    problem_data['efix'] is false, as in the JAX package), (1, 0) or (0, 0)
    for ``psystem_2D``'s "linear" or "exp" stress law, (grav, 0) for
    ``shallow_sphere_fwave_2D``, (0, 0) for the systems that read none."""
    if rp.name == "acoustics_2D":
        zz, cc = acoustics._zc(params)
        return float(zz), float(cc)
    if rp.name.startswith("euler_"):
        return float(params["gamma"] - 1.0), 0.0
    if rp.name == "advection_2D":
        return float(params["u"]), float(params["v"])
    if rp.name == "burgers_2D":
        return float(bool(params.get("efix", True))), 0.0
    if rp.name == "psystem_2D":
        return float(params.get("stress_relation", "exp") == "linear"), 0.0
    if rp.name == "shallow_sphere_fwave_2D":
        return float(params["grav"]), 0.0
    if rp.name in ("vc_advection_2D", "vc_advection_fwave_2D",
                   "vc_acoustics_2D", "kpp_2D"):
        return 0.0, 0.0
    return float(params["grav"]), float(params.get("dry_tolerance", 1e-8))


def aos_limiter_ids(mthlim, nlim=AOS_LIMITERS):
    """The ``nlim`` limiter ids an entry of ``csrc/step2_aos.cu`` takes:
    one per wave, padded with the last (the kernel reads the system's)."""
    lims = [int(m) for m in mthlim]
    return lims + [lims[-1]] * (nlim - len(lims))


def step2_rows_generic(qbc, auxbc, dt, dx, dy, rp, params, mthlim, order,
                       fwave, index_capa, num_ghost=2, transverse_waves=2,
                       lib=None, out=None):
    """One 2D CTU step of the generic AoS form (any system with AoS
    hooks on the CPU; the systems of :data:`AOS_SYSTEMS` on the card).

    qbc: (num_eqn, nx+4, ny+4) ghost-padded q; auxbc: (num_aux, nx+4,
    ny+4) or None (float32 or float64, contiguous, q's dtype).  dt: step
    in q's dtype (a Python float or a 0-d tensor, exact in it).
    ``index_capa`` >= 0 names the aux row of the capacity function;
    ``out`` is the buffer of q or None.  A record without ``rpt``
    (``psystem_2D``, ``shallow_sphere_fwave_2D``) runs no transverse pass
    whatever ``transverse_waves`` says: the plain step skips it without
    ``rpt``, the instance (``NO_TRANS``) runs with transverse_waves 0.
    Returns (q (num_eqn, nx, ny), cfl as a 0-d tensor).  On a CPU tensor
    this is
    ``classic/kernels.py:step2``; on a CUDA tensor one launch of
    ``csrc/step2_aos.cu`` (``lib``: another build of it, bound by
    :func:`bind_step2_aos_lib`, for the variant timer
    ``ops/time_kernels.py``; None for this checkout's)."""
    check_options(mthlim, order, transverse_waves, rp.num_waves,
                  "step2_rows_generic")
    if num_ghost != 2:
        raise ValueError(f"step2_rows_generic: num_ghost must be 2, got "
                         f"{num_ghost}")
    if qbc.device.type == "cpu":
        return _build.plain_out(kernels.step2(
            qbc, auxbc, dt, dx, dy, rp.rp, rp.rpt, params, mthlim, order,
            fwave, index_capa, num_ghost, transverse_waves, rp.prefactor),
            out)
    if rp.name not in AOS_SYSTEMS:
        raise NotImplementedError(
            f"step2_rows_generic: {rp.name} has no kernel yet (ROADMAP.md, "
            f"Queue 2 item 8: '2D systems of step2_aos.cu')")
    _check_cuda_qbc("step2_rows_generic", qbc, num_ghost, rp.num_eqn, 2)
    _, nxg, nyg = qbc.shape
    system, naux = AOS_SYSTEMS[rp.name]
    aux_ptr = _check_cuda_aux(f"step2_rows_generic: {rp.name}", auxbc, qbc,
                              naux, index_capa)
    is_double = qbc.dtype == torch.float64
    lib = _aos_lib() if lib is None else lib
    q_out = _build.out_tensor("step2_rows_generic", out,
                              (rp.num_eqn, nxg - 4, nyg - 4), qbc)
    cfl_blocks = torch.empty((aos_blocks(lib, system, nxg, nyg, is_double),),
                             dtype=qbc.dtype, device=qbc.device)
    fn = lib.step2_aos_f64 if is_double else lib.step2_aos_f32
    dt_ptr, _dt = _build.dt_arg(dt, qbc)
    rc = fn(qbc.data_ptr(), aux_ptr, q_out.data_ptr(), cfl_blocks.data_ptr(),
            nxg, nyg, system, int(index_capa), int(bool(fwave)),
            dt_ptr, float(dx), float(dy), *aos_system_params(rp, params),
            int(order), int(transverse_waves),
            *aos_limiter_ids(mthlim, aos_limiter_count(lib)),
            torch.cuda.current_stream(qbc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"step2_aos launch failed: cudaError_t {rc}")
    _build.counted(step2_rows_generic)
    return q_out, torch.amax(cfl_blocks)


step2_rows_generic.launches = 0
step2_rows_generic.device_launches = None


# rp.name -> (system id of csrc/step3_aos.cu (SYS_*), aux rows its solvers
# read (NAUX)).  euler_3D is not here: ClawSolver3D sends it to step3_xy
# (csrc/step3_ctu.cu), with or without a capacity function or f-waves.
STEP3_SYSTEMS = {"vc_acoustics_3D": (0, 2), "acoustics_3D": (1, 0),
                 "advection_3D": (2, 0), "burgers_3D": (3, 0)}
# limiter ids an entry of csrc/step3_aos.cu takes (five: the interface
# keeps the width it had when it also ran euler_3D's five waves)
STEP3_AOS_LIMITERS = 5
# qbc, aux, qout, cflb; nxg, nyg, nzg, system, capa, fwave; dt (a
# pointer), dx, dy, dz and three physics scalars; order, tw and five
# limiter ids (the host emulation takes these, the card's entries a stream
# after them)
STEP3_AOS_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                      + [ctypes.c_void_p] + [ctypes.c_double] * 6
                      + [ctypes.c_int] * (2 + STEP3_AOS_LIMITERS))


def bind_step3_aos_lib(lib):
    """Set the argument types of a ctypes handle of a build of
    ``csrc/step3_aos.cu``; returns it.  Raises if the build takes another
    number of limiter ids than :data:`STEP3_AOS_LIMITERS`."""
    n = lib.step3_aos_limiter_ids()
    if n != STEP3_AOS_LIMITERS:
        raise RuntimeError(f"step3_aos: the build takes {n} limiter ids, "
                           f"the wrapper passes {STEP3_AOS_LIMITERS}")
    _build.bind_dt(lib, ("step3_aos_f32", "step3_aos_f64"),
                   STEP3_AOS_ARGTYPES, 10)
    return bind_step3_aos_lib_counts(lib)


def bind_step3_aos_lib_counts(lib):
    """Set the argument types of the block-count entries of a build of
    ``csrc/step3_aos.cu`` (also of its host emulation); returns it."""
    lib.step3_aos_blocks.argtypes = [ctypes.c_int] * 4
    lib.step3_aos_blocks.restype = ctypes.c_int
    if hasattr(lib, "step3_aos_system_blocks"):
        lib.step3_aos_system_blocks.argtypes = [ctypes.c_int] * 5
        lib.step3_aos_system_blocks.restype = ctypes.c_int
    return lib


def step3_aos_blocks(lib, system, nxg, nyg, nzg, is_double):
    """The CFL partials a build of ``csrc/step3_aos.cu`` (``lib``, bound by
    :func:`bind_step3_aos_lib`) writes for system id ``system`` on a padded
    grid: ``step3_aos_system_blocks`` (Burgers has a tile of its own); an
    earlier build without it has one tile per type
    (``step3_aos_blocks``)."""
    if hasattr(lib, "step3_aos_system_blocks"):
        return lib.step3_aos_system_blocks(system, nxg, nyg, nzg,
                                           int(is_double))
    return lib.step3_aos_blocks(nxg, nyg, nzg, int(is_double))


@functools.cache
def _step3_aos_lib():
    return bind_step3_aos_lib(_build.load("step3_aos"))


def step3_build_takes(lib, rp):
    """Whether a build of ``csrc/step3_aos.cu`` (``lib``, a ctypes handle)
    has the system of ``rp``: one without ``step3_aos_num_systems`` (an
    earlier build) has the first three."""
    count = getattr(lib, "step3_aos_num_systems", None)
    return STEP3_SYSTEMS[rp.name][0] < (count() if count is not None else 3)


def step3_system_scalars(rp, params):
    """The three physics scalars ``csrc/step3_aos.cu`` takes for system
    ``rp``: (u, v, w) for advection, (zz, cc, 0) for acoustics, (1, 0, 0)
    or (0, 0, 0) for Burgers with or without the entropy fix (on unless
    problem_data['efix'] is false)."""
    if rp.name == "advection_3D":
        return tuple(float(params[k]) for k in ("u", "v", "w"))
    if rp.name == "acoustics_3D":
        zz, cc = acoustics._zc(params)
        return float(zz), float(cc), 0.0
    if rp.name == "burgers_3D":
        return float(bool(params.get("efix", True))), 0.0, 0.0
    return 0.0, 0.0, 0.0


def step3_limiter_ids(mthlim):
    """The limiter ids of ``mthlim`` as the entries of
    ``csrc/step3_aos.cu`` take them: one per wave, padded to
    :data:`STEP3_AOS_LIMITERS` (the kernel reads the system's waves')."""
    lims = [int(m) for m in mthlim]
    return lims + [lims[-1]] * (STEP3_AOS_LIMITERS - len(lims))


def step3_xy_generic(qbc, auxbc, dt, dx, dy, dz, rp, params, mthlim, order,
                     fwave, index_capa, num_ghost=2, transverse_waves=2,
                     lib=None, out=None):
    """One 3D CTU step of the generic AoS form (any system with AoS hooks
    on the CPU; the systems of :data:`STEP3_SYSTEMS` on the card).

    qbc: (num_eqn, nx+4, ny+4, nz+4) ghost-padded q; auxbc: (num_aux,
    nx+4, ny+4, nz+4) or None (float32 or float64, contiguous, q's dtype).
    dt: step in q's dtype (a Python float or a 0-d tensor, exact in it).
    ``index_capa`` >= 0 names the aux row of the capacity function;
    ``out`` is the buffer of q or None.  Returns (q (num_eqn, nx, ny, nz),
    cfl as a 0-d tensor).  On a CPU
    tensor this is ``classic/kernels.py:step3``; on a CUDA tensor one
    launch of ``csrc/step3_aos.cu`` (``lib``: another build of it, bound
    by :func:`bind_step3_aos_lib`, for the variant timer
    ``ops/time_kernels.py``; None for this checkout's)."""
    check_options(mthlim, order, transverse_waves, rp.num_waves,
                  "step3_xy_generic")
    if num_ghost != 2:
        raise ValueError(f"step3_xy_generic: num_ghost must be 2, got "
                         f"{num_ghost}")
    if qbc.device.type == "cpu":
        return _build.plain_out(kernels.step3(
            qbc, auxbc, dt, dx, dy, dz, rp.rp, rp.rpt, rp.rptt, params,
            mthlim, order, fwave, index_capa, num_ghost, transverse_waves,
            rp.prefactor), out)
    if rp.name == "euler_3D":
        raise NotImplementedError(
            "step3_xy_generic: euler_3D runs on step3_xy (csrc/step3_ctu.cu)")
    if rp.name not in STEP3_SYSTEMS:
        raise NotImplementedError(
            f"step3_xy_generic: {rp.name} has no kernel yet (ROADMAP.md, "
            f"Queue 1 item 10: '3D systems of step3_aos.cu')")
    _check_cuda_qbc("step3_xy_generic", qbc, num_ghost, rp.num_eqn, 3)
    _, nxg, nyg, nzg = qbc.shape
    system, naux = STEP3_SYSTEMS[rp.name]
    aux_ptr = _check_cuda_aux(f"step3_xy_generic: {rp.name}", auxbc, qbc,
                              naux, index_capa)
    is_double = qbc.dtype == torch.float64
    lib = _step3_aos_lib() if lib is None else lib
    q_out = _build.out_tensor("step3_xy_generic", out,
                              (rp.num_eqn, nxg - 4, nyg - 4, nzg - 4), qbc)
    cfl_blocks = torch.empty((step3_aos_blocks(lib, system, nxg, nyg, nzg,
                                               is_double),),
                             dtype=qbc.dtype, device=qbc.device)
    fn = lib.step3_aos_f64 if is_double else lib.step3_aos_f32
    dt_ptr, _dt = _build.dt_arg(dt, qbc)
    rc = fn(qbc.data_ptr(), aux_ptr, q_out.data_ptr(), cfl_blocks.data_ptr(),
            nxg, nyg, nzg, system, int(index_capa), int(bool(fwave)),
            dt_ptr, float(dx), float(dy), float(dz),
            *step3_system_scalars(rp, params), int(order),
            int(transverse_waves), *step3_limiter_ids(mthlim),
            torch.cuda.current_stream(qbc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"step3_aos launch failed: cudaError_t {rc}")
    _build.counted(step3_xy_generic)
    return q_out, torch.amax(cfl_blocks)


step3_xy_generic.launches = 0
step3_xy_generic.device_launches = None
