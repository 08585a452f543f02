"""Time builds of one kernel of ``csrc/`` against each other on one card,
and the timers and timed cases that ``chip_smoke.py`` uses too.

    python -m pyclaw_tpu_torch.ops.time_kernels KERNEL VARIANT [VARIANT ...]
        [--out FILE] [--sass] [--only TEXT ...]

KERNEL is ``step2_ctu``, ``dq2_weno5`` (the Euler 4-wave and 5-wave
cases), ``dq2_weno`` (its 36 instances, each on its 1024^2 case and its
ragged fallback case, :func:`dq_weno_case`; each build's CFL partials
are compared too), ``step3_ctu``, ``step3_aos`` (the heterogeneous-acoustics and
Burgers cases), ``step2_aos`` (the shallow-water, acoustics, Euler
4-wave, Euler 5-wave and sw_aug_2D cases, those of the scalar and
variable-coefficient systems, :data:`SCALAR_CASES`, those of the two
systems without a transverse solver, :data:`NO_TRANS_CASES`, and the
other variants of psystem_2D and vc_advection_2D, :data:`OWN_VARIANTS`),
``euler3d_capa`` (the source ``step3_ctu.cu`` on the
Euler capacity path's case), ``step1`` or ``weno5``, timed through its
wrapper in ``ops/tiled2d.py``, ``ops/sweep.py`` or ``ops/weno.py`` on the
case that ``chip_smoke.py`` times (:func:`step2_ctu_case`,
:func:`dq_case`, :func:`dq_euler5_case`, :func:`step3_ctu_case`,
:func:`step3_aos_case`, :func:`step3_aos_burgers_case`,
:func:`step2_aos_case` and the other ``step2_aos_*_case``, :func:`euler3d_capa_case`, :func:`step1_case`,
:func:`weno5_case`); a case whose system a build lacks (an earlier
build) leaves that build out of it.  The two 1D kernels are timed on
two states at 2^20
cells, the Sod tube's initial state (two constant states: all but one
interface carry no wave) and a seeded smooth state (:func:`smooth_state`:
every interface works), and on the Sod state at their path's shape (800
cells; (3, 806)); step1 also on a seeded wet/dry state of the dry dam
break at 2^20 (:func:`dam_state`: its sw_aug instance; a build without
that system leaves it out), and each library system (ids 6-15,
:data:`LIBRARY_1D`) at 2^20 on its seeded state (:func:`library_case`).
Each VARIANT is ``LABEL=ROOT[@SOURCE][:FLAG,...]``: the source ``ROOT/pyclaw_tpu_torch/
csrc/KERNEL.cu`` (ROOT a checkout, for example an unpacked ``git
archive`` of a parent commit, or a copy with an edited source) built with
this checkout's nvcc flags and the given extra nvcc flags (for example
``-prec-div=false``) into ``build/variants/LABEL/``.  ``@SOURCE`` builds
another source of ROOT for the same case: for ``euler3d_capa``,
``@step3_aos`` is a checkout whose ``step3_aos.cu`` still has its Euler
system (system id 3, before ``step3_ctu.cu`` took the capacity path),
called through its own entry.  All builds start together.

For float32 and float64 (and each state) it prints each build's
registers, stack frame and spills per entry, each variant's output
against the first variant's (max |difference| relative to max |output|,
whether it is equal bit for bit, and the CFL), and its time: CUDA
events over a run of calls, taken in turns (the variants in order, then in reverse, so two
variants run old, new, new, old), and the device time per launch from
torch.profiler.  With ``--sass`` it also prints, for each build, the
static instruction count of each kernel entry and its most frequent
opcodes (``cuobjdump -sass``).  ``--only`` times only the states whose
key (the type and the state's label) holds the text.  Needs a card;
writes the numbers as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from . import _build

ITERS = {"step2_ctu": 200, "dq2_weno5": 100, "dq2_weno": 20,
         "step3_ctu": 10, "step3_aos": 20, "step2_aos": 200,
         "euler3d_capa": 10, "step1": 200, "weno5": 200}
# the source of each KERNEL that is not its own name
SOURCE = {"euler3d_capa": "step3_ctu"}


# ---- timers -------------------------------------------------------------

def events_ms(fn, iters, warm=5):
    """Mean ms of a call of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_per_call(fn, needle, calls=20):
    """Device time per launch of the kernels whose name holds ``needle``
    over ``calls`` calls of ``fn``, from torch.profiler, and the number of
    such launches (None, 0 when it shows none).  At the 1D sizes a
    wrapper call's host work (allocations, the ctypes call, the CFL
    reduction) takes longer than its kernel, so the CUDA events of
    :func:`events_ms` time the host; this times the kernel alone.  A
    window whose trace shows none of the launches (it happens for the
    smallest kernels) is profiled again, up to three windows."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total, count, seen = 0.0, 0, []
        for ev in prof.key_averages():
            if (getattr(ev, "device_type", None)
                    != torch.autograd.DeviceType.CUDA):
                continue
            t = getattr(ev, "self_device_time_total", None)
            t = t if t is not None else getattr(ev, "self_cuda_time_total",
                                                0.0)
            seen.append((ev.key[:60], ev.count, t))
            if needle in ev.key:
                total += t
                count += ev.count
        if count:
            return total / count / 1e3, count
        print(f"    profiler window {attempt + 1}: no {needle} launch among "
              f"{seen[:4]}", flush=True)
    return None, 0


# ---- states and timed cases ---------------------------------------------

def quadrants_state(nx, ny):
    """q of examples.euler_2d_quadrants at nx x ny (a CPU tensor)."""
    from ..examples import euler_2d_quadrants as ex
    return ex.setup(mx=nx, my=ny, outdir=None, device="cpu").solution.q


def euler3d_state(nx, ny, nz):
    """q of examples.euler_3d at nx x ny x nz (a CPU tensor)."""
    from ..examples import euler_3d as ex
    return ex.setup(mx=nx, my=ny, mz=nz, outdir=None,
                    device="cpu").solution.q


def het_state(nx, ny, nz):
    """q and aux (Z, c) of examples.acoustics_3d_heterogeneous."""
    from ..examples import acoustics_3d_heterogeneous as ex
    st = ex.setup(mx=nx, my=ny, mz=nz, outdir=None,
                  device="cpu").solution.state
    return st.q, st.aux


def euler3d_capa_state(nx, ny, nz):
    """q and aux (kappa) of examples.euler_3d with the capacity function
    of ``examples.euler_3d.add_capacity`` (CPU arrays)."""
    from ..examples import euler_3d as ex
    st = ex.add_capacity(ex.setup(mx=nx, my=ny, mz=nz, outdir=None,
                                  device="cpu").solution.state)
    return st.q, st.aux


def padded(q_np, dtype, dev, num_ghost=2):
    """2D q extended by extrapolation on every side."""
    from .. import bc
    q = torch.as_tensor(q_np, dtype=dtype, device=dev)
    return bc.extend(q, num_ghost, [bc.BC.extrap] * 2, [bc.BC.extrap] * 2)


def padded3(q_np, dtype, dev):
    """3D q extended by two extrapolated cells on every side."""
    from .. import bc
    q = torch.as_tensor(q_np, dtype=dtype, device=dev)
    return bc.extend(q, 2, [bc.BC.extrap] * 3, [bc.BC.extrap] * 3)


def padded3_aux(aux_np, dtype, dev):
    """3D aux extended as the solver extends it (no wall reflection)."""
    from .. import bc
    aux = torch.as_tensor(aux_np, dtype=dtype, device=dev)
    return bc.extend(aux, 2, [bc.BC.extrap] * 3, [bc.BC.extrap] * 3,
                     wall_reflects=False)


def _exact(value, dtype):
    """A Python float that is exact in ``dtype``."""
    return float(np.dtype(str(dtype).split(".")[1]).type(value))


def _dt(value, dtype, dev):
    """The step of a timed case: ``value`` rounded to ``dtype``, as a
    float64 0-d tensor on ``dev``, as the solver's device loop holds it
    (the kernels read dt from device memory)."""
    return torch.full((), _exact(value, dtype), dtype=torch.float64,
                      device=dev)


def step2_ctu_case(n, dtype, dev):
    """step2_ctu's timed case at n^2, the classic quadrants path's
    configuration on its first state: qbc (2 extrapolated ghost cells) and
    the rest of ``tiled2d.step2_rows``'s arguments (dt = 0.2/n, dx = dy =
    1/n, gamma 1.4, van Leer, order 2, transverse_waves 2)."""
    qbc = padded(quadrants_state(n, n), dtype, dev)
    h = 1.0 / n
    return qbc, (_dt(0.2 / n, dtype, dev), h, h, {"gamma": 1.4}, (3,) * 4, 2,
                 2, 2)


def step3_ctu_case(n, dtype, dev, q=None):
    """step3_ctu's timed case at n^3, the Euler 3D path's configuration on
    its first state (or on ``q``, another state of the path): qbc (2
    extrapolated ghost cells) and the rest of ``tiled2d.step3_xy``'s
    arguments (dt = 0.3 dx, dx = 2/n, gamma 1.4, MC, order 2,
    transverse_waves 2)."""
    q = euler3d_state(n, n, n) if q is None else q
    qbc = padded3(q, dtype, dev).contiguous()
    d = 2.0 / n
    return qbc, (_dt(0.3 * d, dtype, dev), d, d, d, {"gamma": 1.4}, (4,) * 5,
                 2, 2, 2)


def dq_case(n, dtype, dev):
    """dq2_weno5's timed case at n^2: qbc (the quadrants state, 3 ghost
    cells) and the rest of ``tiled2d.dq_rows``'s arguments (dt = 2/n,
    dx = dy = 1/n, gamma 1.4)."""
    qbc = padded(quadrants_state(n, n), dtype, dev, num_ghost=3)
    return qbc, (_dt(2.0 / n, dtype, dev), 1.0 / n, 1.0 / n, {"gamma": 1.4})


def step3_aos_case(n, dtype, dev):
    """step3_aos's timed case at n^3, the heterogeneous path's
    configuration on its first state: qbc, auxbc and the rest of
    ``tiled2d.step3_xy_generic``'s arguments (dt = 0.45 dx, dx = 2/n,
    vc_acoustics_3D, MC, order 2, no f-waves, no capacity, 2 ghost cells,
    transverse_waves 1)."""
    from .. import riemann
    q_np, aux_np = het_state(n, n, n)
    qbc = padded3(q_np, dtype, dev).contiguous()
    auxbc = padded3_aux(aux_np, dtype, dev).contiguous()
    d = 2.0 / n
    return qbc, auxbc, (_dt(0.45 * d, dtype, dev), d, d, d,
                        riemann.vc_acoustics_3D, {}, (4, 4), 2, False, -1,
                        2, 1)


def euler3d_capa_case(n, dtype, dev, q=None):
    """The Euler capacity path's timed case at n^3 on its first state (or
    on ``q``, another state of the path): qbc, auxbc (kappa) and the rest
    of ``tiled2d.step3_xy``'s positional arguments (dt = 0.3 dx, dx = 2/n,
    gamma 1.4, MC, order 2, 2 ghost cells, transverse_waves 2); the path
    passes ``auxbc=auxbc, index_capa=0, fwave=False``."""
    q_np, aux_np = euler3d_capa_state(n, n, n)
    q_np = q_np if q is None else q
    qbc = padded3(q_np, dtype, dev).contiguous()
    auxbc = padded3_aux(aux_np, dtype, dev).contiguous()
    d = 2.0 / n
    return qbc, auxbc, (_dt(0.3 * d, dtype, dev), d, d, d, {"gamma": 1.4},
                        (4,) * 5, 2, 2, 2)


def shallow_state(nx, ny):
    """q of examples.shallow_2d_radial at nx x ny (a CPU tensor)."""
    from ..examples import shallow_2d_radial as ex
    return ex.setup(mx=nx, my=ny, outdir=None, device="cpu").solution.q


def step2_aos_case(n, dtype, dev):
    """step2_aos's timed case at n^2, the shallow-water path's
    configuration on its first state (the radial dam break): qbc (2
    extrapolated ghost cells) and the rest of
    ``tiled2d.step2_rows_generic``'s arguments (no aux, dt = 0.5 dx, dx =
    dy = 5/n, shallow_roe_with_efix_2D, grav 1, MC, order 2, no f-waves, no
    capacity, 2 ghost cells, transverse_waves 2)."""
    from .. import riemann
    qbc = padded(shallow_state(n, n), dtype, dev)
    h = 5.0 / n
    return qbc, (None, _dt(0.5 * h, dtype, dev), h, h,
                 riemann.shallow_roe_with_efix_2D, {"grav": 1.0}, (4,) * 3,
                 2, False, -1, 2, 2)


def acoustics_state(nx, ny):
    """q of examples.acoustics_2d at nx x ny (a numpy array)."""
    from ..examples import acoustics_2d as ex
    return ex.setup(mx=nx, my=ny, outdir=None, device="cpu").solution.q


def step2_aos_acoustics_case(n, dtype, dev):
    """step2_aos's acoustics instance's timed case at n^2, the acoustics
    path's configuration on its first state (the radial pulse of
    examples.acoustics_2d): qbc (2 extrapolated ghost cells) and the rest
    of ``tiled2d.step2_rows_generic``'s arguments (no aux, dt = 0.4 dx /
    c, dx = dy = 2/n, acoustics_2D with rho 1 and K 4 (Z = c = 2), MC,
    order 2, no f-waves, no capacity, 2 ghost cells, transverse_waves
    2)."""
    from .. import riemann
    qbc = padded(acoustics_state(n, n), dtype, dev)
    h = 2.0 / n
    return qbc, (None, _dt(0.2 * h, dtype, dev), h, h, riemann.acoustics_2D,
                 {"rho": 1.0, "bulk": 4.0, "zz": 2.0, "cc": 2.0}, (4,) * 2,
                 2, False, -1, 2, 2)


def shock_bubble_state(nx, ny):
    """q of examples.shock_bubble at nx x ny (a numpy array)."""
    from ..examples import shock_bubble as ex
    return ex.setup(mx=nx, my=ny, outdir=None, device="cpu").solution.q


def radial_bump_state(nx, ny):
    """q and aux (the bottom) of examples.radial_bump_bathymetry at nx x
    ny (numpy arrays)."""
    from ..examples import radial_bump_bathymetry as ex
    st = ex.setup(mx=nx, my=ny, outdir=None, device="cpu").solution.state
    return st.q, st.aux


def step2_aos_euler4_case(n, dtype, dev):
    """step2_aos's Euler 4-wave instance's timed case at n^2: the
    quadrants off the SoA route on their first state, the classic
    quadrants path's configuration (no aux, dt = 0.2/n, dx = dy = 1/n,
    gamma 1.4, van Leer, order 2, no f-waves, no capacity, 2 ghost cells,
    transverse_waves 2)."""
    from .. import riemann
    qbc = padded(quadrants_state(n, n), dtype, dev)
    h = 1.0 / n
    return qbc, (None, _dt(0.2 * h, dtype, dev), h, h,
                 riemann.euler_4wave_2D, {"gamma": 1.4}, (3,) * 4, 2, False,
                 -1, 2, 2)


def step2_aos_euler5_case(n, dtype, dev):
    """step2_aos's Euler 5-wave instance's timed case at 2n x n/2 (the
    cells of n^2), the shock-bubble path's configuration on its first
    state: qbc (2 extrapolated ghost cells) and the rest of
    ``tiled2d.step2_rows_generic``'s arguments (no aux, dt = 0.2 dx, dx =
    dy = 1/n, gamma 1.4, MC, order 2, no f-waves, no capacity, 2 ghost
    cells, transverse_waves 2)."""
    from .. import riemann
    qbc = padded(shock_bubble_state(2 * n, n // 2), dtype, dev)
    h = 1.0 / n
    return qbc, (None, _dt(0.2 * h, dtype, dev), h, h,
                 riemann.euler_5wave_2D, {"gamma": 1.4}, (4,) * 5, 2, False,
                 -1, 2, 2)


# the ragged grid of the Euler instances' cases: no multiple of either
# type's tile along either axis
EULER_RAGGED = (250, 171)


def step2_aos_euler_ragged_case(name, dtype, dev):
    """step2_aos's Euler 4-wave (the quadrants) or 5-wave (the shock
    bubble) instance on its first state at :data:`EULER_RAGGED`, with the
    rest of the arguments of its full-size case (dx = dy = 1/nx)."""
    from .. import riemann
    nx, ny = EULER_RAGGED
    if name == "euler_4wave_2D":
        q, lims = quadrants_state(nx, ny), (3,) * 4
    else:
        q, lims = shock_bubble_state(nx, ny), (4,) * 5
    h = 1.0 / nx
    return padded(q, dtype, dev), (None, _dt(0.2 * h, dtype, dev), h, h,
                                   riemann.ALL[name], {"gamma": 1.4}, lims,
                                   2, False, -1, 2, 2)


def step2_aos_sw_aug_case(n, dtype, dev):
    """step2_aos's sw_aug_2D instance's timed case at n^2, the radial-bump
    path's configuration on its first state: qbc, auxbc (the bottom; 2
    extrapolated ghost cells each) and the rest of
    ``tiled2d.step2_rows_generic``'s arguments (dt = 0.1 dx, dx = dy =
    2/n, grav 9.8, dry_tolerance 1e-8, minmod, order 2, f-waves, no
    capacity, 2 ghost cells, transverse_waves 2)."""
    from .. import riemann
    q_np, aux_np = radial_bump_state(n, n)
    h = 2.0 / n
    return padded(q_np, dtype, dev), (
        padded(aux_np, dtype, dev), _dt(0.1 * h, dtype, dev), h, h,
        riemann.sw_aug_2D, {"grav": 9.8}, (1,) * 3, 2, True, -1, 2, 2)


def example_state(module, nx, ny, **kw):
    """q and aux of ``examples.<module>``'s initial state at nx x ny
    (numpy arrays; aux None without aux)."""
    import importlib
    ex = importlib.import_module(f"pyclaw_tpu_torch.examples.{module}")
    st = ex.setup(mx=nx, my=ny, outdir=None, device="cpu", **kw).solution.state
    return st.q, st.aux


def gaussian_state(shape):
    """The Burgers runs' pulse exp(-30 |x - 1/2|^2) on the unit square
    (cube) of ``shape`` cells, at the cell centres (a (1, *shape) numpy
    array)."""
    axes = [(np.arange(n) + 0.5) / n - 0.5 for n in shape]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.exp(-30.0 * sum(g * g for g in grids))[None]


def swirl_cell_velocities(nx, ny):
    """The swirl of examples/advection_2d.py at the cell centres of [0, 1]^2
    (u = dpsi/dy, v = -dpsi/dx of psi = sin^2(pi x) sin^2(pi y) / pi): the
    cell velocities of the vc_advection_fwave_2D runs, (2, nx, ny)."""
    x = (np.arange(nx) + 0.5) / nx
    y = (np.arange(ny) + 0.5) / ny
    X, Y = np.meshgrid(x, y, indexing="ij")
    u = np.sin(np.pi * X) ** 2 * np.sin(2.0 * np.pi * Y)
    v = -np.sin(2.0 * np.pi * X) * np.sin(np.pi * Y) ** 2
    return np.stack([u, v])


def fwave_capacity(nx, ny):
    """The capacity row of the vc_advection_fwave_2D runs: 1 + 0.3
    sin(2 pi x) sin(2 pi y) at the cell centres of [0, 1]^2."""
    x = (np.arange(nx) + 0.5) / nx
    y = (np.arange(ny) + 0.5) / ny
    X, Y = np.meshgrid(x, y, indexing="ij")
    return 1.0 + 0.3 * np.sin(2.0 * np.pi * X) * np.sin(2.0 * np.pi * Y)


# step2_aos's scalar and variable-coefficient instances, each timed on the
# first input of its run in chip_smoke.py ([4s]-[4v]): system -> (state
# (q, aux or None) at n^2, dx at n, dt / dx, problem_data, limiter,
# fwave, index_capa, transverse_waves)
SCALAR_CASES = {
    "kpp_2D": (lambda n: example_state("kpp", n, n), lambda n: 4.0 / n,
               0.45, {}, 1, False, -1, 2),
    "vc_acoustics_2D": (lambda n: example_state("acoustics_2d_interface", n,
                                                n),
                        lambda n: 2.0 / n, 0.9, {}, 4, False, -1, 2),
    "vc_advection_2D": (lambda n: example_state("advection_2d", n, n),
                        lambda n: 1.0 / n, 0.45, {}, 3, False, -1, 0),
    "advection_2D": (lambda n: (example_state("advection_2d", n, n)[0],
                                None),
                     lambda n: 1.0 / n, 0.6, {"u": 1.0, "v": 0.5}, 3,
                     False, -1, 2),
    "vc_advection_fwave_2D": (
        lambda n: (example_state("advection_2d", n, n)[0],
                   np.concatenate([swirl_cell_velocities(n, n),
                                   fwave_capacity(n, n)[None]])),
        lambda n: 1.0 / n, 0.45, {}, 4, True, 2, 2),
    "burgers_2D": (lambda n: (gaussian_state((n, n)), None),
                   lambda n: 1.0 / n,
                   0.9, {"efix": True}, 4, False, -1, 2)}


def step2_aos_scalar_case(name, n, dtype, dev):
    """step2_aos's instance of system ``name`` (:data:`SCALAR_CASES`): qbc,
    and the rest of ``tiled2d.step2_rows_generic``'s arguments (auxbc, dt,
    dx, dy, the system, its problem_data, limiters, order 2, fwave,
    index_capa, 2 ghost cells, transverse_waves), all extended by
    extrapolation."""
    from .. import riemann
    state, dx_of, cfl, params, lim, fwave, capa, tw = SCALAR_CASES[name]
    q_np, aux_np = state(n)
    h = dx_of(n)
    rp = riemann.ALL[name]
    auxbc = None if aux_np is None else padded(aux_np, dtype, dev)
    return padded(q_np, dtype, dev), (
        auxbc, _dt(cfl * h, dtype, dev), h, h, rp, params,
        (lim,) * rp.num_waves, 2, fwave, capa, 2, tw)


# step2_aos's instances without a transverse solver, each timed on the
# first input of its unsplit run in chip_smoke.py ([4w]): system ->
# (example, (mx, my) at n, problem_data, limiter, index_capa, the aux rows
# its step reads); f-waves, transverse_waves 0, dt = 0.3 min(dx kappa_min,
# dy) / max speed bound
NO_TRANS_CASES = {
    "psystem_2D": ("psystem_2d", lambda n: (n, n),
                   {"stress_relation": "exp"}, 4, -1, (0, 1)),
    "shallow_sphere_fwave_2D": ("shallow_sphere", lambda n: (n, n // 2),
                                {"grav": 1.0}, 4, 1, (1,))}


def step2_aos_no_trans_case(name, n, dtype, dev):
    """step2_aos's instance of system ``name`` (:data:`NO_TRANS_CASES`) on
    its example's initial state at (mx, my): qbc, and the rest of
    ``tiled2d.step2_rows_generic``'s arguments (auxbc, dt, dx, dy, the
    system, its problem_data, limiters, order 2, f-waves, index_capa, 2
    ghost cells, transverse_waves 0), all extended by extrapolation."""
    import importlib

    from .. import riemann
    module, cells, params, lim, capa, _ = NO_TRANS_CASES[name]
    mx, my = cells(n)
    ex = importlib.import_module(f"pyclaw_tpu_torch.examples.{module}")
    st = ex.setup(mx=mx, my=my, outdir=None, device="cpu").solution.state
    dx, dy = st.patch.delta
    kappa = 1.0 if capa < 0 else float(st.aux[capa].min())
    rp = riemann.ALL[name]
    return padded(st.q, dtype, dev), (
        padded(st.aux, dtype, dev),
        _dt(0.3 * min(dx * kappa, dy) / 1.5, dtype, dev), dx, dy, rp,
        params, (lim,) * rp.num_waves, 2, True, capa, 2, 0)


# the other variants of step2_aos's psystem_2D and vc_advection_2D
# instances (each a design of its own), each on its path's state at n^2 as
# in SCALAR_CASES / NO_TRANS_CASES but for: label -> (system,
# transverse_waves, a capacity row (:func:`fwave_capacity`, appended to
# aux), f-waves)
OWN_VARIANTS = {
    "vc_advection_2D tw1": ("vc_advection_2D", 1, False, False),
    "vc_advection_2D tw2 capa fwave": ("vc_advection_2D", 2, True, True),
    "psystem_2D capa": ("psystem_2D", 0, True, True),
    "psystem_2D wave": ("psystem_2D", 0, False, False)}


def step2_aos_variant_case(label, n, dtype, dev):
    """step2_aos's case :data:`OWN_VARIANTS` ``label``: qbc and the rest of
    ``tiled2d.step2_rows_generic``'s arguments (as
    :func:`step2_aos_scalar_case` and :func:`step2_aos_no_trans_case`)."""
    name, tw, capa, fwave = OWN_VARIANTS[label]
    case = (step2_aos_scalar_case if name in SCALAR_CASES
            else step2_aos_no_trans_case)
    qbc, args = case(name, n, dtype, dev)
    args = list(args)
    if capa:
        nx, ny = qbc.shape[1] - 4, qbc.shape[2] - 4
        kappa = padded(fwave_capacity(nx, ny)[None], dtype, dev)
        args[9] = args[0].shape[0]
        args[0] = torch.cat([args[0], kappa]).contiguous()
    args[8] = fwave
    args[11] = tw
    return qbc, tuple(args)


def step3_aos_burgers_case(n, dtype, dev):
    """step3_aos's burgers_3D instance's timed case at n^3, the Burgers 3D
    run's configuration on its first state (the pulse of
    :func:`gaussian_state`): qbc, no aux, and the rest of
    ``tiled2d.step3_xy_generic``'s arguments (dt = 0.45 dx, dx = 1/n, the
    entropy fix, MC, order 2, no f-waves, no capacity, 2 ghost cells,
    transverse_waves 2)."""
    from .. import riemann
    qbc = padded3(gaussian_state((n,) * 3), dtype, dev).contiguous()
    d = 1.0 / n
    return qbc, None, (_dt(0.45 * d, dtype, dev), d, d, d,
                       riemann.burgers_3D, {"efix": True}, (4,), 2, False,
                       -1, 2, 2)


# burgers_3D's options (transverse_waves, order, limiter, index_capa,
# fwave, efix) that chip_smoke.py [3o] holds against the plain version:
# every transverse_waves and order, MC, minmod, the CFL-dependent id 10
# and van Leer, a capacity row, the f-wave form, the entropy fix on and
# off; the first is the Burgers 3D run's.  Each is timed at 192^3 on the
# pulse and on a ragged grid of several tiles on a seeded state of either
# sign (transonic interfaces).
BURGERS3D_OPTS = [(2, 2, 4, -1, False, True), (1, 2, 1, 0, False, False),
                  (0, 1, 4, -1, False, True), (2, 2, 10, 0, True, True),
                  (2, 1, 3, 0, False, False)]
BURGERS3D_RAGGED = (17, 13, 9)


def step3_aos_burgers_variant_case(k, shape, dtype, dev, seed=15):
    """step3_aos's burgers_3D instance with option k of
    :data:`BURGERS3D_OPTS` on ``shape`` cells: the pulse of
    :func:`gaussian_state` (a cube, as the Burgers 3D run) or a seeded
    standard normal state (another shape), a seeded capacity row in
    0.7 .. 1.3 where the option has one; qbc, auxbc (or None) and the rest
    of ``tiled2d.step3_xy_generic``'s arguments (dt = 0.45 min(dx), dx =
    1/n an axis)."""
    from .. import riemann
    tw, order, lim, capa, fwave, efix = BURGERS3D_OPTS[k]
    rng = np.random.default_rng(seed + k)
    cube = len(set(shape)) == 1
    q = gaussian_state(shape) if cube else rng.standard_normal((1,) + shape)
    qbc = padded3(q, dtype, dev).contiguous()
    auxbc = None
    if capa >= 0:
        kappa = 0.7 + 0.6 * rng.random((1,) + shape)
        auxbc = padded3_aux(kappa, dtype, dev).contiguous()
    d = tuple(1.0 / n for n in shape)
    return qbc, auxbc, (_dt(0.45 * min(d), dtype, dev), *d,
                        riemann.burgers_3D, {"efix": efix}, (lim,), order,
                        fwave, capa, 2, tw)


def dq_euler5_case(n, dtype, dev):
    """dq2_weno5's Euler 5-wave instance's timed case at 2n x n/2 (the
    cells of n^2): qbc (the shock-bubble state, 3 ghost cells) and the
    rest of ``tiled2d.dq_rows``'s arguments (dt = 0.5 dx, dx = dy = 1/n,
    gamma 1.4) and the system."""
    from .. import riemann
    qbc = padded(shock_bubble_state(2 * n, n // 2), dtype, dev, num_ghost=3)
    h = 1.0 / n
    return qbc, (_dt(0.5 * h, dtype, dev), h, h, {"gamma": 1.4}), \
        riemann.euler_5wave_2D


def random_state(rng, nx, ny, gamma=1.4, pockets=0.0):
    """A seeded admissible Euler state (positive density and pressure).
    With ``pockets`` > 0, that share of the cells are low-density pockets
    (rho = p = 0.05), where WENO's edge values go non-positive and the
    positivity fallback runs."""
    rho = 0.5 + rng.random((nx, ny))
    u = 0.5 * rng.standard_normal((nx, ny))
    v = 0.5 * rng.standard_normal((nx, ny))
    p = 0.5 + rng.random((nx, ny))
    if pockets > 0.0:
        pocket = rng.random((nx, ny)) < pockets
        rho = np.where(pocket, 0.05, rho)
        p = np.where(pocket, 0.05, p)
    return np.stack([rho, rho * u, rho * v,
                     p / (gamma - 1.0) + 0.5 * rho * (u * u + v * v)])


WENO_ORDERS = (7, 9, 11, 13, 15, 17)     # csrc/dq2_weno.cu's
# its systems (ops/tiled2d.py:DQ_SYSTEMS)
DQ_WENO_SYSTEMS = ("euler_4wave_2D", "acoustics_2D", "euler_5wave_2D")
# acoustics_2D as examples/acoustics_2d.py sets it up
DQ_WENO_ACOUSTICS = {"rho": 1.0, "bulk": 4.0, "zz": 2.0, "cc": 2.0}


def dq_weno_rp(name):
    from ..riemann import acoustics, euler
    return {"euler_4wave_2D": euler.euler_4wave_2D,
            "euler_5wave_2D": euler.euler_5wave_2D,
            "acoustics_2D": acoustics.acoustics_2D}[name]


def dq_weno_params(name):
    return DQ_WENO_ACOUSTICS if name == "acoustics_2D" else {"gamma": 1.4}


def dq_weno_state(name, nx, ny, seed, pockets=0.0):
    """A seeded state of system ``name`` (nx, ny cells): an admissible
    Euler state (with ``pockets``, low-density cells that take the
    positivity fallback), the 5-wave system's with a tracer, or a random
    acoustics state."""
    rng = np.random.default_rng(seed)
    if name == "acoustics_2D":
        return rng.standard_normal((3, nx, ny))
    q = random_state(rng, nx, ny, pockets=pockets)
    if name == "euler_5wave_2D":
        q = np.concatenate([q, (q[0] * rng.random((nx, ny)))[None]])
    return q


def dq_weno_case(name, order, tname, dev, big=True):
    """(qbc, dt, dx, dy) of one dq of an instance of ``csrc/dq2_weno.cu``
    (chip_smoke.py [4y] and [6]): at 1024^2 (Euler 5-wave 2048x512, as
    [4q]) on a seeded admissible state, or at 250x171 (ragged) on a state
    whose Euler edges take the positivity fallback."""
    k = (order + 1) // 2
    nx, ny = (((2048, 512) if name == "euler_5wave_2D" else (1024, 1024))
              if big else (250, 171))
    q = dq_weno_state(name, nx, ny, seed=order * 7 + len(name) + big,
                      pockets=0.0 if big else 0.1)
    dtype = getattr(torch, tname)
    qbc = padded(q, dtype, dev, num_ghost=k).contiguous()
    dt = float(np.dtype(tname).type(0.3 / max(nx, ny)))
    return qbc, dt, 1.0 / nx, 1.0 / ny


def sod_state(n):
    """q of examples.euler_1d_shocktube at n cells (a CPU array)."""
    from ..examples import euler_1d_shocktube as ex
    return ex.setup(nx=n, outdir=None, device="cpu").solution.q


def smooth_state(n, seed=0):
    """A seeded smooth Euler state (gamma 1.4) at n cells of [-0.5, 0.5]:
    rho, u and p each a constant plus four sine modes a_k sin(2 pi k x +
    phi_k), k drawn from 1..64, with amplitudes summing to at most 0.2
    (rho, p in 0.8 .. 1.2) and 0.4 (|u| <= 0.4).  Every interface then
    carries waves, u takes both signs, and no rarefaction is transonic:
    |u| stays well below the sound speed (about 1.2)."""
    rng = np.random.default_rng(seed)
    x = (np.arange(n) + 0.5) / n - 0.5

    def field(mean, amp):
        k = rng.choice(np.arange(1, 65), 4, replace=False)
        phase = rng.uniform(0.0, 2.0 * np.pi, 4)
        a = amp / 4 * rng.uniform(0.5, 1.0, 4)
        return mean + sum(a[j] * np.sin(2.0 * np.pi * k[j] * x + phase[j])
                          for j in range(4))
    rho, u, p = field(1.0, 0.2), field(0.0, 0.4), field(1.0, 0.2)
    return np.stack([rho, rho * u, p / 0.4 + 0.5 * rho * u * u])


def dam_state(n, seed=0):
    """A seeded wet/dry state of the dry dam break's system at n cells of
    [-5, 5] (q (2, n), aux (1, n), CPU arrays): the example's beach b =
    max(0, 0.4 (x - 1)), and in each cell, drawn independently, water of
    depth 0.2 .. 1.2 with a velocity of either sign (3 in 4 cells) or a
    dry bed.  Its interfaces take every branch of the augmented solver:
    wet/wet, the Ritter fronts either way, walls where the beach rises
    above a neighbour's surface, both dry."""
    rng = np.random.default_rng(seed)
    x = (np.arange(n) + 0.5) * (10.0 / n) - 5.0
    b = np.maximum(0.0, 0.4 * (x - 1.0))
    h = np.where(rng.random(n) < 0.75, 0.2 + rng.random(n), 0.0)
    return np.stack([h, h * rng.standard_normal(n)]), b[None]


def padded_1d(q_np, dtype, dev, num_ghost):
    """1D q extended by ``num_ghost`` extrapolated cells at each end."""
    from .. import bc
    q = torch.as_tensor(q_np, dtype=dtype, device=dev)
    return bc.extend(q, num_ghost, [bc.BC.extrap], [bc.BC.extrap])


STATES_1D = {"sod": sod_state, "smooth": smooth_state}
# the dry dam break's grav and dry_tolerance (examples/dam_break_dry.py)
DAM_PARAMS = {"grav": 9.8, "dry_tolerance": 1e-5}


def step1_case(n, dtype, dev, state="sod"):
    """step1's timed case at n cells: qbc (2 extrapolated ghost cells)
    and the rest of ``sweep.step1``'s arguments.  On a state of
    :data:`STATES_1D`, the classic Sod path's configuration (no aux, dt =
    0.5 dx, dx = 1/n, euler_with_efix_1D, gamma 1.4, MC, order 2, no
    f-waves, no capacity, 2 ghost cells); on "dam" (:func:`dam_state`)
    the dry dam break's (the beach in aux, dt = 0.06 dx, dx = 10/n,
    sw_aug_1D, grav 9.8, dry_tolerance 1e-5, minmod, order 2, f-waves, no
    capacity)."""
    from .. import riemann
    if state == "dam":
        q_np, aux_np = dam_state(n)
        qbc = padded_1d(q_np, dtype, dev, 2)
        auxbc = padded_1d(aux_np, dtype, dev, 2)
        dx = 10.0 / n
        return qbc, (auxbc, _dt(0.06 * dx, dtype, dev), dx,
                     riemann.sw_aug_1D, DAM_PARAMS, (1, 1), 2, True, -1, 2)
    qbc = padded_1d(STATES_1D[state](n), dtype, dev, 2)
    dx = 1.0 / n
    return qbc, (None, _dt(0.5 * dx, dtype, dev), dx,
                 riemann.euler_with_efix_1D, {"gamma": 1.4}, (4,) * 3, 2,
                 False, -1, 2)


# ---- the 1D records of step1.cu's systems 6-15 ----------------------------
# each record's physics scalars on its seeded state (library_state) and in
# its timed case (library_case): the examples' values
LIBRARY_1D = {
    "shallow_roe_with_efix_1D": {"grav": 1.0},
    "shallow_hlle_1D": {"grav": 1.0},
    "shallow_bathymetry_fwave_1D": {"grav": 9.8},
    "psystem_1D": {"stress_relation": "exp"},
    "vc_advection_1D": {},
    "vc_advection_fwave_1D": {},
    "acoustics_variable_1D": {},
    "burgers_1D": {"efix": True},
    "traffic_1D": {"umax": 1.0},
    "mhd_1D": {"gamma": 2.0, "bx": 0.75},
}
# (limiter id, f-waves) of each record's example: MC 4, van Leer 3
LIBRARY_OPTS = {
    "shallow_roe_with_efix_1D": (4, False), "shallow_hlle_1D": (4, False),
    "shallow_bathymetry_fwave_1D": (3, True), "psystem_1D": (3, True),
    "vc_advection_1D": (4, False), "vc_advection_fwave_1D": (4, True),
    "acoustics_variable_1D": (4, False), "burgers_1D": (3, False),
    "traffic_1D": (3, False), "mhd_1D": (4, False)}


def library_state(name, n, seed=0):
    """A seeded admissible state of record ``name`` (a key of
    :data:`LIBRARY_1D`, or ``sw_aug_1D``) at n cells: (q (num_eqn, n),
    the aux rows the record reads (naux, n) or None), CPU float64 arrays.
    Velocities take both signs, so that the transonic and sign branches
    (the entropy fixes, the f-wave splits, traffic's sonic point) are
    taken: shallow water h in 0.5 .. 1.5 (bathymetry below the surface,
    0 .. 0.3; sw_aug_1D also dry and damp cells on low and high bottoms);
    the p-system rho and K in 1 .. 4 and K eps within +-2.4; impedances
    and sound speeds in 0.5 .. 2.5; traffic densities in 0 .. 1; MHD rho
    in 0.3 .. 1.3, p in 0.2 .. 1.2 at gamma 2 and bx 0.75."""
    rng = np.random.default_rng(seed)
    r, z = rng.random, rng.standard_normal
    if name in ("shallow_roe_with_efix_1D", "shallow_hlle_1D",
                "shallow_bathymetry_fwave_1D"):
        h = 0.5 + r(n)
        q = np.stack([h, h * 1.2 * z(n)])
        aux = 0.3 * r((1, n)) if name.endswith("fwave_1D") else None
        return q, aux
    if name == "sw_aug_1D":
        kind = rng.integers(0, 4, n)
        h = np.where(kind == 0, 0.2 + r(n),
                     np.where(kind == 3, 1e-5 * r(n), 0.0))
        b = np.where(kind == 2, 2.0 + r(n), 0.3 * r(n))
        return np.stack([h, h * z(n)]), b[None]
    if name == "psystem_1D":
        aux = 1.0 + 3.0 * r((2, n))
        return np.stack([0.6 * z(n).clip(-1, 1), aux[0] * z(n)]), aux
    if name in ("vc_advection_1D", "vc_advection_fwave_1D"):
        return z((1, n)), z((1, n))
    if name == "acoustics_variable_1D":
        return z((2, n)), 0.5 + 2.0 * r((2, n))
    if name == "burgers_1D":
        return z((1, n)), None
    if name == "traffic_1D":
        return r((1, n)), None
    if name == "mhd_1D":
        par = LIBRARY_1D[name]
        rho, p = 0.3 + r(n), 0.2 + r(n)
        vel = 0.8 * z((3, n))
        by, bz = z(n), z(n)
        E = (p / (par["gamma"] - 1.0) + 0.5 * rho * (vel ** 2).sum(0)
             + 0.5 * (par["bx"] ** 2 + by ** 2 + bz ** 2))
        return np.stack([rho, *(rho * vel), by, bz, E]), None
    raise KeyError(name)


def library_case(name, n, dtype, dev, seed=0):
    """step1's timed case of record ``name`` at n cells: qbc and auxbc (2
    extrapolated ghost cells) of :func:`library_state` and the rest of
    ``sweep.step1``'s arguments: the example's limiter and form
    (:data:`LIBRARY_OPTS`), order 2, no capacity, dt = 0.05 dx (every
    speed of the state is below 10), dx = 1/n."""
    from .. import riemann
    q_np, aux_np = library_state(name, n, seed)
    qbc = padded_1d(q_np, dtype, dev, 2)
    auxbc = None if aux_np is None else padded_1d(aux_np, dtype, dev, 2)
    rp = riemann.ALL[name]
    lim, fwave = LIBRARY_OPTS[name]
    dx = 1.0 / n
    return qbc, (auxbc, _dt(0.05 * dx, dtype, dev), dx, rp, LIBRARY_1D[name],
                 (lim,) * rp.num_waves, 2, fwave, -1, 2)


def weno5_case(n, dtype, dev, state="sod"):
    """weno5's timed case at n cells, the SharpClaw Sod path's input on
    ``state``: q with 3 extrapolated ghost cells, (3, n + 6)."""
    return padded_1d(STATES_1D[state](n), dtype, dev, 3)


def _step2_ctu_call(dtype, dev, n=1024):
    from . import tiled2d
    qbc, args = step2_ctu_case(n, dtype, dev)

    def make(lib, source=None):
        lib = tiled2d.bind_step2_lib(lib)
        return lambda: tiled2d.step2_rows(qbc, *args, lib=lib)
    return make


def _step3_ctu_call(dtype, dev, n=192):
    from . import tiled2d
    qbc, args = step3_ctu_case(n, dtype, dev)

    def make(lib, source=None):
        lib = tiled2d.bind_step3_lib(lib)
        return lambda: tiled2d.step3_xy(qbc, *args, lib=lib)
    return make


def dq_euler5_ragged_case(dtype, dev):
    """dq2_weno5's Euler 5-wave instance on the ragged 250x171 state of
    :func:`dq_weno_case` at WENO order 5 (several 16x16 tiles, partial
    ones on both axes; low-density pockets take the positivity fallback):
    qbc and the rest of ``tiled2d.dq_rows``'s arguments and the system."""
    from .. import riemann
    tname = str(dtype).split(".")[1]
    qbc, dt, dx, dy = dq_weno_case("euler_5wave_2D", 5, tname, dev,
                                   big=False)
    return qbc, (dt, dx, dy, {"gamma": 1.4}), riemann.euler_5wave_2D


def _dq_call(dtype, dev, n=1024):
    """dq2_weno5's Euler 4-wave instance on the quadrants at n^2, its Euler
    5-wave instance on the shock bubble at 2n x n/2 and at the [4q]
    SharpClaw path's n x n/4, and on the ragged fallback state; each
    Euler 5-wave call also gives its CFL partials (``.partials``)."""
    from . import tiled2d
    from .. import riemann
    qbc, args = dq_case(n, dtype, dev)
    makes = {}
    for label, case in (
            ("", lambda: (qbc, args, riemann.euler_4wave_2D)),
            ("euler5", lambda: dq_euler5_case(n, dtype, dev)),
            ("euler5 path", lambda: dq_euler5_case(n // 2, dtype, dev)),
            ("euler5 ragged", lambda: dq_euler5_ragged_case(dtype, dev))):
        # the state is made at the first variant's call
        case = functools.cache(case)

        def make(lib, source=None, case=case, label=label):
            lib = tiled2d.bind_dq_lib(lib)
            qbc, args, rp = case()
            if not tiled2d.dq_build_takes(lib, rp):
                return None        # an earlier build without the system

            def call():
                return tiled2d.dq_rows(qbc, *args, lib=lib, rp=rp)
            if label:
                call.partials = lambda: dq_weno_partials(
                    lib, qbc, *args, 5, rp)
            return call
        makes[label] = make
    return makes


def dq_weno_partials(lib, qbc, dt, dx, dy, params, order, rp):
    """The CFL partial of each block of one launch of a build of
    ``csrc/dq2_weno.cu`` (``lib`` bound by ``tiled2d.bind_dq_weno_lib``),
    or of ``csrc/dq2_weno5.cu`` at order 5 (bound by
    ``tiled2d.bind_dq_lib``): the launch ``tiled2d.dq_rows`` makes,
    without its max over the partials."""
    from . import tiled2d
    k = (order + 1) // 2
    _, nxg, nyg = qbc.shape
    dq = torch.empty((rp.num_eqn, nxg - 2 * k, nyg - 2 * k), dtype=qbc.dtype,
                     device=qbc.device)
    nblocks = (lib.dq2_weno5_blocks(nxg, nyg) if order == 5
               else lib.dq2_weno_blocks(nxg, nyg, order))
    cflb = torch.empty((nblocks,), dtype=qbc.dtype, device=qbc.device)
    prefix = tiled2d.dq_weno_entry(rp.name, order)
    fn = getattr(lib, prefix + ("_f64" if qbc.dtype == torch.float64
                                else "_f32"))
    dt_ptr, _dt = _build.dt_arg(dt, qbc)
    rc = fn(qbc.data_ptr(), dq.data_ptr(), cflb.data_ptr(), nxg, nyg, dt_ptr,
            float(dx), float(dy), *tiled2d.dq_system_params(rp, params),
            torch.cuda.current_stream(qbc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{prefix} launch failed: cudaError_t {rc}")
    return cflb


def _dq_weno_call(dtype, dev):
    """Each instance of ``csrc/dq2_weno.cu`` of ``dtype`` on its 1024^2
    case and on its ragged 250x171 case (:func:`dq_weno_case`), timed
    through ``tiled2d.dq_rows``; each call also gives its CFL partials
    (``.partials``, :func:`dq_weno_partials`) for the bit check."""
    from . import tiled2d
    tname = str(dtype).split(".")[1]
    makes = {}
    for order in WENO_ORDERS:
        for name in DQ_WENO_SYSTEMS:
            for big in (True, False):
                # the state is made at the first variant's call (so that
                # --only makes none of the others)
                case = functools.cache(functools.partial(
                    dq_weno_case, name, order, tname, dev, big))

                def make(lib, source=None, case=case, order=order,
                         name=name):
                    lib = tiled2d.bind_dq_weno_lib(lib)
                    rp, params = dq_weno_rp(name), dq_weno_params(name)
                    qbc, dt, dx, dy = case()
                    k = (order + 1) // 2

                    def call():
                        return tiled2d.dq_rows(qbc, dt, dx, dy, params,
                                               order, k, lib=lib, rp=rp)
                    call.partials = lambda: dq_weno_partials(
                        lib, qbc, dt, dx, dy, params, order, rp)
                    return call
                makes[f"{order} {name}" + ("" if big else " ragged")] = make
    return makes


def _step3_aos_call(dtype, dev, n=192):
    """step3_aos's heterogeneous-acoustics case and its Burgers cases: the
    Burgers 3D run's (``burgers``), each other option of
    :data:`BURGERS3D_OPTS` on the pulse at n^3 (``burgers v<k>``) and every
    option on the ragged grid (``burgers ragged v<k>``)."""
    from . import tiled2d
    makes = {}
    cases = [("", lambda: step3_aos_case(n, dtype, dev)),
             ("burgers", lambda: step3_aos_burgers_case(n, dtype, dev))]
    cases += [(f"burgers v{k}", lambda k=k: step3_aos_burgers_variant_case(
        k, (n,) * 3, dtype, dev)) for k in range(1, len(BURGERS3D_OPTS))]
    cases += [(f"burgers ragged v{k}",
               lambda k=k: step3_aos_burgers_variant_case(
                   k, BURGERS3D_RAGGED, dtype, dev))
              for k in range(len(BURGERS3D_OPTS))]
    for label, case in cases:
        # the state is made at the first variant's call (so that --only
        # makes none of the others)
        case = functools.cache(case)

        def make(lib, source=None, case=case):
            lib = tiled2d.bind_step3_aos_lib(lib)
            qbc, auxbc, args = case()
            if not tiled2d.step3_build_takes(lib, args[4]):
                return None        # an earlier build without the system
            return lambda: tiled2d.step3_xy_generic(qbc, auxbc, *args,
                                                    lib=lib)
        makes[label] = make
    return makes


def _step2_aos_call(dtype, dev, n=1024):
    from . import tiled2d
    makes = {}
    cases = [("", step2_aos_case),
             ("acoustics", step2_aos_acoustics_case),
             ("euler4", step2_aos_euler4_case),
             ("euler5", step2_aos_euler5_case),
             ("sw_aug", step2_aos_sw_aug_case)]
    cases += [(f"{label} ragged", lambda n, dtype, dev, name=name:
               step2_aos_euler_ragged_case(name, dtype, dev))
              for label, name in (("euler4", "euler_4wave_2D"),
                                  ("euler5", "euler_5wave_2D"))]
    cases += [(name, lambda n, dtype, dev, name=name: step2_aos_scalar_case(
        name, n, dtype, dev)) for name in SCALAR_CASES]
    cases += [(name, lambda n, dtype, dev, name=name: step2_aos_no_trans_case(
        name, n, dtype, dev)) for name in NO_TRANS_CASES]
    cases += [(label, lambda n, dtype, dev, label=label:
               step2_aos_variant_case(label, n, dtype, dev))
              for label in OWN_VARIANTS]
    for label, case in cases:
        qbc, args = case(n, dtype, dev)

        def make(lib, source="step2_aos", qbc=qbc, args=args):
            lib = tiled2d.bind_step2_aos_lib(lib)
            if not tiled2d.aos_build_takes(lib, args[4]):
                return None        # an earlier build without the system
            return lambda: tiled2d.step2_rows_generic(qbc, *args, lib=lib)
        makes[label] = make
    return makes


def _step3_aos_euler(lib, qbc, auxbc, args):
    """One step of the Euler system of an earlier build of step3_aos.cu
    (system id 3, which this checkout's wrapper no longer routes) on the
    Euler capacity case, through that build's own entry (``lib`` bound by
    ``tiled2d.bind_step3_aos_lib``)."""
    dt, dx, dy, dz, params, lims, order, _, tw = args
    nxg, nyg, nzg = qbc.shape[1:]
    is_double = qbc.dtype == torch.float64
    q_out = torch.empty((5, nxg - 4, nyg - 4, nzg - 4), dtype=qbc.dtype,
                        device=qbc.device)
    cfl_blocks = torch.empty((lib.step3_aos_blocks(nxg, nyg, nzg,
                                                   int(is_double)),),
                             dtype=qbc.dtype, device=qbc.device)
    fn = lib.step3_aos_f64 if is_double else lib.step3_aos_f32
    rc = fn(qbc.data_ptr(), auxbc.data_ptr(), q_out.data_ptr(),
            cfl_blocks.data_ptr(), nxg, nyg, nzg, 3, 0, 0, float(dt),
            float(dx), float(dy), float(dz), float(params["gamma"]), 0.0,
            0.0, int(order), int(tw), *[int(m) for m in lims],
            torch.cuda.current_stream(qbc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"step3_aos (Euler) launch failed: cudaError_t "
                           f"{rc}")
    return q_out, torch.amax(cfl_blocks)


def _euler3d_capa_call(dtype, dev, n=192):
    from . import tiled2d
    qbc, auxbc, args = euler3d_capa_case(n, dtype, dev)

    def make(lib, source="step3_ctu"):
        if source == "step3_aos":
            # that build (an older commit's) takes dt by value
            lib = tiled2d.bind_step3_aos_lib(lib)
            types = list(tiled2d.STEP3_AOS_ARGTYPES)
            types[10] = ctypes.c_double
            for fn in (lib.step3_aos_f32, lib.step3_aos_f64):
                fn.argtypes = types + [ctypes.c_void_p]
            return lambda: _step3_aos_euler(lib, qbc, auxbc, args)
        lib = tiled2d.bind_step3_lib(lib)
        return lambda: tiled2d.step3_xy(qbc, *args, lib=lib, auxbc=auxbc,
                                        index_capa=0)
    return make


# the 1D kernels' timed states: name -> (state, cells); "dam" times
# step1 alone (the dry dam break runs no weno5)
CASES_1D = {"sod": ("sod", 2 ** 20), "smooth": ("smooth", 2 ** 20),
            "sod 800": ("sod", 800), "dam": ("dam", 2 ** 20)}


def _step1_call(dtype, dev):
    from . import sweep
    makes = {}
    cases = {label: step1_case(n, dtype, dev, state)
             for label, (state, n) in CASES_1D.items()}
    # the library systems (ids 6-15) at 2^20 cells on their seeded states
    cases.update({f"lib {name}": library_case(name, 2 ** 20, dtype, dev)
                  for name in LIBRARY_1D})
    for label, (qbc, args) in cases.items():

        def make(lib, source=None, qbc=qbc, args=args):
            lib = sweep.bind_lib(lib)
            if not sweep.build_takes(lib, args[3]):
                return None        # an earlier build without the system
            return lambda: sweep.step1(qbc, *args, lib=lib)
        makes[label] = make
    return makes


def _weno5_call(dtype, dev):
    from . import weno
    makes = {}
    for label, (state, n) in CASES_1D.items():
        if state == "dam":
            continue
        q = weno5_case(n, dtype, dev, state)

        def make(lib, source=None, q=q):
            lib = weno.bind_lib(lib)
            return lambda: weno.weno5(q, lib=lib)
        makes[label] = make
    return makes


def _outputs(res):
    """(output tensor, CFL as a float or None) of a wrapper's result: a
    step's (q, cfl) or weno5's (ql, qr), the two edges stacked."""
    a, b = res
    if b.dim() == 0:
        return a, float(b)
    return torch.stack([a, b]), None


# ---- variants -----------------------------------------------------------

def _build_variants(variants):
    procs = []
    start = time.perf_counter()
    for label, root, source, flags in variants:
        src = os.path.join(root, "pyclaw_tpu_torch", "csrc", f"{source}.cu")
        out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), "variants",
                               label)
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, f"lib{source}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
               *_build.EXTRA_NVCC_FLAGS.get(source, []), *flags, "-o", out,
               src]
        procs.append((label, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for label, out, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"build of {label} failed:\n{stderr}")
        # the builds run together: a build done before an earlier-listed
        # one is read when that one is
        print(f"  [{label}] built by {time.perf_counter() - start:.1f} s")
        for fn, rec in ptxas_resources(stdout + stderr).items():
            if rec["registers"] is not None:
                print(f"  [{label}] {fn}: {rec['registers']} registers, "
                      f"stack {rec.get('stack')} B, spill stores "
                      f"{rec.get('spill_stores')} B, loads "
                      f"{rec.get('spill_loads')} B")
        libs[label] = ctypes.CDLL(out)
    return libs


def sass_text(lib_path):
    """``cuobjdump -sass`` of a built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300).stdout


def sass_digests(text):
    """{kernel entry: sha1 of its instructions} from ``cuobjdump -sass``
    text: each ``Function :`` section's instruction lines without their
    address comments and encodings, so that two builds of one function
    compare equal exactly when they compiled to the same code (the
    anonymous namespace's name, which each build draws anew, is left out
    of the entries' names)."""
    import hashlib
    out, name, h = {}, None, None
    # the anonymous namespace's name differs from build to build
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", text)
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                out[name] = h.hexdigest()
            name, h = m.group(1), hashlib.sha1()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*(/\*.*)?$", line)
        if name and m:
            h.update(m.group(1).encode() + b"\n")
    if name:
        out[name] = h.hexdigest()
    return out


def parse_sass(text, top=12):
    """{kernel entry: (static instruction count, [(opcode, count), ...])}
    from ``cuobjdump -sass``
    text: each ``Function :`` section's instructions by opcode (without
    its modifiers; a predicate guard is not an opcode)."""
    out, name, ops = {}, None, collections.Counter()
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                out[name] = (sum(ops.values()), ops.most_common(top))
            name, ops = m.group(1), collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if name and m:
            ops[m.group(1).split(".")[0]] += 1
    if name:
        out[name] = (sum(ops.values()), ops.most_common(top))
    return out


def sass_compare(a, b):
    """(the entries equal in the two {entry: value} maps ``a`` and ``b``,
    :func:`sass_digests` of two builds, the other entries of either), each
    sorted."""
    same = sorted(k for k in a.keys() & b.keys() if a[k] == b[k])
    return same, sorted((a.keys() | b.keys()) - set(same))


def ptxas_resources(text):
    """{function: {"registers", "stack", "spill_stores", "spill_loads"}}
    from the ``-Xptxas -v`` report of a build: each entry function's
    registers (None for a function that is not an entry) and each
    function's stack frame and spill bytes."""
    out, entry, props = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out.setdefault(entry, {"registers": None})
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props:
            rec = out.setdefault(props, {"registers": None})
            rec.update(zip(("stack", "spill_stores", "spill_loads"),
                           map(int, m.groups())))
            props = None
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry]["registers"] = int(m.group(1))
    return out


# the system structs of csrc/dq2_systems.cuh, by their record's name
DQ_WENO_STRUCTS = {"Euler4": "euler_4wave_2D", "Acoustics": "acoustics_2D",
                   "Euler5": "euler_5wave_2D"}


def dq_weno_instance(function):
    """(system name, WENO order, type name) of the mangled name of an
    instance of ``csrc/dq2_weno.cu``'s kernel, or None for another
    function."""
    m = re.search(r"dq2_weno_kernelI\w*?\d(Euler4|Euler5|Acoustics)ELi(\d+)E"
                  r"([fd])E", function)
    if m is None:
        return None
    return (DQ_WENO_STRUCTS[m.group(1)], 2 * int(m.group(2)) - 1,
            "float32" if m.group(3) == "f" else "float64")


# the Euler system structs of csrc/euler2d_aos.cuh, by their wave count,
# and the other systems of step2_aos.cu with a design of their own
STEP2_AOS_EULER = {"4": "euler_4wave_2D", "5": "euler_5wave_2D"}
STEP2_AOS_OWN = {"Psystem2D": "psystem_2D",
                 "VcAdvection2D": "vc_advection_2D"}


def step2_aos_instance(function):
    """(system name, type name, capa, fwave) of the mangled name of an
    instance of ``csrc/step2_aos.cu``'s kernel of a system with a design
    of its own (the Euler systems, psystem_2D, vc_advection_2D), or None
    for another function."""
    m = re.search(r"step2_aos_kernelINS_\d+(?:EulerAoS2DILi([45])EE|"
                  r"(Psystem2D|VcAdvection2D))E([fd])Li\d+ELi\d+ELb([01])"
                  r"ELb([01])E", function)
    if m is None:
        return None
    return (STEP2_AOS_EULER[m.group(1)] if m.group(1)
            else STEP2_AOS_OWN[m.group(2)],
            "float32" if m.group(3) == "f" else "float64",
            m.group(4) == "1", m.group(5) == "1")


def dq2_weno5_instance(function):
    """(system name, type name) of the mangled name of an instance of
    ``csrc/dq2_weno5.cu``'s kernel, or None for another function."""
    m = re.search(r"dq2_weno5_kernelINS_\d+(Euler4|Euler5|Acoustics)E([fd])E",
                  function)
    if m is None:
        return None
    return (DQ_WENO_STRUCTS[m.group(1)],
            "float32" if m.group(2) == "f" else "float64")


# the system structs of csrc/acoustics3d.cuh, by their record's name
STEP3_AOS_STRUCTS = {"VcAcoustics3D": "vc_acoustics_3D",
                     "Acoustics3D": "acoustics_3D",
                     "Advection3D": "advection_3D",
                     "Burgers3D": "burgers_3D"}


def step3_aos_instance(function):
    """(system name, type name, capa, fwave) of the mangled name of an
    instance of ``csrc/step3_aos.cu``'s kernel, or None for another
    function."""
    m = re.search(r"step3_aos_kernelINS_\d+(\w+?3D)E([fd])Lb([01])ELb([01])E",
                  function)
    if m is None or m.group(1) not in STEP3_AOS_STRUCTS:
        return None
    return (STEP3_AOS_STRUCTS[m.group(1)],
            "float32" if m.group(2) == "f" else "float64",
            m.group(3) == "1", m.group(4) == "1")


def run(kernel, variants, sass=False, only=None):
    if not torch.cuda.is_available():
        raise RuntimeError("time_kernels needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}")
    variants = [(label, root, source or SOURCE.get(kernel, kernel), flags)
                for label, root, source, flags in variants]
    sources = {v[0]: v[2] for v in variants}
    libs = _build_variants(variants)
    labels = [v[0] for v in variants]
    result_sass, digests = {}, {}
    if sass:
        for label in labels:
            text = sass_text(libs[label]._name)
            hist = parse_sass(text)
            result_sass[label] = hist
            digests[label] = sass_digests(text)
            for entry, (count, ops) in hist.items():
                print(f"  sass [{label}] {entry[:70]}: {count} "
                      f"instructions; {ops}")
        for label in labels[1:]:
            same, differ = sass_compare(digests[labels[0]], digests[label])
            print(f"  sass [{label}] against [{labels[0]}]: {len(same)} "
                  f"entries equal instruction for instruction, "
                  f"{len(differ)} differ or are in one build only: "
                  f"{differ}")
    order = labels + labels[::-1]
    case = {"step2_ctu": _step2_ctu_call, "dq2_weno5": _dq_call,
            "dq2_weno": _dq_weno_call, "step3_ctu": _step3_ctu_call,
            "step3_aos": _step3_aos_call,
            "step2_aos": _step2_aos_call,
            "euler3d_capa": _euler3d_capa_call,
            "step1": _step1_call, "weno5": _weno5_call}[kernel]
    result = {"kernel": kernel, "card": card, "order": order, "types": {},
              "sass": result_sass}
    for dtype in (torch.float32, torch.float64):
        tname = str(dtype).split(".")[1]
        makes = case(dtype, dev)
        if callable(makes):
            makes = {"": makes}
        for state, make in makes.items():
            key = f"{tname} {state}" if state else tname
            if only and not any(s in key for s in only):
                continue
            result["types"][key] = _time_state(
                kernel, key, make, libs, sources, labels, order)
        del makes
        torch.cuda.empty_cache()
    return result


def _time_state(kernel, key, make, libs, sources, labels, order):
    """Each variant's output against the first one's and its times on one
    timed state.  A build that lacks the state's system (``make`` gives
    None) is left out of it."""
    calls = {label: make(libs[label], sources[label]) for label in labels}
    labels = [label for label in labels if calls[label] is not None]
    order = [label for label in order if calls[label] is not None]
    ref_out, ref_cfl, ref_parts = None, None, None
    per = {}
    for label in labels:
        out, cfl = _outputs(calls[label]())
        if ref_out is None:
            ref_out, ref_cfl = out.clone(), cfl
        diff = float((out - ref_out).abs().max() / ref_out.abs().max())
        per[label] = {"rel_diff_vs_first": diff,
                      "equal": bool(torch.equal(out, ref_out)), "cfl": cfl,
                      "cfl_equal": cfl == ref_cfl, "events_ms": []}
        partials = getattr(calls[label], "partials", None)
        if partials is not None:
            # every block's CFL partial, bit for bit
            parts = partials()
            ref_parts = parts.clone() if ref_parts is None else ref_parts
            per[label]["partials_equal"] = bool(torch.equal(parts,
                                                            ref_parts))
    for label in order:
        per[label]["events_ms"].append(
            events_ms(calls[label], ITERS[kernel], warm=3))
    for label in labels:
        dev_ms, dev_n = device_ms_per_call(
            calls[label], f"{sources[label]}_kernel",
            max(10, ITERS[kernel] // 4))
        per[label]["device_ms"] = dev_ms
        per[label]["device_launches_profiled"] = dev_n
        print(f"  {kernel} {key} [{label}]: events ms "
              f"{per[label]['events_ms']}, device ms {dev_ms} "
              f"({dev_n} launches), rel diff vs {labels[0]} "
              f"{per[label]['rel_diff_vs_first']:.3e}, equal "
              f"{per[label]['equal']}, cfl {per[label]['cfl']!r}"
              + (f", partials equal {per[label]['partials_equal']}"
                 if "partials_equal" in per[label] else ""), flush=True)
    return per


def _parse_variant(text):
    """(label, root, source or None, extra nvcc flags) of
    ``LABEL=ROOT[@SOURCE][:FLAG,...]``."""
    label, rest = text.split("=", 1)
    root, _, flags = rest.partition(":")
    root, _, source = root.partition("@")
    return (label, os.path.abspath(root), source or None,
            [f for f in flags.split(",") if f])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(ITERS))
    ap.add_argument("variants", nargs="+", type=_parse_variant)
    ap.add_argument("--out")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--only", action="append",
                    help="time only the states whose key (type and state) "
                         "holds this text; may be given again")
    args = ap.parse_args(argv)
    result = run(args.kernel, args.variants, args.sass, args.only)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
