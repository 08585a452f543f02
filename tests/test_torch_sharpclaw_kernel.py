"""The CUDA kernel ``csrc/dq2_weno5.cu``, compiled for the host, against
its plain PyTorch version ``sharpclaw/soa.py:dq_2d_soa``: the Euler
4-wave instance (the entries ``dq2_weno5_host_*``), the acoustics
instance (``dq2_weno5_acoustics_host_*``, the plain version with
``acoustics_2D``'s SoA hooks) and the Euler 5-wave instance with its
passive tracer (``dq2_weno5_euler5_host_*``, the plain version with
``euler_5wave_2D``'s SoA hooks).

Without ``__CUDACC__`` the source runs its phases block by block on the
CPU, which checks the kernel's index algebra, 16x16 tiling, ragged-edge
masks, positivity fallback and CFL windows (ghost band included) without
a card.  Tolerances as tests/test_torch_step2.py: 1e-12 (float64) and
1e-5 (float32) relative to max|dq|, and the CFL to the same relative
tolerance.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from pyclaw_tpu_torch.ops import tiled2d
from pyclaw_tpu_torch.riemann import acoustics as tac
from pyclaw_tpu_torch.riemann import euler as te
from pyclaw_tpu_torch.sharpclaw import soa as tsoa
from test_torch_sharpclaw import euler_state, fallback_cells

PARAMS = {"gamma": 1.4}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    from pyclaw_tpu_torch.ops import _build
    lib = _build.build_host_emulation(
        "dq2_weno5", str(tmp_path_factory.mktemp("dq2_weno5_host")))
    for name, argtypes in (
            ("dq2_weno5_host_f32", tiled2d.DQ_ARGTYPES),
            ("dq2_weno5_host_f64", tiled2d.DQ_ARGTYPES),
            ("dq2_weno5_acoustics_host_f32", tiled2d.DQ_ACOUSTICS_ARGTYPES),
            ("dq2_weno5_acoustics_host_f64", tiled2d.DQ_ACOUSTICS_ARGTYPES),
            ("dq2_weno5_euler5_host_f32", tiled2d.DQ_ARGTYPES),
            ("dq2_weno5_euler5_host_f64", tiled2d.DQ_ARGTYPES)):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dq2_weno5_blocks.argtypes = [ctypes.c_int] * 2
    lib.dq2_weno5_blocks.restype = ctypes.c_int
    return lib


def _host_dq(lib, qbc, dt, dx, dy):
    nxg, nyg = qbc.shape[1:]
    out = np.empty((4, nxg - 6, nyg - 6), qbc.dtype)
    # one CFL partial per 16 x 16 tile, each written
    ntiles = -(-(nxg - 6) // 16) * -(-(nyg - 6) // 16)
    assert lib.dq2_weno5_blocks(nxg, nyg) == ntiles
    cfl_blocks = np.full(ntiles, np.nan, qbc.dtype)
    fn = (lib.dq2_weno5_host_f64 if qbc.dtype == np.float64
          else lib.dq2_weno5_host_f32)
    rc = fn(qbc.ctypes.data, out.ctypes.data, cfl_blocks.ctypes.data, nxg,
            nyg, ctypes.byref(ctypes.c_double(dt)), dx, dy, 0.4)
    assert rc == 0
    assert np.isfinite(cfl_blocks).all()
    return out, cfl_blocks.max()


def _plain_dq(qbc, dt, dx, dy):
    d, c = tsoa.dq_2d_soa(torch.from_numpy(qbc), dt, dx, dy,
                          te._rpn2_euler_soa, PARAMS, 5, 3,
                          positivity=te.euler_4wave_2D.positivity,
                          flux_soa=te._flux_euler_2d_soa)
    return d.numpy(), float(c)


def _check(lib, qbc, tol):
    nx, ny = qbc.shape[1] - 6, qbc.shape[2] - 6
    dt = float(qbc.dtype.type(0.3 / max(nx, ny)))
    out, cfl = _host_dq(lib, qbc, dt, 1.0 / nx, 1.0 / ny)
    d_p, c_p = _plain_dq(qbc, dt, 1.0 / nx, 1.0 / ny)
    assert np.abs(out - d_p).max() / np.abs(d_p).max() <= tol
    assert abs(cfl - c_p) <= tol * c_p
    return c_p


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("nx,ny,fallback", [
    (40, 36, False), (16, 16, False), (5, 9, False), (33, 17, True),
    (17, 50, True)])
def test_kernel_source_on_host_matches_plain(host_kernel, nx, ny, fallback,
                                             dtype, tol):
    """Grids of several tiles, partial tiles, exactly one tile and a
    single partial tile; random states, and states whose WENO edges go
    non-positive so that the fallback runs."""
    qbc = np.ascontiguousarray(
        euler_state(nx * ny, (nx + 6, ny + 6), fallback).astype(dtype))
    if fallback:
        assert fallback_cells(torch.from_numpy(qbc)) > 0
    _check(host_kernel, qbc, tol)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("where", ["x-lo", "x-hi", "y-lo", "y-hi"])
def test_kernel_cfl_covers_the_ghost_band(host_kernel, where, dtype, tol):
    """A fast state only in one ghost band sets the CFL; the blocks at the
    grid's ends must solve those interfaces (grid 37 x 21: two tiles per
    axis, the last partial)."""
    nx, ny = 37, 21
    qbc = euler_state(9, (nx + 6, ny + 6))
    i, j = {"x-lo": (20, 1), "x-hi": (20, ny + 4),
            "y-lo": (1, 10), "y-hi": (nx + 4, 10)}[where]
    normal = 1 if where.startswith("x") else 2      # momentum along the band
    qbc[normal, i, j] = 40.0 * qbc[0, i, j]
    qbc[3, i, j] += 0.5 * qbc[normal, i, j] ** 2 / qbc[0, i, j]
    qbc = np.ascontiguousarray(qbc.astype(dtype))
    # the state elsewhere gives a CFL below 1; the Roe averages with the
    # neighbours still carry about half of the cell's speed 40
    assert _check(host_kernel, qbc, tol) > 2.0


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("nx,ny", [(70, 50), (48, 97), (17, 130)])
def test_kernel_on_many_ragged_tiles(host_kernel, nx, ny, dtype, tol):
    """Grids of 20, 21 and 18 tiles, ragged along x, y or both, on states
    that fall back: every tile writes its CFL partial (the warp maxima
    folded into one), and every cell its dq."""
    qbc = np.ascontiguousarray(
        euler_state(nx + ny, (nx + 6, ny + 6), fallback=True).astype(dtype))
    assert fallback_cells(torch.from_numpy(qbc)) > 0
    _check(host_kernel, qbc, tol)


# acoustics_2D as examples/acoustics_2d.py sets it up: rho = 1, K = 4
ACOUSTICS = {"rho": 1.0, "bulk": 4.0, "zz": 2.0, "cc": 2.0}


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("nx,ny", [(40, 36), (16, 16), (5, 9), (17, 50)])
def test_acoustics_instance_on_host_matches_plain(host_kernel, nx, ny,
                                                  dtype, tol):
    """The acoustics instance: 3 equations, the constant speeds -c, +c,
    no positivity fallback, the waves' zero transverse component skipped
    as the plain version skips its None."""
    rng = np.random.default_rng(nx + 3 * ny)
    qbc = np.ascontiguousarray(
        rng.standard_normal((3, nx + 6, ny + 6)).astype(dtype))
    dt = float(qbc.dtype.type(0.3 / max(nx, ny)))
    dx, dy = 2.0 / nx, 2.0 / ny
    out = np.empty((3, nx, ny), qbc.dtype)
    ntiles = -(-nx // 16) * -(-ny // 16)
    cfl_blocks = np.full(ntiles, np.nan, qbc.dtype)
    fn = (host_kernel.dq2_weno5_acoustics_host_f64 if dtype == np.float64
          else host_kernel.dq2_weno5_acoustics_host_f32)
    rc = fn(qbc.ctypes.data, out.ctypes.data, cfl_blocks.ctypes.data,
            nx + 6, ny + 6, ctypes.byref(ctypes.c_double(dt)), dx, dy,
            *tiled2d.dq_system_params(tac.acoustics_2D, ACOUSTICS))
    assert rc == 0 and np.isfinite(cfl_blocks).all()
    rp = tac.acoustics_2D
    d_p, c_p = tsoa.dq_2d_soa(torch.from_numpy(qbc), dt, dx, dy, rp.rpn_soa,
                              ACOUSTICS, 5, 3, positivity=rp.positivity,
                              flux_soa=rp.flux_soa)
    d_p = d_p.numpy()
    assert np.abs(out - d_p).max() / np.abs(d_p).max() <= tol
    assert abs(cfl_blocks.max() - float(c_p)) <= tol * float(c_p)
    # the same physics scalars reach the wrapper's plain route
    d_w, c_w = tiled2d.dq_rows(torch.from_numpy(qbc), dt, dx, dy, ACOUSTICS,
                               rp=rp)
    assert torch.equal(d_w, torch.from_numpy(d_p)) and float(c_w) == c_p


def tracer_state(seed, shape, fallback=False):
    """:func:`euler_state` with a tracer rho phi, phi in [0, 1), zero
    outside a random half of the cells (the bubble's edge)."""
    rng = np.random.default_rng(seed + 1)
    q = euler_state(seed, shape, fallback)
    phi = rng.random(shape) * (rng.random(shape) < 0.5)
    return np.concatenate([q, (q[0] * phi)[None]])


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("nx,ny,fallback", [
    (40, 36, False), (16, 16, False), (7, 5, False), (33, 17, True),
    (17, 50, True)])
def test_euler5_instance_on_host_matches_plain(host_kernel, nx, ny,
                                               fallback, dtype, tol):
    """The Euler 5-wave instance: the tracer's fifth wave and flux, its
    parts of the waves that carry density, the positivity fallback on rho
    and p (the tracer is not tested), the None components skipped as the
    plain version skips them."""
    rp = te.euler_5wave_2D
    qbc = np.ascontiguousarray(
        tracer_state(nx * ny, (nx + 6, ny + 6), fallback).astype(dtype))
    if fallback:
        assert tsoa.fallback_count(torch.from_numpy(qbc), PARAMS,
                                   rp.positivity) > 0
    dt = float(qbc.dtype.type(0.3 / max(nx, ny)))
    dx, dy = 1.0 / nx, 1.0 / ny
    out = np.empty((5, nx, ny), qbc.dtype)
    cfl_blocks = np.full(host_kernel.dq2_weno5_blocks(nx + 6, ny + 6),
                         np.nan, qbc.dtype)
    fn = (host_kernel.dq2_weno5_euler5_host_f64 if dtype == np.float64
          else host_kernel.dq2_weno5_euler5_host_f32)
    rc = fn(qbc.ctypes.data, out.ctypes.data, cfl_blocks.ctypes.data,
            nx + 6, ny + 6, ctypes.byref(ctypes.c_double(dt)), dx, dy,
            *tiled2d.dq_system_params(rp, PARAMS))
    assert rc == 0 and np.isfinite(cfl_blocks).all()
    d_p, c_p = tsoa.dq_2d_soa(torch.from_numpy(qbc), dt, dx, dy, rp.rpn_soa,
                              PARAMS, 5, 3, positivity=rp.positivity,
                              flux_soa=rp.flux_soa)
    d_p = d_p.numpy()
    assert np.abs(out - d_p).max() / np.abs(d_p).max() <= tol
    # the tracer's row on its own scale
    assert (np.abs(out[4] - d_p[4]).max() / np.abs(d_p[4]).max()
            <= tol)
    assert abs(cfl_blocks.max() - float(c_p)) <= tol * float(c_p)
    # the wrapper's plain route on a CPU tensor is the same plain version
    d_w, c_w = tiled2d.dq_rows(torch.from_numpy(qbc), dt, dx, dy, PARAMS,
                               rp=rp)
    assert torch.equal(d_w, torch.from_numpy(d_p)) and float(c_w) == c_p
