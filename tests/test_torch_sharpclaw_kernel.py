"""The CUDA kernels ``csrc/dq2_weno5.cu`` and ``csrc/dq2_weno.cu``,
compiled for the host, against their plain PyTorch version
``sharpclaw/soa.py:dq_2d_soa``: the Euler 4-wave instance (the entries
``dq2_weno5_host_*``), the acoustics instance
(``dq2_weno5_acoustics_host_*``, the plain version with
``acoustics_2D``'s SoA hooks) and the Euler 5-wave instance with its
passive tracer (``dq2_weno5_euler5_host_*``, the plain version with
``euler_5wave_2D``'s SoA hooks); and the same three systems at WENO
orders 7 and 17 (``dq2_weno<order>[_acoustics|_euler5]_host_*``), the
kernel that takes the stencil half-width K as a template parameter.

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


@pytest.fixture(scope="module")
def host_weno_kernel(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    from pyclaw_tpu_torch.ops import _build
    lib = _build.build_host_emulation(
        "dq2_weno", str(tmp_path_factory.mktemp("dq2_weno_host")))
    for name, (_, argtypes, _) in tiled2d.DQ_SYSTEMS.items():
        for order in (7, 9, 17):
            for suffix in ("_host_f32", "_host_f64"):
                fn = getattr(lib, tiled2d.dq_weno_entry(name, order) + suffix)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
    lib.dq2_weno_blocks.argtypes = [ctypes.c_int] * 3
    lib.dq2_weno_blocks.restype = ctypes.c_int
    lib.dq2_weno_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.dq2_weno_smem_bytes.restype = ctypes.c_int
    return lib


WENO_RPS = {"euler_4wave_2D": te.euler_4wave_2D,
            "euler_5wave_2D": te.euler_5wave_2D,
            "acoustics_2D": tac.acoustics_2D}


def _weno_state(name, seed, nx, ny, k, dtype):
    if name == "acoustics_2D":
        q = np.random.default_rng(seed).standard_normal(
            (3, nx + 2 * k, ny + 2 * k))
    elif name == "euler_5wave_2D":
        q = tracer_state(seed, (nx + 2 * k, ny + 2 * k), fallback=True)
    else:
        q = euler_state(seed, (nx + 2 * k, ny + 2 * k), fallback=True)
    return np.ascontiguousarray(q.astype(dtype))


def _check_weno(lib, name, order, qbc, tol):
    """The host emulation of ``name``'s instance at ``order`` against
    the plain version: (relative max error of dq, the CFL of both)."""
    rp = WENO_RPS[name]
    params = ACOUSTICS if name == "acoustics_2D" else PARAMS
    k = (order + 1) // 2
    neq, nxg, nyg = qbc.shape
    nx, ny = nxg - 2 * k, nyg - 2 * k
    dt = float(qbc.dtype.type(0.3 / max(nx, ny)))
    out = np.empty((neq, nx, ny), qbc.dtype)
    # one CFL partial per 16 x 16 tile, each written
    ntiles = -(-nx // 16) * -(-ny // 16)
    assert lib.dq2_weno_blocks(nxg, nyg, order) == ntiles
    cfl_blocks = np.full(ntiles, np.nan, qbc.dtype)
    fn = getattr(lib, tiled2d.dq_weno_entry(name, order) + (
        "_host_f64" if qbc.dtype == np.float64 else "_host_f32"))
    rc = fn(qbc.ctypes.data, out.ctypes.data, cfl_blocks.ctypes.data, nxg,
            nyg, ctypes.byref(ctypes.c_double(dt)), 1.0 / nx, 1.0 / ny,
            *tiled2d.dq_system_params(rp, params))
    assert rc == 0 and np.isfinite(cfl_blocks).all()
    d_p, c_p = tiled2d.dq_rows(torch.from_numpy(qbc), dt, 1.0 / nx,
                               1.0 / ny, params, order, k, rp=rp)
    d_p = d_p.numpy()
    assert np.abs(out - d_p).max() / np.abs(d_p).max() <= tol
    assert abs(cfl_blocks.max() - float(c_p)) <= tol * float(c_p)
    return float(c_p)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("name", sorted(WENO_RPS))
@pytest.mark.parametrize("order,nx,ny", [(7, 19, 37), (17, 17, 5)])
def test_weno_instances_on_host_match_plain(host_weno_kernel, order, nx, ny,
                                            name, dtype, tol):
    """dq2_weno.cu's instances at orders 7 and 17 (K = 4, 9), each system,
    both types, on ragged grids (partial tiles along both axes; at 17 x 5
    the grid is less than a tile wide), the Euler states taking the
    positivity fallback."""
    k = (order + 1) // 2
    qbc = _weno_state(name, order * nx + ny, nx, ny, k, dtype)
    if name != "acoustics_2D":
        assert tsoa.fallback_count(torch.from_numpy(qbc), PARAMS,
                                   WENO_RPS[name].positivity, order) > 0
    _check_weno(host_weno_kernel, name, order, qbc, tol)


@pytest.mark.parametrize("where", ["x-lo", "x-hi", "y-lo", "y-hi"])
def test_weno_instance_cfl_covers_the_ghost_band(host_weno_kernel, where):
    """Order 9 (a 5-cell ghost band): a fast state in one ghost band, at
    its outermost line, sets the CFL; the blocks at the grid's ends must
    solve those interfaces (grid 37 x 21: two tiles per axis)."""
    nx, ny, k = 37, 21, 5
    qbc = euler_state(9, (nx + 2 * k, ny + 2 * k))
    i, j = {"x-lo": (20, 0), "x-hi": (20, ny + 2 * k - 1),
            "y-lo": (0, 10), "y-hi": (nx + 2 * k - 1, 10)}[where]
    normal = 1 if where.startswith("x") else 2      # momentum along the band
    qbc[normal, i, j] = 40.0 * qbc[0, i, j]
    qbc[3, i, j] += 0.5 * qbc[normal, i, j] ** 2 / qbc[0, i, j]
    qbc = np.ascontiguousarray(qbc)
    assert _check_weno(host_weno_kernel, "euler_4wave_2D", 9, qbc,
                       1e-12) > 2.0


def test_weno_instances_shared_memory(host_weno_kernel):
    """Each instance's shared memory: N (16 + 2K)^2 + 4N 288 + 4N 272 +
    256 N + 288 values (Euler at K = 9: 59.6 KB float32, 119 KB float64;
    the Euler 5-wave system at K = 9 in float64 148 KB), within the card's
    227 KB a block."""
    for name, (_, _, sys_id) in tiled2d.DQ_SYSTEMS.items():
        n = WENO_RPS[name].num_eqn
        for order in (7, 9, 11, 13, 15, 17):
            k = (order + 1) // 2
            elems = n * (16 + 2 * k) ** 2 + 4 * n * 288 + 4 * n * 272 \
                + 256 * n + 288
            for is_double, size in ((0, 4), (1, 8)):
                got = host_weno_kernel.dq2_weno_smem_bytes(sys_id, order,
                                                           is_double)
                assert got == elems * size <= 232448
    assert host_weno_kernel.dq2_weno_smem_bytes(0, 17, 0) == 59584
    assert host_weno_kernel.dq2_weno_smem_bytes(2, 17, 1) == 148384
    assert host_weno_kernel.dq2_weno_smem_bytes(0, 19, 0) == -1
