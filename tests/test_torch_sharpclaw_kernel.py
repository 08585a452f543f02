"""The CUDA kernels ``csrc/dq2_weno5.cu`` and ``csrc/dq2_weno.cu``,
compiled for the host, against their plain PyTorch version
``sharpclaw/soa.py:dq_2d_soa``: the Euler 4-wave instance (the entries
``dq2_weno5_host_*``), the acoustics instance
(``dq2_weno5_acoustics_host_*``, the plain version with
``acoustics_2D``'s SoA hooks) and the Euler 5-wave instance with its
passive tracer (``dq2_weno5_euler5_host_*``, the plain version with
``euler_5wave_2D``'s SoA hooks); and the same three systems at WENO
orders 7, 9, 11, 15 and 17 (``dq2_weno<order>[_acoustics|_euler5]_host_*``),
the kernel that takes the stencil half-width K as a template parameter,
whose dq and CFL partials are also held bit for bit to its first design's
(``WENO_DIGESTS``).

Without ``__CUDACC__`` the source runs its phases block by block on the
CPU, which checks the kernel's index algebra, 16x16 tiling, ragged-edge
masks, positivity fallback and CFL windows (ghost band included) without
a card.  Tolerances as tests/test_torch_step2.py: 1e-12 (float64) and
1e-5 (float32) relative to max|dq|, and the CFL to the same relative
tolerance.
"""

import ctypes
import hashlib
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
        for order in (7, 9, 11, 15, 17):
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
    the plain version; returns the CFL and the SHA-256 of the emulation's
    dq and CFL partials (bytes)."""
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
    return float(c_p), hashlib.sha256(out.tobytes()
                                      + cfl_blocks.tobytes()).hexdigest()


# The SHA-256 of dq and the CFL partials of csrc/dq2_weno.cu's host
# emulation on the states of test_weno_instances_on_host_match_plain, as
# the first design of the kernel (one thread a cell, both directions'
# buffers at once) computed them: a later design keeps its bits.
WENO_DIGESTS = {
    (7, 19, 37, "acoustics_2D", "float64"):
        "ea4814a4598ee517d8069c4b45a63210848f14d569bda81fa35cc317a4b29be4",
    (7, 19, 37, "acoustics_2D", "float32"):
        "c6d62b3a18e7efc50f9cba5410c308b5fe17dbaef0ff2f1307d575e7520e5c18",
    (7, 19, 37, "euler_4wave_2D", "float64"):
        "6a67cf898caba16dfb0f3199dac86c681d34ada55ebe0e07c0a67b00edcc361e",
    (7, 19, 37, "euler_4wave_2D", "float32"):
        "eabffa34d0a1938fb6343cb8e448948d41f88f3d93807a544899a36b8e90ce36",
    (7, 19, 37, "euler_5wave_2D", "float64"):
        "186f1aae4a8394f869714b134761c138d0bbe7f966f04134d39c7a89d627c314",
    (7, 19, 37, "euler_5wave_2D", "float32"):
        "23a2f9a2ee4ed7a61a0a0b1500910391fef44e29210e946716c6ccad7bc69df4",
    (17, 17, 5, "acoustics_2D", "float64"):
        "81053ab72d8a4fe52f6a6471d63a2c163c87c830628fab33560450e19f238bc6",
    (17, 17, 5, "acoustics_2D", "float32"):
        "b7e707535a81a125496c8e7520fb97aa661517b4d019b42a34977972ae742207",
    (17, 17, 5, "euler_4wave_2D", "float64"):
        "30ef37573604ba8e3637df65a7c0bd0c31fcbeb22face050b841fbc00be101ed",
    (17, 17, 5, "euler_4wave_2D", "float32"):
        "8a0a5663e4c19c9a78b641f585f66c665c885443f5ceacfa8943494b5d117a79",
    (17, 17, 5, "euler_5wave_2D", "float64"):
        "cca40a28bb8905163539cb93d5979557465d70046825b7a2e970efea425a17fa",
    (17, 17, 5, "euler_5wave_2D", "float32"):
        "d86832933cb75bfe3b9cf26d4e60c81968fd96878ea1954947c317e800cbf9c7",
    (11, 13, 11, "acoustics_2D", "float64"):
        "cfc995ecad8897117849d7802a57c1cc837be4445b386e2e5865e5009752b394",
    (11, 13, 11, "acoustics_2D", "float32"):
        "00d8eb7e0ebcb4de2060186630096d0c334affb2e754ce3a936b8300d04acda0",
    (11, 13, 11, "euler_4wave_2D", "float64"):
        "b7dfa579e66eae6ce65939227910556c09411483eeba55333b441ef6979444e8",
    (11, 13, 11, "euler_4wave_2D", "float32"):
        "329b012b6d7c60496e39d03fca99a8852d60cc07f36c8bcd627658815c37084b",
    (11, 13, 11, "euler_5wave_2D", "float64"):
        "a022e8d77c1bc9d468b6447022cfcd20bc0a07d15e1f7457ba550234400accca",
    (11, 13, 11, "euler_5wave_2D", "float32"):
        "75d387c539de5038fa5b28f29c9ab413f0fd58d844a207e5ac6005cac920208f",
    (15, 9, 14, "acoustics_2D", "float64"):
        "f621cda665b95eca8aad2f3ef29710aeff5cdbf42febe502772caa52fc4b3181",
    (15, 9, 14, "acoustics_2D", "float32"):
        "ec167dd6b8dc52babe4f1b22de3daba1ba5e89908fe04b907c665c6df2afd0da",
    (15, 9, 14, "euler_4wave_2D", "float64"):
        "b383ffe7630dadbe7b683452c8e4649d2b1f8d27da99730294cff3c4c7fdf879",
    (15, 9, 14, "euler_4wave_2D", "float32"):
        "b6bfb27687e0030564d84bf450ff878d79b8a31013bf9ba63add7f48821e24d5",
    (15, 9, 14, "euler_5wave_2D", "float64"):
        "093c64c7a8fa0d85462b07ccf12574a57cac94c5103614e3e6360caa1709357b",
    (15, 9, 14, "euler_5wave_2D", "float32"):
        "21589349c9ba36036aab7707036f309a4425e3844b9c94d359d1375c2932837d"}


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("name", sorted(WENO_RPS))
@pytest.mark.parametrize("order,nx,ny", [(7, 19, 37), (17, 17, 5),
                                         (11, 13, 11), (15, 9, 14)])
def test_weno_instances_on_host_match_plain(host_weno_kernel, order, nx, ny,
                                            name, dtype, tol):
    """dq2_weno.cu's instances at orders 7, 11, 15 and 17 (K = 4, 6, 8,
    9), each system, both types, on ragged grids (partial tiles along
    both axes; at 17 x 5 the grid is less than a tile wide; at 13 x 11
    and 9 x 14 one block holds the whole grid, so its ghost bands cover
    both sides in each direction), the Euler states taking the positivity
    fallback; dq and the CFL partials bit for bit those of the kernel's
    first design (WENO_DIGESTS)."""
    k = (order + 1) // 2
    qbc = _weno_state(name, order * nx + ny, nx, ny, k, dtype)
    if name != "acoustics_2D":
        assert tsoa.fallback_count(torch.from_numpy(qbc), PARAMS,
                                   WENO_RPS[name].positivity, order) > 0
    _, digest = _check_weno(host_weno_kernel, name, order, qbc, tol)
    assert digest == WENO_DIGESTS[(order, nx, ny, name,
                                   np.dtype(dtype).name)]


@pytest.mark.parametrize("where", ["x-lo", "x-hi", "y-lo", "y-hi"])
@pytest.mark.parametrize("nx,ny,i0,j0", [(37, 21, 20, 10),
                                         (13, 11, 10, 8)])
def test_weno_instance_cfl_covers_the_ghost_band(host_weno_kernel, where,
                                                 nx, ny, i0, j0):
    """Order 9 (a 5-cell ghost band): a fast state in one ghost band, at
    its outermost line (row i0 of an x-band, column j0 of a y-band), sets
    the CFL; the blocks at the grid's ends must solve those interfaces
    (grid 37 x 21: two tiles per axis; 13 x 11: one block, which holds
    both sides of each direction's band)."""
    k = 5
    qbc = euler_state(9, (nx + 2 * k, ny + 2 * k))
    i, j = {"x-lo": (i0, 0), "x-hi": (i0, ny + 2 * k - 1),
            "y-lo": (0, j0), "y-hi": (nx + 2 * k - 1, j0)}[where]
    normal = 1 if where.startswith("x") else 2      # momentum along the band
    qbc[normal, i, j] = 40.0 * qbc[0, i, j]
    qbc[3, i, j] += 0.5 * qbc[normal, i, j] ** 2 / qbc[0, i, j]
    qbc = np.ascontiguousarray(qbc)
    assert _check_weno(host_weno_kernel, "euler_4wave_2D", 9, qbc,
                       1e-12)[0] > 2.0


def test_weno_instances_shared_memory(host_weno_kernel):
    """Each instance's shared memory: N (16 + 2K)^2 + ND 2N 288 + ND 2N
    272 + 256 N + NT values, with ND = 1 (one direction's buffers at a
    time) or 2 (both directions', float32 only, where four blocks still
    fit the SM's 228 KB, 1 KB reserved a block) and NT the instance's
    threads (a multiple of 32); every float64 instance fits two blocks
    (Euler at K = 9: 42.0 KB float32, 83.1 KB float64; the Euler 5-wave
    system at K = 9 in float64 103.3 KB)."""
    for fn in ("dq2_weno_smem_bytes", "dq2_weno_threads"):
        getattr(host_weno_kernel, fn).argtypes = [ctypes.c_int] * 3
        getattr(host_weno_kernel, fn).restype = ctypes.c_int
    for name, (_, _, sys_id) in tiled2d.DQ_SYSTEMS.items():
        n = WENO_RPS[name].num_eqn
        for order in (7, 9, 11, 13, 15, 17):
            k = (order + 1) // 2
            for is_double, size in ((0, 4), (1, 8)):
                nt = host_weno_kernel.dq2_weno_threads(sys_id, order,
                                                       is_double)
                assert nt % 32 == 0 and 256 <= nt <= 384
                got = host_weno_kernel.dq2_weno_smem_bytes(sys_id, order,
                                                           is_double)
                elems = {nd: n * (16 + 2 * k) ** 2 + nd * 2 * n * 288
                         + nd * 2 * n * 272 + 256 * n + nt
                         for nd in (1, 2)}
                assert got in (elems[1] * size, elems[2] * size)
                if got == elems[2] * size:
                    assert not is_double and 4 * (got + 1024) <= 233472
                assert got <= 233472 // 2 - 1024
    assert host_weno_kernel.dq2_weno_smem_bytes(0, 17, 0) == 42048
    assert host_weno_kernel.dq2_weno_smem_bytes(0, 17, 1) == 83072
    assert host_weno_kernel.dq2_weno_smem_bytes(2, 17, 1) == 103328
    assert host_weno_kernel.dq2_weno_smem_bytes(0, 19, 0) == -1
    assert host_weno_kernel.dq2_weno_threads(0, 19, 0) == -1
