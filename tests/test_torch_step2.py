"""The port's 2D CTU step against the JAX package's.

* ``classic/soa.py:step2_soa`` of the port (the kernel's plain PyTorch
  version) against the JAX package's ``step2_soa``, float64, for
  transverse_waves 0/1/2, order 1/2 and limiters {3, 4, 10}: 1e-12
  relative to max|q|, CFL to 1e-12.
* the port's solver step against ``ops/tiled2d.py:step2_pallas_rows`` in
  Pallas interpret mode at 64x128, as tests/test_pallas_backend.py runs it.
* the CUDA kernel's own source, compiled for the host (its phases run
  block by block on the CPU), against the plain version: this checks the
  kernel's index algebra, tiling and edge masks without a card.
"""

import ctypes
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyclaw_tpu.classic import soa as jsoa
from pyclaw_tpu.riemann import euler as je
from pyclaw_tpu_torch.classic import soa as tsoa
from pyclaw_tpu_torch.ops import tiled2d
from pyclaw_tpu_torch.riemann import euler as te

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

PARAMS = {"gamma": 1.4}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _state(seed, nx, ny):
    """Ghost-padded random admissible Euler state (4, nx+4, ny+4)."""
    rng = np.random.default_rng(seed)
    n = (nx + 4, ny + 4)
    rho = 0.5 + rng.random(n)
    u, v = 0.5 * rng.standard_normal(n), 0.5 * rng.standard_normal(n)
    p = 0.5 + rng.random(n)
    return np.stack([rho, rho * u, rho * v,
                     p / 0.4 + 0.5 * rho * (u * u + v * v)])


def _jax_step(q, dt, dx, dy, ml, order, tw):
    qn, cfl = jsoa.step2_soa(jnp.asarray(q), dt, dx, dy,
                             je._rpn2_euler_4wave_soa, je._rpt2_euler_soa,
                             PARAMS, ml, order, 2, tw,
                             je._prefactor_euler_2d_soa)
    return np.asarray(qn), float(cfl)


def _plain_step(q, dt, dx, dy, ml, order, tw):
    qn, cfl = tsoa.step2_soa(torch.from_numpy(q), dt, dx, dy,
                             te._rpn2_euler_soa, te._rpt2_euler_soa, PARAMS,
                             ml, order, 2, tw, te._prefactor_euler_2d_soa)
    return qn.numpy(), float(cfl)


@pytest.mark.parametrize("lim", [3, 4, 10])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("tw", [0, 1, 2])
def test_plain_step_matches_jax_step2_soa(tw, order, lim):
    nx, ny = 14, 11
    q = _state(100 * tw + 10 * order + lim, nx, ny)
    args = (0.02, 1.0 / nx, 1.0 / ny, (lim,) * 4, order, tw)
    q_j, c_j = _jax_step(q, *args)
    q_t, c_t = _plain_step(q, *args)
    assert q_t.shape == (4, nx, ny)
    assert np.abs(q_t - q_j).max() / np.abs(q_j).max() <= 1e-12
    assert abs(c_t - c_j) <= 1e-12 * c_j


def test_wrapper_on_cpu_is_the_plain_version():
    """On a CPU tensor step2_rows computes step2_soa and counts nothing."""
    q = _state(7, 9, 6)
    before = tiled2d.step2_rows.launches
    q_w, c_w = tiled2d.step2_rows(torch.from_numpy(q), 0.02, 1 / 9, 1 / 6,
                                  PARAMS, (3,) * 4, 2)
    q_p, c_p = _plain_step(q, 0.02, 1 / 9, 1 / 6, (3,) * 4, 2, 2)
    assert np.array_equal(q_w.numpy(), q_p) and float(c_w) == c_p
    assert tiled2d.step2_rows.launches == before


@pytest.mark.parametrize("bad", [
    dict(mthlim=(3, 3, 3)), dict(mthlim=(22,) * 4), dict(order=3),
    dict(transverse_waves=3)])
def test_wrapper_rejects_options(bad):
    kw = dict(mthlim=(3,) * 4, order=2, transverse_waves=2)
    kw.update(bad)
    with pytest.raises(ValueError):
        tiled2d.step2_rows(torch.zeros(4, 9, 9, dtype=torch.float64), 0.01,
                           0.1, 0.1, PARAMS, kw["mthlim"], kw["order"],
                           transverse_waves=kw["transverse_waves"])


def test_step_matches_step2_pallas_rows_interpret():
    """One fixed-dt step of the quadrants setup at 64x128 against the JAX
    package's row-tiled Pallas kernel in interpret mode."""
    import euler_2d_quadrants as jex
    from pyclaw_tpu_torch.examples import euler_2d_quadrants as tex
    jclaw = jex.setup(solver_type="classic", kernel_language="pallas",
                      outdir=None, mx=64, my=128)
    jclaw.solver.setup(jclaw.solution)
    q_j, c_j = jclaw.solver._step_fn(jnp.asarray(jclaw.solution.state.q),
                                     None, 1e-4, 0.0)
    tclaw = tex.setup(outdir=None, mx=64, my=128, device="cpu")
    tclaw.solver.setup(tclaw.solution)
    q_t, c_t = tclaw.solver._step_fn(
        torch.from_numpy(tclaw.solution.state.q), None, 1e-4, 0.0)
    q_j = np.asarray(q_j)
    assert np.abs(q_t.numpy() - q_j).max() / np.abs(q_j).max() <= 1e-12
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    from pyclaw_tpu_torch.ops import _build
    lib = _build.build_host_emulation(
        "step2_ctu", str(tmp_path_factory.mktemp("step2_ctu_host")))
    for name in ("step2_ctu_host_f32", "step2_ctu_host_f64"):
        fn = getattr(lib, name)
        fn.argtypes = tiled2d.STEP2_ARGTYPES
        fn.restype = ctypes.c_int
    lib.step2_ctu_blocks.argtypes = [ctypes.c_int] * 3
    lib.step2_ctu_blocks.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("nx,ny,order,tw,lim", [
    (24, 20, 2, 2, 3), (13, 37, 2, 1, 4), (17, 9, 1, 2, 10),
    (8, 16, 2, 0, 3), (33, 5, 2, 2, 10),
    # smaller than one tile (12x16 in f32, 10x16 in f64); ragged on both
    # axes against either tile
    (7, 11, 2, 2, 3), (29, 37, 2, 2, 4), (23, 18, 2, 1, 10)])
def test_kernel_source_on_host_matches_plain(host_kernel, nx, ny, order,
                                             tw, lim, dtype, tol):
    """csrc/step2_ctu.cu's phases (tiles, halos, ragged-edge masks, the
    rpt2 gathers of both directions, the CFL windows) against the plain
    version; the grids cover several tiles, partial tiles and a single
    partial tile."""
    q = np.ascontiguousarray(_state(nx * ny + lim, nx, ny).astype(dtype))
    dt = float(dtype(0.2 / max(nx, ny)))
    is_double = dtype == np.float64
    fn = (host_kernel.step2_ctu_host_f64 if is_double
          else host_kernel.step2_ctu_host_f32)
    out = np.empty((4, nx, ny), dtype)
    cfl_blocks = np.empty(host_kernel.step2_ctu_blocks(nx + 4, ny + 4,
                                                       int(is_double)), dtype)
    rc = fn(q.ctypes.data, out.ctypes.data, cfl_blocks.ctypes.data, nx + 4,
            ny + 4, ctypes.byref(ctypes.c_double(dt)), 1.0 / nx, 1.0 / ny,
            0.4, order, tw, lim, lim, lim, lim)
    assert rc == 0
    q_p, c_p = _plain_step(q, dt, 1.0 / nx, 1.0 / ny, (lim,) * 4, order, tw)
    assert np.abs(out - q_p).max() / np.abs(q_p).max() <= tol
    assert abs(cfl_blocks.max() - c_p) <= tol * c_p
