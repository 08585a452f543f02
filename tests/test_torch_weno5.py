"""The port's WENO5 reconstruction against the JAX package's.

* ``limiters/recon.py:weno5`` of the port (the plain version of
  ``csrc/weno5.cu``) against ``pyclaw_tpu/limiters/recon.py:weno5``: float64
  to 1e-13, float32 to 1e-5 of the largest magnitude (the wrapped band
  included);
* against the JAX package's Pallas kernel ``weno5_pallas`` in interpret
  mode, float64 to 1e-13.  In float32 the port follows ``recon.weno5``'s
  normalised-beta weights: ``weno5_pallas`` gives NaN on constant float32
  data, the port does not;
* the CUDA kernel's own source, compiled for the host (its phases run
  block by block on the CPU), against the plain version: rows of one
  entry up to rows that span several blocks, float32 and float64, on
  both of its tiles (256 entries, one a thread; 1024, four a thread in a
  sliding window), with rows ending inside a thread's window and across
  the tiles' edges; every entry written, the wrapped band included.
"""

import ctypes
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyclaw_tpu.limiters import recon as jrecon
from pyclaw_tpu_torch.limiters import recon
from pyclaw_tpu_torch.ops import weno

TOL = {np.float64: 1e-13, np.float32: 1e-5}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _q(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    return np.ascontiguousarray(rng.standard_normal(shape).astype(dtype))


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", [(3, 40), (2, 5, 37)])
def test_plain_weno5_matches_jax(shape, dtype):
    q = _q(shape, 1, dtype)
    ql_t, qr_t = recon.weno5(torch.from_numpy(q))
    ql_j, qr_j = jrecon.weno5(jnp.asarray(q))
    _close(ql_t.numpy(), ql_j, TOL[dtype])
    _close(qr_t.numpy(), qr_j, TOL[dtype])


def test_plain_weno5_matches_weno5_pallas():
    from pyclaw_tpu.ops import weno5_pallas
    q = _q((3, 4, 64), 11, np.float64)
    ql_t, qr_t = recon.weno5(torch.from_numpy(q))
    ql_j, qr_j = weno5_pallas(jnp.asarray(q))
    _close(ql_t.numpy(), ql_j, 1e-13)
    _close(qr_t.numpy(), qr_j, 1e-13)


def test_constant_float32_stays_finite():
    """recon.py's float32 weights; weno5_pallas's float64 formula gives
    NaN here (ROADMAP.md, Queue 3: the JAX-side baselines)."""
    from pyclaw_tpu.ops import weno5_pallas
    q = np.full((3, 1, 32), 2.5, np.float32)
    ql, qr = recon.weno5(torch.from_numpy(q))
    assert torch.isfinite(ql).all() and torch.isfinite(qr).all()
    np.testing.assert_allclose(ql.numpy(), 2.5, rtol=1e-6)
    ql_j, _ = weno5_pallas(jnp.asarray(q))
    assert np.isnan(np.asarray(ql_j)).any()


def test_wrapper_on_cpu_is_the_plain_version():
    q = torch.from_numpy(_q((3, 30), 2, np.float64))
    before = weno.weno5.launches
    ql_w, qr_w = weno.weno5(q)
    ql_p, qr_p = recon.weno5(q)
    assert torch.equal(ql_w, ql_p) and torch.equal(qr_w, qr_p)
    assert weno.weno5.launches == before


# ---- the kernel's source on the host ---------------------------------------
@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    from pyclaw_tpu_torch.ops import _build
    lib = _build.build_host_emulation(
        "weno5", str(tmp_path_factory.mktemp("weno5_host")))
    for name in ("weno5_host_f32", "weno5_host_f64"):
        fn = getattr(lib, name)
        fn.argtypes = weno.WENO5_ARGTYPES
        fn.restype = ctypes.c_int
    lib.weno5_tile.argtypes = [ctypes.c_int] * 3
    lib.weno5_tile.restype = ctypes.c_int
    return lib


def _host(lib, q):
    """The kernel's edge values of q, into outputs filled with NaN."""
    fn = lib.weno5_host_f64 if q.dtype == np.float64 else lib.weno5_host_f32
    ql, qr = np.full_like(q, np.nan), np.full_like(q, np.nan)
    n = q.shape[-1]
    assert fn(q.ctypes.data, ql.ctypes.data, qr.ctypes.data, q.size // n,
              n) == 0
    return ql, qr


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (1, 5), (3, 206),
                                   (2, 600), (4, 7, 131)])
def test_kernel_source_on_host_matches_plain(host_kernel, shape, dtype):
    """csrc/weno5.cu's phases (the tiles along a row, the wrapped halo at
    both ends, the row walk) against the plain version, every entry."""
    q = _q(shape, sum(shape), dtype)
    ql_k, qr_k = _host(host_kernel, q)
    ql_p, qr_p = recon.weno5(torch.from_numpy(q))
    # float32: the kernel divides 1e3 by the betas' sum where PyTorch
    # multiplies by its reciprocal; one rounding apart
    tol = 1e-15 if dtype == np.float64 else 1e-6
    _close(ql_k, ql_p.numpy(), tol)
    _close(qr_k, qr_p.numpy(), tol)


def test_kernel_source_on_host_constant_float32(host_kernel):
    q = np.full((3, 806), 2.5, np.float32)
    ql, qr = _host(host_kernel, q)
    assert np.isfinite(ql).all() and np.isfinite(qr).all()
    np.testing.assert_allclose(ql, 2.5, rtol=1e-6)


# the edges of the two tiles (csrc/weno5.cu: weno5_tile): the small one
# (128 entries, one a thread) and the large one (1024 entries in f32,
# eight a thread; 512 in f64, four a thread), which takes arrays of at
# least 2^18 entries in rows of at least half a tile.  A row one short
# of, equal to and one past a tile, and two tiles and three entries: n =
# T - 1, T + 1 and 2T + 3 are no multiple of the entries a thread, so a
# row ends inside a thread's window.
SMALL, LARGE = 128, {np.float32: 1024, np.float64: 512}
EDGES = [(-1, 1), (0, 1), (1, 1), (3, 2)]      # n = k T + c


def _edge_shape(tile, c, k):
    n = k * tile + c
    return (2 ** 18 // n + 1 if tile > SMALL else 3, n)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("large", [False, True])
@pytest.mark.parametrize("c,k", EDGES)
def test_kernel_source_on_host_writes_every_entry(host_kernel, c, k, large,
                                                  dtype):
    """Every edge value the kernel writes, on both tiles and across their
    edges, against the plain version at every entry, the wrapped band at
    the two ends of each row included (the outputs start as NaN)."""
    tile = LARGE[dtype] if large else SMALL
    shape = _edge_shape(tile, c, k)
    assert host_kernel.weno5_tile(*shape, int(dtype == np.float64)) == tile
    _check_every_entry(host_kernel, _q(shape, shape[1], dtype))


def _check_every_entry(lib, q):
    ql_k, qr_k = _host(lib, q)
    ql_p, qr_p = recon.weno5(torch.from_numpy(q))
    tol = 1e-15 if q.dtype == np.float64 else 1e-6
    for k, p in ((ql_k, ql_p.numpy()), (qr_k, qr_p.numpy())):
        assert np.isfinite(k).all()
        assert (np.abs(k - p) <= tol * np.abs(p).max()).all()
    return ql_k, qr_k


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kernel_source_on_host_piecewise_constant(host_kernel, dtype):
    """Constant runs between jumps, on the large tile: most stencils have
    three zero betas and take the block's weights of zero betas, the rest
    their own (the outputs start as NaN)."""
    shape = (3, 2 ** 18 + 6)
    assert host_kernel.weno5_tile(*shape, int(dtype == np.float64)) == \
        LARGE[dtype]
    rng = np.random.default_rng(7)
    steps = rng.standard_normal((shape[0], 64))
    q = np.ascontiguousarray(np.repeat(steps, -(-shape[1] // 64), axis=1)
                             [:, :shape[1]].astype(dtype))
    # inside a constant run every stencil is the same: so is each edge
    for k in _check_every_entry(host_kernel, q):
        run = k[:, 100:4000]
        assert (run == run[:, :1]).all()
