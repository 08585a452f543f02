"""The port's 3D CTU step against the JAX package's.

* ``classic/kernels.py:step3`` of the port (the kernel's plain PyTorch
  version) against the JAX package's ``kernels.step3`` in float64, for
  transverse_waves 0/1/2, order 1/2 and limiters 4 and 10, at 16^3 and a
  ragged 12x10x8: 1e-12 relative to max|q|, the CFL to 1e-12 relative.
  Each JAX reference is jitted once.
* one step against ``ops/tiled2d.py:step3_pallas_xy`` in Pallas interpret
  mode at 16^3 with tile (8, 8), as tests/test_tiled_kernels.py runs it.
* the CUDA kernel's own source, compiled for the host (its phases run
  block by block on the CPU), against the plain version at 9x7x5 and
  17x16x10 in float32 and float64.  Besides a plain state, each of the
  six faces in turn gets a fast state in its inner ghost layer (inside
  the CFL window) and a faster one in its outer layer (outside it), so
  that each of the kernel's CFL windows is pinned from both sides.
* the same source's capacity and f-wave variants (the aux entries)
  against the plain version: a capacity function at transverse_waves 2,
  1 and 0, f-waves without aux and with a capacity function, and two
  faces whose small capacity pins the upwinded CFL window (1e-12 in
  float64, 1e-5 in float32); and the capacity variant at kappa = 1
  against the variant without one.

The states keep every velocity component away from zero (and the sound
speed well above it), so no upwind switch sits on a roundoff tie.  The
plain step gives the same bits on 1 to 8 intra-op threads, and on 8
threads for an input at any storage offset from 1 to 7 elements.

Run as a script (``python tests/test_torch_step3.py --probe N OUTDIR``),
it repeats the plain step in N fresh processes, each after a JAX step as
in the test suite, and prints how far each lies from the first: a probe
for the rare cross-process difference filed in ROADMAP.md Queue 3.
"""

import ctypes
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyclaw_tpu import riemann as jriemann
from pyclaw_tpu.classic import kernels as jk
from pyclaw_tpu_torch.classic import kernels as tk
from pyclaw_tpu_torch.ops import tiled2d
from pyclaw_tpu_torch.riemann import euler as te

PARAMS = {"gamma": 1.4}
RP = te.euler_3D


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _state(seed, nx, ny, nz, dtype=np.float64):
    """Ghost-padded admissible Euler state (5, nx+4, ny+4, nz+4) with
    velocities of fixed sign, |u| in [0.2, 0.6], in all three
    directions."""
    rng = np.random.default_rng(seed)
    n = (nx + 4, ny + 4, nz + 4)
    rho = 0.8 + 0.4 * rng.random(n)
    u = 0.2 + 0.4 * rng.random(n)
    v = -(0.2 + 0.4 * rng.random(n))
    w = 0.2 + 0.4 * rng.random(n)
    p = 0.8 + 0.4 * rng.random(n)
    q = np.stack([rho, rho * u, rho * v, rho * w,
                  p / 0.4 + 0.5 * rho * (u * u + v * v + w * w)])
    return np.ascontiguousarray(q.astype(dtype))


def _plain(q, dt, deltas, lims, order, tw):
    qn, cfl = tk.step3(torch.from_numpy(q), None, dt, *deltas, RP.rp,
                       RP.rpt, RP.rptt, PARAMS, lims, order, False, -1, 2,
                       tw, RP.prefactor)
    return qn.numpy(), float(cfl)


@pytest.mark.parametrize("tw,order,lim,shape", [
    (0, 2, 10, (16, 16, 16)), (1, 1, 10, (16, 16, 16)),
    (1, 2, 4, (16, 16, 16)), (2, 1, 4, (16, 16, 16)),
    (2, 2, 10, (16, 16, 16)), (2, 2, 4, (12, 10, 8))])
def test_plain_step_matches_jax_step3(tw, order, lim, shape):
    q = _state(sum(shape) + 10 * tw + order + lim, *shape)
    deltas = (2.0 / shape[0], 2.0 / shape[1], 2.0 / shape[2])
    dt = 0.15 * min(deltas)
    jrp = jriemann.euler_3D
    step = jax.jit(lambda qj: jk.step3(
        qj, None, dt, *deltas, jrp.rp, jrp.rpt, jrp.rptt, PARAMS, (lim,) * 5,
        order, False, -1, 2, transverse_waves=tw, prefactor=jrp.prefactor))
    q_j, c_j = step(jnp.asarray(q))
    q_j, c_j = np.asarray(q_j), float(c_j)
    q_t, c_t = _plain(q, dt, deltas, (lim,) * 5, order, tw)
    assert q_t.shape == (5,) + shape
    assert np.abs(q_t - q_j).max() / np.abs(q_j).max() <= 1e-12
    assert abs(c_t - c_j) <= 1e-12 * c_j


def test_step_matches_step3_pallas_xy_interpret():
    """One step at 16^3 against the JAX package's (x, y)-tiled Pallas
    kernel in interpret mode, tile (8, 8), full corner transport."""
    from pyclaw_tpu.ops import tiled2d as jtiled
    q = _state(7, 16, 16, 16)
    jrp = jriemann.euler_3D
    q_j, c_j = jtiled.step3_pallas_xy(
        jnp.asarray(q), 1e-2, 0.125, 0.125, 0.125, jrp.rp, jrp.rpt, jrp.rptt,
        PARAMS, (4,) * 5, 2, 2, transverse_waves=2,
        prefactor=jrp.prefactor, tile=(8, 8))
    q_t, c_t = tiled2d.step3_xy(torch.from_numpy(q), 1e-2, 0.125, 0.125,
                                0.125, PARAMS, (4,) * 5, 2)
    q_j = np.asarray(q_j)
    assert np.abs(q_t.numpy() - q_j).max() / np.abs(q_j).max() <= 1e-12
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)


def _crossing_state(seed=0, shape=(16, 14, 12)):
    """Ghost-padded state (5, *shape) whose velocities cross zero
    (normal, sd 0.5); no wave speed comes near zero."""
    rng = np.random.default_rng(seed)
    q = np.ones((5,) + shape)
    q[0] = 1 + 0.5 * rng.random(shape)
    q[1:4] = 0.5 * rng.standard_normal((3,) + shape)
    q[4] = 3 + rng.random(shape)
    return q


CROSSING_ARGS = (1e-2, 0.1, 0.12, 0.09)


def test_plain_step_is_the_same_on_any_thread_count():
    """The plain step gives the same bits with 1 to 8 intra-op threads
    (the work split between threads does not change any sum's order)."""
    q = _crossing_state()
    ref = _plain(q, CROSSING_ARGS[0], CROSSING_ARGS[1:], (4,) * 5, 2, 2)
    for threads in (2, 3, 8):
        torch.set_num_threads(threads)
        q_t, c_t = _plain(q, CROSSING_ARGS[0], CROSSING_ARGS[1:], (4,) * 5,
                          2, 2)
        assert np.array_equal(q_t, ref[0]) and c_t == ref[1]


@pytest.mark.parametrize("offset", range(1, 8))
def test_plain_step_is_the_same_at_any_storage_offset(offset):
    """On 8 intra-op threads, the plain step of an input that sits
    ``offset`` elements into a larger buffer (so every slice of it starts
    at another alignment, and ATen's vectorised bodies and scalar tails
    meet other elements) gives the bits of the aligned input."""
    q = _crossing_state()
    ref = _plain(q, CROSSING_ARGS[0], CROSSING_ARGS[1:], (4,) * 5, 2, 2)
    torch.set_num_threads(8)
    buf = torch.zeros(q.size + 8, dtype=torch.float64)
    buf[offset:offset + q.size] = torch.from_numpy(q).reshape(-1)
    q_off = buf[offset:offset + q.size].view(q.shape)
    assert q_off.storage_offset() == offset
    q_t, c_t = tk.step3(q_off, None, CROSSING_ARGS[0], *CROSSING_ARGS[1:],
                        RP.rp, RP.rpt, RP.rptt, PARAMS, (4,) * 5, 2, False,
                        -1, 2, 2, RP.prefactor)
    assert np.array_equal(q_t.numpy(), ref[0]) and float(c_t) == ref[1]


def test_wrapper_on_cpu_is_the_plain_version():
    q = _state(3, 6, 5, 4)
    before = tiled2d.step3_xy.launches
    q_w, c_w = tiled2d.step3_xy(torch.from_numpy(q), 0.02, 0.2, 0.2, 0.25,
                                PARAMS, (10,) * 5, 2, transverse_waves=1)
    q_p, c_p = _plain(q, 0.02, (0.2, 0.2, 0.25), (10,) * 5, 2, 1)
    assert np.array_equal(q_w.numpy(), q_p) and float(c_w) == c_p
    assert tiled2d.step3_xy.launches == before


@pytest.mark.parametrize("bad", [
    dict(mthlim=(4,) * 4), dict(mthlim=(22,) * 5), dict(order=3),
    dict(transverse_waves=3), dict(num_ghost=3)])
def test_wrapper_rejects_options(bad):
    kw = dict(mthlim=(4,) * 5, order=2, transverse_waves=2, num_ghost=2)
    kw.update(bad)
    with pytest.raises(ValueError):
        tiled2d.step3_xy(torch.zeros(5, 9, 9, 9, dtype=torch.float64), 0.01,
                         0.1, 0.1, 0.1, PARAMS, kw["mthlim"], kw["order"],
                         kw["num_ghost"], kw["transverse_waves"])


def test_plain_step_refuses_what_it_does_not_port():
    """The plain step now takes aux (which Euler does not read), a
    capacity function and the f-wave form, as JAX ``step3`` does, and so
    does the wrapper on the CPU.  Euler with a capacity function has a
    kernel (step3_ctu.cu's capacity variant): what is refused is a tensor
    off the CPU that is not the card's (a meta tensor), before any
    launch."""
    q_np = _state(1, 4, 4, 4)
    q = torch.from_numpy(q_np)
    kappa = 1.0 + 0.5 * np.random.default_rng(1).random((1,) + q_np.shape[1:])
    args = (0.01, 0.1, 0.1, 0.1, RP.rp, RP.rpt, RP.rptt, PARAMS, (4,) * 5, 2)
    jrp = jriemann.euler_3D
    jargs = (0.01, 0.1, 0.1, 0.1, jrp.rp, jrp.rpt, jrp.rptt, PARAMS,
             (4,) * 5, 2)
    base = tk.step3(q, None, *args, False, -1, 2, 2, RP.prefactor)
    with_aux = tk.step3(q, q[:1], *args, False, -1, 2, 2, RP.prefactor)
    assert np.array_equal(with_aux[0].numpy(), base[0].numpy())
    for aux, fwave, capa in ((kappa, False, 0), (None, True, -1)):
        q_t, c_t = tk.step3(q, None if aux is None else torch.from_numpy(aux),
                            *args, fwave, capa, 2, 2, RP.prefactor)
        step = jax.jit(lambda qj, aj, fw=fwave, ca=capa: jk.step3(
            qj, aj, *jargs, fw, ca, 2, transverse_waves=2,
            prefactor=jrp.prefactor))
        q_j, c_j = step(jnp.asarray(q_np),
                        None if aux is None else jnp.asarray(aux))
        q_j = np.asarray(q_j)
        assert np.abs(q_t.numpy() - q_j).max() / np.abs(q_j).max() <= 1e-12
        assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)
        q_w, c_w = tiled2d.step3_xy(
            q, *args[:4], PARAMS, (4,) * 5, 2, auxbc=None if aux is None
            else torch.from_numpy(aux), index_capa=capa, fwave=fwave)
        assert np.array_equal(q_w.numpy(), q_t.numpy())
        assert float(c_w) == float(c_t)
    with pytest.raises(ValueError, match="device"):
        tiled2d.step3_xy(q.to("meta"), *args[:4], PARAMS, (4,) * 5, 2,
                         auxbc=torch.from_numpy(kappa).to("meta"),
                         index_capa=0)


# ---- the kernel's source on the host -----------------------------------
@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    from pyclaw_tpu_torch.ops import _build
    lib = _build.build_host_emulation(
        "step3_ctu", str(tmp_path_factory.mktemp("step3_ctu_host")))
    for name in ("step3_ctu_host_f32", "step3_ctu_host_f64"):
        fn = getattr(lib, name)
        fn.argtypes = tiled2d.STEP3_ARGTYPES
        fn.restype = ctypes.c_int
    for name in ("step3_ctu_aux_host_f32", "step3_ctu_aux_host_f64"):
        fn = getattr(lib, name)
        fn.argtypes = tiled2d.STEP3_AUX_ARGTYPES
        fn.restype = ctypes.c_int
    lib.step3_ctu_blocks.argtypes = [ctypes.c_int] * 4
    lib.step3_ctu_blocks.restype = ctypes.c_int
    return lib


def _fast_face(q, axis, side, scale):
    """Put a fast state (velocity 4 scale in every direction) in the inner
    ghost layer of one face and a faster one (8 scale) in its outer
    layer.  The inner layer's interface with the interior lies in the CFL
    window of the sweep along ``axis``; the outer layer's interface, and
    the inner layer seen from the other two sweeps, lie outside it.
    ``scale`` (the axis' cell width over the smallest) makes the face's
    Courant number, not only its speed, the largest."""
    n = q.shape[1 + axis]
    for layer, speed in (((1, 4.0) if side == 0 else (n - 2, 4.0)),
                         ((0, 8.0) if side == 0 else (n - 1, 8.0))):
        idx = [slice(None)] * 4
        idx[1 + axis] = layer
        rho = q[tuple([0] + idx[1:])]
        for c in (1, 2, 3):
            q[tuple([c] + idx[1:])] = rho * speed * scale
        q[tuple([4] + idx[1:])] = (1.0 / 0.4
                                   + 1.5 * rho * (speed * scale) ** 2)
    return q


FACES = [None] + [(a, s) for a in range(3) for s in (0, 1)]


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
# (5, 4, 3) is smaller than one tile (8^3 in f32, 6^3 in f64), (13, 11,
# 10) ragged on every axis against either
@pytest.mark.parametrize("shape", [(9, 7, 5), (17, 16, 10), (5, 4, 3),
                                   (13, 11, 10)])
@pytest.mark.parametrize("face", range(len(FACES)))
def test_kernel_source_on_host_matches_plain(host_kernel, face, shape,
                                             dtype, tol):
    """csrc/step3_ctu.cu's phases (tiles, halos, ragged-edge masks, the
    gathers of the rpt3/rptt3 parts, the CFL windows) against the plain
    version; the grids cover several tiles and partial tiles."""
    tw, order, lim = [(2, 2, 4), (1, 2, 10), (0, 1, 3), (2, 1, 4),
                      (2, 2, 10), (1, 1, 4), (0, 2, 4)][face]
    q = _state(face + sum(shape), *shape).astype(np.float64)
    deltas = (2.0 / shape[0], 2.0 / shape[1], 2.0 / shape[2])
    if FACES[face] is not None:
        axis = FACES[face][0]
        q = _fast_face(q, *FACES[face], deltas[axis] / min(deltas))
    q = np.ascontiguousarray(q.astype(dtype))
    dt = float(dtype(0.1 * min(deltas)))
    is_double = dtype == np.float64
    fn = (host_kernel.step3_ctu_host_f64 if is_double
          else host_kernel.step3_ctu_host_f32)
    out = np.empty((5,) + shape, dtype)
    nxg, nyg, nzg = (n + 4 for n in shape)
    cfl_blocks = np.empty(host_kernel.step3_ctu_blocks(nxg, nyg, nzg,
                                                       int(is_double)), dtype)
    rc = fn(q.ctypes.data, out.ctypes.data, cfl_blocks.ctypes.data, nxg, nyg,
            nzg, ctypes.byref(ctypes.c_double(dt)), *deltas, 0.4, order, tw,
            *(lim,) * 5)
    assert rc == 0
    q_p, c_p = _plain(q, dt, deltas, (lim,) * 5, order, tw)
    assert np.abs(out - q_p).max() / np.abs(q_p).max() <= tol
    assert abs(cfl_blocks.max() - c_p) <= tol * c_p
    if FACES[face] is not None:
        # the fast inner layer sets the CFL: its window is the one pinned
        assert c_p > 1.2 * _plain(_state(face + sum(shape), *shape)
                                  .astype(dtype), dt, deltas, (lim,) * 5,
                                  order, tw)[1]


# the capacity and f-wave variants (the aux entries): (index_capa,
# transverse_waves, order, limiter, fwave, face); a face case puts a small
# capacity in the inner ghost layer of one face (inside the CFL window)
# and a smaller one in its outer layer (outside it)
EULER_HOST_CASES = [(0, 2, 2, 4, False, None),
                    (0, 1, 2, 3, False, None),
                    (0, 0, 1, 4, False, None),
                    (-1, 2, 2, 4, True, None),
                    (0, 2, 2, 10, True, None),
                    (0, 2, 2, 4, False, (0, 1)),
                    (0, 1, 2, 4, True, (2, 0))]


def _euler_random_state(rng, n):
    """An admissible state with velocities of both signs in all three
    directions."""
    q = np.empty((5,) + n)
    q[0] = 1.0 + 0.3 * rng.random(n)
    q[1:4] = q[0] * 0.4 * (2.0 * rng.random((3,) + n) - 1.0)
    q[4] = (1.0 + rng.random(n)) / 0.4 + 0.5 * (q[1:4] ** 2).sum(0) / q[0]
    return q


def _small_capacity_face(kappa, axis, side, scale):
    """kappa 1 / (4 scale) in the inner ghost layer of one face, 1 / (8
    scale) in its outer layer: the largest Courant numbers, inside and
    outside the window of the sweep along ``axis``."""
    n = kappa.shape[1 + axis]
    for layer, k in (((1, 4.0) if side == 0 else (n - 2, 4.0)),
                     ((0, 8.0) if side == 0 else (n - 1, 8.0))):
        idx = [slice(None)] * 3
        idx[axis] = layer
        kappa[(0,) + tuple(idx)] = 1.0 / (k * scale)
    return kappa


def _aux_host_step(lib, q, aux, capa, fwave, dt, d, order, tw, lim):
    """One step of the aux entry of the host emulation: (q, cfl)."""
    shape = tuple(n - 4 for n in q.shape[1:])
    is_double = q.dtype == np.float64
    fn = (lib.step3_ctu_aux_host_f64 if is_double
          else lib.step3_ctu_aux_host_f32)
    out = np.empty((5,) + shape, q.dtype)
    # one CFL partial per block, each written
    cfl_blocks = np.full(lib.step3_ctu_blocks(*q.shape[1:], int(is_double)),
                         np.nan, q.dtype)
    rc = fn(q.ctypes.data, None if aux is None else aux.ctypes.data,
            out.ctypes.data, cfl_blocks.ctypes.data, *q.shape[1:], capa,
            int(fwave), ctypes.byref(ctypes.c_double(dt)), *d, 0.4, order,
            tw, *(lim,) * 5)
    assert rc == 0 and np.isfinite(cfl_blocks).all()
    return out, float(cfl_blocks.max())


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("shape", [(9, 7, 10), (17, 13, 9), (3, 5, 2)])
@pytest.mark.parametrize("case", range(len(EULER_HOST_CASES)))
def test_euler_source_on_host_matches_plain(host_kernel, case, shape, dtype,
                                            tol):
    """csrc/step3_ctu.cu's capacity and f-wave variants in the kernel's
    phases against the plain version: with a capacity function at
    transverse_waves 2 (MC), 1 (van Leer) and 0 (first order), f-waves
    without aux and with a capacity function, and two faces whose small
    capacity pins the CFL window; grids that cover several tiles and
    partial tiles, one ragged on every axis and one smaller than a tile,
    in both types' tiles (8^3 in float32, 6^3 in float64)."""
    capa, tw, order, lim, fwave, face = EULER_HOST_CASES[case]
    rng = np.random.default_rng(100 + case + sum(shape))
    n = tuple(s + 4 for s in shape)
    q = _euler_random_state(rng, n)
    kappa = 0.7 + 0.6 * rng.random((1,) + n)
    kappa0 = kappa.copy()
    d = (2.0 / shape[0], 2.2 / shape[1], 1.8 / shape[2])
    if face is not None:
        kappa = _small_capacity_face(kappa, *face, d[face[0]] / min(d))
    q, kappa, kappa0 = (np.ascontiguousarray(a.astype(dtype))
                        for a in (q, kappa, kappa0))
    aux = kappa if capa >= 0 else None
    dt = float(dtype(0.05 * min(d)))
    out, c_k = _aux_host_step(host_kernel, q, aux, capa, fwave, dt, d, order,
                              tw, lim)

    def plain(aux_np):
        qp, cp = tk.step3(torch.from_numpy(q), None if aux_np is None
                          else torch.from_numpy(aux_np), dt, *d, RP.rp,
                          RP.rpt, RP.rptt, PARAMS, (lim,) * 5, order, fwave,
                          capa, 2, tw, RP.prefactor)
        return qp.numpy(), float(cp)

    q_p, c_p = plain(aux)
    assert np.abs(out - q_p).max() / np.abs(q_p).max() <= tol
    assert abs(c_k - c_p) <= tol * c_p
    if face is not None:
        # the small capacity of the inner layer sets the CFL
        assert c_p > 1.2 * plain(kappa0)[1]


# float32: the capacity variant's dt/(dD kappa) is dt and dD rounded to
# float32, then divided in float32; the variant without one rounds the
# double dt/dD once (an ulp apart)
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-6)])
@pytest.mark.parametrize("tw,order,lim", [(2, 2, 4), (1, 2, 10), (0, 1, 3)])
def test_capacity_variant_at_kappa_one_matches_no_capacity(host_kernel, tw,
                                                           order, lim,
                                                           dtype, tol):
    """The capacity variant with kappa = 1 against the variant without a
    capacity function, both the kernel's source on the host, on a ragged
    multi-tile grid with velocities of both signs."""
    shape = (11, 9, 13)
    n = tuple(s + 4 for s in shape)
    q = np.ascontiguousarray(_euler_random_state(
        np.random.default_rng(7 + tw), n).astype(dtype))
    ones = np.ones((2,) + n, dtype)
    d = (2.0 / shape[0], 2.2 / shape[1], 1.8 / shape[2])
    dt = float(dtype(0.1 * min(d)))
    out1, c1 = _aux_host_step(host_kernel, q, ones, 1, False, dt, d, order,
                              tw, lim)
    is_double = dtype == np.float64
    fn = (host_kernel.step3_ctu_host_f64 if is_double
          else host_kernel.step3_ctu_host_f32)
    out0 = np.empty_like(out1)
    cfl0 = np.empty(host_kernel.step3_ctu_blocks(*n, int(is_double)), dtype)
    assert fn(q.ctypes.data, out0.ctypes.data, cfl0.ctypes.data, *n,
              ctypes.byref(ctypes.c_double(dt)), *d, 0.4, order, tw,
              *(lim,) * 5) == 0
    assert np.abs(out1 - out0).max() / np.abs(out0).max() <= tol
    assert abs(c1 - float(cfl0.max())) <= tol * float(cfl0.max())


# ---- run as a script: the plain step in fresh processes ------------------
def _probe_child(path):
    """One process as the test suite has it: JAX's step first (8 host
    devices, float64), then the plain step on all intra-op threads."""
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_platforms", "cpu")
    q = _crossing_state()
    jrp = jriemann.euler_3D
    jk.step3(jnp.asarray(q), None, *CROSSING_ARGS, jrp.rp, jrp.rpt, jrp.rptt,
             PARAMS, (4,) * 5, 2, False, -1, 2, transverse_waves=2,
             prefactor=jrp.prefactor)
    np.save(path, _plain(q, CROSSING_ARGS[0], CROSSING_ARGS[1:], (4,) * 5,
                         2, 2)[0])


def _probe(n, outdir, at_once=5):
    """Run ``n`` fresh processes, ``at_once`` at a time, and print how far
    each one's plain step lies from the first one's (relative to max|q|)
    and the cells that moved by more than 1e-15 of it."""
    import os
    import subprocess
    import sys
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    paths = [os.path.join(outdir, f"probe_{i}.npy") for i in range(n)]
    for start in range(0, n, at_once):
        procs = [subprocess.Popen([sys.executable, __file__, "--child", p],
                                  env=env)
                 for p in paths[start:start + at_once]]
        for p in procs:
            p.wait()
    ref = np.load(paths[0])
    scale = np.abs(ref).max()
    for i, p in enumerate(paths):
        d = np.abs(np.load(p) - ref)
        cells = np.flatnonzero(d.max(0).ravel() > 1e-15 * scale)
        where = f", cells {cells.min()}..{cells.max()}" if len(cells) else ""
        print(f"process {i}: {d.max() / scale:.3e}, {len(cells)} cells{where}")


if __name__ == "__main__":
    # python tests/test_torch_step3.py --probe N OUTDIR
    import sys
    if sys.argv[1] == "--child":
        _probe_child(sys.argv[2])
    else:
        _probe(int(sys.argv[2]), sys.argv[3])
