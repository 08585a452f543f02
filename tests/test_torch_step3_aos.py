"""The port's generic 3D CTU step (aux, capacity, f-waves) against the JAX
package's, and the CUDA kernel's source on the host.

* ``classic/kernels.py:step3`` of the port (the plain version of
  ``csrc/step3_aos.cu``) against ``pyclaw_tpu/classic/kernels.py:step3``
  and against ``ops/tiled2d.py:step3_pallas_xy`` in Pallas interpret mode
  (tile (8, 8)), in float64, on the JAX package's own cases
  (tests/test_tiled_kernels.py: heterogeneous acoustics with
  transverse_waves=1, Euler with a capacity function and
  transverse_waves=2, advection f-waves with transverse_waves 0 and 2
  through the same ``rp_fwave`` wrapper on both sides), and against JAX
  ``step3`` on each system with and without a capacity function, order 1
  and 2 and a CFL-dependent limiter: 1e-12 relative, the CFL to 1e-12.
* the product-form CTU oracle of tests/test_ctu_exact.py on the port's
  ``ClawSolver3D(advection_3D)``: one first-order step with every
  transverse and double-transverse term equals the exact upwind update
  to 1e-13.
* the CUDA kernel's own source, compiled for the host (its phases run
  block by block on the CPU), against the plain version on multi-tile
  ragged grids in float32 and float64, with a non-uniform capacity row and
  aux in every case; besides a plain state, each of the six faces in turn
  gets a fast state in its inner ghost layer (inside the CFL window) and
  a faster one in its outer layer (outside it).

The same for the ``burgers_3D`` instance (the splits by the receiving
cell's state) on grids less than, equal to and larger than a tile of
each type.  Euler with a capacity function or f-waves runs
``csrc/step3_ctu.cu``; its host test is in tests/test_torch_step3.py.
"""

import ctypes
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu import riemann as jriemann
from pyclaw_tpu.classic import kernels as jk
from pyclaw_tpu_torch import riemann as triemann
from pyclaw_tpu_torch.classic import kernels as tk
from pyclaw_tpu_torch.ops import tiled2d

PARAMS = {"u": 0.7, "v": -0.4, "w": 0.3, "zz": 1.3, "cc": 0.8,
          "gamma": 1.4}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(q_t, c_t, q_j, c_j, tol=1e-12):
    q_j = np.asarray(q_j)
    assert q_t.shape == q_j.shape
    assert np.abs(q_t - q_j).max() / np.abs(q_j).max() <= tol
    assert abs(float(c_t) - float(c_j)) <= tol * float(c_j)


def _plain(rp, rpn, q, aux, dt, d, lims, order, fwave, capa, tw):
    qn, cfl = tk.step3(torch.from_numpy(q), None if aux is None
                       else torch.from_numpy(aux), dt, *d, rpn, rp.rpt,
                       rp.rptt, PARAMS, lims, order, fwave, capa, 2, tw,
                       rp.prefactor)
    return qn.numpy(), float(cfl)


def _euler_state(rng, n):
    q = np.ones((5,) + n)
    q[0] = 1.0 + 0.1 * rng.random(n)
    q[1:4] = 0.1 * rng.random((3,) + n)
    q[4] = 2.5 + 0.1 * rng.random(n)
    return q


# ---- the JAX package's own cases: step3 and step3_pallas_xy (interpret) --
def _jax_step3(q, aux, args, rp, rpn, params, lims, order, fwave, capa, tw):
    """JAX ``step3``, jitted (one compile instead of one per operation)."""
    fn = jax.jit(lambda qj, aj: jk.step3(
        qj, aj, *args, rpn, rp.rpt, rp.rptt, params, lims, order, fwave,
        capa, 2, transverse_waves=tw, prefactor=rp.prefactor))
    return fn(jnp.asarray(q), None if aux is None else jnp.asarray(aux))


def test_heterogeneous_acoustics_matches_jax():
    """tests/test_tiled_kernels.py:317: vc acoustics, transverse_waves=1,
    8x16x6 with its ghost cells, two tiles."""
    from pyclaw_tpu.ops import tiled2d as jtiled
    rng = np.random.default_rng(12)
    n = (12, 20, 10)
    q = 0.1 * rng.random((4,) + n)
    aux = 1.0 + 0.2 * rng.random((2,) + n)
    jrp, rp = jriemann.vc_acoustics_3D, triemann.vc_acoustics_3D
    args = (1e-3, 0.1, 0.1, 0.1)
    q_t, c_t = _plain(rp, rp.rp, q, aux, args[0], args[1:], (1, 1), 2,
                      False, -1, 1)
    q_j, c_j = _jax_step3(q, aux, args, jrp, jrp.rp, {}, (1, 1), 2, False,
                          -1, 1)
    _close(q_t, c_t, q_j, c_j)
    q_p, c_p = jtiled.step3_pallas_xy(
        jnp.asarray(q), *args, jrp.rp, jrp.rpt, None, {}, (1, 1), 2, 2,
        transverse_waves=1, tile=(8, 8), auxbc=jnp.asarray(aux))
    _close(q_t, c_t, q_p, c_p)


def test_euler_with_capacity_matches_jax():
    """tests/test_tiled_kernels.py:370: Euler with a capacity function,
    transverse_waves=2 (rpt3 and rptt3 with the receiving cell's kappa),
    8x8x6 with its ghost cells."""
    from pyclaw_tpu.ops import tiled2d as jtiled
    rng = np.random.default_rng(22)
    n = (12, 12, 10)
    q = _euler_state(rng, n)
    aux = 1.0 + 0.5 * rng.random((1,) + n)
    jrp, rp = jriemann.euler_3D, triemann.euler_3D
    args = (1e-3, 0.1, 0.1, 0.1)
    q_t, c_t = _plain(rp, rp.rp, q, aux, args[0], args[1:], (4,) * 5, 2,
                      False, 0, 2)
    q_j, c_j = _jax_step3(q, aux, args, jrp, jrp.rp, {"gamma": 1.4},
                          (4,) * 5, 2, False, 0, 2)
    _close(q_t, c_t, q_j, c_j)
    q_p, c_p = jtiled.step3_pallas_xy(
        jnp.asarray(q), *args, jrp.rp, jrp.rpt, jrp.rptt, {"gamma": 1.4},
        (4,) * 5, 2, 2, transverse_waves=2, prefactor=jrp.prefactor,
        tile=(8, 8), auxbc=jnp.asarray(aux), index_capa=0)
    _close(q_t, c_t, q_p, c_p)


def _fwave(base, stack):
    def rp_fwave(ixy, q_l, q_r, aux_l, aux_r, params):
        wave, s, amdq, apdq = base.rp(ixy, q_l, q_r, aux_l, aux_r, params)
        return wave * stack(s), s, amdq, apdq
    return rp_fwave


@pytest.mark.parametrize("tw", [0, 2])
def test_advection_fwave_matches_jax(tw):
    """tests/test_tiled_kernels.py:400: advection through the f-wave
    correction form (the same rp_fwave wrapper, W s, on both sides)."""
    from pyclaw_tpu.ops import tiled2d as jtiled
    rng = np.random.default_rng(33)
    n = (12, 12, 10)
    q = rng.random((1,) + n)
    params = {"u": 1.0, "v": 0.5, "w": -0.7}
    jrp, rp = jriemann.advection_3D, triemann.advection_3D
    j_fw = _fwave(jrp, lambda s: jnp.expand_dims(s, 0))
    t_fw = _fwave(rp, lambda s: s[None])
    args = (1e-3, 0.1, 0.1, 0.1)
    qn, c_t = tk.step3(torch.from_numpy(q), None, *args, t_fw, rp.rpt,
                       rp.rptt, params, (4,), 2, True, -1, 2, tw)
    q_t = qn.numpy()
    q_j, c_j = _jax_step3(q, None, args, jrp, j_fw, params, (4,), 2, True,
                          -1, tw)
    _close(q_t, c_t, q_j, c_j)
    q_p, c_p = jtiled.step3_pallas_xy(
        jnp.asarray(q), *args, j_fw, jrp.rpt, jrp.rptt, params, (4,), 2, 2,
        transverse_waves=tw, tile=(8, 8), fwave=True)
    _close(q_t, c_t, q_p, c_p)
    # for constant advection the f-wave is s W: the wave-form result
    w_t, cw_t = tk.step3(torch.from_numpy(q), None, *args, rp.rp, rp.rpt,
                         rp.rptt, params, (4,), 2, False, -1, 2, tw)
    assert np.abs(q_t - w_t.numpy()).max() <= 1e-14
    assert float(cw_t) == float(c_t)


# (system, index_capa, transverse_waves, order, limiter, fwave)
MATRIX = [("vc_acoustics_3D", 2, 1, 2, 10, False),
          ("vc_acoustics_3D", 2, 0, 1, 3, True),
          ("acoustics_3D", 2, 2, 2, 4, False),
          ("acoustics_3D", -1, 1, 1, 10, False),
          ("advection_3D", 2, 2, 2, 10, True)]


def _aux3(rng, n):
    """Non-uniform aux: Z and c in 1 +- 0.2, kappa in 0.7 .. 1.3."""
    return np.concatenate([1.0 + 0.2 * (2.0 * rng.random((2,) + n) - 1.0),
                           0.7 + 0.6 * rng.random((1,) + n)])


@pytest.mark.parametrize("name,capa,tw,order,lim,fwave", MATRIX)
def test_plain_step_matches_jax_step3(name, capa, tw, order, lim, fwave):
    rng = np.random.default_rng(sum(map(ord, name)) + 7 * capa + tw + lim)
    shape = (9, 8, 7)
    n = tuple(s + 4 for s in shape)
    rp, jrp = triemann.ALL[name], getattr(jriemann, name)
    q = rng.standard_normal((rp.num_eqn,) + n)
    aux = _aux3(rng, n)
    d = tuple(2.0 / s for s in shape)
    dt = 0.1 * min(d)
    lims = (lim,) * rp.num_waves
    q_t, c_t = _plain(rp, rp.rp, q, aux, dt, d, lims, order, fwave, capa,
                      tw)
    q_j, c_j = _jax_step3(q, aux, (dt,) + d, jrp, jrp.rp, PARAMS, lims,
                          order, fwave, capa, tw)
    assert q_t.shape == (rp.num_eqn,) + shape
    _close(q_t, c_t, q_j, c_j)


# ---- the product-form CTU oracle (tests/test_ctu_exact.py) ---------------
def _product_form(q, nus):
    out = q.copy()
    for d, nu in enumerate(nus):
        shift = 1 if nu > 0 else -1
        out = (1.0 - abs(nu)) * out + abs(nu) * np.roll(out, shift, axis=d)
    return out


@pytest.mark.parametrize("vels", [(1.0, 0.5, 0.25), (1.0, -0.5, 0.25),
                                  (-0.6, 0.4, -0.8)])
def test_ctu3d_exact_one_step(vels):
    u, v, w = vels
    n = 10
    solver = pyclaw.ClawSolver3D(triemann.advection_3D, device="cpu")
    solver.order = 1
    solver.transverse_waves = 2
    solver.all_bcs = pyclaw.BC.periodic
    domain = pyclaw.Domain([0.0] * 3, [1.0] * 3, [n] * 3)
    state = pyclaw.State(domain, 1)
    state.problem_data.update(u=u, v=v, w=w)
    state.q[0] = np.random.default_rng(1).standard_normal((n, n, n))
    solver.setup(pyclaw.Solution(state, domain))
    dt = 0.5 / n
    q_new, _ = solver._step_fn(torch.from_numpy(state.q), None, dt, 0.0)
    expected = _product_form(state.q[0], (u * dt * n, v * dt * n,
                                          w * dt * n))
    np.testing.assert_allclose(q_new[0].numpy(), expected, atol=1e-13)


# ---- the wrapper ----------------------------------------------------------
def test_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    n = (10, 9, 8)
    rp = triemann.vc_acoustics_3D
    q, aux = rng.standard_normal((4,) + n), _aux3(rng, n)
    before = tiled2d.step3_xy_generic.launches
    q_w, c_w = tiled2d.step3_xy_generic(
        torch.from_numpy(q), torch.from_numpy(aux), 0.02, 0.2, 0.25, 0.3,
        rp, PARAMS, (10, 10), 2, False, 2, transverse_waves=1)
    q_p, c_p = _plain(rp, rp.rp, q, aux, 0.02, (0.2, 0.25, 0.3), (10, 10),
                      2, False, 2, 1)
    assert np.array_equal(q_w.numpy(), q_p) and float(c_w) == c_p
    assert tiled2d.step3_xy_generic.launches == before


@pytest.mark.parametrize("bad", [
    dict(mthlim=(4,) * 3), dict(mthlim=(22,) * 2), dict(order=3),
    dict(transverse_waves=3), dict(num_ghost=3)])
def test_wrapper_rejects_options(bad):
    kw = dict(mthlim=(4,) * 2, order=2, transverse_waves=1, num_ghost=2)
    kw.update(bad)
    with pytest.raises(ValueError):
        tiled2d.step3_xy_generic(
            torch.zeros(4, 9, 9, 9, dtype=torch.float64),
            torch.ones(2, 9, 9, 9, dtype=torch.float64), 0.01, 0.1, 0.1,
            0.1, triemann.vc_acoustics_3D, PARAMS, kw["mthlim"], kw["order"],
            False, -1, kw["num_ghost"], kw["transverse_waves"])


def test_wrapper_off_the_cpu_refuses_what_has_no_kernel():
    """On a tensor off the CPU the wrapper launches the kernel or raises;
    systems outside STEP3_SYSTEMS raise before any launch, and so does a
    tensor that is not the card's (a meta tensor stands in for both).
    Euler is not a system of this kernel (ClawSolver3D runs it on
    step3_xy, csrc/step3_ctu.cu): on the card the wrapper refuses it,
    with or without a capacity function."""
    q = torch.empty(5, 9, 9, 9, dtype=torch.float64, device="meta")
    aux = torch.empty(1, 9, 9, 9, dtype=torch.float64, device="meta")
    e3 = triemann.euler_3D
    assert set(tiled2d.STEP3_SYSTEMS) == {"vc_acoustics_3D", "acoustics_3D",
                                          "advection_3D", "burgers_3D"}
    assert tiled2d.step3_system_scalars(e3, PARAMS) == (0.0, 0.0, 0.0)
    assert tiled2d.step3_limiter_ids((4, 3, 1, 10, 2)) == [4, 3, 1, 10, 2]
    assert tiled2d.step3_limiter_ids((4, 10)) == [4, 10, 10, 10, 10]
    for aux_e, capa in ((aux, 0), (None, -1)):
        with pytest.raises(NotImplementedError, match="step3_ctu"):
            tiled2d.step3_xy_generic(q, aux_e, 1e-3, 0.1, 0.1, 0.1, e3,
                                     PARAMS, (4,) * 5, 2, False, capa)
    other = triemann.RiemannSolver("other_3D", 3, 5, 5, e3.rp, rpt=e3.rpt,
                                   rptt=e3.rptt)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        tiled2d.step3_xy_generic(q, None, 1e-3, 0.1, 0.1, 0.1, other,
                                 PARAMS, (4,) * 5, 2, False, -1)
    with pytest.raises(ValueError, match="device"):
        tiled2d.step3_xy_generic(q[:4], aux, 1e-3, 0.1, 0.1, 0.1,
                                 triemann.vc_acoustics_3D, PARAMS, (4,) * 2,
                                 2, False, -1)


# ---- the kernel's source on the host ------------------------------------
@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    from pyclaw_tpu_torch.ops import _build
    lib = _build.build_host_emulation(
        "step3_aos", str(tmp_path_factory.mktemp("step3_aos_host")), "-O0")
    for name in ("step3_aos_host_f32", "step3_aos_host_f64"):
        fn = getattr(lib, name)
        fn.argtypes = tiled2d.STEP3_AOS_ARGTYPES
        fn.restype = ctypes.c_int
    lib.step3_aos_blocks.argtypes = [ctypes.c_int] * 4
    lib.step3_aos_blocks.restype = ctypes.c_int
    return lib


def test_the_source_takes_the_wrappers_limiter_ids(host_kernel):
    """The build reports as many limiter ids as the wrapper passes, and a
    build that takes another number is refused where it is bound."""
    assert host_kernel.step3_aos_limiter_ids() == tiled2d.STEP3_AOS_LIMITERS

    class Fn:
        pass

    class Other:
        step3_aos_blocks = Fn()
        step3_aos_f32 = Fn()
        step3_aos_f64 = Fn()

        @staticmethod
        def step3_aos_limiter_ids():
            return 2

    with pytest.raises(RuntimeError, match="2 limiter ids"):
        tiled2d.bind_step3_aos_lib(Other())


def _fast_face(aux, axis, side, scale):
    """A fast sound speed (4 scale) and a small capacity (1 / (4 scale))
    in the inner ghost layer of one face, faster ones (8 scale) in its
    outer layer.  The inner layer's interface with the interior lies in
    the CFL window of the sweep along ``axis``; the outer layer's
    interface, and the inner layer seen from the other sweeps, lie outside
    it.  ``scale`` (the axis' cell width over the smallest) makes the
    face's Courant number, not only its speed, the largest."""
    n = aux.shape[1 + axis]
    for layer, k in (((1, 4.0) if side == 0 else (n - 2, 4.0)),
                     ((0, 8.0) if side == 0 else (n - 1, 8.0))):
        idx = [slice(None)] * 3
        idx[axis] = layer
        aux[(1,) + tuple(idx)] = k * scale
        aux[(2,) + tuple(idx)] = 1.0 / (k * scale)
    return aux


FACES = [None] + [(a, s) for a in range(3) for s in (0, 1)]
# per face case: (system, index_capa, transverse_waves, order, limiter,
# fwave); a face of a constant-speed system is pinned by its capacity
HOST_CASES = [("vc_acoustics_3D", 2, 1, 2, 4, False),
              ("vc_acoustics_3D", -1, 1, 2, 10, False),
              ("acoustics_3D", 2, 2, 2, 4, False),
              ("advection_3D", 2, 2, 2, 10, True),
              ("vc_acoustics_3D", 2, 0, 1, 3, False),
              ("acoustics_3D", 2, 1, 1, 4, False),
              ("vc_acoustics_3D", 2, 1, 2, 4, True)]


def _host_step(lib, rp, q, aux, dt, d, params, case, dtype):
    name, capa, tw, order, lim, fwave = case
    shape = tuple(s - 4 for s in q.shape[1:])
    is_double = dtype == np.float64
    fn = lib.step3_aos_host_f64 if is_double else lib.step3_aos_host_f32
    out = np.empty((rp.num_eqn,) + shape, dtype)
    # one CFL partial per block, each written
    cfl_blocks = np.full(lib.step3_aos_blocks(*q.shape[1:], int(is_double)),
                         np.nan, dtype)
    rc = fn(q.ctypes.data, aux.ctypes.data, out.ctypes.data,
            cfl_blocks.ctypes.data, *q.shape[1:],
            tiled2d.STEP3_SYSTEMS[name][0], capa, int(fwave),
            ctypes.byref(ctypes.c_double(dt)), *d,
            *tiled2d.step3_system_scalars(rp, params), order, tw,
            *tiled2d.step3_limiter_ids((lim,) * rp.num_waves))
    assert rc == 0
    assert np.isfinite(cfl_blocks).all()
    return out, float(cfl_blocks.max())


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("shape", [(9, 7, 10), (17, 13, 9), (3, 5, 2),
                                   (11, 14, 17)])
@pytest.mark.parametrize("face", range(len(FACES)))
def test_kernel_source_on_host_matches_plain(host_kernel, face, shape, dtype,
                                             tol):
    """csrc/step3_aos.cu's phases (tiles, halos, ragged-edge masks, the
    staged aux and per-cell dt/(dD kappa), the gathers of the rpt3/rptt3
    parts with the receiving cells' kappa, the CFL windows) against the
    plain version; the grids cover several tiles and partial tiles, a grid
    smaller than one tile, and one ragged on every axis in both types'
    tiles (8x8x8 in float32, 4x6x8 in float64)."""
    case = HOST_CASES[face]
    name, capa, tw, order, lim, fwave = case
    rp = triemann.ALL[name]
    rng = np.random.default_rng(face + sum(shape))
    n = tuple(s + 4 for s in shape)
    q = rng.standard_normal((rp.num_eqn,) + n)
    aux = _aux3(rng, n)
    aux0 = aux.copy()
    d = (2.0 / shape[0], 2.2 / shape[1], 1.8 / shape[2])
    params = dict(PARAMS)
    if FACES[face] is not None:
        axis, side = FACES[face]
        aux = _fast_face(aux, axis, side, d[axis] / min(d))
        # advection's speed along the face's axis points out of the
        # interior, so the ghost cell's capacity enters the window
        vel = ("u", "v", "w")[axis]
        params[vel] = -abs(params[vel]) if side == 0 else abs(params[vel])
    q, aux, aux0 = (np.ascontiguousarray(a.astype(dtype))
                    for a in (q, aux, aux0))
    dt = float(dtype(0.05 * min(d)))
    out, c_k = _host_step(host_kernel, rp, q, aux, dt, d, params, case,
                          dtype)
    qp, cp = tk.step3(torch.from_numpy(q), torch.from_numpy(aux), dt, *d,
                      rp.rp, rp.rpt, rp.rptt, params, (lim,) * rp.num_waves,
                      order, fwave, capa, 2, tw)
    q_p, c_p = qp.numpy(), float(cp)
    assert np.abs(out - q_p).max() / np.abs(q_p).max() <= tol
    assert abs(c_k - c_p) <= tol * c_p
    if FACES[face] is not None:
        # the fast inner layer sets the CFL: its window is the one pinned
        c0 = float(tk.step3(torch.from_numpy(q), torch.from_numpy(aux0), dt,
                            *d, rp.rp, rp.rpt, rp.rptt, params,
                            (lim,) * rp.num_waves, order, fwave, capa, 2,
                            tw)[1])
        assert c_p > 1.2 * c0


# ---- burgers_3D on the host -------------------------------------------------
# (transverse_waves, order, limiter, index_capa, fwave, efix): every
# transverse_waves and order, MC, minmod and the CFL-dependent id 10, with
# and without a capacity function, the f-wave form, without the entropy fix
BURGERS_OPTS = [(2, 2, 4, -1, False, True), (1, 2, 1, 0, False, False),
                (0, 1, 4, -1, False, True), (2, 2, 10, 0, True, True),
                (2, 1, 3, 0, False, False)]


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("shape", [(3, 5, 2), (8, 8, 8), (4, 6, 8),
                                   (17, 13, 9), (9, 14, 20)])
def test_burgers_on_host_matches_plain(host_kernel, shape, dtype, tol):
    """csrc/step3_aos.cu's burgers_3D instance (the splits by the receiving
    cell's state, rpt3 and rptt3, the entropy fix) against the plain
    version on states of either sign (transonic interfaces) with a
    capacity row: a grid less than a tile, one tile of each type (8x8x8
    in float32, 4x6x8 in float64) and ragged grids of several tiles."""
    rp = triemann.burgers_3D
    rng = np.random.default_rng(sum(shape))
    n = tuple(s + 4 for s in shape)
    q = rng.standard_normal((1,) + n)
    aux = (0.7 + 0.6 * rng.random((1,) + n))
    q, aux = (np.ascontiguousarray(a.astype(dtype)) for a in (q, aux))
    d = (2.0 / shape[0], 2.2 / shape[1], 1.8 / shape[2])
    dt = float(dtype(0.05 * min(d)))
    for tw, order, lim, capa, fwave, efix in BURGERS_OPTS:
        params = {"efix": efix}
        out, c_k = _host_step(host_kernel, rp, q, aux, dt, d, params,
                              ("burgers_3D", capa, tw, order, lim, fwave),
                              dtype)
        qp, cp = tk.step3(torch.from_numpy(q), torch.from_numpy(aux), dt,
                          *d, rp.rp, rp.rpt, rp.rptt, params, (lim,), order,
                          fwave, capa, 2, tw)
        q_p, c_p = qp.numpy(), float(cp)
        assert np.abs(out - q_p).max() / np.abs(q_p).max() <= tol
        assert abs(c_k - c_p) <= tol * c_p


def test_the_source_takes_burgers(host_kernel):
    """The build takes four systems, the wrapper's; an earlier build (no
    step3_aos_num_systems) takes three."""
    assert host_kernel.step3_aos_num_systems() == len(tiled2d.STEP3_SYSTEMS)
    assert tiled2d.step3_build_takes(host_kernel, triemann.burgers_3D)

    class Earlier:
        pass

    assert not tiled2d.step3_build_takes(Earlier(), triemann.burgers_3D)
    assert tiled2d.step3_build_takes(Earlier(), triemann.advection_3D)
    assert tiled2d.step3_system_scalars(triemann.burgers_3D, {}) == (
        1.0, 0.0, 0.0)
    assert tiled2d.step3_system_scalars(triemann.burgers_3D,
                                        {"efix": False}) == (0.0, 0.0, 0.0)
