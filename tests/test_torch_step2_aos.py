"""The port's generic 2D CTU step (aux, capacity, f-waves) against the
JAX package's.

* ``classic/kernels.py:step2`` of the port (the plain version of
  ``csrc/step2_aos.cu``) against ``pyclaw_tpu/classic/kernels.py:step2``
  in float64, CFL included, to 1e-12 relative: the shallow-water Roe
  solver for transverse_waves 0/1/2 x order 1/2 x limiters {MC, minmod,
  one CFL-dependent id}; the bathymetry f-wave solver with aux; and both
  with a non-uniform capacity function in aux[1] (``index_capa=1``).
* one case each against the JAX package's Pallas kernels in interpret
  mode, as tests/test_pallas_backend.py runs them: ``step2_pallas_rows``
  with the generic body (``rpn_soa=None``) at 16x128,
  ``step2_pallas_tiled_generic`` at 32x64 and ``ops.step2_pallas`` at
  12x10.
* the CUDA kernel's own source, compiled for the host (its phases run
  block by block on the CPU), against the plain version: several tiles,
  partial tiles, float32 and float64, with a non-uniform capacity
  function and, on each face in turn, a fast state in the inner ghost
  layer (inside the CFL window) and a faster one in the outer layer
  (outside it).
* the same for the instances of the Euler 4- and 5-wave systems (a
  tracer; speeds crossing zero; the f-wave form) and of ``sw_aug_2D``
  (wet/dry states that take every branch of the augmented solver: both
  wet, each dry front, walls on either side, both dry, damp cells below
  the dry tolerance; the f-wave form, the bottom in aux) on grids less
  than a tile, of one and of several tiles, ragged either way;
* and for the scalar and variable-coefficient instances (advection_2D,
  vc_advection_2D, vc_advection_fwave_2D, vc_acoustics_2D, kpp_2D,
  burgers_2D: the split by the receiving cell and its transverse
  neighbours' aux, with aux that jumps across tile edges);
* and for the two instances without a transverse solver (psystem_2D with
  either stress law, shallow_sphere_fwave_2D with its capacity row), which
  take no transverse pass whatever transverse_waves the caller passes.
"""

import ctypes
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyclaw_tpu import riemann as jriemann
from pyclaw_tpu.classic import kernels as jk
from pyclaw_tpu_torch import riemann as triemann
from pyclaw_tpu_torch.classic import kernels as tk
from pyclaw_tpu_torch.ops import tiled2d

PARAMS = {"grav": 1.0}
ROE, BATHY = "shallow_roe_with_efix_2D", "shallow_bathymetry_fwave_2D"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _state(seed, nx, ny, dtype=np.float64):
    """Ghost-padded wet state (3, nx+4, ny+4) with velocities of either
    sign (transonic interfaces included), bathymetry in aux[0] and a
    non-uniform capacity function in aux[1]."""
    rng = np.random.default_rng(seed)
    n = (nx + 4, ny + 4)
    h = 0.5 + rng.random(n)
    u, v = rng.standard_normal(n), rng.standard_normal(n)
    q = np.stack([h, h * u, h * v])
    aux = np.stack([0.3 * rng.random(n), 0.7 + 0.6 * rng.random(n)])
    return (np.ascontiguousarray(q.astype(dtype)),
            np.ascontiguousarray(aux.astype(dtype)))


def _jax_step(name, q, aux, dt, dx, dy, lims, order, fwave, capa, tw):
    rp = getattr(jriemann, name)
    qn, cfl = jk.step2(jnp.asarray(q), jnp.asarray(aux), dt, dx, dy, rp.rp,
                       rp.rpt, PARAMS, lims, order, fwave, capa, 2,
                       transverse_waves=tw)
    return np.asarray(qn), float(cfl)


def _plain(name, q, aux, dt, dx, dy, lims, order, fwave, capa, tw):
    rp = triemann.ALL[name]
    qn, cfl = tk.step2(torch.from_numpy(q), torch.from_numpy(aux), dt, dx,
                       dy, rp.rp, rp.rpt, PARAMS, lims, order, fwave, capa,
                       2, tw)
    return qn.numpy(), float(cfl)


def _close(a, b, ca, cb, tol):
    assert a.shape == b.shape
    assert np.abs(a - b).max() / np.abs(b).max() <= tol
    assert abs(ca - cb) <= tol * cb


CASES = ([(ROE, False, -1, tw, order, lim) for tw in (0, 1, 2)
          for order in (1, 2) for lim in (4, 1, 10)]
         + [(BATHY, True, -1, 2, 2, 4), (BATHY, True, -1, 1, 2, 10),
            (BATHY, True, -1, 0, 1, 1), (BATHY, True, 1, 2, 2, 4),
            (BATHY, True, 1, 1, 2, 10), (BATHY, True, 1, 2, 1, 1),
            (ROE, False, 1, 2, 2, 4), (ROE, True, -1, 2, 2, 10)])


@pytest.mark.parametrize("name,fwave,capa,tw,order,lim", CASES)
def test_plain_step_matches_jax_step2(name, fwave, capa, tw, order, lim):
    nx, ny = 14, 11
    q, aux = _state(100 * tw + 10 * order + lim + capa, nx, ny)
    args = (0.02, 1.0 / nx, 1.0 / ny, (lim,) * 3, order, fwave, capa, tw)
    q_t, c_t = _plain(name, q, aux, *args)
    q_j, c_j = _jax_step(name, q, aux, *args)
    _close(q_t, q_j, c_t, c_j, 1e-12)


def test_wrapper_on_cpu_is_the_plain_version():
    q, aux = _state(7, 9, 6)
    rp = triemann.ALL[BATHY]
    before = tiled2d.step2_rows_generic.launches
    q_w, c_w = tiled2d.step2_rows_generic(
        torch.from_numpy(q), torch.from_numpy(aux), 0.02, 1 / 9, 1 / 6, rp,
        PARAMS, (4,) * 3, 2, True, 1)
    q_p, c_p = _plain(BATHY, q, aux, 0.02, 1 / 9, 1 / 6, (4,) * 3, 2, True,
                      1, 2)
    assert np.array_equal(q_w.numpy(), q_p) and float(c_w) == c_p
    assert tiled2d.step2_rows_generic.launches == before


@pytest.mark.parametrize("bad", [
    dict(mthlim=(4,) * 4), dict(mthlim=(22,) * 3), dict(order=3),
    dict(transverse_waves=3), dict(num_ghost=3)])
def test_wrapper_rejects_options(bad):
    kw = dict(mthlim=(4,) * 3, order=2, transverse_waves=2, num_ghost=2)
    kw.update(bad)
    with pytest.raises(ValueError):
        tiled2d.step2_rows_generic(
            torch.ones(3, 9, 9, dtype=torch.float64), None, 0.01, 0.1, 0.1,
            triemann.ALL[ROE], PARAMS, kw["mthlim"], kw["order"], False, -1,
            kw["num_ghost"], kw["transverse_waves"])


# ---- the JAX package's Pallas kernels, interpret mode ---------------------
def test_matches_step2_pallas_rows_generic_body():
    """step2_pallas_rows with the generic-AoS roll body (rpn_soa=None),
    bathymetry f-waves with capacity, two row tiles of 8."""
    from pyclaw_tpu.ops import tiled2d as jtiled
    nx, ny = 16, 128
    q, aux = _state(3, nx, ny)
    rp = jriemann.shallow_bathymetry_fwave_2D
    args = (2e-3, 1.0 / nx, 1.0 / ny)
    q_j, c_j = jtiled.step2_pallas_rows(
        jnp.asarray(q), jnp.asarray(aux), *args, rp.rp, rp.rpt, PARAMS,
        (4,) * 3, 2, True, 1, 2, rpn_soa=None, transverse_waves=2,
        tile_rows=8)
    q_t, c_t = _plain(BATHY, q, aux, *args, (4,) * 3, 2, True, 1, 2)
    _close(q_t, np.asarray(q_j), c_t, float(c_j), 1e-12)


def test_matches_step2_pallas_tiled_generic():
    from pyclaw_tpu.ops import tiled2d as jtiled
    nx, ny = 32, 64
    q, aux = _state(4, nx, ny)
    rp = jriemann.shallow_roe_with_efix_2D
    args = (2e-3, 1.0 / nx, 1.0 / ny)
    q_j, c_j = jtiled.step2_pallas_tiled_generic(
        jnp.asarray(q), jnp.asarray(aux), *args, rp.rp, rp.rpt, PARAMS,
        (1,) * 3, 2, False, 1, 2, transverse_waves=1, tile=(8, 32))
    q_t, c_t = _plain(ROE, q, aux, *args, (1,) * 3, 2, False, 1, 1)
    _close(q_t, np.asarray(q_j), c_t, float(c_j), 1e-12)


def test_matches_step2_pallas_single_block():
    from pyclaw_tpu.ops import step2_pallas
    nx, ny = 12, 10
    q, aux = _state(5, nx, ny)
    rp = jriemann.shallow_roe_with_efix_2D
    args = (1e-2, 1.0 / nx, 1.0 / ny)
    q_j, c_j = step2_pallas(jnp.asarray(q), None, *args, rp.rp, rp.rpt,
                            PARAMS, (4,) * 3, 2, False, -1, 2,
                            transverse_waves=2)
    q_t, c_t = _plain(ROE, q, aux, *args, (4,) * 3, 2, False, -1, 2)
    _close(q_t, np.asarray(q_j), c_t, float(c_j), 1e-12)


# ---- the kernel's source on the host ---------------------------------------
@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    from pyclaw_tpu_torch.ops import _build
    lib = _build.build_host_emulation(
        "step2_aos", str(tmp_path_factory.mktemp("step2_aos_host")))
    return tiled2d.bind_step2_aos_host(lib)


def _fast_face(q, axis, side, scale):
    """A fast state (velocity 8 scale, inward) in the inner ghost layer of
    one face, and a faster one (16 scale) in its outer layer.  The inner
    layer's interface with the interior lies in the CFL window of the
    sweep along ``axis``; the outer layer's interface, and the inner
    layer seen from the other sweep, lie outside it.  ``scale`` (the
    axis' cell width over the smallest) makes the face's Courant number,
    not only its speed, the largest."""
    n = q.shape[1 + axis]
    sign = 1.0 if side == 0 else -1.0
    for layer, speed in (((1, 8.0) if side == 0 else (n - 2, 8.0)),
                         ((0, 16.0) if side == 0 else (n - 1, 16.0))):
        idx = [slice(None)] * 3
        idx[1 + axis] = layer
        h = q[tuple([0] + idx[1:])]
        for c in (1, 2):
            q[tuple([c] + idx[1:])] = sign * h * speed * scale
    return q


FACES = [None] + [(a, s) for a in range(2) for s in (0, 1)]


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("nx,ny", [(24, 20), (13, 37), (33, 5)])
@pytest.mark.parametrize("face", range(len(FACES)))
def test_kernel_source_on_host_matches_plain(host_kernel, face, nx, ny,
                                             dtype, tol):
    """csrc/step2_aos.cu's phases (tiles, halos, ragged-edge masks, the
    rpt2 gathers with the receiving cells' capacity, the CFL windows)
    against the plain version, for each system with and without a
    capacity function."""
    name, fwave, capa, tw, order, lim = [
        (BATHY, True, 1, 2, 2, 4), (ROE, False, 1, 1, 2, 10),
        (BATHY, True, -1, 2, 1, 1), (ROE, False, -1, 2, 2, 4),
        (ROE, True, 1, 0, 2, 10)][face]
    q, aux = _state(face + nx + ny, nx, ny)
    deltas = (1.0 / nx, 1.0 / ny)
    if FACES[face] is not None:
        axis = FACES[face][0]
        q = _fast_face(q, *FACES[face], deltas[axis] / min(deltas))
    q, aux = (np.ascontiguousarray(a.astype(dtype)) for a in (q, aux))
    dt = float(dtype(0.05 * min(deltas)))
    is_double = dtype == np.float64
    fn = (host_kernel.step2_aos_host_f64 if is_double
          else host_kernel.step2_aos_host_f32)
    out = np.empty((3, nx, ny), dtype)
    cfl_blocks = np.empty(host_kernel.step2_aos_blocks(nx + 4, ny + 4,
                                                       int(is_double)), dtype)
    rc = fn(q.ctypes.data, aux.ctypes.data, out.ctypes.data,
            cfl_blocks.ctypes.data, nx + 4, ny + 4, tiled2d.AOS_SYSTEMS[name][0],
            capa, int(fwave), ctypes.byref(ctypes.c_double(dt)), *deltas,
            PARAMS["grav"], 1e-8, order, tw,
            *tiled2d.aos_limiter_ids((lim,) * 3))
    assert rc == 0
    q_p, c_p = _plain(name, q, aux, dt, *deltas, (lim,) * 3, order, fwave,
                      capa, tw)
    _close(out, q_p, float(cfl_blocks.max()), c_p, tol)
    if FACES[face] is not None:
        # the fast inner layer sets the CFL: its window is the one pinned
        q0, _ = _state(face + nx + ny, nx, ny)
        assert c_p > 1.2 * _plain(name, q0.astype(dtype), aux, dt, *deltas,
                                  (lim,) * 3, order, fwave, capa, tw)[1]


# ---- the Euler and sw_aug_2D instances on the host --------------------------
EULER_PARAMS = {"gamma": 1.4}
SW_AUG_PARAMS = {"grav": 9.8, "dry_tolerance": 1e-3}
# (transverse_waves, order, limiter, index_capa, fwave): every
# transverse_waves and order, MC, van Leer and the CFL-dependent id 10,
# with and without a capacity function, the wave and the f-wave form
EULER_OPTS = [(2, 2, 4, -1, False), (1, 2, 3, -1, False),
              (0, 1, 4, -1, False), (2, 2, 10, 0, False),
              (1, 1, 3, 0, False), (2, 2, 4, -1, True), (0, 2, 10, 0, True)]
# sw_aug_2D takes f-waves, the bottom in aux[0]; the capacity in aux[1]
SW_AUG_OPTS = [(2, 2, 4, -1), (1, 2, 3, 1), (0, 1, 4, -1), (0, 2, 10, 1),
               (2, 1, 1, -1), (1, 2, 4, 1)]


def euler_state(seed, nx, ny, num_eqn):
    """Ghost-padded admissible Euler state (num_eqn, nx+4, ny+4) with
    velocities of either sign (u - a and u + a cross zero), a tracer rho
    phi for the 5-wave system, and a non-uniform capacity in aux[0]."""
    rng = np.random.default_rng(seed)
    n = (nx + 4, ny + 4)
    rho = 0.5 + rng.random(n)
    u, v = 1.5 * rng.standard_normal(n), 1.5 * rng.standard_normal(n)
    p = 0.5 + rng.random(n)
    q = [rho, rho * u, rho * v, p / 0.4 + 0.5 * rho * (u * u + v * v)]
    if num_eqn == 5:
        q.append(rho * rng.random(n) * (rng.random(n) < 0.5))
    return np.stack(q), np.stack([0.7 + 0.6 * rng.random(n)])


def sw_aug_state(seed, nx, ny):
    """Ghost-padded wet/dry state (3, nx+4, ny+4): a quarter of the cells
    dry (h = 0) on a bottom that lies above or below the wet neighbours'
    surface (walls and fronts), a tenth damp (h below the dry tolerance),
    the rest wet with velocities of either sign; aux: the bottom and a
    non-uniform capacity."""
    rng = np.random.default_rng(seed)
    n = (nx + 4, ny + 4)
    dry = rng.random(n) < 0.25
    h = np.where(dry, 0.0, 0.2 + rng.random(n))
    h = np.where(rng.random(n) < 0.1, 5e-4, h)
    b = np.where(dry, 0.5 + rng.random(n), 0.3 * rng.random(n))
    q = np.stack([h, h * rng.standard_normal(n), h * rng.standard_normal(n)])
    return q, np.stack([b, 0.7 + 0.6 * rng.random(n)])


def _host_step(lib, name, q, aux, dt, deltas, params, lims, order, tw,
               fwave, capa):
    rp = triemann.ALL[name]
    nx, ny = q.shape[1] - 4, q.shape[2] - 4
    is_double = q.dtype == np.float64
    fn = lib.step2_aos_host_f64 if is_double else lib.step2_aos_host_f32
    out = np.empty((rp.num_eqn, nx, ny), q.dtype)
    cfl_blocks = np.full(tiled2d.aos_blocks(
        lib, tiled2d.AOS_SYSTEMS[name][0], nx + 4, ny + 4, is_double),
        np.nan, q.dtype)
    rc = fn(q.ctypes.data, aux.ctypes.data, out.ctypes.data,
            cfl_blocks.ctypes.data, nx + 4, ny + 4,
            tiled2d.AOS_SYSTEMS[name][0], capa, int(fwave),
            ctypes.byref(ctypes.c_double(dt)), *deltas,
            *tiled2d.aos_system_params(rp, params), order, tw,
            *tiled2d.aos_limiter_ids(lims))
    assert rc == 0 and np.isfinite(cfl_blocks).all()
    return out, float(cfl_blocks.max())


# grids less than a tile, of several tiles, ragged either way; and those
# that straddle the Euler systems' tiles (12x15 in float32, 11x15 in
# float64) by a cell: one tile of either type, k TX +- 1 by k TY -+ 1
GRIDS = [(7, 5), (60, 60), (100, 37), (64, 100), (11, 15), (12, 15),
         (23, 29), (21, 31), (25, 14), (35, 46)]
# The SHA-256 of q and the CFL of the Euler instances' host emulation over
# EULER_OPTS (in order) on the grids that straddle their tiles, as the
# design before the compact records (the one tile of every system)
# computed them: the redesign keeps its bits
EULER_DIGESTS = {
    ("euler_4wave_2D", 11, 15, "float64"):
        "4276bc6371110a59e6cb9cc25a0c295782e6c2b186e7254a993cfe4ed12a5412",
    ("euler_4wave_2D", 11, 15, "float32"):
        "c8d2291e0bb998ec1f063a8d905831fffce913a117d1976806aaea5e7dd268a3",
    ("euler_4wave_2D", 12, 15, "float64"):
        "6d422834ecdd325ad293da97f2dba822d3777d098028aee3faaa78ae0373e93e",
    ("euler_4wave_2D", 12, 15, "float32"):
        "7ebf6b61a7a615f9a4c3271a37bc1228b26ca23210acbbb041d5ab50b2804ebf",
    ("euler_4wave_2D", 23, 29, "float64"):
        "a8903c1b7a70ec48bf6bafbb4e4eb272f8067b7f35b81ce67db62e629d23424e",
    ("euler_4wave_2D", 23, 29, "float32"):
        "18247f97485bf87cfc1a0b0626776f3e89acd073c4f9d9d925433da70f09dfcc",
    ("euler_4wave_2D", 21, 31, "float64"):
        "11151c5b6530f66cb8d180c6ab6059e50aac87d6d7b58247f5dc8755a3e42b16",
    ("euler_4wave_2D", 21, 31, "float32"):
        "0d750049355f2ba1edd5591d7932216db50883d04f3f4ec5cd66da5f9b755e05",
    ("euler_4wave_2D", 25, 14, "float64"):
        "4243e01289935fa34c9389ff66dd111f6a77349143a2565db89e40a4e2b1b0cb",
    ("euler_4wave_2D", 25, 14, "float32"):
        "0e6344963df4662e82c3458db7b67909a0e041f980735b01a11165d39af02c11",
    ("euler_4wave_2D", 35, 46, "float64"):
        "6fa234747ffd25c6a5628513aabc7f2182141c7ad66197dfe3976c9eaf2253e0",
    ("euler_4wave_2D", 35, 46, "float32"):
        "c746acb4ddc49a77dc22932aecff98929bf340b073cc8fc0b7bf0def20bd88a3",
    ("euler_5wave_2D", 11, 15, "float64"):
        "a381d0c510568e96061b260bb63a5a356c8d75da3817eb72745f66857ed877c9",
    ("euler_5wave_2D", 11, 15, "float32"):
        "6961b021564fe5a3ba9f6f59887ccb0616565e43e9eb444da0d469481be15c2f",
    ("euler_5wave_2D", 12, 15, "float64"):
        "1de00e966355ab198b5094e4f71dfc0255d3d9ecf963975c6257a03c7c1d3324",
    ("euler_5wave_2D", 12, 15, "float32"):
        "7a4f4f31d5b7596e638f0588f0f9d1ed29dd6b8700cdd876060824c595db646f",
    ("euler_5wave_2D", 23, 29, "float64"):
        "11fd76946a7e4ddcbc85ac667951b8a290c90a79e172a14e931455a722bcb6e3",
    ("euler_5wave_2D", 23, 29, "float32"):
        "aa403d7042709e486d7d16517294f84f3a5e1db8b59b90f07e60a28f9bfc4462",
    ("euler_5wave_2D", 21, 31, "float64"):
        "69f661f565d06cc01926a658ecdb2d1198c332c397c335f081e57dc5a9b25e9f",
    ("euler_5wave_2D", 21, 31, "float32"):
        "40d02aca07f0789ef43334170bb7d551d381145a4c613f7b91e64b96f5407606",
    ("euler_5wave_2D", 25, 14, "float64"):
        "c8974981ca66f70030c7764c35b8eb9bd65cf6c1300b01cbed5f443a24f29c39",
    ("euler_5wave_2D", 25, 14, "float32"):
        "0db44f768bb4f155435710a6ccf0ad508538cfb2a00b0e314f14a7eee53f105d",
    ("euler_5wave_2D", 35, 46, "float64"):
        "3432197a709765ae20f1873da224576def693be35ca7d155598120e1c789d39a",
    ("euler_5wave_2D", 35, 46, "float32"):
        "c0ed56d226b2e13b1b0dc600e2c454dc068db6ca6263cfa035d67bcde2ca11b0",
}


def _euler_digest(h, out, cfl, dtype):
    h.update(out.tobytes())
    h.update(np.array(cfl, dtype).tobytes())


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("nx,ny", GRIDS)
@pytest.mark.parametrize("name", ["euler_4wave_2D", "euler_5wave_2D",
                                  "sw_aug_2D"])
def test_new_instances_on_host_match_plain(host_kernel, name, nx, ny,
                                           dtype, tol):
    """csrc/step2_aos.cu's Euler 4-wave, Euler 5-wave and sw_aug_2D
    instances (the wider limiter ids, the per-cell Roe quantities, the
    tracer, the dry-state machinery; the Euler systems' compact records
    and their own tile) against the plain version, over the options
    matrix; on the grids of EULER_DIGESTS the Euler instances' q and CFL
    bit for bit those of their design before the compact records."""
    import hashlib
    digest = hashlib.sha256()
    rp = triemann.ALL[name]
    deltas = (1.0 / nx, 1.0 / ny)
    if name == "sw_aug_2D":
        q, aux = sw_aug_state(nx + 3 * ny, nx, ny)
        params = SW_AUG_PARAMS
        opts = [o + (True,) for o in SW_AUG_OPTS]
    else:
        q, aux = euler_state(nx + 3 * ny, nx, ny, rp.num_eqn)
        params = EULER_PARAMS
        opts = EULER_OPTS
    q, aux = (np.ascontiguousarray(a.astype(dtype)) for a in (q, aux))
    dt = float(dtype(0.05 * min(deltas)))
    for tw, order, lim, capa, fwave in opts:
        lims = (lim,) * rp.num_waves
        out, cfl = _host_step(host_kernel, name, q, aux, dt, deltas, params,
                              lims, order, tw, fwave, capa)
        q_p, c_p = tk.step2(torch.from_numpy(q), torch.from_numpy(aux), dt,
                            *deltas, rp.rp, rp.rpt, params, lims, order,
                            fwave, capa, 2, tw, rp.prefactor)
        _close(out, q_p.numpy(), cfl, float(c_p), tol)
        _euler_digest(digest, out, cfl, dtype)
    key = (name, nx, ny, np.dtype(dtype).name)
    if key in EULER_DIGESTS:
        assert digest.hexdigest() == EULER_DIGESTS[key]


def _any_state(name, nx, ny, dtype):
    """A ghost-padded state, its aux and the physics parameters of system
    ``name`` of AOS_SYSTEMS (the states of this file's other tests)."""
    if name == "euler_4wave_2D" or name == "euler_5wave_2D":
        q, aux = euler_state(nx + ny, nx, ny, triemann.ALL[name].num_eqn)
        params = EULER_PARAMS
    elif name == "sw_aug_2D":
        q, aux = sw_aug_state(nx + ny, nx, ny)
        params = SW_AUG_PARAMS
    elif name in ("psystem_2D", "shallow_sphere_fwave_2D"):
        q, aux = no_trans_state(nx + ny, name, nx, ny)
        params = {"grav": 1.0, "stress_relation": "exp"}
    elif name in (ROE, BATHY, "acoustics_2D"):
        q, aux = _state(nx + ny, nx, ny)
        params = dict(PARAMS, rho=1.0, bulk=4.0)
    else:
        q, aux = scalar_state(nx + ny, name, nx, ny)
        params = SCALAR_PARAMS
    return (np.ascontiguousarray(q.astype(dtype)),
            np.ascontiguousarray(aux.astype(dtype)), params)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(tiled2d.AOS_SYSTEMS))
def test_kernel_writes_the_partials_it_counts(host_kernel, name, dtype):
    """Each system's instance writes step2_aos_system_blocks(...) CFL
    partials, every one of them, and nothing past them, on a ragged grid
    of several tiles."""
    nx, ny = 37, 47
    rp = triemann.ALL[name]
    q, aux, params = _any_state(name, nx, ny, dtype)
    is_double = dtype == np.float64
    system = tiled2d.AOS_SYSTEMS[name][0]
    n = host_kernel.step2_aos_system_blocks(system, nx + 4, ny + 4,
                                            int(is_double))
    fn = (host_kernel.step2_aos_host_f64 if is_double
          else host_kernel.step2_aos_host_f32)
    out = np.empty((rp.num_eqn, nx, ny), dtype)
    cfl_blocks = np.full(n + 8, np.nan, dtype)
    rc = fn(q.ctypes.data, aux.ctypes.data, out.ctypes.data,
            cfl_blocks.ctypes.data, nx + 4, ny + 4, system, -1, 0,
            ctypes.byref(ctypes.c_double(1e-3)), 1.0 / nx, 1.0 / ny,
            *tiled2d.aos_system_params(rp, params), 2, 2,
            *tiled2d.aos_limiter_ids((4,) * rp.num_waves))
    assert rc == 0
    assert np.isfinite(cfl_blocks[:n]).all()
    assert np.isnan(cfl_blocks[n:]).all()


@pytest.mark.parametrize("nx,ny", [(7, 5), (11, 15), (12, 16), (100, 37),
                                   (1024, 1024), (2048, 512)])
def test_system_blocks_are_the_tiles(host_kernel, nx, ny):
    """step2_aos_system_blocks: the ten systems of the generic design keep
    step2_aos_blocks (one tile per type, 12x15 and 11x16); the Euler
    systems count their own tiles (12x15 and 11x15), psystem_2D its 16x32
    and vc_advection_2D its 32x32 in both types."""
    own = {"psystem_2D": (16, 32), "vc_advection_2D": (32, 32)}
    for name, (system, _) in tiled2d.AOS_SYSTEMS.items():
        for is_double in (0, 1):
            got = host_kernel.step2_aos_system_blocks(system, nx + 4, ny + 4,
                                                      is_double)
            if name.startswith("euler_") or name in own:
                tx, ty = own.get(name, (11, 15) if is_double else (12, 15))
                assert got == -(-nx // tx) * -(-ny // ty)
            else:
                assert got == host_kernel.step2_aos_blocks(nx + 4, ny + 4,
                                                           is_double)
    assert host_kernel.step2_aos_system_blocks(len(tiled2d.AOS_SYSTEMS),
                                               11, 9, 1) == -1


# ---- the scalar and variable-coefficient instances on the host -------------
SCALAR_PARAMS = {"u": 0.7, "v": -0.4}
# (transverse_waves, order, limiter, index_capa, fwave): every
# transverse_waves and order, MC, minmod and the CFL-dependent id 10, with
# and without a capacity function (aux[2]), the wave and the f-wave form
# (vc_advection_fwave_2D always takes the f-wave form)
SCALAR_OPTS = [(2, 2, 4, -1, False), (1, 2, 1, 2, False), (0, 1, 4, -1, False),
               (2, 2, 10, 2, True), (0, 2, 3, 2, False)]
# grids less than a tile, of one tile in float32 (12x15) and in float64
# (11x16), and of several tiles, ragged either way
SCALAR_GRIDS = [(7, 5), (12, 15), (11, 16), (100, 37), (37, 64)]


def scalar_state(seed, name, nx, ny):
    """Ghost-padded state (num_eqn, nx+4, ny+4) and aux (3, nx+4, ny+4) of
    a scalar or variable-coefficient system: states of either sign
    (Burgers: transonic interfaces; kpp: around its initial 14 pi / 4 and
    pi / 4), aux rows of either sign for the advection velocities,
    positive impedance and sound speed for acoustics, a capacity row last;
    the aux rows jump across the first tile edges of both types (padded
    rows 13 | 14 and columns 17 | 18: f64 and f32 tiles' first rows and
    f32 and f64 tiles' first columns)."""
    rng = np.random.default_rng(seed)
    n = (nx + 4, ny + 4)
    rp = triemann.ALL[name]
    if name == "kpp_2D":
        q = np.where(rng.random((1,) + n) < 0.5, 14.0 * np.pi / 4.0,
                     np.pi / 4.0) + 0.3 * rng.standard_normal((1,) + n)
    else:
        q = rng.standard_normal((rp.num_eqn,) + n)
    if name == "vc_acoustics_2D":
        aux = np.stack([1.0 + 0.5 * rng.random(n), 1.0 + 0.5 * rng.random(n),
                        0.7 + 0.6 * rng.random(n)])
    else:
        aux = np.stack([rng.standard_normal(n), rng.standard_normal(n),
                        0.7 + 0.6 * rng.random(n)])
    aux[:2, 13:] *= 2.5
    aux[:2, 14:] *= 0.5
    aux[:2, :, 17:] *= 3.0
    aux[:2, :, 18:] *= 0.4
    return q, aux


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("nx,ny", SCALAR_GRIDS)
@pytest.mark.parametrize("name", ["advection_2D", "vc_advection_2D",
                                  "vc_advection_fwave_2D", "vc_acoustics_2D",
                                  "kpp_2D", "burgers_2D"])
def test_scalar_instances_on_host_match_plain(host_kernel, name, nx, ny,
                                              dtype, tol):
    """csrc/step2_aos.cu's advection_2D, vc_advection_2D,
    vc_advection_fwave_2D, vc_acoustics_2D, kpp_2D and burgers_2D instances
    (the cell split with the receiving cell's transverse neighbours'
    aux, kpp's sin and cos, Burgers' entropy fix) against the plain
    version, over the options matrix; Burgers also without the entropy
    fix.  float32 to 1e-5 relative: roundoff, and for kpp the host's sinf
    and cosf against PyTorch's (8e-8 here)."""
    rp = triemann.ALL[name]
    deltas = (1.0 / nx, 1.0 / ny)
    q, aux = scalar_state(nx + 3 * ny + len(name), name, nx, ny)
    q, aux = (np.ascontiguousarray(a.astype(dtype)) for a in (q, aux))
    dt = float(dtype(0.05 * min(deltas)))
    for k, (tw, order, lim, capa, fwave) in enumerate(SCALAR_OPTS):
        fwave = fwave or name == "vc_advection_fwave_2D"
        params = dict(SCALAR_PARAMS, efix=k != 1)
        lims = (lim,) * rp.num_waves
        out, cfl = _host_step(host_kernel, name, q, aux, dt, deltas, params,
                              lims, order, tw, fwave, capa)
        q_p, c_p = tk.step2(torch.from_numpy(q), torch.from_numpy(aux), dt,
                            *deltas, rp.rp, rp.rpt, params, lims, order,
                            fwave, capa, 2, tw, rp.prefactor)
        _close(out, q_p.numpy(), cfl, float(c_p), tol)


# ---- the instances without a transverse solver on the host ----------------
# (transverse_waves passed, order, limiter, index_capa, fwave, the
# p-system's stress law): the kernel runs each with transverse_waves 0
NO_TRANS_OPTS = [(2, 2, 4, -1, True, "exp"), (1, 2, 1, 1, True, "linear"),
                 (0, 1, 4, 1, False, "exp"), (2, 2, 10, 1, True, "exp")]


def no_trans_state(seed, name, nx, ny):
    """Ghost-padded state and aux (2, nx+4, ny+4) of psystem_2D (strain of
    either sign, rho and K positive) or shallow_sphere_fwave_2D (depths
    near 1, velocities of either sign with transonic interfaces, aux rows
    of cos(theta)-like values in (0.5, 1.1)), aux jumping across the first
    tile edges of both types as scalar_state's."""
    rng = np.random.default_rng(seed)
    n = (nx + 4, ny + 4)
    if name == "psystem_2D":
        q = np.stack([0.3 * rng.standard_normal(n), rng.standard_normal(n),
                      rng.standard_normal(n)])
        aux = np.stack([0.5 + rng.random(n), 0.5 + 3.0 * rng.random(n)])
    else:
        h = 0.8 + 0.4 * rng.random(n)
        q = np.stack([h, h * 1.2 * rng.standard_normal(n),
                      h * 1.2 * rng.standard_normal(n)])
        aux = 0.5 + 0.6 * rng.random((2,) + n)
    aux[:, 13:] *= 1.3
    aux[:, 14:] *= 0.8
    aux[:, :, 17:] *= 1.2
    aux[:, :, 18:] *= 0.9
    return q, aux


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("nx,ny", [(7, 5), (12, 15), (100, 37)])
@pytest.mark.parametrize("name", ["psystem_2D", "shallow_sphere_fwave_2D"])
def test_no_transverse_instances_on_host_match_plain(host_kernel, name, nx,
                                                     ny, dtype, tol):
    """csrc/step2_aos.cu's psystem_2D instance (the per-cell stress staged
    from q and aux, both laws) and shallow_sphere_fwave_2D instance (kappa
    inside the theta f-wave, the capacity row 1, each wave split by its
    speed's sign) against the plain step with rpt=None, over the options
    matrix; the kernel is given transverse_waves 1 and 2 too and runs none."""
    rp = triemann.ALL[name]
    deltas = (1.0 / nx, 1.0 / ny)
    q, aux = no_trans_state(nx + 3 * ny + len(name), name, nx, ny)
    q, aux = (np.ascontiguousarray(a.astype(dtype)) for a in (q, aux))
    dt = float(dtype(0.05 * min(deltas)))
    for tw, order, lim, capa, fwave, law in NO_TRANS_OPTS:
        params = {"grav": 1.0, "stress_relation": law}
        lims = (lim,) * rp.num_waves
        out, cfl = _host_step(host_kernel, name, q, aux, dt, deltas, params,
                              lims, order, tw, fwave, capa)
        q_p, c_p = tk.step2(torch.from_numpy(q), torch.from_numpy(aux), dt,
                            *deltas, rp.rp, None, params, lims, order,
                            fwave, capa, 2, tw, None)
        _close(out, q_p.numpy(), cfl, float(c_p), tol)


def test_new_instances_are_registered(host_kernel):
    """The build takes the six systems and five limiter ids, as the
    wrapper passes them; an unknown system id is refused."""
    assert host_kernel.step2_aos_num_systems() == len(tiled2d.AOS_SYSTEMS)
    assert host_kernel.step2_aos_limiter_ids() == tiled2d.AOS_LIMITERS
    assert tiled2d.aos_limiter_count(host_kernel) == tiled2d.AOS_LIMITERS
    assert tiled2d.aos_system_params(triemann.euler_5wave_2D,
                                     EULER_PARAMS) == (1.4 - 1.0, 0.0)
    assert tiled2d.aos_system_params(triemann.sw_aug_2D,
                                     SW_AUG_PARAMS) == (9.8, 1e-3)
    q, aux = euler_state(0, 7, 5, 4)
    q, aux = np.ascontiguousarray(q), np.ascontiguousarray(aux)
    out = np.empty((4, 7, 5))
    cfl_blocks = np.empty(host_kernel.step2_aos_blocks(11, 9, 1))
    rc = host_kernel.step2_aos_host_f64(
        q.ctypes.data, aux.ctypes.data, out.ctypes.data,
        cfl_blocks.ctypes.data, 11, 9, len(tiled2d.AOS_SYSTEMS), -1, 0,
        ctypes.byref(ctypes.c_double(1e-3)), 0.1, 0.1, 0.4, 0.0, 2, 2,
        *tiled2d.aos_limiter_ids((4,)))
    assert rc == -1


# ---- the redesigned psystem_2D and vc_advection_2D instances ---------------
# grids less than a tile, of one tile of either design (psystem_2D 16x32,
# vc_advection_2D 32x32, rows x columns), and k TX +- 1 by k TY -+ 1 of
# both: the tiles' edges fall one cell inside and one cell outside
BITS_GRIDS = [(7, 5), (16, 32), (32, 32), (17, 31), (33, 31), (31, 65),
              (63, 65)]
# The SHA-256 of q and the CFL of the host emulation of psystem_2D over
# NO_TRANS_OPTS and of vc_advection_2D over SCALAR_OPTS (in order) on
# BITS_GRIDS, as the generic design (12x15 / 11x16 tiles, the rpt2 parts
# and their sums in shared memory) computed them: the designs of their own
# keep its bits
BITS_DIGESTS = {
    ('psystem_2D', 7, 5, 'float64'):
        "081c985ffc5778ad3a6c0e64011690b0c4a45a02382d3920419ee3c99d13f1d9",
    ('psystem_2D', 7, 5, 'float32'):
        "d047eb6ef30f13863a217de0e79e0fa5057207cb8b8027936250d0b1c04c91a2",
    ('psystem_2D', 16, 32, 'float64'):
        "2af1204988f83c8a0540142d1cca7c10160bd481bda86883fe03efa2b84e41f7",
    ('psystem_2D', 16, 32, 'float32'):
        "3e94d8bae31d8f7751a065fb90dacadd56b35e5d0eb5699bea498c7520647881",
    ('psystem_2D', 32, 32, 'float64'):
        "19c36da3aa657b3f5371eaed5bbc689861617db8d7459822b8c65ea2c0f4087c",
    ('psystem_2D', 32, 32, 'float32'):
        "14e3fc2c4a2435c5a6b2543e5fa3f053b49ec1de966b3732808be6596f364b07",
    ('psystem_2D', 17, 31, 'float64'):
        "33943615ca6ae1f90c8a6088f1bb62483ced57d484c9b7d7f8e97e15597029bc",
    ('psystem_2D', 17, 31, 'float32'):
        "45e1c86e06cb8b666e3571500e040de5db3c1e20803a1c4c8c480aabcdb3f881",
    ('psystem_2D', 33, 31, 'float64'):
        "b944565cc4867181063a08a4d56a92229d5c3d1120bdbe54df86cfdb79af4174",
    ('psystem_2D', 33, 31, 'float32'):
        "297e12330d1d72e7871384cb1e172d7202fa7cd4b46c4ed19dd2578a7861ed5a",
    ('psystem_2D', 31, 65, 'float64'):
        "88a8679d6ef431fe84d248e74b9a57f21a472733bb5de68edf3ff444a7e035b1",
    ('psystem_2D', 31, 65, 'float32'):
        "c511d1f61611731720e0cb6c998ebc27d8a5a4f9b69981775ffdcb6967734a83",
    ('psystem_2D', 63, 65, 'float64'):
        "178708ea8ab4908ef4157287acf8d6a7459e12ad948be1cd3049d411146ab8aa",
    ('psystem_2D', 63, 65, 'float32'):
        "9083091807f0b5313a39fc850eb15479a6721cbfa9cffd8cec69192c6c76a324",
    ('vc_advection_2D', 7, 5, 'float64'):
        "27f4ac138b92c63f84a16be698aae4cfec67b8a8c2d5acc99b63211ac69854ba",
    ('vc_advection_2D', 7, 5, 'float32'):
        "27fdb6dcea2e9cf991cfe1de4c6784c146a5ca26b00b962e52ca5943e453e00f",
    ('vc_advection_2D', 16, 32, 'float64'):
        "df7319bf5edf6afd80ce235578ed799ec766ba90a827ee289c60f78b1c7d37eb",
    ('vc_advection_2D', 16, 32, 'float32'):
        "25224f48d5e525dbb6cd1691e1ccecd1e375254b6ed6ccd55c645aac08e5a6f3",
    ('vc_advection_2D', 32, 32, 'float64'):
        "7ec95ec8382b5bace54c9ef5e4012cf968ca8ee7d83a4ccb9e843f29566c5d07",
    ('vc_advection_2D', 32, 32, 'float32'):
        "296fb99297a23f607f3d8acce63b0c2c8ed5ebc33e02728b5f92a3ed81f78aee",
    ('vc_advection_2D', 17, 31, 'float64'):
        "cf15abee73a1450e45a8a0f0c41145da52f6a06e7563b6beac7bfc274ab93921",
    ('vc_advection_2D', 17, 31, 'float32'):
        "a4ea30b4fb4d4ad83d3dd5b48ad63326f7a5a09d206a37d7c146e403a95d17d8",
    ('vc_advection_2D', 33, 31, 'float64'):
        "389a90a78931f455c48be456e088c1e2a9e02c237a2f19693e956f95e380f6d1",
    ('vc_advection_2D', 33, 31, 'float32'):
        "5de84810ba1659b7ba0a29248019749f47a6a1d439274b400e3886a67b4f813b",
    ('vc_advection_2D', 31, 65, 'float64'):
        "f939d76c051f0207d1a0953a8b36e943d8f359a632454c8f1bb85d02915f9ded",
    ('vc_advection_2D', 31, 65, 'float32'):
        "c11e2f75384bf1697c05915d0d5a0e5c2d757de5f88fb01f933d262b6bbb5637",
    ('vc_advection_2D', 63, 65, 'float64'):
        "4909e1dfab89d6caabca07b328a4f2bd2030171534631a5236122a592d41a66f",
    ('vc_advection_2D', 63, 65, 'float32'):
        "9680b9bf4044c5f463883cf5963daa8c9e50c8c3657e75bd23057fb31034ad9b",
}


def bits_digest(lib, name, nx, ny, dtype):
    """The SHA-256 of q and the CFL of ``lib``'s host emulation of system
    ``name`` (psystem_2D or vc_advection_2D) over its options on an nx x ny
    grid, and each option's (q, CFL, the plain step's q and CFL)."""
    import hashlib
    digest = hashlib.sha256()
    rp = triemann.ALL[name]
    deltas = (1.0 / nx, 1.0 / ny)
    if name == "psystem_2D":
        q, aux = no_trans_state(nx + 3 * ny + len(name), name, nx, ny)
        opts = [(tw, order, lim, capa, fwave,
                 {"grav": 1.0, "stress_relation": law}, None)
                for tw, order, lim, capa, fwave, law in NO_TRANS_OPTS]
    else:
        q, aux = scalar_state(nx + 3 * ny + len(name), name, nx, ny)
        opts = [(tw, order, lim, capa, fwave, SCALAR_PARAMS, rp.rpt)
                for tw, order, lim, capa, fwave in SCALAR_OPTS]
    q, aux = (np.ascontiguousarray(a.astype(dtype)) for a in (q, aux))
    dt = float(dtype(0.05 * min(deltas)))
    runs = []
    for tw, order, lim, capa, fwave, params, rpt in opts:
        lims = (lim,) * rp.num_waves
        out, cfl = _host_step(lib, name, q, aux, dt, deltas, params, lims,
                              order, tw, fwave, capa)
        q_p, c_p = tk.step2(torch.from_numpy(q), torch.from_numpy(aux), dt,
                            *deltas, rp.rp, rpt, params, lims, order, fwave,
                            capa, 2, tw, rp.prefactor if rpt else None)
        _euler_digest(digest, out, cfl, dtype)
        runs.append((out, cfl, q_p.numpy(), float(c_p)))
    return digest.hexdigest(), runs


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("nx,ny", BITS_GRIDS)
@pytest.mark.parametrize("name", ["psystem_2D", "vc_advection_2D"])
def test_redesigned_instances_keep_their_bits(host_kernel, name, nx, ny,
                                              dtype, tol):
    """csrc/step2_aos.cu's psystem_2D and vc_advection_2D instances (each a
    design of its own) against the plain version over their options
    (every transverse_waves, order 1 and 2, capacity, f-waves, both stress
    laws), and their q and CFL bit for bit those of the generic design
    (BITS_DIGESTS) on grids that straddle their tiles."""
    digest, runs = bits_digest(host_kernel, name, nx, ny, dtype)
    for out, cfl, q_p, c_p in runs:
        _close(out, q_p, cfl, c_p, tol)
    assert digest == BITS_DIGESTS[(name, nx, ny, np.dtype(dtype).name)]
