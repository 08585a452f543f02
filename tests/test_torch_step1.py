"""The port's 1D classic sweep against the JAX package's.

* ``classic/kernels.py:step1`` of the port (the plain version of
  ``csrc/step1.cu``) against ``pyclaw_tpu/classic/kernels.py:step1`` in
  float64, CFL included, to 1e-12 relative: the five 1D systems, order
  1/2, limiters MC, minmod, van Leer and one CFL-dependent id, a
  non-uniform capacity function (``index_capa=0``) and the f-wave form.
* a few cases against the JAX package's Pallas kernel ``step1_pallas``
  in interpret mode, as tests/test_pallas_backend.py runs it.
* the CUDA kernel's own source, compiled for the host (its phases run
  block by block on the CPU), against the plain version at lengths that
  span several tiles and are no multiple of the tile, and at the edges of
  its 252-cell tile, float32 and float64, with a fast state in the inner
  ghost cell of each end (inside the CFL window) and a faster one in the
  outer ghost cell (outside it); every block writes its CFL partial.  All
  sixteen systems: those that read aux rows (sw_aug_1D, the bathymetry
  f-wave, the p-system with both stress laws, the variable-coefficient
  advection and acoustics) on seeded admissible states
  (``ops/time_kernels.py:library_state``) with their rows and, where the
  case has one, a capacity row after them.
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
from pyclaw_tpu_torch.ops import sweep
from pyclaw_tpu_torch.ops.time_kernels import LIBRARY_1D, library_state

PARAMS = {"u": -0.7, "rho": 1.3, "bulk": 2.0, "gamma": 1.4}
# the physics scalars of the library systems' cases; a case's name
# "record:variant" runs the record with the variant's scalars
VARIANT_PARAMS = {"sw_aug_1D": {"grav": 9.8, "dry_tolerance": 1e-5},
                  "psystem_1D:linear": {"stress_relation": "linear"},
                  "burgers_1D:nofix": {"efix": False}}
# the first five systems, which read no aux (sw_aug_1D: tests/
# test_torch_sw_aug.py; systems 6-15: tests/test_torch_riemann_1d_library.py)
NAMES = [n for n, i in sweep.SYSTEMS_1D.items()
         if i < 6 and n not in sweep.AUX_ROWS_1D]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _state(name, n, seed, dtype=np.float64):
    """Ghost-padded q (num_eqn, n) and aux (1, n): a positive capacity
    function.  Euler states have velocities of either sign (transonic
    interfaces included)."""
    rng = np.random.default_rng(seed)
    if name.startswith("euler"):
        rho = 0.3 + rng.random(n)
        u = 1.5 * rng.standard_normal(n)
        p = 0.2 + rng.random(n)
        q = np.stack([rho, rho * u, p / 0.4 + 0.5 * rho * u * u])
    else:
        q = rng.standard_normal((2 if name == "acoustics_1D" else 1, n))
    aux = 0.7 + 0.6 * rng.random((1, n))
    return (np.ascontiguousarray(q.astype(dtype)),
            np.ascontiguousarray(aux.astype(dtype)))


def _params(case_name):
    """(record, problem_data) of a case's name."""
    name = case_name.split(":")[0]
    return name, VARIANT_PARAMS.get(case_name, LIBRARY_1D.get(name, PARAMS))


def _library_state(case_name, n, seed, dtype):
    """q (num_eqn, n) and aux: the record's aux rows, then a positive
    capacity row (index: the record's aux row count)."""
    name = case_name.split(":")[0]
    q, aux = library_state(name, n, seed)
    cap = 0.7 + 0.6 * np.random.default_rng(seed + 1).random((1, n))
    aux = cap if aux is None else np.vstack([aux, cap])
    return (np.ascontiguousarray(q.astype(dtype)),
            np.ascontiguousarray(aux.astype(dtype)))


def _plain(name, q, aux, dt, dx, lim, order, fwave, capa, g=2):
    name, params = _params(name)
    rp = triemann.ALL[name]
    qn, cfl = tk.step1(torch.from_numpy(q), torch.from_numpy(aux), dt, dx,
                       rp.rp, params, (lim,) * rp.num_waves, order, fwave,
                       capa, g)
    return qn.numpy(), float(cfl)


def _close(a, b, ca, cb, tol):
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(b).max()
    assert abs(ca - cb) <= tol * cb


CASES = ([(name, order, lim, -1, False) for name in NAMES
          for order, lim in ((1, 4), (2, 4), (2, 1), (2, 3), (2, 10))]
         + [(name, 2, lim, 0, False) for name in NAMES for lim in (4, 10)]
         + [("advection_1D", 2, 4, -1, True), ("advection_1D", 2, 10, 0, True),
            ("euler_hlle_1D", 2, 3, 0, True)])


@pytest.mark.parametrize("name,order,lim,capa,fwave", CASES)
def test_plain_step1_matches_jax_step1(name, order, lim, capa, fwave):
    n = 40
    q, aux = _state(name, n + 4, 7 * order + lim + capa)
    dt, dx = 0.1 / n, 1.0 / n
    q_t, c_t = _plain(name, q, aux, dt, dx, lim, order, fwave, capa)
    rp = jriemann.ALL[name]
    q_j, c_j = jk.step1(jnp.asarray(q), jnp.asarray(aux), dt, dx, rp.rp,
                        PARAMS, (lim,) * rp.num_waves, order, fwave, capa, 2)
    _close(q_t, np.asarray(q_j), c_t, float(c_j), 1e-12)


def test_plain_step1_takes_more_ghost_cells():
    q, aux = _state("euler_with_efix_1D", 38 + 6, 3)
    q_t, c_t = _plain("euler_with_efix_1D", q, aux, 2e-3, 1 / 38, 4, 2,
                      False, 0, g=3)
    rp = jriemann.euler_with_efix_1D
    q_j, c_j = jk.step1(jnp.asarray(q), jnp.asarray(aux), 2e-3, 1 / 38,
                        rp.rp, PARAMS, (4,) * 3, 2, False, 0, 3)
    _close(q_t, np.asarray(q_j), c_t, float(c_j), 1e-12)


@pytest.mark.parametrize("name,lim,capa,fwave", [
    ("euler_with_efix_1D", 4, -1, False), ("acoustics_1D", 10, 0, False),
    ("advection_1D", 3, 0, True)])
def test_plain_step1_matches_step1_pallas(name, lim, capa, fwave):
    from pyclaw_tpu.ops import step1_pallas
    n = 24
    q, aux = _state(name, n + 4, 5)
    rp = jriemann.ALL[name]
    q_j, c_j = step1_pallas(jnp.asarray(q), jnp.asarray(aux), 1e-2, 1 / n,
                            rp.rp, PARAMS, (lim,) * rp.num_waves, 2, fwave,
                            capa, 2)
    q_t, c_t = _plain(name, q, aux, 1e-2, 1 / n, lim, 2, fwave, capa)
    _close(q_t, np.asarray(q_j), c_t, float(c_j), 1e-12)


def test_wrapper_on_cpu_is_the_plain_version():
    q, aux = _state("euler_hlle_1D", 20, 2)
    before = sweep.step1.launches
    q_w, c_w = sweep.step1(torch.from_numpy(q), torch.from_numpy(aux), 1e-2,
                           0.05, triemann.euler_hlle_1D, PARAMS, (4, 4), 2,
                           False, 0)
    q_p, c_p = _plain("euler_hlle_1D", q, aux, 1e-2, 0.05, 4, 2, False, 0)
    assert np.array_equal(q_w.numpy(), q_p) and float(c_w) == c_p
    assert sweep.step1.launches == before


@pytest.mark.parametrize("bad", [
    dict(mthlim=(4,) * 2), dict(mthlim=(22,) * 3), dict(order=3),
    dict(num_ghost=1)])
def test_wrapper_rejects_options(bad):
    kw = dict(mthlim=(4,) * 3, order=2, num_ghost=2)
    kw.update(bad)
    with pytest.raises(ValueError):
        sweep.step1(torch.ones(3, 9, dtype=torch.float64), None, 0.01, 0.1,
                    triemann.euler_with_efix_1D, PARAMS, kw["mthlim"],
                    kw["order"], False, -1, kw["num_ghost"])


# ---- the kernel's source on the host ---------------------------------------
@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    from pyclaw_tpu_torch.ops import _build
    lib = _build.build_host_emulation(
        "step1", str(tmp_path_factory.mktemp("step1_host")))
    for name in ("step1_host_f32", "step1_host_f64"):
        fn = getattr(lib, name)
        fn.argtypes = sweep.STEP1_ARGTYPES
        fn.restype = ctypes.c_int
    lib.step1_blocks.argtypes = [ctypes.c_int] * 2
    lib.step1_blocks.restype = ctypes.c_int
    return lib


def _host(lib, name, q, aux, dt, dx, lim, order, fwave, capa, g):
    name, params = _params(name)
    rp = triemann.ALL[name]
    n = q.shape[1]
    is_double = q.dtype == np.float64
    fn = lib.step1_host_f64 if is_double else lib.step1_host_f32
    out = np.empty((rp.num_eqn, n - 2 * g), q.dtype)
    cfl_blocks = np.full(lib.step1_blocks(n, g), np.nan, q.dtype)
    lims = [lim] * rp.num_waves + [0] * (3 - rp.num_waves)
    rc = fn(q.ctypes.data, aux.ctypes.data, out.ctypes.data,
            cfl_blocks.ctypes.data, n, g, sweep.SYSTEMS_1D[name], capa,
            int(fwave), ctypes.byref(ctypes.c_double(dt)), dx,
            *sweep.system_params(rp, params), order,
            *lims)
    assert rc == 0
    # each block wrote its partial
    assert np.isfinite(cfl_blocks).all()
    return out, float(cfl_blocks.max())


def _fast_end(q, side, g):
    """An Euler state moving fast inward in the inner ghost cell of one
    end (its interface with the interior lies in the CFL window) and a
    faster one in the outer ghost cell (outside it)."""
    inner, outer = (g - 1, 0) if side == 0 else (-g, -1)
    for cell, speed in ((inner, 40.0), (outer, 80.0)):
        q[1, cell] = q[0, cell] * speed * (1.0 if side == 0 else -1.0)
        q[2, cell] = q[2, cell] + 0.5 * q[1, cell] ** 2 / q[0, cell]
    return q


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
# 251, 252, 253 and 505: one cell short of, equal to and one past the
# 252-cell tile (csrc/step1.cu: TILE), and two tiles and a cell
@pytest.mark.parametrize("n", [1, 7, 300, 513, 251, 252, 253, 505])
@pytest.mark.parametrize("case", [
    ("euler_with_efix_1D", 2, 4, -1, False, 2, None),
    ("euler_with_efix_1D", 2, 10, 0, False, 3, 1),
    ("euler_roe_1D", 1, 4, 0, False, 2, 0),
    ("euler_hlle_1D", 2, 3, -1, False, 2, 1),
    ("acoustics_1D", 2, 4, 0, False, 2, None),
    ("advection_1D", 2, 10, 0, True, 2, None),
    ("advection_1D", 2, 1, -1, False, 4, None),
    # the systems with aux rows and the library systems (ids 5-15); a
    # capacity case's capacity row follows the system's aux rows
    ("sw_aug_1D", 2, 1, -1, True, 2, None),
    ("sw_aug_1D", 2, 4, 0, True, 3, None),
    ("shallow_roe_with_efix_1D", 2, 4, -1, False, 2, None),
    ("shallow_hlle_1D", 2, 10, 0, False, 2, None),
    ("shallow_bathymetry_fwave_1D", 2, 3, 0, True, 2, None),
    ("psystem_1D", 2, 3, -1, True, 2, None),
    ("psystem_1D:linear", 1, 4, 0, True, 3, None),
    ("vc_advection_1D", 2, 4, 0, False, 2, None),
    ("vc_advection_fwave_1D", 2, 10, -1, True, 2, None),
    ("acoustics_variable_1D", 2, 4, 0, False, 2, None),
    ("burgers_1D", 2, 3, -1, False, 2, None),
    ("burgers_1D:nofix", 2, 4, 0, True, 2, None),
    ("traffic_1D", 2, 3, 0, True, 2, None),
    ("mhd_1D", 2, 4, -1, False, 2, None),
    ("mhd_1D", 2, 1, 0, True, 2, None)], ids=str)
def test_kernel_source_on_host_matches_plain(host_kernel, case, n, dtype,
                                             tol):
    """csrc/step1.cu's phases (tiles, halos, ragged-edge masks, the
    limiter's neighbour waves across tile edges, the capacity
    coefficients, the CFL window) against the plain version."""
    name, order, lim, capa, fwave, g, fast = case
    record = name.split(":")[0]
    if record in sweep.SYSTEMS_1D and record in (*LIBRARY_1D, "sw_aug_1D"):
        q, aux = _library_state(name, n + 2 * g, n + g, dtype)
        capa = capa if capa < 0 else sweep.AUX_ROWS_1D.get(record, 0) + capa
    else:
        q, aux = _state(name, n + 2 * g, n + g, dtype)
    if fast is not None:
        q = _fast_end(q.astype(np.float64), fast, g).astype(dtype)
    dx = 1.0 / max(n, 10)
    dt = float(dtype(0.02 * dx))
    out, c_k = _host(host_kernel, name, q, aux, dt, dx, lim, order, fwave,
                     capa, g)
    q_p, c_p = _plain(name, q, aux, dt, dx, lim, order, fwave, capa, g)
    _close(out, q_p, c_k, c_p, tol)
    if fast is not None:
        # the fast inner ghost cell sets the CFL: its window is the one
        # pinned
        q0, _ = _state(name, n + 2 * g, n + g, dtype)
        assert c_p > 1.2 * _plain(name, q0, aux, dt, dx, lim, order, fwave,
                                  capa, g)[1]
