"""2D acoustics (the other half of BASELINE cfg3) on the port's generic
classic CTU solver, against the JAX package.

* ``_rp_acoustics`` (rpn2) and ``_rpt_acoustics`` (rpt2), AoS and SoA,
  against the JAX functions on seeded states, 1e-12 relative;
* one fixed-dt ``ops.tiled2d.step2_rows_generic`` step (the plain
  version of ``csrc/step2_aos.cu`` on the CPU) against the JAX package's
  ``ClawSolver2D._step_fn``, which runs acoustics on its SoA route;
* the kernel's own source, compiled for the host (its phases run block
  by block on the CPU), for the acoustics instance (two waves, where the
  shallow-water instances have three) against the plain step: several
  tiles and partial tiles, float32 and float64, every transverse_waves,
  orders 1 and 2, MC, minmod and a CFL-dependent limiter, with and
  without a capacity function;
* the 60^2 run against tests/golden/acoustics_2d.npz in float64 (1e-8);
* the accept/reject loop at 60^2: the same accepted and rejected steps as
  the JAX package's traced loop, 1e-12;
* what the example refuses.
"""

import ctypes
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyclaw_tpu import riemann as jriemann
from pyclaw_tpu_torch import riemann as triemann
from pyclaw_tpu_torch.classic import kernels as tk
from pyclaw_tpu_torch.examples import acoustics_2d as tex
from pyclaw_tpu_torch.ops import tiled2d

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import acoustics_2d as jex  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
PARAMS = {"zz": 1.3, "cc": 0.8}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _pair(seed, n=(7, 9)):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((3, *n)), rng.standard_normal((3, *n))


@pytest.mark.parametrize("ixy", [0, 1])
@pytest.mark.parametrize("params", [PARAMS, {"rho": 1.0, "bulk": 4.0}])
def test_rpn2_and_rpt2_aos_match_jax(ixy, params):
    ql, qr = _pair(ixy)
    asdq = np.random.default_rng(5 + ixy).standard_normal((3, 7, 9))
    out_t = triemann.acoustics_2D.rp(ixy, torch.from_numpy(ql),
                                     torch.from_numpy(qr), None, None, params)
    out_j = jax.jit(lambda a, b: jriemann.acoustics_2D.rp(
        ixy, a, b, None, None, params))(ql, qr)
    for a, b in zip(out_t, out_j):
        assert _rel(a.numpy(), b) <= 1e-12
    bt = triemann.acoustics_2D.rpt(ixy, 1, torch.from_numpy(ql),
                                   torch.from_numpy(qr), None, None,
                                   torch.from_numpy(asdq), params)
    bj = jax.jit(lambda a, b, c: jriemann.acoustics_2D.rpt(
        ixy, 1, a, b, None, None, c, params))(ql, qr, asdq)
    for a, b in zip(bt, bj):
        assert _rel(a.numpy(), b) <= 1e-12


@pytest.mark.parametrize("ixy", [0, 1])
def test_rpn2_and_rpt2_soa_match_jax(ixy):
    ql, qr = _pair(10 + ixy)
    asdq = np.random.default_rng(20 + ixy).standard_normal((3, 7, 9))
    qlt, qrt = tuple(torch.from_numpy(ql)), tuple(torch.from_numpy(qr))
    qlj, qrj = tuple(jnp.asarray(ql)), tuple(jnp.asarray(qr))
    (wt, st) = triemann.acoustics_2D.rpn_soa(ixy, qlt, qrt, PARAMS)
    (wj, sj) = jriemann.acoustics_2D.rpn_soa(ixy, qlj, qrj, PARAMS)
    assert st == sj
    for pt, pj in zip(wt, wj):
        for ct, cj in zip(pt, pj):
            assert (ct is None) == (cj is None)
            if ct is not None:
                assert _rel(ct.numpy(), cj) <= 1e-12
    bt = triemann.acoustics_2D.rpt_soa(ixy, 0, qlt, qrt,
                                       tuple(torch.from_numpy(asdq)), PARAMS)
    bj = jriemann.acoustics_2D.rpt_soa(ixy, 0, qlj, qrj,
                                       tuple(jnp.asarray(asdq)), PARAMS)
    for side_t, side_j in zip(bt, bj):
        for ct, cj in zip(side_t, side_j):
            assert _rel(ct.numpy(), cj) <= 1e-12
    ft = triemann.acoustics_2D.flux_soa(ixy, qlt, PARAMS)
    fj = jriemann.acoustics_2D.flux_soa(ixy, qlj, PARAMS)
    for ct, cj in zip(ft, fj):
        assert (ct is None) == (cj is None)
        if ct is not None:
            assert _rel(ct.numpy(), cj) <= 1e-12


def test_fixed_dt_step_matches_jax_soa_step_fn():
    """The port's generic AoS step against the JAX package's SoA step
    (the route it takes for acoustics without aux), one fixed dt, on a
    seeded state with velocities."""
    jclaw = jex.setup(mx=24, my=20, outdir=None)
    rng = np.random.default_rng(3)
    state = jclaw.solution.state
    state.q = state.q + 0.3 * rng.standard_normal(state.q.shape)
    jsolver = jclaw.solver
    jsolver.setup(jclaw.solution)
    assert jsolver._soa_eligible(state)
    q_j, c_j = jsolver._step_fn(jnp.asarray(state.q), None, 4e-3, 0.0)

    claw = tex.setup(mx=24, my=20, outdir=None, device="cpu")
    claw.solution.state.q = np.array(state.q)
    solver = claw.solver
    solver.setup(claw.solution)
    assert not solver._soa_eligible(claw.solution.state)
    before = tiled2d.step2_rows_generic.launches
    q_t, c_t = solver._step_fn(torch.from_numpy(claw.solution.state.q),
                               None, 4e-3, 0.0)
    assert tiled2d.step2_rows_generic.launches == before  # CPU: plain
    assert _rel(q_t.numpy(), q_j) <= 1e-12
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)


# ---- the kernel's source on the host ---------------------------------------
@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    from pyclaw_tpu_torch.ops import _build
    lib = _build.build_host_emulation(
        "step2_aos", str(tmp_path_factory.mktemp("step2_aos_host")),
        opt="-O0")
    for name in ("step2_aos_host_f32", "step2_aos_host_f64"):
        fn = getattr(lib, name)
        fn.argtypes = tiled2d.AOS_ARGTYPES
        fn.restype = ctypes.c_int
    lib.step2_aos_blocks.argtypes = [ctypes.c_int] * 3
    lib.step2_aos_blocks.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("nx,ny", [(24, 20), (13, 37), (33, 5)])
@pytest.mark.parametrize("capa,tw,order,lim", [
    (-1, 2, 2, 4), (-1, 1, 2, 1), (-1, 0, 1, 4), (0, 2, 2, 10),
    (0, 1, 1, 4)])
def test_kernel_source_on_host_matches_plain(host_kernel, capa, tw, order,
                                             lim, nx, ny, dtype, tol):
    """csrc/step2_aos.cu's acoustics instance: its two-wave buffers, the
    limiter ids of two waves and the CFL fold over two speeds, against the
    plain version."""
    rng = np.random.default_rng(nx * ny + 10 * tw + lim)
    q = np.ascontiguousarray(
        rng.standard_normal((3, nx + 4, ny + 4)).astype(dtype))
    aux = np.ascontiguousarray(
        (0.7 + 0.6 * rng.random((1, nx + 4, ny + 4))).astype(dtype))
    rp = triemann.acoustics_2D
    deltas = (1.0 / nx, 1.0 / ny)
    dt = float(dtype(0.05 * min(deltas)))
    is_double = dtype == np.float64
    fn = (host_kernel.step2_aos_host_f64 if is_double
          else host_kernel.step2_aos_host_f32)
    out = np.empty((3, nx, ny), dtype)
    cfl_blocks = np.empty(host_kernel.step2_aos_blocks(nx + 4, ny + 4,
                                                       int(is_double)), dtype)
    lims = (lim,) * rp.num_waves
    rc = fn(q.ctypes.data, aux.ctypes.data, out.ctypes.data,
            cfl_blocks.ctypes.data, nx + 4, ny + 4,
            tiled2d.AOS_SYSTEMS[rp.name][0], capa, 0,
            ctypes.byref(ctypes.c_double(dt)), *deltas,
            *tiled2d.aos_system_params(rp, PARAMS), order, tw,
            *tiled2d.aos_limiter_ids(lims))
    assert rc == 0
    q_p, c_p = tk.step2(torch.from_numpy(q), torch.from_numpy(aux), dt,
                        *deltas, rp.rp, rp.rpt, PARAMS, lims, order, False,
                        capa, 2, tw)
    assert _rel(out, q_p.numpy()) <= tol
    assert abs(float(cfl_blocks.max()) - float(c_p)) <= tol * float(c_p)


def test_wrapper_passes_the_system_scalars():
    rp = triemann.acoustics_2D
    assert tiled2d.aos_system_params(rp, {"rho": 1.0, "bulk": 4.0}) == (
        2.0, 2.0)
    assert tiled2d.aos_system_params(
        triemann.shallow_roe_with_efix_2D, {"grav": 9.8}) == (9.8, 1e-8)
    assert tiled2d.aos_limiter_ids((4, 1)) == [4, 1, 1, 1, 1]
    assert tiled2d.aos_limiter_ids((4, 1), 3) == [4, 1, 1]


# ---- the slice end to end -------------------------------------------------
def test_acoustics_2d_matches_golden():
    ref = np.load(os.path.join(GOLDEN, "acoustics_2d.npz"))
    claw = tex.setup(mx=60, my=60, outdir=None, device="cpu",
                     dtype=np.float64)
    claw.run()
    assert abs(claw.solution.t - float(ref["t"])) < 1e-10
    assert _rel(claw.solution.q, ref["q"]) <= 1e-8


def test_accept_reject_loop_matches_jax():
    """To t = 0.12 in one frame at 60^2, against the traced accept/reject
    loop of the JAX package's Controller.run."""
    jclaw = jex.setup(mx=60, my=60, outdir=None)
    jsolver = jclaw.solver
    jsolver.setup(jclaw.solution)
    evolve = jsolver._make_evolve_fn(jclaw.solution.state)
    q_j, t_j, _, ns_j, nr_j, *_ = evolve(
        jnp.asarray(jclaw.solution.state.q), None, 0.0, jsolver.dt, 0.12)
    claw = tex.setup(mx=60, my=60, outdir=None, device="cpu",
                     dtype=np.float64)
    claw.num_output_times = 1
    status = claw.run()
    assert claw.solution.t == pytest.approx(float(t_j), abs=1e-12)
    assert (status["numsteps"], status["numrejected"]) == (int(ns_j),
                                                           int(nr_j))
    assert status["numrejected"] >= 1
    assert _rel(claw.solution.q, q_j) <= 1e-12


def test_what_the_example_refuses():
    """The SharpClaw route runs (the SoA dq: csrc/dq2_weno5.cu's acoustics
    instance on a card, its plain version here) and gives the JAX
    example's run, which ignores dimensional_split as the port does.  The
    classic route takes dimensional_split too (no longer refused): its x
    and y sweeps give the JAX example's split run."""
    claw = tex.setup(mx=8, my=8, outdir=None, device="cpu",
                     solver_type="sharpclaw", dtype=np.float64,
                     dimensional_split=True)
    status = claw.run()
    assert claw.solver._soa_eligible(claw.solution.state)
    jclaw = jex.setup(mx=8, my=8, outdir=None, solver_type="sharpclaw",
                      dimensional_split=True)
    assert status["numsteps"] == jclaw.run()["numsteps"]
    assert _rel(claw.solution.q, jclaw.solution.q) <= 1e-12
    claw = tex.setup(mx=8, my=8, outdir=None, device="cpu",
                     dtype=np.float64, dimensional_split=True)
    jclaw = jex.setup(mx=8, my=8, outdir=None, dimensional_split=True)
    assert claw.run()["numsteps"] == jclaw.run()["numsteps"]
    assert _rel(claw.solution.q, jclaw.solution.q) <= 1e-12
