"""The port's SharpClaw 2D path (WENO5, Euler 4-wave) against the JAX
package's, on the CPU.

* ``limiters/recon.py:weno5_stencil``, the Euler flux and
  ``sharpclaw/soa.py:dq_2d_soa`` (the kernel's plain version) against their
  JAX counterparts, float64 and float32, on ragged grids, with both
  in-cell fluctuation branches and a state that trips the positivity
  fallback;
* one dq against ``ops/tiled2d.py:dq_pallas_rows`` in Pallas interpret
  mode at a 16x128 interior, as tests/test_pallas_backend.py runs it;
* one fixed-dt step of each integrator (Euler, SSP33, SSP104) against the
  JAX package's ``_step_fn``;
* ``Controller.run`` of the quadrants problem at 48^2 in float64 against
  the JAX run: equal step counts; to t=0.2 within 1e-6 max relative, to
  t=0.8 within 1e-4 relative L1 and 1e-2 max relative (a whole run
  amplifies one-ulp differences through the shocks: perturbing the
  initial state by one ulp moves the JAX package's own t=0.8 result by
  up to 6e-4 max relative);
* the options that were refused at setup (the other integrators,
  lim_type=1, weno_order=7, tfluct_solver, call_before_step_each_stage)
  and those that take the generic dq (char_decomp, use_soa=False, aux, a
  capacity function) give the JAX solver's fixed-dt step or run.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyclaw_tpu_torch
from pyclaw_tpu.limiters import recon as jrecon
from pyclaw_tpu.riemann import euler as je
from pyclaw_tpu.sharpclaw import soa as jsoa
from pyclaw_tpu_torch import convert
from pyclaw_tpu_torch.examples import euler_2d_quadrants as tex
from pyclaw_tpu_torch.limiters import recon as trecon
from pyclaw_tpu_torch.ops import tiled2d
from pyclaw_tpu_torch.riemann import euler as te
from pyclaw_tpu_torch.sharpclaw import soa as tsoa

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import euler_2d_quadrants as jex  # noqa: E402

PARAMS = {"gamma": 1.4}
TOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def euler_state(seed, shape, fallback=False):
    """Seeded admissible Euler state of the given cell shape.  With
    ``fallback``, 15% of the cells are near-vacuum pockets (rho = p =
    1e-3), where WENO's edge values undershoot below zero."""
    rng = np.random.default_rng(seed)
    rho = 0.5 + rng.random(shape)
    u = 0.5 * rng.standard_normal(shape)
    v = 0.5 * rng.standard_normal(shape)
    p = 0.5 + rng.random(shape)
    if fallback:
        pocket = rng.random(shape) < 0.15
        rho = np.where(pocket, 1e-3, rho)
        p = np.where(pocket, 1e-3, p)
    return np.stack([rho, rho * u, rho * v,
                     p / 0.4 + 0.5 * rho * (u * u + v * v)])


def fallback_cells(qbc):
    """Cells whose WENO edges fail the positivity test, per sweep."""
    return tsoa.fallback_count(qbc, PARAMS, te.euler_4wave_2D.positivity)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["random", "constant", "step"])
def test_weno5_stencil_matches_jax(kind, dtype):
    rng = np.random.default_rng(3)
    if kind == "random":
        v = rng.standard_normal((5, 7, 9))
    elif kind == "constant":
        v = np.full((5, 7, 9), 1.1)
    else:
        v = np.where(rng.random((5, 7, 9)) < 0.5, 0.35, 1.1)
    v = v.astype(dtype)
    lj, rj = jrecon.weno5_stencil(*[jnp.asarray(x) for x in v])
    lt, rt = trecon.weno5_stencil(*[torch.from_numpy(x) for x in v])
    tol = 1e-13 if dtype == np.float64 else 1e-6
    for a, b in ((lt, lj), (rt, rj)):
        a = a.numpy()
        assert a.dtype == dtype and np.all(np.isfinite(a))
        assert _rel(a, np.asarray(b)) <= tol


def test_weno_stencil_other_orders_raise():
    """Order 7, once refused, against the JAX function (1e-12); a stencil
    list of the wrong length raises as there."""
    v = np.random.default_rng(7).standard_normal((7, 5, 6))
    lt, rt = trecon.weno_stencil(7, [torch.from_numpy(x) for x in v])
    lj, rj = jrecon.weno_stencil(7, [jnp.asarray(x) for x in v])
    assert _rel(lt.numpy(), np.asarray(lj)) <= 1e-12
    assert _rel(rt.numpy(), np.asarray(rj)) <= 1e-12
    with pytest.raises(ValueError, match="needs 7 stencil arrays"):
        trecon.weno_stencil(7, [torch.zeros(3)] * 5)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("ixy", [0, 1])
def test_flux_matches_jax(ixy, dtype):
    q = euler_state(11 + ixy, (9, 13)).astype(dtype)
    fj = je._flux_euler_2d_soa(ixy, tuple(jnp.asarray(c) for c in q),
                               PARAMS)
    ft = te._flux_euler_2d_soa(ixy, tuple(torch.from_numpy(c) for c in q),
                               PARAMS)
    tol = 1e-15 if dtype == np.float64 else 1e-6
    for a, b in zip(ft, fj):
        assert a.dtype == torch.from_numpy(q).dtype
        assert _rel(a.numpy(), np.asarray(b)) <= tol


def _jax_dq(qbc, dt, dx, dy, flux=True):
    d, c = jsoa.dq_2d_soa(jnp.asarray(qbc), jnp.asarray(dt, qbc.dtype), dx,
                          dy, je._rpn2_euler_4wave_soa, PARAMS, 5, 3,
                          positivity=je.euler_4wave_2D.positivity,
                          flux_soa=je._flux_euler_2d_soa if flux else None)
    return np.asarray(d), float(c)


def _plain_dq(qbc, dt, dx, dy, flux=True):
    d, c = tsoa.dq_2d_soa(torch.from_numpy(qbc), dt, dx, dy,
                          te._rpn2_euler_soa, PARAMS, 5, 3,
                          positivity=te.euler_4wave_2D.positivity,
                          flux_soa=te._flux_euler_2d_soa if flux else None)
    return d.numpy(), float(c)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("flux", [True, False], ids=["flux", "riemann"])
@pytest.mark.parametrize("nx,ny,fallback", [(13, 21, False), (7, 30, False),
                                            (17, 11, True)])
def test_dq_2d_soa_matches_jax(nx, ny, fallback, flux, dtype):
    qbc = euler_state(nx * ny, (nx + 6, ny + 6), fallback).astype(dtype)
    if fallback:
        assert fallback_cells(torch.from_numpy(qbc)) > 0
    dt = float(dtype(0.3 / max(nx, ny)))
    d_j, c_j = _jax_dq(qbc, dt, 1.0 / nx, 1.0 / ny, flux)
    d_t, c_t = _plain_dq(qbc, dt, 1.0 / nx, 1.0 / ny, flux)
    assert d_t.shape == (4, nx, ny) and d_t.dtype == dtype
    assert _rel(d_t, d_j) <= TOL[dtype]
    assert abs(c_t - c_j) <= TOL[dtype] * c_j


def test_cfl_sees_the_ghost_band():
    """The CFL window spans the whole other axis, ghost cells included: a
    fast state placed only in a ghost column sets the CFL."""
    nx = ny = 10
    qbc = euler_state(5, (nx + 6, ny + 6))
    _, c0 = _plain_dq(qbc, 0.01, 0.1, 0.1)
    qbc[1, 5, 0] = 40.0 * qbc[0, 5, 0]          # u = 40 in ghost column 0
    qbc[3, 5, 0] += 0.5 * qbc[1, 5, 0] ** 2 / qbc[0, 5, 0]
    d_t, c_t = _plain_dq(qbc, 0.01, 0.1, 0.1)
    d_j, c_j = _jax_dq(qbc, 0.01, 0.1, 0.1)
    assert c_t > 2 * c0
    assert abs(c_t - c_j) <= 1e-12 * c_j and _rel(d_t, d_j) <= 1e-12


def test_wrapper_on_cpu_is_the_plain_version():
    """On a CPU tensor dq_rows computes dq_2d_soa and counts nothing."""
    qbc = euler_state(7, (15, 12))
    before = tiled2d.dq_rows.launches
    d_w, c_w = tiled2d.dq_rows(torch.from_numpy(qbc), 0.01, 1 / 9, 1 / 6,
                               PARAMS)
    d_p, c_p = _plain_dq(qbc, 0.01, 1 / 9, 1 / 6)
    assert np.array_equal(d_w.numpy(), d_p) and float(c_w) == c_p
    assert tiled2d.dq_rows.launches == before


def test_dq_matches_dq_pallas_rows_interpret():
    """One dq at a 16x128 interior, float64, against the JAX package's
    row-tiled Pallas kernel in interpret mode."""
    from pyclaw_tpu.ops import tiled2d as jtiled
    nx, ny = 16, 128
    qbc = euler_state(21, (nx + 6, ny + 6))
    rp = je.euler_4wave_2D
    d_j, c_j = jtiled.dq_pallas_rows(
        jnp.asarray(qbc), 1e-3, 1.0 / nx, 1.0 / ny, rp.rpn_soa, PARAMS, 5, 3,
        positivity=rp.positivity, flux_soa=rp.flux_soa, tile_rows=16)
    d_t, c_t = tiled2d.dq_rows(torch.from_numpy(qbc), 1e-3, 1.0 / nx,
                               1.0 / ny, PARAMS)
    d_j = np.asarray(d_j)
    assert _rel(d_t.numpy(), d_j) <= 1e-12
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)


def _port_from(jclaw):
    """Port Controller starting from the JAX controller's state and
    solver settings, through plain numpy and dicts."""
    jsol = jclaw.solution
    dom = jsol.domain.patch
    sol = convert.solution_from_arrays(
        jsol.state.q, jsol.state.problem_data, dom.lower_global,
        dom.upper_global, dom.num_cells_global, t=jsol.t)
    solver = pyclaw_tpu_torch.SharpClawSolver2D(
        pyclaw_tpu_torch.riemann.euler_4wave_2D, device="cpu")
    convert.apply_solver_settings(solver,
                                  convert.solver_settings(jclaw.solver))
    claw = pyclaw_tpu_torch.Controller()
    claw.solution = sol
    claw.solver = solver
    claw.tfinal = jclaw.tfinal
    claw.num_output_times = jclaw.num_output_times
    claw.output_format = None
    return claw


@pytest.mark.parametrize("integrator", ["Euler", "SSP33", "SSP104"])
def test_fixed_dt_step_matches_jax_step_fn(integrator):
    jclaw = jex.setup(mx=40, my=24, outdir=None, solver_type="sharpclaw",
                      time_integrator=integrator)
    jclaw.solver.setup(jclaw.solution)
    q_j, c_j = jclaw.solver._step_fn(jnp.asarray(jclaw.solution.state.q),
                                     None, 2e-3, 0.0)
    claw = _port_from(jclaw)
    assert claw.solver.time_integrator == integrator
    claw.solver.setup(claw.solution)
    assert (claw.solver.cfl_desired, claw.solver.cfl_max) == (
        jclaw.solver.cfl_desired, jclaw.solver.cfl_max)
    q_t, c_t = claw.solver._step_fn(torch.from_numpy(claw.solution.q),
                                    None, 2e-3, 0.0)
    assert _rel(q_t.numpy(), np.asarray(q_j)) <= 1e-12
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)


def _jax_run(n, tfinal):
    """The JAX package's quadrants run from t=0 to ``tfinal`` through the
    traced accept/reject loop that its Controller.run uses; returns (q,
    t, accepted, rejected)."""
    jclaw = jex.setup(mx=n, my=n, outdir=None, solver_type="sharpclaw")
    solver = jclaw.solver
    solver.setup(jclaw.solution)
    evolve = solver._make_evolve_fn(jclaw.solution.state)
    q, t, _, ns, nr, *_ = evolve(jnp.asarray(jclaw.solution.state.q), None,
                                 0.0, solver.dt, tfinal)
    return np.asarray(q), float(t), int(ns), int(nr)


@pytest.mark.parametrize("tfinal", [0.2, 0.8])
def test_controller_run_matches_jax(tfinal):
    q_j, t_j, ns_j, nr_j = _jax_run(48, tfinal)
    claw = tex.setup(mx=48, my=48, outdir=None, device="cpu",
                     solver_type="sharpclaw")
    claw.tfinal = tfinal
    claw.num_output_times = 1
    status = claw.run()
    q_t = claw.solution.q
    assert claw.solution.t == pytest.approx(tfinal)
    assert t_j == pytest.approx(tfinal)
    assert status["numsteps"] == ns_j
    assert status["numrejected"] == nr_j >= 1
    assert np.all(np.isfinite(q_t)) and claw.solution.state.is_valid()
    if tfinal <= 0.2:
        assert _rel(q_t, q_j) <= 1e-6
    else:
        assert np.abs(q_t - q_j).mean() / np.abs(q_j).mean() <= 1e-4
        assert _rel(q_t, q_j) <= 1e-2


def _set(attr, value):
    def apply(claw):
        setattr(claw.solver, attr, value)
    return apply


@pytest.mark.parametrize("apply,match", [
    (_set("time_integrator", "RK"), "time_integrator"),
    (_set("time_integrator", "SSPLMMk2"), "time_integrator"),
    (_set("time_integrator", "LMM"), "time_integrator"),
    (_set("lim_type", 1), "lim_type=1"),
    (_set("weno_order", 7), "weno_order 7-17"),
    (_set("tfluct_solver", True), "tfluct_solver"),
    (_set("call_before_step_each_stage", True),
     "call_before_step_each_stage"),
])
def test_setup_raises_for_unported_options(apply, match):
    """Each option this test once saw refused (named by the second
    column) now runs as in the JAX package, on the quadrants at 8^2 in
    float64: a one-step integrator (RK with the classical RK4 tableau)
    gives the JAX solver's fixed-dt step to 1e-12; SSPLMMk2 the JAX run's
    steps and q to t=0.05 on the host loop; LMM without coefficients the
    JAX package's ValueError."""
    claw = tex.setup(mx=8, my=8, outdir=None, device="cpu",
                     solver_type="sharpclaw")
    jclaw = jex.setup(mx=8, my=8, outdir=None, solver_type="sharpclaw")
    for c in (claw, jclaw):
        apply(c)
        if c.solver.time_integrator == "RK":
            c.solver.a = [[0, 0, 0, 0], [0.5, 0, 0, 0], [0, 0.5, 0, 0],
                          [0, 0, 1.0, 0]]
            c.solver.b = [1 / 6, 1 / 3, 1 / 3, 1 / 6]
    integrator = claw.solver.time_integrator
    if integrator == "LMM":
        errors = []
        for c in (claw, jclaw):
            with pytest.raises(ValueError) as info:
                c.solver.setup(c.solution)
            errors.append(str(info.value))
        assert errors[0] == errors[1] and "lmm_alpha" in errors[0]
        return
    if integrator == "SSPLMMk2":
        for c in (claw, jclaw):
            c.tfinal = 0.05
            c.num_output_times = 1
        status_j = jclaw.run()
        status_t = claw.run()
        assert status_t["numsteps"] == status_j["numsteps"]
        assert _rel(claw.solution.q, jclaw.solution.q) <= TOL[np.float64]
        return
    for c in (claw, jclaw):
        c.solver.setup(c.solution)
    q0 = claw.solution.state.q
    q_t, c_t = claw.solver._step_fn(torch.from_numpy(q0), None, 2e-3, 0.0)
    q_j, c_j = jclaw.solver._step_fn(jnp.asarray(q0), None, 2e-3, 0.0)
    tol = tol_cfl = TOL[np.float64]
    if claw.solver.weno_order == 7:
        # conditioned (the generic-order betas of near-constant stencils
        # are roundoff, ROADMAP.md Queue 3): held to the largest move of
        # the JAX step when q0 moves by one ulp, up or down
        moved = [jclaw.solver._step_fn(jnp.asarray(np.nextafter(q0, to)),
                                       None, 2e-3, 0.0)
                 for to in (np.inf, -np.inf)]
        tol = max(_rel(np.asarray(q), np.asarray(q_j)) for q, _ in moved)
        tol_cfl = max(abs(float(c) - float(c_j)) / float(c_j)
                      for _, c in moved)
    assert _rel(q_t.numpy(), np.asarray(q_j)) <= tol
    assert abs(float(c_t) - float(c_j)) <= tol_cfl * float(c_j)


def _aux(claw):
    claw.solution.state.aux = np.full((1, 8, 8), 0.5)


def _capacity(claw):
    x, y = claw.solution.state.grid.c_centers
    claw.solution.state.aux = (1.0 + 0.2 * np.cos(4.0 * x)
                               * np.sin(3.0 * y))[None]
    claw.solution.state.index_capa = 0


# the options that sent the quadrants off the SoA route and raised 'generic
# SharpClaw dq' until the generic dq (sharpclaw/kernels.py:dq_nd) was
# ported; aux and a capacity function were refused by every SharpClaw 2D
# solver
@pytest.mark.parametrize("apply", [
    _set("char_decomp", 2), _set("use_soa", False), _aux, _capacity],
    ids=["char_decomp", "use_soa", "aux", "capacity"])
def test_generic_route_matches_jax_step_fn(apply):
    """Each option takes the generic dq, as in the JAX package
    (``_soa_eligible`` false), and the port's fixed-dt SSP104 step equals
    the JAX solver's to 1e-12."""
    claw = tex.setup(mx=8, my=8, outdir=None, device="cpu",
                     solver_type="sharpclaw")
    jclaw = jex.setup(mx=8, my=8, outdir=None, solver_type="sharpclaw")
    for c in (claw, jclaw):
        apply(c)
        c.solver.setup(c.solution)
    state = claw.solution.state
    assert not claw.solver._soa_eligible(state)
    assert not jclaw.solver._soa_eligible(jclaw.solution.state)
    aux = state.aux
    q_t, c_t = claw.solver._step_fn(
        torch.from_numpy(state.q),
        None if aux is None else torch.from_numpy(aux), 2e-3, 0.0)
    q_j, c_j = jclaw.solver._step_fn(
        jnp.asarray(state.q), None if aux is None else jnp.asarray(aux),
        2e-3, 0.0)
    assert _rel(q_t.numpy(), np.asarray(q_j)) <= TOL[np.float64]
    assert abs(float(c_t) - float(c_j)) <= TOL[np.float64] * float(c_j)
