"""The shallow-water slice end to end on the CPU: the radial dam break
(BASELINE cfg3) on the generic classic CTU solver, the port against the
JAX package.

* the port's 60^2 run against tests/golden/shallow_2d_radial.npz
  (float64, 1e-8 of max|q|);
* the port against the JAX example at 48^2 to t = 1.0 in float64: the
  same accepted and rejected steps, 1e-10 of max|q|;
* one fixed-dt solver step from a state with bathymetry and a capacity
  function carried across with pyclaw_tpu_torch.convert, against the JAX
  package's ``_step_fn``;
* a lake at rest over a bump (bathymetry f-waves) stays at rest to
  roundoff;
* ascii frames with aux across the two packages;
* what the slice still refuses, and the quadrants off the SoA route.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyclaw_tpu
import pyclaw_tpu_torch
from pyclaw_tpu_torch import convert
from pyclaw_tpu_torch.examples import shallow_2d_radial as tex
from pyclaw_tpu_torch.ops import tiled2d

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import shallow_2d_radial as jex  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_radial_dam_break_matches_golden():
    ref = np.load(os.path.join(GOLDEN, "shallow_2d_radial.npz"))
    claw = tex.setup(mx=60, my=60, outdir=None, device="cpu")
    status = claw.run()
    assert abs(claw.solution.t - float(ref["t"])) < 1e-10
    q = claw.solution.q
    assert np.abs(q - ref["q"]).max() / np.abs(ref["q"]).max() <= 1e-8
    # the first step, at dt_initial=0.1, is rejected
    assert status["numrejected"] >= 1 and status["numsteps"] > 10
    assert claw.solution.state.is_valid()


def test_radial_dam_break_matches_jax_run():
    """To t = 1.0 in one frame, against the traced accept/reject loop that
    the JAX package's Controller.run uses."""
    jclaw = jex.setup(mx=48, my=48, outdir=None)
    jsolver = jclaw.solver
    jsolver.setup(jclaw.solution)
    evolve = jsolver._make_evolve_fn(jclaw.solution.state)
    q_j, t_j, _, ns_j, nr_j, *_ = evolve(
        jnp.asarray(jclaw.solution.state.q), None, 0.0, jsolver.dt, 1.0)
    claw = tex.setup(mx=48, my=48, outdir=None, device="cpu")
    claw.num_output_times = 1
    status = claw.run()
    assert float(t_j) == pytest.approx(1.0, abs=1e-12)
    assert claw.solution.t == pytest.approx(1.0, abs=1e-12)
    assert (status["numsteps"], status["numrejected"]) == (int(ns_j),
                                                           int(nr_j))
    assert status["numrejected"] >= 1
    q_j = np.asarray(q_j)
    assert np.abs(claw.solution.q - q_j).max() / np.abs(q_j).max() <= 1e-10


def _bump_state(pkg, mx, my, capacity):
    """A perturbed lake over a Gaussian bump, aux[0] = b and, with
    ``capacity``, a non-uniform kappa in aux[1] (index_capa = 1)."""
    domain = pkg.Domain([-1.0, -1.0], [1.0, 1.0], [mx, my])
    state = pkg.State(domain, 3, num_aux=2 if capacity else 1)
    state.problem_data["grav"] = 9.8
    x, y = domain.grid.c_centers
    b = 0.5 * np.exp(-10.0 * (x ** 2 + y ** 2))
    state.aux[0] = b
    if capacity:
        state.aux[1] = 1.0 + 0.3 * np.sin(3.0 * x) * np.cos(2.0 * y)
        state.index_capa = 1
    eta = 1.0 + 0.05 * np.exp(-50.0 * ((x + 0.4) ** 2 + y ** 2))
    state.q[0] = eta - b
    state.q[1] = 0.1 * state.q[0]
    state.q[2] = 0.0
    return pkg.Solution(state, domain)


@pytest.mark.parametrize("capacity", [False, True])
def test_fixed_dt_step_with_aux_matches_jax_step_fn(capacity):
    jsol = _bump_state(pyclaw_tpu, 24, 20, capacity)
    jsolver = pyclaw_tpu.ClawSolver2D(
        pyclaw_tpu.riemann.shallow_bathymetry_fwave_2D)
    jsolver.fwave = True
    jsolver.limiters = [pyclaw_tpu.limiters.tvd.MC]
    jsolver.aux_bc_lower = [pyclaw_tpu.BC.wall, pyclaw_tpu.BC.extrap]
    jsolver.bc_upper = [pyclaw_tpu.BC.wall, pyclaw_tpu.BC.extrap]
    jsolver.setup(jsol)
    state = jsol.state
    q_j, c_j = jsolver._step_fn(jnp.asarray(state.q), jnp.asarray(state.aux),
                                2e-3, 0.0)

    dom = jsol.domain.patch
    sol = convert.solution_from_arrays(
        state.q, state.problem_data, dom.lower_global, dom.upper_global,
        dom.num_cells_global, aux=state.aux, index_capa=state.index_capa)
    solver = pyclaw_tpu_torch.ClawSolver2D(
        pyclaw_tpu_torch.riemann.shallow_bathymetry_fwave_2D, device="cpu")
    convert.apply_solver_settings(solver, convert.solver_settings(jsolver))
    assert solver.fwave and solver.aux_bc_lower[0] == pyclaw_tpu_torch.BC.wall
    solver.setup(sol)
    before = tiled2d.step2_rows_generic.launches
    q_t, c_t = solver._step_fn(torch.from_numpy(sol.state.q),
                               torch.from_numpy(sol.state.aux), 2e-3, 0.0)
    assert tiled2d.step2_rows_generic.launches == before   # CPU: plain
    q_j = np.asarray(q_j)
    assert np.abs(q_t.numpy() - q_j).max() / np.abs(q_j).max() <= 1e-12
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)


def test_lake_at_rest_stays_at_rest():
    sol = _bump_state(pyclaw_tpu_torch, 40, 40, capacity=False)
    state = sol.state
    state.q[0] = 1.0 - state.aux[0]
    state.q[1] = 0.0
    solver = pyclaw_tpu_torch.ClawSolver2D(
        pyclaw_tpu_torch.riemann.shallow_bathymetry_fwave_2D, device="cpu")
    solver.fwave = True
    solver.limiters = [pyclaw_tpu_torch.limiters.tvd.MC]
    solver.all_bcs = pyclaw_tpu_torch.BC.extrap
    claw = pyclaw_tpu_torch.Controller()
    claw.solution, claw.solver = sol, solver
    claw.tfinal, claw.num_output_times = 0.3, 1
    claw.output_format = None
    status = claw.run()
    assert status["numsteps"] > 5
    eta = claw.solution.q[0] + claw.solution.aux[0]
    assert np.abs(eta - 1.0).max() < 1e-13
    assert np.abs(claw.solution.q[1:]).max() < 1e-13


def test_aux_frames_across_the_packages(tmp_path):
    """The port writes a frame with aux that the JAX package reads, and
    reads the JAX package's back, bit for bit at the printed digits."""
    out = str(tmp_path)
    sol = _bump_state(pyclaw_tpu_torch, 12, 10, capacity=True)
    sol.write(0, path=out, write_aux=True)
    jsol = pyclaw_tpu.Solution(0, path=out, file_format="ascii",
                               read_aux=True)
    np.testing.assert_allclose(jsol.state.aux, sol.state.aux, rtol=1e-8)
    np.testing.assert_allclose(jsol.state.q, sol.state.q, rtol=1e-8,
                               atol=1e-12)
    jsol.write(1, path=out, write_aux=True)
    tsol = pyclaw_tpu_torch.Solution(1, path=out, file_format="ascii",
                                     read_aux=True)
    assert tsol.state.num_aux == 2
    np.testing.assert_array_equal(tsol.state.aux, jsol.state.aux)
    np.testing.assert_array_equal(tsol.state.q, jsol.state.q)


def test_what_the_slice_refuses():
    # the SharpClaw route runs (the generic dq with the flux and
    # positivity hooks) and gives the JAX example's run
    claw = tex.setup(mx=8, my=8, outdir=None, device="cpu",
                     solver_type="sharpclaw", dtype=np.float64)
    jclaw = jex.setup(mx=8, my=8, outdir=None, solver_type="sharpclaw")
    assert claw.run()["numsteps"] == jclaw.run()["numsteps"]
    q_j = np.asarray(jclaw.solution.q)
    assert np.abs(claw.solution.q - q_j).max() <= 1e-12 * np.abs(q_j).max()
    # the Euler system off the SoA route (use_soa=False) takes the generic
    # classic step (rpt2_euler with the shared Roe average), as the JAX
    # package does, and gives the JAX example's run
    from pyclaw_tpu_torch.examples import euler_2d_quadrants as qex
    import euler_2d_quadrants as jqex
    claw = qex.setup(mx=8, my=8, outdir=None, device="cpu",
                     dtype=np.float64)
    jclaw = jqex.setup(mx=8, my=8, outdir=None)
    claw.solver.use_soa = jclaw.solver.use_soa = False
    assert claw.run()["numsteps"] == jclaw.run()["numsteps"]
    assert not claw.solver._soa_eligible(claw.solution.state)
    q_j = np.asarray(jclaw.solution.q)
    assert np.abs(claw.solution.q - q_j).max() <= 1e-12 * np.abs(q_j).max()
    # SharpClaw takes aux: with it the quadrants leave the SoA route for
    # the generic dq, the same numerics (Euler reads no aux)
    claws = [qex.setup(mx=8, my=8, outdir=None, device="cpu",
                       solver_type="sharpclaw") for _ in range(2)]
    claws[1].solution.state.aux = np.ones((1, 8, 8))
    steps = [c.run()["numsteps"] for c in claws]
    assert not claws[1].solver._soa_eligible(claws[1].solution.state)
    assert steps[0] == steps[1] >= 2
    q_soa = claws[0].solution.q
    assert (np.abs(claws[1].solution.q - q_soa).max()
            <= 1e-12 * np.abs(q_soa).max())
    # a capacity row that is not in aux
    claw = tex.setup(mx=8, my=8, outdir=None, device="cpu")
    claw.solution.state.index_capa = 0
    with pytest.raises(ValueError, match="index_capa"):
        claw.solver.setup(claw.solution)
