"""The 1D slice end to end on the CPU: the examples of BASELINE cfg1-2
(advection, acoustics, the Sod shock tube) on ClawSolver1D and
SharpClawSolver1D, the port against the JAX package.

* the five 1D goldens (tests/golden/*.npz) in float64, 1e-8 of max|q|;
* the Sod runs at nx = 200 to t = 0.2 in one frame, classic and
  SharpClaw SSP104, against the traced accept/reject loop of the JAX
  package: the same accepted and rejected steps; q to 1e-12 of max|q|
  (classic) and 1e-7 (SharpClaw, whose run moves by 4e-9 of max|q|
  when its initial state moves by one ulp: the WENO weights and the
  positivity fallback amplify roundoff at the shock);
* one fixed-dt ClawSolver1D step with aux, a capacity function, f-waves
  and a wall, the settings carried across with convert, against the JAX
  package's ``_step_fn``;
* 1D frames: the Controller writes them, and the JAX package reads them
  back (and the port reads its own);
* what the slice refuses raises and names its ROADMAP.md item.
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
from pyclaw_tpu_torch.examples import acoustics_1d as tac
from pyclaw_tpu_torch.examples import advection_1d as tadv
from pyclaw_tpu_torch.examples import euler_1d_shocktube as tsod
from pyclaw_tpu_torch.ops import sweep, weno

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import euler_1d_shocktube as jsod  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


GOLDEN_CASES = [
    ("advection_1d", tadv, dict(nx=100, solver_type="classic")),
    ("advection_1d_sharpclaw", tadv, dict(nx=100, solver_type="sharpclaw")),
    ("acoustics_1d", tac, dict(nx=100)),
    ("euler_1d_sod", tsod, dict(nx=200, solver_type="classic")),
    ("euler_1d_sod_sharpclaw", tsod, dict(nx=200, solver_type="sharpclaw"))]


@pytest.mark.parametrize("name,example,kwargs", GOLDEN_CASES,
                         ids=[c[0] for c in GOLDEN_CASES])
def test_example_matches_golden(name, example, kwargs):
    ref = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    claw = example.setup(outdir=None, device="cpu", **kwargs)
    before = (sweep.step1.launches, weno.weno5.launches)
    status = claw.run()
    assert (sweep.step1.launches, weno.weno5.launches) == before  # plain
    assert abs(claw.solution.t - float(ref["t"])) < 1e-10
    q = claw.solution.q
    assert q.dtype == np.float64 and q.shape == ref["q"].shape
    assert np.abs(q - ref["q"]).max() / np.abs(ref["q"]).max() <= 1e-8
    # the first step, at dt_initial=0.1, is rejected
    assert status["numrejected"] >= 1 and status["numsteps"] > 10


@pytest.mark.parametrize("solver_type,tol", [("classic", 1e-12),
                                             ("sharpclaw", 1e-7)])
def test_sod_matches_jax_run(solver_type, tol):
    jclaw = jsod.setup(nx=200, solver_type=solver_type, outdir=None)
    jsolver = jclaw.solver
    jsolver.setup(jclaw.solution)
    evolve = jsolver._make_evolve_fn(jclaw.solution.state)
    q_j, t_j, _, ns_j, nr_j, *_ = evolve(
        jnp.asarray(jclaw.solution.state.q), None, 0.0, jsolver.dt, 0.2)
    claw = tsod.setup(nx=200, solver_type=solver_type, outdir=None,
                      device="cpu")
    claw.num_output_times = 1
    status = claw.run()
    assert float(t_j) == pytest.approx(0.2, abs=1e-12)
    assert claw.solution.t == pytest.approx(0.2, abs=1e-12)
    assert (status["numsteps"], status["numrejected"]) == (int(ns_j),
                                                           int(nr_j))
    q_j = np.asarray(q_j)
    assert np.abs(claw.solution.q - q_j).max() / np.abs(q_j).max() <= tol


def _advection_with_capacity(pkg, nx=30):
    """A Gaussian pulse with a non-uniform capacity function in aux[0]."""
    domain = pkg.Domain([0.0], [1.0], [nx])
    state = pkg.State(domain, 1, num_aux=1)
    state.problem_data["u"] = -0.8
    x = domain.grid.x.centers
    state.q[0] = np.exp(-80.0 * (x - 0.4) ** 2)
    state.aux[0] = 1.0 + 0.4 * np.sin(7.0 * x)
    state.index_capa = 0
    return pkg.Solution(state, domain)


@pytest.mark.parametrize("fwave,lim", [(True, 4), (False, 10)])
def test_fixed_dt_step_with_capacity_matches_jax_step_fn(fwave, lim):
    jsol = _advection_with_capacity(pyclaw_tpu)
    jsolver = pyclaw_tpu.ClawSolver1D(pyclaw_tpu.riemann.advection_1D)
    jsolver.fwave = fwave
    jsolver.limiters = [lim]
    jsolver.bc_lower = [pyclaw_tpu.BC.wall]
    jsolver.bc_upper = [pyclaw_tpu.BC.extrap]
    jsolver.setup(jsol)
    state = jsol.state
    q_j, c_j = jsolver._step_fn(jnp.asarray(state.q), jnp.asarray(state.aux),
                                1e-2, 0.0)

    dom = jsol.domain.patch
    sol = convert.solution_from_arrays(
        state.q, state.problem_data, dom.lower_global, dom.upper_global,
        dom.num_cells_global, aux=state.aux, index_capa=state.index_capa)
    solver = pyclaw_tpu_torch.ClawSolver1D(
        pyclaw_tpu_torch.riemann.advection_1D, device="cpu")
    convert.apply_solver_settings(solver, convert.solver_settings(jsolver))
    assert (solver.fwave, solver.limiters, solver.bc_lower) == (
        fwave, [lim], [pyclaw_tpu_torch.BC.wall])
    solver.setup(sol)
    before = sweep.step1.launches
    q_t, c_t = solver._step_fn(torch.from_numpy(sol.state.q),
                               torch.from_numpy(sol.state.aux), 1e-2, 0.0)
    assert sweep.step1.launches == before           # CPU: the plain version
    q_j = np.asarray(q_j)
    assert np.abs(q_t.numpy() - q_j).max() <= 1e-12 * np.abs(q_j).max()
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)


def test_sharpclaw_settings_carry_across():
    jsolver = pyclaw_tpu.SharpClawSolver1D(
        pyclaw_tpu.riemann.euler_with_efix_1D)
    jsolver.time_integrator, jsolver.char_decomp = "SSP33", 2
    jsolver.weno_order, jsolver.lim_type = 7, 1
    solver = pyclaw_tpu_torch.SharpClawSolver1D(
        pyclaw_tpu_torch.riemann.euler_with_efix_1D, device="cpu")
    convert.apply_solver_settings(solver, convert.solver_settings(jsolver))
    assert (solver.time_integrator, solver.char_decomp, solver.weno_order,
            solver.lim_type) == ("SSP33", 2, 7, 1)


def test_frames_across_the_packages(tmp_path):
    """The Controller writes num_output_times + 1 ascii frames of a 1D run
    (acoustics: a wall on the left); the JAX package reads the last one
    back at the printed digits, the port bit for bit."""
    out = str(tmp_path)
    claw = tac.setup(nx=30, outdir=out, device="cpu")
    claw.num_output_times = 4
    claw.run()
    names = sorted(os.listdir(out))
    assert [n for n in names if n.startswith("fort.q")] == [
        f"fort.q{k:04d}" for k in range(5)]
    jsol = pyclaw_tpu.Solution(4, path=out, file_format="ascii")
    assert jsol.t == pytest.approx(1.0)
    np.testing.assert_allclose(jsol.state.q, claw.solution.q, rtol=1e-8,
                               atol=1e-12)
    tsol = pyclaw_tpu_torch.Solution(4, path=out, file_format="ascii")
    assert tsol.state.q.shape == (2, 30)
    np.testing.assert_array_equal(tsol.state.q, jsol.state.q)


# the options this test once saw refused; each now runs as in the JAX
# package (the third column names the option)
@pytest.mark.parametrize("attr,value,match", [
    ("lim_type", 1, "lim_type=1"),
    ("weno_order", 7, "weno_order 7-17"),
    ("time_integrator", "RK", "time_integrator"),
    ("tfluct_solver", True, "tfluct_solver")])
def test_sharpclaw_1d_refuses(attr, value, match):
    """The SharpClaw Sod tube at 64 cells in float64 with each option (RK
    with the classical RK4 tableau; tfluct_solver without a tfluct hook
    takes the Riemann fallback in both packages): the JAX run's steps and
    1e-12 of max|q| at t=0.1.  At weno_order 7 the run is conditioned (on
    near-constant stencils the generic-order betas are the cancellation
    of their quadratic forms, so the weights follow roundoff: ROADMAP.md,
    Queue 3), and the port is held at t=0.02 to the largest move of the
    JAX run when its initial state moves by one ulp (up, down, or each
    cell either way by a seed)."""
    tfinal = 0.02 if attr == "weno_order" else 0.1

    def run(mod, q0=None, **kw):
        claw = mod.setup(nx=64, solver_type="sharpclaw", outdir=None, **kw)
        setattr(claw.solver, attr, value)
        if value == "RK":
            claw.solver.a = [[0, 0, 0, 0], [0.5, 0, 0, 0], [0, 0.5, 0, 0],
                             [0, 0, 1.0, 0]]
            claw.solver.b = [1 / 6, 1 / 3, 1 / 3, 1 / 6]
        if q0 is not None:
            claw.solution.state.q = q0
        claw.tfinal = tfinal
        claw.num_output_times = 1
        return claw, claw.run()

    jclaw, status_j = run(jsod)
    claw, status_t = run(tsod, device="cpu")
    assert status_t["numsteps"] == status_j["numsteps"]
    q_j = jclaw.solution.q
    scale = np.abs(q_j).max()
    gap = np.abs(claw.solution.q - q_j).max() / scale
    if attr != "weno_order":
        assert gap <= 1e-12
        return
    q0 = jsod.setup(nx=64, solver_type="sharpclaw",
                    outdir=None).solution.state.q
    rng = np.random.default_rng(0)
    moved = [np.nextafter(q0, np.inf), np.nextafter(q0, -np.inf)] + [
        np.where(rng.random(q0.shape) < 0.5, np.nextafter(q0, np.inf),
                 np.nextafter(q0, -np.inf)) for _ in range(2)]
    moves = [np.abs(run(jsod, q)[0].solution.q - q_j).max() / scale
             for q in moved]
    assert gap <= max(moves), (gap, moves)


def test_use_petsc_runs_the_serial_solver():
    """use_petsc=True in both packages' advection example: the flag
    changes nothing, the serial classic solver runs (to t=0.2)."""
    import advection_1d as jadv
    runs = []
    for claw in (jadv.setup(nx=64, use_petsc=True, outdir=None),
                 tadv.setup(nx=64, use_petsc=True, outdir=None,
                            device="cpu")):
        claw.tfinal, claw.num_output_times = 0.2, 1
        status = claw.run()
        runs.append((np.array(claw.solution.q), status["numsteps"]))
    (q_j, ns_j), (q_t, ns_t) = runs
    assert ns_t == ns_j > 0
    assert np.abs(q_t - q_j).max() / np.abs(q_j).max() <= 1e-12


def test_what_the_slice_refuses():
    # use_petsc is taken and changes nothing, as in the JAX example: the
    # serial solver runs (test_use_petsc_runs_the_serial_solver)
    assert type(tadv.setup(nx=8, use_petsc=True, outdir=None,
                           device="cpu").solver) is pyclaw_tpu_torch.ClawSolver1D
    # before_step is taken (the host loop runs it)
    claw = tadv.setup(nx=8, outdir=None, device="cpu")
    claw.solver.before_step = lambda solver, state: None
    claw.solver.setup(claw.solution)
    # a record without an rp hook
    rp = pyclaw_tpu_torch.riemann.RiemannSolver("no_rp_1D", 1, 1, 1, None)
    for cls in (pyclaw_tpu_torch.ClawSolver1D,
                pyclaw_tpu_torch.SharpClawSolver1D):
        claw = tadv.setup(nx=8, outdir=None, device="cpu")
        claw.solver = cls(rp, device="cpu")
        with pytest.raises(ValueError, match="no rp hook"):
            claw.solver.setup(claw.solution)
    # the step's options
    with pytest.raises(ValueError, match="order"):
        sweep.check_options((4,), 3, 1, 2)
