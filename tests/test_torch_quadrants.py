"""The slice end to end on the CPU: 2D Euler quadrants on the classic CTU
solver, the port against the JAX package.

* one fixed-dt solver step from identical state (carried across with
  pyclaw_tpu_torch.convert), against the JAX package's ``_step_fn``;
* the full ``Controller.run`` at 80^2 and 128^2 against the golden arrays,
  with tests/test_golden.py's tolerance;
* ascii frames across the two packages: a frame the JAX package wrote,
  read by the port and restarted; a frame the port wrote, read by the JAX
  package.
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
from pyclaw_tpu_torch.examples import euler_2d_quadrants as tex

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import euler_2d_quadrants as jex  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _port_from(jclaw):
    """Port Controller starting from the JAX controller's state and
    solver settings, through plain numpy and dicts."""
    jsol = jclaw.solution
    dom = jsol.domain.patch
    sol = convert.solution_from_arrays(
        jsol.state.q, jsol.state.problem_data, dom.lower_global,
        dom.upper_global, dom.num_cells_global, t=jsol.t)
    solver = pyclaw_tpu_torch.ClawSolver2D(
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


def test_fixed_dt_step_matches_jax_step_fn():
    jclaw = jex.setup(mx=40, my=24, outdir=None)
    jclaw.solver.setup(jclaw.solution)
    q_j, c_j = jclaw.solver._step_fn(jnp.asarray(jclaw.solution.state.q),
                                     None, 2e-3, 0.0)
    claw = _port_from(jclaw)
    claw.solver.setup(claw.solution)
    q_t, c_t = claw.solver._step_fn(torch.from_numpy(claw.solution.q),
                                    None, 2e-3, 0.0)
    q_j = np.asarray(q_j)
    assert np.abs(q_t.numpy() - q_j).max() / np.abs(q_j).max() <= 1e-12
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)


@pytest.mark.parametrize("n,name", [(80, "euler_2d_quadrants"),
                                    (128, "euler_2d_quadrants_128")])
def test_controller_run_matches_golden(n, name):
    ref = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    claw = tex.setup(mx=n, my=n, outdir=None, device="cpu")
    status = claw.run()
    assert abs(claw.solution.t - float(ref["t"])) < 1e-10
    scale = np.max(np.abs(ref["q"]))
    np.testing.assert_allclose(claw.solution.q, ref["q"], atol=1e-6 * scale,
                               rtol=1e-6)
    # the first step, at dt_initial=0.1, is rejected (CFL ~ 9)
    assert status["numrejected"] >= 1 and status["numsteps"] > 100
    assert claw.solution.state.is_valid()


def test_restart_from_jax_ascii_frame(tmp_path):
    """The JAX package writes frames; the port reads frame 1 and runs on
    to tfinal; the JAX package does the same from the same frame."""
    out = str(tmp_path / "jax")
    jclaw = jex.setup(mx=24, my=20, outdir=out)
    jclaw.num_output_times = 2
    jclaw.run()

    tsol = pyclaw_tpu_torch.Solution(1, path=out, file_format="ascii")
    jsol = pyclaw_tpu.Solution(1, path=out, file_format="ascii")
    assert tsol.t == jsol.t == pytest.approx(0.4)
    np.testing.assert_array_equal(tsol.q, jsol.q)

    runs = []
    for pkg, sol in ((pyclaw_tpu_torch, tsol), (pyclaw_tpu, jsol)):
        kw = {"device": "cpu"} if pkg is pyclaw_tpu_torch else {}
        solver = pkg.ClawSolver2D(pkg.riemann.euler_4wave_2D, **kw)
        convert.apply_solver_settings(
            solver, convert.solver_settings(jclaw.solver))
        sol.state.problem_data["gamma"] = 1.4
        claw = pkg.Controller()
        claw.solution, claw.solver = sol, solver
        claw.tfinal, claw.num_output_times = 0.8, 1
        claw.output_format = None
        claw.run()
        runs.append(claw.solution.q.copy())
    assert np.abs(runs[0] - runs[1]).max() / np.abs(runs[1]).max() <= 1e-12


def test_port_ascii_frame_read_by_jax(tmp_path):
    out = str(tmp_path / "port")
    claw = tex.setup(mx=16, my=12, outdir=out, device="cpu")
    claw.num_output_times = 2
    claw.run()
    jsol = pyclaw_tpu.Solution(2, path=out, file_format="ascii")
    assert jsol.t == pytest.approx(0.8)
    q = claw.solution.q
    # %18.8e fields: 9 significant digits
    np.testing.assert_allclose(jsol.q, q, rtol=1e-8, atol=1e-12)
