"""The Euler capacity / f-wave slice end to end on the CPU: 3D Euler on the
generic 3D CTU step (``ClawSolver3D(euler_3D)`` with a capacity function
or the f-wave form, the configuration that runs ``csrc/step3_ctu.cu``'s
capacity and f-wave variants on the card), the port against the JAX
package.

* a JAX ``ClawSolver3D(euler_3D)`` with the slice's capacity function
  (kappa = 1 + 0.25 cos(pi x) cos(pi y) cos(pi z), index_capa 0) on the
  euler_3d state with seeded momenta, and the same with ``fwave`` and no
  aux at transverse_waves 0 and 2: its state and settings carried across
  with ``convert``, the port's ``Controller.run`` takes the same steps to
  the same result (1e-12 relative, float64), the JAX side jitted as its
  own solver runs it.

The route of the step (tests/test_torch_acoustics3d.py) and the kernel's
source on the host (tests/test_torch_step3_aos.py) are held elsewhere.
"""

import os
import sys

import numpy as np
import pytest
import torch

import pyclaw_tpu_torch
from pyclaw_tpu_torch import convert
from pyclaw_tpu_torch.examples.euler_3d import add_capacity

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import euler_3d as jex  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_claw(capacity, fwave, tw, n=(12, 11, 10)):
    """The JAX package's euler_3d controller with seeded momenta in all
    three directions and the capacity function of
    ``pyclaw_tpu_torch.examples.euler_3d.add_capacity`` or f-waves.  The
    capacity case runs at the example's CFL limits of 0.9 / 1.0; with
    f-waves they are 0.4 / 0.5: Euler's waves are not f-waves, and the
    f-wave correction form (0.5 sign(s) where the wave form has 0.5 |s|)
    drives the example's state to negative density by t = 0.1 at 0.9 /
    1.0.  It runs to t = 0.1 with f-waves and to t = 0.3 without, for at
    least three steps (a step is near 0.1 here at 0.9)."""
    jclaw = jex.setup(mx=n[0], my=n[1], mz=n[2], outdir=None)
    state = jclaw.solution.state
    rng = np.random.default_rng(9)
    state.q[1:4] = 0.2 * (rng.random(state.q[1:4].shape) - 0.5)
    state.q[4] += 0.5 * (state.q[1:4] ** 2).sum(axis=0) / state.q[0]
    if capacity:
        add_capacity(state)
    jclaw.solver.fwave = fwave
    jclaw.solver.transverse_waves = tw
    if fwave:
        jclaw.solver.cfl_desired, jclaw.solver.cfl_max = 0.4, 0.5
    jclaw.tfinal = 0.1 if fwave else 0.3
    jclaw.num_output_times = 1
    return jclaw


@pytest.mark.parametrize("capacity,fwave,tw", [(True, False, 2),
                                               (True, True, 2),
                                               (False, True, 0),
                                               (False, True, 2)])
def test_controller_run_matches_jax(capacity, fwave, tw):
    jclaw = _jax_claw(capacity, fwave, tw)
    jstate = jclaw.solution.state
    dom = jclaw.solution.domain.patch
    sol = convert.solution_from_arrays(
        jstate.q, jstate.problem_data, dom.lower_global, dom.upper_global,
        dom.num_cells_global, aux=jstate.aux, index_capa=jstate.index_capa)
    assert sol.state.index_capa == (0 if capacity else -1)
    solver = pyclaw_tpu_torch.ClawSolver3D(pyclaw_tpu_torch.riemann.euler_3D,
                                           device="cpu")
    convert.apply_solver_settings(solver, convert.solver_settings(
        jclaw.solver))
    assert solver.fwave == fwave and solver.transverse_waves == tw
    claw = pyclaw_tpu_torch.Controller()
    claw.solution = sol
    claw.solver = solver
    claw.tfinal = jclaw.tfinal
    claw.num_output_times = 1
    claw.output_format = None

    jstatus = jclaw.run()
    status = claw.run()
    assert status["numsteps"] == jstatus["numsteps"] >= 3
    q_j = np.asarray(jclaw.solution.state.q)
    q_t = claw.solution.q
    assert q_t.shape == q_j.shape == (5, 12, 11, 10)
    assert q_t.dtype == q_j.dtype == np.float64
    assert np.abs(q_t - q_j).max() / np.abs(q_j).max() <= 1e-12
    assert abs(claw.solution.t - jclaw.solution.t) <= 1e-14
    assert claw.solution.state.is_valid()

