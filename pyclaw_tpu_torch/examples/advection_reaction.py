"""Advection-reaction, q_t + u q_x = -lambda q on [0, 1] (u = 1, periodic;
exact solution exp(-lambda t) q0(x - u t)) — the port's copy of the JAX
package's ``examples/advection_reaction.py``, with the same initial
condition (a Gaussian pulse at x = 0.5) and settings, to t = 1.0.  It
exercises the source hooks: ``solver_type="classic"`` runs
``ClawSolver1D(advection_1D)`` (MC) with a ``step_source`` (the exact
decay factor over dt) split Godunov (``source_split=1``) or Strang (2,
the default) around the step (``csrc/step1.cu`` on a card, the source
in the device loop's graphs); ``solver_type="sharpclaw"`` runs
``SharpClawSolver1D(advection_1D)`` (WENO5, SSP104) with the semidiscrete
``dq_src`` = -lambda q (``csrc/weno5.cu`` on a card).  ``setup()`` takes
the JAX example's keywords plus ``device`` and ``dtype``; the device
picks the kernel, so there is no ``kernel_language``.

    python -m pyclaw_tpu_torch.examples.advection_reaction
"""

import numpy as np
import torch

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(nx=200, lam=1.0, solver_type="classic", source_split=2,
          outdir="./_output", dtype=None, device=None):
    if solver_type == "classic":
        solver = pyclaw.ClawSolver1D(riemann.advection_1D, device=device)
        solver.limiters = [pyclaw.limiters.tvd.MC]
        solver.source_split = source_split

        def step_source(solver, state, q, dt):
            # the exact integrator of q_t = -lam q over dt (a 0-d tensor)
            return q * torch.exp(-lam * dt)

        solver.step_source = step_source
    else:
        solver = pyclaw.SharpClawSolver1D(riemann.advection_1D,
                                          device=device)

        def dq_src(solver, state, q, dt, t):
            return -lam * q

        solver.dq_src = dq_src
    solver.all_bcs = pyclaw.BC.periodic

    domain = pyclaw.Domain([0.0], [1.0], [nx])
    state = pyclaw.State(domain, 1, dtype=dtype)
    state.problem_data["u"] = 1.0

    x = domain.grid.x.centers
    state.q[0, :] = np.exp(-100.0 * (x - 0.5) ** 2)

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 1.0
    claw.num_output_times = 5
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
