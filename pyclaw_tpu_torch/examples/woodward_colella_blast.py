"""Woodward-Colella interacting blast waves (reference
examples/euler_1d/woodward_colella_blast.py) — the port's copy of the JAX
package's ``examples/woodward_colella_blast.py``, with the same initial
condition and settings: 1D Euler, gamma 1.4, rho = 1 at rest on [0, 1]
with p = 1000 left of x = 0.1, 100 right of x = 0.9 and 0.01 between,
reflecting walls at both ends through custom BC callbacks (the ghost
cells mirror the interior, the momentum negated: ``wall_bc_lower``,
``wall_bc_upper``, in torch on the ghost array's device, in place, so
the device loop captures them), to t = 0.038.  ``SharpClawSolver1D``
(the default: WENO5, SSP33, the positivity fallback; ``csrc/weno5.cu``
on a card), or ``ClawSolver1D`` with the MC limiter (``csrc/step1.cu``'s
Euler system with the entropy fix).  ``setup()`` takes the JAX example's
keywords plus ``device`` and ``dtype``; the device picks the kernel, so
there is no ``kernel_language``.

    python -m pyclaw_tpu_torch.examples.woodward_colella_blast
"""

import numpy as np
import torch

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def wall_bc_lower(state, dim, t, qbc, auxbc, num_ghost):
    """Reflecting wall: the ghost cells mirror the first interior cells,
    the momentum negated."""
    g = num_ghost
    band = torch.flip(qbc[:, g:2 * g], dims=(1,))
    band[1] *= -1.0
    qbc[:, :g] = band
    return qbc


def wall_bc_upper(state, dim, t, qbc, auxbc, num_ghost):
    g = num_ghost
    band = torch.flip(qbc[:, -2 * g:-g], dims=(1,))
    band[1] *= -1.0
    qbc[:, -g:] = band
    return qbc


def setup(nx=800, solver_type="sharpclaw", outdir="./_output", dtype=None,
          device=None):
    if solver_type == "classic":
        solver = pyclaw.ClawSolver1D(riemann.euler_with_efix_1D,
                                     device=device)
        solver.limiters = [pyclaw.limiters.tvd.MC]
    else:
        solver = pyclaw.SharpClawSolver1D(riemann.euler_with_efix_1D,
                                          device=device)
        solver.time_integrator = "SSP33"
    solver.bc_lower = [pyclaw.BC.custom]
    solver.bc_upper = [pyclaw.BC.custom]
    solver.user_bc_lower = wall_bc_lower
    solver.user_bc_upper = wall_bc_upper

    domain = pyclaw.Domain([0.0], [1.0], [nx])
    state = pyclaw.State(domain, solver.rp.num_eqn, dtype=dtype)
    gamma = 1.4
    state.problem_data["gamma"] = gamma

    x = domain.grid.x.centers
    p = np.where(x < 0.1, 1000.0, np.where(x > 0.9, 100.0, 0.01))
    state.q[0, :] = 1.0
    state.q[1, :] = 0.0
    state.q[2, :] = p / (gamma - 1.0)

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 0.038
    claw.num_output_times = 10
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
