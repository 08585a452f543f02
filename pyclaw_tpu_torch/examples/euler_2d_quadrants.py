"""2D Euler Riemann-quadrants problem, configuration 4 (reference
examples/euler_2d/quadrants.py) — the port's copy of the JAX package's
``examples/euler_2d_quadrants.py``, with the same initial condition and
``setup()`` keywords plus ``device``: the classic CTU solver or SharpClaw
WENO5 with ``time_integrator`` SSP104 (default), SSP33 or Euler.  The
device picks the kernel, so there is no ``kernel_language``.

    python -m pyclaw_tpu_torch.examples.euler_2d_quadrants
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(mx=200, my=200, solver_type="classic", time_integrator="SSP104",
          outdir="./_output", dtype=None, device=None):
    if solver_type == "classic":
        solver = pyclaw.ClawSolver2D(riemann.euler_4wave_2D, device=device)
        solver.limiters = [pyclaw.limiters.tvd.vanleer]
    else:
        solver = pyclaw.SharpClawSolver2D(riemann.euler_4wave_2D,
                                          device=device)
        solver.time_integrator = time_integrator
    solver.all_bcs = pyclaw.BC.extrap

    domain = pyclaw.Domain([0.0, 0.0], [1.0, 1.0], [mx, my])
    state = pyclaw.State(domain, solver.rp.num_eqn, dtype=dtype)
    gamma = 1.4
    state.problem_data["gamma"] = gamma

    # Riemann-quadrants configuration 4 initial data
    x, y = domain.grid.c_centers
    l = x < 0.8
    b = y < 0.8
    rho = np.where(l & b, 1.1, np.where(~l & b, 0.5065,
                   np.where(l & ~b, 0.5065, 1.1)))
    u = np.where(l & b, 0.8939, np.where(~l & b, 0.0,
                 np.where(l & ~b, 0.8939, 0.0)))
    v = np.where(l & b, 0.8939, np.where(~l & b, 0.8939,
                 np.where(l & ~b, 0.0, 0.0)))
    p = np.where(l & b, 1.1, np.where(~l & b, 0.35,
                 np.where(l & ~b, 0.35, 1.1)))

    state.q[0] = rho
    state.q[1] = rho * u
    state.q[2] = rho * v
    state.q[3] = p / (gamma - 1.0) + 0.5 * rho * (u ** 2 + v ** 2)

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 0.8
    claw.num_output_times = 4
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
