"""1D homogeneous acoustics (reference
examples/acoustics_1d_homogeneous/acoustics_1d.py; BASELINE cfg2) — the
port's copy of the JAX package's ``examples/acoustics_1d.py``, with the
same initial condition and settings (a pressure pulse at x = 0.75 on
[0, 1], rho = K = 1, a wall on the left and extrapolation on the right,
to t = 1.0): ``ClawSolver1D(acoustics_1D)`` with the MC limiter, or
``SharpClawSolver1D`` (WENO5; ``time_integrator`` SSP104, SSP33 or
Euler).  ``setup()`` takes the JAX example's keywords plus ``device`` and
``dtype``; the device picks the kernel, so there is no
``kernel_language``.

    python -m pyclaw_tpu_torch.examples.acoustics_1d
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(nx=100, solver_type="classic", time_integrator="SSP104",
          outdir="./_output", dtype=None, device=None):
    if solver_type == "classic":
        solver = pyclaw.ClawSolver1D(riemann.acoustics_1D, device=device)
        solver.limiters = [pyclaw.limiters.tvd.MC]
    else:
        solver = pyclaw.SharpClawSolver1D(riemann.acoustics_1D,
                                          device=device)
        solver.time_integrator = time_integrator
    solver.bc_lower[:] = [pyclaw.BC.wall]
    solver.bc_upper[:] = [pyclaw.BC.extrap]

    domain = pyclaw.Domain([0.0], [1.0], [nx])
    state = pyclaw.State(domain, solver.rp.num_eqn, dtype=dtype)
    rho, bulk = 1.0, 1.0
    state.problem_data["rho"] = rho
    state.problem_data["bulk"] = bulk
    state.problem_data["zz"] = np.sqrt(rho * bulk)
    state.problem_data["cc"] = np.sqrt(bulk / rho)

    x = domain.grid.x.centers
    beta, x0 = 100.0, 0.75
    state.q[0, :] = np.exp(-beta * (x - x0) ** 2)
    state.q[1, :] = 0.0

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 1.0
    claw.num_output_times = 10
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
