"""1D linear advection (reference examples/advection_1d/advection_1d.py;
BASELINE cfg1) — the port's copy of the JAX package's
``examples/advection_1d.py``, with the same initial condition and
settings (q_t + u q_x = 0 on [0, 1] with u = 1, a Gaussian pulse,
periodic BCs, to t = 1.0, when the exact solution equals the initial
one): ``ClawSolver1D(advection_1D)`` with the van Leer limiter, or
``SharpClawSolver1D`` (WENO5; ``time_integrator`` SSP104, SSP33 or
Euler).  ``setup()`` takes the JAX example's keywords plus ``device`` and
``dtype``; the device picks the kernel (``csrc/step1.cu`` or
``csrc/weno5.cu`` on a card), so there is no ``kernel_language``.
``use_petsc`` is taken and, as in the JAX example, changes nothing: the
serial solver runs.

    python -m pyclaw_tpu_torch.examples.advection_1d
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(nx=100, use_petsc=False, solver_type="classic", weno_order=5,
          time_integrator="SSP104", outdir="./_output", dtype=None,
          device=None):
    if solver_type == "classic":
        solver = pyclaw.ClawSolver1D(riemann.advection_1D, device=device)
        solver.limiters = [pyclaw.limiters.tvd.vanleer]
    elif solver_type == "sharpclaw":
        solver = pyclaw.SharpClawSolver1D(riemann.advection_1D,
                                          device=device)
        solver.weno_order = weno_order
        solver.time_integrator = time_integrator
    else:
        raise ValueError(f"bad solver_type {solver_type}")
    solver.bc_lower[:] = [pyclaw.BC.periodic]
    solver.bc_upper[:] = [pyclaw.BC.periodic]

    domain = pyclaw.Domain([0.0], [1.0], [nx])
    state = pyclaw.State(domain, solver.rp.num_eqn, dtype=dtype)
    state.problem_data["u"] = 1.0

    x = domain.grid.x.centers
    beta, x0 = 100.0, 0.75
    state.q[0, :] = np.exp(-beta * (x - x0) ** 2)

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
