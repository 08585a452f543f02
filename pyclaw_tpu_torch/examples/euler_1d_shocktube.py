"""Sod shock tube (reference examples/euler_1d/shocktube.py; BASELINE
cfg2) — the port's copy of the JAX package's
``examples/euler_1d_shocktube.py``, with the same initial condition and
settings (rho, p = 1, 1 left of x = 0 and 0.125, 0.1 right of it on
[-0.5, 0.5], gamma = 1.4, extrapolation BCs, to t = 0.2):
``ClawSolver1D(euler_with_efix_1D)`` with the MC limiter, or
``SharpClawSolver1D`` (WENO5 with the positivity fallback and the flux
form of the in-cell fluctuation; ``time_integrator`` SSP104, SSP33 or
Euler).  ``setup()`` takes the JAX example's keywords plus ``device`` and
``dtype``; the device picks the kernel (``csrc/step1.cu`` or
``csrc/weno5.cu`` on a card), so there is no ``kernel_language``.
``char_decomp`` (SharpClaw, 0-4) picks the reconstruction: 2 is the
golden ``euler_1d_sod_chardecomp``'s characteristic WENO, plain PyTorch
on the card too.

    python -m pyclaw_tpu_torch.examples.euler_1d_shocktube
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(nx=800, solver_type="sharpclaw", time_integrator="SSP104",
          char_decomp=0, outdir="./_output", dtype=None, device=None):
    if solver_type == "classic":
        solver = pyclaw.ClawSolver1D(riemann.euler_with_efix_1D,
                                     device=device)
        solver.limiters = [pyclaw.limiters.tvd.MC]
    else:
        solver = pyclaw.SharpClawSolver1D(riemann.euler_with_efix_1D,
                                          device=device)
        solver.time_integrator = time_integrator
        solver.char_decomp = char_decomp
    solver.all_bcs = pyclaw.BC.extrap

    domain = pyclaw.Domain([-0.5], [0.5], [nx])
    state = pyclaw.State(domain, solver.rp.num_eqn, dtype=dtype)
    gamma = 1.4
    state.problem_data["gamma"] = gamma

    x = domain.grid.x.centers
    rho = np.where(x < 0.0, 1.0, 0.125)
    p = np.where(x < 0.0, 1.0, 0.1)
    state.q[0, :] = rho
    state.q[1, :] = 0.0
    state.q[2, :] = p / (gamma - 1.0)

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 0.2
    claw.num_output_times = 10
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
