"""Brio-Wu MHD shock tube (reference riemann mhd_1D solver) — the port's
copy of the JAX package's ``examples/mhd_1d.py``, with the same initial
condition and settings: gamma 2, Bx 0.75, (rho, p, By) = (1, 1, 1) left
of x = 0.5 and (0.125, 0.1, -1) right of it on [0, 1], at rest,
extrapolation BCs, to t = 0.1 (the five features of the Brio-Wu profile,
the slow compound wave among them): ``ClawSolver1D(mhd_1D)`` with the MC
limiter (``csrc/step1.cu``'s ``Mhd1D``, seven equations and two HLL
waves, on a card), or ``SharpClawSolver1D`` (WENO5, SSP104, with the
positivity fallback and the flux hook; ``csrc/weno5.cu`` on a card).
``setup()`` takes the JAX example's keywords plus ``device`` and
``dtype``; the device picks the kernel, so there is no
``kernel_language``.

    python -m pyclaw_tpu_torch.examples.mhd_1d
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(nx=800, gamma=2.0, bx=0.75, solver_type="classic",
          outdir="./_output", dtype=None, device=None):
    if solver_type == "classic":
        solver = pyclaw.ClawSolver1D(riemann.mhd_1D, device=device)
        solver.limiters = [pyclaw.limiters.tvd.MC]
    else:
        solver = pyclaw.SharpClawSolver1D(riemann.mhd_1D, device=device)
    solver.all_bcs = pyclaw.BC.extrap

    domain = pyclaw.Domain([0.0], [1.0], [nx])
    state = pyclaw.State(domain, 7, dtype=dtype)
    state.problem_data["gamma"] = gamma
    state.problem_data["bx"] = bx

    x = domain.grid.x.centers
    left = x < 0.5
    rho = np.where(left, 1.0, 0.125)
    p = np.where(left, 1.0, 0.1)
    by = np.where(left, 1.0, -1.0)
    state.q[0] = rho
    state.q[1] = 0.0
    state.q[2] = 0.0
    state.q[3] = 0.0
    state.q[4] = by
    state.q[5] = 0.0
    state.q[6] = p / (gamma - 1.0) + 0.5 * (bx ** 2 + by ** 2)

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 0.1
    claw.num_output_times = 5
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
