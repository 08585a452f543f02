"""2D homogeneous acoustics radial pulse (reference
examples/acoustics_2d_homogeneous/acoustics_2d.py; BASELINE cfg3) — the
port's copy of the JAX package's ``examples/acoustics_2d.py``, with the
same initial condition and settings (a cosine ring of pressure around r =
0.5 on [-1, 1]^2, rho = 1, K = 4, extrapolation BCs, to t = 0.12):
``ClawSolver2D(acoustics_2D)`` with the MC limiter, the unsplit CTU step
(``csrc/step2_aos.cu`` on a card), or with ``solver_type="sharpclaw"``
``SharpClawSolver2D(acoustics_2D)`` (WENO5, ``time_integrator``; the SoA
dq, ``csrc/dq2_weno5.cu``'s acoustics instance on a card).  ``setup()``
takes the JAX example's keywords plus ``device`` and ``dtype``; the
device picks the kernel, so there is no ``kernel_language``.
``dimensional_split=True`` runs the x and y sweeps of dimensional
splitting (plain PyTorch on every device).

    python -m pyclaw_tpu_torch.examples.acoustics_2d
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(mx=100, my=100, solver_type="classic", time_integrator="SSP104",
          dimensional_split=False, outdir="./_output", dtype=None,
          device=None):
    if solver_type == "classic":
        solver = pyclaw.ClawSolver2D(riemann.acoustics_2D, device=device)
        solver.dimensional_split = dimensional_split
        solver.limiters = [pyclaw.limiters.tvd.MC]
    else:
        solver = pyclaw.SharpClawSolver2D(riemann.acoustics_2D,
                                          device=device)
        solver.time_integrator = time_integrator
    solver.all_bcs = pyclaw.BC.extrap

    domain = pyclaw.Domain([-1.0, -1.0], [1.0, 1.0], [mx, my])
    state = pyclaw.State(domain, solver.rp.num_eqn, dtype=dtype)
    rho, bulk = 1.0, 4.0
    state.problem_data["rho"] = rho
    state.problem_data["bulk"] = bulk
    state.problem_data["zz"] = np.sqrt(rho * bulk)
    state.problem_data["cc"] = np.sqrt(bulk / rho)

    x, y = domain.grid.c_centers
    r = np.sqrt(x ** 2 + y ** 2)
    width = 0.2
    state.q[0, :, :] = np.where(np.abs(r - 0.5) <= width,
                                1.0 + np.cos(np.pi * (r - 0.5) / width), 0.0)
    state.q[1, :, :] = 0.0
    state.q[2, :, :] = 0.0

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 0.12
    claw.num_output_times = 2
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
