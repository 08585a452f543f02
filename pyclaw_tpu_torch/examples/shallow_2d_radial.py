"""2D shallow-water radial dam break (reference
examples/shallow_2d/radial_dam_break.py; BASELINE cfg3) — the port's copy
of the JAX package's ``examples/shallow_2d_radial.py``, with the same
initial condition and settings (``ClawSolver2D(shallow_roe_with_efix_2D)``,
MC limiter, extrapolation BCs, grav 1.0, [-2.5, 2.5]^2, to t = 1.0) and
``setup()`` keywords plus ``device`` and ``dtype``.  The device picks the
kernel (``csrc/step2_aos.cu`` on a card), so there is no
``kernel_language``.  ``solver_type="sharpclaw"`` runs
``SharpClawSolver2D(shallow_roe_with_efix_2D)`` (WENO5, SSP104; the
generic dq with the system's flux and positivity hooks, ``csrc/weno5.cu``
on a card).

    python -m pyclaw_tpu_torch.examples.shallow_2d_radial
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(mx=125, my=125, solver_type="classic", outdir="./_output",
          dtype=None, device=None):
    if solver_type == "classic":
        solver = pyclaw.ClawSolver2D(riemann.shallow_roe_with_efix_2D,
                                     device=device)
        solver.limiters = [pyclaw.limiters.tvd.MC]
    else:
        solver = pyclaw.SharpClawSolver2D(riemann.shallow_roe_with_efix_2D,
                                          device=device)
    solver.all_bcs = pyclaw.BC.extrap

    domain = pyclaw.Domain([-2.5, -2.5], [2.5, 2.5], [mx, my])
    state = pyclaw.State(domain, solver.rp.num_eqn, dtype=dtype)
    state.problem_data["grav"] = 1.0

    x, y = domain.grid.c_centers
    r = np.sqrt(x ** 2 + y ** 2)
    state.q[0, :, :] = np.where(r <= 0.5, 2.0, 1.0)
    state.q[1, :, :] = 0.0
    state.q[2, :, :] = 0.0

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
