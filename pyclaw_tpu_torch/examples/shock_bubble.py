"""2D Euler shock-bubble interaction with a passive tracer (reference
examples/euler_2d/shock_bubble_interaction.py) — the port's copy of the
JAX package's ``examples/shock_bubble.py``, with the same initial
condition and settings (a Mach ~2 shock at x = 0.2 meets a bubble of
density 0.1 and radius 0.2 at (0.5, 0) on [0, 2] x [0, 0.5]; the tracer
q[4] = rho marks the bubble; gamma 1.4; BCs extrap in x, wall below and
extrap above in y; to t = 0.6) and ``setup()`` keywords plus ``device``
and ``dtype``.  ``solver_type="classic"`` runs
``ClawSolver2D(euler_5wave_2D)`` with the MC limiter, the generic CTU step
(``csrc/step2_aos.cu``'s Euler 5-wave instance on a card);
``solver_type="sharpclaw"`` runs ``SharpClawSolver2D(euler_5wave_2D)``
(WENO5, SSP104; ``csrc/dq2_weno5.cu``'s Euler 5-wave instance on a card).
The device picks the kernel, so there is no ``kernel_language``.

    python -m pyclaw_tpu_torch.examples.shock_bubble
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(mx=320, my=80, solver_type="classic", outdir="./_output",
          dtype=None, device=None):
    if solver_type == "classic":
        solver = pyclaw.ClawSolver2D(riemann.euler_5wave_2D, device=device)
        solver.limiters = [pyclaw.limiters.tvd.MC]
    else:
        solver = pyclaw.SharpClawSolver2D(riemann.euler_5wave_2D,
                                          device=device)
    solver.bc_lower = [pyclaw.BC.extrap, pyclaw.BC.wall]
    solver.bc_upper = [pyclaw.BC.extrap, pyclaw.BC.extrap]

    domain = pyclaw.Domain([0.0, 0.0], [2.0, 0.5], [mx, my])
    state = pyclaw.State(domain, solver.rp.num_eqn, dtype=dtype)
    gamma = 1.4
    state.problem_data["gamma"] = gamma

    x, y = domain.grid.c_centers
    r = np.sqrt((x - 0.5) ** 2 + y ** 2)
    in_bubble = r < 0.2

    # the pre-shock ambient state and the post-shock left state
    rho = np.where(x < 0.2, 2.6667, 1.0)
    u = np.where(x < 0.2, 1.25, 0.0)
    p = np.where(x < 0.2, 4.5, 1.0)
    rho = np.where(in_bubble, 0.1, rho)

    state.q[0] = rho
    state.q[1] = rho * u
    state.q[2] = 0.0
    state.q[3] = p / (gamma - 1.0) + 0.5 * rho * u ** 2
    state.q[4] = rho * in_bubble          # the tracer marks the bubble

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 0.6
    claw.num_output_times = 6
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
