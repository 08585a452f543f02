"""1D Burgers equation (reference examples/burgers_1d/) — the port's copy
of the JAX package's ``examples/burgers_1d.py``, with the same initial
condition and settings: q = sin(2 pi x) + 0.5 on [0, 1], periodic BCs,
the entropy fix on, to t = 0.5 (the wave steepens into a shock):
``ClawSolver1D(burgers_1D)`` with the van Leer limiter
(``csrc/step1.cu``'s ``Burgers1D`` on a card), or ``SharpClawSolver1D``
(WENO5, SSP104, the flux hook; ``csrc/weno5.cu`` on a card).
``setup()`` takes the JAX example's keywords plus ``device`` and
``dtype``; the device picks the kernel, so there is no
``kernel_language``.

    python -m pyclaw_tpu_torch.examples.burgers_1d
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(nx=500, solver_type="classic", outdir="./_output", dtype=None,
          device=None):
    if solver_type == "classic":
        solver = pyclaw.ClawSolver1D(riemann.burgers_1D, device=device)
        solver.limiters = [pyclaw.limiters.tvd.vanleer]
    else:
        solver = pyclaw.SharpClawSolver1D(riemann.burgers_1D, device=device)
    solver.all_bcs = pyclaw.BC.periodic

    domain = pyclaw.Domain([0.0], [1.0], [nx])
    state = pyclaw.State(domain, solver.rp.num_eqn, dtype=dtype)
    state.problem_data["efix"] = True

    x = domain.grid.x.centers
    state.q[0, :] = np.sin(2 * np.pi * x) + 0.5

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 0.5
    claw.num_output_times = 10
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
