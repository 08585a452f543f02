"""Stegotons: solitary waves in periodic layered media (reference
examples/stegoton_1d/stegoton.py) — the port's copy of the JAX package's
``examples/stegoton_1d.py``, with the same initial condition and
settings: the nonlinear p-system (``psystem_1D``, stress exp(K eps) - 1)
in alternating layers (rho, K) = (4, 4) / (1, 1) of width 1 on [0,
nx / cells_per_layer], a strain pulse 2 exp(-(x - xmax/2)^2 / 5) at rest,
periodic BCs on q and aux, f-waves, to t = 20 (tests/golden/
stegoton_1d.npz at nx = 600): ``ClawSolver1D`` with the van Leer limiter
(``csrc/step1.cu``'s ``Psystem1D`` on a card), or ``SharpClawSolver1D``
(WENO5, SSP104; ``csrc/weno5.cu`` on a card).  ``setup()`` takes the JAX
example's keywords plus ``device`` and ``dtype``; the device picks the
kernel, so there is no ``kernel_language``.

    python -m pyclaw_tpu_torch.examples.stegoton_1d
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(nx=1200, cells_per_layer=24, solver_type="classic",
          outdir="./_output", dtype=None, device=None):
    if solver_type == "classic":
        solver = pyclaw.ClawSolver1D(riemann.psystem_1D, device=device)
        solver.limiters = [pyclaw.limiters.tvd.vanleer]
    else:
        solver = pyclaw.SharpClawSolver1D(riemann.psystem_1D, device=device)
    solver.fwave = True
    solver.all_bcs = pyclaw.BC.periodic
    solver.aux_bc_lower = [pyclaw.BC.periodic]
    solver.aux_bc_upper = [pyclaw.BC.periodic]

    xmax = nx / cells_per_layer  # one layer pair per 2 units
    domain = pyclaw.Domain([0.0], [xmax], [nx])
    state = pyclaw.State(domain, 2, num_aux=2, dtype=dtype)

    x = domain.grid.x.centers
    # alternating layers: (rho, K) = (4, 4) / (1, 1), period 2
    layer = (x % 2.0) < 1.0
    state.aux[0, :] = np.where(layer, 4.0, 1.0)
    state.aux[1, :] = np.where(layer, 4.0, 1.0)
    state.problem_data["stress_relation"] = "exp"

    # initial strain pulse
    state.q[0, :] = 2.0 * np.exp(-((x - xmax / 2) ** 2) / 5.0)
    state.q[1, :] = 0.0

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 20.0
    claw.num_output_times = 10
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
