"""2D p-system with gauges (reference examples/psystem_2d/) — the port's
copy of the JAX package's ``examples/psystem_2d.py``, with the same
initial condition and settings: a radial strain pulse 0.5 exp(-50 r^2)
in an elastic medium (rho = K = 1, or ``layered=True``: rho = K = 4 in
every other band of 0.25 in y) on [-1, 1]^2, the "exp" stress law,
extrapolation BCs on q and aux, gauges at (0.5, 0) and (0, 0.75), to
t = 1.0.  ``ClawSolver2D(psystem_2D)`` with f-waves and the MC limiter,
split into x and y sweeps (``dimensional_split=True``, the default as in
the JAX example: the record has no transverse solver; plain PyTorch on
every device), or with ``dimensional_split=False`` the unsplit step
without a transverse pass at CFL 0.2 / 0.25, where its roundoff stays
small (``csrc/step2_aos.cu``'s ``psystem_2D`` instance on a card).
``setup()`` takes the JAX example's keywords plus ``dimensional_split``,
``device`` and ``dtype``; the device picks the kernel, so there is no
``kernel_language``.

    python -m pyclaw_tpu_torch.examples.psystem_2d
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(mx=100, my=100, layered=False, dimensional_split=True,
          outdir="./_output", dtype=None, device=None):
    solver = pyclaw.ClawSolver2D(riemann.psystem_2D, device=device)
    solver.fwave = True
    solver.dimensional_split = dimensional_split
    solver.limiters = [pyclaw.limiters.tvd.MC]
    if not dimensional_split:
        # no transverse pass (the record has no rpt).  The step's
        # donor-cell part needs a Courant sum below 1; its second-order
        # corrections without cross terms are unstable at every Courant
        # number (for advection at nu along both axes, unlimited, the
        # wave numbers (pi/2, pi/2) grow by |g|^2 = 1 + 4 nu^4 a step, so
        # over a fixed time as n nu^3), and only the limiter bounds them.
        # At CFL 0.2 / 0.25 the pulse's x mirror asymmetry stays near
        # roundoff (float32 at 512^2: 3.9e-7, against 1.9e-4 at CFL 0.45;
        # tests/test_torch_split.py --unsplit)
        solver.cfl_desired, solver.cfl_max = 0.2, 0.25
    solver.all_bcs = pyclaw.BC.extrap
    solver.aux_bc_lower = [pyclaw.BC.extrap] * 2
    solver.aux_bc_upper = [pyclaw.BC.extrap] * 2

    domain = pyclaw.Domain([-1.0, -1.0], [1.0, 1.0], [mx, my])
    state = pyclaw.State(domain, 3, num_aux=2, dtype=dtype)
    state.problem_data["stress_relation"] = "exp"

    x, y = domain.grid.c_centers
    if layered:
        layer = (np.floor(4.0 * (y + 1.0)) % 2) == 0
        state.aux[0] = np.where(layer, 4.0, 1.0)
        state.aux[1] = np.where(layer, 4.0, 1.0)
    else:
        state.aux[0] = 1.0
        state.aux[1] = 1.0

    r2 = x ** 2 + y ** 2
    state.q[0] = 0.5 * np.exp(-50.0 * r2)
    state.q[1] = 0.0
    state.q[2] = 0.0

    domain.grid.add_gauges([[0.5, 0.0], [0.0, 0.75]])

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
