"""Dam break onto a dry sloping beach, wetting and drying with the
augmented solver (reference GeoClaw-class sw_aug) — the port's copy of the
JAX package's ``examples/dam_break_dry.py``, with the same initial
condition and settings (a column of depth 1 left of x = 0 on [-5, 5], a
dry beach b = max(0, 0.4 (x - 1)), grav 9.8, dry_tolerance 1e-5,
extrapolation BCs for q and aux, to t = 2.0): ``ClawSolver1D(sw_aug_1D)``
with f-waves and the minmod limiter, cfl_desired 0.4, cfl_max 0.45
(``csrc/step1.cu`` on a card).  Depths stay nonnegative through the
wetting and the drying front.  ``dimension=2`` runs the radial analog on
[-5, 5]^2: ``ClawSolver2D(sw_aug_2D)`` with ``transverse_waves=0`` (the
CTU corrections are not positivity-preserving over wetting and drying
fronts), a column of depth 1 inside r = 0.5 and the beach b = max(0,
0.4 (r - 1)) (``csrc/step2_aos.cu``'s sw_aug instance on a card); on
fine grids its depths dip below 0, in the JAX package's run too
(ROADMAP.md, Queue 3).
``setup()`` takes the JAX example's keywords plus ``device`` and
``dtype``.

    python -m pyclaw_tpu_torch.examples.dam_break_dry
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(nx=500, dimension=1, outdir="./_output", dtype=None, device=None):
    if dimension == 1:
        solver = pyclaw.ClawSolver1D(riemann.sw_aug_1D, device=device)
        domain = pyclaw.Domain([-5.0], [5.0], [nx])
    else:
        solver = pyclaw.ClawSolver2D(riemann.sw_aug_2D, device=device)
        # donor-cell corners: the CTU transverse corrections are not
        # positivity-preserving over wetting and drying fronts
        solver.transverse_waves = 0
        domain = pyclaw.Domain([-5.0, -5.0], [5.0, 5.0], [nx, nx])
    solver.fwave = True
    solver.limiters = [pyclaw.limiters.tvd.minmod]
    solver.cfl_desired = 0.4
    solver.cfl_max = 0.45
    solver.all_bcs = pyclaw.BC.extrap
    solver.aux_bc_lower = [pyclaw.BC.extrap] * dimension
    solver.aux_bc_upper = [pyclaw.BC.extrap] * dimension

    state = pyclaw.State(domain, solver.rp.num_eqn, num_aux=1, dtype=dtype)
    state.problem_data["grav"] = 9.8
    state.problem_data["dry_tolerance"] = 1e-5

    if dimension == 1:
        x = domain.grid.x.centers
        beach = np.maximum(0.0, 0.4 * (x - 1.0))       # dry beach x > 1
        state.aux[0] = beach
        state.q[0] = np.where(x < 0.0, 1.0, 0.0)       # dam at x = 0
        state.q[1] = 0.0
    else:
        x, y = domain.grid.c_centers
        r = np.sqrt(x ** 2 + y ** 2)
        state.aux[0] = np.maximum(0.0, 0.4 * (r - 1.0))
        state.q[0] = np.where(r < 0.5, 1.0, 0.0)
        state.q[1] = 0.0
        state.q[2] = 0.0

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 2.0
    claw.num_output_times = 4
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
