"""2D shallow water over a submerged bathymetry bump — the port's copy of
the JAX package's ``examples/radial_bump_bathymetry.py``, with the same
initial condition and settings (``ClawSolver2D(sw_aug_2D)`` with f-waves
and the minmod limiter, grav 9.8, the ridge b = 0.5 exp(-10 r^2) on
[-1, 1]^2, the surface 1 + perturb exp(-100 ((x + 0.5)^2 + y^2)),
extrapolation BCs for q and aux, to t = 0.3) and ``setup()`` keywords
plus ``device``.  The well-balanced augmented solver keeps the lake at
rest machine-still over the bump while the perturbation radiates across
it.  The device picks the kernel (``csrc/step2_aos.cu``'s sw_aug instance
on a card), so ``kernel_language`` is not taken.

    python -m pyclaw_tpu_torch.examples.radial_bump_bathymetry
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(mx=150, my=150, perturb=0.01, outdir="./_output", dtype=None,
          device=None):
    solver = pyclaw.ClawSolver2D(riemann.sw_aug_2D, device=device)
    solver.fwave = True
    solver.limiters = [pyclaw.limiters.tvd.minmod]
    solver.all_bcs = pyclaw.BC.extrap
    solver.aux_bc_lower = [pyclaw.BC.extrap] * 2
    solver.aux_bc_upper = [pyclaw.BC.extrap] * 2

    domain = pyclaw.Domain([-1.0, -1.0], [1.0, 1.0], [mx, my])
    state = pyclaw.State(domain, 3, num_aux=1, dtype=dtype)
    state.problem_data["grav"] = 9.8

    x, y = domain.grid.c_centers
    b = 0.5 * np.exp(-10.0 * (x ** 2 + y ** 2))        # submerged ridge
    state.aux[0] = b
    eta = 1.0 + perturb * np.exp(-100.0 * ((x + 0.5) ** 2 + y ** 2))
    state.q[0] = eta - b
    state.q[1] = 0.0
    state.q[2] = 0.0

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 0.3
    claw.num_output_times = 3
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
