"""2D swirl advection (reference examples/advection_2d/) — the port's copy
of the JAX package's ``examples/advection_2d.py``, with the same initial
condition and settings: a disk of color (q = 1 within 0.15 of (0.5,
0.75)) carried by the incompressible swirl of the stream function
psi = sin^2(pi x) sin^2(pi y) / pi on [0, 1]^2, its velocities taken at
the cell edges so that the discrete field is divergence-free;
``ClawSolver2D(vc_advection_2D)``, unsplit with ``transverse_waves=0``
(both sweeps see the same q, so the edge field cancels exactly), CFL
0.45 / 0.5, the van Leer limiter, extrapolation BCs on q and aux, to
t = 2.0.  ``setup()`` takes the JAX example's keywords plus ``device``
and ``dtype``; the device picks the kernel (``csrc/step2_aos.cu``'s
``vc_advection_2D`` instance on a card), so there is no
``kernel_language``.

    python -m pyclaw_tpu_torch.examples.advection_2d
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(mx=100, my=100, outdir="./_output", dtype=None, device=None):
    solver = pyclaw.ClawSolver2D(riemann.vc_advection_2D, device=device)
    solver.dimensional_split = False
    solver.transverse_waves = 0
    # donor-cell unsplit: stability needs the sum of the per-axis CFLs < 1
    solver.cfl_desired, solver.cfl_max = 0.45, 0.5
    solver.limiters = [pyclaw.limiters.tvd.vanleer]
    solver.all_bcs = pyclaw.BC.extrap
    solver.aux_bc_lower = [pyclaw.BC.extrap] * 2
    solver.aux_bc_upper = [pyclaw.BC.extrap] * 2

    domain = pyclaw.Domain([0.0, 0.0], [1.0, 1.0], [mx, my])
    state = pyclaw.State(domain, 1, num_aux=2, dtype=dtype)

    # the stream function on the cell corners
    xe = domain.grid.x.edges
    ye = domain.grid.y.edges
    Xe, Ye = np.meshgrid(xe, ye, indexing="ij")
    psi = (1.0 / np.pi) * np.sin(np.pi * Xe) ** 2 * np.sin(np.pi * Ye) ** 2
    dx, dy = domain.grid.delta
    # the normal velocities at each cell's lower faces
    state.aux[0] = (psi[:-1, 1:] - psi[:-1, :-1]) / dy
    state.aux[1] = -(psi[1:, :-1] - psi[:-1, :-1]) / dx

    x, y = domain.grid.c_centers
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.75) ** 2)
    state.q[0] = np.where(r < 0.15, 1.0, 0.0)

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 2.0
    claw.num_output_times = 8
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
