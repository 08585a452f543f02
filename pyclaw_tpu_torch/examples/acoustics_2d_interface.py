"""2D acoustics across a material interface (reference
examples/acoustics_2d_variable/acoustics_2d_interface.py) — the port's
copy of the JAX package's ``examples/acoustics_2d_interface.py``, with the
same initial condition, settings and ``setup()`` keywords: a radial
pressure pulse (a cosine ring of radius 0.25 and width 0.1 around
(-0.5, 0)) in the left medium (rho 4, c 0.5) hits the vertical impedance
jump at x = 0 to the right medium (rho 1, c 1) on [-1, 1]^2 and is partly
transmitted and refracted; aux rows impedance Z and sound speed c,
extrapolation BCs on q and aux, to t = 0.6.  ``solver_type="classic"``
runs ``ClawSolver2D(vc_acoustics_2D)`` with the MC limiter, the unsplit
CTU step with the heterogeneous transverse split (``csrc/step2_aos.cu``'s
``vc_acoustics_2D`` instance on a card); ``solver_type="sharpclaw"``
runs ``SharpClawSolver2D(vc_acoustics_2D)`` (WENO5, SSP104, the generic
dq with aux, ``csrc/weno5.cu`` on a card; ``char_decomp`` through the
record's ``evec``).  Plus ``device`` and ``dtype``; the device picks the
kernel, so there is no ``kernel_language``.  ``dimensional_split=True``
runs the x and y sweeps of dimensional splitting (plain PyTorch on every
device).

    python -m pyclaw_tpu_torch.examples.acoustics_2d_interface
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(mx=200, my=200, solver_type="classic", rhol=4.0, cl=0.5,
          rhor=1.0, cr=1.0, dimensional_split=False, outdir="./_output",
          dtype=None, device=None):
    if solver_type == "classic":
        solver = pyclaw.ClawSolver2D(riemann.vc_acoustics_2D, device=device)
        solver.dimensional_split = dimensional_split
        solver.limiters = [pyclaw.limiters.tvd.MC]
    else:
        solver = pyclaw.SharpClawSolver2D(riemann.vc_acoustics_2D,
                                          device=device)
    solver.all_bcs = pyclaw.BC.extrap
    solver.aux_bc_lower = [pyclaw.BC.extrap] * 2
    solver.aux_bc_upper = [pyclaw.BC.extrap] * 2

    domain = pyclaw.Domain([-1.0, -1.0], [1.0, 1.0], [mx, my])
    state = pyclaw.State(domain, 3, num_aux=2, dtype=dtype)

    X, Y = domain.grid.c_centers
    zl, zr = rhol * cl, rhor * cr
    state.aux[0] = np.where(X < 0.0, zl, zr)        # impedance Z
    state.aux[1] = np.where(X < 0.0, cl, cr)        # sound speed c

    # the radial pressure pulse in the left medium
    r = np.sqrt((X + 0.5) ** 2 + Y ** 2)
    width, rad = 0.10, 0.25
    state.q[0] = (np.abs(r - rad) <= width) * \
        (1.0 + np.cos(np.pi * (r - rad) / width))
    state.q[1] = 0.0
    state.q[2] = 0.0

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
