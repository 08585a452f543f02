"""3D acoustics in a layered medium (reference
examples/acoustics_3d_heterogeneous/acoustics_3d_interface.py) — the
port's copy of the JAX package's ``examples/acoustics_3d_heterogeneous.py``:
a pressure pulse below a horizontal impedance interface at z = 0,
transmitted and reflected in 3D, on ``ClawSolver3D(vc_acoustics_3D)``
with the same initial condition, settings (``transverse_waves=1``, since
the system has no double-transverse solver; CFL 0.45 / 0.5; MC limiter;
extrapolation BCs on q and aux; aux rows impedance Z and sound speed c;
to t = 0.8) and ``setup()`` keywords, plus ``device`` and ``dtype``.  The
device picks the kernel (``csrc/step3_aos.cu`` on a card), so there is no
``kernel_language``.  ``solver_type="sharpclaw"`` runs
``SharpClawSolver3D(vc_acoustics_3D)`` (WENO5, SSP104; the generic dq
with aux and the second Riemann solve for the in-cell fluctuation,
``csrc/weno5.cu`` on a card).  ``dimensional_split=True`` runs the
three sweeps of dimensional splitting at the default CFL (plain PyTorch
on every device), as the JAX example does.

    python -m pyclaw_tpu_torch.examples.acoustics_3d_heterogeneous
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(mx=32, my=32, mz=32, solver_type="classic", rho_bot=4.0,
          c_bot=0.5, rho_top=1.0, c_top=1.0, dimensional_split=False,
          outdir="./_output", dtype=None, device=None):
    if solver_type == "classic":
        solver = pyclaw.ClawSolver3D(riemann.vc_acoustics_3D, device=device)
        solver.dimensional_split = dimensional_split
        if not dimensional_split:
            solver.transverse_waves = 1     # no variable-coefficient rptt
            solver.cfl_desired, solver.cfl_max = 0.45, 0.5
        solver.limiters = [pyclaw.limiters.tvd.MC]
    else:
        solver = pyclaw.SharpClawSolver3D(riemann.vc_acoustics_3D,
                                          device=device)
    solver.all_bcs = pyclaw.BC.extrap
    solver.aux_bc_lower = [pyclaw.BC.extrap] * 3
    solver.aux_bc_upper = [pyclaw.BC.extrap] * 3

    domain = pyclaw.Domain([-1.0, -1.0, -1.0], [1.0, 1.0, 1.0],
                           [mx, my, mz])
    state = pyclaw.State(domain, 4, num_aux=2, dtype=dtype)

    x, y, z = domain.grid.c_centers
    zb, zt = rho_bot * c_bot, rho_top * c_top
    state.aux[0] = np.where(z < 0.0, zb, zt)        # impedance
    state.aux[1] = np.where(z < 0.0, c_bot, c_top)  # sound speed

    r2 = x ** 2 + y ** 2 + (z + 0.5) ** 2
    state.q[0] = 5.0 * np.exp(-40.0 * r2)
    state.q[1] = 0.0
    state.q[2] = 0.0
    state.q[3] = 0.0

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 0.8
    claw.num_output_times = 4
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
