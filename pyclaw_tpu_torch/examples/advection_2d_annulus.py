"""Rigid-body rotation on an annulus, a mapped grid (reference
examples/advection_2d_annulus/) — the port's copy of the JAX package's
``examples/advection_2d_annulus.py``, with the same initial condition
and settings: computational coordinates (r, theta) on [0.2, 1] x [0,
2 pi], the map x = r cos(theta), y = r sin(theta) (``mapc2p``), the
capacity kappa = r (aux[2], ``index_capa = 2``), no radial velocity
(aux[0] = 0) and the cell-centred theta velocity omega r (aux[1]), a
Gaussian blob exp(-40 (r - 0.6)^2 - 6 (cos(theta) - 1)^2), extrapolation
BCs in r and periodic in theta (q and aux), f-waves, the MC limiter, to
one revolution t = 2 pi / omega, when the exact solution equals the
initial one.  ``dimensional_split=True`` (the default) runs
``ClawSolver2D(vc_advection_fwave_1D)`` split into an r and a theta
sweep, each reading its own velocity row aux[ixy] (``classic/kernels.py:
step1_dir``, plain PyTorch on every device); ``False`` the unsplit CTU
step of ``vc_advection_fwave_2D`` with its transverse split
(``csrc/step2_aos.cu``'s ``VcAdvectionFwave2D`` instance on a card).
``setup()`` takes the JAX example's keywords plus ``device`` and
``dtype``; the device picks the kernel, so there is no
``kernel_language``.

    python -m pyclaw_tpu_torch.examples.advection_2d_annulus
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def mapc2p(grid, r, theta):
    return r * np.cos(theta), r * np.sin(theta)


def setup(mr=40, mth=120, omega=1.0, dimensional_split=True,
          outdir="./_output", dtype=None, device=None):
    if dimensional_split:
        solver = pyclaw.ClawSolver2D(riemann.vc_advection_fwave_1D,
                                     device=device)
        solver.dimensional_split = True
    else:
        # unsplit CTU: the transverse split of rpt2_vc_advection and the
        # capacity-scaled corner-transport coefficients
        solver = pyclaw.ClawSolver2D(riemann.vc_advection_fwave_2D,
                                     device=device)
        solver.dimensional_split = False
    solver.fwave = True
    solver.limiters = [pyclaw.limiters.tvd.MC]
    solver.bc_lower = [pyclaw.BC.extrap, pyclaw.BC.periodic]
    solver.bc_upper = [pyclaw.BC.extrap, pyclaw.BC.periodic]
    solver.aux_bc_lower = [pyclaw.BC.extrap, pyclaw.BC.periodic]
    solver.aux_bc_upper = [pyclaw.BC.extrap, pyclaw.BC.periodic]

    domain = pyclaw.Domain([0.2, 0.0], [1.0, 2.0 * np.pi], [mr, mth])
    domain.grid.mapc2p = mapc2p
    state = pyclaw.State(domain, 1, num_aux=3, dtype=dtype)

    r, th = domain.grid.c_centers
    # aux[0]: r-face normal velocity (0: no radial flow)
    # aux[1]: theta-face velocity u = omega r (cell-centred for f-waves)
    # aux[2]: capacity kappa = r (cell area / (dr dtheta))
    state.aux[0] = 0.0
    state.aux[1] = omega * r
    state.aux[2] = r
    state.index_capa = 2

    state.q[0] = np.exp(-40.0 * ((r - 0.6) ** 2)
                        - 6.0 * (np.cos(th) - 1.0) ** 2)

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 2.0 * np.pi / omega
    claw.num_output_times = 4
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
