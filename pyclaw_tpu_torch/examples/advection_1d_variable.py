"""Variable-coefficient 1D advection (reference
examples/advection_1d_variable/) — the port's copy of the JAX package's
``examples/advection_1d_variable.py``, with the same initial condition
and settings: the velocity u(x) = 1 + 0.5 sin(2 pi x) on [0, 1], a
Gaussian pulse exp(-100 (x - 0.3)^2), periodic BCs on q and aux, to
t = 0.5.  ``use_fwave`` picks the form: the color equation with the
edge velocities in aux[0] (``vc_advection_1D``) or the conservative
equation with the cell velocities, f-waves (``vc_advection_fwave_1D``);
``use_capacity`` adds the capacity function kappa = 1/u at the centres
(aux[1], ``index_capa = 1``).  ``ClawSolver1D`` with the MC limiter
(``csrc/step1.cu``'s ``VcAdvection1D`` / ``VcAdvectionFwave1D``, with
or without its capacity variant, on a card), or ``SharpClawSolver1D``
(WENO5, SSP104; ``csrc/weno5.cu`` on a card).  ``setup()`` takes the JAX
example's keywords plus ``device`` and ``dtype``; the device picks the
kernel, so there is no ``kernel_language``.

    python -m pyclaw_tpu_torch.examples.advection_1d_variable
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def velocity(x):
    return 1.0 + 0.5 * np.sin(2 * np.pi * x)


def setup(nx=200, solver_type="classic", use_capacity=False,
          use_fwave=False, outdir="./_output", dtype=None, device=None):
    rs = (riemann.vc_advection_fwave_1D if use_fwave
          else riemann.vc_advection_1D)
    if solver_type == "classic":
        solver = pyclaw.ClawSolver1D(rs, device=device)
        solver.limiters = [pyclaw.limiters.tvd.MC]
    else:
        solver = pyclaw.SharpClawSolver1D(rs, device=device)
    solver.fwave = use_fwave
    solver.all_bcs = pyclaw.BC.periodic
    solver.aux_bc_lower = [pyclaw.BC.periodic]
    solver.aux_bc_upper = [pyclaw.BC.periodic]

    domain = pyclaw.Domain([0.0], [1.0], [nx])
    num_aux = 2 if use_capacity else 1
    state = pyclaw.State(domain, 1, num_aux=num_aux, dtype=dtype)

    if use_fwave:
        # conservative form: cell-centered velocities
        state.aux[0, :] = velocity(domain.grid.x.centers)
    else:
        # color equation: edge velocities (lower edge of each cell)
        state.aux[0, :] = velocity(domain.grid.x.edges[:-1])
    if use_capacity:
        centers = domain.grid.x.centers
        state.aux[1, :] = 1.0 / velocity(centers)
        state.index_capa = 1

    x = domain.grid.x.centers
    state.q[0, :] = np.exp(-100.0 * (x - 0.3) ** 2)

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 0.5
    claw.num_output_times = 5
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
