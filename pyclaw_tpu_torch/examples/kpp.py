"""KPP rotating-wave problem (reference examples/kpp/kpp.py) — the port's
copy of the JAX package's ``examples/kpp.py``:

    q_t + sin(q)_x + cos(q)_y = 0

a scalar conservation law with a nonconvex flux whose entropy solution
develops a rotating spiral (Kurganov-Petrova-Popov 2007), with the same
initial condition (14 pi / 4 in the unit disk, pi / 4 outside, on
[-2, 2] x [-2.5, 1.5]), extrapolation BCs, to t = 1.0, and ``setup()``
keywords plus ``device`` and ``dtype``.  ``solver_type="classic"`` runs
``ClawSolver2D(kpp_2D)`` with the minmod limiter, ``transverse_waves=2``
and CFL 0.45 / 0.5 (overshoots of the Rusanov dissipation feed the wrong
spiral branch near CFL 1), the unsplit CTU step (``csrc/step2_aos.cu``'s
``kpp_2D`` instance on a card); ``solver_type="sharpclaw"`` runs
``SharpClawSolver2D(kpp_2D)`` (WENO5, SSP104, the generic dq with the
second Riemann solve for the in-cell fluctuation, ``csrc/weno5.cu`` on a
card).  The device picks the kernel, so there is no ``kernel_language``.
``setplot`` is the JAX example's (q as a pcolor in [0, 4 pi]); the
``htmlplot`` and ``iplot`` tokens draw the frames with it (matplotlib).

    python -m pyclaw_tpu_torch.examples.kpp
    python -m pyclaw_tpu_torch.examples.kpp device=cpu htmlplot
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(mx=200, my=200, solver_type="classic", outdir="./_output",
          dtype=None, device=None):
    if solver_type == "classic":
        solver = pyclaw.ClawSolver2D(riemann.kpp_2D, device=device)
        solver.limiters = [pyclaw.limiters.tvd.minmod]
        solver.dimensional_split = False
        solver.transverse_waves = 2
        solver.cfl_desired, solver.cfl_max = 0.45, 0.5
    else:
        solver = pyclaw.SharpClawSolver2D(riemann.kpp_2D, device=device)
    solver.all_bcs = pyclaw.BC.extrap

    domain = pyclaw.Domain([-2.0, -2.5], [2.0, 1.5], [mx, my])
    state = pyclaw.State(domain, solver.rp.num_eqn, dtype=dtype)

    x, y = domain.grid.c_centers
    r = np.sqrt(x ** 2 + y ** 2)
    state.q[0] = np.where(r <= 1.0, 14.0 * np.pi / 4.0, np.pi / 4.0)

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 1.0
    claw.num_output_times = 10
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


def setplot(plotdata):
    plotdata.clearfigures()
    plotfigure = plotdata.new_plotfigure(name="q", figno=0)
    plotaxes = plotfigure.new_plotaxes()
    plotaxes.title = "q (KPP rotating wave)"
    plotitem = plotaxes.new_plotitem(plot_type="2d_pcolor")
    plotitem.plot_var = 0
    plotitem.pcolor_cmin = 0.0
    plotitem.pcolor_cmax = 4.0 * np.pi
    return plotdata


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup, setplot=setplot)
