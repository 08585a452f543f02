"""Mach-3 wind tunnel with a forward-facing step (reference
examples/euler_2d/shock_forward_step.py, the Emery problem) — the port's
copy of the JAX package's ``examples/shock_forward_step.py``, with the
same initial condition and settings: the Mach-3 free stream (rho 1.4,
u 3, p 1, gamma 1.4) on [0, 3] x [0, 1], inflow pinned by a custom BC on
the left, extrapolation on the right, walls below and above, CFL 0.4 /
0.5, to t = 4.0 in 8 frames.  The solid step [0.6, 3] x [0, 0.2] is
embedded in the grid: a ``before_step`` hook re-fills the two cell
layers inside each of its faces with mirror images of the fluid cells
beside them (normal momentum negated) before every step, on the host's
q (so the run takes the host loop).  ``solver_type="classic"`` runs
``ClawSolver2D(euler_4wave_2D)`` with minmod, split into x and y sweeps
(``dimensional_split=True``, as in the JAX example; plain PyTorch on
every device); ``solver_type="sharpclaw"`` runs
``SharpClawSolver2D(euler_4wave_2D)`` (WENO5, SSP104, the SoA dq:
``csrc/dq2_weno5.cu`` on a card).  ``setup()`` takes the JAX example's
keywords plus ``device`` and ``dtype``; the device picks the kernel, so
there is no ``kernel_language``.  ``setplot`` is the JAX example's (the
density and its schlieren); the ``htmlplot`` and ``iplot`` tokens draw
the frames with it (matplotlib).

    python -m pyclaw_tpu_torch.examples.shock_forward_step
"""

import numpy as np
import torch

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann

GAMMA = 1.4
RHO_IN, U_IN, P_IN = 1.4, 3.0, 1.0   # Mach 3: c = sqrt(gamma p/rho) = 1


def _inflow_state():
    e = P_IN / (GAMMA - 1.0) + 0.5 * RHO_IN * U_IN ** 2
    return np.array([RHO_IN, RHO_IN * U_IN, 0.0, e])


_INFLOW = {}


def inflow_bc_lower(state, dim, t, qbc, auxbc, num_ghost):
    """The free stream in the left ghost columns (held on qbc's device in
    its dtype)."""
    key = (qbc.device, qbc.dtype)
    if key not in _INFLOW:
        _INFLOW[key] = torch.as_tensor(_inflow_state(), dtype=qbc.dtype,
                                       device=qbc.device)[:, None, None]
    qbc[:, :num_ghost, :] = _INFLOW[key]
    return qbc


def make_step_filler(ix0, jy, num_ghost):
    """before_step hook: reflect-fill the step's internal ghost layers.

    ix0: first cell column inside the step (x >= 0.6);
    jy:  first cell row above the step (y >= 0.2)."""
    qstep = _inflow_state()

    def fill(solver, state):
        q = state.q
        # a finite state deep inside the step (the stencil sees only the
        # freshly mirrored layers)
        q[:, ix0:, :jy] = qstep[:, None, None]
        for k in range(num_ghost):
            # left face (x = 0.6): mirror fluid columns, negate u
            q[:, ix0 + k, :jy] = q[:, ix0 - 1 - k, :jy]
            q[1, ix0 + k, :jy] *= -1.0
        for k in range(num_ghost):
            # top face (y = 0.2): mirror fluid rows, negate v
            q[:, ix0:, jy - 1 - k] = q[:, ix0:, jy + k]
            q[2, ix0:, jy - 1 - k] *= -1.0

    return fill


def setup(mx=120, my=40, solver_type="classic", tfinal=4.0,
          num_output_times=8, outdir="./_output", dtype=None, device=None):
    if mx % 5 or my % 5:
        raise ValueError("mx, my must be multiples of 5 so the step "
                         "corner (0.6, 0.2) lies on cell edges")
    if solver_type == "classic":
        solver = pyclaw.ClawSolver2D(riemann.euler_4wave_2D, device=device)
        solver.limiters = [pyclaw.limiters.tvd.minmod]
        solver.dimensional_split = True   # robust for the corner singularity
    else:
        solver = pyclaw.SharpClawSolver2D(riemann.euler_4wave_2D,
                                          device=device)
    solver.bc_lower = [pyclaw.BC.custom, pyclaw.BC.wall]
    solver.bc_upper = [pyclaw.BC.extrap, pyclaw.BC.wall]
    solver.user_bc_lower = inflow_bc_lower
    solver.cfl_desired = 0.4
    solver.cfl_max = 0.5

    domain = pyclaw.Domain([0.0, 0.0], [3.0, 1.0], [mx, my])
    state = pyclaw.State(domain, solver.rp.num_eqn, dtype=dtype)
    state.problem_data["gamma"] = GAMMA

    state.q[:] = _inflow_state()[:, None, None]

    ix0 = int(round(0.2 * mx))   # x = 0.6 of [0, 3]
    jy = int(round(0.2 * my))    # y = 0.2 of [0, 1]
    solver.before_step = make_step_filler(ix0, jy, solver.num_ghost)

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = tfinal
    claw.num_output_times = num_output_times
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


def setplot(plotdata):
    """Density pcolor + schlieren (visclaw-style setplot)."""
    plotdata.clearfigures()

    fig = plotdata.new_plotfigure(name="Density", figno=0)
    axes = fig.new_plotaxes()
    axes.title = "Density"
    axes.scaled = True
    item = axes.new_plotitem(plot_type="2d_pcolor")
    item.plot_var = 0
    item.pcolor_cmin = 0.0
    item.pcolor_cmax = 6.0

    fig = plotdata.new_plotfigure(name="Schlieren", figno=1)
    axes = fig.new_plotaxes()
    axes.title = "Schlieren (|grad rho|)"
    axes.scaled = True
    item = axes.new_plotitem(plot_type="2d_schlieren")
    item.plot_var = 0
    return plotdata


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup, setplot=setplot)
