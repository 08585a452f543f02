"""Shallow water on the rotating sphere (reference examples/shallow_sphere;
the JAX package's lat-lon channel redesign, riemann/shallow_sphere.py) —
the port's copy of the JAX package's ``examples/shallow_sphere.py``, with
the same initial condition and settings: Williamson test case 2, the
steady geostrophic zonal flow u = u0 cos(theta), v = 0, g h = g h0 -
(u0 (2 Omega a + u0) / 2) sin^2(theta), on lambda in [0, 2 pi) (periodic)
and theta in [-lat_max, lat_max], whose theta boundaries hold the
analytic state and the exact cos(theta) aux rows in their ghost rows
(custom q and aux BCs), to one revolution at u0; ``perturb=True`` adds a
Gaussian height bump.  ``ClawSolver2D(shallow_sphere_fwave_2D)`` with
f-waves, the MC limiter, the capacity kappa = cos(theta) (aux[1],
``index_capa = 1``) and the Coriolis and metric source
(``riemann.shallow_sphere.make_sphere_source``) split Strang around the
step; split into x and y sweeps (``dimensional_split=True``, the default
as in the JAX example; plain PyTorch on every device, the source and the
BC callbacks in the device loop's graphs on a card), or with
``dimensional_split=False`` the unsplit step without a transverse pass
at CFL 0.2 / 0.25
(``csrc/step2_aos.cu``'s ``shallow_sphere_fwave_2D`` instance on a card).
``setup()`` takes the JAX example's keywords plus ``dimensional_split``,
``device`` and ``dtype``; the device picks the kernel, so there is no
``kernel_language``.

    python -m pyclaw_tpu_torch.examples.shallow_sphere
"""

import numpy as np
import torch

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann
from pyclaw_tpu_torch.riemann.shallow_sphere import make_sphere_source


def setup(mx=128, my=64, u0=0.25, h0=1.0, omega=0.5, radius=1.0,
          grav=1.0, lat_max=1.0, perturb=False, dimensional_split=True,
          outdir="./_output", dtype=None, device=None):
    solver = pyclaw.ClawSolver2D(riemann.shallow_sphere_fwave_2D,
                                 device=device)
    solver.fwave = True
    solver.dimensional_split = dimensional_split
    solver.limiters = [pyclaw.limiters.tvd.MC]
    if not dimensional_split:
        # no transverse pass (the record has no rpt): CFL 0.2 / 0.25, as
        # psystem_2d.py's unsplit step, whose comment says why
        solver.cfl_desired, solver.cfl_max = 0.2, 0.25
    # theta boundaries: the analytic TC2 equilibrium in the ghost rows
    solver.bc_lower = [pyclaw.BC.periodic, pyclaw.BC.custom]
    solver.bc_upper = [pyclaw.BC.periodic, pyclaw.BC.custom]
    solver.aux_bc_lower = [pyclaw.BC.periodic, pyclaw.BC.custom]
    solver.aux_bc_upper = [pyclaw.BC.periodic, pyclaw.BC.custom]

    domain = pyclaw.Domain([0.0, -lat_max], [2.0 * np.pi, lat_max],
                           [mx, my])
    state = pyclaw.State(domain, 3, num_aux=2, dtype=dtype)
    state.problem_data["grav"] = grav

    lam, th = domain.grid.c_centers
    th_edge = th - 0.5 * domain.grid.delta[1]
    state.aux[0] = np.cos(th_edge)       # kappa at the lower theta edge
    state.aux[1] = np.cos(th)            # kappa at the centre (capacity)
    state.index_capa = 1

    # Williamson TC2 steady state
    gh = grav * h0 - 0.5 * u0 * (2.0 * omega * radius + u0) * np.sin(th) ** 2
    h = gh / grav
    u = u0 * np.cos(th)
    state.q[0] = h
    state.q[1] = h * u
    state.q[2] = 0.0
    if perturb:
        r2 = (lam - np.pi) ** 2 + (th - 0.25) ** 2
        state.q[0] = state.q[0] + 0.1 * h0 * np.exp(-20.0 * r2)

    solver.step_source = make_sphere_source(domain.grid, radius=radius,
                                            omega=omega, grav=grav)
    solver.source_split = 2              # Strang

    # custom theta BCs: the analytic TC2 state and the exact cos(theta)
    # aux rows, each held on the ghost array's device in its dtype
    dth = domain.grid.delta[1]
    ng = solver.num_ghost

    def _profile(th):
        ghp = grav * h0 - 0.5 * u0 * (2.0 * omega * radius + u0) \
            * np.sin(th) ** 2
        hp = ghp / grav
        return np.stack([hp, hp * u0 * np.cos(th), np.zeros_like(th)])

    th_lo = -lat_max - dth * (np.arange(ng, 0, -1) - 0.5)
    th_hi = lat_max + dth * (np.arange(1, ng + 1) - 0.5)
    rows = {"q_lo": _profile(th_lo), "q_hi": _profile(th_hi),   # (3, ng)
            "aux_lo": np.stack([np.cos(th_lo - 0.5 * dth), np.cos(th_lo)]),
            "aux_hi": np.stack([np.cos(th_hi - 0.5 * dth), np.cos(th_hi)])}
    held = {}

    def row(name, like):
        key = (name, like.device, like.dtype)
        if key not in held:
            held[key] = torch.as_tensor(rows[name], dtype=like.dtype,
                                        device=like.device)[:, None, :]
        return held[key]

    def bc_lower(state, d, t, qbc, auxbc, g):
        qbc[:, :, :g] = row("q_lo", qbc)
        return qbc

    def bc_upper(state, d, t, qbc, auxbc, g):
        qbc[:, :, -g:] = row("q_hi", qbc)
        return qbc

    def aux_bc_lower(state, d, t, qbc, auxbc, g):
        auxbc[:, :, :g] = row("aux_lo", auxbc)
        return auxbc

    def aux_bc_upper(state, d, t, qbc, auxbc, g):
        auxbc[:, :, -g:] = row("aux_hi", auxbc)
        return auxbc

    solver.user_bc_lower = bc_lower
    solver.user_bc_upper = bc_upper
    solver.user_aux_bc_lower = aux_bc_lower
    solver.user_aux_bc_upper = aux_bc_upper

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 2.0 * np.pi / max(u0, 1e-12)   # one revolution at u0
    claw.num_output_times = 4
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
