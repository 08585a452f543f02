"""Shallow water over a bathymetry sill (reference
examples/shallow_1d/sill.py) — the port's copy of the JAX package's
``examples/sill.py``, with the same initial condition and settings: the
sill b = 0.8 exp(-x^2 / 0.2) on [-1, 1], grav 9.8, a lake at rest (h + b
= 1, u = 0) with a small surface pulse ``perturb`` exp(-1000 (x + 0.6)^2),
extrapolation BCs on q and aux, to t = 0.4:
``ClawSolver1D(shallow_bathymetry_fwave_1D)`` with f-waves and the van
Leer limiter (``csrc/step1.cu``'s ``ShallowBathyFwave1D`` on a card).
The solver builds the topography source into its flux decomposition, so
the lake at rest (``perturb=0``) has zero fluctuations and stays at rest
to roundoff.  ``setup()`` takes the JAX example's keywords plus
``device`` and ``dtype``; the device picks the kernel, so there is no
``kernel_language``.

    python -m pyclaw_tpu_torch.examples.sill
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def bathymetry(x):
    return 0.8 * np.exp(-x ** 2 / 0.2)


def setup(nx=500, perturb=1e-3, outdir="./_output", dtype=None,
          device=None):
    solver = pyclaw.ClawSolver1D(riemann.shallow_bathymetry_fwave_1D,
                                 device=device)
    solver.fwave = True
    solver.limiters = [pyclaw.limiters.tvd.vanleer]
    solver.all_bcs = pyclaw.BC.extrap
    solver.aux_bc_lower = [pyclaw.BC.extrap]
    solver.aux_bc_upper = [pyclaw.BC.extrap]

    domain = pyclaw.Domain([-1.0], [1.0], [nx])
    state = pyclaw.State(domain, 2, num_aux=1, dtype=dtype)
    state.problem_data["grav"] = 9.8

    x = domain.grid.x.centers
    state.aux[0, :] = bathymetry(x)
    # lake at rest: surface eta = h + b = 1, plus a small pressure pulse
    state.q[0, :] = 1.0 - state.aux[0, :] \
        + perturb * np.exp(-1000.0 * (x + 0.6) ** 2)
    state.q[1, :] = 0.0

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 0.4
    claw.num_output_times = 4
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
