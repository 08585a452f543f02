"""1D acoustics across a material interface (reference
examples/acoustics_1d_heterogeneous/) — the port's copy of the JAX
package's ``examples/acoustics_1d_heterogeneous.py``, with the same
initial condition and settings: impedance and sound speed (zl, cl) left
of x = 0 and (zr, cr) right of it on [-1, 1] (aux rows Z, c), a
right-going pulse p = Z u = exp(-200 (x + 0.5)^2) in the left medium,
extrapolation BCs, to t = 0.8 (the pulse splits at the interface with
the classical transmission and reflection coefficients):
``ClawSolver1D(acoustics_variable_1D)`` with the MC limiter
(``csrc/step1.cu``'s ``AcousticsVar1D`` on a card), or
``SharpClawSolver1D`` (WENO5, SSP104; ``csrc/weno5.cu`` on a card).
``setup()`` takes the JAX example's keywords plus ``device`` and
``dtype``; the device picks the kernel, so there is no
``kernel_language``.

    python -m pyclaw_tpu_torch.examples.acoustics_1d_heterogeneous
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(nx=800, solver_type="classic", zl=1.0, cl=1.0, zr=4.0, cr=0.5,
          outdir="./_output", dtype=None, device=None):
    if solver_type == "classic":
        solver = pyclaw.ClawSolver1D(riemann.acoustics_variable_1D,
                                     device=device)
        solver.limiters = [pyclaw.limiters.tvd.MC]
    else:
        solver = pyclaw.SharpClawSolver1D(riemann.acoustics_variable_1D,
                                          device=device)
    solver.all_bcs = pyclaw.BC.extrap

    domain = pyclaw.Domain([-1.0], [1.0], [nx])
    state = pyclaw.State(domain, 2, num_aux=2, dtype=dtype)

    x = domain.grid.x.centers
    state.aux[0, :] = np.where(x < 0.0, zl, zr)     # impedance
    state.aux[1, :] = np.where(x < 0.0, cl, cr)     # sound speed

    # right-going pulse in the left medium: p = Z u
    pulse = np.exp(-200.0 * (x + 0.5) ** 2)
    state.q[0, :] = pulse
    state.q[1, :] = pulse / zl

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 0.8
    claw.num_output_times = 8
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
