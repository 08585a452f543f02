"""LWR traffic flow (reference examples/traffic/) — the port's copy of the
JAX package's ``examples/traffic_1d.py``, with the same initial
condition and settings: a red-light Riemann problem, density 0.75 left of
x = 0 and 0.1 right of it on [-1, 1], umax 1, extrapolation BCs, to
t = 1.0 (the queue dissolves into a transonic rarefaction; a shock on
the right): ``ClawSolver1D(traffic_1D)`` with the van Leer limiter
(``csrc/step1.cu``'s ``Traffic1D`` on a card), or ``SharpClawSolver1D``
(WENO5, SSP104, the flux hook; ``csrc/weno5.cu`` on a card).
``setup()`` takes the JAX example's keywords plus ``device`` and
``dtype``; the device picks the kernel, so there is no
``kernel_language``.

    python -m pyclaw_tpu_torch.examples.traffic_1d
"""

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(nx=500, solver_type="classic", outdir="./_output", dtype=None,
          device=None):
    if solver_type == "classic":
        solver = pyclaw.ClawSolver1D(riemann.traffic_1D, device=device)
        solver.limiters = [pyclaw.limiters.tvd.vanleer]
    else:
        solver = pyclaw.SharpClawSolver1D(riemann.traffic_1D, device=device)
    solver.all_bcs = pyclaw.BC.extrap

    domain = pyclaw.Domain([-1.0], [1.0], [nx])
    state = pyclaw.State(domain, 1, dtype=dtype)
    state.problem_data["umax"] = 1.0

    x = domain.grid.x.centers
    state.q[0, :] = 0.75 * (x < 0.0) + 0.1 * (x >= 0.0)

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 1.0
    claw.num_output_times = 10
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
