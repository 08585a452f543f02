"""1D shallow-water dam break (reference examples/shallow_1d/
dam_break.py) — the port's copy of the JAX package's
``examples/shallow_1d.py``, with the same initial condition and
settings: h = 3 left of x = 0 and 1 right of it on [-5, 5], at rest,
grav 1, extrapolation BCs, to t = 2.0.  ``riemann_solver`` picks the
record: "roe" (``shallow_roe_with_efix_1D``, Harten's entropy fix) or any
other value (``shallow_hlle_1D``).  ``ClawSolver1D`` with the MC limiter
(``csrc/step1.cu``'s ``ShallowRoe1D`` / ``ShallowHlle1D`` on a card), or
``SharpClawSolver1D`` (WENO5, SSP104; ``csrc/weno5.cu`` on a card).
``setup()`` takes the JAX example's keywords plus ``device`` and
``dtype``; the device picks the kernel, so there is no
``kernel_language``.

    python -m pyclaw_tpu_torch.examples.shallow_1d
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import riemann


def setup(nx=500, solver_type="classic", riemann_solver="roe",
          outdir="./_output", dtype=None, device=None):
    rs = (riemann.shallow_roe_with_efix_1D if riemann_solver == "roe"
          else riemann.shallow_hlle_1D)
    if solver_type == "classic":
        solver = pyclaw.ClawSolver1D(rs, device=device)
        solver.limiters = [pyclaw.limiters.tvd.MC]
    else:
        solver = pyclaw.SharpClawSolver1D(rs, device=device)
    solver.all_bcs = pyclaw.BC.extrap

    domain = pyclaw.Domain([-5.0], [5.0], [nx])
    state = pyclaw.State(domain, solver.rp.num_eqn, dtype=dtype)
    state.problem_data["grav"] = 1.0

    x = domain.grid.x.centers
    state.q[0, :] = np.where(x < 0.0, 3.0, 1.0)
    state.q[1, :] = 0.0

    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 2.0
    claw.num_output_times = 10
    claw.outdir = outdir
    if outdir is None:
        claw.output_format = None
    return claw


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
