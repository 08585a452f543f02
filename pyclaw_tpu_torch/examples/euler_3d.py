"""3D Euler smooth energy deposition (reference examples/euler_3d/Sedov.py)
— the port's copy of the JAX package's ``examples/euler_3d.py``, with the
same initial condition and ``setup()`` keywords plus ``device``, on the
unsplit classic CTU solver (MC limiter, extrapolation BCs, gamma = 1.4,
to t = 0.2; ``csrc/step3_ctu.cu`` on a card) or, with
``solver_type="sharpclaw"``, on ``SharpClawSolver3D`` (WENO5, SSP104; the
generic dq, ``csrc/weno5.cu`` on a card).  The device picks the kernel,
so there is no ``kernel_language``.  With ``use_parallel=True`` the
solver is the parallel overlay's (``pyclaw_tpu_torch.parallel``), one
process a rank.

    python -m pyclaw_tpu_torch.examples.euler_3d mx=64 my=64 mz=64
    torchrun --nproc-per-node 4 -m pyclaw_tpu_torch.examples.euler_3d \
        use_parallel=True mx=192 my=192 mz=192 dtype=float32
"""

import numpy as np

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import parallel, riemann


def setup(mx=32, my=32, mz=32, solver_type="classic", use_parallel=False,
          outdir="./_output", dtype=None, device=None):
    classes = parallel if use_parallel else pyclaw
    if solver_type == "classic":
        solver = classes.ClawSolver3D(riemann.euler_3D, device=device)
        solver.limiters = [pyclaw.limiters.tvd.MC]
    else:
        solver = classes.SharpClawSolver3D(riemann.euler_3D, device=device)
    solver.all_bcs = pyclaw.BC.extrap

    domain = pyclaw.Domain([-1.0, -1.0, -1.0], [1.0, 1.0, 1.0],
                           [mx, my, mz])
    state = pyclaw.State(domain, solver.rp.num_eqn, dtype=dtype)
    gamma = 1.4
    state.problem_data["gamma"] = gamma

    x, y, z = domain.grid.c_centers
    r2 = x ** 2 + y ** 2 + z ** 2
    p = 0.1 + 5.0 * np.exp(-40.0 * r2)      # smooth energy deposition
    state.q[0] = 1.0
    state.q[1] = 0.0
    state.q[2] = 0.0
    state.q[3] = 0.0
    state.q[4] = p / (gamma - 1.0)

    # the overlay's Controller: rank 0 writes the ascii frames
    claw = classes.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 0.2
    claw.num_output_times = 2
    claw.outdir = outdir
    claw.output_format = "ascii" if outdir is not None else None
    return claw


def add_capacity(state):
    """Give a 3D state on [-1, 1]^3 a capacity function, kappa = 1 +
    0.25 cos(pi x) cos(pi y) cos(pi z) (in 0.75 .. 1.25, even in every
    axis, so the example keeps its x <-> y mirror symmetry), as its one
    aux row (index_capa = 0); returns the state.  No JAX example runs
    this configuration: it is how the capacity variant of
    csrc/step3_ctu.cu is driven on a whole run."""
    x, y, z = state.grid.c_centers
    kappa = 1.0 + 0.25 * (np.cos(np.pi * x) * np.cos(np.pi * y)
                          * np.cos(np.pi * z))
    state.num_aux = 1
    state.aux = kappa[None].astype(state.q.dtype)
    state.index_capa = 0
    return state


if __name__ == "__main__":
    from pyclaw_tpu_torch.util import run_app_from_main
    run_app_from_main(setup)
