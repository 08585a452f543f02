"""pyclaw_tpu_torch — the PyTorch/CUDA port of pyclaw_tpu.

Same user API as the JAX package (and as clawpack/pyclaw), plus an
explicit ``device``: entry points run on the CUDA card unless the caller
passes ``device="cpu"``.

    import pyclaw_tpu_torch as pyclaw
    from pyclaw_tpu_torch import riemann
    solver = pyclaw.ClawSolver2D(riemann.euler_4wave_2D)
    solver.all_bcs = pyclaw.BC.extrap
    domain = pyclaw.Domain([0., 0.], [1., 1.], [mx, my])
    state = pyclaw.State(domain, solver.rp.num_eqn)
    state.problem_data['gamma'] = 1.4
    state.q[...] = <initial condition>
    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = 0.6
    claw.run()

The port carries the 2D classic CTU path and the 2D SharpClaw WENO5
path (``SharpClawSolver2D``; SSP104, SSP33, Euler) of the Euler 4-wave
system, and the 3D classic CTU path (``ClawSolver3D``) of the 3D Euler
system; ROADMAP.md lists what comes next.
"""

from . import config  # noqa: F401

from .cfl import CFL  # noqa: F401,E402
from .controller import Controller  # noqa: F401,E402
from .geometry import Dimension, Domain, Grid, Patch  # noqa: F401,E402
from .solution import Solution  # noqa: F401,E402
from .solver import BC, Solver  # noqa: F401,E402
from .state import State  # noqa: F401,E402
from .classic import ClawSolver2D, ClawSolver3D  # noqa: F401,E402
from .sharpclaw import SharpClawSolver2D  # noqa: F401,E402
from . import limiters, riemann  # noqa: F401,E402

__version__ = "0.1.0"
