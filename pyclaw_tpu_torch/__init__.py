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

The port carries these paths, each with a hand-written CUDA kernel:

* 2D Euler quadrants on the classic CTU step (``ClawSolver2D`` with
  ``euler_4wave_2D``; ``csrc/step2_ctu.cu``);
* 2D Euler and 2D acoustics on SharpClaw WENO5 (``SharpClawSolver2D``;
  SSP104, SSP33, Euler; ``csrc/dq2_weno5.cu``), and SharpClaw on every
  other 2D and 3D system and option through the generic dq
  (``SharpClawSolver2D/3D``; ``sharpclaw/kernels.py:dq_nd`` around
  ``csrc/weno5.cu``);
* 3D Euler on the classic CTU step (``ClawSolver3D`` with ``euler_3D``;
  ``csrc/step3_ctu.cu``);
* 2D shallow water on the generic AoS CTU step, with aux, capacity and
  f-waves (``ClawSolver2D`` with ``shallow_roe_with_efix_2D`` or
  ``shallow_bathymetry_fwave_2D``; ``csrc/step2_aos.cu``);
* the 1D solvers: advection, acoustics and Euler (Roe with and without
  the entropy fix, HLLE) on the classic sweep (``ClawSolver1D``;
  ``csrc/step1.cu``) and on SharpClaw WENO5 (``SharpClawSolver1D``;
  ``csrc/weno5.cu``);
* 3D heterogeneous acoustics, and the 3D linear acoustics and advection
  systems, on the generic 3D CTU step with aux, capacity and f-waves
  (``ClawSolver3D`` with ``vc_acoustics_3D``, ``acoustics_3D`` or
  ``advection_3D``; ``csrc/step3_aos.cu``).

Frames go through ``fileio`` in the JAX package's five formats: 'ascii'
(the native C++ writer, ``_native``), 'hdf5' (``h5py``), 'netcdf',
'binary' (read only) and the overlay's 'sharded' (``h5py``); every frame
is a restart point, ``Solution(frame, path=..., file_format=...)``.
``plot`` draws them (matplotlib).

ROADMAP.md lists what comes next.
"""

from . import config  # noqa: F401

from .cfl import CFL  # noqa: F401,E402
from .controller import Controller  # noqa: F401,E402
from .geometry import Dimension, Domain, Grid, Patch  # noqa: F401,E402
from .solution import Solution  # noqa: F401,E402
from .solver import BC, Solver  # noqa: F401,E402
from .state import State  # noqa: F401,E402
from .classic import (  # noqa: F401,E402
    ClawSolver1D, ClawSolver2D, ClawSolver3D)
from .sharpclaw import (  # noqa: F401,E402
    SharpClawSolver1D, SharpClawSolver2D, SharpClawSolver3D)
from . import limiters, riemann  # noqa: F401,E402

__version__ = "0.1.0"
