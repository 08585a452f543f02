"""Distributed overlay: the PetClaw equivalent on ``torch.distributed``.

Counterpart of ``pyclaw_tpu/parallel`` (a rebuild of reference
``src/petclaw/``).  The overlay substitutes the data model, not the
solvers: each rank (one process; NCCL between CUDA cards, ``gloo`` on the
CPU) runs the port's serial step, and through it the hand kernels, on its
block of the grid, with the reference's per-step communication events:

  1. halo exchange : DMDA globalToLocal -> ``dist.batch_isend_irecv`` of
                     the faces, axis by axis (BOX corner semantics)
  2. CFL reduction : MPI Allreduce(MAX) -> ``dist.all_reduce(MAX)``
  3. frames        : one ``all_gather`` of the blocks into the global q
                     on every rank; each rank writes its block of a
                     'sharded' frame (``parallel/io.py``,
                     ``fileio/sharded.py``), rank 0 the gather formats
  4. gauges        : the owner of a gauge's cell reads it, one small
                     ``all_gather`` an accepted step; rank 0 writes them

Usage (mirrors ``import clawpack.petclaw as pyclaw``), one process a rank
(``torchrun --nproc-per-node N program.py``):

    from pyclaw_tpu_torch import parallel as pyclaw
    pyclaw.init_distributed()
    solver = pyclaw.ClawSolver2D(riemann.euler_4wave_2D)   # distributed
    ... everything else identical ...

The solver builds a near-square mesh over all ranks by default; pass
``mesh=make_mesh(num_dim, mesh_shape)`` to choose the decomposition.
"""

from ..geometry import Dimension, Domain, Grid, Patch  # noqa: F401
from ..solution import Solution  # noqa: F401
from ..solver import BC  # noqa: F401
from ..state import State  # noqa: F401
from .controller import Controller  # noqa: F401 (rank-0 frame output)
from .distributed import (init_distributed, is_main_process,  # noqa: F401
                          process_count, process_index)
from .mesh import make_mesh  # noqa: F401
from .solver import (ClawSolver1D, ClawSolver2D, ClawSolver3D,  # noqa: F401
                     SharpClawSolver1D, SharpClawSolver2D, SharpClawSolver3D)
