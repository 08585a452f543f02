"""Classic Clawpack solvers (counterpart of ``pyclaw_tpu/classic``):
the 1D sweep and the 2D and 3D unsplit CTU solvers."""

from .solver import (  # noqa: F401
    ClawSolver, ClawSolver1D, ClawSolver2D, ClawSolver3D)
