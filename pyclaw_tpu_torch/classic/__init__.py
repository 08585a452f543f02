"""Classic Clawpack solvers (counterpart of ``pyclaw_tpu/classic``):
the 2D and 3D unsplit CTU solvers."""

from .solver import ClawSolver, ClawSolver2D, ClawSolver3D  # noqa: F401
