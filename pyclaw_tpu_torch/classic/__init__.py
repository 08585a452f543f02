"""Classic Clawpack solvers (counterpart of ``pyclaw_tpu/classic``).
This slice ports the 2D unsplit CTU solver."""

from .solver import ClawSolver, ClawSolver2D  # noqa: F401
