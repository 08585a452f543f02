"""SharpClaw method-of-lines solvers (counterpart of
``pyclaw_tpu/sharpclaw``).  This slice ports the 2D WENO5 path of the
Euler 4-wave system."""

from .solver import SharpClawSolver, SharpClawSolver2D  # noqa: F401
