"""SharpClaw method-of-lines solvers (counterpart of
``pyclaw_tpu/sharpclaw``): the 1D WENO5 path of every registered 1D
system and the 2D WENO5 path of the Euler 4-wave system; in 3D the
solver class only (its setup raises)."""

from .solver import (  # noqa: F401
    SharpClawSolver, SharpClawSolver1D, SharpClawSolver2D, SharpClawSolver3D)
