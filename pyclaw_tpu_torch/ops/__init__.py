"""Hand-written CUDA kernels and their wrappers (counterpart of
``pyclaw_tpu/ops``).  Sources live in ``csrc/``; ``_build`` compiles them
with nvcc at first use.  Nothing here imports a compiler or touches the
card at import time."""

from .tiled2d import step2_rows  # noqa: F401
