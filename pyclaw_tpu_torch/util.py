"""The examples' command line.

Counterpart of ``pyclaw_tpu/util.py``'s ``run_app_from_main`` (bare
``key=value`` tokens, the de-facto CLI of every example):

    python -m pyclaw_tpu_torch.examples.euler_2d_quadrants mx=400 my=400
    torchrun --nproc-per-node 4 -m pyclaw_tpu_torch.examples.euler_3d \\
        use_parallel=True mx=192 my=192 mz=192 dtype=float32

With ``use_parallel=True`` the process first joins the launcher's process
group (:func:`pyclaw_tpu_torch.parallel.init_distributed`: NCCL on the
card, ``gloo`` with ``device=cpu``).  The test machinery of the JAX
module (``check_diff``, ``gen_variants``, ``test_app``) and its plotting
are not ported yet.
"""

from __future__ import annotations

import sys

from .solver import _not_ported


def _coerce(value):
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    if value in ("True", "true"):
        return True
    if value in ("False", "false"):
        return False
    if value == "None":
        return None
    return value


def run_app_from_main(application, argv=None):
    """Parse ``argv`` (default ``sys.argv[1:]``) ``key=value`` tokens into
    keywords, run ``application(**kwargs)``, print the status on the main
    process (rank 0) and return it."""
    from . import parallel
    kwargs = {}
    for arg in sys.argv[1:] if argv is None else argv:
        if arg in ("htmlplot", "iplot"):
            raise _not_ported("plotting")
        if "=" not in arg:
            raise ValueError(f"arguments must be key=value pairs, got {arg!r}")
        key, value = arg.split("=", 1)
        kwargs[key] = _coerce(value)
    if kwargs.get("use_parallel"):
        parallel.init_distributed(device=kwargs.get("device"))
    status = application(**kwargs).run()
    if parallel.is_main_process():
        print(status)
    return status
