"""Hand-written CUDA kernels and their wrappers (counterpart of
``pyclaw_tpu/ops``).  Sources live in ``csrc/``; ``_build`` compiles them
with nvcc at first use.  Nothing here imports a compiler or touches the
card at import time."""

from .tiled2d import step2_rows  # noqa: F401


def kernel_wrappers():
    """{kernel: wrapper} of every kernel wrapper (for ``dq2_weno``, whose
    launches ``tiled2d.dq_rows`` makes at WENO orders 7-17, the counter
    ``tiled2d.dq_weno_launches``); each adds one to its ``launches`` where
    it launches its kernel, or records the launch into a CUDA graph being
    captured (the solver's device loop), and to its device counter when
    one is set (:func:`count_on_device`)."""
    from . import restore, sweep, tiled2d, weno
    return {"step2_ctu": tiled2d.step2_rows, "dq2_weno5": tiled2d.dq_rows,
            "dq2_weno": tiled2d.dq_weno_launches,
            "step3_ctu": tiled2d.step3_xy,
            "step2_aos": tiled2d.step2_rows_generic,
            "step1": sweep.step1, "weno5": weno.weno5,
            "step3_aos": tiled2d.step3_xy_generic,
            "restore": restore.restore}


def count_on_device(device):
    """Give every kernel wrapper a device counter on ``device`` (an int64
    0-d tensor in ``fn.device_launches``, at 0), to which it adds one on
    the launch's stream right after each launch of its kernel: a launch
    that a CUDA graph captured then counts at each replay, where the
    host's ``fn.launches`` cannot.  ``None`` removes the counters.  A
    graph captured before the counters were set holds no increment.  Off
    by default: each counted launch costs one more small kernel."""
    import torch
    for fn in kernel_wrappers().values():
        fn.device_launches = (None if device is None else
                              torch.zeros((), dtype=torch.int64,
                                          device=device))
