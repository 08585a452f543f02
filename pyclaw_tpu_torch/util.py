"""The examples' command line and the test machinery.

Counterpart of ``pyclaw_tpu/util.py``: ``run_app_from_main`` (bare
``key=value`` tokens, the de-facto CLI of every example, and the
``htmlplot`` / ``iplot`` tokens, which plot the run's frames with the
example's ``setplot``), ``check_diff`` (tolerance comparison returning
None on pass) and ``gen_variants`` / ``test_app`` (one test callable per
variant):

    python -m pyclaw_tpu_torch.examples.euler_2d_quadrants mx=400 my=400
    python -m pyclaw_tpu_torch.examples.kpp device=cpu htmlplot
    torchrun --nproc-per-node 4 -m pyclaw_tpu_torch.examples.euler_3d \\
        use_parallel=True mx=192 my=192 mz=192 dtype=float32

With ``use_parallel=True`` the process first joins the launcher's process
group (:func:`pyclaw_tpu_torch.parallel.init_distributed`: NCCL on the
card, ``gloo`` with ``device=cpu``).  Plotting needs matplotlib.
"""

from __future__ import annotations

import sys

import numpy as np


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


def run_app_from_main(application, argv=None, setplot=None):
    """Parse ``argv`` (default ``sys.argv[1:]``) ``key=value`` tokens into
    keywords, run ``application(**kwargs)``, print the status on the main
    process (rank 0) and return it.  ``iplot`` shows the run's frames
    (``Controller.plot``), ``htmlplot`` writes them as PNGs and an
    index.html under ``<outdir>/_plots`` (``plot.html_plot``), each with
    ``setplot``, on the main process."""
    from . import parallel
    kwargs = {}
    plot_requested = False
    for arg in sys.argv[1:] if argv is None else argv:
        if arg in ("htmlplot", "iplot"):
            plot_requested = arg
            continue
        if "=" not in arg:
            raise ValueError(f"arguments must be key=value pairs, got {arg!r}")
        key, value = arg.split("=", 1)
        kwargs[key] = _coerce(value)
    if kwargs.get("use_parallel"):
        parallel.init_distributed(device=kwargs.get("device"))
    claw = application(**kwargs)
    status = claw.run()
    if not parallel.is_main_process():
        return status
    print(status)
    if plot_requested == "iplot":
        claw.plot(setplot=setplot)
    elif plot_requested == "htmlplot":
        from . import plot
        plot.html_plot(outdir=claw.outdir, setplot=setplot)
    return status


def check_diff(expected, test, **kwargs):
    """Tolerance comparison (reference util.check_diff): returns None on
    pass, else (expected, test, diff-info)."""
    expected = np.asarray(expected)
    test = np.asarray(test)
    if "reltol" in kwargs:
        err = np.max(np.abs(expected - test)) / np.max(np.abs(expected))
        if err < kwargs["reltol"]:
            return None
        return (expected, test, f"relative error {err} > {kwargs['reltol']}")
    elif "abstol" in kwargs:
        err = np.max(np.abs(expected - test))
        if err < kwargs["abstol"]:
            return None
        return (expected, test, f"absolute error {err} > {kwargs['abstol']}")
    elif "delta" in kwargs:
        diff = expected - test
        if np.all(np.abs(diff) < kwargs["delta"]):
            return None
        return (expected, test, f"delta exceeded {kwargs['delta']}")
    raise ValueError("check_diff needs reltol, abstol, or delta")


def gen_variants(application, verifier, kernel_languages=("xla",),
                 solver_type="classic", **kwargs):
    """Yield one test callable per entry of ``kernel_languages`` (reference
    util.gen_variants, with the JAX package's signature).  The port's
    device picks the kernel, so :func:`test_app` drops the
    ``kernel_language`` key before it calls the example, as
    ``validate.py:setup_case`` does: every variant runs the same route."""
    for backend in kernel_languages:
        kw = dict(kwargs)
        kw["kernel_language"] = backend
        kw["solver_type"] = solver_type
        yield lambda kw=kw: test_app(application, verifier, kw)


def test_app(application, verifier, kwargs):
    """Run ``application(**kwargs)`` (no output files unless ``outdir`` is
    given; ``kernel_language`` dropped) and raise AssertionError unless
    ``verifier(claw)`` returns None."""
    kwargs = {k: v for k, v in kwargs.items() if k != "kernel_language"}
    kwargs.setdefault("outdir", None)
    claw = application(**kwargs)
    claw.run()
    result = verifier(claw)
    if result is not None:
        raise AssertionError(f"verification failed: {result[2] if len(result) > 2 else result}")
    return None
