"""Golden validation of the port on its device: the counterpart of
``tools/tpu_validate.py``.

The CPU tests hold the port against the JAX package in float64.  This
runs the same ten golden cases (``tests/golden/*.npz``, made by the JAX
package's float64 CPU path) through the port's example copies on the
card, in float32 (the product) or float64, and compares each final q
with its golden: max |q - q_golden| over max |q_golden|, against the
tool's tolerance for float32 and ``GOLDEN_TOL_F64`` for float64, and the
final time to 1e-10.

    python -m pyclaw_tpu_torch.validate [--dtype float64] [--device cpu]

prints one JSON line (the device, the dtype, whether every case is ok,
and each case's record) and exits non-zero unless every case is ok.

Two cases cannot be held to their tolerance by any run that does not
repeat the golden's arithmetic bit for bit: the dry dam break in float32
and the characteristic Sod tube in float64.  The JAX package's own run,
from its initial state moved by one ulp, misses their goldens by more
than the tolerance for many seeds (``python tests/test_torch_validate.py``
prints the readings).  They are reported as they are, not ok.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")

# (golden name, example module of pyclaw_tpu_torch.examples, setup
# keywords, float32 tolerance): tools/tpu_validate.py:35-57, case for case
CASES = [
    ("advection_1d", "advection_1d", dict(nx=100), 5e-4),
    ("advection_1d_sharpclaw", "advection_1d",
     dict(nx=100, solver_type="sharpclaw"), 5e-4),
    ("acoustics_2d", "acoustics_2d", dict(mx=60, my=60), 2e-3),
    ("euler_2d_quadrants", "euler_2d_quadrants",
     dict(mx=80, my=80, solver_type="classic"), 1e-3),
    ("euler_1d_sod_sharpclaw", "euler_1d_shocktube",
     dict(nx=200, solver_type="sharpclaw"), 1e-3),
    ("euler_3d", "euler_3d", dict(mx=16, my=16, mz=16), 1e-3),
    ("shallow_2d_radial", "shallow_2d_radial", dict(mx=60, my=60), 2e-3),
    ("dam_break_dry_1d", "dam_break_dry", dict(nx=200, dimension=1),
     2e-3),
    ("euler_1d_sod_chardecomp", "euler_1d_shocktube",
     dict(nx=200, solver_type="sharpclaw", char_decomp=2), 1e-3),
    ("euler_2d_quadrants_128", "euler_2d_quadrants",
     dict(mx=128, my=128, solver_type="classic",
          kernel_language="pallas"), 1e-3),
]
# the float64 tolerance of every case (chip_smoke.py:GOLDEN_TOL)
GOLDEN_TOL_F64 = 1e-8


def setup_case(module, kwargs, device, dtype):
    """The Controller of one case, from the port's example ``module``.
    ``kernel_language`` is the JAX example's choice of kernel; the port's
    device picks it (the 128^2 quadrants case then runs csrc/step2_ctu.cu,
    as the classic path does), so it is dropped."""
    ex = importlib.import_module(f"pyclaw_tpu_torch.examples.{module}")
    kw = {k: v for k, v in kwargs.items() if k != "kernel_language"}
    return ex.setup(outdir=None, device=device, dtype=dtype, **kw)


def run_case(module, kwargs, device, dtype):
    """The final (q as float64, t) of one case through Controller.run()."""
    claw = setup_case(module, kwargs, device, dtype)
    claw.run()
    return np.asarray(claw.solution.q, dtype=np.float64), claw.solution.t


def validate(cases=CASES, device=None, dtype="float32"):
    """Run the golden cases on ``device`` (None: the port's default, the
    card) in ``dtype`` ("float32" or "float64").  Returns {name:
    {"rel_err", "tol", "ok", "t", "t_ok", "seconds"}}: ``tol`` the case's
    tolerance, ``t_ok`` whether the final time is the golden's to 1e-10,
    ``ok`` whether rel_err is below ``tol`` and ``t_ok``, ``seconds`` the
    run's wall time.  A case that raises is reported with ``ok`` False
    and its error."""
    dt = np.dtype(dtype).type
    results = {}
    for name, module, kwargs, tol32 in cases:
        tol = tol32 if dtype == "float32" else GOLDEN_TOL_F64
        try:
            ref = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
            t0 = time.perf_counter()
            q, t = run_case(module, kwargs, device, dt)
            seconds = time.perf_counter() - t0
            scale = float(np.max(np.abs(ref["q"])))
            rel = float(np.max(np.abs(q - ref["q"]))) / scale
            t_ok = abs(t - float(ref["t"])) < 1e-10
            rec = {"rel_err": rel, "tol": tol, "t": t, "t_ok": t_ok,
                   "seconds": seconds, "ok": bool(rel < tol) and t_ok}
        except Exception as e:  # noqa: BLE001 -- reported, as the tool does
            rec = {"ok": False, "error": repr(e)}
        results[name] = rec
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    import torch
    from .config import resolve_device
    dev = resolve_device(args.device)
    res = validate(device=dev, dtype=args.dtype)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    out = {"device": name, "dtype": args.dtype,
           "all_ok": all(r.get("ok") for r in res.values()), "cases": res}
    print(json.dumps(out))
    return 0 if out["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
