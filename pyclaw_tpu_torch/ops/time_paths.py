"""Time the classic and SharpClaw quadrants, Euler 3D, shallow-water,
Euler capacity, the two Sod, the heterogeneous acoustics, the classic and
SharpClaw shock bubble, the quadrants-off-SoA, the Burgers 3D, the
unsplit p-system and the swirl paths of checkouts against each other on
one card, each run in a process of its own.

    python -m pyclaw_tpu_torch.ops.time_paths LABEL=ROOT[:host]
        [LABEL=ROOT[:host] ...] [--out FILE] [--paths P1,P2]

ROOT is a directory that holds a ``pyclaw_tpu_torch`` package: ``.`` for
this checkout, an unpacked ``git archive`` for another commit; ``:host``
runs its solvers on the host loop (``traced_evolve = False``) in place of
the device loop.  For each
path the labels run in order and then in reverse (parent, change,
change, parent).  Each run is a fresh Python process that imports the
package from ROOT (its kernels build into ROOT's ``build/kernels``),
warms the path up with a short run to t = 0.01, then times
``Controller.run()`` at the path's full size, in float32: quadrants at
1024^2 to t = 0.8 on the classic solver (``step2_ctu``), Euler 3D at
192^3 to t = 0.2 (``step3_ctu``), the shallow-water radial dam break at
1024^2 to t = 1.0 (``step2_aos``) and Euler 3D with the capacity function
of ``examples.euler_3d.add_capacity`` at 192^3 to t = 0.2 (``step3_ctu``;
``step3_aos`` in checkouts before it moved there, so both wrappers'
launches are counted), the SharpClaw quadrants at 1024^2 to t = 0.8
(WENO5, SSP104: ``dq2_weno5``; at WENO order 7: ``dq2_weno``), the Sod
tube at 800 cells to t = 0.2
on the classic solver (``step1``) and on SharpClaw (``weno5``), and the
heterogeneous acoustics at 192^3 to t = 0.8 (``step3_aos``), the shock
bubble at 2048x512 to t = 0.6 (``shock_bubble``: ``step2_aos``'s Euler
5-wave instance), the shock bubble on SharpClaw at 1024x256 to t = 0.6
(``shock_bubble_sharpclaw``: ``dq2_weno5``'s Euler 5-wave instance), the
quadrants at 1024^2 to t = 0.8 off the SoA route (``quadrants_aos``:
``use_soa = False``, ``step2_aos``'s Euler 4-wave instance) and
``burgers_3D`` on its pulse at 192^3 to t = 0.4 (``burgers3d``:
``step3_aos``'s Burgers instance; chip_smoke.py [4v]'s run, built through
the package's API as that run is: periodic, MC, CFL 0.45 / 0.5), the
p-system's unsplit route at 1024^2 to t = 1.0 (``psystem_unsplit``:
``dimensional_split=False``, CFL 0.2 / 0.25, ``step2_aos``'s psystem_2D
instance; [4w]'s run) and the swirl at 1024^2 to t = 2.0 (``swirl``:
``examples.advection_2d``, transverse_waves 0, ``step2_aos``'s
vc_advection_2D instance; [4u]'s run).  It
prints the accepted and rejected steps, the kernel's launches as its
wrappers count them (on the device loop the launches they make or
capture: a capture's eager warm-up attempt and two captured attempts;
a replay counts nothing), the wall seconds, the cell-updates/s and,
where the solver has a device loop, its host readbacks and attempted
steps per output frame, the attempts after the end and the seconds of
its warm-up and capture.  Needs a card; writes the records as JSON to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

# the module name of a path that no example sets up: the child builds it
# with BURGERS3D_SETUP
BURGERS3D = "@burgers_3D"
# (example module, setup keywords (under "solver", attributes set on the
# solver after setup), final time, cells, the wrappers whose launches
# count (module.function of ops), a function of the module applied to the
# state or "") per path
PATHS = {
    "quadrants": ("euler_2d_quadrants", {"mx": 1024, "my": 1024}, 0.8,
                  1024 ** 2, "tiled2d.step2_rows", ""),
    "euler3d": ("euler_3d", {"mx": 192, "my": 192, "mz": 192}, 0.2,
                192 ** 3, "tiled2d.step3_xy", ""),
    "shallow": ("shallow_2d_radial", {"mx": 1024, "my": 1024}, 1.0,
                1024 ** 2, "tiled2d.step2_rows_generic", ""),
    "euler3d_capa": ("euler_3d", {"mx": 192, "my": 192, "mz": 192}, 0.2,
                     192 ** 3, "tiled2d.step3_xy,tiled2d.step3_xy_generic",
                     "add_capacity"),
    "sharpclaw": ("euler_2d_quadrants", {"mx": 1024, "my": 1024,
                                         "solver_type": "sharpclaw"}, 0.8,
                  1024 ** 2, "tiled2d.dq_rows", ""),
    "sharpclaw_weno7": ("euler_2d_quadrants",
                        {"mx": 1024, "my": 1024, "solver_type": "sharpclaw",
                         "solver": {"weno_order": 7}}, 0.8, 1024 ** 2,
                        "tiled2d.dq_weno_launches", ""),
    "sod": ("euler_1d_shocktube", {"nx": 800, "solver_type": "classic"},
            0.2, 800, "sweep.step1", ""),
    "sod_sharpclaw": ("euler_1d_shocktube", {"nx": 800,
                                             "solver_type": "sharpclaw"},
                      0.2, 800, "weno.weno5", ""),
    "het": ("acoustics_3d_heterogeneous", {"mx": 192, "my": 192, "mz": 192},
            0.8, 192 ** 3, "tiled2d.step3_xy_generic", ""),
    "shock_bubble": ("shock_bubble", {"mx": 2048, "my": 512}, 0.6,
                     2048 * 512, "tiled2d.step2_rows_generic", ""),
    "quadrants_aos": ("euler_2d_quadrants",
                      {"mx": 1024, "my": 1024, "solver": {"use_soa": False}},
                      0.8, 1024 ** 2, "tiled2d.step2_rows_generic", ""),
    "shock_bubble_sharpclaw": ("shock_bubble",
                               {"mx": 1024, "my": 256,
                                "solver_type": "sharpclaw"}, 0.6,
                               1024 * 256, "tiled2d.dq_rows", ""),
    "burgers3d": (BURGERS3D, {"mx": 192, "my": 192, "mz": 192}, 0.4,
                  192 ** 3, "tiled2d.step3_xy_generic", ""),
    "psystem_unsplit": ("psystem_2d", {"mx": 1024, "my": 1024,
                                       "dimensional_split": False}, 1.0,
                        1024 ** 2, "tiled2d.step2_rows_generic", ""),
    "swirl": ("advection_2d", {"mx": 1024, "my": 1024}, 2.0, 1024 ** 2,
              "tiled2d.step2_rows_generic", ""),
}

# burgers_3D as chip_smoke.py [4v] runs it (scalar_claw): the pulse
# exp(-30 |x - 1/2|^2) on the unit cube, periodic, MC, CFL 0.45 / 0.5,
# through the package's API (the same in every checkout that has the
# system)
BURGERS3D_SETUP = r"""
import numpy as np
import pyclaw_tpu_torch as pyclaw


def setup(mx, my, mz, outdir=None, dtype=np.float32, device=None):
    solver = pyclaw.ClawSolver3D(pyclaw.riemann.burgers_3D, device=device)
    solver.limiters = [pyclaw.limiters.tvd.MC]
    solver.all_bcs = pyclaw.BC.periodic
    solver.cfl_desired, solver.cfl_max = 0.45, 0.5
    domain = pyclaw.Domain([0.0] * 3, [1.0] * 3, [mx, my, mz])
    state = pyclaw.State(domain, 1, dtype=dtype)
    axes = [(np.arange(n) + 0.5) / n - 0.5 for n in (mx, my, mz)]
    grids = np.meshgrid(*axes, indexing="ij")
    state.q[0] = np.exp(-30.0 * sum(g * g for g in grids))
    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.num_output_times = 1
    claw.outdir = outdir
    claw.output_format = None
    return claw
"""

CHILD = r"""
import importlib, json, sys, time, types
import numpy as np
import torch
root, module, kw, tfinal, cells, wrappers, post, device, host = sys.argv[1:10]
BURGERS3D_SETUP = sys.argv[10]
sys.path.insert(0, root)
sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
if host == "host":
    from pyclaw_tpu_torch.solver import Solver
    Solver.traced_evolve = False
if module.startswith("@"):
    ex = types.SimpleNamespace()
    exec(BURGERS3D_SETUP, vars(ex))
else:
    ex = importlib.import_module("pyclaw_tpu_torch.examples." + module)
kw = json.loads(kw)
solver_attrs = kw.pop("solver", {})

def make(t):
    claw = ex.setup(outdir=None, dtype=np.float32, device=device, **kw)
    for name, value in solver_attrs.items():
        setattr(claw.solver, name, value)
    if post:
        getattr(ex, post)(claw.solution.state)
    claw.tfinal = t
    claw.keep_copy = False
    return claw

make(0.01).run()
claw = make(float(tfinal))
fns = []
for w in wrappers.split(","):
    mod, name = w.split(".")
    fns.append(getattr(importlib.import_module("pyclaw_tpu_torch.ops."
                                               + mod), name))
for fn in fns:
    fn.launches = 0
sync()
t0 = time.perf_counter()
status = claw.run()
sync()
wall = time.perf_counter() - t0
stats = getattr(claw.solver, "loop_stats", None)
print(json.dumps({"accepted": status["numsteps"],
                  "rejected": status["numrejected"],
                  "launches": sum(fn.launches for fn in fns), "wall_s": wall,
                  "cell_updates_per_s": status["numsteps"] * int(cells)
                  / wall,
                  "loop": None if stats is None else dict(stats)}))
"""


def run_one(root, path, device="cuda", size=None, tfinal=None, host=False):
    """One timed run of ``path`` from ROOT in a fresh process (``size``
    and ``tfinal`` override the path's setup keywords and final time: the
    CPU tests run it small; ``host`` takes the host loop)."""
    module, kw, t_path, cells, wrappers, post = PATHS[path]
    kw = kw if size is None else size
    cells = cells if size is None else math.prod(
        v for v in size.values()
        if isinstance(v, int) and not isinstance(v, bool))
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, root, module, json.dumps(kw),
         str(t_path if tfinal is None else tfinal), str(cells), wrappers,
         post, device, "host" if host else "device", BURGERS3D_SETUP],
        cwd=root,
        capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{path} from {root} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+",
                    type=lambda v: tuple(v.split("=", 1)))
    ap.add_argument("--out")
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="comma-separated paths to time (default: all)")
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    order = args.variants + args.variants[::-1]
    result = {"card": card, "order": [label for label, _ in order],
              "paths": {}}
    for path in args.paths.split(","):
        runs = {label: [] for label, _ in args.variants}
        for label, root in order:
            root, _, mode = root.partition(":")
            rec = run_one(os.path.abspath(root), path, host=mode == "host")
            runs[label].append(rec)
            loop = rec.get("loop")
            per = "" if not (loop and loop["frames"]) else (
                f"; {loop['readbacks'] / loop['frames']:.2f} readbacks and "
                f"{loop['attempts'] / loop['frames']:.2f} attempts a frame, "
                f"{loop['after_end']} after the end, warm-up "
                f"{loop['warmup_s']:.4f} s, capture "
                f"{loop['capture_s']:.4f} s")
            print(f"  {path} [{label}]: {rec['accepted']} + "
                  f"{rec['rejected']} steps, {rec['launches']} launches, "
                  f"{rec['wall_s']:.3f} s, "
                  f"{rec['cell_updates_per_s']:.4e} cell-updates/s{per}",
                  flush=True)
        result["paths"][path] = runs
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
