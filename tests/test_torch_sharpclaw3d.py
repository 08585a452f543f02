"""The port's SharpClaw in 3D (``SharpClawSolver3D`` on
``sharpclaw/kernels.py:dq_nd``) against the JAX package's, on the CPU, in
float64: the 3D half of tests/test_torch_sharpclaw_nd.py, in a file of
its own so that the two share the CPU's workers.

* ``dq_nd`` against the JAX package's ``dq_nd`` (``backend="xla"``,
  jitted) on seeded ghost-padded states, to 1e-12 of max|dq| and the CFL
  to 1e-12 relative: Euler 3D, acoustics 3D, advection 3D,
  ``vc_acoustics_3D`` with aux, Euler 3D with a capacity row, and
  ``char_decomp`` 1-4 on Euler 3D (2-4 also on ``vc_acoustics_3D``,
  whose eigenvectors read aux);
* whole runs of the SharpClaw routes of ``examples/euler_3d.py`` and
  ``examples/acoustics_3d_heterogeneous.py`` at 10^3 against the JAX
  examples: equal steps, t equal, q to 1e-12 of max|q|;
* the device loop's eager attempt against the host loop, bit for bit.
"""

import numpy as np
import pytest
import torch

from test_torch_sharpclaw_nd import check_dq_nd, check_example

# (system, char_decomp, capacity row)
CASES = ([(n, 0, False) for n in ("euler_3D", "acoustics_3D", "advection_3D",
                                  "vc_acoustics_3D")]
         + [("euler_3D", 0, True)]
         + [("euler_3D", cd, False) for cd in (1, 2, 3, 4)]
         + [("vc_acoustics_3D", cd, False) for cd in (2, 3, 4)])


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("name,cd,capa", CASES)
def test_dq_nd_3d_matches_jax(name, cd, capa):
    check_dq_nd(name, cd, capa)


@pytest.mark.parametrize("name", ["euler_3d", "acoustics_3d_heterogeneous"])
def test_example_sharpclaw_3d_route_matches_jax(name):
    check_example(name, dict(mx=10, my=10, mz=10))


def test_device_loop_equals_host_loop_sharpclaw_3d():
    """The device loop's attempt, run eagerly on the CPU, against the host
    loop: the same bits and counts (first step rejected from
    dt_initial 0.1 at 8^3)."""
    from pyclaw_tpu_torch.examples import euler_3d
    claws = [euler_3d.setup(mx=8, my=8, mz=8, outdir=None, device="cpu",
                            solver_type="sharpclaw") for _ in range(2)]
    claws[0].solver.traced_evolve = False
    for c in claws:
        c.run()
    assert np.array_equal(claws[0].solution.q, claws[1].solution.q)
    s0, s1 = claws[0].solver.status, claws[1].solver.status
    for key in ("numsteps", "numrejected", "cflmax", "dtmin", "dtmax"):
        assert s0[key] == s1[key]
    assert s1["numsteps"] >= 2
    assert getattr(claws[0].solver, "_evolve_fn", None) is None
    assert claws[1].solver.loop_stats["attempts"] >= s1["numsteps"]


def _asymmetry(q):
    """max over the three exchanges of two axes of |q - q mirrored| (the
    matching momentum components swapped too), relative to max|q|."""
    out = []
    for a, b in ((0, 1), (0, 2), (1, 2)):
        m = np.swapaxes(q, 1 + a, 1 + b).copy()
        m[[1 + a, 1 + b]] = m[[1 + b, 1 + a]]
        out.append(float(np.abs(m - q).max() / np.abs(q).max()))
    return out


def _roundoff_readings(n3, dtype3, n2):
    """How far the SharpClaw runs' roundoff grows, on the CPU's plain path:
    the axis asymmetry of examples/euler_3d.py's SharpClaw run at n3^3 in
    ``dtype3`` at each of its four frames (the problem is symmetric under
    each exchange of two axes), and examples/acoustics_2d.py's SharpClaw
    run at n2^2 in float32 against the same run in float64.  One JSON
    line."""
    import json
    import time

    from pyclaw_tpu_torch.examples import acoustics_2d, euler_3d
    out = {}
    claw = euler_3d.setup(mx=n3, my=n3, mz=n3, outdir=None, device="cpu",
                          solver_type="sharpclaw", dtype=dtype3)
    claw.num_output_times, claw.keep_copy = 4, True
    t0 = time.time()
    status = claw.run()
    out["euler_3d"] = {"n": n3, "dtype": dtype3,
                       "steps": [status["numsteps"], status["numrejected"]],
                       "seconds": time.time() - t0,
                       "asymmetry_by_frame": [
                           (f.t, _asymmetry(np.asarray(f.q, np.float64)))
                           for f in claw.frames]}
    qs = {}
    for dtype in ("float32", "float64"):
        claw = acoustics_2d.setup(mx=n2, my=n2, outdir=None, device="cpu",
                                  solver_type="sharpclaw", dtype=dtype)
        claw.run()
        qs[dtype] = claw.solution.q.astype(np.float64)
    d = np.abs(qs["float32"] - qs["float64"])
    out["acoustics_2d"] = {
        "n": n2, "f32_vs_f64_max": float(d.max() / np.abs(qs["float64"]).max()),
        "f32_vs_f64_l1": float(d.sum() / np.abs(qs["float64"]).sum()),
        "f32_p_mirror": float(np.abs(qs["float32"][0] - qs["float32"][0].T)
                              .max() / np.abs(qs["float32"][0]).max())}
    print(json.dumps(out))


if __name__ == "__main__":
    # python tests/test_torch_sharpclaw3d.py --roundoff 96 float32 1024
    # (the CPU, a few minutes)
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--roundoff", nargs=3, metavar=("N3", "DTYPE3", "N2"),
                    required=True)
    args = ap.parse_args()
    torch.set_num_threads(8)
    _roundoff_readings(int(args.roundoff[0]), args.roundoff[1],
                       int(args.roundoff[2]))
