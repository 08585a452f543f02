"""The 2D Euler family off the SoA route and ``sw_aug_2D``, whole runs of
the port against the JAX package's (CPU, float64).

* ``shock_bubble`` (``euler_5wave_2D``, the passive tracer): the classic
  solver with MC on the generic CTU step (``classic/kernels.py:step2``,
  the plain version of ``csrc/step2_aos.cu``'s Euler 5-wave instance;
  the JAX package runs its SoA body, the same step to roundoff) and
  SharpClaw on the SoA dq (``sharpclaw/soa.py:dq_2d_soa`` with the
  tracer's hooks, the plain version of ``csrc/dq2_weno5.cu``'s Euler
  5-wave instance), at 40x10 to t = 0.6: equal steps, q to 1e-12 of
  max|q|, the tracer's sum kept;
* the Riemann-quadrants problem on the generic step: with
  ``use_soa=False``, with a capacity row in aux, and with ``fwave=True``,
  at 16^2 to t = 0.8;
* ``sw_aug_2D``: ``radial_bump_bathymetry`` at 24^2, ``dam_break_dry``
  with ``dimension=2`` at 16^2 (h >= 0), SharpClaw on the generic dq
  (``sharpclaw/kernels.py:dq_nd``: sw_aug_2D has no SoA hooks), and a
  lake at rest, over a submerged bump and against a dry island,
  machine-still.
"""

import os
import sys

import numpy as np
import pytest
import torch

import pyclaw_tpu
import pyclaw_tpu_torch
from pyclaw_tpu_torch.examples import dam_break_dry as tdb
from pyclaw_tpu_torch.examples import euler_2d_quadrants as tq
from pyclaw_tpu_torch.examples import radial_bump_bathymetry as trb
from pyclaw_tpu_torch.examples import shock_bubble as tsb
from pyclaw_tpu_torch.ops import tiled2d

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import dam_break_dry as jdb  # noqa: E402
import euler_2d_quadrants as jq  # noqa: E402
import radial_bump_bathymetry as jrb  # noqa: E402
import shock_bubble as jsb  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _same_run(claw, jclaw, tol=1e-12):
    """Run both; the same accepted steps and final time, q within tol of
    max|q|.  Returns the port's status."""
    status = claw.run()
    jstatus = jclaw.run()
    assert status["numsteps"] == jstatus["numsteps"]
    assert claw.solution.t == pytest.approx(float(jclaw.solution.t),
                                            abs=1e-12)
    q_j = np.asarray(jclaw.solution.q)
    q = claw.solution.q
    assert q.shape == q_j.shape and np.all(np.isfinite(q))
    assert np.abs(q - q_j).max() <= tol * np.abs(q_j).max()
    return status


@pytest.mark.parametrize("solver_type", ["classic", "sharpclaw"])
def test_shock_bubble_matches_jax(solver_type):
    claw = tsb.setup(mx=40, my=10, solver_type=solver_type, outdir=None,
                     device="cpu", dtype=np.float64)
    jclaw = jsb.setup(mx=40, my=10, solver_type=solver_type, outdir=None)
    state = claw.solution.state
    # classic: the generic step (the JAX package's SoA test holds, the
    # port's kernel for the 5-wave system is step2_aos.cu); SharpClaw: the
    # SoA dq, as in the JAX package
    assert claw.solver._soa_eligible(state) == (solver_type == "sharpclaw")
    tracer0 = state.q[4].sum()
    status = _same_run(claw, jclaw)
    q = claw.solution.q
    assert q[0].min() > 0.0 and status["numsteps"] > 10
    # the tracer is conserved until it reaches the outflow (the JAX
    # package's own check, tests/test_examples_tail.py)
    np.testing.assert_allclose(q[4].sum(), tracer0, rtol=1e-3)


def _capacity(claw):
    """A non-uniform capacity row kappa = 1 + 0.25 cos(pi x) cos(pi y) in
    aux[0] of a quadrants run (either package)."""
    state = claw.solution.state
    x, y = claw.solution.domain.grid.c_centers
    state.aux = (1.0 + 0.25 * np.cos(np.pi * x) * np.cos(np.pi * y))[None]
    state.index_capa = 0


@pytest.mark.parametrize("form", ["use_soa=False", "capacity", "fwave"])
def test_quadrants_on_the_generic_step_match_jax(form):
    claws = [tq.setup(mx=16, my=16, outdir=None, device="cpu",
                      dtype=np.float64), jq.setup(mx=16, my=16, outdir=None)]
    for c in claws:
        if form == "use_soa=False":
            c.solver.use_soa = False
        elif form == "capacity":
            _capacity(c)
        else:
            c.solver.fwave = True
    assert not claws[0].solver._soa_eligible(claws[0].solution.state)
    before = tiled2d.step2_rows_generic.launches
    _same_run(*claws)
    # on the CPU the wrapper runs the plain version and counts no launch
    assert tiled2d.step2_rows_generic.launches == before


def test_radial_bump_bathymetry_matches_jax():
    claw = trb.setup(mx=24, my=24, outdir=None, device="cpu",
                     dtype=np.float64)
    jclaw = jrb.setup(mx=24, my=24, outdir=None)
    _same_run(claw, jclaw)


def test_dam_break_dry_2d_matches_jax():
    claw = tdb.setup(nx=16, dimension=2, outdir=None, device="cpu",
                     dtype=np.float64)
    jclaw = jdb.setup(nx=16, dimension=2, outdir=None)
    mass0 = claw.solution.q[0].sum()
    _same_run(claw, jclaw)
    for frame in claw.frames:
        assert frame.q[0].min() >= 0.0
    # the water stays on the plane beach: nothing reaches the boundary
    assert abs(claw.solution.q[0].sum() - mass0) <= 1e-12 * mass0


def _sharpclaw_sw_aug(pkg, claw):
    """The radial bump's claw with its solver replaced by SharpClaw
    (WENO5, SSP104) on sw_aug_2D, the BCs of the example."""
    kw = {} if pkg is pyclaw_tpu else {"device": "cpu"}
    solver = pkg.SharpClawSolver2D(pkg.riemann.sw_aug_2D, **kw)
    solver.all_bcs = pkg.BC.extrap
    solver.aux_bc_lower = [pkg.BC.extrap] * 2
    solver.aux_bc_upper = [pkg.BC.extrap] * 2
    claw.solver = solver
    claw.tfinal = 0.1
    return claw


def test_sharpclaw_sw_aug_on_the_generic_dq_matches_jax():
    claw = _sharpclaw_sw_aug(pyclaw_tpu_torch, trb.setup(
        mx=16, my=16, outdir=None, device="cpu", dtype=np.float64))
    jclaw = _sharpclaw_sw_aug(pyclaw_tpu, jrb.setup(mx=16, my=16,
                                                    outdir=None))
    claw.solver.setup(claw.solution)
    assert not claw.solver._soa_eligible(claw.solution.state)
    _same_run(claw, jclaw)


@pytest.mark.parametrize("island", [False, True])
def test_sw_aug_lake_at_rest_is_machine_still(island):
    """h + b = 1, u = v = 0 over the radial bump (submerged), or over a
    bump that rises above the surface (a dry island: its shore cells are
    walls) stays at rest to roundoff."""
    claw = trb.setup(mx=24, my=24, perturb=0.0, outdir=None, device="cpu",
                     dtype=np.float64)
    state = claw.solution.state
    if island:
        x, y = claw.solution.domain.grid.c_centers
        state.aux[0] = 1.5 * np.exp(-10.0 * (x ** 2 + y ** 2))
        state.q[0] = np.maximum(1.0 - state.aux[0], 0.0)
        assert (state.q[0] == 0.0).any()
    wet = state.q[0] > 0.0
    claw.tfinal = 0.1
    claw.run()
    q, b = claw.solution.q, claw.solution.state.aux[0]
    # roundoff of the unit depth in the wet cells and on the island
    assert np.abs((q[0] + b - 1.0)[wet]).max() <= 1e-14
    assert np.abs(q[0][~wet]).max(initial=0.0) <= 1e-14
    assert np.abs(q[1:]).max() <= 1e-14


def test_soa_dq_carries_the_tracer_as_jax():
    """sharpclaw/soa.py:dq_2d_soa, generic over num_eqn, with the 5-wave
    SoA hooks (the tracer's waves, flux and the positivity fallback)
    against the JAX package's dq_2d_soa on one seeded state."""
    import jax.numpy as jnp
    from pyclaw_tpu import riemann as jriemann
    from pyclaw_tpu.sharpclaw import soa as jsoa
    from pyclaw_tpu_torch import riemann as triemann
    from pyclaw_tpu_torch.sharpclaw import soa as tsoa
    rng = np.random.default_rng(12)
    n = (26, 19)
    rho = np.where(rng.random(n) < 0.1, 1e-3, 0.5 + rng.random(n))
    u, v = rng.standard_normal(n), rng.standard_normal(n)
    p = 0.5 + rng.random(n)
    qbc = np.stack([rho, rho * u, rho * v,
                    p / 0.4 + 0.5 * rho * (u * u + v * v),
                    rho * rng.random(n)])
    params = {"gamma": 1.4}
    out = []
    for pkg, soa, arr in ((triemann, tsoa, torch.from_numpy),
                          (jriemann, jsoa, jnp.asarray)):
        rp = pkg.euler_5wave_2D
        d, c = soa.dq_2d_soa(arr(qbc), 0.01, 0.05, 0.05, rp.rpn_soa, params,
                             5, 3, positivity=rp.positivity,
                             flux_soa=rp.flux_soa)
        out.append((np.asarray(d), float(c)))
    (d_t, c_t), (d_j, c_j) = out
    assert d_t.shape == (5, 20, 13)
    assert np.abs(d_t - d_j).max() <= 1e-12 * np.abs(d_j).max()
    assert np.abs(d_t[4] - d_j[4]).max() <= 1e-12 * np.abs(d_j[4]).max()
    assert abs(c_t - c_j) <= 1e-12 * c_j


# ---- the CPU readings that PERF.md and chip_smoke.py cite -----------------
def _perturbed(claw, seed, to_array):
    """Move claw's initial state by one ulp (relative, seeded uniform in
    [-1, 1])."""
    state = claw.solution.state
    q = np.asarray(state.q)
    r = np.random.default_rng(seed).uniform(-1.0, 1.0, q.shape)
    state.q = to_array(q * (1.0 + np.finfo(q.dtype).eps * r))


def _final(claw):
    status = claw.run()
    return (np.asarray(claw.solution.q), status["numsteps"],
            status.get("numrejected"))


def readings(seeds=5, dam500=False):
    """The readings of the plain paths on the CPU that chip_smoke.py's
    gates cite: the quadrants' two classic routes at 128^2 to t=0.8
    (float64 and float32); the 2D dry dam break at 40^2 to t=0.5 and 2.0,
    the port's and the JAX package's runs, each against its own runs from
    initial states moved by one ulp (``seeds`` seeds); with ``dam500``
    (minutes) the least depth of both packages' 500^2 runs to t=0.5; and
    the share of PyTorch's CPU float64 square roots that differ from the
    correctly rounded ones (numpy's) on 10^6 seeded entries."""
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_enable_x64", True)
    out = {}
    for dtype in (np.float64, np.float32):
        runs = []
        for soa in (True, False):
            claw = tq.setup(mx=128, my=128, outdir=None, device="cpu",
                            dtype=dtype)
            claw.solver.use_soa = soa
            runs.append(_final(claw))
        (a, na, ra), (b, nb, rb) = runs
        a, b = a.astype(np.float64), b.astype(np.float64)
        out[f"quadrants_routes_128_{dtype.__name__}"] = {
            "max_rel": float(np.abs(a - b).max() / np.abs(a).max()),
            "l1_rel": float(np.abs(a - b).sum() / np.abs(a).sum()),
            "steps": [(na, ra), (nb, rb)]}
    for tfinal in (0.5, 2.0):
        finals = {}
        for pkg, setup, to_array in (
                ("port", lambda: tdb.setup(nx=40, dimension=2, outdir=None,
                                           device="cpu", dtype=np.float64),
                 np.asarray),
                ("jax", lambda: jdb.setup(nx=40, dimension=2, outdir=None),
                 jnp.asarray)):
            claw = setup()
            claw.tfinal = tfinal
            q0, n0, r0 = _final(claw)
            moved = []
            for seed in range(1, seeds + 1):
                claw = setup()
                claw.tfinal = tfinal
                _perturbed(claw, seed, to_array)
                q1, n1, _ = _final(claw)
                moved.append((float(np.abs(q1 - q0).max() / np.abs(q0).max()),
                              n1))
            finals[pkg] = q0
            out[f"dam_break_2d_40_t{tfinal}_{pkg}"] = {
                "steps": (n0, r0), "min_h": float(q0[0].min()),
                "one_ulp_max_rel": moved}
        out[f"dam_break_2d_40_t{tfinal}_port_vs_jax"] = float(
            np.abs(finals["port"] - finals["jax"]).max()
            / np.abs(finals["jax"]).max())
    if dam500:
        for pkg, dtype in (("port", np.float32), ("port", np.float64),
                           ("jax", None)):
            if pkg == "port":
                claw = tdb.setup(nx=500, dimension=2, outdir=None,
                                 device="cpu", dtype=dtype)
            else:
                claw = jdb.setup(nx=500, dimension=2, outdir=None)
            claw.tfinal = 0.5
            claw.keep_copy = True
            q, n, r = _final(claw)
            out[f"dam_break_2d_500_{pkg}_{np.asarray(q).dtype}"] = {
                "steps": (n, r),
                "min_h": min(float(np.asarray(f.q[0]).min())
                             for f in claw.frames)}
    x = np.random.default_rng(0).random(10 ** 6)
    out["torch_cpu_sqrt_f64_off_by_one_ulp_share"] = float(
        np.mean(torch.sqrt(torch.from_numpy(x)).numpy() != np.sqrt(x)))
    return out


if __name__ == "__main__":
    import argparse
    import json
    ap = argparse.ArgumentParser(description=readings.__doc__.split(
        "\n\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--dam500", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(4)
    print(json.dumps(readings(args.seeds, args.dam500)))
