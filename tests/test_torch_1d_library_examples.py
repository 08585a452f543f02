"""The last ten examples of the port end to end on the CPU, float64,
against the JAX package's copies: stegoton_1d, sill, shallow_1d,
traffic_1d, mhd_1d, burgers_1d, acoustics_1d_heterogeneous,
advection_1d_variable, advection_2d_annulus and woodward_colella_blast.

* each example on each of its routes (classic and SharpClaw, both
  shallow_1d solvers, advection_1d_variable's four forms, the annulus
  split and unsplit, the blast's SharpClaw SSP33 and classic routes)
  against the JAX example's ``Controller.run`` at a small grid, in one
  frame: the same accepted steps and t, q to 1e-12 of max|q|, at a t
  where the run is well-conditioned (:data:`ROUTES`; the readings below
  say why some end early);
* stegoton_1d at nx = 600 to t = 20 against tests/golden/stegoton_1d.npz.
  That run is chaotic in roundoff: its CFL sits at 0.9-1.0 with rejected
  steps, so a rounding difference flips an accept or reject and the step
  sequence forks.  The JAX package's own run, from its initial state
  moved by one ulp (each entry times 1 + eps r, r seeded uniform in
  [-1, 1]), misses the golden by up to 0.34 of max|q| (30 seeds,
  ``python tests/test_torch_1d_library_examples.py --seeds 30``), so 1e-8
  is no gate a run can be held to.  The statistics those readings keep
  tight are held instead: the relative L1 distance to the golden
  (:data:`STEGOTON_ULP_L1`) and the peak strain (:data:`STEGOTON_PEAK`);
  the JAX package's seed-7 run is shown to miss 1e-8;
* what the examples stand for: the sill's lake at rest stays at rest to
  roundoff; the blast keeps rho and p positive between its walls; the
  annulus returns near its initial state after a revolution; the
  Brio-Wu profile has its compound wave (By changes sign) and keeps
  rho, p > 0.
"""

import argparse
import json
import os
import sys

import numpy as np
import pytest
import torch

from pyclaw_tpu_torch.examples import (  # noqa: F401
    acoustics_1d_heterogeneous, advection_1d_variable,
    advection_2d_annulus, burgers_1d, mhd_1d, shallow_1d, sill,
    stegoton_1d, traffic_1d, woodward_colella_blast)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "stegoton_1d.npz")
# the JAX package's stegoton run at nx = 600 from its initial state moved
# by one ulp, over seeds 7-36 (the script below prints each seed's
# readings), against the golden: max-abs over max|q| 0.00067 to 0.3383
# (the port's own run 0.1164 unmoved, 0.0046 to 0.2828 moved), rounded up;
# the relative L1 distance 0.00014 to 0.0877 (the port's 0.0595 unmoved,
# 0.00085 to 0.0759 moved), rounded up; the peak strain max q[0] 2.2347 to
# 2.2873 (the golden's 2.2716; the port's 2.2665 unmoved, 2.2408 to 2.2846
# moved), widened by 0.01
STEGOTON_ULP_MAX = 0.34
STEGOTON_ULP_L1 = 0.09
STEGOTON_PEAK = (2.22, 2.30)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# (module, setup keywords, tfinal): each route at a small grid, to a t
# where a one-ulp move of the JAX run's initial state moves it by less than
# 1e-12 of max|q| (the SharpClaw routes of stegoton, traffic, MHD and the
# heterogeneous acoustics, and the classic stegoton, end early for that:
# at their examples' t the one-ulp moves reach 2e-11 (stegoton SharpClaw
# t=2), 5e-12 (traffic t=0.5), 2e-10 (MHD t=0.1), 3e-4 (acoustics t=0.8)
# and 4e-7 (stegoton classic t=1))
ROUTES = [
    ("stegoton_1d", dict(nx=120), 0.5),
    ("stegoton_1d", dict(nx=120, solver_type="sharpclaw"), 0.5),
    ("sill", dict(nx=100), 0.4),
    ("shallow_1d", dict(nx=100), 0.5),
    ("shallow_1d", dict(nx=100, riemann_solver="hlle"), 0.5),
    ("shallow_1d", dict(nx=100, solver_type="sharpclaw"), 0.5),
    ("shallow_1d", dict(nx=100, solver_type="sharpclaw",
                        riemann_solver="hlle"), 0.5),
    ("traffic_1d", dict(nx=100), 1.0),
    ("traffic_1d", dict(nx=100, solver_type="sharpclaw"), 0.2),
    ("mhd_1d", dict(nx=100), 0.1),
    ("mhd_1d", dict(nx=100, solver_type="sharpclaw"), 0.02),
    ("burgers_1d", dict(nx=100), 0.5),
    ("burgers_1d", dict(nx=100, solver_type="sharpclaw"), 0.5),
    ("acoustics_1d_heterogeneous", dict(nx=100), 0.8),
    ("acoustics_1d_heterogeneous", dict(nx=100, solver_type="sharpclaw"),
     0.2),
    ("advection_1d_variable", dict(nx=60), 0.5),
    ("advection_1d_variable", dict(nx=60, use_capacity=True), 0.5),
    ("advection_1d_variable", dict(nx=60, use_fwave=True), 0.5),
    ("advection_1d_variable", dict(nx=60, use_capacity=True,
                                   use_fwave=True), 0.5),
    ("advection_1d_variable", dict(nx=60, solver_type="sharpclaw"), 0.5),
    ("advection_2d_annulus", dict(mr=16, mth=40), 1.0),
    ("advection_2d_annulus", dict(mr=16, mth=40, dimensional_split=False),
     1.0),
    ("woodward_colella_blast", dict(nx=60), 0.038),
    ("woodward_colella_blast", dict(nx=60, solver_type="classic"), 0.038)]


def _port(module):
    return sys.modules[f"pyclaw_tpu_torch.examples.{module}"]


def _jax_run(module, kwargs, tfinal=None, q0=None):
    """The JAX example's run: to ``tfinal`` in one frame, or (None) to its
    own tfinal in its own frames, as the golden was made."""
    import importlib
    claw = importlib.import_module(module).setup(outdir=None, **kwargs)
    return _run(claw, tfinal, q0)


def _port_run(module, kwargs, tfinal=None, q0=None):
    claw = _port(module).setup(outdir=None, device="cpu", **kwargs)
    return _run(claw, tfinal, q0)


def _run(claw, tfinal, q0):
    if tfinal is not None:
        claw.tfinal = tfinal
        claw.num_output_times = 1
    if q0 is not None:
        claw.solution.state.q = q0
    status = claw.run()
    return claw, status


@pytest.mark.parametrize("module,kwargs,tfinal", ROUTES,
                         ids=[f"{m}-{k}" for m, k, _ in ROUTES])
def test_example_route_matches_jax_run(module, kwargs, tfinal):
    from pyclaw_tpu_torch.ops import sweep, weno
    jclaw, jst = _jax_run(module, kwargs, tfinal)
    before = (sweep.step1.launches, weno.weno5.launches)
    claw, st = _port_run(module, kwargs, tfinal)
    assert (sweep.step1.launches, weno.weno5.launches) == before  # plain
    assert st["numsteps"] == jst["numsteps"]
    assert claw.solution.t == pytest.approx(jclaw.solution.t, abs=1e-12)
    assert claw.solution.t == pytest.approx(tfinal, abs=1e-12)
    q_j = np.asarray(jclaw.solution.q)
    q = claw.solution.q
    assert q.dtype == np.float64 and q.shape == q_j.shape
    assert np.all(np.isfinite(q))
    assert np.abs(q - q_j).max() <= 1e-12 * np.abs(q_j).max()


def _moved(q, seed):
    """q moved by one ulp: each entry times 1 + eps r, r seeded uniform in
    [-1, 1]."""
    r = np.random.default_rng(seed).uniform(-1.0, 1.0, q.shape)
    return (q * (1.0 + np.finfo(q.dtype).eps * r)).astype(q.dtype)


def _golden_miss(q):
    ref = np.load(GOLDEN)["q"]
    return float(np.abs(q - ref).max() / np.abs(ref).max())


def _golden_l1(q):
    ref = np.load(GOLDEN)["q"]
    return float(np.mean(np.abs(q - ref)) / np.mean(np.abs(ref)))


def _readings(q):
    """A run's readings against the golden: max-abs over max|q|, relative
    L1 and the peak strain."""
    q = np.asarray(q)
    return {"max": _golden_miss(q), "l1": _golden_l1(q),
            "peak": float(q[0].max())}


def test_stegoton_golden():
    ref = np.load(GOLDEN)
    claw = stegoton_1d.setup(nx=600, outdir=None, device="cpu")
    status = claw.run()
    assert claw.solution.t == pytest.approx(float(ref["t"]), abs=1e-10)
    q = claw.solution.q
    assert q.shape == ref["q"].shape and np.all(np.isfinite(q))
    assert status["numrejected"] >= 1 and status["numsteps"] > 2000
    assert _golden_l1(q) <= STEGOTON_ULP_L1
    assert STEGOTON_PEAK[0] <= q[0].max() <= STEGOTON_PEAK[1]
    assert _golden_miss(q) <= STEGOTON_ULP_MAX
    # strain is conserved (periodic, f-waves) to roundoff
    q0 = stegoton_1d.setup(nx=600, outdir=None, device="cpu").solution.q
    assert abs(q[0].sum() - q0[0].sum()) <= 1e-12 * np.abs(q0[0]).sum()


def test_stegoton_golden_is_conditioned():
    """The JAX package's run from its initial state moved by one ulp
    misses the golden by far more than 1e-8 (the unmoved run meets it)."""
    import stegoton_1d as jsteg
    q0 = jsteg.setup(nx=600, outdir=None).solution.state.q
    jclaw, _ = _jax_run("stegoton_1d", dict(nx=600), q0=_moved(q0, 7))
    assert _golden_miss(np.asarray(jclaw.solution.q)) > 1e-4


def test_sill_lake_at_rest_stays_at_rest():
    claw = sill.setup(nx=200, perturb=0.0, outdir=None, device="cpu")
    q0 = claw.solution.q.copy()
    b = claw.solution.state.aux[0]
    claw.run()
    q = claw.solution.q
    assert np.abs(q[0] + b - 1.0).max() <= 1e-13
    assert np.abs(q[1]).max() <= 1e-13
    assert np.abs(q - q0).max() <= 1e-13


def test_blast_stays_positive():
    claw = woodward_colella_blast.setup(nx=100, outdir=None, device="cpu")
    claw.run()
    q = claw.solution.q
    rho = q[0]
    p = 0.4 * (q[2] - 0.5 * q[1] ** 2 / rho)
    assert rho.min() > 0.0 and p.min() > 0.0
    # reflecting walls: mass is conserved
    assert abs(rho.sum() / 100 - 1.0) <= 1e-12


def test_annulus_returns_after_a_revolution():
    claw = advection_2d_annulus.setup(mr=20, mth=60, outdir=None,
                                      device="cpu")
    q0 = claw.solution.q.copy()
    claw.run()
    assert claw.solution.t == pytest.approx(2.0 * np.pi)
    err = np.abs(claw.solution.q - q0).max() / np.abs(q0).max()
    assert err < 0.5


def test_brio_wu_profile():
    claw = mhd_1d.setup(nx=200, outdir=None, device="cpu")
    claw.run()
    q = claw.solution.q
    rho, by = q[0], q[4]
    ke = 0.5 * (q[1] ** 2 + q[2] ** 2 + q[3] ** 2) / rho
    p = (q[6] - ke - 0.5 * (0.75 ** 2 + by ** 2 + q[5] ** 2))
    assert rho.min() > 0.0 and p.min() > 0.0
    # the compound wave: By turns from +1 to -1, v (q[2]) is driven
    assert by[0] == pytest.approx(1.0) and by[-1] == pytest.approx(-1.0)
    assert np.abs(q[2]).max() > 0.1


def stegoton_readings(seeds):
    """The one-ulp readings of the stegoton golden: the JAX package's run
    and the port's at nx = 600 from the initial state moved by one ulp
    (seed s), each :func:`_readings` (max-abs over max|q|, relative L1,
    peak strain)."""
    import stegoton_1d as jsteg
    q0 = jsteg.setup(nx=600, outdir=None).solution.state.q
    out = {"seeds": list(seeds)}
    jclaw, _ = _jax_run("stegoton_1d", dict(nx=600))
    out["jax_unmoved"] = _readings(jclaw.solution.q)
    claw, _ = _port_run("stegoton_1d", dict(nx=600))
    out["port_unmoved"] = _readings(claw.solution.q)
    out["jax"] = [_readings(_jax_run(
        "stegoton_1d", dict(nx=600), q0=_moved(q0, s))[0].solution.q)
        for s in seeds]
    out["port"] = [_readings(_port_run(
        "stegoton_1d", dict(nx=600), q0=_moved(q0, s))[0].solution.q)
        for s in seeds]
    return out


# the routes of chip_smoke.py's [4x] at the examples' own sizes: (module,
# setup keywords, the t its card run is held to its plain version at;
# None: the example's tfinal)
CARD_ROUTES = [
    ("stegoton_1d", {}, 1.0),
    ("stegoton_1d", dict(solver_type="sharpclaw"), 1.0),
    ("sill", {}, None), ("shallow_1d", {}, None),
    ("shallow_1d", dict(riemann_solver="hlle"), None),
    ("shallow_1d", dict(solver_type="sharpclaw"), None),
    ("shallow_1d", dict(solver_type="sharpclaw", riemann_solver="hlle"),
     None),
    ("traffic_1d", {}, None),
    ("traffic_1d", dict(solver_type="sharpclaw"), None),
    ("mhd_1d", {}, None), ("mhd_1d", dict(solver_type="sharpclaw"), 0.002),
    ("burgers_1d", {}, None),
    ("burgers_1d", dict(solver_type="sharpclaw"), None),
    ("acoustics_1d_heterogeneous", {}, None),
    ("acoustics_1d_heterogeneous", dict(solver_type="sharpclaw"), None),
    ("advection_1d_variable", {}, None),
    ("advection_1d_variable", dict(use_capacity=True), None),
    ("advection_1d_variable", dict(use_fwave=True), None),
    ("advection_1d_variable", dict(use_capacity=True, use_fwave=True),
     None),
    ("advection_1d_variable", dict(solver_type="sharpclaw"), None),
    ("advection_2d_annulus", {}, None),
    ("advection_2d_annulus", dict(dimensional_split=False), None),
    ("woodward_colella_blast", {}, None),
    ("woodward_colella_blast", dict(solver_type="classic"), None)]


def route_readings(seeds):
    """The one-ulp readings of the card's routes: the JAX example's run at
    its own size to the compared t in one frame, from its initial state
    moved by one ulp (seed s), against the unmoved run, max-abs over its
    max magnitude."""
    import importlib
    out = []
    for module, kwargs, t in CARD_ROUTES:
        setup = importlib.import_module(module).setup
        tfinal = t or setup(outdir=None, **kwargs).tfinal
        q_ref = np.asarray(_jax_run(module, kwargs, tfinal)[0].solution.q)
        q0 = setup(outdir=None, **kwargs).solution.state.q
        reads = [float(np.abs(np.asarray(_jax_run(
            module, kwargs, tfinal, _moved(q0, s))[0].solution.q)
            - q_ref).max() / np.abs(q_ref).max()) for s in seeds]
        out.append({"module": module, "kwargs": kwargs, "t": tfinal,
                    "max": max(reads), "readings": reads})
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="the one-ulp readings of the "
                                 "stegoton golden, or (--routes) of the "
                                 "card's routes")
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--routes", action="store_true")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(1)
    if args.routes:
        route_readings(range(7, 7 + args.seeds))
    else:
        print(json.dumps(stegoton_readings(range(7, 7 + args.seeds))))
