"""Dimensional splitting and the two 2D records without a transverse
solver, the port against the JAX package (CPU, float64).

* ``classic/kernels.py:step1_dir`` against the JAX package's, on each axis
  of a 2D and a 3D array, with aux, a capacity row and f-waves, to 1e-12;
* the ``rp`` hooks of ``psystem_2D`` (both stress laws) and
  ``shallow_sphere_fwave_2D`` against the JAX package's on seeded random
  states, along both axes;
* whole runs through both packages' ``Controller.run``, the same accepted
  steps, q within 1e-12 of max|q|: ``examples/psystem_2d.py`` at 60^2
  with its gauges (split), and its unsplit step without a transverse pass
  (CFL 0.2 / 0.25); ``acoustics_2d.py`` and ``acoustics_3d_heterogeneous.py``
  split (40^2, 16^3); ``shock_forward_step.py`` at 60x20, classic (split)
  to t = 0.5 and SharpClaw to t = 0.05 (the JAX run itself moves by
  1e-11 at t = 0.2 and 1.5e-9 at t = 0.5 when its initial density moves
  by one ulp: ``--forward-step`` below); ``shallow_sphere.py`` at 32x16
  to t = 5.0 (split, Strang source, custom q and aux BCs at the theta
  ends) and its unsplit step (CFL 0.2 / 0.25); its float32 depth drift
  at 64x32 to t = 1.0 against the JAX run's, which the JAX source hook
  promotes to float64;
* the parallel overlay refuses the sphere's source, which closes over the
  whole grid's latitudes (tests/test_torch_parallel.py holds the split
  step on four ranks against the serial run).

On the CPU each kernel wrapper runs its plain version and counts no
launch.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyclaw_tpu import riemann as jriemann
from pyclaw_tpu.classic import kernels as jk
from pyclaw_tpu_torch import parallel
from pyclaw_tpu_torch import riemann as triemann
from pyclaw_tpu_torch.classic import kernels as tk
from pyclaw_tpu_torch.examples import acoustics_2d as tac2
from pyclaw_tpu_torch.examples import acoustics_3d_heterogeneous as tac3
from pyclaw_tpu_torch.examples import psystem_2d as tps
from pyclaw_tpu_torch.examples import shallow_sphere as tsph
from pyclaw_tpu_torch.examples import shock_forward_step as tfs
from pyclaw_tpu_torch.ops import sweep, tiled2d

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import acoustics_2d as jac2  # noqa: E402
import acoustics_3d_heterogeneous as jac3  # noqa: E402
import psystem_2d as jps  # noqa: E402
import shallow_sphere as jsph  # noqa: E402
import shock_forward_step as jfs  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


# ---- step1_dir ------------------------------------------------------------
def _dir_inputs(seed, name, shape):
    """Ghost-padded q and aux of system ``name`` on ``shape`` (cells with
    ghosts): the sphere (depths near 1, velocities of either sign, aux rows
    of cos(theta)-like values), the p-system (strain of either sign, rho
    and K positive) or heterogeneous 3D acoustics (Z and c positive, a
    capacity row last)."""
    rng = np.random.default_rng(seed)
    if name == "shallow_sphere_fwave_2D":
        h = 0.8 + 0.4 * rng.random(shape)
        q = np.stack([h, h * rng.standard_normal(shape),
                      h * rng.standard_normal(shape)])
        return q, 0.5 + 0.5 * rng.random((2,) + shape)
    if name == "psystem_2D":
        q = np.stack([0.3 * rng.standard_normal(shape),
                      rng.standard_normal(shape), rng.standard_normal(shape)])
        return q, 0.5 + 3.0 * rng.random((2,) + shape)
    q = rng.standard_normal((4,) + shape)
    return q, 0.5 + rng.random((3,) + shape)


# (system, shape with ghosts, sweep axis, index_capa, fwave, limiter,
# order): every axis of a 2D and a 3D array, aux in each, a capacity row,
# f-waves, MC / minmod / van Leer, first and second order
DIR_CASES = [
    ("shallow_sphere_fwave_2D", (14, 11), 0, 1, True, 4, 2),
    ("shallow_sphere_fwave_2D", (14, 11), 1, 1, True, 4, 2),
    ("psystem_2D", (9, 16), 0, -1, True, 1, 2),
    ("psystem_2D", (9, 16), 1, 0, False, 3, 1),
    ("vc_acoustics_3D", (8, 9, 7), 0, 2, False, 4, 2),
    ("vc_acoustics_3D", (8, 9, 7), 1, 2, True, 1, 2),
    ("vc_acoustics_3D", (8, 9, 7), 2, -1, False, 3, 2),
]


@pytest.mark.parametrize("name,shape,ixy,capa,fwave,lim,order", DIR_CASES)
def test_step1_dir_matches_jax(name, shape, ixy, capa, fwave, lim, order):
    q, aux = _dir_inputs(len(shape) * 10 + ixy, name, shape)
    params = {"grav": 1.0, "stress_relation": "exp"}
    t_rp, j_rp = triemann.ALL[name], getattr(jriemann, name)
    lims = (lim,) * t_rp.num_waves
    dxi = 1.0 / shape[ixy]
    dt = 0.2 * dxi
    q_t, c_t = tk.step1_dir(torch.from_numpy(q), torch.from_numpy(aux), dt,
                            dxi, ixy, t_rp.rp, params, lims, order, fwave,
                            capa, 2)
    q_j, c_j = jax.jit(lambda q, aux: jk.step1_dir(
        q, aux, dt, dxi, ixy, j_rp.rp, params, lims, order, fwave, capa,
        2))(jnp.asarray(q), jnp.asarray(aux))
    assert tuple(q_t.shape) == (q.shape[0],) + tuple(n - 4 for n in shape)
    assert _rel(q_t.numpy(), q_j) <= 1e-12
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)


# ---- the two records' rp --------------------------------------------------
@pytest.mark.parametrize("name,law", [("psystem_2D", "exp"),
                                      ("psystem_2D", "linear"),
                                      ("shallow_sphere_fwave_2D", None)])
def test_rp_matches_jax(name, law):
    t_rs, j_rs = triemann.ALL[name], getattr(jriemann, name)
    assert (t_rs.num_dim, t_rs.num_eqn, t_rs.num_waves, t_rs.requires) == (
        j_rs.num_dim, j_rs.num_eqn, j_rs.num_waves, j_rs.requires)
    assert t_rs.rpt is None and j_rs.rpt is None
    params = {"grav": 9.81, "stress_relation": law}
    for ixy in (0, 1):
        q, aux = _dir_inputs(7 + ixy, name, (40,))
        args = (q[:, :-1], q[:, 1:], aux[:, :-1], aux[:, 1:])
        out_t = triemann.ALL[name].rp(ixy, *(torch.from_numpy(a)
                                             for a in args), params)
        out_j = jax.jit(lambda *a: getattr(jriemann, name).rp(
            ixy, *a, params))(*(jnp.asarray(a) for a in args))
        for a, b in zip(out_t, out_j):
            assert a.shape == b.shape
            assert _rel(a.numpy(), b) <= 1e-13


# ---- whole runs -------------------------------------------------------------
def _same_run(claw, jclaw, tol=1e-12):
    """Run both; the same accepted steps and final time, q within tol of
    max|q|, no kernel launch.  Returns the port's status."""
    before = (tiled2d.step2_rows_generic.launches, sweep.step1.launches)
    status = claw.run()
    jstatus = jclaw.run()
    assert (tiled2d.step2_rows_generic.launches,
            sweep.step1.launches) == before
    assert status["numsteps"] == jstatus["numsteps"]
    assert claw.solution.t == pytest.approx(float(jclaw.solution.t),
                                            abs=1e-12)
    q = claw.solution.q
    assert np.all(np.isfinite(q)) and q.shape == np.shape(jclaw.solution.q)
    assert _rel(q, jclaw.solution.q) <= tol
    return status


def test_psystem_2d_split_with_gauges_matches_jax():
    claw = tps.setup(mx=60, my=60, outdir=None, device="cpu",
                     dtype=np.float64)
    jclaw = jps.setup(mx=60, my=60, outdir=None)
    status = _same_run(claw, jclaw)
    assert status["numsteps"] >= 30
    tg = claw.solution.state.gauge_data
    jg = jclaw.solution.state.gauge_data
    assert len(tg) == len(jg) == 2 * status["numsteps"]
    for (jn, jt, jv), (tn, tt, tv) in zip(jg, tg):
        assert tn == jn and abs(tt - jt) <= 1e-12
        assert np.abs(np.asarray(tv) - np.asarray(jv)).max() <= 1e-12


@pytest.mark.parametrize("example", ["psystem_2d", "shallow_sphere"])
def test_unsplit_step_without_rpt_matches_jax(example):
    """The rpt-less records' unsplit step: no transverse pass, whatever
    transverse_waves says (the JAX generic body's rpt=None branch), at the
    port example's CFL 0.2 / 0.25 (psystem_2d.py says why)."""
    tmod, jmod = (tps, jps) if example == "psystem_2d" else (tsph, jsph)
    n = (40, 40) if example == "psystem_2d" else (32, 16)
    claw = tmod.setup(mx=n[0], my=n[1], outdir=None, device="cpu",
                      dtype=np.float64, dimensional_split=False)
    jclaw = jmod.setup(mx=n[0], my=n[1], outdir=None)
    assert (claw.solver.cfl_desired, claw.solver.cfl_max) == (0.2, 0.25)
    jclaw.solver.dimensional_split = False
    jclaw.solver.cfl_desired, jclaw.solver.cfl_max = 0.2, 0.25
    for c in (claw, jclaw):
        c.tfinal = min(c.tfinal, 1.0)
        c.num_output_times = 1
    assert claw.solver.transverse_waves == 2
    assert _same_run(claw, jclaw)["numsteps"] >= 10


@pytest.mark.parametrize("example", ["acoustics_2d", "acoustics_3d"])
def test_acoustics_split_matches_jax(example):
    if example == "acoustics_2d":
        claw = tac2.setup(mx=40, my=40, dimensional_split=True, outdir=None,
                          device="cpu", dtype=np.float64)
        jclaw = jac2.setup(mx=40, my=40, dimensional_split=True, outdir=None)
    else:
        claw = tac3.setup(mx=16, my=16, mz=16, dimensional_split=True,
                          outdir=None, device="cpu", dtype=np.float64)
        jclaw = jac3.setup(mx=16, my=16, mz=16, dimensional_split=True,
                           outdir=None)
        for c in (claw, jclaw):
            c.num_output_times = 1
    assert claw.solver.cfl_max == jclaw.solver.cfl_max == 1.0
    assert _same_run(claw, jclaw)["numsteps"] >= 6


@pytest.mark.parametrize("solver_type,tfinal", [("classic", 0.5),
                                                ("sharpclaw", 0.05)])
def test_shock_forward_step_matches_jax(solver_type, tfinal):
    """The custom inflow BC and the before_step filler (the host loop in
    both packages, with the JAX host loop's dt rule: many attempts blow up
    and are rejected, some of them clipped)."""
    claw, jclaw = (mod.setup(mx=60, my=20, tfinal=tfinal,
                             num_output_times=1, solver_type=solver_type,
                             outdir=None, **kw)
                   for mod, kw in ((tfs, {"device": "cpu",
                                          "dtype": np.float64}),
                                   (jfs, {})))
    status = _same_run(claw, jclaw)
    assert status["numsteps"] >= 10 and status["numrejected"] >= 10


def test_shallow_sphere_matches_jax():
    claw = tsph.setup(mx=32, my=16, outdir=None, device="cpu",
                      dtype=np.float64)
    jclaw = jsph.setup(mx=32, my=16, outdir=None)
    for c in (claw, jclaw):
        c.tfinal, c.num_output_times = 5.0, 1
    q0 = claw.solution.q.copy()
    status = _same_run(claw, jclaw)
    assert status["numsteps"] >= 30
    # the steady TC2 flow stays near its initial state
    q = claw.solution.q
    assert np.abs(q[0] - q0[0]).max() / q0[0].max() < 0.05


def _sphere_drifts(mx=64, my=32, tfinal=1.0):
    """The TC2 depth drift (max |h - h0| / max h0) at mx x my to
    ``tfinal``: the port's float32 and float64 runs and the JAX package's
    run from the same float32 state, with their dtypes and steps."""
    def run(claw):
        claw.tfinal, claw.num_output_times = tfinal, 1
        claw.run()
        q = np.asarray(claw.solution.q)
        return (float(np.abs(q[0].astype(np.float64) - h0).max()
                      / h0.max()), q.dtype, claw.solver.status["numsteps"])

    jclaw = jsph.setup(mx=mx, my=my, outdir=None)
    h0 = np.asarray(jclaw.solution.state.q[0], np.float64).copy()
    st = jclaw.solution.state
    st.q, st.aux = st.q.astype(np.float32), st.aux.astype(np.float32)
    st.dtype = np.dtype(np.float32)
    jclaw.solver.traced_evolve = False
    out = {"jax_f32": run(jclaw)}
    for name, dtype in (("port_f32", np.float32), ("port_f64", np.float64)):
        out[name] = run(tsph.setup(mx=mx, my=my, outdir=None, device="cpu",
                                   dtype=dtype))
    return out


def test_shallow_sphere_float32_drift_matches_jax():
    """The float32 TC2 depth drift at 64x32 to t = 1.0: the port's float32
    run against the JAX package's run from the same float32 state.  The
    JAX source hook multiplies q by its float64 latitude arrays, so its q
    turns float64 after the first source (its traced loop refuses that
    change of type: the run takes its host loop); the tolerance, 1e-5
    relative, allows for that promotion: the two drifts differ by 1.2e-6
    relative, the port's float32 and float64 drifts by 5.9e-7
    (``--sphere-drift``)."""
    runs = _sphere_drifts()
    (d, dtype, steps), (dj, jdtype, jsteps) = (runs["port_f32"],
                                               runs["jax_f32"])
    assert dtype == np.float32 and jdtype == np.float64
    assert steps == jsteps >= 30
    assert abs(d - dj) <= 1e-5 * dj


def test_overlay_refuses_a_source_on_the_global_grid():
    claw = tsph.setup(mx=8, my=8, outdir=None, device="cpu")
    s = parallel.ClawSolver2D(claw.solver.rp, device="cpu")
    s.step_source = claw.solver.step_source
    s.dimensional_split = True
    claw.solver = s
    with pytest.raises(NotImplementedError, match="global grid"):
        s.setup(claw.solution)


# ---- readings (not tests): python tests/test_torch_split.py ... ----------
def _unsplit_asymmetry(n, cfl, dtype):
    """max |eps(x, y) - eps(-x, y)| of the port's unsplit p-system run
    (psystem_2d.py's pulse, no transverse pass) at n^2 to t=1.0 on the
    CPU's plain path, at CFL (cfl, cfl + 0.05)."""
    claw = tps.setup(mx=n, my=n, outdir=None, device="cpu",
                     dtype=np.dtype(dtype).type, dimensional_split=False)
    claw.solver.cfl_desired, claw.solver.cfl_max = cfl, cfl + 0.05
    claw.num_output_times = 1
    status = claw.run()
    eps = claw.solution.q[0].astype(np.float64)
    return status["numsteps"], float(np.abs(eps - eps[::-1]).max())


def _forward_step_ulp(tfinal):
    """The SharpClaw forward step at 60x20 to ``tfinal``: the JAX run's
    change when its initial density moves by one ulp, and the port's
    distance from the JAX run (max relative)."""
    runs = {}
    for name, mod, kw in (("jax", jfs, {}), ("jax_ulp", jfs, {}),
                          ("port", tfs, {"device": "cpu",
                                         "dtype": np.float64})):
        claw = mod.setup(mx=60, my=20, tfinal=tfinal, num_output_times=1,
                         solver_type="sharpclaw", outdir=None, **kw)
        if name == "jax_ulp":
            q = claw.solution.state.q
            q[0] = np.nextafter(q[0], np.inf)
        claw.run()
        runs[name] = np.asarray(claw.solution.q)
    return {k: _rel(runs[k], runs["jax"]) for k in ("jax_ulp", "port")}


if __name__ == "__main__":
    # python tests/test_torch_split.py --unsplit 512 0.45 float32
    # python tests/test_torch_split.py --forward-step 0.5   (the CPU)
    # python tests/test_torch_split.py --sphere-drift
    import argparse
    import json
    ap = argparse.ArgumentParser()
    ap.add_argument("--unsplit", nargs=3, metavar=("N", "CFL", "DTYPE"))
    ap.add_argument("--forward-step", type=float, metavar="TFINAL")
    ap.add_argument("--sphere-drift", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(8)
    if args.unsplit:
        n, cfl, dtype = args.unsplit
        steps, asym = _unsplit_asymmetry(int(n), float(cfl), dtype)
        print(json.dumps({"n": int(n), "cfl": float(cfl), "dtype": dtype,
                          "steps": steps, "mirror_asymmetry": asym}))
    if args.sphere_drift:
        runs = _sphere_drifts()
        dj = runs["jax_f32"][0]
        print(json.dumps({k: {"drift": v[0], "dtype": str(v[1]),
                              "steps": v[2],
                              "rel_to_jax_f32": abs(v[0] - dj) / dj}
                          for k, v in runs.items()}))
    if args.forward_step is not None:
        print(json.dumps({"tfinal": args.forward_step,
                          **_forward_step_ulp(args.forward_step)}))
