"""The scalar and variable-coefficient 2D/3D systems, whole runs of the
port against the JAX package's (CPU, float64): each through both
packages' ``Controller.run``, the same accepted steps and final time, q
within 1e-12 of max|q|.

* ``examples/advection_2d.py`` (``vc_advection_2D``, the swirl on edge
  velocities, ``transverse_waves=0``) at 48^2 to t = 2.0, with its mass
  kept to roundoff;
* ``examples/acoustics_2d_interface.py`` (``vc_acoustics_2D``) at 40^2 to
  t = 0.6, classic (MC, the heterogeneous transverse split) and SharpClaw
  (the generic dq with aux), and SharpClaw with ``char_decomp=2`` (the
  record's ``evec``); its ``dimensional_split=True`` gives the JAX
  example's split run;
* ``examples/kpp.py`` (``kpp_2D``) at 40^2 to t = 1.0, classic and
  SharpClaw;
* ``burgers_2D`` on a Gaussian at 48^2 to t = 0.4 (periodic, MC: the
  run of tests/test_2d_examples.py, whose diagonal symmetry holds here
  too) and without the entropy fix, ``burgers_3D`` at 12^3 to t = 0.5;
* ``advection_2D`` (constant u, v, periodic) at 40x32 and
  ``vc_advection_fwave_2D`` (cell velocities, ``fwave=True``, a capacity
  row) at 32^2, through the API, as no example of either package uses
  them.

On the CPU each kernel wrapper runs its plain version and counts no
launch.
"""

import os
import sys

import numpy as np
import pytest
import torch

import pyclaw_tpu
import pyclaw_tpu_torch
from pyclaw_tpu_torch.examples import acoustics_2d_interface as tai
from pyclaw_tpu_torch.examples import advection_2d as tad
from pyclaw_tpu_torch.examples import kpp as tkpp
from pyclaw_tpu_torch.ops import tiled2d

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import acoustics_2d_interface as jai  # noqa: E402
import advection_2d as jad  # noqa: E402
import kpp as jkpp  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _same_run(claw, jclaw, tol=1e-12):
    """Run both; the same accepted steps and final time, q within tol of
    max|q|.  Returns the port's status."""
    before = (tiled2d.step2_rows_generic.launches,
              tiled2d.step3_xy_generic.launches)
    status = claw.run()
    jstatus = jclaw.run()
    assert (tiled2d.step2_rows_generic.launches,
            tiled2d.step3_xy_generic.launches) == before
    assert status["numsteps"] == jstatus["numsteps"]
    assert claw.solution.t == pytest.approx(float(jclaw.solution.t),
                                            abs=1e-12)
    q_j = np.asarray(jclaw.solution.q)
    q = claw.solution.q
    assert q.shape == q_j.shape and np.all(np.isfinite(q))
    assert np.abs(q - q_j).max() <= tol * np.abs(q_j).max()
    return status


def test_advection_2d_matches_jax():
    claw = tad.setup(mx=48, my=48, outdir=None, device="cpu",
                     dtype=np.float64)
    jclaw = jad.setup(mx=48, my=48, outdir=None)
    mass0 = claw.solution.state.q[0].sum()
    status = _same_run(claw, jclaw)
    assert status["numsteps"] > 100
    # the divergence-free edge field keeps the mass (no flux crosses the
    # boundary, where the swirl's normal velocity is zero)
    assert abs(claw.solution.q[0].sum() - mass0) <= 1e-12 * mass0


@pytest.mark.parametrize("solver_type,char_decomp", [
    ("classic", 0), ("sharpclaw", 0), ("sharpclaw", 2)])
def test_acoustics_2d_interface_matches_jax(solver_type, char_decomp):
    claw = tai.setup(mx=40, my=40, solver_type=solver_type, outdir=None,
                     device="cpu", dtype=np.float64)
    jclaw = jai.setup(mx=40, my=40, solver_type=solver_type, outdir=None)
    for c in (claw, jclaw):
        if char_decomp:
            c.solver.char_decomp = char_decomp
    status = _same_run(claw, jclaw)
    assert status["numsteps"] >= 6


def test_acoustics_2d_interface_refuses_dimensional_split():
    """No longer refused: the example's dimensional_split=True runs its x
    and y sweeps and gives the JAX example's split run."""
    claw = tai.setup(mx=16, my=16, dimensional_split=True, outdir=None,
                     device="cpu", dtype=np.float64)
    jclaw = jai.setup(mx=16, my=16, dimensional_split=True, outdir=None)
    assert _same_run(claw, jclaw)["numsteps"] >= 6


@pytest.mark.parametrize("solver_type", ["classic", "sharpclaw"])
def test_kpp_matches_jax(solver_type):
    claw = tkpp.setup(mx=40, my=40, solver_type=solver_type, outdir=None,
                      device="cpu", dtype=np.float64)
    jclaw = jkpp.setup(mx=40, my=40, solver_type=solver_type, outdir=None)
    status = _same_run(claw, jclaw)
    assert status["numsteps"] >= 6


def _gaussian_claw(pkg, name, n, tfinal, dim=2, **solver_kw):
    """A periodic Gaussian pulse exp(-30 |x - 1/2|^2) on the unit square
    (cube) for system ``name`` of package ``pkg``, MC limiter, one output
    time (the burgers_2D run of tests/test_2d_examples.py)."""
    kw = {} if pkg is pyclaw_tpu else {"device": "cpu"}
    cls = pkg.ClawSolver2D if dim == 2 else pkg.ClawSolver3D
    solver = cls(getattr(pkg.riemann, name), **kw)
    solver.dimensional_split = False
    solver.limiters = [pkg.limiters.tvd.MC]
    solver.all_bcs = pkg.BC.periodic
    for k, v in solver_kw.items():
        setattr(solver, k, v)
    domain = pkg.Domain([0.0] * dim, [1.0] * dim, [n] * dim)
    skw = {} if pkg is pyclaw_tpu else {"dtype": np.float64}
    state = pkg.State(domain, 1, **skw)
    centers = domain.grid.c_centers
    state.q[0] = np.exp(-30.0 * sum((c - 0.5) ** 2 for c in centers))
    claw = pkg.Controller()
    claw.solution = pkg.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = tfinal
    claw.num_output_times = 1
    claw.output_format = None
    return claw


@pytest.mark.parametrize("efix", [True, False])
def test_burgers_2d_matches_jax(efix):
    claws = [_gaussian_claw(pkg, "burgers_2D", 48, 0.4)
             for pkg in (pyclaw_tpu_torch, pyclaw_tpu)]
    for c in claws:
        # a falling sine on the Gaussian makes transonic rarefactions
        x, y = c.solution.domain.grid.c_centers
        c.solution.state.q[0] = (c.solution.state.q[0]
                                 - 0.3 * np.sin(2.0 * np.pi * (x + y)))
        c.solution.state.problem_data["efix"] = efix
    _same_run(*claws)
    q = claws[0].solution.q[0]
    # the diagonal symmetry of tests/test_2d_examples.py
    np.testing.assert_allclose(q, q.T, atol=1e-11)


def test_burgers_3d_matches_jax():
    claws = [_gaussian_claw(pkg, "burgers_3D", 12, 0.5, dim=3)
             for pkg in (pyclaw_tpu_torch, pyclaw_tpu)]
    status = _same_run(*claws)
    assert status["numsteps"] > 4
    q = claws[0].solution.q[0]
    np.testing.assert_allclose(q, q.transpose(1, 0, 2), atol=1e-11)


def test_advection_2d_constant_velocity_matches_jax():
    claws = []
    for pkg in (pyclaw_tpu_torch, pyclaw_tpu):
        kw = {} if pkg is pyclaw_tpu else {"device": "cpu"}
        solver = pkg.ClawSolver2D(pkg.riemann.advection_2D, **kw)
        solver.limiters = [pkg.limiters.tvd.vanleer]
        solver.all_bcs = pkg.BC.periodic
        domain = pkg.Domain([0.0, 0.0], [1.0, 1.0], [40, 32])
        skw = {} if pkg is pyclaw_tpu else {"dtype": np.float64}
        state = pkg.State(domain, 1, **skw)
        state.problem_data["u"], state.problem_data["v"] = 0.7, -0.4
        x, y = domain.grid.c_centers
        state.q[0] = np.where((x - 0.4) ** 2 + (y - 0.6) ** 2 < 0.04,
                              1.0, 0.0)
        claw = pkg.Controller()
        claw.solution = pkg.Solution(state, domain)
        claw.solver = solver
        claw.tfinal = 0.5
        claw.num_output_times = 1
        claw.output_format = None
        claws.append(claw)
    mass0 = claws[0].solution.state.q[0].sum()
    _same_run(*claws)
    assert abs(claws[0].solution.q[0].sum() - mass0) <= 1e-12 * mass0


def test_vc_advection_fwave_2d_with_capacity_matches_jax():
    claws = []
    for pkg in (pyclaw_tpu_torch, pyclaw_tpu):
        kw = {} if pkg is pyclaw_tpu else {"device": "cpu"}
        solver = pkg.ClawSolver2D(pkg.riemann.vc_advection_fwave_2D, **kw)
        solver.fwave = True
        solver.limiters = [pkg.limiters.tvd.MC]
        solver.cfl_desired, solver.cfl_max = 0.45, 0.5
        solver.all_bcs = pkg.BC.periodic
        solver.aux_bc_lower = [pkg.BC.periodic] * 2
        solver.aux_bc_upper = [pkg.BC.periodic] * 2
        domain = pkg.Domain([0.0, 0.0], [1.0, 1.0], [32, 32])
        skw = {} if pkg is pyclaw_tpu else {"dtype": np.float64}
        state = pkg.State(domain, 1, num_aux=3, **skw)
        x, y = domain.grid.c_centers
        # cell velocities of either sign, and a capacity in aux[2]
        state.aux[0] = np.sin(2.0 * np.pi * y) + 0.3
        state.aux[1] = np.cos(2.0 * np.pi * x) - 0.2
        state.aux[2] = 1.0 + 0.3 * np.sin(2.0 * np.pi * x) \
            * np.sin(2.0 * np.pi * y)
        state.index_capa = 2
        state.q[0] = np.exp(-20.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2))
        claw = pkg.Controller()
        claw.solution = pkg.Solution(state, domain)
        claw.solver = solver
        claw.tfinal = 0.3
        claw.num_output_times = 1
        claw.output_format = None
        claws.append(claw)
    _same_run(*claws)
