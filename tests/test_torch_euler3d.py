"""The 3D slice end to end on the CPU: 3D Euler on the unsplit classic CTU
solver (``ClawSolver3D``), the port against the JAX package.

* the full ``Controller.run`` of the port's ``examples/euler_3d.py`` at
  16^3 against ``tests/golden/euler_3d.npz``, with
  tests/test_torch_quadrants.py's tolerance;
* the octant reflection symmetry and the conservation of rho and E of
  tests/test_3d.py, on the port's run at 24^3;
* a JAX ``ClawSolver3D``'s settings (five limiters, transverse_waves, CFL)
  and its state carried across with ``convert``, one fixed-dt step against
  the JAX solver's ``_step_fn``;
* the options the port refuses (aux, a capacity function and f-waves now
  set up), and the default device without a card.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyclaw_tpu
import pyclaw_tpu_torch
from pyclaw_tpu_torch import convert
from pyclaw_tpu_torch.examples import euler_3d as tex

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import euler_3d as jex  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_controller_run_matches_golden():
    ref = np.load(os.path.join(GOLDEN, "euler_3d.npz"))
    claw = tex.setup(mx=16, my=16, mz=16, outdir=None, device="cpu")
    status = claw.run()
    assert abs(claw.solution.t - float(ref["t"])) < 1e-10
    scale = np.max(np.abs(ref["q"]))
    np.testing.assert_allclose(claw.solution.q, ref["q"], atol=1e-6 * scale,
                               rtol=1e-6)
    # the first step, at dt_initial=0.1, is rejected
    assert status["numrejected"] >= 1 and status["numsteps"] >= 4
    assert claw.solution.state.is_valid()


def test_symmetry_and_conservation():
    """tests/test_3d.py:test_euler_3d_symmetry_conservation on the port."""
    claw = tex.setup(mx=24, my=24, mz=24, outdir=None, device="cpu")
    tot0 = claw.solution.q.sum(axis=(1, 2, 3)).copy()
    claw.run()
    q = claw.solution.q
    assert np.all(np.isfinite(q))
    rho = q[0]
    assert rho.min() > 0.0
    np.testing.assert_allclose(rho, rho[::-1, :, :], atol=1e-10)
    np.testing.assert_allclose(rho, rho[:, ::-1, :], atol=1e-10)
    np.testing.assert_allclose(rho, rho[:, :, ::-1], atol=1e-10)
    assert np.mean(np.abs(rho - rho.transpose(1, 0, 2))) < 1e-2 * rho.mean()
    assert np.mean(np.abs(rho - rho.transpose(2, 1, 0))) < 1e-2 * rho.mean()
    tot1 = q.sum(axis=(1, 2, 3))
    np.testing.assert_allclose(tot1[0], tot0[0], rtol=1e-12)
    np.testing.assert_allclose(tot1[4], tot0[4], rtol=1e-12)


def test_jax_solver_settings_and_state_carry_across():
    """A JAX ClawSolver3D with five distinct limiters, transverse_waves=1
    and its own CFL limits, on a perturbed euler_3d state: the port, set
    up from its settings and state through convert, takes the same
    fixed-dt step."""
    jclaw = jex.setup(mx=12, my=10, mz=8, outdir=None)
    jsolver = jclaw.solver
    jsolver.limiters = [4, 3, 1, 10, 2]
    jsolver.transverse_waves = 1
    jsolver.cfl_desired, jsolver.cfl_max = 0.45, 0.5
    jstate = jclaw.solution.state
    rng = np.random.default_rng(5)
    jstate.q[1:4] = 0.2 + 0.1 * rng.random(jstate.q[1:4].shape)
    jstate.q[4] += 0.5 * (jstate.q[1:4] ** 2).sum(axis=0) / jstate.q[0]
    jsolver.setup(jclaw.solution)
    q_j, c_j = jsolver._step_fn(jnp.asarray(jstate.q), None, 1e-2, 0.0)

    dom = jclaw.solution.domain.patch
    sol = convert.solution_from_arrays(
        jstate.q, jstate.problem_data, dom.lower_global, dom.upper_global,
        dom.num_cells_global, t=jclaw.solution.t)
    solver = pyclaw_tpu_torch.ClawSolver3D(pyclaw_tpu_torch.riemann.euler_3D,
                                           device="cpu")
    convert.apply_solver_settings(solver, convert.solver_settings(jsolver))
    assert solver.limiters == [4, 3, 1, 10, 2]
    assert solver.transverse_waves == 1
    assert (solver.cfl_desired, solver.cfl_max) == (0.45, 0.5)
    assert solver._mthlim() == (4, 3, 1, 10, 2)
    solver.setup(sol)
    q_t, c_t = solver._step_fn(torch.from_numpy(sol.state.q), None, 1e-2, 0.0)
    q_j = np.asarray(q_j)
    assert np.abs(q_t.numpy() - q_j).max() / np.abs(q_j).max() <= 1e-12
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)


def _setup_raises(exc, match, **kw):
    claw = tex.setup(mx=4, my=4, mz=4, outdir=None, device="cpu")
    for key, val in kw.items():
        if key in ("aux", "index_capa"):
            setattr(claw.solution.state, key, val)
        else:
            setattr(claw.solver, key, val)
    with pytest.raises(exc, match=match):
        claw.solver.setup(claw.solution)


def test_setup_refuses_what_the_port_does_not_take():
    # dimensional_split is taken (no longer refused)
    claw = tex.setup(mx=4, my=4, mz=4, outdir=None, device="cpu")
    claw.solver.dimensional_split = True
    claw.solver.setup(claw.solution)
    # aux, a capacity function and f-waves now set up (the generic step;
    # Euler reads no aux); a capacity row that is not in aux is refused
    for kw in (dict(aux=np.ones((1, 4, 4, 4))),
               dict(aux=np.ones((1, 4, 4, 4)), index_capa=0),
               dict(fwave=True)):
        claw = tex.setup(mx=4, my=4, mz=4, outdir=None, device="cpu")
        for key, val in kw.items():
            target = claw.solver if key == "fwave" else claw.solution.state
            setattr(target, key, val)
        claw.solver.setup(claw.solution)
        aux = claw.solution.state.aux
        q_new, cfl = claw.solver._step_fn(
            torch.from_numpy(claw.solution.state.q),
            None if aux is None else torch.from_numpy(aux), 1e-3, 0.0)
        assert q_new.shape == (5, 4, 4, 4) and float(cfl) > 0.0
    _setup_raises(ValueError, "index_capa", index_capa=0)
    # the SharpClaw route runs (SharpClawSolver3D on the generic dq) and
    # takes the JAX solver's fixed-dt step, with lim_type=1 (once refused)
    # too
    claw = tex.setup(mx=4, my=5, mz=6, outdir=None, device="cpu",
                     solver_type="sharpclaw")
    jclaw = jex.setup(mx=4, my=5, mz=6, outdir=None, solver_type="sharpclaw")
    for c in (claw, jclaw):
        c.solver.setup(c.solution)
    q0 = claw.solution.state.q
    q_t, c_t = claw.solver._step_fn(torch.from_numpy(q0), None, 0.02, 0.0)
    q_j, c_j = jclaw.solver._step_fn(jnp.asarray(q0), None, 0.02, 0.0)
    q_j = np.asarray(q_j)
    assert np.abs(q_t.numpy() - q_j).max() <= 1e-12 * np.abs(q_j).max()
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)
    for c in (claw, jclaw):
        c.solver.lim_type = 1
        c.solver.setup(c.solution)
    q_t, c_t = claw.solver._step_fn(torch.from_numpy(q0), None, 0.02, 0.0)
    q_j, c_j = jclaw.solver._step_fn(jnp.asarray(q0), None, 0.02, 0.0)
    q_j = np.asarray(q_j)
    assert np.abs(q_t.numpy() - q_j).max() <= 1e-12 * np.abs(q_j).max()
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)
    # use_parallel builds the parallel overlay's solver and Controller
    from pyclaw_tpu_torch import parallel
    claw = tex.setup(mx=4, my=4, mz=4, outdir=None, device="cpu",
                     use_parallel=True)
    assert isinstance(claw.solver, parallel.ClawSolver3D)
    assert isinstance(claw, parallel.Controller)


def test_missing_rptt_raises_as_in_the_jax_package():
    rs = pyclaw_tpu_torch.riemann.RiemannSolver(
        "no_rptt_3D", 3, 5, 5, pyclaw_tpu_torch.riemann.euler_3D.rp,
        rpt=pyclaw_tpu_torch.riemann.euler_3D.rpt, requires=("gamma",))
    claw = tex.setup(mx=4, my=4, mz=4, outdir=None, device="cpu")
    claw.solver.rp = rs
    with pytest.raises(ValueError, match="no rptt"):
        claw.solver.setup(claw.solution)
    jclaw = jex.setup(mx=4, my=4, mz=4, outdir=None)
    jclaw.solver.rp = pyclaw_tpu.riemann.RiemannSolver(
        "no_rptt_3D", 3, 5, 5, pyclaw_tpu.riemann.euler_3D.rp,
        rpt=pyclaw_tpu.riemann.euler_3D.rpt, requires=("gamma",))
    with pytest.raises(ValueError, match="no rptt"):
        jclaw.solver.setup(jclaw.solution)


def test_other_3d_solvers_are_not_ported_yet():
    e3 = pyclaw_tpu_torch.riemann.euler_3D
    rs = pyclaw_tpu_torch.riemann.RiemannSolver(
        "other_3D", 3, 5, 5, e3.rp, rpt=e3.rpt, rptt=e3.rptt,
        requires=("gamma",))
    claw = tex.setup(mx=4, my=4, mz=4, outdir=None, device="cpu")
    claw.solver.rp = rs
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        claw.solver.setup(claw.solution)


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tex.setup(mx=4, my=4, mz=4, outdir=None)
