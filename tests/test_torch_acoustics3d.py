"""The 3D heterogeneous-acoustics slice end to end on the CPU: a pressure
pulse under an impedance interface on ``ClawSolver3D(vc_acoustics_3D)``
with aux, the port against the JAX package.

* the port's ``examples/acoustics_3d_heterogeneous.py`` at 20^3 to t=0.4
  against the JAX example's traced accept/reject loop: the same accepted
  and rejected steps, 1e-12 of max|q| (float64);
* on that run, the x <-> y and x-mirror symmetry of p
  (tests/test_3d.py:156-168);
* the uniform-medium oracle (tests/test_3d.py:170-197): with rho = c = 1
  everywhere, the heterogeneous solver reproduces ``acoustics_3D`` with
  transverse_waves=1 to roundoff;
* a JAX ``ClawSolver3D``'s settings and a 3D state with aux and a
  capacity row carried across with ``convert``, one fixed-dt step against
  the JAX solver's ``_step_fn``, and ascii frames with 3D aux across the
  two packages;
* what the slice still refuses.
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
from pyclaw_tpu_torch.examples import acoustics_3d_heterogeneous as tex

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import acoustics_3d_heterogeneous as jex  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def run20():
    torch.set_num_threads(1)
    claw = tex.setup(mx=20, my=20, mz=20, outdir=None, device="cpu")
    claw.tfinal = 0.4
    claw.num_output_times = 1
    status = claw.run()
    return claw, dict(status)


def test_example_matches_jax_run(run20):
    claw, status = run20
    jclaw = jex.setup(mx=20, my=20, mz=20, outdir=None)
    jsolver = jclaw.solver
    jsolver.setup(jclaw.solution)
    jstate = jclaw.solution.state
    evolve = jsolver._make_evolve_fn(jstate)
    q_j, t_j, _, ns_j, nr_j, *_ = evolve(
        jnp.asarray(jstate.q), jnp.asarray(jstate.aux), 0.0, jsolver.dt, 0.4)
    assert float(t_j) == pytest.approx(0.4, abs=1e-12)
    assert claw.solution.t == pytest.approx(0.4, abs=1e-12)
    assert (status["numsteps"], status["numrejected"]) == (int(ns_j),
                                                           int(nr_j))
    assert status["numrejected"] >= 1 and status["numsteps"] >= 5
    q_j = np.asarray(q_j)
    assert np.abs(claw.solution.q - q_j).max() / np.abs(q_j).max() <= 1e-12


def test_symmetry(run20):
    q = run20[0].solution.q
    assert np.all(np.isfinite(q))
    np.testing.assert_allclose(q[0], q[0].transpose(1, 0, 2), atol=1e-11)
    np.testing.assert_allclose(q[0], q[0][::-1], atol=1e-11)


def test_uniform_medium_matches_homogeneous_acoustics():
    claw_vc = tex.setup(mx=16, my=16, mz=16, rho_bot=1.0, c_bot=1.0,
                        outdir=None, device="cpu")
    claw_vc.tfinal = 0.2
    claw_vc.num_output_times = 1
    claw_vc.run()

    pyclaw = pyclaw_tpu_torch
    solver = pyclaw.ClawSolver3D(pyclaw.riemann.acoustics_3D, device="cpu")
    solver.transverse_waves = 1
    solver.cfl_desired, solver.cfl_max = 0.45, 0.5
    solver.limiters = [pyclaw.limiters.tvd.MC]
    solver.all_bcs = pyclaw.BC.extrap
    domain = pyclaw.Domain([-1.0] * 3, [1.0] * 3, [16, 16, 16])
    state = pyclaw.State(domain, 4)
    state.problem_data["zz"] = 1.0
    state.problem_data["cc"] = 1.0
    x, y, z = domain.grid.c_centers
    state.q[0] = 5.0 * np.exp(-40.0 * (x ** 2 + y ** 2 + (z + 0.5) ** 2))
    state.q[1] = state.q[2] = state.q[3] = 0.0
    claw_h = pyclaw.Controller()
    claw_h.solution = pyclaw.Solution(state, domain)
    claw_h.solver = solver
    claw_h.tfinal = 0.2
    claw_h.num_output_times = 1
    claw_h.output_format = None
    claw_h.run()
    np.testing.assert_allclose(claw_vc.solution.q, claw_h.solution.q,
                               atol=1e-11)


def _layered_state(pkg, n, capacity):
    """The example's layered medium on an (n0, n1, n2) grid with a third
    aux row, a non-uniform capacity function (index_capa = 2)."""
    domain = pkg.Domain([-1.0] * 3, [1.0] * 3, list(n))
    state = pkg.State(domain, 4, num_aux=3 if capacity else 2)
    x, y, z = domain.grid.c_centers
    state.aux[0] = np.where(z < 0.0, 2.0, 1.0)
    state.aux[1] = np.where(z < 0.0, 0.5, 1.0)
    if capacity:
        state.aux[2] = 1.0 + 0.3 * np.sin(3.0 * x) * np.cos(2.0 * y + z)
        state.index_capa = 2
    state.q[0] = 5.0 * np.exp(-40.0 * (x ** 2 + y ** 2 + (z + 0.5) ** 2))
    state.q[1] = 0.3 * np.sin(2.0 * y)
    state.q[2] = 0.0
    state.q[3] = 0.2 * np.cos(x)
    return pkg.Solution(state, domain)


def test_settings_and_state_with_capacity_carry_across():
    """A JAX ClawSolver3D(vc_acoustics_3D) with a capacity row in a 3D aux,
    its own limiters and transverse_waves: the port, set up through
    convert, takes the same fixed-dt step."""
    jsol = _layered_state(pyclaw_tpu, (10, 9, 8), capacity=True)
    jsolver = pyclaw_tpu.ClawSolver3D(pyclaw_tpu.riemann.vc_acoustics_3D)
    jsolver.transverse_waves = 1
    jsolver.limiters = [4, 10]
    jsolver.aux_bc_lower = [pyclaw_tpu.BC.extrap] * 3
    jsolver.aux_bc_upper = [pyclaw_tpu.BC.extrap] * 3
    jsolver.bc_lower = [pyclaw_tpu.BC.wall, pyclaw_tpu.BC.extrap,
                        pyclaw_tpu.BC.extrap]
    jsolver.setup(jsol)
    state = jsol.state
    q_j, c_j = jsolver._step_fn(jnp.asarray(state.q), jnp.asarray(state.aux),
                                1e-2, 0.0)

    dom = jsol.domain.patch
    sol = convert.solution_from_arrays(
        state.q, state.problem_data, dom.lower_global, dom.upper_global,
        dom.num_cells_global, aux=state.aux, index_capa=state.index_capa)
    assert sol.state.index_capa == 2 and sol.state.aux.shape == (3, 10, 9, 8)
    solver = pyclaw_tpu_torch.ClawSolver3D(
        pyclaw_tpu_torch.riemann.vc_acoustics_3D, device="cpu")
    convert.apply_solver_settings(solver, convert.solver_settings(jsolver))
    assert solver.limiters == [4, 10] and solver.transverse_waves == 1
    assert solver.bc_lower[0] == pyclaw_tpu_torch.BC.wall
    assert not solver.fwave
    solver.setup(sol)
    q_t, c_t = solver._step_fn(torch.from_numpy(sol.state.q),
                               torch.from_numpy(sol.state.aux), 1e-2, 0.0)
    q_j = np.asarray(q_j)
    assert np.abs(q_t.numpy() - q_j).max() / np.abs(q_j).max() <= 1e-12
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)


def test_fwave_setting_carries_across():
    """fwave crosses with the settings; the step with it equals the JAX
    solver's (the f-wave correction form on the same waves)."""
    jsol = _layered_state(pyclaw_tpu, (8, 7, 6), capacity=False)
    jsolver = pyclaw_tpu.ClawSolver3D(pyclaw_tpu.riemann.vc_acoustics_3D)
    jsolver.transverse_waves = 1
    jsolver.fwave = True
    jsolver.setup(jsol)
    state = jsol.state
    q_j, c_j = jsolver._step_fn(jnp.asarray(state.q), jnp.asarray(state.aux),
                                1e-2, 0.0)
    dom = jsol.domain.patch
    sol = convert.solution_from_arrays(
        state.q, state.problem_data, dom.lower_global, dom.upper_global,
        dom.num_cells_global, aux=state.aux)
    solver = pyclaw_tpu_torch.ClawSolver3D(
        pyclaw_tpu_torch.riemann.vc_acoustics_3D, device="cpu")
    convert.apply_solver_settings(solver, convert.solver_settings(jsolver))
    assert solver.fwave
    solver.setup(sol)
    q_t, c_t = solver._step_fn(torch.from_numpy(sol.state.q),
                               torch.from_numpy(sol.state.aux), 1e-2, 0.0)
    q_j = np.asarray(q_j)
    assert np.abs(q_t.numpy() - q_j).max() / np.abs(q_j).max() <= 1e-12
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)


def test_aux_frames_across_the_packages(tmp_path):
    """The port writes a 3D frame with aux that the JAX package reads, and
    reads the JAX package's back."""
    out = str(tmp_path)
    sol = _layered_state(pyclaw_tpu_torch, (5, 4, 3), capacity=True)
    sol.write(0, path=out, write_aux=True)
    jsol = pyclaw_tpu.Solution(0, path=out, file_format="ascii",
                               read_aux=True)
    assert jsol.state.aux.shape == (3, 5, 4, 3)
    np.testing.assert_allclose(jsol.state.aux, sol.state.aux, rtol=1e-8)
    np.testing.assert_allclose(jsol.state.q, sol.state.q, rtol=1e-8,
                               atol=1e-12)
    jsol.write(1, path=out, write_aux=True)
    tsol = pyclaw_tpu_torch.Solution(1, path=out, file_format="ascii",
                                     read_aux=True)
    assert tsol.state.num_aux == 3
    np.testing.assert_array_equal(tsol.state.aux, jsol.state.aux)
    np.testing.assert_array_equal(tsol.state.q, jsol.state.q)


def test_what_the_slice_refuses():
    # the SharpClaw route runs (SharpClawSolver3D: the generic dq with
    # aux, the second Riemann solve for the in-cell fluctuation) and takes
    # the JAX solver's fixed-dt step; its unported options raise under
    # their own names
    claw = tex.setup(mx=4, my=5, mz=6, outdir=None, device="cpu",
                     solver_type="sharpclaw")
    jclaw = jex.setup(mx=4, my=5, mz=6, outdir=None, solver_type="sharpclaw")
    for c in (claw, jclaw):
        c.solver.setup(c.solution)
    state = claw.solution.state
    q_t, c_t = claw.solver._step_fn(torch.from_numpy(state.q),
                                    torch.from_numpy(state.aux), 0.05, 0.0)
    jstate = jclaw.solution.state
    q_j, c_j = jclaw.solver._step_fn(jnp.asarray(jstate.q),
                                     jnp.asarray(jstate.aux), 0.05, 0.0)
    q_j = np.asarray(q_j)
    assert np.abs(q_t.numpy() - q_j).max() <= 1e-12 * np.abs(q_j).max()
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)
    # the options once refused here (lim_type=1, weno_order=7,
    # tfluct_solver without a hook: the second Riemann solve) take the
    # JAX solver's fixed-dt step too
    for attr, val in (("lim_type", 1), ("weno_order", 7),
                      ("tfluct_solver", True)):
        claw = tex.setup(mx=4, my=4, mz=4, outdir=None, device="cpu",
                         solver_type="sharpclaw")
        jclaw = jex.setup(mx=4, my=4, mz=4, outdir=None,
                          solver_type="sharpclaw")
        for c in (claw, jclaw):
            setattr(c.solver, attr, val)
            c.solver.setup(c.solution)
        state = claw.solution.state
        q_t, c_t = claw.solver._step_fn(torch.from_numpy(state.q),
                                        torch.from_numpy(state.aux), 0.05,
                                        0.0)
        q_j, c_j = jclaw.solver._step_fn(jnp.asarray(state.q),
                                         jnp.asarray(state.aux), 0.05, 0.0)
        q_j = np.asarray(q_j)
        assert np.abs(q_t.numpy() - q_j).max() <= 1e-12 * np.abs(q_j).max()
        assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)
    # dimensional_split is taken (no longer refused): three sweeps at the
    # default CFL and transverse_waves, as the JAX example sets them
    claw = tex.setup(mx=4, my=4, mz=4, outdir=None, device="cpu",
                     dimensional_split=True)
    claw.solver.setup(claw.solution)
    assert (claw.solver.cfl_max, claw.solver.transverse_waves) == (1.0, 2)
    # no variable-coefficient rptt: transverse_waves=2 is refused
    claw = tex.setup(mx=4, my=4, mz=4, outdir=None, device="cpu")
    claw.solver.transverse_waves = 2
    with pytest.raises(ValueError, match="no rptt"):
        claw.solver.setup(claw.solution)


def test_euler_with_capacity_off_the_cpu_is_refused(monkeypatch):
    """ClawSolver3D routes Euler with a capacity function, with f-waves,
    with both and with neither to step3_xy (csrc/step3_ctu.cu), naming the
    capacity row and the form; never to step3_xy_generic.  On the CPU that
    step is the plain version; a tensor off the CPU that is not the card's
    (a meta tensor) is refused before any launch."""
    from pyclaw_tpu_torch.examples import euler_3d
    from pyclaw_tpu_torch.ops import tiled2d

    def setup(capacity, fwave):
        claw = euler_3d.setup(mx=4, my=4, mz=4, outdir=None, device="cpu")
        if capacity:
            euler_3d.add_capacity(claw.solution.state)
        claw.solver.fwave = fwave
        claw.solver.setup(claw.solution)
        return claw.solver, claw.solution.state

    solver, state = setup(True, False)
    q_t, _ = solver._step_fn(torch.from_numpy(state.q),
                             torch.from_numpy(state.aux), 1e-3, 0.0)
    assert q_t.shape == (5, 4, 4, 4) and bool(torch.isfinite(q_t).all())
    with pytest.raises(ValueError, match="device"):
        solver._step_fn(torch.empty(5, 4, 4, 4, dtype=torch.float64,
                                    device="meta"),
                        torch.empty(1, 4, 4, 4, dtype=torch.float64,
                                    device="meta"), 1e-3, 0.0)

    calls = []

    def recorder(name):
        def step(qbc, *args, **kwargs):
            calls.append((name, args, kwargs))
            return qbc[:, 2:-2, 2:-2, 2:-2], torch.tensor(0.5)
        return step

    monkeypatch.setattr(tiled2d, "step3_xy_generic", recorder("generic"))
    monkeypatch.setattr(tiled2d, "step3_xy", recorder("step3_xy"))
    for capacity, fwave in ((True, False), (False, True), (True, True),
                            (False, False)):
        solver, state = setup(capacity, fwave)
        calls.clear()
        aux = None if state.aux is None else torch.from_numpy(state.aux)
        solver._step_fn(torch.from_numpy(state.q), aux, 1e-3, 0.0)
        assert len(calls) == 1
        name, args, kwargs = calls[0]
        assert name == "step3_xy"
        assert kwargs["fwave"] == fwave
        assert kwargs["index_capa"] == (0 if capacity else -1)
        assert (kwargs["auxbc"] is None) == (not capacity)
