"""The port's 1D SharpClaw semidiscretization against the JAX package's.

* ``sharpclaw/kernels.py:dq_1d`` of the port against
  ``pyclaw_tpu/sharpclaw/kernels.py:dq_1d`` (WENO5, char_decomp 0) in
  float64, CFL included, to 1e-12 relative: Euler with the ``flux`` hook
  and the positivity fallback (on a state where it fires), acoustics with
  its ``flux``, advection through the second-Riemann-solve branch (no
  ``flux``), and a non-uniform capacity function.
* one fixed-dt step of ``SharpClawSolver1D`` with SSP104, SSP33 and
  Euler, the solver settings carried across with
  ``pyclaw_tpu_torch.convert``, against the JAX package's ``_step_fn``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyclaw_tpu
import pyclaw_tpu_torch
from pyclaw_tpu import riemann as jriemann
from pyclaw_tpu.sharpclaw import kernels as jk
from pyclaw_tpu_torch import convert
from pyclaw_tpu_torch import riemann as triemann
from pyclaw_tpu_torch.ops import weno
from pyclaw_tpu_torch.sharpclaw import kernels as tk

PARAMS = {"u": 0.8, "rho": 1.3, "bulk": 2.0, "gamma": 1.4}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _state(name, n, seed, pockets=0.0):
    """Ghost-padded q (num_eqn, n) and aux (1, n), a positive capacity
    function.  With ``pockets``, that share of the Euler cells has a
    density and pressure of 0.01 among neighbours near 1, so some WENO
    edge states go negative and the positivity fallback runs."""
    rng = np.random.default_rng(seed)
    if name.startswith("euler"):
        rho = 0.5 + rng.random(n)
        u = rng.standard_normal(n)
        p = 0.5 + rng.random(n)
        if pockets:
            pocket = rng.random(n) < pockets
            rho = np.where(pocket, 0.01, rho)
            p = np.where(pocket, 0.01, p)
        q = np.stack([rho, rho * u, p / 0.4 + 0.5 * rho * u * u])
    else:
        q = rng.standard_normal((2 if name == "acoustics_1D" else 1, n))
    return q, 0.7 + 0.6 * rng.random((1, n))


def _fallbacks(q, rp):
    ql, qr = weno.weno5(torch.from_numpy(q))
    ok = rp.positivity(ql, None, PARAMS) & rp.positivity(qr, None, PARAMS)
    return int((~ok).sum())


@pytest.mark.parametrize("name,use_flux,capa,pockets", [
    ("euler_with_efix_1D", True, -1, 0.08),
    ("euler_with_efix_1D", True, 0, 0.0),
    ("euler_hlle_1D", True, 0, 0.08),
    ("euler_roe_1D", False, -1, 0.0),
    ("acoustics_1D", True, -1, 0.0),
    ("advection_1D", False, -1, 0.0),
    ("advection_1D", False, 0, 0.0)])
def test_dq_1d_matches_jax(name, use_flux, capa, pockets):
    n, g = 40, 3
    q, aux = _state(name, n + 2 * g, len(name) + capa, pockets)
    trp, jrp = triemann.ALL[name], jriemann.ALL[name]
    if pockets:
        assert _fallbacks(q, trp) > 0
    dt, dx = 0.5 / n, 1.0 / n
    d_t, c_t = tk.dq_1d(torch.from_numpy(q), torch.from_numpy(aux), dt, dx,
                        trp.rp, PARAMS, 2, 5, capa, g,
                        positivity=trp.positivity,
                        flux=trp.flux if use_flux else None)
    d_j, c_j = jk.dq_1d(jnp.asarray(q), jnp.asarray(aux), dt, dx, jrp.rp,
                        PARAMS, 2, 5, capa, g, positivity=jrp.positivity,
                        flux=jrp.flux if use_flux else None)
    d_j = np.asarray(d_j)
    assert d_t.shape == d_j.shape == (trp.num_eqn, n)
    assert np.abs(d_t.numpy() - d_j).max() <= 1e-12 * np.abs(d_j).max()
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)


def _sod(pkg, nx, integrator):
    """The Sod tube with a smooth seeded perturbation, on pkg's
    SharpClawSolver1D (the port's on the CPU)."""
    domain = pkg.Domain([-0.5], [0.5], [nx])
    state = pkg.State(domain, 3)
    state.problem_data["gamma"] = 1.4
    x = domain.grid.x.centers
    rho = np.where(x < 0.0, 1.0, 0.125) + 0.05 * np.sin(9.0 * x)
    state.q[0] = rho
    state.q[1] = 0.3 * rho * np.cos(5.0 * x)
    state.q[2] = np.where(x < 0.0, 2.5, 0.25) + 0.5 * state.q[1] ** 2 / rho
    return pkg.Solution(state, domain)


@pytest.mark.parametrize("integrator", ["SSP104", "SSP33", "Euler"])
def test_fixed_dt_step_matches_jax_step_fn(integrator):
    jsol = _sod(pyclaw_tpu, 48, integrator)
    jsolver = pyclaw_tpu.SharpClawSolver1D(jriemann.euler_with_efix_1D)
    jsolver.time_integrator = integrator
    jsolver.bc_lower = [pyclaw_tpu.BC.wall]
    jsolver.bc_upper = [pyclaw_tpu.BC.extrap]
    jsolver.setup(jsol)
    state = jsol.state
    dt = 4e-3
    q_j, c_j = jsolver._step_fn(jnp.asarray(state.q), None, dt, 0.0)

    dom = jsol.domain.patch
    sol = convert.solution_from_arrays(state.q, state.problem_data,
                                       dom.lower_global, dom.upper_global,
                                       dom.num_cells_global)
    solver = pyclaw_tpu_torch.SharpClawSolver1D(
        triemann.euler_with_efix_1D, device="cpu")
    convert.apply_solver_settings(solver, convert.solver_settings(jsolver))
    assert (solver.time_integrator, solver.bc_lower) == (
        integrator, [pyclaw_tpu_torch.BC.wall])
    solver.setup(sol)
    assert (solver.cfl_desired, solver.cfl_max) == (jsolver.cfl_desired,
                                                    jsolver.cfl_max)
    before = weno.weno5.launches
    q_t, c_t = solver._step_fn(torch.from_numpy(sol.state.q), None, dt, 0.0)
    assert weno.weno5.launches == before          # CPU: the plain version
    q_j = np.asarray(q_j)
    assert np.abs(q_t.numpy() - q_j).max() <= 1e-12 * np.abs(q_j).max()
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)
