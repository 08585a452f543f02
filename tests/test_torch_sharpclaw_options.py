"""The other SharpClaw options, the port against the JAX package on the
CPU in float64.

* ``limiters/recon.py``: the generic-order WENO tables bit for bit
  (k = 3..9), ``weno`` and ``weno_stencil`` at orders 7-17 and ``tvd2``
  with limiters 1-4 against the JAX functions (1e-12 relative); float32
  on constant data stays finite; ``csrc/weno_tables.cuh`` is what the
  generator writes, byte for byte;
* ``sharpclaw/kernels.py``: ``dq_1d`` and ``dq_nd`` at ``lim_type`` 0 and
  1 with ``char_decomp`` 0-4, and with a ``tfluct`` hook, against the
  JAX functions (1e-12);
* ``Controller.run`` of both packages in 1D with RK (the classical RK4
  tableau), SSPLMMk2 and SSPLMMk3 at variable dt (one case with a
  rejected step), LMM with Adams-Bashforth 3, ``tfluct``, TVD and first
  order, ``weno_order`` 7 and 9 on the advection example, and RK and
  SSPLMMk3 through the acoustics example's keyword: the JAX
  run's step counts (and rejections, where the JAX host loop takes them)
  and 1e-12 of max|q| (the 2D runs: tests/test_torch_sharpclaw_options_2d.py);
* the JAX package's ``ValueError``s for RK without a tableau and the
  LMM misconfigurations, and its ``NotImplementedError`` for an unknown
  integrator, with the same text.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyclaw_tpu
import pyclaw_tpu.riemann  # noqa: F401
import pyclaw_tpu_torch
import pyclaw_tpu_torch.riemann  # noqa: F401
from pyclaw_tpu.limiters import recon as jrecon
from pyclaw_tpu.sharpclaw import kernels as jk
from pyclaw_tpu_torch.limiters import recon as trecon
from pyclaw_tpu_torch.sharpclaw import kernels as tk

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import advection_1d as jadv  # noqa: E402

from pyclaw_tpu_torch.examples import advection_1d as tadv  # noqa: E402

EULER = {"gamma": 1.4}
ORDERS = [7, 9, 11, 13, 15, 17]
RK4 = dict(a=[[0, 0, 0, 0], [0.5, 0, 0, 0], [0, 0.5, 0, 0], [0, 0, 1.0, 0]],
           b=[1 / 6, 1 / 3, 1 / 3, 1 / 6])
AB3 = dict(lmm_alpha=[0.0, 0.0, 1.0],
           lmm_beta=[5.0 / 12.0, -16.0 / 12.0, 23.0 / 12.0])


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _euler(seed, shape, pockets=0.0):
    """A seeded admissible Euler state (1 + len(shape) + 1, *shape); with
    ``pockets``, that share of the cells near vacuum (rho = p = 1e-3),
    where WENO's edge values undershoot below zero."""
    rng = np.random.default_rng(seed)
    rho = 0.5 + rng.random(shape)
    p = 0.5 + rng.random(shape)
    pocket = rng.random(shape) < pockets
    rho = np.where(pocket, 1e-3, rho)
    p = np.where(pocket, 1e-3, p)
    mom = [rho * rng.standard_normal(shape) for _ in shape]
    E = p / 0.4 + 0.5 * sum(m * m for m in mom) / rho
    return np.stack([rho, *mom, E])


# ---- limiters/recon.py -----------------------------------------------------

@pytest.mark.parametrize("k", range(3, 10))
def test_weno_tables_equal_jax(k):
    for a, b in zip(trecon._weno_tables(k), jrecon._weno_tables(k)):
        assert a.dtype == np.float64 and np.array_equal(a, b)


def test_weno_tables_header_is_regenerated_byte_equal():
    path = os.path.join(os.path.dirname(trecon.__file__), "..", "csrc",
                        "weno_tables.cuh")
    with open(path, "rb") as f:
        assert f.read() == trecon.emit_header().encode()


@pytest.mark.parametrize("order", ORDERS)
def test_weno_matches_jax(order):
    """``weno`` on a seeded field, and ``weno_stencil`` on 2k-1 unrelated
    seeded arrays (as the characteristic paths pass it), 1e-12."""
    rng = np.random.default_rng(order)
    q = rng.standard_normal((3, 40))
    lt, rt = trecon.weno(order, torch.from_numpy(q))
    lj, rj = jrecon.weno(order, jnp.asarray(q))
    assert _rel(lt.numpy(), lj) <= 1e-12 and _rel(rt.numpy(), rj) <= 1e-12
    k = (order + 1) // 2
    v = rng.standard_normal((2 * k - 1, 2, 9))
    lt, rt = trecon.weno_stencil(order, [torch.from_numpy(x) for x in v])
    lj, rj = jrecon.weno_stencil(order, [jnp.asarray(x) for x in v])
    assert _rel(lt.numpy(), lj) <= 1e-12 and _rel(rt.numpy(), rj) <= 1e-12


@pytest.mark.parametrize("order", ORDERS)
def test_weno_float32_constant_data_is_finite(order):
    """The float32 rule (betas normalised by their sum + 1e-30, eps 1e-6)
    keeps constant data finite, as tests/test_weno.py requires of the JAX
    package: the edge values are the constant."""
    q = torch.full((2, 30), 1.1, dtype=torch.float32)
    ql, qr = trecon.weno(order, q)
    assert ql.dtype == torch.float32
    assert torch.isfinite(ql).all() and torch.isfinite(qr).all()
    assert float((ql - 1.1).abs().max()) <= 1e-5
    with pytest.raises(ValueError, match="stencil arrays"):
        trecon.weno_stencil(order, [q] * 3)


@pytest.mark.parametrize("limiter", [1, 2, 3, 4])
def test_tvd2_matches_jax(limiter):
    q = np.random.default_rng(limiter).standard_normal((3, 30))
    q[:, 10:14] = 0.7                  # zero forward jumps
    lt, rt = trecon.tvd2(torch.from_numpy(q), limiter)
    lj, rj = jrecon.tvd2(jnp.asarray(q), limiter)
    assert _rel(lt.numpy(), lj) <= 1e-12 and _rel(rt.numpy(), rj) <= 1e-12


# ---- sharpclaw/kernels.py ----------------------------------------------

def _adv_tfluct(pkg):
    """The exact in-cell total fluctuation of advection, u (qr - ql), in
    the package's arrays (tests/test_well_balanced.py:40)."""
    def tfluct(ixy, ql, qr, aux_l, aux_r, params):
        return params["u"] * (qr - ql)
    return tfluct


@pytest.mark.parametrize("lim_type", [0, 1])
@pytest.mark.parametrize("cd", [0, 1, 2, 3, 4])
def test_dq_1d_matches_jax(cd, lim_type):
    q = _euler(30 + cd, (40,))
    rs_t = pyclaw_tpu_torch.riemann.euler_with_efix_1D
    rs_j = pyclaw_tpu.riemann.euler_with_efix_1D
    d_t, c_t = tk.dq_1d(torch.from_numpy(q), None, 1e-3, 0.01, rs_t.rp,
                        EULER, lim_type, 5, -1, 2,
                        positivity=rs_t.positivity, flux=rs_t.flux,
                        char_decomp=cd, evec=rs_t.evec, tvd_limiter=3)
    d_j, c_j = jax.jit(lambda a: jk.dq_1d(
        a, None, 1e-3, 0.01, rs_j.rp, EULER, lim_type, 5, -1, 2,
        char_decomp=cd, evec=rs_j.evec, positivity=rs_j.positivity,
        flux=rs_j.flux, tvd_limiter=3))(q)
    assert _rel(d_t.numpy(), d_j) <= 1e-12
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)


@pytest.mark.parametrize("lim_type", [0, 1])
@pytest.mark.parametrize("cd", [0, 1, 2, 3, 4])
def test_dq_nd_matches_jax(cd, lim_type):
    """2D Euler 4-wave at 9 x 11, two ghost cells (the TVD and first-order
    stencils); limiter 1 (minmod)."""
    q = _euler(40 + cd, (13, 15))
    rs_t = pyclaw_tpu_torch.riemann.euler_4wave_2D
    rs_j = pyclaw_tpu.riemann.euler_4wave_2D
    d_t, c_t = tk.dq_nd(torch.from_numpy(q), None, 1e-3, (0.1, 0.08),
                        rs_t.rp, EULER, lim_type, 5, -1, 2,
                        positivity=rs_t.positivity, flux=rs_t.flux,
                        char_decomp=cd, evec=rs_t.evec, tvd_limiter=1)
    d_j, c_j = jax.jit(lambda a: jk.dq_nd(
        a, None, 1e-3, (0.1, 0.08), rs_j.rp, EULER, lim_type, 5, -1, 2,
        char_decomp=cd, evec=rs_j.evec, positivity=rs_j.positivity,
        flux=rs_j.flux, tvd_limiter=1))(q)
    assert _rel(d_t.numpy(), d_j) <= 1e-12
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)


@pytest.mark.parametrize("lim_type,order", [(2, 5), (2, 9), (1, 5)])
def test_dq_with_tfluct_matches_jax(lim_type, order):
    """A user tfluct replaces the in-cell fluctuation (and the flux), in
    1D and in 2D (dq_nd passes it to each sweep)."""
    u = {"u": 1.3, "v": -0.6}
    g = (order + 1) // 2 if lim_type == 2 else 2
    q = np.random.default_rng(order).standard_normal((1, 30))
    rs_t = pyclaw_tpu_torch.riemann.advection_1D
    rs_j = pyclaw_tpu.riemann.advection_1D
    d_t, c_t = tk.dq_1d(torch.from_numpy(q), None, 1e-2, 0.05, rs_t.rp, u,
                        lim_type, order, -1, g, tfluct=_adv_tfluct(torch))
    d_j, c_j = jax.jit(lambda a: jk.dq_1d(
        a, None, 1e-2, 0.05, rs_j.rp, u, lim_type, order, -1, g,
        tfluct=_adv_tfluct(jnp)))(q)
    assert _rel(d_t.numpy(), d_j) <= 1e-12
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)

    def tfluct2(ixy, ql, qr, aux_l, aux_r, params):
        return (params["u"] if ixy == 0 else params["v"]) * (qr - ql)
    q2 = np.random.default_rng(order + 1).standard_normal((1, 14, 16))
    rs_t = pyclaw_tpu_torch.riemann.advection_2D
    rs_j = pyclaw_tpu.riemann.advection_2D
    d_t, c_t = tk.dq_nd(torch.from_numpy(q2), None, 1e-2, (0.05, 0.07),
                        rs_t.rp, u, lim_type, order, -1, g, tfluct=tfluct2)
    d_j, c_j = jax.jit(lambda a: jk.dq_nd(
        a, None, 1e-2, (0.05, 0.07), rs_j.rp, u, lim_type, order, -1, g,
        tfluct=tfluct2))(q2)
    assert _rel(d_t.numpy(), d_j) <= 1e-12
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)


# ---- Controller.run in both packages --------------------------------------

def _advection(pkg, time_integrator, nx=64, dt=None, tfinal=0.25, tfluct=False,
               **attrs):
    """SharpClaw 1D advection of sin^4(2 pi x) on [0, 1], periodic (the
    JAX package's tests/test_integrators.py run): the Controller, the
    solver's settings in ``attrs``; ``dt`` a fixed step."""
    kw = {"device": "cpu"} if pkg is pyclaw_tpu_torch else {}
    solver = pkg.SharpClawSolver1D(pkg.riemann.advection_1D, **kw)
    solver.time_integrator = time_integrator
    solver.all_bcs = pkg.BC.periodic
    for key, val in attrs.items():
        setattr(solver, key, val)
    if dt is not None:
        solver.dt_variable = False
        solver.dt_initial = dt
    if tfluct:
        solver.tfluct_solver = True
        solver.tfluct = _adv_tfluct(pkg)
    domain = pkg.Domain([0.0], [1.0], [nx])
    state = pkg.State(domain, 1)
    state.problem_data["u"] = 1.0
    x = domain.grid.x.centers
    state.q[0, :] = np.sin(2 * np.pi * x) ** 4
    claw = pkg.Controller()
    claw.solution = pkg.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = tfinal
    claw.num_output_times = 2
    claw.output_format = None
    return claw


def _count_rejections(solver):
    """Wrap the JAX solver's accept_reject_step to count its rejections
    (its host loop keeps no count)."""
    seen = {"rejected": 0}
    accept = solver.accept_reject_step

    def counting(cfl):
        ok = accept(cfl)
        seen["rejected"] += not ok
        return ok
    solver.accept_reject_step = counting
    return seen


def _both(time_integrator, **kw):
    """(port status, JAX steps, JAX rejections or None, rel difference of
    q).  The JAX package counts no rejections; those of its host loop (the
    multistep methods) are counted here."""
    claw_j = _advection(pyclaw_tpu, time_integrator, **kw)
    seen = _count_rejections(claw_j.solver)
    claw_j.run()
    claw_t = _advection(pyclaw_tpu_torch, time_integrator, **kw)
    status = claw_t.run()
    assert claw_t.solution.t == pytest.approx(claw_j.solution.t, abs=1e-12)
    host = not claw_j.solver._can_use_traced_evolve(claw_j.solution.state)
    return (status, claw_j.solver.status["numsteps"],
            seen["rejected"] if host else None,
            _rel(claw_t.solution.q, claw_j.solution.q))


@pytest.mark.parametrize("case", [
    ("RK", dict(RK4)), ("RK", dict(RK4, dt=1.0 / 256)),
    ("SSPLMMk2", dict(lmm_steps=5, dt_initial=1e-4)),
    ("SSPLMMk3", dict(lmm_steps=5, dt_initial=1e-4)),
    ("SSPLMMk3", dict(lmm_steps=4, dt_initial=0.05)),
    ("LMM", dict(AB3, dt=1.0 / 600)),
    ("SSP104", dict(tfluct=True)),
    ("SSP104", dict(lim_type=1, tvd_limiter=2)),
    ("SSP104", dict(lim_type=0))],
    ids=["rk4", "rk4-fixed", "ssplmmk2", "ssplmmk3", "ssplmmk3-rejected",
         "lmm-ab3", "tfluct", "tvd", "first-order"])
def test_controller_run_matches_jax(case):
    """Each option's whole run in both packages: the JAX run's steps and
    rejections (the SSPLMMk3 run from dt 0.05 rejects its first step and
    restores the history) and 1e-12 of max|q|; the multistep methods take
    the host loop, the one-step methods the device loop."""
    time_integrator, kw = case
    status, ns_j, nr_j, rel = _both(time_integrator, **kw)
    assert status["numsteps"] == ns_j
    if nr_j is not None:
        assert status["numrejected"] == nr_j
    if kw.get("dt_initial") == 0.05:
        assert nr_j >= 1
    assert rel <= 1e-12


def test_multistep_takes_the_jax_host_loop_and_lowers_dt():
    """SSPLMMk3 lowers dt to keep Omega above its floor (the step reads
    self.dt back), and replays nothing after the end: the attempts are
    the accepted and rejected steps."""
    claw = _advection(pyclaw_tpu_torch, "SSPLMMk3", lmm_steps=4,
                      dt_initial=0.05)
    status = claw.run()
    solver = claw.solver
    assert solver._host_sequenced and solver.loop_stats["attempts"] == 0
    assert status["dtmin"] < status["dtmax"] < 0.05
    assert len(solver._lmm_history) == solver.lmm_steps - 1


@pytest.mark.parametrize("order", [7, 9])
def test_advection_example_weno_order_matches_jax(order):
    """examples/advection_1d with SharpClaw at weno_order 7 and 9 (its
    keyword), float64, to its final time: the JAX run's steps, 1e-12."""
    claw_j = jadv.setup(nx=100, outdir=None, solver_type="sharpclaw",
                        weno_order=order)
    claw_j.run()
    claw_t = tadv.setup(nx=100, outdir=None, solver_type="sharpclaw",
                        weno_order=order, device="cpu")
    status = claw_t.run()
    assert claw_t.solver.num_ghost == (order + 1) // 2
    assert status["numsteps"] == claw_j.solver.status["numsteps"]
    assert _rel(claw_t.solution.q, claw_j.solution.q) <= 1e-12


@pytest.mark.parametrize("integrator", ["RK", "SSPLMMk3"])
def test_acoustics_1d_example_integrators_match_jax(integrator):
    """examples/acoustics_1d with SharpClaw and its ``time_integrator``
    keyword: RK (the RK4 tableau set after setup, the device loop) and
    SSPLMMk3 (the host loop), float64 to its t=1.0 in ten frames: the
    JAX run's steps, 1e-12 of max|q|."""
    import acoustics_1d as jac
    from pyclaw_tpu_torch.examples import acoustics_1d as tac
    claws = [jac.setup(nx=100, solver_type="sharpclaw", outdir=None,
                       time_integrator=integrator),
             tac.setup(nx=100, solver_type="sharpclaw", outdir=None,
                       time_integrator=integrator, device="cpu")]
    for claw in claws:
        if integrator == "RK":
            claw.solver.a, claw.solver.b = RK4["a"], RK4["b"]
    claws[0].run()
    status = claws[1].run()
    assert claws[1].solver.time_integrator == integrator
    assert status["numsteps"] == claws[0].solver.status["numsteps"]
    assert _rel(claws[1].solution.q, claws[0].solution.q) <= 1e-12


def test_call_before_step_each_stage_is_accepted_and_ignored():
    """Both packages store the flag and never read it: the run equals the
    run without it (ROADMAP.md, Queue 3)."""
    runs = []
    for flag in (False, True):
        claw = _advection(pyclaw_tpu_torch, "SSP104", tfinal=0.1,
                          call_before_step_each_stage=flag)
        claw.run()
        runs.append(claw.solution.q.copy())
    assert np.array_equal(runs[0], runs[1])


# ---- the JAX package's errors ---------------------------------------------

def _error(pkg, time_integrator, dt_variable=None, **attrs):
    claw = _advection(pkg, time_integrator, nx=16, **attrs)
    if dt_variable is not None:
        claw.solver.dt_variable = dt_variable
    with pytest.raises((ValueError, NotImplementedError)) as info:
        claw.solver.setup(claw.solution)
    return info.type, str(info.value)


@pytest.mark.parametrize("time_integrator,attrs", [
    ("RK", dict(dt=0.01)),
    ("RK", dict(dt=0.01, a=RK4["a"])),
    ("LMM", dict(dt=0.01)),
    ("LMM", dict(lmm_alpha=[0.0, 1.0], lmm_beta=[-0.5, 1.5])),
    ("LMM", dict(dt=0.01, lmm_alpha=[0.5, 0.0], lmm_beta=[0.0, 1.0])),
    ("LMM", dict(dt=0.01, lmm_alpha=[0.0, 1.0], lmm_beta=[1.0])),
    ("SSP22", dict())],
    ids=["rk-no-tableau", "rk-no-b", "lmm-no-coeffs", "lmm-dt-variable",
         "lmm-alpha-sum", "lmm-shapes", "unknown"])
def test_errors_match_jax(time_integrator, attrs):
    """The same exception type and text as the JAX package's setup
    (tests/test_integrators.py:53, 126-145; an unknown integrator,
    sharpclaw/solver.py:384-387)."""
    assert (_error(pyclaw_tpu_torch, time_integrator, **attrs)
            == _error(pyclaw_tpu, time_integrator, **attrs))
