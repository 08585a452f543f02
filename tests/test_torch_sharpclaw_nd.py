"""The port's generic SharpClaw dq (``sharpclaw/kernels.py:dq_nd``) and the
2D routes it opens, against the JAX package's, on the CPU, in float64
(the 3D half: tests/test_torch_sharpclaw3d.py).

* ``dq_nd`` against the JAX package's ``dq_nd`` (``backend="xla"``,
  jitted) on seeded ghost-padded states, to 1e-12 of max|dq| and the CFL
  to 1e-12 relative: shallow water 2D, Euler 2D through its AoS normal
  solver, and ``char_decomp`` 1-4 on Euler 2D;
* the new hooks (Euler's AoS ``rp`` in 2D, the Euler flux in 2D and 3D,
  the shallow-water flux and eigenvectors, the heterogeneous acoustics
  eigenvectors) against the JAX package's to 1e-12;
* the acoustics SoA plain dq (``sharpclaw/soa.py:dq_2d_soa`` with
  acoustics' constant speeds, what ``ops.tiled2d.dq_rows`` computes on
  the CPU) against the JAX package's ``dq_2d_soa``;
* whole runs of the SharpClaw routes of ``examples/acoustics_2d.py`` and
  ``examples/shallow_2d_radial.py`` at 24^2 against the JAX examples:
  equal steps, t equal, q to 1e-12 of max|q| (the SharpClaw routes of
  these and of the two 3D examples sit 4e-16 to 2e-14 from the JAX
  package's at these sizes; longer 2D runs through shocks sit up to
  2.1e-11 away);
* ``convert`` carries ``use_soa`` across.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

import pyclaw_tpu_torch
from pyclaw_tpu import riemann as jriemann
from pyclaw_tpu.riemann import acoustics_var as jav
from pyclaw_tpu.riemann import euler as je
from pyclaw_tpu.riemann import shallow as jsh
from pyclaw_tpu.sharpclaw import kernels as jk
from pyclaw_tpu.sharpclaw import soa as jsoa
from pyclaw_tpu_torch import convert
from pyclaw_tpu_torch import riemann as triemann
from pyclaw_tpu_torch.riemann import acoustics_var as tav
from pyclaw_tpu_torch.riemann import euler as te
from pyclaw_tpu_torch.riemann import shallow as tsh
from pyclaw_tpu_torch.sharpclaw import kernels as tk
from pyclaw_tpu_torch.sharpclaw import soa as tsoa

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

TOL = 1e-12
G = 3
ACOUSTICS = {"rho": 1.0, "bulk": 4.0, "zz": 2.0, "cc": 2.0}
PARAMS = {"euler_3D": {"gamma": 1.4}, "euler_4wave_2D": {"gamma": 1.4},
          "acoustics_3D": ACOUSTICS, "acoustics_2D": ACOUSTICS,
          "advection_3D": {"u": 1.0, "v": -0.5, "w": 0.25},
          "vc_acoustics_3D": {},
          "shallow_roe_with_efix_2D": {"grav": 1.0}}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def _euler(rng, shape):
    """A seeded admissible Euler state (2D or 3D by ``shape``)."""
    rho = 0.5 + rng.random(shape)
    vel = [0.5 * rng.standard_normal(shape) for _ in shape]
    p = 0.5 + rng.random(shape)
    ke = 0.5 * rho * sum(v * v for v in vel)
    return np.stack([rho] + [rho * v for v in vel] + [p / 0.4 + ke])


def _state(name, rng, shape):
    """(qbc, auxbc) of system ``name`` on ghost-padded cells ``shape``."""
    if name.startswith("euler"):
        return _euler(rng, shape), None
    if name == "advection_3D":
        return rng.standard_normal((1,) + shape), None
    if name == "shallow_roe_with_efix_2D":
        h = 1.0 + 0.3 * rng.random(shape)
        return np.stack([h, 0.2 * h * rng.standard_normal(shape),
                         0.2 * h * rng.standard_normal(shape)]), None
    q = rng.standard_normal((len(shape) + 1,) + shape)
    if name == "vc_acoustics_3D":
        return q, np.stack([1.0 + 2.0 * rng.random(shape),
                            0.5 + rng.random(shape)])
    return q, None


SHAPE = {2: (7 + 2 * G, 5 + 2 * G), 3: (5 + 2 * G, 4 + 2 * G, 6 + 2 * G)}
def check_dq_nd(name, cd, capa):
    """The port's dq_nd against the JAX package's on a seeded state of
    system ``name`` (``char_decomp`` cd, with a capacity row if capa)."""
    jrp, trp = getattr(jriemann, name), getattr(triemann, name)
    ndim = jrp.num_dim
    rng = np.random.default_rng(len(name) + 7 * cd + capa)
    qbc, auxbc = _state(name, rng, SHAPE[ndim])
    index_capa = -1
    if capa:
        auxbc = 0.75 + 0.5 * rng.random((1,) + SHAPE[ndim])
        index_capa = 0
    params = PARAMS[name]
    deltas = (0.1, 0.125, 0.15)[:ndim]
    dt = 0.01

    def jax_dq(q, aux):
        return jk.dq_nd(q, aux, dt, deltas, jrp.rp, params, 2, 5,
                        index_capa, G, char_decomp=cd, evec=jrp.evec,
                        positivity=jrp.positivity, backend="xla",
                        flux=jrp.flux)
    dj, cj = jax.jit(jax_dq)(qbc, auxbc)
    dt_, ct = tk.dq_nd(torch.from_numpy(qbc),
                       None if auxbc is None else torch.from_numpy(auxbc),
                       dt, deltas, trp.rp, params, 2, 5, index_capa, G,
                       positivity=trp.positivity, flux=trp.flux,
                       char_decomp=cd, evec=trp.evec)
    interior = tuple(n - 2 * G for n in SHAPE[ndim])
    assert dt_.shape == (qbc.shape[0],) + interior
    assert np.all(np.isfinite(dt_.numpy()))
    assert _rel(dt_.numpy(), dj) <= TOL
    assert abs(float(ct) - float(cj)) <= TOL * float(cj)


def check_example(name, kw):
    """The SharpClaw route of example ``name`` against the JAX example's:
    equal steps (at least 2), t equal, q to TOL of max|q|."""
    jex = __import__(name)
    tex = __import__(f"pyclaw_tpu_torch.examples.{name}",
                     fromlist=["setup"])
    jclaw = jex.setup(outdir=None, solver_type="sharpclaw", **kw)
    jclaw.num_output_times = 1
    jstatus = jclaw.run()
    claw = tex.setup(outdir=None, solver_type="sharpclaw", device="cpu",
                     dtype=np.float64, **kw)
    claw.num_output_times = 1
    status = claw.run()
    assert type(claw.solver).__name__ == type(jclaw.solver).__name__
    assert claw.solution.t == jclaw.solution.t == jclaw.tfinal
    assert status["numsteps"] == jstatus["numsteps"] >= 2
    assert _rel(claw.solution.q, jclaw.solution.q) <= TOL


@pytest.mark.parametrize("name,cd", [("shallow_roe_with_efix_2D", 0)]
                         + [("euler_4wave_2D", cd) for cd in range(5)])
def test_dq_nd_matches_jax(name, cd):
    check_dq_nd(name, cd, False)


@pytest.mark.parametrize("ixy", [0, 1])
def test_euler_2d_aos_rp_matches_jax(ixy):
    rng = np.random.default_rng(20 + ixy)
    ql, qr = _euler(rng, (6, 5)), _euler(rng, (6, 5))
    out_j = je._rpn2_euler_4wave(ixy, ql, qr, None, None, {"gamma": 1.4})
    out_t = te.euler_4wave_2D.rp(ixy, torch.from_numpy(ql),
                                 torch.from_numpy(qr), None, None,
                                 {"gamma": 1.4})
    for a, b in zip(out_t, out_j):
        assert a.shape == b.shape and _rel(a.numpy(), b) <= TOL


@pytest.mark.parametrize("ndim,ixy", [(2, 0), (2, 1), (3, 0), (3, 1),
                                      (3, 2)])
def test_euler_flux_matches_jax(ndim, ixy):
    q = _euler(np.random.default_rng(30 + ixy), (5, 4, 3)[:ndim])
    name = "euler_4wave_2D" if ndim == 2 else "euler_3D"
    fj = getattr(jriemann, name).flux(ixy, jax.numpy.asarray(q), None,
                                      {"gamma": 1.4})
    ft = getattr(triemann, name).flux(ixy, torch.from_numpy(q), None,
                                      {"gamma": 1.4})
    assert _rel(ft.numpy(), fj) <= TOL


@pytest.mark.parametrize("ixy", [0, 1])
def test_shallow_hooks_match_jax(ixy):
    q, _ = _state("shallow_roe_with_efix_2D", np.random.default_rng(ixy),
                  (6, 5))
    q[0, 0, 0] = 0.0                   # a dry cell: zero flux
    params = {"grav": 9.81}
    fj = jsh._flux_shallow(ixy, q, None, params)
    ft = tsh.shallow_roe_with_efix_2D.flux(ixy, torch.from_numpy(q), None,
                                          params)
    assert _rel(ft.numpy(), fj) <= TOL and ft[:, 0, 0].abs().max() == 0.0
    q[0, 0, 0] = 1.0
    for a, b in zip(tsh.shallow_roe_with_efix_2D.evec(
            ixy, torch.from_numpy(q), None, params),
            jsh._evec_shallow(ixy, q, None, params)):
        assert a.shape == (3, 3, 6, 5) and _rel(a.numpy(), b) <= TOL


@pytest.mark.parametrize("ixy", [0, 1, 2])
def test_vc_acoustics_evec_matches_jax(ixy):
    q, aux = _state("vc_acoustics_3D", np.random.default_rng(ixy), (4, 3, 5))
    R_j, L_j = jav._evec_acoustics_var(ixy, q, aux, {})
    R_t, L_t = tav.vc_acoustics_3D.evec(ixy, torch.from_numpy(q),
                                        torch.from_numpy(aux), {})
    assert _rel(R_t.numpy(), R_j) <= TOL and _rel(L_t.numpy(), L_j) <= TOL
    # L is R's inverse in every cell
    eye = np.einsum("ab...,bc...->ac...", L_t.numpy(), R_t.numpy())
    assert np.abs(eye - np.eye(4)[:, :, None, None, None]).max() <= 1e-14


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-6)])
@pytest.mark.parametrize("nx,ny", [(16, 21)])
def test_acoustics_soa_plain_dq_matches_jax(nx, ny, dtype, tol):
    """The plain version of dq2_weno5.cu's acoustics instance: constant
    speeds (Python floats) in the fluctuations and the CFL."""
    rng = np.random.default_rng(nx * ny)
    qbc = rng.standard_normal((3, nx + 6, ny + 6)).astype(dtype)
    dt = float(dtype(0.4 / max(nx, ny)))
    jrp = jriemann.acoustics_2D
    dj, cj = jax.jit(lambda q, d: jsoa.dq_2d_soa(
        q, d, 2 / nx, 2 / ny, jrp.rpn_soa, ACOUSTICS, 5, G,
        flux_soa=jrp.flux_soa))(qbc, jax.numpy.asarray(dt, dtype))
    trp = triemann.acoustics_2D
    d_t, c_t = tsoa.dq_2d_soa(torch.from_numpy(qbc), dt, 2 / nx, 2 / ny,
                              trp.rpn_soa, ACOUSTICS, 5, G,
                              flux_soa=trp.flux_soa)
    assert d_t.dtype == torch.from_numpy(qbc).dtype
    assert _rel(d_t.numpy(), dj) <= tol
    assert abs(float(c_t) - float(cj)) <= tol * float(cj)
    # the CFL of constant speeds: dt/min(dx, dy) * cc, in q's dtype
    assert float(c_t) == pytest.approx(dt / (2 / max(nx, ny)) * 2.0,
                                       rel=tol)


@pytest.mark.parametrize("name", ["acoustics_2d", "shallow_2d_radial"])
def test_example_sharpclaw_route_matches_jax(name):
    check_example(name, dict(mx=24, my=24))


def test_convert_carries_use_soa():
    import euler_2d_quadrants as jquad
    jclaw = jquad.setup(mx=8, my=8, outdir=None, solver_type="sharpclaw")
    jclaw.solver.use_soa = False
    settings = convert.solver_settings(jclaw.solver)
    assert settings["use_soa"] is False
    solver = pyclaw_tpu_torch.SharpClawSolver2D(
        triemann.euler_4wave_2D, device="cpu")
    convert.apply_solver_settings(solver, settings)
    assert solver.use_soa is False
    # the carried setting picks the route: the generic dq, not dq_rows
    sol = convert.solution_from_arrays(
        np.asarray(jclaw.solution.q), jclaw.solution.state.problem_data,
        [-0.5, -0.5], [0.5, 0.5], [8, 8])
    solver.setup(sol)
    assert not solver._soa_eligible(sol.state)


def test_soa_system_without_an_instance_raises_off_the_cpu():
    """dq_rows runs any system with SoA hooks on a CPU tensor (its plain
    version) and refuses, on any other device, one that dq2_weno5.cu has
    no instance of, naming its ROADMAP item; nothing falls back."""
    from pyclaw_tpu_torch.ops import tiled2d
    rs = triemann.RiemannSolver("soa_only_2D", 2, 3, 2,
                                triemann.acoustics_2D.rp)
    rs.rpn_soa = triemann.acoustics_2D.rpn_soa
    rs.flux_soa = triemann.acoustics_2D.flux_soa
    qbc = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 14, 12)))
    d, c = tiled2d.dq_rows(qbc, 0.01, 0.1, 0.1, ACOUSTICS, rp=rs)
    d_a, c_a = tiled2d.dq_rows(qbc, 0.01, 0.1, 0.1, ACOUSTICS,
                               rp=triemann.acoustics_2D)
    assert torch.equal(d, d_a) and float(c) == float(c_a)
    with pytest.raises(NotImplementedError, match="Queue 2 item 12"):
        tiled2d.dq_rows(qbc.to("meta"), 0.01, 0.1, 0.1, ACOUSTICS, rp=rs)
