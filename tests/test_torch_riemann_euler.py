"""The port's 2D Euler Roe solvers against the JAX package's on random
admissible states: rpn2 waves and speeds, the shared eigensystem
(prefactor) and the rpt2 split, for ixy 0 and 1, in SoA form (4 waves,
and 5 with the passive tracer) and in AoS form (_rpn2_euler 4/5-wave,
_prefactor_euler_2d, _rpt2_euler with and without eig, both imp), and
the tracer's SoA flux.  float64 to 1e-13 relative; float32 to 1e-5,
which also runs the rsqrt branch of _alpha34."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyclaw_tpu import riemann as jriemann
from pyclaw_tpu.riemann import euler as je
from pyclaw_tpu_torch import riemann as triemann
from pyclaw_tpu_torch.riemann import euler as te

PARAMS = {"gamma": 1.4}
TOL = {np.float64: 1e-13, np.float32: 1e-5}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _sides(seed, dtype, n=(12, 9), num_eqn=4):
    """Left/right admissible states (num_eqn, *n), velocities of either
    sign (u - a and u + a cross zero); the 5th component a tracer rho phi,
    zero in about half of the cells."""
    rng = np.random.default_rng(seed)

    def side():
        rho = 0.5 + rng.random(n)
        u, v = rng.standard_normal(n), rng.standard_normal(n)
        p = 0.5 + rng.random(n)
        q = [rho, rho * u, rho * v, p / 0.4 + 0.5 * rho * (u * u + v * v)]
        if num_eqn == 5:
            q.append(rho * rng.random(n) * (rng.random(n) < 0.5))
        return np.stack(q).astype(dtype)
    return side(), side()


def _cmp(got, ref, dtype):
    ref = np.asarray(ref, dtype=np.float64)
    got = got.numpy().astype(np.float64)
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(got - ref).max() / scale <= TOL[dtype]


def _both(ql, qr):
    jl = tuple(jnp.asarray(c) for c in ql)
    jr = tuple(jnp.asarray(c) for c in qr)
    tl = tuple(torch.from_numpy(c) for c in ql)
    tr = tuple(torch.from_numpy(c) for c in qr)
    return jl, jr, tl, tr


def test_registry():
    rs = triemann.euler_4wave_2D
    assert (rs.num_dim, rs.num_eqn, rs.num_waves) == (2, 4, 4)
    assert rs.requires == ("gamma",)
    assert triemann.ALL == {
        "advection_1D": triemann.advection_1D,
        "acoustics_1D": triemann.acoustics_1D,
        "euler_with_efix_1D": triemann.euler_with_efix_1D,
        "euler_roe_1D": triemann.euler_roe_1D,
        "euler_hlle_1D": triemann.euler_hlle_1D,
        "euler_4wave_2D": rs, "euler_5wave_2D": triemann.euler_5wave_2D,
        "euler_3D": triemann.euler_3D,
        "shallow_roe_with_efix_2D": triemann.shallow_roe_with_efix_2D,
        "shallow_bathymetry_fwave_2D":
            triemann.shallow_bathymetry_fwave_2D,
        "sw_aug_2D": triemann.sw_aug_2D,
        "advection_3D": triemann.advection_3D,
        "acoustics_3D": triemann.acoustics_3D,
        "vc_acoustics_3D": triemann.vc_acoustics_3D,
        "acoustics_2D": triemann.acoustics_2D,
        "sw_aug_1D": triemann.sw_aug_1D,
        "advection_2D": triemann.advection_2D,
        "vc_advection_2D": triemann.vc_advection_2D,
        "vc_advection_fwave_2D": triemann.vc_advection_fwave_2D,
        "vc_acoustics_2D": triemann.vc_acoustics_2D,
        "kpp_2D": triemann.kpp_2D,
        "burgers_2D": triemann.burgers_2D,
        "burgers_3D": triemann.burgers_3D,
        "psystem_2D": triemann.psystem_2D,
        "shallow_sphere_fwave_2D": triemann.shallow_sphere_fwave_2D,
        "shallow_roe_with_efix_1D": triemann.shallow_roe_with_efix_1D,
        "shallow_hlle_1D": triemann.shallow_hlle_1D,
        "shallow_bathymetry_fwave_1D":
            triemann.shallow_bathymetry_fwave_1D,
        "psystem_1D": triemann.psystem_1D,
        "vc_advection_1D": triemann.vc_advection_1D,
        "vc_advection_fwave_1D": triemann.vc_advection_fwave_1D,
        "acoustics_variable_1D": triemann.acoustics_variable_1D,
        "burgers_1D": triemann.burgers_1D, "traffic_1D": triemann.traffic_1D,
        "mhd_1D": triemann.mhd_1D}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("ixy", [0, 1])
def test_rpn2_matches_jax(ixy, dtype):
    ql, qr = _sides(ixy, dtype)
    jl, jr, tl, tr = _both(ql, qr)
    wj, sj = je._rpn2_euler_soa(ixy, jl, jr, PARAMS)
    wt, st = te._rpn2_euler_soa(ixy, tl, tr, PARAMS)
    for p in range(4):
        _cmp(st[p], sj[p], dtype)
        for e in range(4):
            assert (wt[p][e] is None) == (wj[p][e] is None)
            if wj[p][e] is not None:
                assert wt[p][e].dtype == torch.from_numpy(ql).dtype
                _cmp(wt[p][e], wj[p][e], dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("ixy", [0, 1])
def test_prefactor_and_rpt2_match_jax(ixy, dtype):
    ql, qr = _sides(10 + ixy, dtype)
    jl, jr, tl, tr = _both(ql, qr)
    asdq = np.random.default_rng(20 + ixy).standard_normal(
        ql.shape).astype(dtype)
    ja = tuple(jnp.asarray(c) for c in asdq)
    ta = tuple(torch.from_numpy(c) for c in asdq)
    eig_j = je._prefactor_euler_2d_soa(ixy, jl, jr, PARAMS)
    eig_t = te._prefactor_euler_2d_soa(ixy, tl, tr, PARAMS)
    for a, b in zip(eig_t, eig_j):
        _cmp(a, b, dtype)
    for imp in (1, 2):
        for kw_j, kw_t in (({}, {}), ({"eig": eig_j}, {"eig": eig_t})):
            bm_j, bp_j = je._rpt2_euler_soa(ixy, imp, jl, jr, ja, PARAMS,
                                            **kw_j)
            bm_t, bp_t = te._rpt2_euler_soa(ixy, imp, tl, tr, ta, PARAMS,
                                            **kw_t)
            for e in range(4):
                _cmp(bm_t[e], bm_j[e], dtype)
                _cmp(bp_t[e], bp_j[e], dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_alpha34_dtype_branch(dtype):
    rng = np.random.default_rng(3)
    a2 = (0.5 + rng.random(50)).astype(dtype)
    a = np.sqrt(a2)
    u, n3, n4 = (rng.standard_normal(50).astype(dtype) for _ in range(3))
    ref = je._alpha34(0.4, jnp.asarray(a), jnp.asarray(a2), jnp.asarray(u),
                      jnp.asarray(n3), jnp.asarray(n4))
    got = te._alpha34(0.4, torch.from_numpy(a), torch.from_numpy(a2),
                      torch.from_numpy(u), torch.from_numpy(n3),
                      torch.from_numpy(n4))
    for g, r in zip(got, ref):
        _cmp(g, r, dtype)


def test_5wave_record():
    rs = triemann.euler_5wave_2D
    assert (rs.num_dim, rs.num_eqn, rs.num_waves) == (2, 5, 5)
    assert rs.requires == ("gamma",) and rs.evec is None
    for r in (rs, triemann.euler_4wave_2D):
        assert r.rpt is te._rpt2_euler
        assert r.prefactor is te._prefactor_euler_2d
        assert r.rpt_soa is te._rpt2_euler_soa
    assert rs.rpn_soa is te._rpn2_euler_5wave_soa
    q = torch.tensor([[1.0, 1.0, -1.0], [0.0] * 3, [0.0] * 3,
                      [1.0, -1.0, 1.0], [-5.0, 0.0, 0.0]])
    assert rs.positivity(q, None, PARAMS).tolist() == [True, False, False]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("ixy", [0, 1])
@pytest.mark.parametrize("num_eqn", [4, 5])
def test_aos_rpn2_matches_jax(num_eqn, ixy, dtype):
    """_rpn2_euler (the classic generic step's normal solver) in AoS form:
    waves, speeds, amdq and apdq."""
    ql, qr = _sides(30 + num_eqn + ixy, dtype, num_eqn=num_eqn)
    name = "_rpn2_euler_5wave" if num_eqn == 5 else "_rpn2_euler_4wave"
    ref = getattr(je, name)(ixy, jnp.asarray(ql), jnp.asarray(qr), None,
                            None, PARAMS)
    got = getattr(te, name)(ixy, torch.from_numpy(ql), torch.from_numpy(qr),
                            None, None, PARAMS)
    assert got[0].shape == (num_eqn, num_eqn) + ql.shape[1:]
    s = np.asarray(ref[1])
    assert (s < 0).any() and (s > 0).any()
    for g, r in zip(got, ref):
        _cmp(g, r, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("ixy", [0, 1])
@pytest.mark.parametrize("num_eqn", [4, 5])
def test_aos_prefactor_and_rpt2_match_jax(num_eqn, ixy, dtype):
    """_prefactor_euler_2d and _rpt2_euler in AoS form, with and without
    eig, for imp 1 and 2; the tracer rides the transverse flow."""
    ql, qr = _sides(40 + num_eqn + ixy, dtype, num_eqn=num_eqn)
    asdq = np.random.default_rng(50 + ixy).standard_normal(
        ql.shape).astype(dtype)
    args_j = (jnp.asarray(ql), jnp.asarray(qr), None, None)
    args_t = (torch.from_numpy(ql), torch.from_numpy(qr), None, None)
    eig_j = je._prefactor_euler_2d(ixy, *args_j, PARAMS)
    eig_t = te._prefactor_euler_2d(ixy, *args_t, PARAMS)
    for a, b in zip(eig_t, eig_j):
        _cmp(a, b, dtype)
    for imp in (1, 2):
        for kw_j, kw_t in (({}, {}), ({"eig": eig_j}, {"eig": eig_t})):
            bm_j, bp_j = je._rpt2_euler(ixy, imp, *args_j, jnp.asarray(asdq),
                                        PARAMS, **kw_j)
            bm_t, bp_t = te._rpt2_euler(ixy, imp, *args_t,
                                        torch.from_numpy(asdq), PARAMS,
                                        **kw_t)
            _cmp(bm_t, bm_j, dtype)
            _cmp(bp_t, bp_j, dtype)
            if num_eqn == 5:
                _cmp(bm_t[4], bm_j[4], dtype)
                _cmp(bp_t[4], bp_j[4], dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("ixy", [0, 1])
def test_soa_tracer_rpn2_rpt2_and_flux_match_jax(ixy, dtype):
    """The 5-wave SoA hooks: the tracer's parts of the waves, its fifth
    wave, the rpt2 tracer lines and the flux u q[4]."""
    ql, qr = _sides(60 + ixy, dtype, num_eqn=5)
    jl, jr, tl, tr = _both(ql, qr)
    wj, sj = je._rpn2_euler_5wave_soa(ixy, jl, jr, PARAMS)
    wt, st = te._rpn2_euler_5wave_soa(ixy, tl, tr, PARAMS)
    assert len(wt) == len(st) == 5
    for p in range(5):
        _cmp(st[p], sj[p], dtype)
        for e in range(5):
            assert (wt[p][e] is None) == (wj[p][e] is None)
            if wj[p][e] is not None:
                _cmp(wt[p][e], wj[p][e], dtype)
    asdq = np.random.default_rng(70 + ixy).standard_normal(
        ql.shape).astype(dtype)
    ja = tuple(jnp.asarray(c) for c in asdq)
    ta = tuple(torch.from_numpy(c) for c in asdq)
    eig_j = je._prefactor_euler_2d_soa(ixy, jl, jr, PARAMS)
    eig_t = te._prefactor_euler_2d_soa(ixy, tl, tr, PARAMS)
    for imp in (1, 2):
        bm_j, bp_j = je._rpt2_euler_soa(ixy, imp, jl, jr, ja, PARAMS,
                                        eig=eig_j)
        bm_t, bp_t = te._rpt2_euler_soa(ixy, imp, tl, tr, ta, PARAMS,
                                        eig=eig_t)
        for e in range(5):
            _cmp(bm_t[e], bm_j[e], dtype)
            _cmp(bp_t[e], bp_j[e], dtype)
    fj = jriemann.euler_5wave_2D.flux_soa(ixy, jl, PARAMS)
    ft = triemann.euler_5wave_2D.flux_soa(ixy, tl, PARAMS)
    for a, b in zip(ft, fj):
        _cmp(a, b, dtype)
