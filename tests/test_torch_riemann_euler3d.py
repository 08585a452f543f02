"""The port's 3D Euler Roe solver (AoS hooks) and AoS limiter factors
against the JAX package's, on seeded admissible states: ``_roe_averages``
in both component orders, ``_rpn3_euler`` in each direction,
``_prefactor_euler_3d``, and ``_rpt3_euler`` / ``_rptt3_euler`` for every
(d, e) pair with and without the shared eigensystem.  float64 to 1e-13
relative, float32 to 1e-5.  ``tvd.limiter_phi`` on each negative axis,
ids 1-6, 10 and 16, to 1e-15 in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyclaw_tpu.limiters import tvd as jtvd
from pyclaw_tpu.riemann import euler as je
from pyclaw_tpu_torch import riemann as triemann
from pyclaw_tpu_torch.limiters import tvd as ttvd
from pyclaw_tpu_torch.riemann import euler as te

PARAMS = {"gamma": 1.4}
TOL = {np.float64: 1e-13, np.float32: 1e-5}
PAIRS = [(d, e) for d in range(3) for e in range(3) if e != d]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _sides(seed, dtype, n=(7, 6, 5)):
    rng = np.random.default_rng(seed)

    def side():
        rho = 0.5 + rng.random(n)
        u, v, w = (rng.standard_normal(n) for _ in range(3))
        p = 0.5 + rng.random(n)
        return np.stack([rho, rho * u, rho * v, rho * w,
                         p / 0.4 + 0.5 * rho * (u * u + v * v + w * w)]
                        ).astype(dtype)
    return side(), side()


def _cmp(got, ref, dtype):
    ref = np.asarray(ref, dtype=np.float64)
    got = got.numpy().astype(np.float64)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(got - ref).max() / scale <= TOL[dtype]


def test_registry():
    rs = triemann.euler_3D
    assert (rs.num_dim, rs.num_eqn, rs.num_waves) == (3, 5, 5)
    assert rs.requires == ("gamma",)
    assert rs.transverse_batchable
    assert triemann.ALL["euler_3D"] is rs
    for hook in ("rp", "rpt", "rptt", "prefactor", "positivity"):
        assert getattr(rs, hook) is not None


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("vel_idx", [(1, 2, 3), (2, 3, 1), (3, 1, 2)])
def test_roe_averages_match_jax(vel_idx, dtype):
    ql, qr = _sides(sum(vel_idx) + vel_idx[0], dtype)
    vj, Hj, aj, a2j, pj = je._roe_averages(jnp.asarray(ql), jnp.asarray(qr),
                                           1.4, vel_idx)
    vt, Ht, at, a2t, pt = te._roe_averages(torch.from_numpy(ql),
                                           torch.from_numpy(qr), 1.4, vel_idx)
    for g, r in zip([*vt, Ht, at, a2t, *pt], [*vj, Hj, aj, a2j, *pj]):
        _cmp(g, r, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("ixy", [0, 1, 2])
def test_rpn3_matches_jax(ixy, dtype):
    ql, qr = _sides(30 + ixy, dtype)
    out_j = je._rpn3_euler(ixy, jnp.asarray(ql), jnp.asarray(qr), None,
                           None, PARAMS)
    out_t = te._rpn3_euler(ixy, torch.from_numpy(ql), torch.from_numpy(qr),
                           None, None, PARAMS)
    assert out_t[0].shape == (5, 5) + ql.shape[1:]
    for g, r in zip(out_t, out_j):
        assert g.dtype == torch.from_numpy(ql).dtype
        _cmp(g, r, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("d,e", PAIRS)
def test_prefactor_rpt3_rptt3_match_jax(d, e, dtype):
    ql, qr = _sides(40 + 3 * d + e, dtype)
    jl, jr = jnp.asarray(ql), jnp.asarray(qr)
    tl, tr = torch.from_numpy(ql), torch.from_numpy(qr)
    asdq = np.random.default_rng(50 + 3 * d + e).standard_normal(
        ql.shape).astype(dtype)
    eig_j = je._prefactor_euler_3d(d, jl, jr, None, None, PARAMS)
    eig_t = te._prefactor_euler_3d(d, tl, tr, None, None, PARAMS)
    (uj, Hj, aj, a2j, kej), (ut, Ht, at, a2t, ket) = eig_j, eig_t
    for g, r in zip([*ut, Ht, at, a2t, ket], [*uj, Hj, aj, a2j, kej]):
        _cmp(g, r, dtype)
    f = 3 - d - e
    for kw_j, kw_t in (({}, {}), ({"eig": eig_j}, {"eig": eig_t})):
        for imp in (1, 2):
            bj = je._rpt3_euler(d, imp, jl, jr, None, None,
                                jnp.asarray(asdq), PARAMS, trans_axis=e,
                                **kw_j)
            bt = te._rpt3_euler(d, imp, tl, tr, None, None,
                                torch.from_numpy(asdq), PARAMS,
                                trans_axis=e, **kw_t)
            for g, r in zip(bt, bj):
                _cmp(g, r, dtype)
            for k in range(2):      # the rptt3 split of bm and of bp
                cj = je._rptt3_euler(d, 2 + (f > e), imp, 2 * k - 1, jl, jr,
                                     None, None, bj[k], PARAMS,
                                     trans_axis=f, **kw_j)
                ct = te._rptt3_euler(d, 2 + (f > e), imp, 2 * k - 1, tl, tr,
                                     None, None, bt[k], PARAMS,
                                     trans_axis=f, **kw_t)
                for g, r in zip(ct, cj):
                    _cmp(g, r, dtype)


def test_positivity_matches_jax():
    ql, _ = _sides(60, np.float64)
    ql[0, 0, 0, 0] = -0.1                   # a negative density
    ql[4, 1, 1, 1] = 0.0                    # a negative pressure
    got = te.euler_3D.positivity(torch.from_numpy(ql), None, PARAMS)
    from pyclaw_tpu import riemann as jriemann
    ref = jriemann.euler_3D.positivity(jnp.asarray(ql), None, PARAMS)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert not got[0, 0, 0] and not got[1, 1, 1]


@pytest.mark.parametrize("lid", [1, 2, 3, 4, 5, 6, 10, 16])
@pytest.mark.parametrize("axis", [-1, -2, -3])
def test_limiter_phi_matches_jax(axis, lid):
    rng = np.random.default_rng(70 + lid - 10 * axis)
    n = (9, 8, 7)
    wave = rng.standard_normal((5, 5) + n)
    wave[:, 2, 3] = 0.0                     # a vanishing wave: phi = 1
    s = rng.standard_normal((5,) + n)
    ids = (lid, lid, 0, lid, lid)
    ref = jtvd.limiter_phi(5, jnp.asarray(wave), jnp.asarray(s), ids,
                           dtdx=0.3, axis=axis)
    got = ttvd.limiter_phi(5, torch.from_numpy(wave), torch.from_numpy(s),
                           ids, dtdx=0.3, axis=axis)
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (5,) + n
    assert np.abs(got.numpy() - ref).max() <= 1e-15 * np.abs(ref).max()
    assert np.all(got.numpy()[2] == 1.0)


def test_limiter_phi_needs_negative_axis_and_dtdx():
    wave = torch.zeros((5, 5, 4))
    s = torch.zeros((5, 4))
    with pytest.raises(ValueError, match="negative"):
        ttvd.limiter_phi(5, wave, s, (4,) * 5, axis=1)
    with pytest.raises(ValueError, match="dtdx"):
        ttvd.limiter_phi(5, wave, s, (10,) * 5)
