"""The port's 3D linear Riemann solvers against the JAX package's, on
seeded inputs: the normal solve, the transverse split and (where the
system has one) the double-transverse split of ``advection_3D``,
``acoustics_3D`` and ``vc_acoustics_3D``, for every sweep direction,
every transverse axis and both fluctuations, with a non-uniform aux
(impedance and sound speed in 1 +- 0.3).  float64 to 1e-14 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyclaw_tpu import riemann as jriemann
from pyclaw_tpu_torch import riemann as triemann

PARAMS = {"u": 0.7, "v": -0.4, "w": 0.3, "rho": 1.7, "bulk": 2.3}
NAMES = ("advection_3D", "acoustics_3D", "vc_acoustics_3D")
TRIPLES = [(d, e, imp) for d in range(3) for e in range(3) if e != d
           for imp in (1, 2)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed, num_eqn, n=(6, 5, 7)):
    rng = np.random.default_rng(seed)
    q_l, q_r, asdq = (rng.standard_normal((num_eqn,) + n) for _ in range(3))
    aux_l, aux_r = (1.0 + 0.3 * (2.0 * rng.random((2,) + n) - 1.0)
                    for _ in range(2))
    return q_l, q_r, aux_l, aux_r, asdq


def _both(arrays):
    return ([torch.from_numpy(a) for a in arrays],
            [jnp.asarray(a) for a in arrays])


def _close(got, ref):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-14 * max(np.abs(ref).max(), 1.0)


def test_registry_records():
    for name, (dim, neq, nw, has_rptt) in {
            "advection_3D": (3, 1, 1, True), "acoustics_3D": (3, 4, 2, True),
            "vc_acoustics_3D": (3, 4, 2, False)}.items():
        t, j = triemann.ALL[name], getattr(jriemann, name)
        assert (t.num_dim, t.num_eqn, t.num_waves) == (dim, neq, nw)
        assert (j.num_dim, j.num_eqn, j.num_waves) == (dim, neq, nw)
        assert (t.rptt is not None) == has_rptt == (j.rptt is not None)
        assert t.requires == j.requires


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("ixy", [0, 1, 2])
def test_normal_solve_matches_jax(name, ixy):
    t_rs, j_rs = triemann.ALL[name], getattr(jriemann, name)
    arrs = _inputs(10 * ixy + len(name), t_rs.num_eqn)
    (ql, qr, al, ar, _), (jql, jqr, jal, jar, _) = _both(arrs)
    got = t_rs.rp(ixy, ql, qr, al, ar, PARAMS)
    ref = j_rs.rp(ixy, jql, jqr, jal, jar, PARAMS)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("d,e,imp", TRIPLES)
def test_transverse_splits_match_jax(name, d, e, imp):
    """rpt along e, and (advection, acoustics) rptt along the third axis,
    of a seeded fluctuation at the d-interfaces."""
    t_rs, j_rs = triemann.ALL[name], getattr(jriemann, name)
    arrs = _inputs(100 * d + 10 * e + imp, t_rs.num_eqn)
    (ql, qr, al, ar, asdq), (jql, jqr, jal, jar, jasdq) = _both(arrs)
    got = t_rs.rpt(d, imp, ql, qr, al, ar, asdq, PARAMS, trans_axis=e)
    ref = j_rs.rpt(d, imp, jql, jqr, jal, jar, jasdq, PARAMS, trans_axis=e)
    for g, r in zip(got, ref):
        _close(g, r)
    if t_rs.rptt is None:
        return
    f = 3 - d - e
    for b_part, jb_part, e_dir in ((got[0], ref[0], -1), (got[1], ref[1], 1)):
        g2 = t_rs.rptt(d, 2 + (f > e), imp, e_dir, ql, qr, al, ar, b_part,
                       PARAMS, trans_axis=f)
        r2 = j_rs.rptt(d, 2 + (f > e), imp, e_dir, jql, jqr, jal, jar,
                       jb_part, PARAMS, trans_axis=f)
        for g, r in zip(g2, r2):
            _close(g, r)


def test_heterogeneous_split_reads_the_transverse_neighbours():
    """The vc split of a fluctuation entering cell j along e depends on the
    impedance of cells j-1 (down-going part) and j+1 (up-going part)."""
    rs = triemann.vc_acoustics_3D
    ql, qr, al, ar, asdq = (torch.from_numpy(a)
                            for a in _inputs(7, 4, n=(3, 6, 4)))
    bm0, bp0 = rs.rpt(0, 2, ql, qr, al, ar, asdq, {}, trans_axis=1)
    ar2 = ar.clone()
    ar2[0, :, 3] *= 2.0
    bm1, bp1 = rs.rpt(0, 2, ql, qr, al, ar2, asdq, {}, trans_axis=1)
    changed_m = (bm1 != bm0).any(dim=0).any(dim=0).any(dim=-1)
    changed_p = (bp1 != bp0).any(dim=0).any(dim=0).any(dim=-1)
    assert changed_m.tolist() == [False, False, False, True, True, False]
    assert changed_p.tolist() == [False, False, True, True, False, False]
