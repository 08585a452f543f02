"""The port's 2D shallow-water Riemann solvers against the JAX package's.

``riemann/shallow.py`` of the port (``_rpn2_shallow_roe``,
``_rpn2_shallow_bathymetry_fwave``, ``_rpt2_shallow_roe``) against
``pyclaw_tpu/riemann/shallow.py`` on the same seeded wet states, in both
directions: float64 to 1e-13 of each output's scale, float32 to 1e-5.
The states include transonic rarefactions, so both branches of the
entropy fix on waves 1 and 3 run (the test counts them).  The augmented
solver with wetting and drying (``_rpn2_sw_aug``, ``_rpt2_sw_aug``) on
seeded wet/dry interfaces that take each of its branches: both wet, a
dry front on either side, a wall on either side, both dry, and damp
cells below the dry tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyclaw_tpu.riemann import shallow as js
from pyclaw_tpu_torch import riemann as triemann
from pyclaw_tpu_torch.riemann import shallow as ts

PARAMS = {"grav": 1.0}
N = (24, 20)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(seed):
    """Left/right wet states (3, *N) with velocities of either sign up to
    ~2.5 times the gravity-wave speed, and bathymetry (1, *N)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        h = 0.3 + rng.random(N)
        u, v = 1.2 * rng.standard_normal(N), 1.2 * rng.standard_normal(N)
        out.append(np.stack([h, h * u, h * v]))
    b = 0.4 * rng.random((2, 1) + N)
    return out[0], out[1], b[0], b[1]


def _max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _transonic(ql, qr, ixy):
    """Interfaces where the port's entropy fix takes its transonic branch
    on wave 1 or wave 3."""
    g = PARAMS["grav"]
    mu = 1 + ixy
    hl, hr = ql[0], qr[0]
    ul, ur = ql[mu] / hl, qr[mu] / hr
    sl, sr = np.sqrt(hl), np.sqrt(hr)
    u = (sl * ul + sr * ur) / (sl + sr)
    c = np.sqrt(g * 0.5 * (hl + hr))
    a1 = 0.5 * ((u + c) * (hr - hl) - (qr[mu] - ql[mu])) / c
    a3 = 0.5 * (-(u - c) * (hr - hl) + (qr[mu] - ql[mu])) / c
    hm, hm3 = hl + a1, hr - a3
    lam1_m = (ql[mu] + a1 * (u - c)) / hm - np.sqrt(g * np.maximum(hm, 0))
    lam3_m = (qr[mu] - a3 * (u + c)) / hm3 + np.sqrt(g * np.maximum(hm3,
                                                                   0))
    t1 = (ul - np.sqrt(g * hl) < 0) & (lam1_m > 0)
    t3 = (lam3_m < 0) & (ur + np.sqrt(g * hr) > 0)
    return int(t1.sum()), int(t3.sum())


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-13),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("ixy", [0, 1])
@pytest.mark.parametrize("solver", ["roe", "bathymetry_fwave"])
def test_rpn2_matches_jax(solver, ixy, dtype, tol):
    ql, qr, bl, br = (a.astype(dtype) for a in _pair(10 * ixy + 3))
    jfn = {"roe": js._rpn2_shallow_roe,
           "bathymetry_fwave": js._rpn2_shallow_bathymetry_fwave}[solver]
    tfn = {"roe": ts._rpn2_shallow_roe,
           "bathymetry_fwave": ts._rpn2_shallow_bathymetry_fwave}[solver]
    outs_j = jfn(ixy, jnp.asarray(ql), jnp.asarray(qr), jnp.asarray(bl),
                 jnp.asarray(br), PARAMS)
    outs_t = tfn(ixy, *(torch.from_numpy(a) for a in (ql, qr, bl, br)),
                 PARAMS)
    for name, oj, ot in zip(("wave", "s", "amdq", "apdq"), outs_j, outs_t):
        assert tuple(ot.shape) == tuple(oj.shape), name
        assert ot.dtype == torch.from_numpy(ql).dtype, name
        assert _max_rel(ot.numpy(), oj) <= tol, name
    if solver == "roe" and dtype == np.float64:
        t1, t3 = _transonic(ql, qr, ixy)
        assert t1 > 0 and t3 > 0, (t1, t3)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-13),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("ixy,imp", [(0, 1), (0, 2), (1, 1), (1, 2)])
def test_rpt2_matches_jax(ixy, imp, dtype, tol):
    ql, qr, _, _ = (a.astype(dtype) for a in _pair(7 + ixy))
    asdq = np.random.default_rng(5 + imp).standard_normal(ql.shape)
    asdq = asdq.astype(dtype)
    bm_j, bp_j = js._rpt2_shallow_roe(ixy, imp, jnp.asarray(ql),
                                      jnp.asarray(qr), None, None,
                                      jnp.asarray(asdq), PARAMS)
    bm_t, bp_t = ts._rpt2_shallow_roe(ixy, imp, torch.from_numpy(ql),
                                      torch.from_numpy(qr), None, None,
                                      torch.from_numpy(asdq), PARAMS)
    assert _max_rel(bm_t.numpy(), bm_j) <= tol
    assert _max_rel(bp_t.numpy(), bp_j) <= tol


def test_lake_at_rest_has_no_fluctuations():
    """h + b constant, u = v = 0: the bathymetry f-wave solver gives zero
    fluctuations (to roundoff), in both directions."""
    rng = np.random.default_rng(2)
    b = 0.5 * rng.random((1,) + N)
    q = np.stack([1.0 - b[0], np.zeros(N), np.zeros(N)])
    for ixy in (0, 1):
        sl = [slice(None)] * 3
        sr = [slice(None)] * 3
        sl[1 + ixy], sr[1 + ixy] = slice(0, -1), slice(1, None)
        args = [torch.from_numpy(np.ascontiguousarray(a[tuple(s)]))
                for a, s in ((q, sl), (q, sr), (b, sl), (b, sr))]
        _, _, amdq, apdq = ts._rpn2_shallow_bathymetry_fwave(
            ixy, *args, {"grav": 9.8})
        assert float(amdq.abs().max()) < 1e-14
        assert float(apdq.abs().max()) < 1e-14


def test_registry_and_records():
    for name in ("shallow_roe_with_efix_2D", "shallow_bathymetry_fwave_2D"):
        rp = triemann.ALL[name]
        assert (rp.num_dim, rp.num_eqn, rp.num_waves) == (2, 3, 3)
        assert rp.requires == ("grav",)
        assert rp.rpt is ts._rpt2_shallow_roe
        assert rp.rpn_soa is None and rp.prefactor is None
        q = torch.tensor([[1.0, 0.0, -1.0]])
        assert rp.positivity(q, None, PARAMS).tolist() == [True, False,
                                                           False]


SW_AUG = {"grav": 9.8, "dry_tolerance": 1e-3}
# (h_l, h_r, b_l, b_r) of each branch of _sw_aug_core: both wet, the dry
# fronts (the Ritter speed), the walls (a dry cell whose bottom lies above
# the wet neighbour's surface), both dry, a damp cell against a wet one
BRANCHES = {"wet": (0.8, 0.5, 0.1, 0.2), "front_l": (0.0, 0.6, 0.0, 0.1),
            "front_r": (0.6, 0.0, 0.1, 0.0), "wall_l": (0.0, 0.3, 1.0, 0.1),
            "wall_r": (0.3, 0.0, 0.1, 1.0), "dry": (0.0, 0.0, 0.2, 0.3),
            "damp": (5e-4, 0.5, 0.2, 0.1)}


def _wet_dry_pair(seed, ixy):
    """Left/right states (3, *N) and bottoms (1, *N): each interface one
    of BRANCHES, its depths and bottoms perturbed (a dry depth stays 0),
    velocities of either sign."""
    rng = np.random.default_rng(seed)
    table = np.array(list(BRANCHES.values()))
    kind = rng.integers(0, len(table), N)
    h_l, h_r, b_l, b_r = (table[kind, k] for k in range(4))
    jitter = 1.0 + 0.2 * rng.random((4,) + N)
    h_l, h_r = h_l * jitter[0], h_r * jitter[1]
    b_l, b_r = b_l * jitter[2], b_r * jitter[3]
    mu, mv = 1 + ixy, 2 - ixy
    ql, qr = np.zeros((3,) + N), np.zeros((3,) + N)
    ql[0], qr[0] = h_l, h_r
    for q in (ql, qr):
        q[mu] = q[0] * 2.0 * rng.standard_normal(N)
        q[mv] = q[0] * rng.standard_normal(N)
    return ql, qr, b_l[None], b_r[None], kind


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-13),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("ixy", [0, 1])
def test_sw_aug_2d_matches_jax(ixy, dtype, tol):
    """_rpn2_sw_aug's waves, speeds and fluctuations and _rpt2_sw_aug's
    split (imp 1 and 2) on interfaces of every branch."""
    ql, qr, bl, br, kind = _wet_dry_pair(80 + ixy, ixy)
    assert set(kind.ravel()) == set(range(len(BRANCHES)))
    arrays = [a.astype(dtype) for a in (ql, qr, bl, br)]
    ref = js._rpn2_sw_aug(ixy, *(jnp.asarray(a) for a in arrays), SW_AUG)
    got = ts._rpn2_sw_aug(ixy, *(torch.from_numpy(a) for a in arrays),
                          SW_AUG)
    for g, r in zip(got, ref):
        assert g.dtype == torch.from_numpy(arrays[0]).dtype
        assert _max_rel(g.numpy(), r) <= tol
    # the walls take no fluctuation, the fronts no f-wave
    wall_l = kind == list(BRANCHES).index("wall_l")
    assert float(got[2][:, wall_l].abs().max()) == 0.0
    front = kind == list(BRANCHES).index("front_l")
    assert float(got[0][:, :, front].abs().max()) == 0.0
    asdq = np.random.default_rng(90 + ixy).standard_normal(
        ql.shape).astype(dtype)
    for imp in (1, 2):
        bm_j, bp_j = js._rpt2_sw_aug(ixy, imp,
                                     *(jnp.asarray(a) for a in arrays),
                                     jnp.asarray(asdq), SW_AUG)
        bm_t, bp_t = ts._rpt2_sw_aug(ixy, imp,
                                     *(torch.from_numpy(a) for a in arrays),
                                     torch.from_numpy(asdq), SW_AUG)
        assert _max_rel(bm_t.numpy(), bm_j) <= tol
        assert _max_rel(bp_t.numpy(), bp_j) <= tol
        # no split where either cell is dry
        assert float(bm_t[:, kind != 0].abs().max()) == 0.0


def test_sw_aug_2d_record():
    rp = triemann.ALL["sw_aug_2D"]
    assert (rp.num_dim, rp.num_eqn, rp.num_waves) == (2, 3, 3)
    assert rp.requires == ("grav",)
    assert rp.rp is ts._rpn2_sw_aug and rp.rpt is ts._rpt2_sw_aug
    assert rp.rpn_soa is None and rp.prefactor is None and rp.flux is None
    q = torch.tensor([[1.0, 1e-9, 0.0]])
    assert rp.positivity(q, None, {"grav": 1.0}).tolist() == [True, False,
                                                              False]
