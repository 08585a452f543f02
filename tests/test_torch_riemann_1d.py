"""The port's 1D Riemann records against the JAX package's: advection_1D,
acoustics_1D, euler_with_efix_1D, euler_roe_1D and euler_hlle_1D.

The normal solve (waves, speeds, amdq, apdq), the ``flux`` hook and the
``positivity`` hook on seeded random interface states, float64 to 1e-13
and float32 to 1e-5 of the largest magnitude.  The Euler states are a
random set plus its mirror image (left and right swapped, momentum
negated), so where the 1-wave's transonic test of the entropy fix fires
in one half, the 3-wave's fires in the other; both are counted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyclaw_tpu import riemann as jriemann
from pyclaw_tpu_torch import riemann as triemann

NAMES = ["advection_1D", "acoustics_1D", "euler_with_efix_1D",
         "euler_roe_1D", "euler_hlle_1D"]
PARAMS = {"u": -0.7, "rho": 1.3, "bulk": 2.0, "gamma": 1.4}
TOL = {np.float64: 1e-13, np.float32: 1e-5}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _euler(rng, n, pockets=0.0):
    rho = 0.3 + rng.random(n)
    u = 1.5 * rng.standard_normal(n)
    p = 0.2 + rng.random(n)
    if pockets:
        # states of negative pressure or density for the positivity hook
        bad = rng.random(n) < pockets
        p = np.where(bad, -0.1, p)
        rho = np.where(rng.random(n) < pockets, -0.2, rho)
    return np.stack([rho, rho * u, p / 0.4 + 0.5 * rho * u * u])


def _pair(name, n, seed):
    """Interface states (q_l, q_r), each (num_eqn, n)."""
    rng = np.random.default_rng(seed)
    if name.startswith("euler"):
        ql, qr = _euler(rng, n), _euler(rng, n)
        mirror = np.array([1.0, -1.0, 1.0])[:, None]
        return (np.concatenate([ql, qr[:, ::-1] * mirror], axis=1),
                np.concatenate([qr, ql[:, ::-1] * mirror], axis=1))
    m = 2 if name == "acoustics_1D" else 1
    return rng.standard_normal((m, n)), rng.standard_normal((m, n))


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", NAMES)
def test_rp_matches_jax(name, dtype):
    ql, qr = (a.astype(dtype) for a in _pair(name, 300, NAMES.index(name)))
    out_t = triemann.ALL[name].rp(0, torch.from_numpy(ql),
                                  torch.from_numpy(qr), None, None, PARAMS)
    out_j = jriemann.ALL[name].rp(0, jnp.asarray(ql), jnp.asarray(qr), None,
                                  None, PARAMS)
    for t, j in zip(out_t, out_j):
        _close(t.numpy(), j, TOL[dtype])


def test_acoustics_takes_zz_cc_or_rho_bulk():
    ql, qr = _pair("acoustics_1D", 50, 3)
    rp = triemann.acoustics_1D.rp
    zc = {"zz": float(np.sqrt(1.3 * 2.0)), "cc": float(np.sqrt(2.0 / 1.3))}
    a = rp(0, torch.from_numpy(ql), torch.from_numpy(qr), None, None, zc)
    b = rp(0, torch.from_numpy(ql), torch.from_numpy(qr), None, None, PARAMS)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_entropy_fix_takes_both_transonic_branches():
    """Where the entropy fix splits a transonic wave, amdq differs from the
    plain Roe solver's; the mirrored half puts the 3-wave cases where the
    1-wave ones were."""
    n = 300
    ql, qr = (torch.from_numpy(a) for a in _pair("euler_with_efix_1D", n, 2))
    _, _, am_fix, _ = triemann.euler_with_efix_1D.rp(0, ql, qr, None, None,
                                                     PARAMS)
    _, _, am_roe, _ = triemann.euler_roe_1D.rp(0, ql, qr, None, None, PARAMS)
    moved = (am_fix != am_roe).any(dim=0).numpy()
    first, mirrored = moved[:n], moved[n:]
    assert 0 < first.sum() < n and 0 < mirrored.sum() < n
    # a 1-wave case maps to a 3-wave case of the mirror, and back
    assert np.array_equal(first, mirrored[::-1])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", ["advection_1D", "acoustics_1D",
                                  "euler_with_efix_1D", "euler_hlle_1D"])
def test_flux_matches_jax(name, dtype):
    q = _pair(name, 200, 11)[0].astype(dtype)
    f_t = triemann.ALL[name].flux(0, torch.from_numpy(q), None, PARAMS)
    f_j = jriemann.ALL[name].flux(0, jnp.asarray(q), None, PARAMS)
    _close(f_t.numpy(), f_j, TOL[dtype])


@pytest.mark.parametrize("name", ["euler_with_efix_1D", "euler_roe_1D",
                                  "euler_hlle_1D"])
def test_positivity_matches_jax(name):
    q = _euler(np.random.default_rng(5), 400, pockets=0.2)
    ok_t = triemann.ALL[name].positivity(torch.from_numpy(q), None, PARAMS)
    ok_j = jriemann.ALL[name].positivity(jnp.asarray(q), None, PARAMS)
    assert np.array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert 0 < ok_t.sum() < q.shape[1]


def test_records_match_jax():
    for name in NAMES:
        t, j = triemann.ALL[name], jriemann.ALL[name]
        assert (t.num_dim, t.num_eqn, t.num_waves, t.requires) == (
            j.num_dim, j.num_eqn, j.num_waves, j.requires)
        assert (t.flux is None) == (j.flux is None)
        assert (t.positivity is None) == (j.positivity is None)
