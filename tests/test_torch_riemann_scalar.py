"""The port's scalar and variable-coefficient 2D/3D Riemann records
(``advection_2D``, ``vc_advection_2D``, ``vc_advection_fwave_2D``,
``vc_acoustics_2D``, ``kpp_2D``, ``burgers_2D``, ``burgers_3D``) against
the JAX package's, and their plain CTU steps against its steps and
Pallas kernels (CPU, float64).

* each record's fields (num_eqn, num_waves, rpt / rptt / flux / evec /
  requires) equal the JAX record's;
* each hook (rp, rpt both ways, rptt, flux, evec) on seeded inputs,
  against the jitted JAX function, to 1e-12 relative; the
  variable-coefficient splits get aux that varies along the transverse
  axis (every row differs), and Burgers states of either sign with
  transonic interfaces, with and without the entropy fix;
* ``classic/kernels.py:step2`` / ``step3`` of the port (the plain versions
  of ``csrc/step2_aos.cu``'s and ``csrc/step3_aos.cu``'s new instances)
  against ``pyclaw_tpu/classic/kernels.py:step2`` / ``step3`` over
  transverse_waves 0/1/2, order 1/2, two limiters, and f-waves and a
  capacity row where the record takes them: 1e-12 relative, the CFL to
  1e-12;
* one case each against the JAX package's Pallas kernels in interpret
  mode, as tests/test_pallas_backend.py runs them:
  ``step2_pallas_rows`` with the generic body on ``vc_acoustics_2D`` (the
  neighbour-aux split inside the roll form) and ``step3_pallas_xy``'s
  ``kernel_aux`` on ``burgers_3D`` (with a capacity row).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyclaw_tpu import riemann as jriemann
from pyclaw_tpu.classic import kernels as jk
from pyclaw_tpu_torch import riemann as triemann
from pyclaw_tpu_torch.classic import kernels as tk

PARAMS = {"u": 0.7, "v": -0.4, "w": 0.3}
NEW_2D = ("advection_2D", "vc_advection_2D", "vc_advection_fwave_2D",
          "vc_acoustics_2D", "kpp_2D", "burgers_2D")
NEW = NEW_2D + ("burgers_3D",)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, ref, tol=1e-12):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1.0)


def _state(rng, name, n):
    """Seeded cell states (num_eqn, *n) and aux (3, *n) for record
    ``name``: both signs (Burgers: transonic interfaces), kpp's states
    around its initial 14 pi / 4 and pi / 4; aux rows of either sign for
    the advection velocities, positive (Z, c) for acoustics, and a
    capacity row last.  Every row of aux differs along every axis."""
    neq = triemann.ALL[name].num_eqn
    if name == "kpp_2D":
        q = np.where(rng.random((1,) + n) < 0.5, 14.0 * np.pi / 4.0,
                     np.pi / 4.0) + 0.3 * rng.standard_normal((1,) + n)
    else:
        q = rng.standard_normal((neq,) + n)
    if name == "vc_acoustics_2D":
        aux = np.stack([1.0 + 0.5 * rng.random(n), 1.0 + 0.5 * rng.random(n),
                        0.7 + 0.6 * rng.random(n)])
    else:
        aux = np.stack([rng.standard_normal(n), rng.standard_normal(n),
                        0.7 + 0.6 * rng.random(n)])
    return q, aux


def test_records_match_jax():
    for name in NEW:
        t, j = triemann.ALL[name], jriemann.ALL[name]
        assert (t.num_dim, t.num_eqn, t.num_waves) == (j.num_dim, j.num_eqn,
                                                        j.num_waves)
        for hook in ("rpt", "rptt", "flux", "evec", "rpn_soa", "prefactor"):
            assert ((getattr(t, hook) is None)
                    == (getattr(j, hook) is None)), (name, hook)
        assert t.requires == j.requires
    # 23 after this slice, 25 with psystem_2D and shallow_sphere_fwave_2D,
    # all 35 with the 1D library (tests/test_torch_riemann_1d_library.py)
    assert len(triemann.ALL) == 35
    assert set(triemann.ALL) <= set(jriemann.ALL)


def _params(name, efix=True):
    return dict(PARAMS, efix=efix) if name.startswith("burgers") else PARAMS


def _hook_calls(pkg_rs, dim, params, ql, qr, al, ar, asdq):
    """Every hook output of record ``pkg_rs`` (either package's) on one
    set of inputs, in a fixed order: rp along each axis; rpt of both
    fluctuations (imp 1, 2) along each transverse axis and, in 3D, rptt
    of both parts along the third; flux; evec."""
    out = []
    for ixy in range(dim):
        out += list(pkg_rs.rp(ixy, ql, qr, al, ar, params))
        for e in range(dim):
            if e == ixy:
                continue
            kw = {} if pkg_rs.name == "kpp_2D" else {"trans_axis": e}
            for imp in (1, 2):
                parts = pkg_rs.rpt(ixy, imp, ql, qr, al, ar, asdq, params,
                                   **kw)
                out += list(parts)
                if pkg_rs.rptt is None:
                    continue
                f = 3 - ixy - e
                for part, e_dir in zip(parts, (-1, 1)):
                    out += list(pkg_rs.rptt(ixy, 2 + (f > e), imp, e_dir,
                                            ql, qr, al, ar, part, params,
                                            trans_axis=f))
        if pkg_rs.flux is not None:
            out.append(pkg_rs.flux(ixy, ql, al, params))
        if pkg_rs.evec is not None:
            out += list(pkg_rs.evec(ixy, ql, al, params))
    return out


@pytest.mark.parametrize("name,efix", [(name, True) for name in NEW]
                         + [("burgers_2D", False), ("burgers_3D", False)])
def test_hooks_match_jax(name, efix):
    """Every hook of the record (:func:`_hook_calls`) against the JAX
    record's, jitted as one function."""
    t, j = triemann.ALL[name], jriemann.ALL[name]
    params = _params(name, efix)
    dim = t.num_dim
    n = (7, 6, 5)[:dim]
    rng = np.random.default_rng(len(name) + 7 * efix)
    (ql, al), (qr, ar) = _state(rng, name, n), _state(rng, name, n)
    asdq = rng.standard_normal(ql.shape)
    arrays = (ql, qr, al, ar, asdq)
    got = _hook_calls(t, dim, params, *(torch.from_numpy(a) for a in arrays))
    ref = jax.jit(lambda *a: _hook_calls(j, dim, params, *a))(
        *(jnp.asarray(a) for a in arrays))
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        _close(g, r)


def test_vc_splits_read_the_transverse_neighbours():
    """The variable-coefficient split of a fluctuation entering cell k
    along y depends on the aux of cell k (down-going part of vc
    advection; both parts of vc acoustics) and of its neighbours k+1 (the
    up-going parts) and k-1 (vc acoustics' down-going part)."""
    rng = np.random.default_rng(3)
    for name, rows, m_rows, p_rows in (
            ("vc_advection_2D", (1,), [3], [2]),
            ("vc_acoustics_2D", (0, 1), [3, 4], [2, 3])):
        rs = triemann.ALL[name]
        q, aux = _state(rng, name, (4, 6))
        ql, qr, al, ar = (torch.from_numpy(a) for a in (q, q, aux, aux))
        asdq = torch.from_numpy(rng.standard_normal(q.shape))
        bm0, bp0 = rs.rpt(0, 2, ql, qr, al, ar, asdq, {})
        ar2 = ar.clone()
        for r in rows:
            ar2[r, :, 3] *= 2.0
        bm1, bp1 = rs.rpt(0, 2, ql, qr, al, ar2, asdq, {})
        changed_m = (bm1 != bm0).any(dim=0).any(dim=0)
        changed_p = (bp1 != bp0).any(dim=0).any(dim=0)
        assert torch.nonzero(changed_m).flatten().tolist() == m_rows
        assert torch.nonzero(changed_p).flatten().tolist() == p_rows


# ---- the plain steps against the JAX package's ----------------------------
# (transverse_waves, order, limiter, fwave, index_capa): every
# transverse_waves and order, MC, minmod and the CFL-dependent id 10, the
# f-wave form (vc_advection_fwave_2D always), a capacity row (aux[2])
OPTS = [(2, 2, 4, False, -1), (1, 2, 1, False, 2), (0, 1, 4, False, -1),
        (2, 2, 10, True, 2)]
STEP2_CASES = [(name,) + o for name in NEW_2D for o in OPTS]


def _jax_step2(name, q, aux, args, params, lims, order, fwave, capa, tw):
    rp = jriemann.ALL[name]
    fn = jax.jit(lambda qj, aj: jk.step2(
        qj, aj, *args, rp.rp, rp.rpt, params, lims, order, fwave, capa, 2,
        transverse_waves=tw))
    qn, cfl = fn(jnp.asarray(q), jnp.asarray(aux))
    return np.asarray(qn), float(cfl)


def _plain2(name, q, aux, args, params, lims, order, fwave, capa, tw):
    rp = triemann.ALL[name]
    qn, cfl = tk.step2(torch.from_numpy(q), torch.from_numpy(aux), *args,
                       rp.rp, rp.rpt, params, lims, order, fwave, capa, 2,
                       tw)
    return qn.numpy(), float(cfl)


@pytest.mark.parametrize("name,tw,order,lim,fwave,capa", STEP2_CASES)
def test_plain_step_matches_jax_step2(name, tw, order, lim, fwave, capa):
    nx, ny = 14, 11
    rng = np.random.default_rng(100 * tw + 10 * order + lim)
    q, aux = _state(rng, name, (nx + 4, ny + 4))
    fwave = fwave or name == "vc_advection_fwave_2D"
    lims = (lim,) * triemann.ALL[name].num_waves
    args = ((0.02, 1.0 / nx, 1.0 / ny), _params(name), lims, order, fwave,
            capa, tw)
    q_t, c_t = _plain2(name, q, aux, *args)
    q_j, c_j = _jax_step2(name, q, aux, *args)
    _close(q_t, q_j)
    assert abs(c_t - c_j) <= 1e-12 * c_j


@pytest.mark.parametrize("tw,order,lim,fwave,capa,efix",
                         [o + (i != 1,) for i, o in enumerate(OPTS)])
def test_plain_step_matches_jax_step3_burgers(tw, order, lim, fwave, capa,
                                             efix):
    rng = np.random.default_rng(10 * tw + order + lim)
    q, aux = _state(rng, "burgers_3D", (11, 10, 9))
    params = _params("burgers_3D", efix)
    args = (0.01, 1 / 7, 1 / 6, 1 / 5)
    j = jriemann.burgers_3D
    fn = jax.jit(lambda qj, aj: jk.step3(
        qj, aj, *args, j.rp, j.rpt, j.rptt, params, (lim,), order, fwave,
        capa, 2, transverse_waves=tw))
    q_j, c_j = fn(jnp.asarray(q), jnp.asarray(aux))
    t = triemann.burgers_3D
    q_t, c_t = tk.step3(torch.from_numpy(q), torch.from_numpy(aux), *args,
                        t.rp, t.rpt, t.rptt, params, (lim,), order, fwave,
                        capa, 2, tw)
    _close(q_t, q_j)
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)


# ---- the JAX package's Pallas kernels, interpret mode ---------------------
def test_matches_step2_pallas_rows_vc_acoustics():
    """step2_pallas_rows with the generic-AoS roll body (rpn_soa=None) on
    vc_acoustics_2D: the split reads the impedance and sound speed of the
    receiving cell's transverse neighbours by a roll inside a row tile;
    two row tiles of 8, an impedance jump across the tiles' seam."""
    from pyclaw_tpu.ops import tiled2d as jtiled
    nx, ny = 16, 128
    rng = np.random.default_rng(5)
    q, aux = _state(rng, "vc_acoustics_2D", (nx + 4, ny + 4))
    aux = aux[:2].copy()
    aux[0, 10:] *= 3.0          # the seam of the row tiles: padded row 10
    rp = jriemann.vc_acoustics_2D
    args = (2e-3, 1.0 / nx, 1.0 / ny)
    q_j, c_j = jtiled.step2_pallas_rows(
        jnp.asarray(q), jnp.asarray(aux), *args, rp.rp, rp.rpt, {},
        (4,) * 2, 2, False, -1, 2, rpn_soa=None, transverse_waves=2,
        tile_rows=8)
    q_t, c_t = _plain2("vc_acoustics_2D", q, aux, args, {}, (4,) * 2, 2,
                       False, -1, 2)
    _close(q_t, q_j)
    assert abs(c_t - float(c_j)) <= 1e-12 * float(c_j)


def test_matches_step3_pallas_xy_kernel_aux_burgers():
    """step3_pallas_xy with its aux body kernel_aux on burgers_3D (a
    capacity row: rpt3 and rptt3 with the receiving cell's kappa),
    transverse_waves=2, two (8, 8) tiles."""
    from pyclaw_tpu.ops import tiled2d as jtiled
    rng = np.random.default_rng(6)
    n = (12, 20, 10)
    q, aux = _state(rng, "burgers_3D", n)
    aux = aux[2:].copy()
    jrp, rp = jriemann.burgers_3D, triemann.burgers_3D
    args = (1e-3, 0.1, 0.1, 0.1)
    params = {"efix": True}
    q_p, c_p = jtiled.step3_pallas_xy(
        jnp.asarray(q), *args, jrp.rp, jrp.rpt, jrp.rptt, params, (4,), 2,
        2, transverse_waves=2, tile=(8, 8), auxbc=jnp.asarray(aux),
        index_capa=0)
    q_t, c_t = tk.step3(torch.from_numpy(q), torch.from_numpy(aux), *args,
                        rp.rp, rp.rpt, rp.rptt, params, (4,), 2, False, 0, 2,
                        2)
    _close(q_t, q_p)
    assert abs(float(c_t) - float(c_p)) <= 1e-12 * float(c_p)
