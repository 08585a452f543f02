"""Plain PyTorch version of the 3D unsplit classic (CTU) step, AoS form.

Counterpart of ``pyclaw_tpu/classic/kernels.py`` (``_correction_flux
:38``, ``_sweep_normal :125``, ``_embed :509``, ``_slc :523``,
``_step3_sweeps :529``, ``step3 :572``, ``_step3_update :597``) — the XLA
form, the oracle of the JAX package, not its roll form or its tiled and
phased variants.  This is what ``ops.tiled2d.step3_xy`` computes on a CPU
tensor, and what the CUDA kernel ``csrc/step3_ctu.cu`` is held against on
the card.  The index algebra and the order of the sums are the JAX
package's, so in float64 the two agree to roundoff
(tests/test_torch_step3.py).

Only the wave-form path without aux arrays or a capacity function is
ported; those arguments raise ``NotImplementedError``.  Without a
capacity function dt/dx stays a scalar: ``dt/dx``, ``0.5 dt/dx`` and
``dt^2 / (6 dx dy)`` are Python floats, which PyTorch rounds to q's
dtype where they meet a tensor.
"""

from __future__ import annotations

import torch

from .._slicing import slc
from ..limiters import tvd
from ..solver import _not_ported



def _embed(v, like, starts):
    """``v`` zero-padded so it sits at offsets ``starts`` (dict axis ->
    start, default 0) within a tensor shaped like ``like``."""
    out = v.new_zeros(like.shape)
    idx = tuple(slice(starts.get(ax, 0), starts.get(ax, 0) + v.shape[ax])
                for ax in range(v.ndim))
    out[idx] = v
    return out


def _correction_flux(wave, phi, s, dtdxave):
    """Second-order correction flux at each interface (wave form):
    cqxx = sum_p 0.5 |s^p| (1 - |s^p| dt/dx) phi^p W^p."""
    abss = torch.abs(s)
    coef = 0.5 * abss * (1.0 - abss * dtdxave)
    return torch.sum((coef * phi)[None] * wave, dim=1)


def _sweep_normal(q, ixy, rp, params, mthlim, order, dtdx):
    """Normal Riemann sweep along axis ``ixy`` of a ghost-padded array:
    (wave, s, amdq, apdq, cqxx) at every interface along that axis
    (cqxx is None for order 1)."""
    axis = 1 + ixy
    n = q.shape[axis]
    q_l, q_r = slc(q, axis, slice(0, n - 1)), slc(q, axis, slice(1, n))
    wave, s, amdq, apdq = rp(ixy, q_l, q_r, None, None, params)
    cqxx = None
    if order == 2:
        phi = tvd.limiter_phi(q.shape[0], wave, s, mthlim, dtdx=dtdx,
                              axis=axis - q.ndim)
        cqxx = _correction_flux(wave, phi, s, dtdx)
    return wave, s, amdq, apdq, cqxx


def _step3_sweeps(q, dt, deltas, rp, params, mthlim, order, num_ghost):
    """Normal sweeps of the 3D step: per-direction (amdq, apdq, cqxx) and
    the CFL over the interfaces touching interior cells."""
    g = num_ghost
    shape = q.shape[1:]
    waves = {}
    cfl = None
    for d in range(3):
        dtdx = dt / deltas[d]
        _, s, amdq, apdq, cqxx = _sweep_normal(q, d, rp, params, mthlim,
                                               order, dtdx)
        waves[d] = (amdq, apdq, cqxx)
        s_int = slc(s, 1 + d, slice(g - 1, shape[d] - g))
        for d2 in range(3):
            if d2 != d:
                s_int = slc(s_int, 1 + d2, slice(g, shape[d2] - g))
        c = torch.amax(torch.abs(s_int)) * dtdx
        cfl = c if cfl is None else torch.maximum(cfl, c)
    return waves, cfl


def step3(q, aux, dt, dx, dy, dz, rp, rpt, rptt, params, mthlim, order,
          fwave, index_capa, num_ghost, transverse_waves=2, prefactor=None):
    """3D unsplit classic step (step3.f90 + flux3.f90): normal sweeps
    with limited corrections, rpt3 corner transport and rptt3
    corner-of-corner corrections.  q (num_eqn, nx, ny, nz) ghost-padded;
    ``dt`` a Python float.  Returns (q_interior, cfl)."""
    if aux is not None:
        raise _not_ported("aux")
    if index_capa >= 0:
        raise _not_ported("capacity")
    if fwave:
        raise _not_ported("fwave")
    dt = float(dt)
    deltas = (dx, dy, dz)
    waves, cfl = _step3_sweeps(q, dt, deltas, rp, params, mthlim, order,
                               num_ghost)
    q_new = _step3_update(q, waves, dt, deltas, rpt, rptt, params,
                          num_ghost, transverse_waves, prefactor)
    return q_new, cfl


def _step3_update(q, waves, dt, deltas, rpt, rptt, params, num_ghost,
                  transverse_waves=2, prefactor=None):
    """Transverse corner transport and assembly of the 3D step (the
    rpt3/rptt3 + gadd/hadd half of flux3.f90).  The summation order is
    the JAX package's: per (d, e) pair the own-row rptt blocks, then the
    crossing blocks in sorted key order, then one add per flux array."""
    g = num_ghost
    shape = q.shape[1:]

    F = {}
    for d in range(3):
        amdq, apdq, cqxx = waves[d]
        F[d] = cqxx if cqxx is not None else torch.zeros_like(amdq)

    if rpt is not None and transverse_waves > 0:
        for d in range(3):                      # sweep axis
            axis_d = 1 + d
            q_l = slc(q, axis_d, slice(0, shape[d] - 1))
            q_r = slc(q, axis_d, slice(1, shape[d]))
            kwd = {} if prefactor is None else {
                "eig": prefactor(d, q_l, q_r, None, None, params)}
            amdq, apdq, cqdd = waves[d]
            # transverse_waves >= 2 with order 2: the correction waves
            # ride the transverse solves too
            if transverse_waves >= 2 and cqdd is not None:
                amdq, apdq = amdq + cqdd, apdq - cqdd
            for e in range(3):                  # transverse axis
                if e == d:
                    continue
                half = 0.5 * (dt / deltas[d])
                axis_e = 1 + e
                f = 3 - d - e                   # the third axis
                axis_f = 1 + f
                n_f = shape[f]
                n_e = shape[e]
                coeff2 = (dt * dt) / (6.0 * deltas[d] * deltas[e])
                own = {}        # i0 -> summed own-row rptt blocks
                cross = {}      # (i0, e_start) -> summed crossing blocks
                fe_blocks = {}  # i0 -> rpt contribution block for F[e]
                for imp in (1, 2):
                    asdq = amdq if imp == 1 else apdq
                    bm, bp = rpt(d, imp, q_l, q_r, None, None, asdq,
                                 params, trans_axis=e, **kwd)
                    i0 = imp - 1   # target cell offset along the sweep axis
                    # below-going: F[e] at e-interface j-1 of source cell j
                    bm_s = slc(bm, axis_e, slice(1, n_e))
                    bp_s = slc(bp, axis_e, slice(0, n_e - 1))
                    fe_blocks[i0] = -(half * bm_s + half * bp_s)

                    if rptt is not None and transverse_waves >= 2:
                        for b_part, e_dir in ((bm, -1), (bp, 1)):
                            cm, cp = rptt(d, 2 + (f > e), imp, e_dir, q_l,
                                          q_r, None, None, b_part, params,
                                          trans_axis=f, **kwd)
                            # the b-part carries sign(v_e); the corner
                            # expansion needs |v_e|: flip the down-going
                            sgn = float(e_dir)
                            for c_part, f_off in ((cm, -1), (cp, 0)):
                                f_src = (slice(1, n_f) if f_off == -1
                                         else slice(0, n_f - 1))
                                cs = slc(c_part, axis_f, f_src)
                                t = sgn * coeff2 * cs
                                # + at the part's own e-row
                                own[i0] = t if i0 not in own else own[i0] + t
                                # - at the e-row it crosses into
                                if e_dir > 0:
                                    e_src, e_start = slice(0, n_e - 1), 1
                                else:
                                    e_src, e_start = slice(1, n_e), 0
                                blk = -slc(t, axis_e, e_src)
                                key = (i0, e_start)
                                cross[key] = (blk if key not in cross
                                              else cross[key] + blk)
                acc = None
                for i0 in sorted(own):
                    p = _embed(own[i0], F[f], {axis_d: i0})
                    acc = p if acc is None else acc + p
                for i0, e_start in sorted(cross):
                    acc = acc + _embed(cross[(i0, e_start)], F[f],
                                       {axis_d: i0, axis_e: e_start})
                if acc is not None:
                    F[f] = F[f] + acc
                F[e] = F[e] + (_embed(fe_blocks[0], F[e], {axis_d: 0})
                               + _embed(fe_blocks[1], F[e], {axis_d: 1}))

    # ---- assemble the update over cells 1..n-2 on every axis -----------
    def inner_cells(a):
        for d in range(3):
            a = slc(a, 1 + d, slice(1, a.shape[1 + d] - 1))
        return a

    qc = inner_cells(q)
    dq_tot = torch.zeros_like(qc)
    for d in range(3):
        amdq, apdq, _ = waves[d]
        axis = 1 + d
        n = shape[d]
        ap = slc(apdq, axis, slice(0, n - 2))
        am = slc(amdq, axis, slice(1, n - 1))
        term = ap + am + (slc(F[d], axis, slice(1, n - 1))
                          - slc(F[d], axis, slice(0, n - 2)))
        for d2 in range(3):
            if d2 != d:
                term = slc(term, 1 + d2, slice(1, term.shape[1 + d2] - 1))
        dq_tot = dq_tot + (dt / deltas[d]) * term
    out = qc - dq_tot
    # out covers cells 1..n-2 per axis; the interior is g..n-1-g
    for d in range(3):
        out = slc(out, 1 + d, slice(g - 1, out.shape[1 + d] - (g - 1)))
    return out
