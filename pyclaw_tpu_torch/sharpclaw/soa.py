"""Plain PyTorch version of the SharpClaw 2D semidiscretization, SoA form.

Counterpart of ``pyclaw_tpu/sharpclaw/soa.py`` (``_slc :26``,
``_shift_ax :32``, ``_weno_edges :49``, ``_combine :56``,
``_dq_dir_soa :73``, ``dq_2d_soa :138``): the XLA form, not the TPU's roll
form or its VMEM row tiling.  Every equation is its own 2D ``(nx, ny)``
tensor; WENO reconstructs each component along the sweep axis.

This is what ``ops.tiled2d.dq_rows`` computes on a CPU tensor, with the
system's SoA hooks (Euler 4-wave, ``acoustics_2D``, whose speeds are
Python floats), and what the CUDA kernel ``csrc/dq2_weno5.cu`` is held
against on the card.  The index algebra and the operation order are the
JAX package's, so in float64 the two agree to roundoff
(tests/test_torch_sharpclaw.py, tests/test_torch_sharpclaw_nd.py).
"""

from __future__ import annotations

from functools import reduce

import torch

from .._slicing import slc
from ..limiters import recon



def _shift_ax(a, k, axis):
    """out[i] = a[i+k] along ``axis``, edge-replicated (the invalid band
    lies in the ghost region, which the caller trims)."""
    if k == 0:
        return a
    n = a.shape[axis]
    if k > 0:
        core = slc(a, axis, slice(k, n))
        edge = slc(a, axis, slice(n - 1, n))
        reps = [core] + [edge] * k
    else:
        core = slc(a, axis, slice(0, n + k))
        edge = slc(a, axis, slice(0, 1))
        reps = [edge] * (-k) + [core]
    return torch.cat(reps, dim=axis)


def _weno_edges(v, axis, weno_order):
    shifts = [_shift_ax(v, m, axis)
              for m in range(-(weno_order + 1) // 2 + 1,
                             (weno_order + 1) // 2)]
    return recon.weno_stencil(weno_order, shifts)


def fallback_count(qbc, params, positivity, weno_order=5):
    """Cells (counted once per sweep) whose WENO edge states fail
    ``positivity``: where :func:`_dq_dir_soa` falls back to the cell
    average."""
    qs = tuple(qbc[e] for e in range(qbc.shape[0]))
    n = 0
    for axis in (0, 1):
        edges = [_weno_edges(c, axis, weno_order) for c in qs]
        ok = (positivity([l for l, _ in edges], None, params)
              & positivity([r for _, r in edges], None, params))
        n += int((~ok).sum())
    return n


def _split(sp):
    """(min(s, 0), max(s, 0)) of a speed: a tensor, or a Python float for
    a system whose speeds are constant (acoustics)."""
    if isinstance(sp, torch.Tensor):
        return torch.clamp(sp, max=0.0), torch.clamp(sp, min=0.0)
    return min(sp, 0.0), max(sp, 0.0)


def _combine(waves, speeds, num_eqn, zero):
    """Godunov fluctuations from SoA waves: (amdq, apdq) per equation."""
    amdq, apdq = [], []
    for e in range(num_eqn):
        am = ap = None
        for w, sp in zip(waves, speeds):
            if w[e] is None:
                continue
            sm, sp_ = _split(sp)
            am_t = sm * w[e]
            ap_t = sp_ * w[e]
            am = am_t if am is None else am + am_t
            ap = ap_t if ap is None else ap + ap_t
        amdq.append(am if am is not None else zero)
        apdq.append(ap if ap is not None else zero)
    return amdq, apdq


def _dq_dir_soa(qs, axis, dt, dxi, rpn_soa, params, weno_order, num_ghost,
                positivity, flux_soa=None):
    """One directional sweep on per-equation 2D planes.  Returns (dq per
    equation over cells 1..n-2 along ``axis`` and the full extent of the
    other axis, cfl).  ``dt`` is a 0-d tensor of q's dtype."""
    g = num_ghost
    num_eqn = len(qs)
    n = qs[0].shape[axis]

    ql, qr = [], []
    for e in range(num_eqn):
        l, r = _weno_edges(qs[e], axis, weno_order)
        ql.append(l)
        qr.append(r)

    if positivity is not None:
        ok = positivity(ql, None, params) & positivity(qr, None, params)
        ql = [torch.where(ok, l, c) for l, c in zip(ql, qs)]
        qr = [torch.where(ok, r, c) for r, c in zip(qr, qs)]

    # interface k between cells k, k+1: states (qr_k, ql_{k+1})
    q_li = tuple(slc(r, axis, slice(0, n - 1)) for r in qr)
    q_ri = tuple(slc(l, axis, slice(1, n)) for l in ql)
    waves, speeds = rpn_soa(axis, q_li, q_ri, params)
    amdq, apdq = _combine(waves, speeds, num_eqn, torch.zeros_like(q_li[0]))

    # in-cell total fluctuation adq = f(qr) - f(ql) from the per-system
    # flux when the system registers one; else a second Riemann solve,
    # sum_p s_p W_p
    zero_c = torch.zeros_like(qs[0])
    if flux_soa is not None:
        fl = flux_soa(axis, tuple(ql), params)
        fr = flux_soa(axis, tuple(qr), params)
        adq = [(fr[e] if fr[e] is not None else zero_c)
               - (fl[e] if fl[e] is not None else zero_c)
               for e in range(num_eqn)]
    else:
        waves2, speeds2 = rpn_soa(axis, tuple(ql), tuple(qr), params)
        adq = []
        for e in range(num_eqn):
            a = None
            for w, sp in zip(waves2, speeds2):
                if w[e] is None:
                    continue
                t = sp * w[e]
                a = t if a is None else a + t
            adq.append(a if a is not None else zero_c)

    dtdx = dt / dxi
    # interfaces g-1 .. n-g-1 along the sweep, the whole other axis
    # (ghost band included); NaN propagates.  A constant speed (a Python
    # float) counts as a 0-d tensor of dt's dtype.
    cfl = dtdx * reduce(torch.maximum,
                        (torch.amax(torch.abs(slc(s, axis,
                                                   slice(g - 1, n - g))))
                         if isinstance(s, torch.Tensor)
                         else torch.full_like(dtdx, abs(s))
                         for s in speeds))

    dq = []
    for e in range(num_eqn):
        dq.append(-dtdx * (slc(apdq[e], axis, slice(0, n - 2))
                           + slc(amdq[e], axis, slice(1, n - 1))
                           + slc(adq[e], axis, slice(1, n - 1))))
    return dq, cfl


def dq_2d_soa(qbc, dt, dx, dy, rpn_soa, params, weno_order, num_ghost,
              positivity=None, flux_soa=None):
    """2D method-of-lines semidiscrete update (componentwise WENO, no aux,
    no capacity, no tfluct): qbc (num_eqn, nx, ny) ghost-padded -> (dq
    over the interior cells, dt included, cfl as a 0-d tensor).  ``dt``
    is a 0-d tensor or a float; it is taken in q's dtype, as the kernel
    takes it."""
    g = num_ghost
    num_eqn, nx, ny = qbc.shape
    dt = torch.as_tensor(dt, dtype=qbc.dtype, device=qbc.device)
    qs = tuple(qbc[e] for e in range(num_eqn))

    dqx, cflx = _dq_dir_soa(qs, 0, dt, dx, rpn_soa, params, weno_order,
                            g, positivity, flux_soa=flux_soa)
    dqy, cfly = _dq_dir_soa(qs, 1, dt, dy, rpn_soa, params, weno_order,
                            g, positivity, flux_soa=flux_soa)

    out = []
    for e in range(num_eqn):
        # each sweep covers cells 1..n-2 along its axis and the whole
        # other axis; trim both to the interior (cells g..n-g-1)
        x_part = dqx[e][g - 1:nx - 1 - g, g:ny - g]
        y_part = dqy[e][g:nx - g, g - 1:ny - 1 - g]
        out.append(x_part + y_part)
    return torch.stack(out), torch.maximum(cflx, cfly)
