"""Plain PyTorch version of the 2D unsplit classic (CTU) step, SoA form.

Counterpart of ``pyclaw_tpu/classic/soa.py`` (``_phi_soa :53``,
``_sweep_soa :73``, ``step2_soa :121``) — the XLA form, not the TPU's
roll form.  Every wave component is its own 2D ``(nx, ny)`` tensor.

This is what ``ops.tiled2d.step2_rows`` computes on a CPU tensor, and
what the CUDA kernel ``csrc/step2_ctu.cu`` is held against on the card.
The index algebra and the operation order are the JAX package's, so in
float64 the two agree to roundoff (tests/test_torch_step2.py).
"""

from __future__ import annotations

import torch

from ..limiters import tvd


def _lo(a, axis):
    return a[:-1] if axis == 0 else a[:, :-1]


def _hi(a, axis):
    return a[1:] if axis == 0 else a[:, 1:]


def _pad(a, axis, before, after):
    """Zero-pad ``a`` by ``before``/``after`` entries along ``axis``."""
    parts = []
    if before:
        shape = list(a.shape)
        shape[axis] = before
        parts.append(a.new_zeros(shape))
    parts.append(a)
    if after:
        shape = list(a.shape)
        shape[axis] = after
        parts.append(a.new_zeros(shape))
    return torch.cat(parts, dim=axis)


def _phi_soa(comps, s, lid, dtdx, axis):
    """Limiter factor for ONE wave family: upwind dot-product theta,
    phi=1 where the wave vanishes, theta=0 at the end interfaces."""
    live = [c for c in comps if c is not None]
    wn2 = sum(c * c for c in live)
    d = sum(_lo(c, axis) * _hi(c, axis) for c in live)
    dot_r = _pad(d, axis, 0, 1)
    dot_l = _pad(d, axis, 1, 0)
    dotu = torch.where(s > 0.0, dot_l, dot_r)
    safe = wn2 > 0.0
    theta = torch.where(safe, dotu / torch.where(safe, wn2, 1.0),
                        torch.zeros_like(wn2))
    phi = tvd.limiter_phi_one(lid, theta, torch.abs(s) * dtdx)
    return torch.where(safe, phi, torch.ones_like(phi))


def _sweep_soa(qs, axis, rpn_soa, params, mthlim, order, dtdx):
    """Normal sweep along ``axis``: (amdq, apdq, cq, speeds) per equation
    at the interfaces (length n-1 along ``axis``)."""
    ql = tuple(_lo(c, axis) for c in qs)
    qr = tuple(_hi(c, axis) for c in qs)
    waves, speeds = rpn_soa(axis, ql, qr, params)
    nw = len(waves)

    phis = [None] * nw
    if order == 2:
        for p in range(nw):
            lid = mthlim[p] if p < len(mthlim) else mthlim[-1]
            if lid != 0:
                phis[p] = _phi_soa(waves[p], speeds[p], lid, dtdx, axis)

    amdq, apdq, cq = [], [], []
    for e in range(len(qs)):
        am = ap = c = None
        for p in range(nw):
            w = waves[p][e]
            if w is None:
                continue
            sp = speeds[p]
            am_t = torch.clamp(sp, max=0.0) * w
            ap_t = torch.clamp(sp, min=0.0) * w
            am = am_t if am is None else am + am_t
            ap = ap_t if ap is None else ap + ap_t
            if order == 2:
                absp = torch.abs(sp)
                coef = 0.5 * absp * (1.0 - absp * dtdx)
                c_t = coef * w if phis[p] is None else coef * phis[p] * w
                c = c_t if c is None else c + c_t
        zero = torch.zeros_like(ql[0])
        amdq.append(am if am is not None else zero)
        apdq.append(ap if ap is not None else zero)
        cq.append((c if c is not None else zero) if order == 2 else None)
    return amdq, apdq, cq, speeds


def _abs_max(speeds, sl):
    """max |s| over the window ``sl`` of every speed (NaN propagates)."""
    return torch.stack([torch.amax(torch.abs(s[sl])) for s in speeds]).amax()


def step2_soa(q, dt, dx, dy, rpn_soa, rpt_soa, params, mthlim, order,
              num_ghost, transverse_waves=2, prefactor_soa=None):
    """2D unsplit classic step: q (num_eqn, nx, ny) ghost-padded ->
    (q_interior, cfl).  ``dt`` is a 0-d tensor or float; it is taken in
    q's dtype, as the kernel takes it."""
    g = num_ghost
    num_eqn, nx, ny = q.shape
    dt = torch.as_tensor(dt, dtype=q.dtype, device=q.device)
    dtdx = dt / dx
    dtdy = dt / dy
    qs = tuple(q[e] for e in range(num_eqn))

    amdqx, apdqx, cqxx, sx = _sweep_soa(qs, 0, rpn_soa, params, mthlim,
                                        order, dtdx)
    amdqy, apdqy, cqyy, sy = _sweep_soa(qs, 1, rpn_soa, params, mthlim,
                                        order, dtdy)

    # CFL over the interfaces touching the interior (step2's windows)
    slx = (slice(g - 1, nx - g), slice(g, ny - g))
    sly = (slice(g, nx - g), slice(g - 1, ny - g))
    cfl = torch.maximum(dtdx * _abs_max(sx, slx), dtdy * _abs_max(sy, sly))

    # list() copies the list, not the tensors; the folds below rebind
    # Fx[e]/Gy[e] to new tensors, never write into cqxx/cqyy, because the
    # y-side fold must still read the ORIGINAL cqyy
    Fx = list(cqxx) if order == 2 else [torch.zeros_like(a) for a in amdqx]
    Gy = list(cqyy) if order == 2 else [torch.zeros_like(a) for a in amdqy]

    if rpt_soa is not None and transverse_waves > 0:
        qx_l = tuple(_lo(c, 0) for c in qs)
        qx_r = tuple(_hi(c, 0) for c in qs)
        if transverse_waves >= 2 and order == 2:
            am_x = [a + c for a, c in zip(amdqx, cqxx)]
            ap_x = [a - c for a, c in zip(apdqx, cqxx)]
        else:
            am_x, ap_x = amdqx, apdqx
        kwx = {} if prefactor_soa is None else {
            "eig": prefactor_soa(0, qx_l, qx_r, params)}
        bm_am, bp_am = rpt_soa(0, 1, qx_l, qx_r, tuple(am_x), params, **kwx)
        bm_ap, bp_ap = rpt_soa(0, 2, qx_l, qx_r, tuple(ap_x), params, **kwx)

        # x-interface k feeds Gy rows k (A- parts) / k+1 (A+ parts);
        # below-going from source cell j>=1 -> Gy col j-1, above-going
        # from j<=ny-2 -> col j
        half_dtdx = 0.5 * dtdx
        for e in range(num_eqn):
            blk0 = half_dtdx * (bm_am[e][:, 1:] + bp_am[e][:, :-1])
            blk1 = half_dtdx * (bm_ap[e][:, 1:] + bp_ap[e][:, :-1])
            Gy[e] = Gy[e] - _pad(blk0, 0, 0, 1) - _pad(blk1, 0, 1, 0)

        qy_l = tuple(_lo(c, 1) for c in qs)
        qy_r = tuple(_hi(c, 1) for c in qs)
        if transverse_waves >= 2 and order == 2:
            am_y = [a + c for a, c in zip(amdqy, cqyy)]
            ap_y = [a - c for a, c in zip(apdqy, cqyy)]
        else:
            am_y, ap_y = amdqy, apdqy
        kwy = {} if prefactor_soa is None else {
            "eig": prefactor_soa(1, qy_l, qy_r, params)}
        am_bm, ap_bm = rpt_soa(1, 1, qy_l, qy_r, tuple(am_y), params, **kwy)
        am_bp, ap_bp = rpt_soa(1, 2, qy_l, qy_r, tuple(ap_y), params, **kwy)

        half_dtdy = 0.5 * dtdy
        for e in range(num_eqn):
            blk0 = half_dtdy * (am_bm[e][1:, :] + ap_bm[e][:-1, :])
            blk1 = half_dtdy * (am_bp[e][1:, :] + ap_bp[e][:-1, :])
            Fx[e] = Fx[e] - _pad(blk0, 1, 0, 1) - _pad(blk1, 1, 1, 0)

    out = []
    for e in range(num_eqn):
        dq = (apdqx[e][:-1, 1:-1] + amdqx[e][1:, 1:-1]
              + Fx[e][1:, 1:-1] - Fx[e][:-1, 1:-1]) * dtdx \
            + (apdqy[e][1:-1, :-1] + amdqy[e][1:-1, 1:]
               + Gy[e][1:-1, 1:] - Gy[e][1:-1, :-1]) * dtdy
        out.append(qs[e][1:-1, 1:-1] - dq)
    q_new = torch.stack(out)
    return q_new[:, g - 1:nx - 1 - g, g - 1:ny - 1 - g], cfl
