"""Plain PyTorch versions of the classic steps, AoS form: the 1D sweep and
the unsplit 2D and 3D CTU steps.

Counterpart of ``pyclaw_tpu/classic/kernels.py`` (``_dtdx_arr :31``,
``_correction_flux :38``, ``step1 :55``, ``_sweep_normal :125``,
``_pad_axis :171``, ``step2 :177``, ``_embed :509``, ``_slc :523``,
``_step3_sweeps :529``, ``step3 :572``, ``_step3_update :597``) — the
XLA form, the oracle of the JAX package, not its roll form or its tiled
and phased variants.  ``step1`` is what ``ops.sweep.step1`` computes on
a CPU tensor, and what the CUDA kernel ``csrc/step1.cu`` is held against
on the card; ``step2`` the same for ``ops.tiled2d.step2_rows_generic``
and ``csrc/step2_aos.cu``; ``step3`` for ``ops.tiled2d.step3_xy`` and
``csrc/step3_ctu.cu`` (Euler, with or without a capacity function or
f-waves) and for ``ops.tiled2d.step3_xy_generic`` and
``csrc/step3_aos.cu`` (the other 3D systems: aux, capacity, f-waves).  The index algebra
and the order of the sums are the JAX package's, so in float64 the two
agree to roundoff (tests/test_torch_step1.py,
tests/test_torch_step2_aos.py, tests/test_torch_step3.py,
tests/test_torch_step3_aos.py).

The 1D, 2D and 3D steps take aux arrays, a capacity function
(``index_capa`` >= 0: per-cell dt/(dx kappa)) and the f-wave correction
form.  Without a capacity function dt/dx stays a scalar: ``dt/dx``,
``0.5 dt/dx`` and ``dt^2 / (6 dx dy)`` are Python floats, which PyTorch
rounds to q's dtype where they meet a tensor; with dt a 0-d float64
tensor (the solver's device loop) they are computed in float64 and rounded
once to q's dtype (``_coef``), the same values.  Sums over the small wave
and equation axes are written as explicit adds in a fixed order, so no
result depends on how ATen splits or vectorises a reduction.
"""

from __future__ import annotations

import torch

from .._slicing import slc
from ..limiters import tvd


def _embed(v, like, starts):
    """``v`` zero-padded so it sits at offsets ``starts`` (dict axis ->
    start, default 0) within a tensor shaped like ``like``."""
    out = v.new_zeros(like.shape)
    idx = tuple(slice(starts.get(ax, 0), starts.get(ax, 0) + v.shape[ax])
                for ax in range(v.ndim))
    out[idx] = v
    return out


def _correction_flux(wave, phi, s, dtdxave, fwave):
    """Second-order correction flux at each interface:
    cqxx = sum_p 0.5 |s^p| (1 - |s^p| dt/dx) phi^p W^p     (wave form)
    cqxx = sum_p 0.5 sign(s^p) (1 - |s^p| dt/dx) phi^p Z^p (f-wave form)
    with sign(0) = 0; the sum over p runs in wave order."""
    abss = torch.abs(s)
    if fwave:
        coef = 0.5 * torch.sign(s) * (1.0 - abss * dtdxave)
    else:
        coef = 0.5 * abss * (1.0 - abss * dtdxave)
    terms = (coef * phi)[None] * wave
    cq = terms[:, 0]
    for p in range(1, wave.shape[1]):
        cq = cq + terms[:, p]
    return cq


def _coef(x, like):
    """A coefficient of dt as the plain version uses it: a Python float
    as it is (PyTorch rounds it to q's dtype where it meets a tensor); a
    0-d tensor (dt held as a float64 tensor by the solver's device loop)
    rounded once to ``like``'s dtype, so that it meets q's tensors, and a
    0-d CFL maximum, as the float would."""
    return x.to(like.dtype) if isinstance(x, torch.Tensor) else x


def _dtdx_arr(dt, dxi, capa, like):
    """dt/(dx kappa) per cell along the sweep axis: with a capacity
    function a tensor shaped like ``capa``, else dt/dx as a scalar
    (:func:`_coef`; the JAX package's ``jnp.full((n,), dt/dx)`` holds that
    value in every cell).  The capacity form divides a 0-d tensor, as the
    JAX package divides (``float / tensor`` in PyTorch multiplies by a
    reciprocal).  ``dt`` is a Python float or a 0-d tensor; ``like`` a
    tensor of q's dtype."""
    if capa is None:
        return _coef(dt / dxi, like)
    return torch.as_tensor(dt, dtype=capa.dtype,
                           device=capa.device) / (dxi * capa)


def step1(q, aux, dt, dx, rp, params, mthlim, order, fwave, index_capa,
          num_ghost, ixy=0):
    """1D classic sweep (step1.f90) along the LAST axis of ghost-padded
    arrays: the plain version of ``csrc/step1.cu``.

    q: (num_eqn, ..., n) with n = mx + 2*num_ghost (ghosts filled); aux:
    (num_aux, ..., n) or None; ``dt`` a Python float or a 0-d tensor.
    Interface k lies
    between cells k and k+1; cell i takes apdq of interface i-1 and amdq
    of interface i.  Returns (q with the last axis cut to the interior
    mx, cfl over the interfaces touching interior cells)."""
    g = num_ghost
    n = q.shape[-1]

    q_l, q_r = q[..., :-1], q[..., 1:]
    aux_l = aux_r = None
    if aux is not None:
        aux_l, aux_r = aux[..., :-1], aux[..., 1:]
    wave, s, amdq, apdq = rp(ixy, q_l, q_r, aux_l, aux_r, params)

    capa = aux[index_capa] if index_capa >= 0 else None
    dtdx = _dtdx_arr(dt, dx, capa, q)
    s_int = s[..., g - 1:n - g]
    if capa is None:
        cfl = torch.amax(torch.maximum(s_int * dtdx, -s_int * dtdx))
        dtdx_c = dtdxave = dtdx
    else:
        cfl = torch.amax(torch.maximum(s_int * dtdx[..., g:n - g + 1],
                                       -s_int * dtdx[..., g - 1:n - g]))
        dtdx_c = dtdx[..., 1:-1]
        dtdxave = 0.5 * (dtdx[..., :-1] + dtdx[..., 1:])

    # first-order fluctuation update for cells 1..n-2
    q_new = q[..., 1:-1] - dtdx_c * (apdq[..., :-1] + amdq[..., 1:])
    if order == 2:
        phi = tvd.limiter_phi(q.shape[0], wave, s, mthlim, dtdx=dtdxave)
        cqxx = _correction_flux(wave, phi, s, dtdxave, fwave)
        q_new = q_new - dtdx_c * (cqxx[..., 1:] - cqxx[..., :-1])
    # q_new covers cells 1..n-2; interior cells are g..n-1-g
    return q_new[..., g - 1:n - 1 - g], cfl


def step1_dir(q, aux, dt, dxi, ixy, rp, params, mthlim, order, fwave,
              index_capa, num_ghost):
    """One sweep of dimensional splitting (step2ds.f90 / step3ds.f90):
    :func:`step1` along spatial axis ``ixy`` of a ghost-padded N-D array,
    with aux and its capacity row moved with q, then the ghost bands of
    every other axis stripped.  Returns (q_interior, cfl).  The JAX
    package's ``classic/kernels.py:99 step1_dir``; it reaches no TPU
    kernel there, and runs as plain PyTorch on every device here."""
    g = num_ghost
    axis = 1 + ixy
    qm = torch.movedim(q, axis, -1)
    auxm = None if aux is None else torch.movedim(aux, axis, -1)
    q_new, cfl = step1(qm, auxm, dt, dxi, rp, params, mthlim, order, fwave,
                       index_capa, g, ixy=ixy)
    q_new = torch.movedim(q_new, -1, axis)
    sl = [slice(None)] * q_new.dim()
    for d in range(q_new.dim() - 1):
        if d != ixy:
            sl[1 + d] = slice(g, q_new.shape[1 + d] - g)
    return q_new[tuple(sl)], cfl


def _sweep_normal(q, aux, ixy, rp, params, mthlim, order, fwave,
                  dtdx_cells):
    """Normal Riemann sweep along axis ``ixy`` of a ghost-padded array:
    (wave, s, amdq, apdq, cqxx, dtdxave) at every interface along that
    axis.  ``dtdx_cells`` is a scalar (:func:`_coef`), or a per-cell
    tensor (with a
    capacity function), whose interface value is the average of the two
    cells'.  cqxx and dtdxave are None for order 1."""
    axis = 1 + ixy
    n = q.shape[axis]
    q_l, q_r = slc(q, axis, slice(0, n - 1)), slc(q, axis, slice(1, n))
    aux_l = aux_r = None
    if aux is not None:
        aux_l, aux_r = slc(aux, axis, slice(0, n - 1)), slc(aux, axis,
                                                            slice(1, n))
    wave, s, amdq, apdq = rp(ixy, q_l, q_r, aux_l, aux_r, params)
    cqxx = dtdxave = None
    if order == 2:
        if isinstance(dtdx_cells, torch.Tensor) and dtdx_cells.dim() > 0:
            dtdxave = 0.5 * (slc(dtdx_cells, ixy, slice(0, n - 1))
                             + slc(dtdx_cells, ixy, slice(1, n)))
        else:
            dtdxave = dtdx_cells
        phi = tvd.limiter_phi(q.shape[0], wave, s, mthlim, dtdx=dtdxave,
                              axis=axis - q.ndim)
        cqxx = _correction_flux(wave, phi, s, dtdxave, fwave)
    return wave, s, amdq, apdq, cqxx, dtdxave


def _pad_axis(a, axis, before, after):
    """``a`` with ``before`` / ``after`` zero entries added along
    ``axis``."""
    pads = [0, 0] * a.ndim
    k = 2 * (a.ndim - 1 - axis)
    pads[k], pads[k + 1] = before, after
    return torch.nn.functional.pad(a, pads)


def step2(q, aux, dt, dx, dy, rp, rpt, params, mthlim, order, fwave,
          index_capa, num_ghost, transverse_waves=2, prefactor=None):
    """2D unsplit classic step (step2.f90 + flux2.f90).

    q: (num_eqn, nx, ny) ghost-padded; aux: (num_aux, nx, ny) or None;
    ``dt`` a Python float or a 0-d tensor.  Normal fluctuations and
    correction fluxes
    are full-grid tensors; the transverse pass adds the corner-transport
    terms into the orthogonal flux as zero-padded shifted blocks (no
    scatter).  ``transverse_waves``: 0 donor-cell corners, 1 transport of
    the first-order fluctuations, 2 also of the correction waves
    (flux2.f90 method(3)).  With a capacity function the transverse
    coefficients are those of the receiving cell (flux2.f90
    ``dtdx1d(i1)``).  Returns (q_interior, cfl)."""
    g = num_ghost
    num_eqn, nx, ny = q.shape

    capa = aux[index_capa] if index_capa >= 0 else None
    dtdx = _dtdx_arr(dt, dx, capa, q)
    dtdy = _dtdx_arr(dt, dy, capa, q)

    wx, sx, amdqx, apdqx, cqxx, _ = _sweep_normal(
        q, aux, 0, rp, params, mthlim, order, fwave, dtdx)
    wy, sy, amdqy, apdqy, cqyy, _ = _sweep_normal(
        q, aux, 1, rp, params, mthlim, order, fwave, dtdy)

    # CFL over the interfaces touching interior cells
    sx_int = sx[:, g - 1:nx - g, g:ny - g]
    sy_int = sy[:, g:nx - g, g - 1:ny - g]
    if capa is None:
        cflx = dtdx * torch.amax(torch.abs(sx_int))
        cfly = dtdy * torch.amax(torch.abs(sy_int))
    else:
        cflx = torch.amax(torch.maximum(
            sx_int * dtdx[None, g:nx - g + 1, g:ny - g],
            -sx_int * dtdx[None, g - 1:nx - g, g:ny - g]))
        cfly = torch.amax(torch.maximum(
            sy_int * dtdy[None, g:nx - g, g:ny - g + 1],
            -sy_int * dtdy[None, g:nx - g, g - 1:ny - g]))
    cfl = torch.maximum(cflx, cfly)

    # F~ at x-interfaces (num_eqn, nx-1, ny); G~ at y-interfaces
    Fx = cqxx if cqxx is not None else torch.zeros_like(amdqx)
    Gy = cqyy if cqyy is not None else torch.zeros_like(amdqy)

    if rpt is not None and transverse_waves > 0:
        if transverse_waves >= 2 and cqxx is not None:
            amdqx_t, apdqx_t = amdqx + cqxx, apdqx - cqxx
        else:
            amdqx_t, apdqx_t = amdqx, apdqx
        qx_l, qx_r = q[:, :-1], q[:, 1:]
        auxx_l = auxx_r = None
        if aux is not None:
            auxx_l, auxx_r = aux[:, :-1], aux[:, 1:]
        kwx = {} if prefactor is None else {
            "eig": prefactor(0, qx_l, qx_r, auxx_l, auxx_r, params)}
        bm_am, bp_am = rpt(0, 1, qx_l, qx_r, auxx_l, auxx_r, amdqx_t,
                           params, **kwx)
        bm_ap, bp_ap = rpt(0, 2, qx_l, qx_r, auxx_l, auxx_r, apdqx_t,
                           params, **kwx)

        # x-interface k lies between cells k and k+1; its A-dQ parts go
        # to Gy row i = k (i0 = 0), its A+dQ parts to row k+1 (i0 = 1):
        # below-going parts of source column j to y-interface j-1,
        # above-going to y-interface j, with the receiving cell's
        # coefficient
        def transverse_contrib(bm, bp, i0):
            if capa is None:
                c_lo = c_hi = 0.5 * dtdx
            else:
                nxm1 = bm.shape[1]
                c_lo = 0.5 * dtdx[None, i0:i0 + nxm1, 1:]
                c_hi = 0.5 * dtdx[None, i0:i0 + nxm1, :-1]
            block = c_lo * bm[:, :, 1:] + c_hi * bp[:, :, :-1]
            return _pad_axis(block, 1, i0, 1 - i0)

        Gy = Gy - transverse_contrib(bm_am, bp_am, 0) \
                - transverse_contrib(bm_ap, bp_ap, 1)

        if transverse_waves >= 2 and cqyy is not None:
            amdqy_t, apdqy_t = amdqy + cqyy, apdqy - cqyy
        else:
            amdqy_t, apdqy_t = amdqy, apdqy
        qy_l, qy_r = q[:, :, :-1], q[:, :, 1:]
        auxy_l = auxy_r = None
        if aux is not None:
            auxy_l, auxy_r = aux[:, :, :-1], aux[:, :, 1:]
        kwy = {} if prefactor is None else {
            "eig": prefactor(1, qy_l, qy_r, auxy_l, auxy_r, params)}
        am_bm, ap_bm = rpt(1, 1, qy_l, qy_r, auxy_l, auxy_r, amdqy_t,
                           params, **kwy)
        am_bp, ap_bp = rpt(1, 2, qy_l, qy_r, auxy_l, auxy_r, apdqy_t,
                           params, **kwy)

        def transverse_contrib_y(am, ap, j0):
            if capa is None:
                c_lo = c_hi = 0.5 * dtdy
            else:
                nym1 = am.shape[2]
                c_lo = 0.5 * dtdy[None, 1:, j0:j0 + nym1]
                c_hi = 0.5 * dtdy[None, :-1, j0:j0 + nym1]
            block = c_lo * am[:, 1:, :] + c_hi * ap[:, :-1, :]
            return _pad_axis(block, 2, j0, 1 - j0)

        Fx = Fx - transverse_contrib_y(am_bm, ap_bm, 0) \
                - transverse_contrib_y(am_bp, ap_bp, 1)

    # ---- update of cells 1..nx-2 (x) and 1..ny-2 (y) ---------------------
    qc = q[:, 1:-1, 1:-1]
    if capa is None:
        dtdx_c, dtdy_c = dtdx, dtdy
    else:
        dtdx_c, dtdy_c = dtdx[1:-1, 1:-1], dtdy[1:-1, 1:-1]
    dq = (apdqx[:, :-1, 1:-1] + amdqx[:, 1:, 1:-1]
          + Fx[:, 1:, 1:-1] - Fx[:, :-1, 1:-1]) * dtdx_c \
        + (apdqy[:, 1:-1, :-1] + amdqy[:, 1:-1, 1:]
           + Gy[:, 1:-1, 1:] - Gy[:, 1:-1, :-1]) * dtdy_c
    q_new = qc - dq
    return q_new[:, g - 1:nx - 1 - g, g - 1:ny - 1 - g], cfl


def _step3_sweeps(q, aux, dt, deltas, rp, params, mthlim, order, fwave,
                  index_capa, num_ghost):
    """Normal sweeps of the 3D step: per-direction (amdq, apdq, cqxx), the
    per-direction dt/(dD kappa) (Python floats without a capacity
    function, per-cell tensors with one), the capacity row and the CFL
    over the interfaces touching interior cells (upwinded per-cell
    dt/(dD kappa) with a capacity function)."""
    g = num_ghost
    shape = q.shape[1:]
    capa = aux[index_capa] if index_capa >= 0 else None
    dtdx_cells = [_dtdx_arr(dt, deltas[d], capa, q) for d in range(3)]
    waves = {}
    cfl = None
    for d in range(3):
        _, s, amdq, apdq, cqxx, _ = _sweep_normal(
            q, aux, d, rp, params, mthlim, order, fwave, dtdx_cells[d])
        waves[d] = (amdq, apdq, cqxx)
        s_int = slc(s, 1 + d, slice(g - 1, shape[d] - g))
        for d2 in range(3):
            if d2 != d:
                s_int = slc(s_int, 1 + d2, slice(g, shape[d2] - g))
        if capa is None:
            c = torch.amax(torch.abs(s_int)) * dtdx_cells[d]
        else:
            dt_r = slc(dtdx_cells[d], d, slice(g, shape[d] - g + 1))
            dt_l = slc(dtdx_cells[d], d, slice(g - 1, shape[d] - g))
            for d2 in range(3):
                if d2 != d:
                    dt_r = slc(dt_r, d2, slice(g, shape[d2] - g))
                    dt_l = slc(dt_l, d2, slice(g, shape[d2] - g))
            c = torch.amax(torch.maximum(s_int * dt_r, -s_int * dt_l))
        cfl = c if cfl is None else torch.maximum(cfl, c)
    return waves, dtdx_cells, capa, cfl


def step3(q, aux, dt, dx, dy, dz, rp, rpt, rptt, params, mthlim, order,
          fwave, index_capa, num_ghost, transverse_waves=2, prefactor=None):
    """3D unsplit classic step (step3.f90 + flux3.f90): normal sweeps
    with limited corrections, rpt3 corner transport and rptt3
    corner-of-corner corrections.  q (num_eqn, nx, ny, nz) ghost-padded;
    aux (num_aux, nx, ny, nz) or None; ``dt`` a Python float or a 0-d
    tensor.  With a
    capacity function (``index_capa`` >= 0) every dt/dD becomes the
    per-cell dt/(dD kappa), and the transverse coefficients are those of
    the receiving cell (flux3.f90 ``dtdx1d(i1)``).  Returns (q_interior,
    cfl)."""
    deltas = (dx, dy, dz)
    waves, dtdx_cells, capa, cfl = _step3_sweeps(
        q, aux, dt, deltas, rp, params, mthlim, order, fwave, index_capa,
        num_ghost)
    q_new = _step3_update(q, aux, waves, dtdx_cells, capa, dt, deltas, rpt,
                          rptt, params, num_ghost, transverse_waves,
                          prefactor)
    return q_new, cfl


def _step3_update(q, aux, waves, dtdx_cells, capa, dt, deltas, rpt, rptt,
                  params, num_ghost, transverse_waves=2, prefactor=None):
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
            a_l = a_r = None
            if aux is not None:
                a_l = slc(aux, axis_d, slice(0, shape[d] - 1))
                a_r = slc(aux, axis_d, slice(1, shape[d]))
            kwd = {} if prefactor is None else {
                "eig": prefactor(d, q_l, q_r, a_l, a_r, params)}
            amdq, apdq, cqdd = waves[d]
            # transverse_waves >= 2 with order 2: the correction waves
            # ride the transverse solves too
            if transverse_waves >= 2 and cqdd is not None:
                amdq, apdq = amdq + cqdd, apdq - cqdd
            for e in range(3):                  # transverse axis
                if e == d:
                    continue
                half = _coef(0.5 * (dt / deltas[d]), q)
                axis_e = 1 + e
                f = 3 - d - e                   # the third axis
                axis_f = 1 + f
                n_f = shape[f]
                n_e = shape[e]
                coeff2 = _coef((dt * dt) / (6.0 * deltas[d] * deltas[e]),
                               q)
                own = {}        # i0 -> summed own-row rptt blocks
                cross = {}      # (i0, e_start) -> summed crossing blocks
                fe_blocks = {}  # i0 -> rpt contribution block for F[e]
                for imp in (1, 2):
                    asdq = amdq if imp == 1 else apdq
                    bm, bp = rpt(d, imp, q_l, q_r, a_l, a_r, asdq,
                                 params, trans_axis=e, **kwd)
                    i0 = imp - 1   # target cell offset along the sweep axis
                    # below-going: F[e] at e-interface j-1 of source cell j
                    bm_s = slc(bm, axis_e, slice(1, n_e))
                    bp_s = slc(bp, axis_e, slice(0, n_e - 1))
                    if capa is None:
                        c_bm = c_bp = half
                        co2_full = None
                    else:   # the receiving cell's kappa (dtdx1d(i1))
                        dd = slc(dtdx_cells[d], d,
                                 slice(i0, i0 + shape[d] - 1))
                        c_bm = 0.5 * slc(dd, e, slice(1, n_e))[None]
                        c_bp = 0.5 * slc(dd, e, slice(0, n_e - 1))[None]
                        co2_full = _coef(dt / (6.0 * deltas[e]), q) * dd
                    fe_blocks[i0] = -(c_bm * bm_s + c_bp * bp_s)

                    if rptt is not None and transverse_waves >= 2:
                        for b_part, e_dir in ((bm, -1), (bp, 1)):
                            cm, cp = rptt(d, 2 + (f > e), imp, e_dir, q_l,
                                          q_r, a_l, a_r, b_part, params,
                                          trans_axis=f, **kwd)
                            # the b-part carries sign(v_e); the corner
                            # expansion needs |v_e|: flip the down-going
                            sgn = float(e_dir)
                            for c_part, f_off in ((cm, -1), (cp, 0)):
                                f_src = (slice(1, n_f) if f_off == -1
                                         else slice(0, n_f - 1))
                                cs = slc(c_part, axis_f, f_src)
                                if co2_full is None:
                                    co_cs = coeff2
                                else:   # kappa-scaled, sliced like cs
                                    co_cs = slc(co2_full, f, f_src)[None]
                                t = sgn * co_cs * cs
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
    def inner_cells(a, first):
        for d in range(3):
            a = slc(a, first + d, slice(1, a.shape[first + d] - 1))
        return a

    qc = inner_cells(q, 1)
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
        dtd = (dtdx_cells[d] if capa is None
               else inner_cells(dtdx_cells[d], 0))
        dq_tot = dq_tot + dtd * term
    out = qc - dq_tot
    # out covers cells 1..n-2 per axis; the interior is g..n-1-g
    for d in range(3):
        out = slc(out, 1 + d, slice(g - 1, out.shape[1 + d] - (g - 1)))
    return out
