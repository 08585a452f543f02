"""SharpClaw semidiscretization in 1D, 2D and 3D, plain PyTorch around
the WENO5 kernel.

Counterpart of ``pyclaw_tpu/sharpclaw/kernels.py`` (``_recon :31-43``,
``_recon_char_tvd :46``, ``_interface_waves :69``, ``_shift_ifc :82``,
``_recon_wave :94`` (TVD and WENO forms), ``_recon_char :169``,
``_recon_char_ifc :184``, ``_recon_char_trans :226``; ``dq_1d
:270-349`` with ``lim_type`` 0, 1 and 2, ``char_decomp`` 0-4 and
``tfluct``; ``dq_nd :352-381``), the rebuild of reference
``sharpclaw/flux1.f90``, ``flux2.f90`` and ``flux3.f90``: reconstruct
cell-edge values, componentwise with WENO of odd order 5-17 (order 5:
``ops.weno.weno5``, the CUDA kernel ``csrc/weno5.cu`` on a card,
``limiters/recon.py:weno5`` on the CPU; orders 7-17:
``limiters/recon.py:weno``), TVD (``lim_type=1``, ``recon.tvd2`` with the
solver's ``tvd_limiter``) or first order (``lim_type=0``: the cell
averages), or, with ``char_decomp``, on the Riemann waves (1), the
cells' characteristic fields (2), the jumps transmitted into each cell's
fields (3) or the interfaces' characteristic fields (4), in their WENO or
TVD forms (the TVD form of 2-4 is the cells' characteristic TVD, as in
the JAX package); fall back to first order in a cell whose edge state is
not admissible (the ``positivity`` hook), solve the Riemann problems at
the interfaces, add the in-cell total fluctuation and assemble

    dq_i = -dt/(kappa_i dx) (apdq_{i-1/2} + amdq_{i+1/2} + adq_i).

The total fluctuation adq_i is a user ``tfluct`` hook's when the solver
passes one (``tfluct_solver``), else f(qr_i) - f(ql_i) from the record's
``flux`` hook when it has one, else a second Riemann solve on (ql_i,
qr_i) summing amdq + apdq.  Everything but the componentwise WENO5 stays
plain tensor operations, as the JAX package leaves it to XLA (its
``_recon`` reaches a Pallas kernel at order 5 only): the other orders,
the TVD forms and the characteristic reconstructions too (each of those
projects every stencil onto its own cell's or interface's eigenvectors,
so the fields do not form the one shifted array that ``weno5.cu``
takes).  Products with the eigenvector matrices and sums over the wave
and equation axes are explicit adds in a fixed order.  :func:`dq_nd` runs
:func:`dq_1d` along each axis in turn (no transverse solves) and sums the
parts in the axis order, as the JAX package does; its row-tiled wrapper
``dq_nd_tiled :384``, which fits the TPU's VMEM and gives the same bits,
is not ported.
"""

from __future__ import annotations

import torch

from ..classic.kernels import _dtdx_arr
from ..limiters import recon
from ..limiters.tvd import _phi
from ..ops import weno


def _recon(qbc, lim_type, weno_order, tvd_limiter=4):
    """Cell-edge values (ql, qr) of every cell of ``qbc`` along its last
    axis, componentwise: WENO (``lim_type=2``; order 5 through
    ``ops.weno.weno5``), TVD (1) or the cell averages (0)."""
    if lim_type == 2:
        if weno_order == 5:
            return weno.weno5(qbc)
        return recon.weno(weno_order, qbc)
    if lim_type == 1:
        return recon.tvd2(qbc, limiter_id=tvd_limiter)
    if lim_type == 0:
        return qbc, qbc
    raise ValueError(f"bad lim_type {lim_type}")


def _matvec(M, v):
    """out[a] = sum_b M[a, b] v[b], the sum in order of b: M (n, n, ...)
    per cell, or (n, n) constant (a CPU tensor of scalars); v (n, ...)."""
    n = M.shape[0]
    out = []
    for a in range(n):
        acc = M[a, 0] * v[0]
        for b in range(1, n):
            acc = acc + M[a, b] * v[b]
        out.append(acc)
    return torch.stack(out)


def _dot0(a, b):
    """sum over axis 0 of a * b, in order."""
    acc = a[0] * b[0]
    for k in range(1, a.shape[0]):
        acc = acc + a[k] * b[k]
    return acc


def _recon_char_tvd(qbc, auxbc, params, evec, ixy, tvd_limiter):
    """Characteristic-wise TVD (reference reconstruct.f90 tvd2_char): the
    cell's characteristic components w = L q of its 3-cell stencil slope
    limited, and the edge values transformed back."""
    R, L = evec(ixy, qbc, auxbc, params)
    w_m, w_0, w_p = (_matvec(L, recon._shift(qbc, m)) for m in (-1, 0, 1))
    slope = recon.tvd_slope(w_0 - w_m, w_p - w_0, tvd_limiter)
    return _matvec(R, w_0 - 0.5 * slope), _matvec(R, w_0 + 0.5 * slope)


def _interface_waves(qbc, auxbc, params, rp, ixy):
    """The Riemann waves at every interface along the last axis: (num_eqn,
    num_waves, ..., n-1), interface k between cells k and k+1."""
    aux_l = aux_r = None
    if auxbc is not None:
        aux_l, aux_r = auxbc[..., :-1], auxbc[..., 1:]
    wave, _, _, _ = rp(ixy, qbc[..., :-1], qbc[..., 1:], aux_l, aux_r, params)
    return wave


def _shift_ifc(a, m):
    """An interface-indexed array shifted by ``m`` along its last axis,
    zero-filled (zero waves beyond the ends; that band is trimmed)."""
    if m == 0:
        return a
    z = torch.zeros_like(a[..., :abs(m)])
    if m > 0:
        return torch.cat([a[..., m:], z], dim=-1)
    return torch.cat([z, a[..., :m]], dim=-1)


def _recon_wave(qbc, auxbc, params, rp, ixy, lim_type, weno_order,
                tvd_limiter=4):
    """Wave-slope reconstruction (reference reconstruct.f90 tvd2_wave,
    weno.f90 weno5_wave; char_decomp=1).  TVD form (``lim_type=1``): cell
    i's slope is sum_p phi(theta_p) W^p at its right interface, theta_p
    the left neighbour's projection ratio <W_{I-1}, W_I> / |W_I|^2.  WENO
    form: for each wave family and target interface I, the neighbouring
    interfaces' waves projected onto W_I give relative strengths T_m =
    <W_{I+m}, W_I> / |W_I|^2, whose cumulative sums form a pseudo-field
    with a unit jump at I; its WENO edge value is the fraction of W_I
    added to the cell average."""
    wave = _interface_waves(qbc, auxbc, params, rp, ixy)
    num_waves = wave.shape[1]
    wnorm2 = _dot0(wave, wave)                     # (nw, ..., n-1)
    safe = wnorm2 > 0.0
    inv = torch.where(safe, 1.0 / torch.where(safe, wnorm2, 1.0), 0.0)

    if lim_type == 1:
        theta = _dot0(_shift_ifc(wave, -1), wave) * inv
        phi = torch.where(safe, _phi(tvd_limiter, theta), 0.0)
        slope_ifc = phi[0][None] * wave[:, 0]      # (ne, ..., n-1)
        for p in range(1, num_waves):
            slope_ifc = slope_ifc + phi[p][None] * wave[:, p]
        # cell i's slope lives at its right interface (index i)
        slope = torch.cat([slope_ifc, torch.zeros_like(slope_ifc[..., :1])],
                          dim=-1)
        return qbc - 0.5 * slope, qbc + 0.5 * slope

    k = (weno_order + 1) // 2
    T = {m: (_dot0(_shift_ifc(wave, m), wave) * inv if m != 0
             else safe.to(wnorm2.dtype))
         for m in range(-k + 1, k)}

    def pseudo(j):
        # v_0 = 0 (the cell left of I), v_{j+1} - v_j = T_j
        if j == 0:
            return torch.zeros_like(T[0])
        if j > 0:
            return sum(T[m] for m in range(0, j))
        return -sum(T[m] for m in range(j, 0))

    # the right edge of cell i: target interface i, cell i pseudo-cell 0
    _, ps_r = recon.weno_stencil(weno_order,
                                 [pseudo(j) for j in range(-k + 1, k)])
    # the left edge of cell i: target interface i-1, cell i pseudo-cell 1
    ps_l, _ = recon.weno_stencil(
        weno_order, [pseudo(j) - 1.0 for j in range(-k + 2, k + 1)])

    def contrib(ps):
        acc = ps[0][None] * wave[:, 0]
        for p in range(1, num_waves):
            acc = acc + ps[p][None] * wave[:, p]
        return acc

    contrib_r = contrib(ps_r)                      # at interface i
    contrib_l = contrib(ps_l)                      # at interface i-1
    zero = torch.zeros_like(contrib_r[..., :1])
    qr = qbc + torch.cat([contrib_r, zero], dim=-1)
    ql = qbc + torch.cat([zero, contrib_l], dim=-1)
    return ql, qr


def _recon_char(qbc, auxbc, params, evec, ixy, weno_order):
    """Characteristic-wise WENO (reference weno5_char; char_decomp=2):
    each cell's stencil projected onto that cell's eigenvectors,
    reconstructed field by field and transformed back."""
    R, L = evec(ixy, qbc, auxbc, params)
    k = (weno_order + 1) // 2
    ws = [_matvec(L, recon._shift(qbc, m)) for m in range(-k + 1, k)]
    wl, wr = recon.weno_stencil(weno_order, ws)
    return _matvec(R, wl), _matvec(R, wr)


def _recon_char_ifc(qbc, auxbc, params, evec, ixy, weno_order):
    """Interface-basis characteristic WENO (char_decomp=4): the
    eigensystem at the mean of each interface's two cells, and both
    biased edge states of that interface reconstructed in it."""
    q_avg = 0.5 * (qbc[..., :-1] + qbc[..., 1:])
    aux_avg = (None if auxbc is None
               else 0.5 * (auxbc[..., :-1] + auxbc[..., 1:]))
    R, L = evec(ixy, q_avg, aux_avg, params)       # (ne, ne, ..., n-1)
    k = (weno_order + 1) // 2

    def proj(m):
        # the interface-indexed view of cell i+m for interface i
        return _matvec(L, recon._shift(qbc, m)[..., :-1])

    # the left state at interface i: the right edge of cell i
    _, wr = recon.weno_stencil(weno_order,
                               [proj(m) for m in range(-k + 1, k)])
    # the right state at interface i: the left edge of cell i+1
    wl, _ = recon.weno_stencil(weno_order,
                               [proj(m + 1) for m in range(-k + 1, k)])
    edge_l = _matvec(R, wr)
    edge_r = _matvec(R, wl)
    # back to the per-cell (ql, qr); the outermost edges lie in the
    # trimmed ghost band
    qr = torch.cat([edge_l, qbc[..., -1:]], dim=-1)
    ql = torch.cat([qbc[..., :1], edge_r], dim=-1)
    return ql, qr


def _recon_char_trans(qbc, auxbc, params, evec, ixy, weno_order):
    """Transmission-based characteristic WENO (reference weno5_trans;
    char_decomp=3): each interface jump projected onto the target cell's
    left eigenvectors; the cumulative sums of those transmitted strengths
    form per-family pseudo-fields (zero at the cell) whose WENO edge
    values are added back through the cell's R."""
    R, L = evec(ixy, qbc, auxbc, params)
    k = (weno_order + 1) // 2
    dq = qbc[..., 1:] - qbc[..., :-1]
    dq_pad = torch.cat([dq, torch.zeros_like(dq[..., :1])], dim=-1)
    # alpha_m[..., i] = L_i (the jump m interfaces away)
    alpha = {m: _matvec(L, _shift_ifc(dq_pad, m))
             for m in range(-k + 1, k - 1)}

    def pseudo(j):
        # v_j - v_{j-1} = alpha_{j-1}; v_0 = 0 (the cell itself)
        if j == 0:
            return torch.zeros_like(qbc)
        if j > 0:
            return sum(alpha[m] for m in range(0, j))
        return -sum(alpha[m] for m in range(j, 0))

    wl, wr = recon.weno_stencil(weno_order,
                                [pseudo(j) for j in range(-k + 1, k)])
    return qbc + _matvec(R, wl), qbc + _matvec(R, wr)


def _reconstruct(qbc, auxbc, params, rp, ixy, lim_type, weno_order,
                 char_decomp, evec, tvd_limiter):
    """The cell-edge values of :func:`dq_1d`, dispatched as the JAX
    package's ``dq_1d :281-307``: ``char_decomp`` 1 on the waves (TVD or
    WENO); 2-4 with ``evec`` in their WENO forms at ``lim_type=2`` and the
    cells' characteristic TVD at ``lim_type=1``; else componentwise."""
    if char_decomp == 1:
        return _recon_wave(qbc, auxbc, params, rp, ixy, lim_type,
                           weno_order, tvd_limiter)
    if char_decomp in (2, 3, 4) and evec is not None:
        if lim_type == 2:
            fn = {2: _recon_char, 3: _recon_char_trans,
                  4: _recon_char_ifc}[char_decomp]
            return fn(qbc, auxbc, params, evec, ixy, weno_order)
        if lim_type == 1:
            return _recon_char_tvd(qbc, auxbc, params, evec, ixy,
                                   tvd_limiter)
    return _recon(qbc, lim_type, weno_order, tvd_limiter)


def dq_1d(qbc, auxbc, dt, dx, rp, params, lim_type, weno_order, index_capa,
          num_ghost, ixy=0, positivity=None, flux=None, char_decomp=0,
          evec=None, tfluct=None, tvd_limiter=4):
    """Semidiscrete update along the LAST axis (flux1.f90).

    qbc: (num_eqn, ..., n) ghost-padded; auxbc (num_aux, ..., n) or None;
    ``dt`` a Python float or a 0-d tensor; ``rp`` the normal solver (its
    waves also feed ``char_decomp=1``), ``evec`` the eigenvector hook of
    ``char_decomp`` 2-4; ``tfluct(ixy, ql, qr, aux_l, aux_r, params)``
    the in-cell total fluctuation, or None; ``tvd_limiter`` the limiter
    id of ``lim_type=1``.  Returns (dq over the interior along the last
    axis, with the dt factor included, cfl)."""
    g = num_ghost
    n = qbc.shape[-1]

    ql, qr = _reconstruct(qbc, auxbc, params, rp, ixy, lim_type, weno_order,
                          char_decomp, evec, tvd_limiter)
    if positivity is not None:
        # per-cell first-order fallback where a reconstructed edge state
        # would be unphysical
        ok = positivity(ql, auxbc, params) & positivity(qr, auxbc, params)
        ql = torch.where(ok[None], ql, qbc)
        qr = torch.where(ok[None], qr, qbc)

    # interface k between cells k, k+1: states (qr_k, ql_{k+1})
    aux_l = aux_r = None
    if auxbc is not None:
        aux_l, aux_r = auxbc[..., :-1], auxbc[..., 1:]
    wave, s, amdq, apdq = rp(ixy, qr[..., :-1], ql[..., 1:], aux_l, aux_r,
                             params)

    # in-cell total fluctuation
    if tfluct is not None:
        adq = tfluct(ixy, ql, qr, auxbc, auxbc, params)
    elif flux is not None:
        adq = flux(ixy, qr, auxbc, params) - flux(ixy, ql, auxbc, params)
    else:
        _, _, amdq2, apdq2 = rp(ixy, ql, qr, auxbc, auxbc, params)
        adq = amdq2 + apdq2

    capa = auxbc[index_capa] if index_capa >= 0 else None
    dtdx = _dtdx_arr(dt, dx, capa, qbc)
    s_int = s[..., g - 1:n - g]
    if capa is None:
        cfl = torch.amax(torch.maximum(s_int * dtdx, -s_int * dtdx))
        dtdx_c = dtdx
    else:
        cfl = torch.amax(torch.maximum(s_int * dtdx[..., g:n - g + 1],
                                       -s_int * dtdx[..., g - 1:n - g]))
        dtdx_c = dtdx[..., 1:-1]

    # cells 1..n-2: apdq at the left interface (k=i-1), amdq at the right
    dq_cells = -dtdx_c * (apdq[..., :-1] + amdq[..., 1:] + adq[..., 1:-1])
    return dq_cells[..., g - 1:n - 1 - g], cfl


def dq_nd(qbc, auxbc, dt, deltas, rp, params, lim_type, weno_order,
          index_capa, num_ghost, positivity=None, flux=None, char_decomp=0,
          evec=None, tfluct=None, tvd_limiter=4):
    """Multi-dimensional method-of-lines update (flux2.f90 / flux3.f90):
    :func:`dq_1d` along each spatial axis of ``qbc`` (num_eqn, *n)
    ghost-padded, the axis moved last (a contiguous copy, which
    ``ops.weno.weno5`` needs on a card), each part stripped of the other
    axes' ghost cells and summed in the axis order.  Returns (dq over the
    interior cells with the dt factor included, cfl: the maximum over the
    axes)."""
    g = num_ghost
    num_dim = qbc.dim() - 1
    dq_total = cfl = None
    for d in range(num_dim):
        axis = 1 + d
        qm = qbc.movedim(axis, -1).contiguous()
        auxm = None if auxbc is None else auxbc.movedim(axis, -1)
        dqd, cfld = dq_1d(qm, auxm, dt, deltas[d], rp, params, lim_type,
                          weno_order, index_capa, g, ixy=d,
                          positivity=positivity, flux=flux,
                          char_decomp=char_decomp, evec=evec, tfluct=tfluct,
                          tvd_limiter=tvd_limiter)
        dqd = dqd.movedim(-1, axis)
        sl = [slice(None)] * dqd.dim()
        for d2 in range(num_dim):
            if d2 != d:
                sl[1 + d2] = slice(g, dqd.shape[1 + d2] - g)
        dqd = dqd[tuple(sl)]
        dq_total = dqd if dq_total is None else dq_total + dqd
        cfl = cfld if cfl is None else torch.maximum(cfl, cfld)
    return dq_total, cfl
