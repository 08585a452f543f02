"""SharpClaw semidiscretization in 1D, plain PyTorch around the WENO5
kernel.

Counterpart of ``pyclaw_tpu/sharpclaw/kernels.py`` (``_recon :31-43`` for
``lim_type=2``, ``weno_order=5``; ``dq_1d :270-349`` for
``char_decomp=0``), the rebuild of reference ``sharpclaw/flux1.f90``:
reconstruct cell-edge values with WENO5 (``ops.weno.weno5``: the CUDA
kernel ``csrc/weno5.cu`` on a card, ``limiters/recon.py:weno5`` on the
CPU), fall back to first order in a cell whose edge state is not
admissible (the ``positivity`` hook), solve the Riemann problems at the
interfaces, add the in-cell total fluctuation and assemble

    dq_i = -dt/(kappa_i dx) (apdq_{i-1/2} + amdq_{i+1/2} + adq_i).

The total fluctuation adq_i = f(qr_i) - f(ql_i) uses the record's ``flux``
hook when it has one, else a second Riemann solve on (ql_i, qr_i) summing
amdq + apdq.  Everything but the reconstruction stays plain tensor
operations, as the JAX package leaves it to XLA.  The other
reconstructions (TVD, char_decomp 1-4, WENO orders 7-17) and ``dq_nd``
raise or are queued in ROADMAP.md.
"""

from __future__ import annotations

import torch

from ..classic.kernels import _dtdx_arr
from ..ops import weno
from ..solver import _not_ported


def _recon(qbc, lim_type, weno_order):
    """Cell-edge values (ql, qr) of every cell of ``qbc`` along its last
    axis: WENO5, the only reconstruction ported."""
    if lim_type != 2:
        raise _not_ported("lim_type=1")
    if weno_order != 5:
        raise _not_ported("weno_order 7-17")
    return weno.weno5(qbc)


def dq_1d(qbc, auxbc, dt, dx, rp, params, lim_type, weno_order, index_capa,
          num_ghost, ixy=0, positivity=None, flux=None):
    """Semidiscrete update along the LAST axis (flux1.f90).

    qbc: (num_eqn, ..., n) ghost-padded; auxbc (num_aux, ..., n) or None;
    ``dt`` a Python float or a 0-d tensor.  Returns (dq over the interior
    along the last axis, with the dt factor included, cfl)."""
    g = num_ghost
    n = qbc.shape[-1]

    ql, qr = _recon(qbc, lim_type, weno_order)
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
    if flux is not None:
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
