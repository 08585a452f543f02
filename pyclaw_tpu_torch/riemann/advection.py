"""Advection Riemann solvers (constant and variable coefficient), plain
PyTorch.

Counterpart of ``pyclaw_tpu/riemann/advection.py`` (``_upwind :15``,
``_rp_advection :22``, ``_rpt_advection :29``, ``_rptt_advection :42``,
``_rpt_vc_advection :55-74``, ``_rp_vc_advection :76-84``,
``_rp_vc_advection_fwave :86-98``, ``_flux_advection :101``, the records
``advection_1D :108``, ``advection_2D :110``, ``advection_3D :112`` with
their ``flux`` hooks ``:115-116``, ``vc_advection_1D :117``,
``vc_advection_fwave_1D :118``, ``vc_advection_2D :120`` and
``vc_advection_fwave_2D :122``), physics of reference
``rp1_advection.f90`` and ``rpn2_vc_advection.f90``: the color equation
q_t + u q_x = 0, one wave W = q_r - q_l with speed u, fluctuations
amdq = min(u, 0) W and apdq = max(u, 0) W; the transverse and
double-transverse splits take the velocity along their axis in the same
way.  The variable-coefficient records read the edge velocities from
aux (``vc_advection_2D``) or, in the f-wave form, the cell velocities
(``vc_advection_fwave_2D``).  The CUDA kernels repeat them:
``csrc/step1.cu`` in ``csrc/systems1d.cuh`` (``Advection1D``,
``VcAdvection1D``, ``VcAdvectionFwave1D``),
``csrc/step2_aos.cu`` in ``csrc/scalar2d.cuh`` (``Advection2D``,
``VcAdvection2D``, ``VcAdvectionFwave2D``), ``csrc/step3_aos.cu`` in
``csrc/acoustics3d.cuh`` (``Advection3D``).
"""

from __future__ import annotations

import torch


def _upwind(dq, s):
    wave = dq[:, None]                      # (1, 1, *n)
    amdq = torch.clamp(s, max=0.0) * dq
    apdq = torch.clamp(s, min=0.0) * dq
    return wave, s[None], amdq, apdq


def _rp_advection(ixy, q_l, q_r, aux_l, aux_r, params):
    u = params[("u", "v", "w")[ixy]]
    dq = q_r - q_l
    s = torch.full_like(dq[0], u)
    return _upwind(dq, s)


def _rpt_advection(ixy, imp, q_l, q_r, aux_l, aux_r, asdq, params,
                   trans_axis=None):
    """Split asdq by the velocity along ``trans_axis`` (default: the other
    coordinate in 2D)."""
    if trans_axis is None:
        trans_axis = 1 - ixy
    ut = params[("u", "v", "w")[trans_axis]]
    return min(ut, 0.0) * asdq, max(ut, 0.0) * asdq


def _rptt_advection(ixy, icoor, imp, impt, q_l, q_r, aux_l, aux_r,
                    bsasdq, params, trans_axis=None):
    """Double-transverse split along ``trans_axis`` (the third
    coordinate)."""
    if trans_axis is None:
        trans_axis = [d for d in range(3) if d != ixy][icoor - 2] \
            if icoor >= 2 else (ixy + 2) % 3
    ut = params[("u", "v", "w")[trans_axis]]
    return min(ut, 0.0) * bsasdq, max(ut, 0.0) * bsasdq


def _rpt_vc_advection(ixy, imp, q_l, q_r, aux_l, aux_r, asdq, params,
                      trans_axis=None):
    """Variable-coefficient transverse split (reference
    rpt2_vc_advection.f90): the fluctuation entering cell i1 (the left
    cell for imp=1, the right for imp=2) is split by that cell's
    transverse EDGE velocities, aux[kv] at its lower transverse edge for
    the down-going part and the next cell's aux[kv] (its upper edge) for
    the up-going part.  aux is sliced only along the normal axis, so the
    neighbour is a shift along ``trans_axis``; the wrapped edge row is
    never read by the transverse gather (it drops the last transverse
    row)."""
    if trans_axis is None:
        trans_axis = 1 - ixy
    aux_c = aux_l if imp == 1 else aux_r
    v_lo = aux_c[trans_axis]                        # its lower edge
    v_hi = torch.roll(v_lo, -1, dims=trans_axis)     # its upper edge
    return (torch.clamp(v_lo, max=0.0) * asdq,
            torch.clamp(v_hi, min=0.0) * asdq)


def _rp_vc_advection(ixy, q_l, q_r, aux_l, aux_r, params):
    """Variable-coefficient color equation q_t + u(x) q_x = 0: aux[ixy]
    holds the edge velocity at each cell's lower interface (reference
    rpn2_vc_advection.f90)."""
    u = aux_r[ixy]          # the velocity at the shared interface
    dq = q_r - q_l
    return _upwind(dq, u)


def _rp_vc_advection_fwave(ixy, q_l, q_r, aux_l, aux_r, params):
    """f-wave solver of the conservative q_t + (u(x) q)_x = 0 with
    CELL-CENTERED velocities aux[ixy]: the wave carries the flux
    difference Z = u_r q_r - u_l q_l, split by the sign of the average
    speed (use with ``solver.fwave = True``)."""
    u_l, u_r = aux_l[ixy], aux_r[ixy]
    z = u_r * q_r - u_l * q_l
    s = 0.5 * (u_l + u_r)
    zero = torch.zeros_like(z)
    amdq = torch.where(s < 0.0, z, zero)
    apdq = torch.where(s >= 0.0, z, zero)
    return z[:, None], s[None], amdq, apdq


def _flux_advection(ixy, q, aux, params):
    """f = u_ixy * q (RiemannSolver.flux protocol)."""
    return params[("u", "v", "w")[ixy]] * q


from . import RiemannSolver  # noqa: E402

advection_1D = RiemannSolver("advection_1D", 1, 1, 1, _rp_advection,
                             requires=("u",))
advection_2D = RiemannSolver("advection_2D", 2, 1, 1, _rp_advection,
                             rpt=_rpt_advection, requires=("u", "v"))
advection_3D = RiemannSolver("advection_3D", 3, 1, 1, _rp_advection,
                             rpt=_rpt_advection, rptt=_rptt_advection,
                             requires=("u", "v", "w"))
for _s in (advection_1D, advection_2D, advection_3D):
    _s.flux = _flux_advection
vc_advection_1D = RiemannSolver("vc_advection_1D", 1, 1, 1, _rp_vc_advection)
vc_advection_fwave_1D = RiemannSolver("vc_advection_fwave_1D", 1, 1, 1,
                                      _rp_vc_advection_fwave)
vc_advection_2D = RiemannSolver("vc_advection_2D", 2, 1, 1, _rp_vc_advection,
                                rpt=_rpt_vc_advection)
vc_advection_fwave_2D = RiemannSolver("vc_advection_fwave_2D", 2, 1, 1,
                                      _rp_vc_advection_fwave,
                                      rpt=_rpt_vc_advection)
