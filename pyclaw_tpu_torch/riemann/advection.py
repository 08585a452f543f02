"""Constant-coefficient advection Riemann solvers, plain PyTorch.

Counterpart of ``pyclaw_tpu/riemann/advection.py`` (``_upwind :15``,
``_rp_advection :22``, ``_rpt_advection :29``, ``_rptt_advection :42``,
``_flux_advection :101``, the records ``advection_1D :108`` and
``advection_3D :112`` with their ``flux`` hooks ``:115-116``), physics of
reference ``rp1_advection.f90``: the color equation q_t + u q_x = 0, one
wave W = q_r - q_l with speed u, fluctuations amdq = min(u, 0) W and
apdq = max(u, 0) W; the transverse and double-transverse splits take the
velocity along their axis in the same way.  The CUDA kernels repeat it:
``csrc/step1.cu`` in ``csrc/systems1d.cuh`` (``Advection1D``),
``csrc/step3_aos.cu`` in ``csrc/acoustics3d.cuh`` (``Advection3D``).  The
2D and variable-coefficient records are queued in ROADMAP.md.
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


def _flux_advection(ixy, q, aux, params):
    """f = u_ixy * q (RiemannSolver.flux protocol)."""
    return params[("u", "v", "w")[ixy]] * q


from . import RiemannSolver  # noqa: E402

advection_1D = RiemannSolver("advection_1D", 1, 1, 1, _rp_advection,
                             requires=("u",))
advection_3D = RiemannSolver("advection_3D", 3, 1, 1, _rp_advection,
                             rpt=_rpt_advection, rptt=_rptt_advection,
                             requires=("u", "v", "w"))
for _s in (advection_1D, advection_3D):
    _s.flux = _flux_advection
