"""KPP rotating-wave Riemann solver (2D scalar, nonconvex flux), plain
PyTorch.

Counterpart of ``pyclaw_tpu/riemann/kpp.py`` (``_rp_kpp :14-37``,
``_rpt_kpp :40-46``, the record ``kpp_2D :51``), physics of reference
``rpn2_kpp.f90``: q_t + sin(q)_x + cos(q)_y = 0.  |sin'| and |cos'| are
at most 1, so the normal solve is Rusanov's with the global bound
alpha = 1 (monotone for the nonconvex flux): amdq = (df - dq) / 2,
apdq = (df + dq) / 2, one wave dq with the speed +-1 of the sign of the
average characteristic speed.  The transverse split takes the
characteristic speed at the average state.  The CUDA kernel
``csrc/step2_aos.cu`` repeats it in ``csrc/scalar2d.cuh`` (``Kpp2D``),
with the device library's ``sin`` / ``cos`` (``sinf`` / ``cosf`` in
float32), as PyTorch's ``torch.sin`` on the card.
"""

from __future__ import annotations

import torch


def _rp_kpp(ixy, q_l, q_r, aux_l, aux_r, params):
    if ixy == 0:
        f = torch.sin
        df = torch.cos
    else:
        f = torch.cos

        def df(q):
            return -torch.sin(q)

    dq = q_r - q_l
    savg = 0.5 * (df(q_l[0]) + df(q_r[0]))
    # Rusanov with the global bound of |f'| (the flux is nonconvex: |f'|
    # can peak strictly inside [q_l, q_r]); the signed speed makes the CFL
    # cover the dissipation coefficient
    alpha = torch.ones_like(savg)
    s = torch.where(savg >= 0.0, alpha, -alpha)
    dflux = f(q_r) - f(q_l)
    amdq = 0.5 * (dflux - alpha * dq)
    apdq = 0.5 * (dflux + alpha * dq)
    return dq[:, None], s[None], amdq, apdq


def _rpt_kpp(ixy, imp, q_l, q_r, aux_l, aux_r, asdq, params):
    """Split asdq by the transverse characteristic speed at the average
    state."""
    qa = 0.5 * (q_l[0] + q_r[0])
    ut = torch.cos(qa) if ixy == 0 else -torch.sin(qa)
    return torch.clamp(ut, max=0.0) * asdq, torch.clamp(ut, min=0.0) * asdq


from . import RiemannSolver  # noqa: E402

kpp_2D = RiemannSolver("kpp_2D", 2, 1, 1, _rp_kpp, rpt=_rpt_kpp)
