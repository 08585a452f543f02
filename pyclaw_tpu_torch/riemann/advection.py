"""Constant-coefficient advection Riemann solver, plain PyTorch.

Counterpart of ``pyclaw_tpu/riemann/advection.py`` (``_upwind :15``,
``_rp_advection :22``, ``_flux_advection :101``, the record
``advection_1D :108`` with its ``flux`` hook ``:115-116``), physics of
reference ``rp1_advection.f90``: the color equation q_t + u q_x = 0, one
wave W = q_r - q_l with speed u, fluctuations amdq = min(u, 0) W and
apdq = max(u, 0) W.  The CUDA kernel ``csrc/step1.cu`` repeats it in
``csrc/systems1d.cuh`` (``Advection1D``).  The 2D/3D and
variable-coefficient records are queued in ROADMAP.md.
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


def _flux_advection(ixy, q, aux, params):
    """f = u_ixy * q (RiemannSolver.flux protocol)."""
    return params[("u", "v", "w")[ixy]] * q


from . import RiemannSolver  # noqa: E402

advection_1D = RiemannSolver("advection_1D", 1, 1, 1, _rp_advection,
                             requires=("u",))
advection_1D.flux = _flux_advection
