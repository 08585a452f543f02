"""Burgers Riemann solvers in 1D, 2D and 3D, plain PyTorch.

Counterpart of ``pyclaw_tpu/riemann/burgers.py`` (``_rp_burgers :15-28``,
``_rpt_burgers :30-39``, ``_rptt_burgers :42-45``, ``_flux_burgers
:48-50``, the records ``burgers_1D :55``, ``burgers_2D :56`` and
``burgers_3D :58`` with their ``flux`` hooks ``:60-61``), physics of reference ``rp1_burgers.f90``
and ``rpt2_burgers.f90``: q_t + (q^2/2)_x + (q^2/2)_y (+ (q^2/2)_z) = 0;
one wave W = q_r - q_l with the Roe speed s = (q_l + q_r)/2, and the
entropy fix of a transonic rarefaction (q_l < 0 < q_r: amdq = -q_l^2/2,
apdq = q_r^2/2), on unless problem_data['efix'] is False.  The transverse
and double-transverse splits go by the sign of the receiving cell's own
state.  The CUDA kernels repeat them: ``csrc/step1.cu`` in
``csrc/systems1d.cuh`` (``Burgers1D``), ``csrc/step2_aos.cu`` in
``csrc/scalar2d.cuh`` (``Burgers2D``), ``csrc/step3_aos.cu`` in
``csrc/acoustics3d.cuh`` (``Burgers3D``).
"""

from __future__ import annotations

import torch


def _rp_burgers(ixy, q_l, q_r, aux_l, aux_r, params):
    dq = q_r - q_l
    s = 0.5 * (q_l[0] + q_r[0])
    amdq = torch.clamp(s, max=0.0) * dq
    apdq = torch.clamp(s, min=0.0) * dq
    if params.get("efix", True):
        transonic = (q_l[0] < 0.0) & (q_r[0] > 0.0)
        amdq = torch.where(transonic, -0.5 * q_l * q_l, amdq)
        apdq = torch.where(transonic, 0.5 * q_r * q_r, apdq)
    return dq[:, None], s[None], amdq, apdq


def _rpt_burgers(ixy, imp, q_l, q_r, aux_l, aux_r, asdq, params,
                 trans_axis=None):
    """Split asdq by the sign of the receiving cell's state (the left
    cell for imp=1, the right for imp=2; reference rpt2_burgers.f90)."""
    qc = (q_l if imp == 1 else q_r)[0]
    return torch.clamp(qc, max=0.0) * asdq, torch.clamp(qc, min=0.0) * asdq


def _rptt_burgers(ixy, icoor, imp, impt, q_l, q_r, aux_l, aux_r, bsasdq,
                  params, trans_axis=None):
    return _rpt_burgers(ixy, imp, q_l, q_r, aux_l, aux_r, bsasdq, params,
                        trans_axis=trans_axis)


def _flux_burgers(ixy, q, aux, params):
    """f = q^2/2 (RiemannSolver.flux protocol)."""
    return 0.5 * q * q


from . import RiemannSolver  # noqa: E402

burgers_1D = RiemannSolver("burgers_1D", 1, 1, 1, _rp_burgers)
burgers_2D = RiemannSolver("burgers_2D", 2, 1, 1, _rp_burgers,
                           rpt=_rpt_burgers)
burgers_3D = RiemannSolver("burgers_3D", 3, 1, 1, _rp_burgers,
                           rpt=_rpt_burgers, rptt=_rptt_burgers)
for _s in (burgers_1D, burgers_2D, burgers_3D):
    _s.flux = _flux_burgers
