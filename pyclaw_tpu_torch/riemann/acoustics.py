"""Linear acoustics Riemann solvers, 1D and 3D, plain PyTorch.

Counterpart of ``pyclaw_tpu/riemann/acoustics.py`` (``_zc :21``,
``_rp_acoustics :28-53``, ``_rpt3_acoustics :107-121``,
``_flux_acoustics :149-157``, ``_rptt3_acoustics :181-188``, the records
``acoustics_1D :171-172`` and ``acoustics_3D :191-194``), physics of
reference ``rp1_acoustics.f90``: p_t + K div(u) = 0, rho u_t + grad p = 0
with impedance Z = sqrt(rho K) and sound speed c = sqrt(K / rho) from
problem_data {'rho', 'bulk'} (or the precomputed {'zz', 'cc'}).  q =
(p, u) in 1D, (p, u, v, w) in 3D; two waves of speeds -c and +c.  The 3D
transverse split decomposes a fluctuation along ``trans_axis`` with the
same eigenstructure, and the double-transverse split is the same split
along the third axis.  The CUDA kernels repeat them: ``csrc/step1.cu`` in
``csrc/systems1d.cuh`` (``Acoustics1D``), ``csrc/step3_aos.cu`` in
``csrc/acoustics3d.cuh`` (``Acoustics3D``).  The ``evec`` hook
(char_decomp) and the 2D record are queued in ROADMAP.md.
"""

from __future__ import annotations

import math

import torch


def _zc(params):
    if "zz" in params:
        return params["zz"], params["cc"]
    rho, bulk = params["rho"], params["bulk"]
    return math.sqrt(rho * bulk), math.sqrt(bulk / rho)


def _rp_acoustics(ixy, q_l, q_r, aux_l, aux_r, params):
    zz, cc = _zc(params)
    num_eqn = q_l.shape[0]
    mu = 1 + ixy                     # normal-velocity component
    dq = q_r - q_l
    a1 = (-dq[0] + zz * dq[mu]) / (2.0 * zz)    # left-going strength
    a2 = (dq[0] + zz * dq[mu]) / (2.0 * zz)     # right-going strength

    zero = torch.zeros_like(a1)
    w1 = [zero] * num_eqn
    w1[0], w1[mu] = -a1 * zz, a1
    w2 = [zero] * num_eqn
    w2[0], w2[mu] = a2 * zz, a2
    wave = torch.stack([torch.stack(w1), torch.stack(w2)], dim=1)

    shape = dq.shape[1:]
    s = torch.stack([torch.full(shape, -cc, dtype=dq.dtype, device=dq.device),
                     torch.full(shape, cc, dtype=dq.dtype, device=dq.device)])
    amdq = -cc * wave[:, 0]
    apdq = cc * wave[:, 1]
    return wave, s, amdq, apdq


def _rpt3_acoustics(ixy, imp, q_l, q_r, aux_l, aux_r, asdq, params,
                    trans_axis=None):
    """3D transverse split along ``trans_axis`` (defaults to the next
    axis)."""
    zz, cc = _zc(params)
    if trans_axis is None:
        trans_axis = (ixy + 1) % 3
    mv = 1 + trans_axis
    a1 = (-asdq[0] + zz * asdq[mv]) / (2.0 * zz)
    a2 = (asdq[0] + zz * asdq[mv]) / (2.0 * zz)
    zero = torch.zeros_like(a1)
    bm = [zero] * asdq.shape[0]
    bm[0], bm[mv] = cc * a1 * zz, -cc * a1
    bp = [zero] * asdq.shape[0]
    bp[0], bp[mv] = cc * a2 * zz, cc * a2
    return torch.stack(bm), torch.stack(bp)


def _rptt3_acoustics(ixy, icoor, imp, impt, q_l, q_r, aux_l, aux_r,
                     bsasdq, params, trans_axis=None):
    """Double-transverse split: the same eigenstructure, along the third
    axis (reference rptt3_acoustics)."""
    if trans_axis is None:
        trans_axis = (ixy + 2) % 3
    return _rpt3_acoustics(ixy, imp, q_l, q_r, aux_l, aux_r, bsasdq,
                           params, trans_axis=trans_axis)


def _flux_acoustics(ixy, q, aux, params):
    """Linear acoustic flux along ixy: f = [K u_n, p/rho, 0...] with
    K = zz*cc, rho = zz/cc (RiemannSolver.flux protocol)."""
    zz, cc = _zc(params)
    mu = 1 + ixy
    zero = torch.zeros_like(q[0])
    f = [zero] * q.shape[0]
    f[0], f[mu] = (zz * cc) * q[mu], (cc / zz) * q[0]
    return torch.stack(f)


from . import RiemannSolver  # noqa: E402

acoustics_1D = RiemannSolver("acoustics_1D", 1, 2, 2, _rp_acoustics)
acoustics_1D.flux = _flux_acoustics
acoustics_3D = RiemannSolver("acoustics_3D", 3, 4, 2, _rp_acoustics,
                             rpt=_rpt3_acoustics, rptt=_rptt3_acoustics)
acoustics_3D.flux = _flux_acoustics
