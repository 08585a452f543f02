"""Linear acoustics Riemann solvers, 1D, 2D and 3D, plain PyTorch.

Counterpart of ``pyclaw_tpu/riemann/acoustics.py`` (``_zc :21``,
``_rp_acoustics :28-53``, ``_rpt_acoustics :54-71``, ``_rp_acoustics_soa
:73-90``, ``_rpt_acoustics_soa :92-105``, ``_rpt3_acoustics :107-121``,
``_evec_acoustics :124-147``, ``_flux_acoustics :149-157``,
``_flux_acoustics_soa :160-166``, ``_rptt3_acoustics :181-188``, the
records ``acoustics_1D :171-173``, ``acoustics_2D :174-180`` and
``acoustics_3D :191-194``), physics of reference ``rp1_acoustics.f90``,
``rpn2_acoustics.f90`` and ``rpt2_acoustics.f90``: p_t + K div(u) = 0,
rho u_t + grad p = 0 with impedance Z = sqrt(rho K) and sound speed c =
sqrt(K / rho) from problem_data {'rho', 'bulk'} (or the precomputed {'zz',
'cc'}).  q = (p, u) in 1D, (p, u, v) in 2D, (p, u, v, w) in 3D; two waves
of speeds -c and +c.  The transverse splits decompose a fluctuation along
the transverse axis with the same eigenstructure, and the 3D
double-transverse split is the same split along the third axis.  The
CUDA kernels repeat them: ``csrc/step1.cu`` in ``csrc/systems1d.cuh``
(``Acoustics1D``), ``csrc/step2_aos.cu`` in ``csrc/acoustics2d.cuh``
(``Acoustics2D``), ``csrc/step3_aos.cu`` in ``csrc/acoustics3d.cuh``
(``Acoustics3D``).
"""

from __future__ import annotations

import math

import numpy as np
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


def _rpt_acoustics(ixy, imp, q_l, q_r, aux_l, aux_r, asdq, params):
    """Split the fluctuation asdq into its transverse-going parts
    (reference rpt2_acoustics.f90)."""
    zz, cc = _zc(params)
    if asdq.shape[0] != 3:
        raise ValueError("rpt2 acoustics expects 3-component q")
    mv = 2 - ixy                                   # transverse component
    a1 = (-asdq[0] + zz * asdq[mv]) / (2.0 * zz)   # down-going
    a2 = (asdq[0] + zz * asdq[mv]) / (2.0 * zz)    # up-going

    zero = torch.zeros_like(a1)
    bm = [zero] * asdq.shape[0]
    bm[0], bm[mv] = cc * a1 * zz, -cc * a1         # -c * (-Z a1)
    bp = [zero] * asdq.shape[0]
    bp[0], bp[mv] = cc * a2 * zz, cc * a2
    return torch.stack(bm), torch.stack(bp)


# ---- SoA variants (classic/soa.py protocol) --------------------------
def _rp_acoustics_soa(ixy, q_l, q_r, params):
    zz, cc = _zc(params)
    mu = 1 + ixy
    dp = q_r[0] - q_l[0]
    dv = q_r[mu] - q_l[mu]
    a1 = (-dp + zz * dv) / (2.0 * zz)
    a2 = (dp + zz * dv) / (2.0 * zz)

    def mk(p_c, u_c):
        comp = [None] * len(q_l)
        comp[0] = p_c
        comp[mu] = u_c
        return tuple(comp)

    waves = (mk(-a1 * zz, a1), mk(a2 * zz, a2))
    speeds = (-cc, cc)
    return waves, speeds


def _rpt_acoustics_soa(ixy, imp, q_l, q_r, asdq, params):
    zz, cc = _zc(params)
    mv = 2 - ixy
    a1 = (-asdq[0] + zz * asdq[mv]) / (2.0 * zz)
    a2 = (asdq[0] + zz * asdq[mv]) / (2.0 * zz)
    zero = torch.zeros_like(asdq[0])
    bm = [zero] * len(q_l)
    bp = [zero] * len(q_l)
    bm[0] = cc * a1 * zz
    bm[mv] = -cc * a1
    bp[0] = cc * a2 * zz
    bp[mv] = cc * a2
    return tuple(bm), tuple(bp)


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


def _evec_acoustics(ixy, q, aux, params):
    """Eigenvector matrices (R, L) of the acoustics flux Jacobian along
    axis ``ixy`` (the SharpClaw evec hook of char_decomp): the acoustic
    waves (-Z, e_mu) and (+Z, e_mu) in the first and last columns, the
    shear components passing through.  Constant: two (n, n) CPU tensors
    in q's dtype, which broadcast against q on any device as scalars do
    (no copy to the device, so a CUDA graph can capture their use)."""
    zz, _ = _zc(params)
    n = q.shape[0]
    mu = 1 + ixy
    R = np.eye(n)
    R[:, 0] = 0.0
    R[:, n - 1] = 0.0
    R[0, 0], R[mu, 0] = -zz, 1.0
    R[0, n - 1], R[mu, n - 1] = zz, 1.0
    shear = [j for j in range(1, n) if j != mu]
    for col, j in zip(range(1, n - 1), shear):
        R[:, col] = 0.0
        R[j, col] = 1.0
    L = np.linalg.inv(R)
    return (torch.tensor(R, dtype=q.dtype), torch.tensor(L, dtype=q.dtype))


def _flux_acoustics(ixy, q, aux, params):
    """Linear acoustic flux along ixy: f = [K u_n, p/rho, 0...] with
    K = zz*cc, rho = zz/cc (RiemannSolver.flux protocol)."""
    zz, cc = _zc(params)
    mu = 1 + ixy
    zero = torch.zeros_like(q[0])
    f = [zero] * q.shape[0]
    f[0], f[mu] = (zz * cc) * q[mu], (cc / zz) * q[0]
    return torch.stack(f)


def _flux_acoustics_soa(ixy, qs, params):
    zz, cc = _zc(params)
    mu = 1 + ixy
    comp = [None] * len(qs)
    comp[0] = (zz * cc) * qs[mu]
    comp[mu] = (cc / zz) * qs[0]
    return tuple(comp)


from . import RiemannSolver  # noqa: E402

acoustics_1D = RiemannSolver("acoustics_1D", 1, 2, 2, _rp_acoustics)
acoustics_1D.flux = _flux_acoustics
acoustics_1D.evec = _evec_acoustics
acoustics_2D = RiemannSolver("acoustics_2D", 2, 3, 2, _rp_acoustics,
                             rpt=_rpt_acoustics)
acoustics_2D.evec = _evec_acoustics
acoustics_2D.rpn_soa = _rp_acoustics_soa
acoustics_2D.rpt_soa = _rpt_acoustics_soa
acoustics_2D.flux = _flux_acoustics
acoustics_2D.flux_soa = _flux_acoustics_soa
acoustics_3D = RiemannSolver("acoustics_3D", 3, 4, 2, _rp_acoustics,
                             rpt=_rpt3_acoustics, rptt=_rptt3_acoustics)
acoustics_3D.evec = _evec_acoustics
acoustics_3D.flux = _flux_acoustics
