"""Linear acoustics Riemann solver, 1D, plain PyTorch.

Counterpart of ``pyclaw_tpu/riemann/acoustics.py`` (``_zc :21``,
``_rp_acoustics :28-53``, ``_flux_acoustics :149-157``, the record
``acoustics_1D :171-172``), physics of reference ``rp1_acoustics.f90``:
p_t + K u_x = 0, rho u_t + p_x = 0 with impedance Z = sqrt(rho K) and
sound speed c = sqrt(K / rho) from problem_data {'rho', 'bulk'} (or the
precomputed {'zz', 'cc'}).  q = (p, u); two waves of speeds -c and +c.
The CUDA kernel ``csrc/step1.cu`` repeats the normal solve in
``csrc/systems1d.cuh`` (``Acoustics1D``).  The ``evec`` hook
(char_decomp) and the 2D/3D records are queued in ROADMAP.md.
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
