"""1D ideal MHD Riemann solver (HLL), plain PyTorch.

Counterpart of ``pyclaw_tpu/riemann/mhd.py`` (``_mhd_flux :23-40``,
``_fast_speed :43-50``, ``_rp_mhd_hll :53-76``, ``_mhd_positivity
:79-87``, the record ``mhd_1D :92`` and ``_flux_mhd :97-102``), capability
of reference ``riemann/src/rp1_mhd.f90``: q = (rho, rho u, rho v, rho w,
By, Bz, E) with Bx the constant problem_data['bx'] and

    p_total = p_gas + B^2/2,   E = p/(gamma-1) + rho |v|^2/2 + B^2/2.

Two HLL waves through the intermediate state, at the Davis bounds of the
fast magnetosonic speed.  The positivity hook (rho > 0 and p > 0) serves
the SharpClaw fallback; the flux hook is the solver's own flux, so that
SharpClaw's total fluctuation f(q_r) - f(q_l) matches the HLL
fluctuations' sum to roundoff.

Every expression keeps the JAX package's operation order (``bx * bx`` a
Python product, as there), so in float64 the two agree to roundoff
(tests/test_torch_riemann_1d_library.py).  The CUDA kernel repeats it:
``csrc/systems1d.cuh`` (``step1.cu``'s ``Mhd1D``).
"""

from __future__ import annotations

import torch


def _mhd_flux(q, bx, gamma):
    """(the flux (7, *n), the gas pressure) of the states q."""
    rho = q[0]
    u = q[1] / rho
    v = q[2] / rho
    w = q[3] / rho
    by, bz = q[4], q[5]
    E = q[6]
    b2 = bx * bx + by * by + bz * bz
    ke = 0.5 * rho * (u * u + v * v + w * w)
    p = (gamma - 1.0) * (E - ke - 0.5 * b2)
    pt = p + 0.5 * b2
    return torch.stack([
        q[1],
        q[1] * u + pt - bx * bx,
        q[2] * u - bx * by,
        q[3] * u - bx * bz,
        by * u - bx * v,
        bz * u - bx * w,
        (E + pt) * u - bx * (u * bx + v * by + w * bz),
    ]), p


def _fast_speed(q, bx, gamma, p):
    rho = q[0]
    a2 = gamma * p / rho
    b2r = (bx * bx + q[4] * q[4] + q[5] * q[5]) / rho
    bx2r = bx * bx / rho
    s = a2 + b2r
    disc = torch.sqrt(torch.clamp(s * s - 4.0 * a2 * bx2r, min=0.0))
    return torch.sqrt(0.5 * (s + disc))


def _rp_mhd_hll(ixy, q_l, q_r, aux_l, aux_r, params):
    gamma = params["gamma"]
    bx = params["bx"]

    F_l, p_l = _mhd_flux(q_l, bx, gamma)
    F_r, p_r = _mhd_flux(q_r, bx, gamma)
    u_l = q_l[1] / q_l[0]
    u_r = q_r[1] / q_r[0]
    cf_l = _fast_speed(q_l, bx, gamma, p_l)
    cf_r = _fast_speed(q_r, bx, gamma, p_r)

    # Davis bounds
    s_l = torch.minimum(u_l - cf_l, u_r - cf_r)
    s_r = torch.maximum(u_l + cf_l, u_r + cf_r)

    q_m = (s_r * q_r - s_l * q_l - (F_r - F_l)) / (s_r - s_l)

    wave = torch.stack([q_m - q_l, q_r - q_m], dim=1)   # (7, 2, *n)
    s = torch.stack([s_l, s_r])
    amdq = torch.clamp(s_l, max=0.0) * wave[:, 0] \
        + torch.clamp(s_r, max=0.0) * wave[:, 1]
    apdq = torch.clamp(s_l, min=0.0) * wave[:, 0] \
        + torch.clamp(s_r, min=0.0) * wave[:, 1]
    return wave, s, amdq, apdq


def _mhd_positivity(q, aux, params):
    gamma = params["gamma"]
    bx = params["bx"]
    rho = q[0]
    safe_rho = torch.where(rho > 0.0, rho, 1.0)
    ke = 0.5 * (q[1] ** 2 + q[2] ** 2 + q[3] ** 2) / safe_rho
    b2 = bx * bx + q[4] ** 2 + q[5] ** 2
    p = (gamma - 1.0) * (q[6] - ke - 0.5 * b2)
    return (rho > 0.0) & (p > 0.0)


def _flux_mhd(ixy, q, aux, params):
    """Ideal-MHD flux (RiemannSolver.flux protocol): the solver's own."""
    f, _ = _mhd_flux(q, params["bx"], params["gamma"])
    return f


from . import RiemannSolver  # noqa: E402

mhd_1D = RiemannSolver("mhd_1D", 1, 7, 2, _rp_mhd_hll,
                       requires=("gamma", "bx"))
mhd_1D.positivity = _mhd_positivity
mhd_1D.flux = _flux_mhd
