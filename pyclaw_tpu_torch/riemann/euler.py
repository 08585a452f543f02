"""2D Euler Roe solver (4 waves), SoA form, plain PyTorch.

Counterpart of ``pyclaw_tpu/riemann/euler.py``: ``_alpha34 :66``,
``_roe_averages_soa :274``, ``_rpn2_euler_soa :297``,
``_prefactor_euler_2d_soa :359``, ``_rpt2_euler_soa :365``,
``_flux_euler_2d_soa :752``, positivity ``:775`` and the registry lines
``:797-803, :820, :829`` (physics of reference ``rpn2_euler_4wave.f90``
+ ``rpt2_euler.f90``).  Ideal gas, gamma from
problem_data; q = (rho, rho*u, rho*v, E).

The CUDA kernels ``csrc/step2_ctu.cu`` and ``csrc/dq2_weno5.cu`` repeat
this algebra operation for operation, including the float32/float64
branches of :func:`_alpha34` and :func:`_flux_euler_2d_soa`.
"""

from __future__ import annotations

import torch


def _alpha34(g1, a, a2, u, n3, n4_partial):
    """Acoustic/entropy wave strengths of the 2D Roe decomposition:
    a3 = g1/a2 * n3,  a4 = (n4_partial - a*a3) / (2a).

    float64: the literal divisions (the reference rpn2_euler algebra).
    float32: 1/a2 and 1/(2a) from one rsqrt, as the JAX package does in
    its float32 regime — so the two packages agree at either dtype."""
    if a2.dtype == torch.float64:
        a3 = g1 / a2 * n3
        a4 = (n4_partial - a * a3) / (2.0 * a)
        return a3, a4
    ia = torch.rsqrt(a2)
    a3 = g1 * (ia * ia) * n3
    a4 = (n4_partial - a * a3) * (0.5 * ia)
    return a3, a4


def _roe_averages_soa(q_l, q_r, gamma, mu, mv):
    """Roe-averaged (u, v, H, a2, a) at each interface, in the rsqrt
    form of the JAX package (1 divide + 2 rsqrts per interface)."""
    rho_l, rho_r = q_l[0], q_r[0]
    irl, irr = torch.rsqrt(rho_l), torch.rsqrt(rho_r)
    srl, srr = rho_l * irl, rho_r * irr
    rinv_l, rinv_r = irl * irl, irr * irr
    w = 1.0 / (srl + srr)
    u = (q_l[mu] * irl + q_r[mu] * irr) * w
    v = (q_l[mv] * irl + q_r[mv] * irr) * w
    ke_l = 0.5 * (q_l[mu] * q_l[mu] + q_l[mv] * q_l[mv]) * rinv_l
    ke_r = 0.5 * (q_r[mu] * q_r[mu] + q_r[mv] * q_r[mv]) * rinv_r
    p_l = (gamma - 1.0) * (q_l[3] - ke_l)
    p_r = (gamma - 1.0) * (q_r[3] - ke_r)
    H = (srl * ((q_l[3] + p_l) * rinv_l)
         + srr * ((q_r[3] + p_r) * rinv_r)) * w
    a2 = (gamma - 1.0) * (H - 0.5 * (u * u + v * v))
    return u, v, H, a2, torch.sqrt(a2)


def _rpn2_euler_soa(ixy, q_l, q_r, params):
    """rpn2_euler_4wave in SoA form: 4 waves as per-equation 2D tensors
    (None for identically-zero components) and their speeds."""
    gamma = params["gamma"]
    g1 = gamma - 1.0
    mu = 1 + ixy
    mv = 2 - ixy
    u, v, H, a2, a = _roe_averages_soa(q_l, q_r, gamma, mu, mv)

    d0 = q_r[0] - q_l[0]
    dmu = q_r[mu] - q_l[mu]
    dmv = q_r[mv] - q_l[mv]
    dE = q_r[3] - q_l[3]

    euv = H - (u * u + v * v)
    a3, a4 = _alpha34(g1, a, a2, u,
                      euv * d0 + u * dmu + v * dmv - dE,
                      dmu + (a - u) * d0)
    a2w = dmv - v * d0
    a1 = d0 - a3 - a4

    def mk(rho_c, mu_c, mv_c, e_c):
        comp = [None] * len(q_l)
        comp[0] = rho_c
        comp[mu] = mu_c
        comp[mv] = mv_c
        comp[3] = e_c
        return tuple(comp)

    waves = (
        mk(a1, a1 * (u - a), a1 * v, a1 * (H - u * a)),
        mk(a3, a3 * u, a3 * v, a3 * 0.5 * (u * u + v * v)),
        mk(None, None, a2w, a2w * v),
        mk(a4, a4 * (u + a), a4 * v, a4 * (H + u * a)),
    )
    speeds = (u - a, u, u, u + a)
    return waves, speeds


def _prefactor_euler_2d_soa(ixy, qs_l, qs_r, params):
    """Shared eigensystem for the transverse solves at one set of
    interfaces (RiemannSolver.prefactor_soa)."""
    mu, mv = 1 + ixy, 2 - ixy
    return _roe_averages_soa(qs_l, qs_r, params["gamma"], mu, mv)


def _rpt2_euler_soa(ixy, imp, q_l, q_r, asdq, params, eig=None):
    """rpt2_euler in SoA form: split the fluctuation ``asdq`` into its
    down-going (bm) and up-going (bp) parts in the transverse direction."""
    gamma = params["gamma"]
    g1 = gamma - 1.0
    mu = 1 + ixy
    mv = 2 - ixy
    if eig is None:
        u, v, H, a2, a = _roe_averages_soa(q_l, q_r, gamma, mu, mv)
    else:
        u, v, H, a2, a = eig

    d0, dmu, dmv, dE = asdq[0], asdq[mu], asdq[mv], asdq[3]
    euv = H - (u * u + v * v)
    b3 = g1 / a2 * (euv * d0 + u * dmu + v * dmv - dE)
    b2w = dmu - u * d0
    b4 = (dmv + (a - v) * d0 - a * b3) / (2.0 * a)
    b1 = d0 - b3 - b4

    def mk(rho_c, mu_c, mv_c, e_c):
        comp = [None] * len(q_l)
        comp[0] = rho_c
        comp[mu] = mu_c
        comp[mv] = mv_c
        comp[3] = e_c
        return tuple(comp)

    waves = (
        mk(b1, b1 * u, b1 * (v - a), b1 * (H - v * a)),
        mk(b3, b3 * u, b3 * v, b3 * 0.5 * (u * u + v * v)),
        mk(None, b2w, None, b2w * u),
        mk(b4, b4 * u, b4 * (v + a), b4 * (H + v * a)),
    )
    speeds = (v - a, v, v, v + a)

    num_eqn = len(q_l)
    bm = [None] * num_eqn
    bp = [None] * num_eqn
    for e in range(num_eqn):
        for w, sp in zip(waves, speeds):
            if w[e] is None:
                continue
            bm_t = torch.clamp(sp, max=0.0) * w[e]
            bp_t = torch.clamp(sp, min=0.0) * w[e]
            bm[e] = bm_t if bm[e] is None else bm[e] + bm_t
            bp[e] = bp_t if bp[e] is None else bp[e] + bp_t
    zero = torch.zeros_like(asdq[0])
    bm = [zero if b is None else b for b in bm]
    bp = [zero if b is None else b for b in bp]
    return tuple(bm), tuple(bp)


def _flux_euler_2d_soa(ixy, qs, params):
    """Physical flux of the 2D Euler system along ``ixy``, one tensor per
    component (RiemannSolver.flux_soa).  float32 shares one reciprocal of
    rho, as the JAX package does; the CUDA kernel ``csrc/dq2_weno5.cu``
    branches the same way."""
    gamma = params["gamma"]
    mu, mv = 1 + ixy, 2 - ixy
    rho, E = qs[0], qs[3]
    if rho.dtype == torch.float64:
        u = qs[mu] / rho
        p = (gamma - 1.0) * (E - 0.5 * (qs[1] ** 2 + qs[2] ** 2) / rho)
    else:
        rinv = 1.0 / rho
        u = qs[mu] * rinv
        p = (gamma - 1.0) * (E - 0.5 * (qs[1] ** 2 + qs[2] ** 2) * rinv)
    comp = [None] * len(qs)
    comp[0] = qs[mu]
    comp[mu] = qs[mu] * u + p
    comp[mv] = qs[mv] * u
    comp[3] = u * (E + p)
    return tuple(comp)


def _make_euler_positivity(vel_idx, e_idx):
    def positivity(q, aux, params):
        rho = q[0]
        ke = 0.5 * sum(q[i] * q[i] for i in vel_idx) / torch.where(
            rho > 0.0, rho, torch.ones_like(rho))
        p = (params["gamma"] - 1.0) * (q[e_idx] - ke)
        return (rho > 0.0) & (p > 0.0)
    return positivity


from . import RiemannSolver  # noqa: E402

# The AoS hooks (rp/rpt) are not ported: the SoA path is the only one
# this slice runs (classic/solver.py raises for the others).
euler_4wave_2D = RiemannSolver("euler_4wave_2D", 2, 4, 4, None,
                               requires=("gamma",))
euler_4wave_2D.rpn_soa = _rpn2_euler_soa
euler_4wave_2D.rpt_soa = _rpt2_euler_soa
euler_4wave_2D.prefactor_soa = _prefactor_euler_2d_soa
euler_4wave_2D.positivity = _make_euler_positivity((1, 2), 3)
euler_4wave_2D.flux_soa = _flux_euler_2d_soa
