"""Euler Roe solvers, plain PyTorch: the 1D systems (Roe with and without
the Harten entropy fix, HLLE), the 2D 4-wave and 5-wave (passive tracer)
systems in AoS form (the classic generic step and SharpClaw's generic dq)
and in SoA form, and the 3D system in AoS form.

Counterpart of ``pyclaw_tpu/riemann/euler.py``: ``_wsum :22``,
``_roe_averages :32``, ``_alpha34 :66``, ``_rp1_euler_roe :93-163``,
``_rp1_euler_hlle :169-194``, ``_rpn2_euler :200-271`` (with its tracer
branch), ``_roe_averages_soa :274``, ``_rpn2_euler_soa :297-356`` (with
its tracer branch), ``_prefactor_euler_2d_soa :359``, ``_rpt2_euler_soa
:365-418``, ``_prefactor_euler_2d :421-427``, ``_rpt2_euler :430-485``,
``_rpn3_euler :489``, ``_prefactor_euler_3d :542``,
``_split_transverse_euler :556``, ``_rpt3_euler :626``, ``_rptt3_euler
:634``, the char_decomp hooks ``_evec_euler_1d :642`` and
``_evec_euler_nd :670``, ``_make_euler_flux :732-749``,
``_flux_euler_2d_soa :752-772``, positivity ``:775`` and the registry
lines ``:787-833`` (physics of reference ``rp1_euler_with_efix.f90``,
``euler_1D_py.py``, ``rpn2_euler_4wave.f90`` / ``rpn2_euler_5wave.f90``
+ ``rpt2_euler.f90`` and ``rpn3_euler.f90`` + ``rpt3_euler.f90`` +
``rptt3_euler.f90``).  Ideal gas, gamma from problem_data; q = (rho,
rho*u, rho*v, E) in 2D (the 5-wave system adds the tracer rho*phi) and
(rho, rho*u, rho*v, rho*w, E) in 3D.

The CUDA kernels repeat the algebra operation for operation, including
the float32/float64 branches of :func:`_alpha34` and
:func:`_flux_euler_2d_soa`: ``csrc/step2_ctu.cu`` the 2D 4-wave SoA step,
``csrc/euler2d_aos.cuh`` (for ``csrc/step2_aos.cu``) the 2D AoS hooks of
both 2D systems, ``csrc/dq2_weno5.cu`` the 2D SoA hooks of both,
``csrc/step3_ctu.cu`` the 3D algebra, ``csrc/systems1d.cuh`` (for
``csrc/step1.cu``) the 1D algebra.  The 3D solver has two wave sets: the
normal solve keeps 5 explicit waves (the limiter sees the two shear waves
apart), the transverse splits sum entropy and both shears into one wave,
so a split has 3 speeds.
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


def _rpn2_euler_soa(ixy, q_l, q_r, params, tracer=False):
    """rpn2_euler_4wave (rpn2_euler_5wave with ``tracer``) in SoA form:
    4 (5) waves as per-equation 2D tensors (None for identically-zero
    components) and their speeds.  The tracer q[4] = rho phi rides every
    wave that carries density as phi_hat times its density strength; the
    rest of its jump is a fifth wave of speed u."""
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

    def mk(rho_c, mu_c, mv_c, e_c, t_c=None):
        comp = [None] * len(q_l)
        comp[0] = rho_c
        comp[mu] = mu_c
        comp[mv] = mv_c
        comp[3] = e_c
        if tracer:
            comp[4] = t_c
        return tuple(comp)

    if tracer:
        srl, srr = torch.sqrt(q_l[0]), torch.sqrt(q_r[0])
        phat = (srl * (q_l[4] / q_l[0]) + srr * (q_r[4] / q_r[0])) \
            / (srl + srr)
        t1, t2, t4 = a1 * phat, a3 * phat, a4 * phat
        a5 = (q_r[4] - q_l[4]) - phat * d0
    else:
        t1 = t2 = t4 = a5 = None

    waves = [
        mk(a1, a1 * (u - a), a1 * v, a1 * (H - u * a), t1),
        mk(a3, a3 * u, a3 * v, a3 * 0.5 * (u * u + v * v), t2),
        mk(None, None, a2w, a2w * v, None),
        mk(a4, a4 * (u + a), a4 * v, a4 * (H + u * a), t4),
    ]
    speeds = [u - a, u, u, u + a]
    if tracer:
        waves.append(mk(None, None, None, None, a5))
        speeds.append(u)
    return tuple(waves), tuple(speeds)


def _rpn2_euler_5wave_soa(ixy, q_l, q_r, params):
    return _rpn2_euler_soa(ixy, q_l, q_r, params, tracer=True)


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
    if num_eqn == 5:    # the passive tracer rides the transverse flow
        t_m = torch.clamp(v, max=0.0) * asdq[4]
        t_p = torch.clamp(v, min=0.0) * asdq[4]
        bm[4] = t_m if bm[4] is None else bm[4] + t_m
        bp[4] = t_p if bp[4] is None else bp[4] + t_p
    zero = torch.zeros_like(asdq[0])
    bm = [zero if b is None else b for b in bm]
    bp = [zero if b is None else b for b in bp]
    return tuple(bm), tuple(bp)


def _flux_euler_2d_soa(ixy, qs, params, tracer=False):
    """Physical flux of the 2D Euler system along ``ixy``, one tensor per
    component (RiemannSolver.flux_soa), with the tracer's u q[4] when
    ``tracer``.  float32 shares one reciprocal of rho, as the JAX package
    does; the CUDA kernel ``csrc/dq2_weno5.cu`` branches the same way."""
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
    if tracer:
        comp[4] = u * qs[4]
    return tuple(comp)


def _flux_euler_5wave_soa(ixy, qs, params):
    return _flux_euler_2d_soa(ixy, qs, params, tracer=True)


def _wsum(coef, wave):
    """sum_p coef[p] * wave[:, p]  ->  (num_eqn, *n), as explicit adds
    in wave order."""
    terms = coef[None] * wave
    out = terms[:, 0]
    for p in range(1, wave.shape[1]):
        out = out + terms[:, p]
    return out


def _roe_averages(q_l, q_r, gamma, vel_idx, e_idx=None):
    """Roe-averaged velocities (one per entry of ``vel_idx``, in that
    order), enthalpy and sound speed of AoS states (num_eqn, *n), in the
    rsqrt form of the JAX package (1 divide + 2 rsqrts per interface).
    Returns (vels, H, a, a2, (p_l, p_r))."""
    rho_l, rho_r = q_l[0], q_r[0]
    irl, irr = torch.rsqrt(rho_l), torch.rsqrt(rho_r)
    srl, srr = rho_l * irl, rho_r * irr
    rinv_l, rinv_r = irl * irl, irr * irr
    w = 1.0 / (srl + srr)
    vels = [(q_l[i] * irl + q_r[i] * irr) * w for i in vel_idx]
    E_idx = (1 + len(vel_idx)) if e_idx is None else e_idx
    ke_l = 0.5 * sum(q_l[i] ** 2 for i in vel_idx) * rinv_l
    ke_r = 0.5 * sum(q_r[i] ** 2 for i in vel_idx) * rinv_r
    p_l = (gamma - 1.0) * (q_l[E_idx] - ke_l)
    p_r = (gamma - 1.0) * (q_r[E_idx] - ke_r)
    H_l = (q_l[E_idx] + p_l) * rinv_l
    H_r = (q_r[E_idx] + p_r) * rinv_r
    H = (srl * H_l + srr * H_r) * w
    ke = 0.5 * sum(v * v for v in vels)
    a2 = (gamma - 1.0) * (H - ke)
    a = torch.sqrt(a2)
    return vels, H, a, a2, (p_l, p_r)


def _rp1_euler_roe(ixy, q_l, q_r, aux_l, aux_r, params, efix=True):
    """rp1_euler_with_efix (``efix``) or the plain Roe solver: 3 waves
    (3, 3, *n), speeds (u - a, u, u + a), amdq, apdq."""
    gamma = params["gamma"]
    g1 = gamma - 1.0
    (u,), H, a, a2, _ = _roe_averages(q_l, q_r, gamma, (1,))

    d = q_r - q_l
    a2_coef = g1 / a2 * ((H - u * u) * d[0] + u * d[1] - d[2])
    a3_coef = (d[1] + (a - u) * d[0] - a * a2_coef) / (2.0 * a)
    a1_coef = d[0] - a2_coef - a3_coef

    w1 = torch.stack([a1_coef, a1_coef * (u - a), a1_coef * (H - u * a)])
    w2 = torch.stack([a2_coef, a2_coef * u, a2_coef * 0.5 * u * u])
    w3 = torch.stack([a3_coef, a3_coef * (u + a), a3_coef * (H + u * a)])
    wave = torch.stack([w1, w2, w3], dim=1)
    s = torch.stack([u - a, u, u + a])

    if not efix:
        amdq = _wsum(torch.clamp(s, max=0.0), wave)
        apdq = _wsum(torch.clamp(s, min=0.0), wave)
        return wave, s, amdq, apdq

    # Harten entropy fix: transonic 1- and 3-rarefactions get a split
    # speed.  The clamp's 1e-300 rounds to 0 in float32, as in JAX.
    def sound(rho, mom, E):
        p = g1 * (E - 0.5 * mom * mom / rho)
        return mom / rho, torch.sqrt(torch.clamp(gamma * p / rho, min=1e-300))

    u_l, c_l = sound(q_l[0], q_l[1], q_l[2])
    u_r, c_r = sound(q_r[0], q_r[1], q_r[2])

    # state just right of the 1-wave
    qm1 = q_l + w1
    u_m1, c_m1 = sound(qm1[0], qm1[1], qm1[2])
    lam1_l = u_l - c_l
    lam1_m = u_m1 - c_m1
    trans1 = (lam1_l < 0.0) & (lam1_m > 0.0)
    den1 = lam1_m - lam1_l
    sfract1 = torch.where(
        trans1,
        lam1_l * (lam1_m - s[0]) / torch.where(den1 == 0.0,
                                               torch.ones_like(den1), den1),
        torch.clamp(s[0], max=0.0))

    sfract2 = torch.clamp(s[1], max=0.0)

    # state just left of the 3-wave
    qm3 = q_r - w3
    u_m3, c_m3 = sound(qm3[0], qm3[1], qm3[2])
    lam3_m = u_m3 + c_m3
    lam3_r = u_r + c_r
    trans3 = (lam3_m < 0.0) & (lam3_r > 0.0)
    den3 = lam3_r - lam3_m
    sfract3 = torch.where(
        trans3,
        lam3_m * (lam3_r - s[2]) / torch.where(den3 == 0.0,
                                               torch.ones_like(den3), den3),
        torch.clamp(s[2], max=0.0))

    amdq = sfract1 * w1 + sfract2 * w2 + sfract3 * w3
    # conservation: amdq + apdq = sum_p s_p W_p (Roe), not a split of s
    apdq = _wsum(s, wave) - amdq
    return wave, s, amdq, apdq


def _rp1_euler_with_efix(ixy, q_l, q_r, aux_l, aux_r, params):
    return _rp1_euler_roe(ixy, q_l, q_r, aux_l, aux_r, params, efix=True)


def _rp1_euler_roe_nofix(ixy, q_l, q_r, aux_l, aux_r, params):
    return _rp1_euler_roe(ixy, q_l, q_r, aux_l, aux_r, params, efix=False)


def _rp1_euler_hlle(ixy, q_l, q_r, aux_l, aux_r, params):
    """HLLE (euler_1D_py.py's euler_hll_1D): 2 waves through the
    intermediate state, speeds from the Roe and the one-sided estimates."""
    gamma = params["gamma"]
    g1 = gamma - 1.0
    (u,), H, a, a2, _ = _roe_averages(q_l, q_r, gamma, (1,))
    u_l = q_l[1] / q_l[0]
    u_r = q_r[1] / q_r[0]
    p_l = g1 * (q_l[2] - 0.5 * q_l[1] ** 2 / q_l[0])
    p_r = g1 * (q_r[2] - 0.5 * q_r[1] ** 2 / q_r[0])
    c_l = torch.sqrt(gamma * p_l / q_l[0])
    c_r = torch.sqrt(gamma * p_r / q_r[0])

    s1 = torch.minimum(u - a, u_l - c_l)
    s2 = torch.maximum(u + a, u_r + c_r)

    f_l = torch.stack([q_l[1], q_l[1] * u_l + p_l, u_l * (q_l[2] + p_l)])
    f_r = torch.stack([q_r[1], q_r[1] * u_r + p_r, u_r * (q_r[2] + p_r)])
    ds = s2 - s1
    denom = torch.where(ds == 0.0, torch.ones_like(ds), ds)
    q_m = (f_r - f_l - (s2 * q_r - s1 * q_l)) / -denom

    wave = torch.stack([q_m - q_l, q_r - q_m], dim=1)
    s = torch.stack([s1, s2])
    amdq = _wsum(torch.clamp(s, max=0.0), wave)
    apdq = _wsum(torch.clamp(s, min=0.0), wave)
    return wave, s, amdq, apdq


def _rpn2_euler(ixy, q_l, q_r, aux_l, aux_r, params, tracer=False):
    """rpn2_euler_4wave (rpn2_euler_5wave with ``tracer``) in AoS form: 4
    (5) waves (num_eqn, num_waves, *n), speeds (u - a, u, u, u + a (, u)),
    amdq, apdq; the algebra of :func:`_rpn2_euler_soa`."""
    gamma = params["gamma"]
    g1 = gamma - 1.0
    mu = 1 + ixy          # normal momentum component
    mv = 2 - ixy          # transverse momentum component
    E = 3

    (u, v), H, a, a2, _ = _roe_averages(q_l, q_r, gamma, (mu, mv))

    d = q_r - q_l
    d0, dmu, dmv, dE = d[0], d[mu], d[mv], d[E]

    euv = H - (u * u + v * v)
    a3, a4 = _alpha34(g1, a, a2, u,
                      euv * d0 + u * dmu + v * dmv - dE,
                      dmu + (a - u) * d0)
    a2w = dmv - v * d0                 # shear strength
    a1 = d0 - a3 - a4

    num_eqn = q_l.shape[0]
    z = torch.zeros_like(d0)

    def mk(rho_c, mu_c, mv_c, e_c, t_c=z):
        comp = [z] * num_eqn
        comp[0] = rho_c
        comp[mu] = mu_c
        comp[mv] = mv_c
        comp[E] = e_c
        if tracer:
            comp[4] = t_c
        return torch.stack(comp)

    if tracer:
        # the passive tracer q[4] = rho phi (rpn2_euler_5wave.f90): every
        # wave that carries density carries phi_hat times its strength;
        # the rest of the tracer's jump rides its own wave of speed u
        T = 4
        srl, srr = torch.sqrt(q_l[0]), torch.sqrt(q_r[0])
        phat = (srl * (q_l[T] / q_l[0]) + srr * (q_r[T] / q_r[0])) \
            / (srl + srr)
        t1, t2, t4 = a1 * phat, a3 * phat, a4 * phat
    else:
        t1 = t2 = t4 = z
    waves = [mk(a1, a1 * (u - a), a1 * v, a1 * (H - u * a), t1),
             mk(a3, a3 * u, a3 * v, a3 * 0.5 * (u * u + v * v), t2),
             mk(z, z, a2w, a2w * v),
             mk(a4, a4 * (u + a), a4 * v, a4 * (H + u * a), t4)]
    speeds = [u - a, u, u, u + a]
    if tracer:
        waves.append(mk(z, z, z, z, d[T] - phat * d0))
        speeds.append(u)
    wave = torch.stack(waves, dim=1)
    s = torch.stack(speeds)
    amdq = _wsum(torch.clamp(s, max=0.0), wave)
    apdq = _wsum(torch.clamp(s, min=0.0), wave)
    return wave, s, amdq, apdq


def _rpn2_euler_4wave(ixy, q_l, q_r, aux_l, aux_r, params):
    return _rpn2_euler(ixy, q_l, q_r, aux_l, aux_r, params, tracer=False)


def _rpn2_euler_5wave(ixy, q_l, q_r, aux_l, aux_r, params):
    return _rpn2_euler(ixy, q_l, q_r, aux_l, aux_r, params, tracer=True)


def _prefactor_euler_2d(ixy, q_l, q_r, aux_l, aux_r, params):
    """The Roe average that both rpt2 splits at one set of interfaces take
    (RiemannSolver.prefactor): (u, v, H, a, a2)."""
    mu, mv = 1 + ixy, 2 - ixy
    (u, v), H, a, a2, _ = _roe_averages(q_l, q_r, params["gamma"], (mu, mv))
    return (u, v, H, a, a2)


def _rpt2_euler(ixy, imp, q_l, q_r, aux_l, aux_r, asdq, params, eig=None):
    """rpt2_euler in AoS form: split ``asdq`` (num_eqn, *n) into its
    down-going (bm) and up-going (bp) parts along the transverse
    direction, at the Roe average of (q_l, q_r) (``eig``: the same from
    :func:`_prefactor_euler_2d`); a tracer rides the transverse flow v."""
    gamma = params["gamma"]
    g1 = gamma - 1.0
    mu = 1 + ixy          # normal component of the sweep
    mv = 2 - ixy          # transverse component (the split's direction)
    E = 3

    if eig is None:
        (u, v), H, a, a2, _ = _roe_averages(q_l, q_r, gamma, (mu, mv))
    else:
        u, v, H, a, a2 = eig
    d0, dmu, dmv, dE = asdq[0], asdq[mu], asdq[mv], asdq[E]

    euv = H - (u * u + v * v)
    b3 = g1 / a2 * (euv * d0 + u * dmu + v * dmv - dE)
    b2w = dmu - u * d0                 # shear in the transverse split
    b4 = (dmv + (a - v) * d0 - a * b3) / (2.0 * a)
    b1 = d0 - b3 - b4

    num_eqn = q_l.shape[0]
    z = torch.zeros_like(d0)

    def mk(rho_c, mu_c, mv_c, e_c):
        comp = [z] * num_eqn
        comp[0] = rho_c
        comp[mu] = mu_c
        comp[mv] = mv_c
        comp[E] = e_c
        return torch.stack(comp)

    w1 = mk(b1, b1 * u, b1 * (v - a), b1 * (H - v * a))
    w2 = mk(b3, b3 * u, b3 * v, b3 * 0.5 * (u * u + v * v))
    w3 = mk(z, b2w, z, b2w * u)
    w4 = mk(b4, b4 * u, b4 * (v + a), b4 * (H + v * a))

    bmasdq = torch.zeros_like(asdq)
    bpasdq = torch.zeros_like(asdq)
    for w, sp in zip((w1, w2, w3, w4), (v - a, v, v, v + a)):
        bmasdq = bmasdq + torch.clamp(sp, max=0.0) * w
        bpasdq = bpasdq + torch.clamp(sp, min=0.0) * w
    if num_eqn == 5:
        bmasdq = torch.cat([bmasdq[:4], (bmasdq[4] + torch.clamp(
            v, max=0.0) * asdq[4])[None]])
        bpasdq = torch.cat([bpasdq[:4], (bpasdq[4] + torch.clamp(
            v, min=0.0) * asdq[4])[None]])
    return bmasdq, bpasdq


def _make_euler_flux(ndim):
    """Physical Euler flux f(q) along ``ixy`` (RiemannSolver.flux): every
    component advects with u, the momentum row adds p, the energy row
    u p."""
    e_idx = 1 + ndim

    def flux(ixy, q, aux, params):
        gamma = params["gamma"]
        rho = q[0]
        u = q[1 + ixy] / rho
        ke = 0.5 * sum(q[1 + d] ** 2 for d in range(ndim)) / rho
        p = (gamma - 1.0) * (q[e_idx] - ke)
        f = [u * q[k] for k in range(q.shape[0])]
        f[1 + ixy] = f[1 + ixy] + p
        f[e_idx] = f[e_idx] + u * p
        return torch.stack(f)
    return flux


def _rpn3_euler(ixy, q_l, q_r, aux_l, aux_r, params):
    """rpn3_euler: 5 explicit waves (num_eqn, 5, *n), speeds (5, *n),
    amdq, apdq.  The Roe average runs in the sweep's permuted component
    order (mu, mv, mw)."""
    gamma = params["gamma"]
    g1 = gamma - 1.0
    mu = 1 + ixy
    mv = 1 + (ixy + 1) % 3
    mw = 1 + (ixy + 2) % 3
    E = 4

    (u, v, w_), H, a, a2, _ = _roe_averages(q_l, q_r, gamma, (mu, mv, mw))

    d = q_r - q_l
    d0, dmu, dmv, dmw, dE = d[0], d[mu], d[mv], d[mw], d[E]

    euv = H - (u * u + v * v + w_ * w_)
    a3 = g1 / a2 * (euv * d0 + u * dmu + v * dmv + w_ * dmw - dE)
    ash = dmv - v * d0                 # shear (v)
    ash2 = dmw - w_ * d0               # shear (w)
    a5 = (dmu + (a - u) * d0 - a * a3) / (2.0 * a)
    a1 = d0 - a3 - a5

    num_eqn = q_l.shape[0]
    z = torch.zeros_like(d0)

    def mk(rho_c, mu_c, mv_c, mw_c, e_c):
        comp = [z] * num_eqn
        comp[0] = rho_c
        comp[mu] = mu_c
        comp[mv] = mv_c
        comp[mw] = mw_c
        comp[E] = e_c
        return torch.stack(comp)

    w1 = mk(a1, a1 * (u - a), a1 * v, a1 * w_, a1 * (H - u * a))
    w2 = mk(a3, a3 * u, a3 * v, a3 * w_,
            a3 * 0.5 * (u * u + v * v + w_ * w_))
    w3 = mk(z, z, ash, z, ash * v)
    w4 = mk(z, z, z, ash2, ash2 * w_)
    w5 = mk(a5, a5 * (u + a), a5 * v, a5 * w_, a5 * (H + u * a))

    wave = torch.stack([w1, w2, w3, w4, w5], dim=1)
    s = torch.stack([u - a, u, u, u, u + a])
    amdq = _wsum(torch.clamp(s, max=0.0), wave)
    apdq = _wsum(torch.clamp(s, min=0.0), wave)
    return wave, s, amdq, apdq


def _prefactor_euler_3d(ixy, q_l, q_r, aux_l, aux_r, params):
    """Shared eigensystem of the 3D transverse splits at one set of
    interfaces: the Roe average in the fixed component order (1, 2, 3),
    and its kinetic energy per unit mass."""
    (u1, u2, u3), H, a, a2, _ = _roe_averages(q_l, q_r, params["gamma"],
                                              (1, 2, 3))
    ke = 0.5 * (u1 * u1 + u2 * u2 + u3 * u3)
    return ((u1, u2, u3), H, a, a2, ke)


def _split_transverse_euler(vel_comp, q_l, q_r, aux_l, aux_r, asdq, params,
                            normal_comp, eig=None):
    """Split ``asdq`` into its parts going down (bm) and up (bp) along
    the momentum row ``vel_comp`` (1 = u, 2 = v, 3 = w), with the
    entropy and both shear waves summed into one wave of speed vt."""
    gamma = params["gamma"]
    g1 = gamma - 1.0
    E = 4
    vel_idx = (1, 2, 3)
    if eig is None:
        (u1, u2, u3), H, a, a2, _ = _roe_averages(q_l, q_r, gamma, vel_idx)
        ke = 0.5 * (u1 * u1 + u2 * u2 + u3 * u3)
    else:
        (u1, u2, u3), H, a, a2, ke = eig
    vels = {1: u1, 2: u2, 3: u3}
    vt = vels[vel_comp]

    d0 = asdq[0]
    dE = asdq[E]
    dm = {i: asdq[i] for i in vel_idx}

    euv = H - 2.0 * ke
    b3 = g1 / a2 * (euv * d0 + u1 * dm[1] + u2 * dm[2] + u3 * dm[3] - dE)
    b5 = (dm[vel_comp] + (a - vt) * d0 - a * b3) / (2.0 * a)
    b1 = d0 - b3 - b5
    shear_comps = [i for i in vel_idx if i != vel_comp]
    bsh = {i: dm[i] - vels[i] * d0 for i in shear_comps}

    num_eqn = q_l.shape[0]
    z = torch.zeros_like(d0)

    def mk(rho_c, mom, e_c):
        comp = [z] * num_eqn
        comp[0] = rho_c
        for i in vel_idx:
            comp[i] = mom[i]
        comp[E] = e_c
        return torch.stack(comp)

    mom1 = {i: b1 * vels[i] for i in vel_idx}
    mom1[vel_comp] = b1 * (vt - a)
    w1 = mk(b1, mom1, b1 * (H - vt * a))
    momm = {i: b3 * vels[i] + bsh[i] for i in shear_comps}
    momm[vel_comp] = b3 * vt
    wmid = mk(b3, momm,
              b3 * ke + bsh[shear_comps[0]] * vels[shear_comps[0]]
              + bsh[shear_comps[1]] * vels[shear_comps[1]])
    mom5 = {i: b5 * vels[i] for i in vel_idx}
    mom5[vel_comp] = b5 * (vt + a)
    w5 = mk(b5, mom5, b5 * (H + vt * a))

    bm = torch.zeros_like(asdq)
    bp = torch.zeros_like(asdq)
    for w, sp_ in zip((w1, wmid, w5), (vt - a, vt, vt + a)):
        bm = bm + torch.clamp(sp_, max=0.0) * w
        bp = bp + torch.clamp(sp_, min=0.0) * w
    return bm, bp


def _rpt3_euler(ixy, imp, q_l, q_r, aux_l, aux_r, asdq, params,
                trans_axis=None, eig=None):
    if trans_axis is None:
        trans_axis = (ixy + 1) % 3
    return _split_transverse_euler(1 + trans_axis, q_l, q_r, aux_l, aux_r,
                                   asdq, params, 1 + ixy, eig=eig)


def _rptt3_euler(ixy, icoor, imp, impt, q_l, q_r, aux_l, aux_r, bsasdq,
                 params, trans_axis=None, eig=None):
    if trans_axis is None:
        trans_axis = (ixy + 2) % 3
    return _split_transverse_euler(1 + trans_axis, q_l, q_r, aux_l, aux_r,
                                   bsasdq, params, 1 + ixy, eig=eig)


def _evec_euler_1d(ixy, q, aux, params):
    """Right and left eigenvector matrices of the 1D Euler Jacobian at
    each cell state (reference sharpclaw/evec.f90; the char_decomp hook):
    (R, L), each (num_eqn, num_eqn, *n), L = R^-1 in closed form."""
    gamma = params["gamma"]
    g1 = gamma - 1.0
    rho, mom, E = q[0], q[1], q[2]
    u = mom / rho
    p = g1 * (E - 0.5 * rho * u * u)
    a = torch.sqrt(gamma * p / rho)
    H = (E + p) / rho

    one = torch.ones_like(u)
    R = torch.stack([
        torch.stack([one, one, one]),
        torch.stack([u - a, u, u + a]),
        torch.stack([H - u * a, 0.5 * u * u, H + u * a]),
    ])
    b1 = g1 / (a * a)
    b2 = 0.5 * b1 * u * u
    L = torch.stack([
        torch.stack([0.5 * (b2 + u / a), -0.5 * (b1 * u + 1.0 / a),
                     0.5 * b1]),
        torch.stack([1.0 - b2, b1 * u, -b1]),
        torch.stack([0.5 * (b2 - u / a), -0.5 * (b1 * u - 1.0 / a),
                     0.5 * b1]),
    ])
    return R, L


def _evec_euler_nd(ixy, q, aux, params):
    """Eigenvector matrices of the multi-D Euler Jacobian along axis
    ``ixy`` at each cell state (the char_decomp hook of the 2D 4-wave
    and 3D solvers); characteristic fields in the order (u-a, entropy,
    shear(s), u+a)."""
    gamma = params["gamma"]
    g1 = gamma - 1.0
    num_eqn = q.shape[0]
    e_idx = num_eqn - 1
    vel_idx = list(range(1, num_eqn - 1))
    mu = 1 + ixy
    trans = [i for i in vel_idx if i != mu]
    rho = q[0]
    E = q[e_idx]
    vels = {i: q[i] / rho for i in vel_idx}
    un = vels[mu]
    V2 = sum(v * v for v in vels.values())
    p = g1 * (E - 0.5 * rho * V2)
    a = torch.sqrt(gamma * p / rho)
    H = (E + p) / rho
    b1 = g1 / (a * a)
    b2 = 0.5 * b1 * V2
    one = torch.ones_like(un)
    zero = torch.zeros_like(un)
    R = [[zero] * num_eqn for _ in range(num_eqn)]
    L = [[zero] * num_eqn for _ in range(num_eqn)]

    # acoustic columns 0 (u-a) and num_eqn-1 (u+a)
    for col, sgn in ((0, -1.0), (num_eqn - 1, 1.0)):
        R[0][col] = one
        R[mu][col] = un + sgn * a
        for i in trans:
            R[i][col] = vels[i]
        R[e_idx][col] = H + sgn * un * a
    # entropy column 1
    R[0][1] = one
    for i in vel_idx:
        R[i][1] = vels[i]
    R[e_idx][1] = 0.5 * V2
    # shear columns: one per transverse momentum
    for col, i in zip(range(2, num_eqn - 1), trans):
        R[i][col] = one
        R[e_idx][col] = vels[i]

    # left eigenvectors (the inverse in closed form)
    for row, sgn in ((0, -1.0), (num_eqn - 1, 1.0)):
        L[row][0] = 0.5 * (b2 - sgn * un / a)
        L[row][mu] = -0.5 * (b1 * un - sgn / a)
        for i in trans:
            L[row][i] = -0.5 * b1 * vels[i]
        L[row][e_idx] = 0.5 * b1
    L[1][0] = 1.0 - b2
    for i in vel_idx:
        L[1][i] = b1 * vels[i]
    L[1][e_idx] = -b1
    for row, i in zip(range(2, num_eqn - 1), trans):
        L[row][0] = -vels[i]
        L[row][i] = one
    return (torch.stack([torch.stack(r) for r in R]),
            torch.stack([torch.stack(r) for r in L]))


def _make_euler_positivity(vel_idx, e_idx):
    def positivity(q, aux, params):
        rho = q[0]
        ke = 0.5 * sum(q[i] * q[i] for i in vel_idx) / torch.where(
            rho > 0.0, rho, torch.ones_like(rho))
        p = (params["gamma"] - 1.0) * (q[e_idx] - ke)
        return (rho > 0.0) & (p > 0.0)
    return positivity


from . import RiemannSolver  # noqa: E402

euler_4wave_2D = RiemannSolver("euler_4wave_2D", 2, 4, 4, _rpn2_euler_4wave,
                               rpt=_rpt2_euler, requires=("gamma",))
euler_4wave_2D.prefactor = _prefactor_euler_2d
euler_4wave_2D.flux = _make_euler_flux(2)
euler_4wave_2D.rpn_soa = _rpn2_euler_soa
euler_4wave_2D.rpt_soa = _rpt2_euler_soa
euler_4wave_2D.prefactor_soa = _prefactor_euler_2d_soa
euler_4wave_2D.positivity = _make_euler_positivity((1, 2), 3)
euler_4wave_2D.flux_soa = _flux_euler_2d_soa
euler_4wave_2D.evec = _evec_euler_nd

# the JAX package's record: no evec hook
euler_5wave_2D = RiemannSolver("euler_5wave_2D", 2, 5, 5, _rpn2_euler_5wave,
                               rpt=_rpt2_euler, requires=("gamma",))
euler_5wave_2D.prefactor = _prefactor_euler_2d
euler_5wave_2D.flux = _make_euler_flux(2)
euler_5wave_2D.rpn_soa = _rpn2_euler_5wave_soa
euler_5wave_2D.rpt_soa = _rpt2_euler_soa
euler_5wave_2D.prefactor_soa = _prefactor_euler_2d_soa
euler_5wave_2D.positivity = _make_euler_positivity((1, 2), 3)
euler_5wave_2D.flux_soa = _flux_euler_5wave_soa

euler_3D = RiemannSolver("euler_3D", 3, 5, 5, _rpn3_euler,
                         rpt=_rpt3_euler, rptt=_rptt3_euler,
                         requires=("gamma",))
euler_3D.prefactor = _prefactor_euler_3d
# metadata of the JAX package; its batched transverse path is not ported
euler_3D.transverse_batchable = True
euler_3D.positivity = _make_euler_positivity((1, 2, 3), 4)
euler_3D.evec = _evec_euler_nd
euler_3D.flux = _make_euler_flux(3)

euler_with_efix_1D = RiemannSolver("euler_with_efix_1D", 1, 3, 3,
                                   _rp1_euler_with_efix, requires=("gamma",))
euler_roe_1D = RiemannSolver("euler_roe_1D", 1, 3, 3, _rp1_euler_roe_nofix,
                             requires=("gamma",))
euler_hlle_1D = RiemannSolver("euler_hlle_1D", 1, 3, 2, _rp1_euler_hlle,
                              requires=("gamma",))
for _s in (euler_with_efix_1D, euler_roe_1D, euler_hlle_1D):
    _s.positivity = _make_euler_positivity((1,), 2)
    _s.flux = _make_euler_flux(1)
euler_with_efix_1D.evec = _evec_euler_1d
euler_roe_1D.evec = _evec_euler_1d
