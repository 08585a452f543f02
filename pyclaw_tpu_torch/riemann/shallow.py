"""Shallow-water Riemann solvers, 1D and 2D, plain PyTorch.

Counterpart of ``pyclaw_tpu/riemann/shallow.py`` (the 1D Roe solver with
Harten's entropy fix ``_rp1_shallow_roe :31-81``, ``_rp1_shallow_hlle
:88-111``, the 1D records ``:283-292``, ``_rp1_shallow_bathymetry_fwave
:300-338`` and its record ``:415-418``, ``_rpn2_shallow_roe
:115``, ``_rpt2_shallow_roe :187``, ``_rpn2_shallow_bathymetry_fwave
:341``, ``_shallow_positivity :407``, ``_sw_aug_core :430-504``,
``_rp1_sw_aug :507-532``, ``_rpn2_sw_aug :535-583``, ``_rpt2_sw_aug
:586-601``, ``_sw_aug_positivity :604-606`` and the ``sw_aug_2D`` record
``:612-614``), itself a
rebuild of reference ``rpn2_shallow_roe_with_efix.f90``,
``rpt2_shallow_roe_with_efix.f90``, ``rpn2_shallow_bathymetry_fwave.f90``
and GeoClaw's augmented solver.  System: h_t + (hu)_x + (hv)_y = 0,
(hu)_t + (hu^2 + g h^2/2)_x + (huv)_y = 0, (hv)_t + (huv)_x + (hv^2 + g
h^2/2)_y = 0, with g = problem_data['grav'] (in 1D: h_t + (hu)_x = 0,
(hu)_t + (hu^2 + g h^2/2)_x = 0).

Every expression keeps the JAX package's operation order (Python
scalars fold first, as there), so in float64 the two agree to roundoff
(tests/test_torch_riemann_shallow.py, tests/test_torch_sw_aug.py).  The
CUDA kernels repeat them: the 2D solvers in ``csrc/shallow2d.cuh`` and
``csrc/sw_aug2d.cuh`` (``SwAug2D``), the 1D solvers in
``csrc/systems1d.cuh`` (``ShallowRoe1D``, ``ShallowHlle1D``,
``ShallowBathyFwave1D``, ``SwAug1D``).  Dry states
(h = 0) give inf/nan in the Roe solver, as in the reference; the
bathymetry f-wave and augmented solvers guard their divisions with
``dry_tolerance`` (default 1e-8).  The SharpClaw hooks of
the Roe and HLLE records: ``_evec_shallow :230`` and ``_flux_shallow
:266`` (the bathymetry f-wave records have neither, as in the JAX
package); nor does ``sw_aug_2D``, whose SharpClaw route is the generic
dq (``sharpclaw/kernels.py:dq_nd``).
"""

from __future__ import annotations

import torch


def _mk(num_eqn, mu, mv, z, h_c, mu_c, mv_c):
    """A wave (num_eqn, *n) with components h, normal and transverse
    momentum at rows 0, ``mu`` and ``mv``; any further row is ``z``."""
    comp = [z] * num_eqn
    comp[0], comp[mu], comp[mv] = h_c, mu_c, mv_c
    return torch.stack(comp)


def _rp1_shallow_roe(ixy, q_l, q_r, aux_l, aux_r, params, efix=True):
    """1D Roe solver, q = (h, hu): two waves at u_hat -+ c_hat, with
    Harten's entropy fix of transonic rarefactions when ``efix``."""
    g = params["grav"]
    h_l, h_r = q_l[0], q_r[0]
    hu_l, hu_r = q_l[1], q_r[1]
    u_l, u_r = hu_l / h_l, hu_r / h_r

    sh_l, sh_r = torch.sqrt(h_l), torch.sqrt(h_r)
    u = (sh_l * u_l + sh_r * u_r) / (sh_l + sh_r)
    c = torch.sqrt(g * 0.5 * (h_l + h_r))

    d = q_r - q_l
    a1 = 0.5 * ((u + c) * d[0] - d[1]) / c
    a2 = 0.5 * (-(u - c) * d[0] + d[1]) / c

    w1 = torch.stack([a1, a1 * (u - c)])
    w2 = torch.stack([a2, a2 * (u + c)])
    wave = torch.stack([w1, w2], dim=1)
    s = torch.stack([u - c, u + c])

    if not efix:
        amdq = torch.clamp(s[0], max=0.0) * w1 \
            + torch.clamp(s[1], max=0.0) * w2
        apdq = torch.clamp(s[0], min=0.0) * w1 \
            + torch.clamp(s[1], min=0.0) * w2
        return wave, s, amdq, apdq

    # Harten entropy fix (transonic rarefactions)
    c_l = torch.sqrt(g * h_l)
    c_r = torch.sqrt(g * h_r)
    # the state between the waves
    hm = h_l + a1
    hum = hu_l + a1 * (u - c)
    um = hum / torch.where(hm <= 0.0, 1.0, hm)
    cm = torch.sqrt(g * torch.clamp(hm, min=0.0))

    lam1_l = u_l - c_l
    lam1_m = um - cm
    trans1 = (lam1_l < 0.0) & (lam1_m > 0.0)
    den1 = torch.where(lam1_m - lam1_l == 0.0, 1.0, lam1_m - lam1_l)
    sf1 = torch.where(trans1, lam1_l * (lam1_m - s[0]) / den1,
                      torch.clamp(s[0], max=0.0))

    lam2_m = um + cm
    lam2_r = u_r + c_r
    trans2 = (lam2_m < 0.0) & (lam2_r > 0.0)
    den2 = torch.where(lam2_r - lam2_m == 0.0, 1.0, lam2_r - lam2_m)
    sf2 = torch.where(trans2, lam2_m * (lam2_r - s[1]) / den2,
                      torch.clamp(s[1], max=0.0))

    amdq = sf1 * w1 + sf2 * w2
    df = s[0] * w1 + s[1] * w2
    apdq = df - amdq
    return wave, s, amdq, apdq


def _rp1_shallow_with_efix(ixy, q_l, q_r, aux_l, aux_r, params):
    return _rp1_shallow_roe(ixy, q_l, q_r, aux_l, aux_r, params, efix=True)


def _rp1_shallow_hlle(ixy, q_l, q_r, aux_l, aux_r, params):
    """1D HLLE solver: two waves through the intermediate state, at the
    Einfeldt speeds (the Roe speeds bounded by the cells' own)."""
    g = params["grav"]
    h_l, h_r = q_l[0], q_r[0]
    u_l, u_r = q_l[1] / h_l, q_r[1] / h_r
    c_l = torch.sqrt(g * h_l)
    c_r = torch.sqrt(g * h_r)
    sh_l, sh_r = torch.sqrt(h_l), torch.sqrt(h_r)
    u = (sh_l * u_l + sh_r * u_r) / (sh_l + sh_r)
    c = torch.sqrt(g * 0.5 * (h_l + h_r))

    s1 = torch.minimum(u - c, u_l - c_l)
    s2 = torch.maximum(u + c, u_r + c_r)
    f_l = torch.stack([q_l[1], h_l * u_l * u_l + 0.5 * g * h_l * h_l])
    f_r = torch.stack([q_r[1], h_r * u_r * u_r + 0.5 * g * h_r * h_r])
    denom = torch.where(s2 - s1 == 0.0, 1.0, s2 - s1)
    q_m = (s2 * q_r - s1 * q_l - (f_r - f_l)) / denom

    wave = torch.stack([q_m - q_l, q_r - q_m], dim=1)
    s = torch.stack([s1, s2])
    amdq = torch.clamp(s1, max=0.0) * wave[:, 0] \
        + torch.clamp(s2, max=0.0) * wave[:, 1]
    apdq = torch.clamp(s1, min=0.0) * wave[:, 0] \
        + torch.clamp(s2, min=0.0) * wave[:, 1]
    return wave, s, amdq, apdq


def _rp1_shallow_bathymetry_fwave(ixy, q_l, q_r, aux_l, aux_r, params):
    """Well-balanced 1D f-wave solver over bathymetry aux[0] = b: the flux
    jump augmented by g h_bar (b_r - b_l), split into two f-waves at the
    Einfeldt speeds, so that a lake at rest has zero fluctuations.  Use
    with ``solver.fwave = True``."""
    g = params["grav"]
    h_l, h_r = q_l[0], q_r[0]
    hu_l, hu_r = q_l[1], q_r[1]
    u_l, u_r = hu_l / h_l, hu_r / h_r
    b_l, b_r = aux_l[0], aux_r[0]

    sh_l, sh_r = torch.sqrt(h_l), torch.sqrt(h_r)
    u = (sh_l * u_l + sh_r * u_r) / (sh_l + sh_r)
    c = torch.sqrt(g * 0.5 * (h_l + h_r))
    s1 = torch.minimum(u - c, u_l - torch.sqrt(g * h_l))
    s2 = torch.maximum(u + c, u_r + torch.sqrt(g * h_r))

    hbar = 0.5 * (h_l + h_r)
    fd1 = hu_r - hu_l
    fd2 = (hu_r * u_r + 0.5 * g * h_r * h_r) \
        - (hu_l * u_l + 0.5 * g * h_l * h_l) \
        + g * hbar * (b_r - b_l)

    denom = torch.where(s2 - s1 == 0.0, 1.0, s2 - s1)
    beta1 = (s2 * fd1 - fd2) / denom
    beta2 = (fd2 - s1 * fd1) / denom

    w1 = torch.stack([beta1, beta1 * s1])
    w2 = torch.stack([beta2, beta2 * s2])
    wave = torch.stack([w1, w2], dim=1)
    s = torch.stack([s1, s2])
    zero = torch.zeros_like(w1)
    amdq = torch.where(s1 < 0.0, w1, zero) + torch.where(s2 < 0.0, w2, zero)
    apdq = torch.where(s1 >= 0.0, w1, zero) \
        + torch.where(s2 >= 0.0, w2, zero)
    return wave, s, amdq, apdq


def _rpn2_shallow_roe(ixy, q_l, q_r, aux_l, aux_r, params):
    """Roe solver with the shear wave and Harten's entropy fix on waves 1
    and 3: (wave (num_eqn, 3, *n), s (3, *n), amdq, apdq)."""
    g = params["grav"]
    mu = 1 + ixy
    mv = 2 - ixy
    h_l, h_r = q_l[0], q_r[0]
    u_l, u_r = q_l[mu] / h_l, q_r[mu] / h_r
    v_l, v_r = q_l[mv] / h_l, q_r[mv] / h_r

    sh_l, sh_r = torch.sqrt(h_l), torch.sqrt(h_r)
    wgt = 1.0 / (sh_l + sh_r)
    u = (sh_l * u_l + sh_r * u_r) * wgt
    v = (sh_l * v_l + sh_r * v_r) * wgt
    c = torch.sqrt(g * 0.5 * (h_l + h_r))

    d0 = q_r[0] - q_l[0]
    dmu = q_r[mu] - q_l[mu]
    dmv = q_r[mv] - q_l[mv]

    a1 = 0.5 * ((u + c) * d0 - dmu) / c
    a2 = dmv - v * d0                      # shear strength
    a3 = 0.5 * (-(u - c) * d0 + dmu) / c

    num_eqn = q_l.shape[0]
    z = torch.zeros_like(d0)
    w1 = _mk(num_eqn, mu, mv, z, a1, a1 * (u - c), a1 * v)
    w2 = _mk(num_eqn, mu, mv, z, z, z, a2)
    w3 = _mk(num_eqn, mu, mv, z, a3, a3 * (u + c), a3 * v)
    wave = torch.stack([w1, w2, w3], dim=1)
    s = torch.stack([u - c, u, u + c])

    # entropy fix on waves 1 and 3
    c_l = torch.sqrt(g * h_l)
    c_r = torch.sqrt(g * h_r)
    hm = h_l + a1
    hum = q_l[mu] + a1 * (u - c)
    um = hum / torch.where(hm <= 0.0, 1.0, hm)
    cm = torch.sqrt(g * torch.clamp(hm, min=0.0))

    lam1_l = u_l - c_l
    lam1_m = um - cm
    trans1 = (lam1_l < 0.0) & (lam1_m > 0.0)
    den1 = torch.where(lam1_m - lam1_l == 0.0, 1.0, lam1_m - lam1_l)
    sf1 = torch.where(trans1, lam1_l * (lam1_m - s[0]) / den1,
                      torch.clamp(s[0], max=0.0))

    sf2 = torch.clamp(s[1], max=0.0)

    hm3 = h_r - a3
    hum3 = q_r[mu] - a3 * (u + c)
    um3 = hum3 / torch.where(hm3 <= 0.0, 1.0, hm3)
    cm3 = torch.sqrt(g * torch.clamp(hm3, min=0.0))
    lam3_m = um3 + cm3
    lam3_r = u_r + c_r
    trans3 = (lam3_m < 0.0) & (lam3_r > 0.0)
    den3 = torch.where(lam3_r - lam3_m == 0.0, 1.0, lam3_r - lam3_m)
    sf3 = torch.where(trans3, lam3_m * (lam3_r - s[2]) / den3,
                      torch.clamp(s[2], max=0.0))

    amdq = sf1 * w1 + sf2 * w2 + sf3 * w3
    df = s[0] * w1 + s[1] * w2 + s[2] * w3
    apdq = df - amdq
    return wave, s, amdq, apdq


def _rpt2_shallow_roe(ixy, imp, q_l, q_r, aux_l, aux_r, asdq, params):
    """Transverse split (rpt2_shallow_roe_with_efix.f90): decompose asdq
    in the transverse direction at the Roe average, which it computes
    itself (shallow water has no shared-eigensystem hook)."""
    g = params["grav"]
    mu = 1 + ixy
    mv = 2 - ixy
    h_l, h_r = q_l[0], q_r[0]
    u_l, u_r = q_l[mu] / h_l, q_r[mu] / h_r
    v_l, v_r = q_l[mv] / h_l, q_r[mv] / h_r
    sh_l, sh_r = torch.sqrt(h_l), torch.sqrt(h_r)
    wgt = 1.0 / (sh_l + sh_r)
    u = (sh_l * u_l + sh_r * u_r) * wgt
    v = (sh_l * v_l + sh_r * v_r) * wgt
    c = torch.sqrt(g * 0.5 * (h_l + h_r))

    d0, dmu, dmv = asdq[0], asdq[mu], asdq[mv]
    b1 = 0.5 * ((v + c) * d0 - dmv) / c
    b2 = dmu - u * d0
    b3 = 0.5 * (-(v - c) * d0 + dmv) / c

    num_eqn = q_l.shape[0]
    z = torch.zeros_like(d0)
    w1 = _mk(num_eqn, mu, mv, z, b1, b1 * u, b1 * (v - c))
    w2 = _mk(num_eqn, mu, mv, z, z, b2, z)
    w3 = _mk(num_eqn, mu, mv, z, b3, b3 * u, b3 * (v + c))

    bmasdq = torch.zeros_like(asdq)
    bpasdq = torch.zeros_like(asdq)
    for w, sp in zip((w1, w2, w3), (v - c, v, v + c)):
        bmasdq = bmasdq + torch.clamp(sp, max=0.0) * w
        bpasdq = bpasdq + torch.clamp(sp, min=0.0) * w
    return bmasdq, bpasdq


def _rpn2_shallow_bathymetry_fwave(ixy, q_l, q_r, aux_l, aux_r, params):
    """Well-balanced f-wave solver over bathymetry aux[0] = b: two
    gravity f-waves at HLLE-bounded Roe speeds carrying the normal flux
    jump augmented by g h_bar (b_r - b_l), and a transverse-momentum
    f-wave at the Roe normal speed.  Lake at rest has zero fluctuations.
    Use with solver.fwave = True."""
    g = params["grav"]
    dry = params.get("dry_tolerance", 1e-8)
    mu = 1 + ixy
    mv = 2 - ixy

    h_l, h_r = q_l[0], q_r[0]
    wet_l, wet_r = h_l > dry, h_r > dry
    hs_l = torch.where(wet_l, h_l, 1.0)
    hs_r = torch.where(wet_r, h_r, 1.0)
    u_l = torch.where(wet_l, q_l[mu] / hs_l, 0.0)
    u_r = torch.where(wet_r, q_r[mu] / hs_r, 0.0)
    v_l = torch.where(wet_l, q_l[mv] / hs_l, 0.0)
    v_r = torch.where(wet_r, q_r[mv] / hs_r, 0.0)
    b_l, b_r = aux_l[0], aux_r[0]

    sh_l = torch.sqrt(torch.clamp(h_l, min=0.0))
    sh_r = torch.sqrt(torch.clamp(h_r, min=0.0))
    denom_roe = torch.where(sh_l + sh_r > 0.0, sh_l + sh_r, 1.0)
    u = (sh_l * u_l + sh_r * u_r) / denom_roe
    c = torch.sqrt(g * 0.5 * (h_l + h_r))
    s1 = torch.minimum(u - c,
                       u_l - torch.sqrt(g * torch.clamp(h_l, min=0.0)))
    s3 = torch.maximum(u + c,
                       u_r + torch.sqrt(g * torch.clamp(h_r, min=0.0)))
    s2 = u

    hbar = 0.5 * (h_l + h_r)
    fd1 = q_r[mu] - q_l[mu]
    fd2 = (q_r[mu] * u_r + 0.5 * g * h_r * h_r) \
        - (q_l[mu] * u_l + 0.5 * g * h_l * h_l) \
        + g * hbar * (b_r - b_l)
    fd3 = q_r[mu] * v_r - q_l[mu] * v_l

    denom = torch.where(s3 - s1 == 0.0, 1.0, s3 - s1)
    beta1 = (s3 * fd1 - fd2) / denom
    beta3 = (fd2 - s1 * fd1) / denom

    num_eqn = q_l.shape[0]
    z = torch.zeros_like(h_l)
    w1 = _mk(num_eqn, mu, mv, z, beta1, beta1 * s1, beta1 * v_l)
    w3 = _mk(num_eqn, mu, mv, z, beta3, beta3 * s3, beta3 * v_r)
    w2 = _mk(num_eqn, mu, mv, z, z, z, fd3 - beta1 * v_l - beta3 * v_r)
    wave = torch.stack([w1, w2, w3], dim=1)
    s = torch.stack([s1, s2, s3])

    amdq = torch.zeros_like(q_l)
    apdq = torch.zeros_like(q_l)
    for w, sp in ((w1, s1), (w2, s2), (w3, s3)):
        amdq = amdq + torch.where(sp < 0.0, w, 0.0)
        apdq = apdq + torch.where(sp >= 0.0, w, 0.0)
    return wave, s, amdq, apdq


def _shallow_positivity(q, aux, params):
    return q[0] > 0.0


def _evec_shallow(ixy, q, aux, params):
    """Eigenvector matrices (R, L) of the shallow-water Jacobian along
    ``ixy`` at each cell state (the char_decomp hook): (2, 2, *n) in 1D,
    (h, hu); (3, 3, *n) in 2D, (h, hu, hv), the transverse momentum riding
    the u-eigenvalue contact."""
    g = params["grav"]
    h = q[0]
    c = torch.sqrt(g * h)
    if q.shape[0] == 2:
        u = q[1] / h
        one = torch.ones_like(u)
        inv2c = 0.5 / c
        R = torch.stack([torch.stack([one, one]),
                         torch.stack([u - c, u + c])])
        L = torch.stack([torch.stack([(u + c) * inv2c, -one * inv2c]),
                         torch.stack([-(u - c) * inv2c, one * inv2c])])
        return R, L
    mu = 1 + ixy
    mv = 2 - ixy
    un = q[mu] / h
    ut = q[mv] / h
    one = torch.ones_like(un)
    zero = torch.zeros_like(un)
    inv2c = 0.5 / c
    R = [[zero] * 3 for _ in range(3)]
    L = [[zero] * 3 for _ in range(3)]
    R[0][0], R[mu][0], R[mv][0] = one, un - c, ut
    R[mv][1] = one
    R[0][2], R[mu][2], R[mv][2] = one, un + c, ut
    L[0][0], L[0][mu] = (un + c) * inv2c, -inv2c
    L[1][0], L[1][mv] = -ut, one
    L[2][0], L[2][mu] = -(un - c) * inv2c, inv2c
    return (torch.stack([torch.stack(r) for r in R]),
            torch.stack([torch.stack(r) for r in L]))


def _flux_shallow(ixy, q, aux, params):
    """Shallow-water flux along ``ixy``: [hu, hu^2 + g h^2/2, huv]
    (RiemannSolver.flux, flat bottom), zero in a dry cell."""
    g = params["grav"]
    h = q[0]
    mu = 1 + ixy
    wet = h > 0.0
    u = torch.where(wet, q[mu] / torch.where(wet, h, 1.0), 0.0)
    f = [u * q[k] for k in range(q.shape[0])]   # [hu, hu*u, hv*u]
    f[mu] = f[mu] + 0.5 * g * h * h
    return torch.stack(f)


# ---- GeoClaw-class augmented solver with wetting and drying (sw_aug) ----
def _sw_aug_core(g, dry, h_l, h_r, hu_l, hu_r, b_l, b_r):
    """The dry-state machinery of the augmented solver (reference
    rpn2_sw_aug.f90, George 2008): a dry cell whose bottom lies above the
    wet neighbour's surface reflects the wet state (a wall); Einfeldt
    speeds, replaced by the Ritter front speed u -+ 2c toward a dry side;
    the HLLE-type split of the bathymetry-augmented flux jump, with the
    surface eta = h + b as the state jump.  Returns (s1, s2, W1, W2, u_hat,
    wall_l, wall_r), W_p the (h, hu) parts of wave p."""
    wet_l, wet_r = h_l > dry, h_r > dry
    u_l0 = torch.where(wet_l, hu_l / torch.where(wet_l, h_l, 1.0), 0.0)
    u_r0 = torch.where(wet_r, hu_r / torch.where(wet_r, h_r, 1.0), 0.0)

    wall_r = (~wet_r) & wet_l & (h_l + b_l <= b_r)
    wall_l = (~wet_l) & wet_r & (h_r + b_r <= b_l)

    h_le = torch.where(wall_l, h_r, torch.where(wet_l, h_l, 0.0))
    u_le = torch.where(wall_l, -u_r0, u_l0)
    b_le = torch.where(wall_l, b_r, b_l)
    h_re = torch.where(wall_r, h_l, torch.where(wet_r, h_r, 0.0))
    u_re = torch.where(wall_r, -u_l0, u_r0)
    b_re = torch.where(wall_r, b_l, b_r)
    wet_le = wet_l | wall_l
    wet_re = wet_r | wall_r
    bothdry = (~wet_le) & (~wet_re)

    c_l = torch.sqrt(g * h_le)
    c_r = torch.sqrt(g * h_re)
    sh_l, sh_r = torch.sqrt(h_le), torch.sqrt(h_re)
    wsum = torch.where(sh_l + sh_r > 0.0, sh_l + sh_r, 1.0)
    u_hat = (sh_l * u_le + sh_r * u_re) / wsum
    c_hat = torch.sqrt(g * 0.5 * (h_le + h_re))

    s1 = torch.minimum(u_le - c_l, u_hat - c_hat)
    s2 = torch.maximum(u_re + c_r, u_hat + c_hat)
    # the exact rarefaction front toward a dry side (Ritter)
    s1 = torch.where(wet_re & ~wet_le, u_re - 2.0 * c_r, s1)
    s2 = torch.where(wet_le & ~wet_re, u_le + 2.0 * c_l, s2)
    s1 = torch.where(bothdry, 0.0, s1)
    s2 = torch.where(bothdry, 0.0, s2)

    hu_le = h_le * u_le
    hu_re = h_re * u_re
    hbar = 0.5 * (h_le + h_re)
    fd1 = hu_re - hu_le
    fd2 = (hu_re * u_re + 0.5 * g * h_re * h_re) \
        - (hu_le * u_le + 0.5 * g * h_le * h_le) \
        + g * hbar * (b_re - b_le)
    # the dissipative state jump: surface and momentum
    dq1 = (h_re + b_re) - (h_le + b_le)
    dq2 = fd1

    denom = torch.where(s2 - s1 == 0.0, 1.0, s2 - s1)
    zero = torch.where(bothdry, 0.0, 1.0 / denom)
    W1 = ((s2 * dq1 - fd1) * zero, (s2 * dq2 - fd2) * zero)
    W2 = ((fd1 - s1 * dq1) * zero, (fd2 - s1 * dq2) * zero)
    u_hat = torch.where(bothdry, 0.0, u_hat)
    return s1, s2, W1, W2, u_hat, wall_l, wall_r


def _rp1_sw_aug(ixy, q_l, q_r, aux_l, aux_r, params):
    """1D augmented shallow-water solver with wetting and drying
    (GeoClaw rp1-class sw_aug): aux[0] = b(x), f-wave form (use
    solver.fwave = True); problem_data['dry_tolerance'] (default 1e-8)
    marks dry cells.  The f-waves s_p W_p are zeroed where either cell is
    dry (first order at fronts), and no fluctuation enters a dry wall
    cell."""
    g = params["grav"]
    dry = params.get("dry_tolerance", 1e-8)
    s1, s2, W1, W2, _, wall_l, wall_r = _sw_aug_core(
        g, dry, q_l[0], q_r[0], q_l[1], q_r[1], aux_l[0], aux_r[0])

    frontal = (q_l[0] <= dry) | (q_r[0] <= dry)
    z1 = torch.where(frontal, 0.0, torch.stack([s1 * W1[0], s1 * W1[1]]))
    z2 = torch.where(frontal, 0.0, torch.stack([s2 * W2[0], s2 * W2[1]]))
    wave = torch.stack([z1, z2], dim=1)
    s = torch.stack([s1, s2])
    amdq = torch.clamp(s1, max=0.0) * torch.stack(W1) \
        + torch.clamp(s2, max=0.0) * torch.stack(W2)
    apdq = torch.clamp(s1, min=0.0) * torch.stack(W1) \
        + torch.clamp(s2, min=0.0) * torch.stack(W2)
    amdq = torch.where(wall_l, 0.0, amdq)
    apdq = torch.where(wall_r, 0.0, apdq)
    return wave, s, amdq, apdq


def _rpn2_sw_aug(ixy, q_l, q_r, aux_l, aux_r, params):
    """2D augmented shallow-water solver with wetting and drying
    (reference rpn2_sw_aug.f90): the machinery of :func:`_sw_aug_core`
    along the normal, and a shear wave of speed u_hat carrying the
    transverse momentum.  aux[0] = b(x, y), f-wave form (use
    solver.fwave = True).  The f-waves are zeroed where either cell is
    dry, and no fluctuation enters a dry wall cell."""
    g = params["grav"]
    dry = params.get("dry_tolerance", 1e-8)
    mu = 1 + ixy
    mv = 2 - ixy

    h_l, h_r = q_l[0], q_r[0]
    wet_l, wet_r = h_l > dry, h_r > dry
    v_l = torch.where(wet_l, q_l[mv] / torch.where(wet_l, h_l, 1.0), 0.0)
    v_r = torch.where(wet_r, q_r[mv] / torch.where(wet_r, h_r, 1.0), 0.0)

    s1, s3, W1, W3, u_hat, wall_l, wall_r = _sw_aug_core(
        g, dry, h_l, h_r, q_l[mu], q_r[mu], aux_l[0], aux_r[0])
    s2 = u_hat                       # the shear rides the normal flow

    # the transverse momentum advects with the normal flow
    hu_le = torch.where(wet_l | wall_l,
                        torch.where(wall_l, -q_r[mu], q_l[mu]), 0.0)
    hu_re = torch.where(wet_r | wall_r,
                        torch.where(wall_r, -q_l[mu], q_r[mu]), 0.0)
    fd3 = hu_re * v_r - hu_le * v_l

    num_eqn = q_l.shape[0]
    z = torch.zeros_like(h_l)
    zv1 = _mk(num_eqn, mu, mv, z, s1 * W1[0], s1 * W1[1], s1 * W1[0] * v_l)
    zv3 = _mk(num_eqn, mu, mv, z, s3 * W3[0], s3 * W3[1], s3 * W3[0] * v_r)
    zv2 = _mk(num_eqn, mu, mv, z, z, z,
              fd3 - s1 * W1[0] * v_l - s3 * W3[0] * v_r)
    # first order at wet/dry fronts (see _rp1_sw_aug)
    frontal = (~wet_l) | (~wet_r)
    wave = torch.where(frontal, 0.0, torch.stack([zv1, zv2, zv3], dim=1))
    s = torch.stack([s1, s2, s3])

    wv1 = _mk(num_eqn, mu, mv, z, W1[0], W1[1], W1[0] * v_l)
    wv3 = _mk(num_eqn, mu, mv, z, W3[0], W3[1], W3[0] * v_r)
    amdq = torch.clamp(s1, max=0.0) * wv1 + torch.clamp(s3, max=0.0) * wv3 \
        + torch.where(s2 < 0.0, zv2, 0.0)
    apdq = torch.clamp(s1, min=0.0) * wv1 + torch.clamp(s3, min=0.0) * wv3 \
        + torch.where(s2 >= 0.0, zv2, 0.0)
    amdq = torch.where(wall_l, 0.0, amdq)
    apdq = torch.where(wall_r, 0.0, apdq)
    return wave, s, amdq, apdq


def _rpt2_sw_aug(ixy, imp, q_l, q_r, aux_l, aux_r, asdq, params):
    """The transverse split of the augmented solver: that of
    :func:`_rpt2_shallow_roe` where both cells are wet, none elsewhere
    (the dry cells' states replaced by ones before the split)."""
    dry = params.get("dry_tolerance", 1e-8)
    wet = (q_l[0] > dry) & (q_r[0] > dry)
    ql_s = torch.where(wet[None], q_l, torch.ones_like(q_l))
    qr_s = torch.where(wet[None], q_r, torch.ones_like(q_r))
    bmasdq, bpasdq = _rpt2_shallow_roe(ixy, imp, ql_s, qr_s, aux_l, aux_r,
                                       asdq, params)
    return (torch.where(wet[None], bmasdq, 0.0),
            torch.where(wet[None], bpasdq, 0.0))


def _sw_aug_positivity(q, aux, params):
    dry = params.get("dry_tolerance", 1e-8)
    return q[0] > dry


from . import RiemannSolver  # noqa: E402

shallow_roe_with_efix_1D = RiemannSolver(
    "shallow_roe_with_efix_1D", 1, 2, 2, _rp1_shallow_with_efix,
    requires=("grav",))
shallow_hlle_1D = RiemannSolver("shallow_hlle_1D", 1, 2, 2,
                                _rp1_shallow_hlle, requires=("grav",))
shallow_roe_with_efix_2D = RiemannSolver(
    "shallow_roe_with_efix_2D", 2, 3, 3, _rpn2_shallow_roe,
    rpt=_rpt2_shallow_roe, requires=("grav",))
for _s in (shallow_roe_with_efix_1D, shallow_hlle_1D,
           shallow_roe_with_efix_2D):
    _s.positivity = _shallow_positivity
    _s.evec = _evec_shallow
    _s.flux = _flux_shallow

shallow_bathymetry_fwave_1D = RiemannSolver(
    "shallow_bathymetry_fwave_1D", 1, 2, 2, _rp1_shallow_bathymetry_fwave,
    requires=("grav",))
shallow_bathymetry_fwave_1D.positivity = _shallow_positivity

shallow_bathymetry_fwave_2D = RiemannSolver(
    "shallow_bathymetry_fwave_2D", 2, 3, 3, _rpn2_shallow_bathymetry_fwave,
    rpt=_rpt2_shallow_roe, requires=("grav",))
shallow_bathymetry_fwave_2D.positivity = _shallow_positivity

sw_aug_1D = RiemannSolver("sw_aug_1D", 1, 2, 2, _rp1_sw_aug,
                          requires=("grav",))
sw_aug_1D.positivity = _sw_aug_positivity

sw_aug_2D = RiemannSolver("sw_aug_2D", 2, 3, 3, _rpn2_sw_aug,
                          rpt=_rpt2_sw_aug, requires=("grav",))
sw_aug_2D.positivity = _sw_aug_positivity
