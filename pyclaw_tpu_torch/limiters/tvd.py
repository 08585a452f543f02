"""TVD wave limiters, plain PyTorch.

Counterpart of ``pyclaw_tpu/limiters/tvd.py`` (``_phi :65``,
``_phi_cfl :109``, ``CFL_LIMITER_IDS :143``, ``limiter_phi :152``),
itself a rebuild of reference ``src/pyclaw/limiters/tvd.py`` and
``classic/limiter.f90``.
The limiter ratio for wave p at interface I is the upwind-side projection

    theta = <W_upwind, W_I> / <W_I, W_I>,   upwind = I-1 if s>0 else I+1

and the wave is scaled by phi(theta).  Ids match the reference table:

    0 none (Lax-Wendroff)   1 minmod        2 superbee   3 van Leer
    4 MC                    5 Beam-Warming  6 Fromm      7 van Albada 2
    8 van Albada 3          9 van Leer w/ Klein sharpening (k=2)
    16 Sweby beta=1.5       19/20 Cada-Torrilhon        21 upper bound

CFL-dependent ids (nu = |s| dt/dx at the interface):

    10 Arora-Roe            11 theta=0.95   12 theta=1.0
    13 theta=0.45           14 CFL-superbee 15 CFL-superbee theta=0.95
    17 hyperbee             18 superpower

Every formula repeats the JAX package's operation order, so the two agree
to the last bit or two (tests/test_torch_limiters.py).  The CUDA kernels
repeat them once more (``csrc/tvd.cuh: phi_limiter``).
"""

from __future__ import annotations

import torch

from .._slicing import slc

minmod = 1
superbee = 2
vanleer = 3  # reference name: van_leer
MC = 4
beam_warming = 5
fromm = 6
albada_2 = 7
albada_3 = 8
van_leer_klein_sharpening = 9
arora_roe = 10
theta_95 = 11
theta_1 = 12
theta_45 = 13
cfl_superbee = 14
cfl_superbee_theta_95 = 15
beta_limiter = 16
hyperbee = 17
superpower = 18
cada_torrilhon = 19
cada_torrilhon_theta_95 = 20
upper_bound = 21

CFL_LIMITER_IDS = (10, 11, 12, 13, 14, 15, 17, 18)


def _pos(x):
    return torch.clamp(x, min=0.0)


def _phi(limiter_id, theta):
    t = theta
    if limiter_id == 0:
        return torch.ones_like(t)
    if limiter_id == 1:    # minmod
        return _pos(torch.clamp(t, max=1.0))
    if limiter_id == 2:    # superbee
        return _pos(torch.maximum(torch.clamp(2.0 * t, max=1.0),
                                  torch.clamp(t, max=2.0)))
    if limiter_id == 3:    # van Leer
        return (t + torch.abs(t)) / (1.0 + torch.abs(t))
    if limiter_id == 4:    # MC (monotonized centered)
        return _pos(torch.minimum((1.0 + t) / 2.0,
                                  torch.clamp(2.0 * t, max=2.0)))
    if limiter_id == 5:    # Beam-Warming
        return t
    if limiter_id == 6:    # Fromm
        return 0.5 * (1.0 + t)
    if limiter_id == 7:    # van Albada 2
        return _pos((t * t + t) / (t * t + 1.0))
    if limiter_id == 8:    # van Albada 3
        return _pos(2.0 * t / (t * t + 1.0))
    if limiter_id == 9:    # van Leer with Klein sharpening, k=2
        a = torch.abs(t)
        phi_vl = (t + a) / (1.0 + a)
        return torch.maximum(phi_vl, torch.clamp(2.0 * _pos(t), max=1.0))
    if limiter_id == 16:   # Sweby beta-family, beta=1.5
        beta = 1.5
        return _pos(torch.maximum(torch.clamp(beta * t, max=1.0),
                                  torch.clamp(t, max=beta)))
    if limiter_id in (19, 20):   # Cada-Torrilhon 2009 (rational form)
        th = 1.0 if limiter_id == 19 else 0.95
        base = (2.0 + t) / 3.0
        return _pos(torch.minimum(
            base, torch.maximum(-0.5 * th * t,
                                torch.minimum(2.0 * th * t,
                                              torch.clamp(base,
                                                          max=1.6 * th)))))
    if limiter_id == 21:   # upper bound (the phi <= min(2, 2 theta) edge)
        return _pos(torch.clamp(2.0 * t, max=2.0))
    raise NotImplementedError(f"limiter id {limiter_id} is CFL-dependent "
                              "or unknown; see _phi_cfl")


def _phi_cfl(limiter_id, theta, nu):
    """CFL-dependent limiters: phi(theta, nu), nu = |s| dt/dx clipped
    away from 0 and 1, clipped to the TVD region
    0 <= phi <= min(2 theta/nu, 2/(1-nu))."""
    t = theta
    nu = torch.clamp(nu, 1e-8, 1.0 - 1e-8)
    bound = torch.minimum(2.0 * t / nu, 2.0 / (1.0 - nu))
    if limiter_id == 10:   # Arora-Roe: mid-slope (1+nu)/3
        return _pos(torch.minimum(bound,
                                  1.0 + (1.0 + nu) / 3.0 * (t - 1.0)))
    if limiter_id in (11, 12, 13):  # theta limiters: mid-slope theta
        th = {11: 0.95, 12: 1.0, 13: 0.45}[limiter_id]
        return _pos(torch.minimum(bound, 1.0 + th * (t - 1.0)))
    if limiter_id == 14:   # cfl_superbee (Roe's Ultrabee: the bound)
        return _pos(bound)
    if limiter_id == 15:   # cfl_superbee with theta=0.95 safety shrink
        return _pos(0.95 * bound)
    if limiter_id == 17:   # hyperbee: compressive smooth member
        return _pos(torch.minimum(
            bound, 1.0 + 0.5 * (1.0 + nu) * (t - 1.0)))
    if limiter_id == 18:   # superpower: power mid-curve |t|^((1+nu)/3)
        return _pos(torch.minimum(
            bound, torch.abs(t) ** ((1.0 + nu) / 3.0)))
    raise NotImplementedError(f"CFL-dependent limiter id {limiter_id} "
                              "unknown")


def limiter_phi_one(limiter_id, theta, nu):
    """phi for one limiter id, dispatching on CFL dependence."""
    if int(limiter_id) in CFL_LIMITER_IDS:
        return _phi_cfl(int(limiter_id), theta, nu)
    return _phi(int(limiter_id), theta)



def _sum_eqn(a):
    """Sum over the leading (equation) axis as explicit adds in a fixed
    order, so the result does not depend on how ATen splits a
    reduction."""
    out = a[0]
    for e in range(1, a.shape[0]):
        out = out + a[e]
    return out


def limiter_phi(num_eqn, wave, s, limiter_ids, dtdx=None, axis=-1):
    """Per-wave limiter factors phi (num_waves, *n) of the AoS wave
    tensor ``wave`` (num_eqn, num_waves, *n) with speeds ``s``
    (num_waves, *n) (counterpart of the JAX package's ``limiter_phi
    :152``).  ``axis`` is the interface axis as a NEGATIVE index, so it
    names the same spatial axis in ``wave``, ``s`` and phi.  The upwind
    dot product is <W_{k-1}, W_k> where s > 0, else <W_k, W_{k+1}>; the
    end interfaces get theta = 0, and phi = 1 where the wave vanishes.
    CFL-dependent ids take nu = |s| dtdx, where ``dtdx`` is a Python float
    or a per-interface tensor shaped like ``s[p]`` (with a capacity
    function)."""
    if axis >= 0:
        raise ValueError("limiter_phi axis must be negative")
    num_waves = wave.shape[1]
    n_ifc = wave.shape[axis]
    wnorm2 = _sum_eqn(wave * wave)
    d = _sum_eqn(slc(wave, axis, slice(0, n_ifc - 1))
                 * slc(wave, axis, slice(1, n_ifc)))
    zcol = torch.zeros_like(slc(d, axis, slice(0, 1)))
    dot_right = torch.cat([d, zcol], dim=axis)
    dot_left = torch.cat([zcol, d], dim=axis)
    dotu = torch.where(s > 0.0, dot_left, dot_right)
    safe = wnorm2 > 0.0
    theta = torch.where(safe, dotu / torch.where(safe, wnorm2, 1.0), 0.0)

    phis = []
    for p in range(num_waves):
        lid = limiter_ids[p] if p < len(limiter_ids) else limiter_ids[-1]
        if lid == 0:
            phis.append(torch.ones_like(theta[p]))
            continue
        if int(lid) in CFL_LIMITER_IDS:
            if dtdx is None:
                raise ValueError(f"limiter id {lid} is CFL-dependent and "
                                 "needs dtdx")
            phi = _phi_cfl(int(lid), theta[p], torch.abs(s[p]) * dtdx)
        else:
            phi = _phi(int(lid), theta[p])
        phis.append(torch.where(safe[p], phi, 1.0))
    return torch.stack(phis, dim=0)
