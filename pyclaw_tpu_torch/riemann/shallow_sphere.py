"""Shallow water on a rotating sphere, f-wave Riemann solver and source
hook, plain PyTorch.

Counterpart of ``pyclaw_tpu/riemann/shallow_sphere.py``
(``_rp_shallow_sphere_fwave :42``, ``make_sphere_source :105``, the
``shallow_sphere_fwave_2D`` record ``:141``), itself a redesign of
reference ``riemann/src/rpn2_shallow_sphere.f90`` on a lat-lon patch
(lon, lat) = (lambda, theta) with q = (h, hu, hv), true velocities:

    kappa h_t  + (h u)_lambda / a + (kappa h v)_theta / a         = 0
    kappa(hu)_t + (hu^2+p)_lambda / a + (kappa huv)_theta / a     = kappa S_u
    kappa(hv)_t + (huv)_lambda / a + (kappa(hv^2+p))_theta / a    = kappa S_v

with kappa = cos(theta) the capacity, p = g h^2 / 2 and the Coriolis and
metric sources of :func:`make_sphere_source`.  The theta f-wave carries
the cell-centred kappa of each side inside it (Z = kappa_r G(q_r) -
kappa_l G(q_l)); the lambda f-wave is unweighted.  aux[0] = cos(theta) at
the cell's lower theta edge, aux[1] = cos(theta) at its centre (the
capacity, ``index_capa = 1``).  The record has no ``rpt``: the unsplit
step runs without a transverse pass; its example runs split.  Use with
``solver.fwave = True``.

Every expression keeps the JAX package's operation order, so in float64
the two agree to roundoff (tests/test_torch_split.py).  The CUDA kernel
repeats the Riemann solver: ``csrc/shallow_sphere2d.cuh``
(``step2_aos.cu``'s ``ShallowSphere2D``).
"""

from __future__ import annotations

import numpy as np
import torch


def _rp_shallow_sphere_fwave(ixy, q_l, q_r, aux_l, aux_r, params):
    g = params["grav"]
    h_l, h_r = q_l[0], q_r[0]
    mu = 1 + ixy          # normal momentum component
    mv = 2 - ixy          # transverse momentum component

    u_l = q_l[mu] / h_l
    u_r = q_r[mu] / h_r
    v_l = q_l[mv] / h_l
    v_r = q_r[mv] / h_r

    # Roe averages
    sqh_l = torch.sqrt(h_l)
    sqh_r = torch.sqrt(h_r)
    h_bar = 0.5 * (h_l + h_r)
    u_hat = (sqh_l * u_l + sqh_r * u_r) / (sqh_l + sqh_r)
    v_hat = (sqh_l * v_l + sqh_r * v_r) / (sqh_l + sqh_r)
    c_hat = torch.sqrt(g * h_bar)

    # the flux jump, with the cell-centred kappa of each side along theta
    p_l = 0.5 * g * h_l * h_l
    p_r = 0.5 * g * h_r * h_r
    if ixy == 1:
        kap_l = aux_l[1]
        kap_r = aux_r[1]
    else:
        kap_l = kap_r = 1.0
    dF0 = kap_r * q_r[mu] - kap_l * q_l[mu]
    dFmu = kap_r * (q_r[mu] * u_r + p_r) - kap_l * (q_l[mu] * u_l + p_l)
    dFmv = kap_r * q_r[mu] * v_r - kap_l * q_l[mu] * v_l

    # onto the Roe eigenvectors r1 = (1, u-c, v), r2 = (0, 0, 1),
    # r3 = (1, u+c, v) (components (h, mu, mv))
    b1 = ((u_hat + c_hat) * dF0 - dFmu) / (2.0 * c_hat)
    b3 = (dFmu - (u_hat - c_hat) * dF0) / (2.0 * c_hat)
    b2 = dFmv - v_hat * dF0

    num_eqn = q_l.shape[0]
    z = torch.zeros_like(h_l)

    def mk(h_c, mu_c, mv_c):
        comp = [z] * num_eqn
        comp[0], comp[mu], comp[mv] = h_c, mu_c, mv_c
        return torch.stack(comp)

    w1 = mk(b1, b1 * (u_hat - c_hat), b1 * v_hat)
    w2 = mk(z, z, b2)
    w3 = mk(b3, b3 * (u_hat + c_hat), b3 * v_hat)
    wave = torch.stack([w1, w2, w3], dim=1)
    s = torch.stack([u_hat - c_hat, u_hat, u_hat + c_hat])

    # left-going f-waves into amdq, the others into apdq
    amdq = torch.zeros_like(q_l)
    apdq = torch.zeros_like(q_l)
    for p in range(3):
        neg = s[p] < 0.0
        amdq = amdq + torch.where(neg, wave[:, p], 0.0)
        apdq = apdq + torch.where(neg, 0.0, wave[:, p])
    return wave, s, amdq, apdq


def make_sphere_source(grid, radius=1.0, omega=0.0, grav=1.0):
    """The Coriolis and metric source hook for ``ClawSolver.step_source``
    (reference shallow_sphere src2.f90): a Heun (RK2) update of

        (hu)_t =  (f + u tan(theta)/a) h v
        (hv)_t = -(f + u tan(theta)/a) h u - tan(theta)/a * (g h^2/2)

    with f = 2 omega sin(theta), as the JAX package's hook.  It closes
    over the grid's latitude array (the whole grid's cells), which it
    holds on q's device in q's dtype from its first call; it is marked
    ``global_grid`` so that the parallel overlay, whose ranks hold blocks
    of the grid, refuses it."""
    theta = np.asarray(grid.c_centers[1])
    tanth_np = np.tan(theta)
    f_cor_np = 2.0 * omega * np.sin(theta)
    a = radius
    held = {}

    def arrays(q):
        key = (q.device, q.dtype)
        if key not in held:
            held[key] = (torch.as_tensor(tanth_np, dtype=q.dtype,
                                         device=q.device),
                         torch.as_tensor(f_cor_np, dtype=q.dtype,
                                         device=q.device))
        return held[key]

    def rates(q):
        tanth, f_cor = arrays(q)
        h, hu, hv = q[0], q[1], q[2]
        u = hu / h
        coef = f_cor + u * tanth / a
        s_hu = coef * hv
        s_hv = -coef * hu - (tanth / a) * (0.5 * grav * h * h)
        return torch.stack([torch.zeros_like(h), s_hu, s_hv])

    def step_source(solver, state, q, dt):
        k1 = rates(q)
        k2 = rates(q + dt * k1)
        return q + 0.5 * dt * (k1 + k2)

    step_source.global_grid = True
    return step_source


from . import RiemannSolver  # noqa: E402

shallow_sphere_fwave_2D = RiemannSolver("shallow_sphere_fwave_2D", 2, 3, 3,
                                        _rp_shallow_sphere_fwave,
                                        requires=("grav",))
