"""2D nonlinear p-system Riemann solver (f-wave, heterogeneous media),
plain PyTorch.

Counterpart of ``pyclaw_tpu/riemann/psystem2d.py`` (``_rpn2_psystem
:24``, the ``psystem_2D`` record ``:65``), a rebuild of reference
``riemann/src/rp2_psystem.f90``.  q = (eps, rho u, rho v) with

    eps_t - u_x - v_y = 0
    (rho u)_t - sigma(eps, x, y)_x = 0
    (rho v)_t - sigma(eps, x, y)_y = 0,

aux = (rho, K) and sigma = exp(K eps) - 1 (``stress_relation`` "exp", the
default) or K eps ("linear").  Two f-waves at speeds -c_l and c_r; the
transverse momentum rides passively.  The record has no ``rpt``: the
unsplit 2D step runs without a transverse pass, and its example runs
split.  Use with ``solver.fwave = True``.

Every expression keeps the JAX package's operation order, so in float64
the two agree to roundoff (tests/test_torch_split.py).  The CUDA kernel
repeats it: ``csrc/psystem2d.cuh`` (``step2_aos.cu``'s ``Psystem2D``).
"""

from __future__ import annotations

import torch


def stress(eps, K, linear):
    """(sigma, sigma') of the stress law at strain ``eps`` and modulus
    ``K``."""
    if linear:
        return K * eps, K
    e = torch.exp(K * eps)
    return e - 1.0, K * e


def _rpn2_psystem(ixy, q_l, q_r, aux_l, aux_r, params):
    linear = params.get("stress_relation", "exp") == "linear"
    mu = 1 + ixy
    rho_l, K_l = aux_l[0], aux_l[1]
    rho_r, K_r = aux_r[0], aux_r[1]
    eps_l, eps_r = q_l[0], q_r[0]
    u_l = q_l[mu] / rho_l
    u_r = q_r[mu] / rho_r

    sig_l, sigp_l = stress(eps_l, K_l, linear)
    sig_r, sigp_r = stress(eps_r, K_r, linear)

    z_l = torch.sqrt(rho_l * sigp_l)
    z_r = torch.sqrt(rho_r * sigp_r)
    c_l = torch.sqrt(sigp_l / rho_l)
    c_r = torch.sqrt(sigp_r / rho_r)

    df1 = -(u_r - u_l)
    df2 = -(sig_r - sig_l)
    denom = z_l + z_r
    b1 = (df2 + z_r * df1) / denom
    b2 = (z_l * df1 - df2) / denom

    num_eqn = q_l.shape[0]
    z = torch.zeros_like(df1)

    def mk(e_c, m_c):
        comp = [z] * num_eqn
        comp[0] = e_c
        comp[mu] = m_c
        return torch.stack(comp)

    w1 = mk(b1, b1 * z_l)
    w2 = mk(b2, -b2 * z_r)
    wave = torch.stack([w1, w2], dim=1)
    s = torch.stack([-c_l, c_r])
    return wave, s, w1, w2


from . import RiemannSolver  # noqa: E402

psystem_2D = RiemannSolver("psystem_2D", 2, 3, 2, _rpn2_psystem)
