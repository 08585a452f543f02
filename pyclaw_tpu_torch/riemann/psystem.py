"""1D nonlinear-elasticity p-system Riemann solver (f-wave, heterogeneous
media; the stegoton problem), plain PyTorch.

Counterpart of ``pyclaw_tpu/riemann/psystem.py`` (``_rp_psystem :27-63``,
the record ``psystem_1D :69``), physics of reference
``riemann/src/rp1_psystem.f90``: q = (eps, rho u) with

    eps_t - u_x = 0
    (rho u)_t - sigma(eps, x)_x = 0,

aux = (rho, K) and sigma = exp(K eps) - 1 (``stress_relation`` "exp", the
default) or K eps ("linear").  The flux jump (-(u_r - u_l), -(sig_r -
sig_l)) splits against the one-sided eigenvectors (1, Z_l) and (1, -Z_r),
Z = sqrt(rho sigma'), into two f-waves at -c_l and c_r.  Use with
``solver.fwave = True``.

Every expression keeps the JAX package's operation order (the stress law
is ``psystem2d.stress``, which the 2D record shares), so in float64 the
two agree to roundoff (tests/test_torch_riemann_1d_library.py).  The CUDA
kernel repeats it: ``csrc/systems1d.cuh`` (``step1.cu``'s ``Psystem1D``).
"""

from __future__ import annotations

import torch

from .psystem2d import stress


def _rp_psystem(ixy, q_l, q_r, aux_l, aux_r, params):
    linear = params.get("stress_relation", "exp") == "linear"
    rho_l, K_l = aux_l[0], aux_l[1]
    rho_r, K_r = aux_r[0], aux_r[1]
    u_l = q_l[1] / rho_l
    u_r = q_r[1] / rho_r

    sig_l, sigp_l = stress(q_l[0], K_l, linear)
    sig_r, sigp_r = stress(q_r[0], K_r, linear)

    z_l = torch.sqrt(rho_l * sigp_l)
    z_r = torch.sqrt(rho_r * sigp_r)
    c_l = torch.sqrt(sigp_l / rho_l)
    c_r = torch.sqrt(sigp_r / rho_r)

    df1 = -(u_r - u_l)
    df2 = -(sig_r - sig_l)
    denom = z_l + z_r
    b1 = (df2 + z_r * df1) / denom
    b2 = (z_l * df1 - df2) / denom

    w1 = torch.stack([b1, b1 * z_l])
    w2 = torch.stack([b2, -b2 * z_r])
    wave = torch.stack([w1, w2], dim=1)
    s = torch.stack([-c_l, c_r])
    return wave, s, w1, w2


from . import RiemannSolver  # noqa: E402

psystem_1D = RiemannSolver("psystem_1D", 1, 2, 2, _rp_psystem)
