"""LWR traffic-flow Riemann solver, plain PyTorch.

Counterpart of ``pyclaw_tpu/riemann/traffic.py`` (``_rp_traffic :14-33``,
``_flux_traffic :36-39``, the record ``traffic_1D :44`` with its ``flux``
hook), physics of reference ``riemann/src/rp1_traffic.f90``:
q_t + (umax q (1 - q))_x = 0.  One wave dq with the Roe speed
umax (1 - q_l - q_r); the fluctuations are the flux difference, upwinded
by the sign of that speed, except at a transonic rarefaction
(q_l > 1/2 > q_r), which splits at the sonic point q = 1/2.  umax is
problem_data's ``efix_umax``, else ``umax``, else 1.

Every expression keeps the JAX package's operation order, so in float64
the two agree to roundoff (tests/test_torch_riemann_1d_library.py).  The
CUDA kernel repeats it: ``csrc/systems1d.cuh`` (``step1.cu``'s
``Traffic1D``).
"""

from __future__ import annotations

import torch


def umax_of(params):
    """The road's top speed: ``efix_umax``, else ``umax``, else 1.0."""
    return params.get("efix_umax", params.get("umax", 1.0))


def _rp_traffic(ixy, q_l, q_r, aux_l, aux_r, params):
    umax = umax_of(params)

    def f(q):
        return umax * q * (1.0 - q)

    dq = q_r - q_l
    # the characteristic speed is umax (1 - 2q); the Roe speed:
    s = umax * (1.0 - (q_l[0] + q_r[0]))

    df = f(q_r) - f(q_l)
    zero = torch.zeros_like(df)
    amdq = torch.where(s < 0.0, df, zero)
    apdq = torch.where(s >= 0.0, df, zero)
    # transonic rarefaction: f'(q_l) < 0 < f'(q_r)
    transonic = (q_l[0] > 0.5) & (q_r[0] < 0.5)
    f_sonic = f(torch.full_like(q_l, 0.5))
    amdq = torch.where(transonic, f_sonic - f(q_l), amdq)
    apdq = torch.where(transonic, f(q_r) - f_sonic, apdq)
    return dq[:, None], s[None], amdq, apdq


def _flux_traffic(ixy, q, aux, params):
    """f = umax q (1 - q) (RiemannSolver.flux protocol)."""
    return umax_of(params) * q * (1.0 - q)


from . import RiemannSolver  # noqa: E402

traffic_1D = RiemannSolver("traffic_1D", 1, 1, 1, _rp_traffic)
traffic_1D.flux = _flux_traffic
