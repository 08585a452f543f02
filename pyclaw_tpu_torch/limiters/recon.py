"""WENO5 cell-edge reconstruction, plain PyTorch.

Counterpart of ``pyclaw_tpu/limiters/recon.py`` (``EPWENO :20``,
``_shift :23``, ``weno5 :29``, ``weno5_stencil :40``, ``weno_stencil
:257`` for order 5), the rebuild of reference
``src/pyclaw/sharpclaw/weno.f90``.  Convention (SharpClaw): for every
cell i, ``ql[i]`` is the value at its left edge and ``qr[i]`` the value
at its right edge; the Riemann problem at interface i+1/2 is
``(qr[i], ql[i+1])``.

The weights are computed by one of two formulas, chosen by dtype, as in
the JAX package, and the CUDA kernels ``csrc/dq2_weno5.cu`` and
``csrc/weno5.cu`` branch the same way:

* float64: the reference weights ``d_k / (EPWENO + beta_k)^2``;
* float32: the betas are normalised by their sum and scaled by 1e3, and
  one reciprocal ``1/(den_r * den_l)`` normalises both edges.  The
  float64 formula underflows to inf/NaN in float32 on constant data.

The generic orders 7-17 are not ported yet (ROADMAP.md, Queue 1 item 8:
'weno_order 7-17').
"""

from __future__ import annotations

import torch

EPWENO = 1e-36  # reference sharpclaw epweno (weno.f90)


def _shift(q, k):
    """q shifted so that out[..., i] = q[..., i+k], wrapping around the
    ends of the last axis as ``torch.roll`` does (the wrapped band is
    invalid; callers keep num_ghost >= 3)."""
    return torch.roll(q, -k, dims=-1)


def weno5(q):
    """Fifth-order Jiang-Shu WENO edge values along the last axis.

    q: (..., n) cell averages.  Returns (ql, qr), each (..., n): ql[..., i]
    the value at the left edge of cell i, qr[..., i] at its right edge.
    The plain version of ``csrc/weno5.cu`` (``ops.weno.weno5``)."""
    return weno5_stencil(_shift(q, -2), _shift(q, -1), q,
                         _shift(q, 1), _shift(q, 2))


def weno5_stencil(vm2, vm1, v0, vp1, vp2):
    """WENO5 edge values (ql, qr) of the cells whose five-cell stencils
    are ``vm2 .. vp2`` (tensors of one shape and dtype)."""
    b0 = (13.0 / 12.0) * (vm2 - 2.0 * vm1 + v0) ** 2 \
        + 0.25 * (vm2 - 4.0 * vm1 + 3.0 * v0) ** 2
    b1 = (13.0 / 12.0) * (vm1 - 2.0 * v0 + vp1) ** 2 \
        + 0.25 * (vm1 - vp1) ** 2
    b2 = (13.0 / 12.0) * (v0 - 2.0 * vp1 + vp2) ** 2 \
        + 0.25 * (3.0 * v0 - 4.0 * vp1 + vp2) ** 2

    # right edge (ideal weights 1/10, 6/10, 3/10)
    p0 = (2.0 * vm2 - 7.0 * vm1 + 11.0 * v0) / 6.0
    p1 = (-vm1 + 5.0 * v0 + 2.0 * vp1) / 6.0
    p2 = (2.0 * v0 + 5.0 * vp1 - vp2) / 6.0
    # left edge (mirror: ideal weights 3/10, 6/10, 1/10)
    m0 = (-vm2 + 5.0 * vm1 + 2.0 * v0) / 6.0
    m1 = (2.0 * vm1 + 5.0 * v0 - vp1) / 6.0
    m2 = (11.0 * v0 - 7.0 * vp1 + 2.0 * vp2) / 6.0

    if v0.dtype == torch.float64:
        ib0 = 1.0 / (EPWENO + b0) ** 2
        ib1 = 1.0 / (EPWENO + b1) ** 2
        ib2 = 1.0 / (EPWENO + b2) ** 2
        a0, a1, a2 = 0.1 * ib0, 0.6 * ib1, 0.3 * ib2
        qr = (a0 * p0 + a1 * p1 + a2 * p2) / (a0 + a1 + a2)
        c0, c1, c2 = 0.3 * ib0, 0.6 * ib1, 0.1 * ib2
        ql = (c0 * m0 + c1 * m1 + c2 * m2) / (c0 + c1 + c2)
        return ql, qr

    # float32: scale-invariant weights from the normalised betas
    r = 1e3 / (b0 + b1 + b2 + 1e-30)
    e0 = 1e-3 + b0 * r
    e1 = 1e-3 + b1 * r
    e2 = 1e-3 + b2 * r
    s01 = (e0 * e1) ** 2
    s02 = (e0 * e2) ** 2
    s12 = (e1 * e2) ** 2
    a0, a1, a2 = 0.1 * s12, 0.6 * s02, 0.3 * s01
    c0, c1, c2 = 0.3 * s12, 0.6 * s02, 0.1 * s01
    den_r = a0 + a1 + a2
    den_l = c0 + c1 + c2
    inv = 1.0 / (den_r * den_l)
    qr = (a0 * p0 + a1 * p1 + a2 * p2) * (den_l * inv)
    ql = (c0 * m0 + c1 * m1 + c2 * m2) * (den_r * inv)
    return ql, qr


def weno_stencil(order, shifts):
    """WENO edge values from ``shifts[m + k - 1] = v_{i+m}``,
    m in [-k+1, k-1], k = (order + 1) // 2.  Order 5 only."""
    if order != 5:
        raise NotImplementedError(
            f"weno_order={order} is not ported to pyclaw_tpu_torch yet "
            f"(ROADMAP.md, Queue 1: 'weno_order 7-17')")
    if len(shifts) != 5:
        raise ValueError(f"weno_stencil(order=5) needs 5 stencil arrays, "
                         f"got {len(shifts)}")
    return weno5_stencil(*shifts)
