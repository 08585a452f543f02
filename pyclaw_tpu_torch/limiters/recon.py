"""WENO cell-edge reconstruction of any odd order 5-17, and the TVD
reconstruction, plain PyTorch.

Counterpart of ``pyclaw_tpu/limiters/recon.py`` (``EPWENO :20``,
``_shift :23``, ``weno5 :29``, ``weno5_stencil :40``, ``_weno_tables
:129``, ``weno :244``, ``weno_stencil :257``, ``tvd2 :315``), the
rebuild of reference ``src/pyclaw/sharpclaw/weno.f90`` and
``reconstruct.f90``.  Convention (SharpClaw): for every
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

The orders 7-17 (:func:`weno_stencil`) take their coefficients from
:func:`_weno_tables` (a copy of the JAX package's, the same float64
values) and keep the JAX package's operation order: the betas over the
full k x k quadratic forms with the zero coefficients skipped, each
coefficient a Python float times a tensor; float64 weights with
``EPWENO``, float32 ones from the betas normalised by their sum + 1e-30
with eps 1e-6 (not the WENO5 float32 rule above).  The CUDA kernel
``csrc/dq2_weno.cu`` repeats them, its tables compiled in from
``csrc/weno_tables.cuh``, which this module writes:

    python -m pyclaw_tpu_torch.limiters.recon --emit-header \
        > pyclaw_tpu_torch/csrc/weno_tables.cuh
"""

from __future__ import annotations

import functools
import sys

import numpy as np
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


@functools.lru_cache(maxsize=None)
def _weno_tables(k):
    """Coefficient tables of WENO of order 2k-1 (k = stencil width), in
    float64: (c_right, c_left, d_right, d_left, B).

    c_right[l, j]: coefficient of cell value v_{i-k+1+l+j} in the right
    edge value of cell i from candidate stencil l; d_right[l]: the ideal
    weight of stencil l for the right edge (c_left, d_left: the left
    edge); B[l]: the (k, k) matrix of the Jiang-Shu smoothness indicator,
    beta_l = v_l^T B[l] v_l over the k cell values v_l of stencil l.  From
    Lagrange interpolation of the primitive function and exact polynomial
    integration, as the JAX package computes them (a copy of
    ``pyclaw_tpu/limiters/recon.py:_weno_tables``)."""
    # reconstruction coefficients: stencil l uses cells {i-k+1+l .. i+l};
    # the interpolant at x = +1/2 (right edge) and -1/2 (left edge), cell
    # i centred at 0, width 1
    def recon_coeffs(l, xi):
        # the derivative of the Lagrange interpolant of the primitive
        # function V through the k+1 edges; V at edge j = sum_{m<j} v_m
        edges = np.array([m - 0.5 for m in range(-k + 1 + l, l + 2)])
        coeffs = np.zeros(k)
        nE = k + 1
        for j in range(nE):
            others = [edges[a] for a in range(nE) if a != j]
            denom = np.prod([edges[j] - o for o in others])
            dsum = 0.0
            for a in range(len(others)):
                term = 1.0
                for b in range(len(others)):
                    if b != a:
                        term *= (xi - others[b])
                dsum += term
            dLj = dsum / denom
            for m in range(j):
                coeffs[m] += dLj
        return coeffs

    c_right = np.array([recon_coeffs(l, 0.5) for l in range(k)])
    c_left = np.array([recon_coeffs(l, -0.5) for l in range(k)])

    # the full (2k-1)-cell coefficients, for the ideal weights
    def full_coeffs(xi):
        edges = np.array([m - 0.5 for m in range(-k + 1, k + 1)])
        nE = 2 * k
        coeffs = np.zeros(2 * k - 1)
        for j in range(nE):
            others = [edges[a] for a in range(nE) if a != j]
            denom = np.prod([edges[j] - o for o in others])
            dsum = 0.0
            for a in range(len(others)):
                term = 1.0
                for b in range(len(others)):
                    if b != a:
                        term *= (xi - others[b])
                dsum += term
            dLj = dsum / denom
            for m in range(j):
                coeffs[m] += dLj
        return coeffs

    def ideal_weights(c_stencils, xi):
        # sum_l d_l c_stencils[l] (embedded) == full_coeffs(xi)
        A = np.zeros((2 * k - 1, k))
        for l in range(k):
            A[l:l + k, l] += c_stencils[l]
        b = full_coeffs(xi)
        d, *_ = np.linalg.lstsq(A, b, rcond=None)
        return d

    d_right = ideal_weights(c_right, 0.5)
    d_left = ideal_weights(c_left, -0.5)

    # smoothness indicators: beta_l = sum_{m=1}^{k-1} int_{-1/2}^{1/2}
    # (d^m p_l / dx^m)^2 dx, p_l the degree k-1 polynomial with the cell
    # averages of stencil l
    B = []
    for l in range(k):
        cells = list(range(-k + 1 + l, l + 1))
        A = np.zeros((k, k))  # A[c, p] = average of x^p over cell c
        for ci, c in enumerate(cells):
            for p in range(k):
                a, b2 = c - 0.5, c + 0.5
                A[ci, p] = (b2 ** (p + 1) - a ** (p + 1)) / (p + 1)
        M = np.linalg.inv(A)  # monomial coefficients from cell values
        Bl = np.zeros((k, k))
        for m in range(1, k):
            D = np.zeros((k, k))  # the m-th derivative, monomial basis
            for p in range(m, k):
                fact = 1.0
                for t in range(m):
                    fact *= (p - t)
                D[p - m, p] = fact
            Dm = D @ M
            # the Gram matrix of the monomials on [-1/2, 1/2]
            G = np.zeros((k, k))
            for p in range(k):
                for q2 in range(k):
                    if (p + q2) % 2 == 0:
                        G[p, q2] = 2 * (0.5 ** (p + q2 + 1)) / (p + q2 + 1)
            Bl += Dm.T @ G @ Dm
        B.append(Bl)
    return c_right, c_left, d_right, d_left, np.array(B)


def weno(order, q):
    """WENO edge values (ql, qr) of odd order 5-17 along the last axis of
    q (reference weno.f90 weno5..weno17), as :func:`weno5`."""
    if order == 5:
        return weno5(q)
    if order % 2 == 0 or order < 3:
        raise ValueError("WENO order must be odd >= 3")
    k = (order + 1) // 2
    return weno_stencil(order, [_shift(q, m) for m in range(-k + 1, k)])


def weno_stencil(order, shifts):
    """WENO edge values (ql, qr) from ``shifts[m + k - 1] = v_{i+m}``,
    m in [-k+1, k-1], k = (order + 1) // 2 (tensors of one shape and
    dtype; the characteristic paths pass projections onto each cell's
    eigenvectors).  Order 5 is :func:`weno5_stencil`."""
    if order == 5:
        if len(shifts) != 5:
            raise ValueError(f"weno_stencil(order=5) needs 5 stencil "
                             f"arrays, got {len(shifts)}")
        return weno5_stencil(*shifts)
    k = (order + 1) // 2
    if len(shifts) != 2 * k - 1:
        raise ValueError(f"weno_stencil(order={order}) needs {2 * k - 1} "
                         f"stencil arrays, got {len(shifts)}")
    c_right, c_left, d_right, d_left, B = _weno_tables(k)

    # smoothness indicators, shared by both edges
    betas = []
    for l in range(k):
        beta = 0.0
        cells = shifts[l:l + k]
        for a in range(k):
            for b in range(k):
                coeff = float(B[l][a, b])
                if coeff != 0.0:
                    beta = beta + coeff * cells[a] * cells[b]
        betas.append(beta)

    if shifts[0].dtype == torch.float64:
        eps = EPWENO
    else:
        # float32: EPWENO squared underflows (inf/NaN on locally constant
        # data); the weights are ratios, so normalise the betas by their
        # sum and take the classical eps
        r = 1.0 / (sum(betas) + 1e-30)
        betas = [b * r for b in betas]
        eps = 1e-6

    def edge(c_tab, d_tab):
        num = 0.0
        den = 0.0
        for l in range(k):
            cells = shifts[l:l + k]
            p = 0.0
            for j in range(k):
                p = p + float(c_tab[l, j]) * cells[j]
            alpha = float(d_tab[l]) / (eps + betas[l]) ** 2
            num = num + alpha * p
            den = den + alpha
        return num / den

    qr = edge(c_right, d_right)
    ql = edge(c_left, d_left)
    return ql, qr


def tvd_slope(dqm, dqp, limiter_id):
    """The limited slope phi(theta) dqp of a cell from its backward and
    forward jumps, theta = dqm / dqp, zero where the forward jump is."""
    from .tvd import _phi
    safe = dqp != 0.0
    theta = torch.where(safe, dqm / torch.where(safe, dqp, 1.0), 0.0)
    return torch.where(safe, _phi(limiter_id, theta), 0.0) * dqp


def tvd2(q, limiter_id=4):
    """Second-order TVD edge values (ql, qr) along the last axis
    (SharpClaw lim_type=1; reference reconstruct.f90's tvd2): the slope
    q_{i+1} - q_i limited by phi(theta) (:func:`tvd_slope`).  MC by
    default."""
    slope = tvd_slope(q - _shift(q, -1), _shift(q, 1) - q, limiter_id)
    return q - 0.5 * slope, q + 0.5 * slope


# ---- csrc/weno_tables.cuh -------------------------------------------------

HEADER_ORDERS = (7, 9, 11, 13, 15, 17)   # the kernel's orders past WENO5


def _literal(v):
    """A float64 as a C++ double literal, printed with %.17g (exact)."""
    s = "%.17g" % v
    if not any(c in s for c in ".en"):
        s += ".0"
    return s


def _table(name, values, per_line=3):
    vals = [_literal(float(v)) for v in np.asarray(values).ravel()]
    lines = [", ".join(vals[i:i + per_line])
             for i in range(0, len(vals), per_line)]
    body = ",\n        ".join(lines)
    return (f"  static HD constexpr double {name}(int i) {{\n"
            f"    constexpr double t[{len(vals)}] = {{\n        {body}}};\n"
            f"    return t[i];\n  }}\n")


def emit_header():
    """The text of ``csrc/weno_tables.cuh``: :func:`_weno_tables` of each
    stencil width of :data:`HEADER_ORDERS` as compile-time literals."""
    out = ["// weno_tables.cuh — the coefficient tables of Jiang-Shu WENO of "
           "order 2K-1,\n"
           "// K = 4..9, for dq2_weno.cu: "
           "pyclaw_tpu_torch/limiters/recon.py:_weno_tables(K)\n"
           "// in float64, printed with %.17g.  Written by\n"
           "//   python -m pyclaw_tpu_torch.limiters.recon --emit-header\n"
           "// (tests/test_torch_sharpclaw_options.py regenerates it and "
           "finds it\n"
           "// byte-equal).  Indices: cr(l * K + j), cl(l * K + j) "
           "(c_right, c_left),\n"
           "// dr(l), dl(l) (d_right, d_left), b((l * K + a) * K + b) "
           "(B[l][a, b]).\n"
           "\n#pragma once\n\n#include \"euler2d.cuh\"\n\n"
           "namespace {\n\ntemplate <int K> struct WenoTables;\n"]
    for order in HEADER_ORDERS:
        k = (order + 1) // 2
        c_right, c_left, d_right, d_left, B = _weno_tables(k)
        out.append(f"\n// order {order}\ntemplate <> struct "
                   f"WenoTables<{k}> {{\n")
        for name, vals in (("cr", c_right), ("cl", c_left), ("dr", d_right),
                           ("dl", d_left), ("b", B)):
            out.append(_table(name, vals))
        out.append("};\n")
    out.append("\n}  // namespace\n")
    return "".join(out)


if __name__ == "__main__":
    if sys.argv[1:] != ["--emit-header"]:
        sys.exit("usage: python -m pyclaw_tpu_torch.limiters.recon "
                 "--emit-header")
    sys.stdout.write(emit_header())
