"""Variable-coefficient (heterogeneous-media) acoustics Riemann solvers,
plain PyTorch.

Counterpart of ``pyclaw_tpu/riemann/acoustics_var.py``
(``_rp_acoustics_var :19-41``, ``_rpt_acoustics_var :44-78``, the
char_decomp hook ``_evec_acoustics_var :81-101``, the records
``acoustics_variable_1D :104-106``, ``vc_acoustics_2D :107-109`` and
``vc_acoustics_3D :114-116``), physics of reference
``rp1_acoustics_var.f90`` and ``rpn2_vc_acoustics.f90``: per-cell
material parameters in aux, aux[0] = impedance Z and aux[1] = sound speed
c.  At an interface the jump splits against the one-sided impedances:

    a1 = (-dp + Z_r du) / (Z_l + Z_r)     left-going,  speed -c_l
    a2 = ( dp + Z_l du) / (Z_l + Z_r)     right-going, speed +c_r
    W1 = a1 (-Z_l, n),  W2 = a2 (Z_r, n)

The operations run in the JAX package's order, so the two agree to
roundoff in float64 (tests/test_torch_riemann_3d.py,
tests/test_torch_riemann_scalar.py, tests/test_torch_riemann_1d_library.py).
The CUDA kernels repeat them: ``csrc/step1.cu`` in ``csrc/systems1d.cuh``
(``AcousticsVar1D``), ``csrc/step2_aos.cu`` in ``csrc/acoustics2d.cuh``
(``VcAcoustics2D``), ``csrc/step3_aos.cu`` in ``csrc/acoustics3d.cuh``
(``VcAcoustics3D``).
"""

from __future__ import annotations

import torch


def _rp_acoustics_var(ixy, q_l, q_r, aux_l, aux_r, params):
    num_eqn = q_l.shape[0]
    mu = 1 + ixy
    z_l, c_l = aux_l[0], aux_l[1]
    z_r, c_r = aux_r[0], aux_r[1]
    d = q_r - q_l
    denom = z_l + z_r
    a1 = (-d[0] + z_r * d[mu]) / denom
    a2 = (d[0] + z_l * d[mu]) / denom

    zero = torch.zeros_like(a1)
    w1 = [zero] * num_eqn
    w1[0], w1[mu] = -a1 * z_l, a1
    w2 = [zero] * num_eqn
    w2[0], w2[mu] = a2 * z_r, a2
    wave = torch.stack([torch.stack(w1), torch.stack(w2)], dim=1)

    s = torch.stack([-c_l, c_r])
    amdq = -c_l * wave[:, 0]
    apdq = c_r * wave[:, 1]
    return wave, s, amdq, apdq


def _rpt_acoustics_var(ixy, imp, q_l, q_r, aux_l, aux_r, asdq, params,
                       trans_axis=None):
    """Heterogeneous-media transverse split (reference
    rpt2_vc_acoustics.f90): the fluctuation entering cell i1 (the left
    cell for imp=1, the right for imp=2) is decomposed against the
    impedances of that cell's neighbours along ``trans_axis``.  The
    down-going part crosses into the cell below (Z_below, c_below), the
    up-going one into the cell above:

        a1 = (-dp + Z dv) / (Z + Z_below),   bm = -c_below a1 (-Z_below, e_v)
        a2 = ( dp + Z dv) / (Z + Z_above),   bp =  c_above a2 ( Z_above, e_v)

    aux is sliced only along the normal axis, so the neighbours are
    shifts along ``trans_axis``; the wrapped edge rows are never read by
    the transverse gather (it drops the first and last transverse row)."""
    if trans_axis is None:
        trans_axis = 1 - ixy
    mv = 1 + trans_axis
    aux_c = aux_l if imp == 1 else aux_r
    z_c = aux_c[0]
    z_below = torch.roll(z_c, 1, dims=trans_axis)
    z_above = torch.roll(z_c, -1, dims=trans_axis)
    c_below = torch.roll(aux_c[1], 1, dims=trans_axis)
    c_above = torch.roll(aux_c[1], -1, dims=trans_axis)

    a1 = (-asdq[0] + z_c * asdq[mv]) / (z_c + z_below)
    a2 = (asdq[0] + z_c * asdq[mv]) / (z_c + z_above)

    zero = torch.zeros_like(a1)
    bm = [zero] * asdq.shape[0]
    bm[0], bm[mv] = c_below * a1 * z_below, -c_below * a1
    bp = [zero] * asdq.shape[0]
    bp[0], bp[mv] = c_above * a2 * z_above, c_above * a2
    return torch.stack(bm), torch.stack(bp)


def _evec_acoustics_var(ixy, q, aux, params):
    """Per-cell eigenvector matrices (R, L), each (num_eqn, num_eqn, *n),
    of heterogeneous acoustics along ``ixy`` (the char_decomp hook): the
    acoustic waves (-Z, e_mu) and (Z, e_mu) with the cell's impedance
    aux[0] in the first and last columns, the shear components passing
    through."""
    z = aux[0]
    num_eqn = q.shape[0]
    mu = 1 + ixy
    one = torch.ones_like(z)
    zero = torch.zeros_like(z)
    R = [[zero] * num_eqn for _ in range(num_eqn)]
    L = [[zero] * num_eqn for _ in range(num_eqn)]
    R[0][0], R[mu][0] = -z, one
    R[0][num_eqn - 1], R[mu][num_eqn - 1] = z, one
    L[0][0], L[0][mu] = -0.5 / z, 0.5 * one
    L[num_eqn - 1][0], L[num_eqn - 1][mu] = 0.5 / z, 0.5 * one
    shear = [j for j in range(1, num_eqn) if j != mu]
    for k, j in zip(range(1, num_eqn - 1), shear):
        R[j][k] = one
        L[k][j] = one
    return (torch.stack([torch.stack(r) for r in R]),
            torch.stack([torch.stack(r) for r in L]))


from . import RiemannSolver  # noqa: E402

# 1D heterogeneous acoustics: q = (p, u), aux rows (Z, c)
acoustics_variable_1D = RiemannSolver("acoustics_variable_1D", 1, 2, 2,
                                      _rp_acoustics_var)
acoustics_variable_1D.evec = _evec_acoustics_var
# 2D heterogeneous acoustics: q = (p, u, v), aux rows (Z, c)
vc_acoustics_2D = RiemannSolver("vc_acoustics_2D", 2, 3, 2,
                                _rp_acoustics_var, rpt=_rpt_acoustics_var)
vc_acoustics_2D.evec = _evec_acoustics_var
# 3D heterogeneous acoustics: q = (p, u, v, w), aux rows (Z, c).  No rptt
# (the reference has no variable-coefficient double-transverse solver):
# the unsplit step runs with transverse_waves=1.
vc_acoustics_3D = RiemannSolver("vc_acoustics_3D", 3, 4, 2,
                                _rp_acoustics_var, rpt=_rpt_acoustics_var)
vc_acoustics_3D.evec = _evec_acoustics_var
