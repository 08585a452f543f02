// shallow_sphere2d.cuh — shallow water on the rotating sphere's lat-lon
// patch for the generic CTU kernel (step2_aos.cu), operation for operation
// as in pyclaw_tpu_torch/riemann/shallow_sphere.py
// (_rp_shallow_sphere_fwave): q = (h, hu, hv), aux row 1 the cell-centred
// kappa = cos(theta), which the theta (y) f-wave carries inside it and
// which is the capacity (index_capa = 1), the one aux row staged (AUX0);
// three f-waves at the Roe speeds u - c, u, u + c, each into amdq or
// apdq by the sign of its own speed.
//
// The record has no transverse solver: ShallowSphere2D is marked
// NO_TRANS, so step2_aos.cu runs it with transverse_waves 0 and compiles
// no split for it.  Each cell's hu/h, hv/h, sqrt(h) and p = (g/2) h h are
// staged once (prep), the same operations on the same values as at each
// of its interfaces.  The split by the sign of a speed turns on roundoff,
// so step2_aos.cu is built without fused multiply-adds
// (ops/_build.py: -fmad=false): each operation rounds as PyTorch's does.
//
// Compiles with nvcc and, without __CUDACC__, with a host C++ compiler
// for the kernel's host emulation (ops/_build.py:build_host_emulation).

#pragma once

#include "shallow2d.cuh"

namespace {

struct ShallowSphere2D {
  // aux row 1 (kappa) alone is staged, as the system's row 0: row 0 of
  // the record's aux is read by no solver
  static constexpr int NEQ = 3, NW = 3, NAUX = 1, AUX0 = 1, NPC = 4;
  static constexpr bool NO_TRANS = true;
  // (grav, unused) as p0, p1: Sw's g and hg = 0.5 * grav
  template <typename T> using Par = Sw<T>;
  template <typename T> static Sw<T> make_par(double p0, double) {
    Sw<T> P;
    P.g = T(p0);
    P.hg = T(0.5 * p0);
    P.dry = T(0);
    return P;
  }

  template <typename T>
  static HD void prep(const Sw<T>& P, const T q[3], T pc[4]) {
    pc[0] = q[1] / q[0];
    pc[1] = q[2] / q[0];
    pc[2] = sqrt_(q[0]);
    pc[3] = P.hg * q[0] * q[0];
  }

  // the shear wave (p = 1) has the transverse momentum only
  template <int IXY> static HD constexpr bool nz(int p, int e) {
    return sw_nz<IXY>(p, e);
  }

  template <int IXY, typename T>
  static HD void rpn(const Sw<T>& P, const T ql[3], const T qr[3],
                     const T al[], const T ar[], const T pl[4],
                     const T pr[4], T w[3][3], T s[3], T am[3], T ap[3]) {
    constexpr int mu = 1 + IXY, mv = 2 - IXY;
    const T hl = ql[0], hr = qr[0];
    const T ul = pl[IXY], ur = pr[IXY];
    const T vl = pl[1 - IXY], vr = pr[1 - IXY];
    const T sql = pl[2], sqr = pr[2];
    const T hbar = T(0.5) * (hl + hr);
    const T u = (sql * ul + sqr * ur) / (sql + sqr);
    const T v = (sql * vl + sqr * vr) / (sql + sqr);
    const T c = sqrt_(P.g * hbar);
    // the flux jump; along theta each side's flux times its own kappa
    // (along lambda the plain version's kappa is the Python 1.0, whose
    // products are exact)
    T fl0 = ql[mu], fr0 = qr[mu];
    T flu = ql[mu] * ul + pl[3], fru = qr[mu] * ur + pr[3];
    T flv = ql[mu], frv = qr[mu];
    if (IXY == 1) {
      fl0 = al[0] * fl0;
      fr0 = ar[0] * fr0;
      flu = al[0] * flu;
      fru = ar[0] * fru;
      flv = al[0] * flv;
      frv = ar[0] * frv;
    }
    const T dF0 = fr0 - fl0;
    const T dFmu = fru - flu;
    const T dFmv = frv * vr - flv * vl;
    const T c2 = T(2) * c;
    const T b1 = ((u + c) * dF0 - dFmu) / c2;
    const T b3 = (dFmu - (u - c) * dF0) / c2;
    const T b2 = dFmv - v * dF0;
    w[0][0] = b1;
    w[0][mu] = b1 * (u - c);
    w[0][mv] = b1 * v;
    w[1][0] = T(0);
    w[1][mu] = T(0);
    w[1][mv] = b2;
    w[2][0] = b3;
    w[2][mu] = b3 * (u + c);
    w[2][mv] = b3 * v;
    s[0] = u - c;
    s[1] = u;
    s[2] = u + c;
    for (int e = 0; e < 3; ++e) {
      T m = T(0), p = T(0);
      for (int k = 0; k < 3; ++k) {
        const bool neg = s[k] < T(0);
        m = m + (neg ? w[k][e] : T(0));
        p = p + (neg ? T(0) : w[k][e]);
      }
      am[e] = m;
      ap[e] = p;
    }
  }
};

}  // namespace
