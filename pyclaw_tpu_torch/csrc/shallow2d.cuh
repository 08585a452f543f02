// shallow2d.cuh — the 2D shallow-water systems of the generic CTU kernel
// (step2_aos.cu), operation for operation as in
// pyclaw_tpu_torch/riemann/shallow.py but for the splits' reciprocal of c
// (RoeSw):
//   ShallowRoeEfix2D     _rpn2_shallow_roe + _rpt2_shallow_roe
//   ShallowBathyFwave2D  _rpn2_shallow_bathymetry_fwave (aux[0] = b) +
//                        _rpt2_shallow_roe
// The Python scalar factors fold as they do there: g*0.5 and 0.5*g once
// in double (Sw::hg), then rounded to T where they meet a tensor.  Both
// systems give step2_aos.cu its system hooks through ShallowHooks: Par and
// make_par (their physics scalars in Args), prep (the per-cell quantities),
// nz (the wave components that can be nonzero) and Trans (the Roe
// transverse split of one interface); acoustics2d.cuh gives the same
// hooks.
//
// Compiles with nvcc and, without __CUDACC__, with a host C++ compiler
// for the kernel's host emulation (ops/_build.py:build_host_emulation).

#pragma once

#include "euler2d.cuh"

namespace {

// physics scalars in the kernel's type
template <typename T> struct Sw {
  T g;     // grav
  T hg;    // 0.5 * grav
  T dry;   // dry_tolerance (f-wave solver)
};

// the quantities of one cell that the solvers take at each of its
// interfaces: hu/h, hv/h, sqrt(h), sqrt(g h), computed once per staged
// cell (the same operations on the same values as at each interface)
constexpr int NPC = 4;
template <typename T>
HD void cell_prep(const Sw<T>& P, const T q[3], T pc[NPC]) {
  pc[0] = q[1] / q[0];
  pc[1] = q[2] / q[0];
  pc[2] = sqrt_(q[0]);
  pc[3] = sqrt_(P.g * q[0]);
}

// the Roe averages of both shallow-water solvers' transverse split and of
// the Roe normal solve (the same expressions in both), from the depths and
// the per-cell quantities of the interface's two cells; rc, the IEEE
// reciprocal of c, is the splits' only (the normal solve divides by c)
template <int IXY, typename T> struct RoeSw {
  T ul, ur, u, v, c, rc;
  HD RoeSw(const Sw<T>& P, T hl, T hr, const T pl[NPC], const T pr[NPC]) {
    ul = pl[IXY];
    ur = pr[IXY];
    const T vl = pl[1 - IXY], vr = pr[1 - IXY];
    const T shl = pl[2], shr = pr[2];
    const T wgt = T(1) / (shl + shr);
    u = (shl * ul + shr * ur) * wgt;
    v = (shl * vl + shr * vr) * wgt;
    c = sqrt_(P.hg * (hl + hr));
    rc = T(1) / c;
  }
};

// _rpt2_shallow_roe: split asdq along the transverse direction into its
// down-going (bm) and up-going (bp) parts, with the interface's Roe
// average r, which the two splits of an interface share; they multiply by
// its reciprocal of c where the plain version divides by c (roundoff: the
// strengths feed no gate)
template <int IXY, typename T>
HD void rpt2_shallow(const RoeSw<IXY, T>& r, const T asdq[3], T bm[3],
                     T bp[3]) {
  constexpr int mu = 1 + IXY, mv = 2 - IXY;
  const T u = r.u, v = r.v, c = r.c, rc = r.rc;
  const T d0 = asdq[0], dmu = asdq[mu], dmv = asdq[mv];
  const T b1 = T(0.5) * ((v + c) * d0 - dmv) * rc;
  const T b2 = dmu - u * d0;
  const T b3 = T(0.5) * (-(v - c) * d0 + dmv) * rc;
  T w[3][3];
  w[0][0] = b1; w[0][mu] = b1 * u; w[0][mv] = b1 * (v - c);
  w[1][0] = T(0); w[1][mu] = b2; w[1][mv] = T(0);
  w[2][0] = b3; w[2][mu] = b3 * u; w[2][mv] = b3 * (v + c);
  const T sp[3] = {v - c, v, v + c};
  for (int e = 0; e < 3; ++e) {
    T m = T(0), p = T(0);
    for (int k = 0; k < 3; ++k) {
      m = m + mn(sp[k], T(0)) * w[k][e];
      p = p + mx(sp[k], T(0)) * w[k][e];
    }
    bm[e] = m;
    bp[e] = p;
  }
}

// whether component e of wave p of either system's normal solve along IXY
// can be nonzero: the shear wave (p = 1) has only the transverse momentum
template <int IXY> HD constexpr bool sw_nz(int p, int e) {
  return p != 1 || e == 2 - IXY;
}

// the hooks both shallow-water systems share
struct ShallowHooks {
  static constexpr int NPC = ::NPC;

  // the physics scalars in Args: (grav, dry_tolerance) as p0, p1
  template <typename T> using Par = Sw<T>;
  template <typename T> static Sw<T> make_par(double p0, double p1) {
    Sw<T> P;
    P.g = T(p0);
    P.hg = T(p0 * 0.5);
    P.dry = T(p1);
    return P;
  }

  template <typename T>
  static HD void prep(const Sw<T>& P, const T q[3], T pc[NPC]) {
    cell_prep(P, q, pc);
  }

  template <int IXY> static HD constexpr bool nz(int p, int e) {
    return sw_nz<IXY>(p, e);
  }

  // the two rpt2 splits of an interface share its Roe average
  template <int IXY, typename T> struct Trans {
    RoeSw<IXY, T> r;
    HD Trans(const Sw<T>& P, const T ql[3], const T qr[3], const T pl[NPC],
             const T pr[NPC])
        : r(P, ql[0], qr[0], pl, pr) {}
    HD void split(const T asdq[3], T bm[3], T bp[3]) const {
      rpt2_shallow<IXY, T>(r, asdq, bm, bp);
    }
  };
};

// ---- shallow_roe_with_efix_2D ------------------------------------------
struct ShallowRoeEfix2D : ShallowHooks {
  static constexpr int NEQ = 3, NW = 3, NAUX = 0;

  template <int IXY, typename T>
  static HD void rpn(const Sw<T>& P, const T ql[3], const T qr[3],
                     const T* al, const T* ar, const T pl[NPC],
                     const T pr[NPC], T w[3][3], T s[3], T am[3], T ap[3]) {
    constexpr int mu = 1 + IXY, mv = 2 - IXY;
    (void)al;
    (void)ar;
    const RoeSw<IXY, T> r(P, ql[0], qr[0], pl, pr);
    const T u = r.u, v = r.v, c = r.c;
    const T hl = ql[0], hr = qr[0];
    const T d0 = qr[0] - ql[0], dmu = qr[mu] - ql[mu], dmv = qr[mv] - ql[mv];
    const T a1 = T(0.5) * ((u + c) * d0 - dmu) / c;
    const T a2 = dmv - v * d0;
    const T a3 = T(0.5) * (-(u - c) * d0 + dmu) / c;
    w[0][0] = a1; w[0][mu] = a1 * (u - c); w[0][mv] = a1 * v;
    w[1][0] = T(0); w[1][mu] = T(0); w[1][mv] = a2;
    w[2][0] = a3; w[2][mu] = a3 * (u + c); w[2][mv] = a3 * v;
    s[0] = u - c;
    s[1] = u;
    s[2] = u + c;

    // Harten's entropy fix on waves 1 and 3; the guards are where(hm <= 0)
    const T cl = pl[3], cr = pr[3];
    const T hm = hl + a1;
    const T hum = ql[mu] + a1 * (u - c);
    const T um = hum / (hm <= T(0) ? T(1) : hm);
    const T cm = sqrt_(P.g * mx(hm, T(0)));
    const T lam1_l = r.ul - cl, lam1_m = um - cm;
    const bool trans1 = lam1_l < T(0) && lam1_m > T(0);
    const T den1 = lam1_m - lam1_l == T(0) ? T(1) : lam1_m - lam1_l;
    const T sf1 = trans1 ? lam1_l * (lam1_m - s[0]) / den1 : mn(s[0], T(0));
    const T sf2 = mn(s[1], T(0));
    const T hm3 = hr - a3;
    const T hum3 = qr[mu] - a3 * (u + c);
    const T um3 = hum3 / (hm3 <= T(0) ? T(1) : hm3);
    const T cm3 = sqrt_(P.g * mx(hm3, T(0)));
    const T lam3_m = um3 + cm3, lam3_r = r.ur + cr;
    const bool trans3 = lam3_m < T(0) && lam3_r > T(0);
    const T den3 = lam3_r - lam3_m == T(0) ? T(1) : lam3_r - lam3_m;
    const T sf3 = trans3 ? lam3_m * (lam3_r - s[2]) / den3 : mn(s[2], T(0));
    for (int e = 0; e < 3; ++e) {
      const T m = sf1 * w[0][e] + sf2 * w[1][e] + sf3 * w[2][e];
      const T df = s[0] * w[0][e] + s[1] * w[1][e] + s[2] * w[2][e];
      am[e] = m;
      ap[e] = df - m;
    }
  }
};

// ---- shallow_bathymetry_fwave_2D (aux[0] = b) ----------------------------
struct ShallowBathyFwave2D : ShallowHooks {
  static constexpr int NEQ = 3, NW = 3, NAUX = 1;

  template <int IXY, typename T>
  static HD void rpn(const Sw<T>& P, const T ql[3], const T qr[3],
                     const T* al, const T* ar, const T*, const T*,
                     T w[3][3], T s[3], T am[3], T ap[3]) {
    constexpr int mu = 1 + IXY, mv = 2 - IXY;
    const T hl = ql[0], hr = qr[0];
    const bool wet_l = hl > P.dry, wet_r = hr > P.dry;
    const T hs_l = wet_l ? hl : T(1), hs_r = wet_r ? hr : T(1);
    const T ul = wet_l ? ql[mu] / hs_l : T(0);
    const T ur = wet_r ? qr[mu] / hs_r : T(0);
    const T vl = wet_l ? ql[mv] / hs_l : T(0);
    const T vr = wet_r ? qr[mv] / hs_r : T(0);
    const T bl = al[0], br = ar[0];
    const T shl = sqrt_(mx(hl, T(0))), shr = sqrt_(mx(hr, T(0)));
    const T denom_roe = shl + shr > T(0) ? shl + shr : T(1);
    const T u = (shl * ul + shr * ur) / denom_roe;
    const T c = sqrt_(P.hg * (hl + hr));
    const T s1 = mn(u - c, ul - sqrt_(P.g * mx(hl, T(0))));
    const T s3 = mx(u + c, ur + sqrt_(P.g * mx(hr, T(0))));
    const T s2 = u;
    const T hbar = T(0.5) * (hl + hr);
    const T fd1 = qr[mu] - ql[mu];
    const T fd2 = (qr[mu] * ur + P.hg * hr * hr)
                - (ql[mu] * ul + P.hg * hl * hl)
                + P.g * hbar * (br - bl);
    const T fd3 = qr[mu] * vr - ql[mu] * vl;
    const T denom = s3 - s1 == T(0) ? T(1) : s3 - s1;
    const T beta1 = (s3 * fd1 - fd2) / denom;
    const T beta3 = (fd2 - s1 * fd1) / denom;
    w[0][0] = beta1; w[0][mu] = beta1 * s1; w[0][mv] = beta1 * vl;
    w[1][0] = T(0); w[1][mu] = T(0); w[1][mv] = fd3 - beta1 * vl - beta3 * vr;
    w[2][0] = beta3; w[2][mu] = beta3 * s3; w[2][mv] = beta3 * vr;
    s[0] = s1;
    s[1] = s2;
    s[2] = s3;
    for (int e = 0; e < 3; ++e) {
      T m = T(0), p = T(0);
      for (int k = 0; k < 3; ++k) {
        m = m + (s[k] < T(0) ? w[k][e] : T(0));
        p = p + (s[k] >= T(0) ? w[k][e] : T(0));
      }
      am[e] = m;
      ap[e] = p;
    }
  }
};

}  // namespace
