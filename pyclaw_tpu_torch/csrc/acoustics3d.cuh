// acoustics3d.cuh — the 3D systems of the generic 3D CTU kernel
// (step3_aos.cu), operation for operation as in pyclaw_tpu_torch/riemann:
//   VcAcoustics3D  acoustics_var.py  _rp_acoustics_var + _rpt_acoustics_var
//                  (aux[0] = impedance Z, aux[1] = sound speed c; no rptt)
//   Acoustics3D    acoustics.py      _rp_acoustics + _rpt3_acoustics +
//                  _rptt3_acoustics (constant Z and c)
//   Advection3D    advection.py      _rp_advection + _rpt_advection +
//                  _rptt_advection (constant u, v, w)
//   Burgers3D      burgers.py        _rp_burgers + _rpt_burgers +
//                  _rptt_burgers (the entropy fix; splits by the sign of
//                  the receiving cell's state: SPLIT_Q)
// (Euler in 3D runs step3_ctu.cu, euler3d.cuh.)  Each system gives its
// normal solve rpn<D> at a D-interface, its transverse split rpt<E> of a
// fluctuation along E and, where it has one, its double-transverse split
// rptt<F> along F.  A split reads the aux of the receiving cell and of
// its two neighbours along the split's axis; a system with SPLIT_Q reads
// the receiving cell's state instead, which the kernel passes in place of
// that cell's aux (ac).
// The Python scalar factors fold as they do there: 2.0 * zz once in
// double (Sys3::p2z), then rounded to T where it meets a tensor.
//
// Compiles with nvcc and, without __CUDACC__, with a host C++ compiler
// for the kernel's host emulation (ops/_build.py:build_host_emulation).

#pragma once

#include "euler2d.cuh"

namespace {

// physics scalars in the kernel's type: advection (u, v, w) in vel (the
// efix flag of Burgers in vel[0]); acoustics zz, cc and 2 zz
template <typename T> struct Sys3 {
  T vel[3];
  T zz, cc, p2z;
};

// ---- heterogeneous acoustics: q = (p, u, v, w), aux rows (Z, c) ---------
struct VcAcoustics3D {
  static constexpr int NEQ = 4, NW = 2, NAUX = 2;
  static constexpr bool HAS_RPTT = false;

  template <int D, typename T>
  HD static void rpn(const Sys3<T>&, const T ql[], const T qr[],
                     const T al[], const T ar[], T w[][NEQ], T s[], T am[],
                     T ap[]) {
    constexpr int mu = 1 + D;
    const T z_l = al[0], c_l = al[1], z_r = ar[0], c_r = ar[1];
    const T d0 = qr[0] - ql[0], dmu = qr[mu] - ql[mu];
    const T denom = z_l + z_r;
    const T a1 = (-d0 + z_r * dmu) / denom;
    const T a2 = (d0 + z_l * dmu) / denom;
    for (int e = 0; e < NEQ; ++e) w[0][e] = w[1][e] = T(0);
    w[0][0] = -a1 * z_l;
    w[0][mu] = a1;
    w[1][0] = a2 * z_r;
    w[1][mu] = a2;
    s[0] = -c_l;
    s[1] = c_r;
    for (int e = 0; e < NEQ; ++e) {
      am[e] = -c_l * w[0][e];
      ap[e] = c_r * w[1][e];
    }
  }

  // split of asdq along E against the impedances of the receiving cell
  // (ac) and of its neighbours below (ab) and above (aa) along E
  template <int E, typename T>
  HD static void rpt(const Sys3<T>&, const T ab[], const T ac[],
                     const T aa[], const T asdq[], T bm[], T bp[]) {
    constexpr int mv = 1 + E;
    const T z_c = ac[0], z_b = ab[0], z_a = aa[0];
    const T c_b = ab[1], c_a = aa[1];
    const T a1 = (-asdq[0] + z_c * asdq[mv]) / (z_c + z_b);
    const T a2 = (asdq[0] + z_c * asdq[mv]) / (z_c + z_a);
    for (int e = 0; e < NEQ; ++e) bm[e] = bp[e] = T(0);
    bm[0] = c_b * a1 * z_b;
    bm[mv] = -c_b * a1;
    bp[0] = c_a * a2 * z_a;
    bp[mv] = c_a * a2;
  }

  template <int F, typename T>
  HD static void rptt(const Sys3<T>&, const T[], const T[], const T[],
                      const T[], T cm[], T cp[]) {
    for (int e = 0; e < NEQ; ++e) cm[e] = cp[e] = T(0);   // never called
  }
};

// ---- constant-coefficient acoustics: q = (p, u, v, w) --------------------
struct Acoustics3D {
  static constexpr int NEQ = 4, NW = 2, NAUX = 0;
  static constexpr bool HAS_RPTT = true;

  template <int D, typename T>
  HD static void rpn(const Sys3<T>& P, const T ql[], const T qr[],
                     const T[], const T[], T w[][NEQ], T s[], T am[],
                     T ap[]) {
    constexpr int mu = 1 + D;
    const T d0 = qr[0] - ql[0], dmu = qr[mu] - ql[mu];
    const T a1 = (-d0 + P.zz * dmu) / P.p2z;
    const T a2 = (d0 + P.zz * dmu) / P.p2z;
    for (int e = 0; e < NEQ; ++e) w[0][e] = w[1][e] = T(0);
    w[0][0] = -a1 * P.zz;
    w[0][mu] = a1;
    w[1][0] = a2 * P.zz;
    w[1][mu] = a2;
    s[0] = -P.cc;
    s[1] = P.cc;
    for (int e = 0; e < NEQ; ++e) {
      am[e] = -P.cc * w[0][e];
      ap[e] = P.cc * w[1][e];
    }
  }

  template <int E, typename T>
  HD static void rpt(const Sys3<T>& P, const T[], const T[], const T[],
                     const T asdq[], T bm[], T bp[]) {
    constexpr int mv = 1 + E;
    const T a1 = (-asdq[0] + P.zz * asdq[mv]) / P.p2z;
    const T a2 = (asdq[0] + P.zz * asdq[mv]) / P.p2z;
    for (int e = 0; e < NEQ; ++e) bm[e] = bp[e] = T(0);
    bm[0] = P.cc * a1 * P.zz;
    bm[mv] = -P.cc * a1;
    bp[0] = P.cc * a2 * P.zz;
    bp[mv] = P.cc * a2;
  }

  template <int F, typename T>
  HD static void rptt(const Sys3<T>& P, const T ab[], const T ac[],
                      const T aa[], const T bs[], T cm[], T cp[]) {
    rpt<F, T>(P, ab, ac, aa, bs, cm, cp);
  }
};

// ---- constant-coefficient advection: one equation, one wave -------------
struct Advection3D {
  static constexpr int NEQ = 1, NW = 1, NAUX = 0;
  static constexpr bool HAS_RPTT = true;

  template <int D, typename T>
  HD static void rpn(const Sys3<T>& P, const T ql[], const T qr[],
                     const T[], const T[], T w[][NEQ], T s[], T am[],
                     T ap[]) {
    const T u = P.vel[D];
    const T dq = qr[0] - ql[0];
    w[0][0] = dq;
    s[0] = u;
    am[0] = mn(u, T(0)) * dq;
    ap[0] = mx(u, T(0)) * dq;
  }

  template <int E, typename T>
  HD static void rpt(const Sys3<T>& P, const T[], const T[], const T[],
                     const T asdq[], T bm[], T bp[]) {
    const T ut = P.vel[E];
    bm[0] = mn(ut, T(0)) * asdq[0];
    bp[0] = mx(ut, T(0)) * asdq[0];
  }

  template <int F, typename T>
  HD static void rptt(const Sys3<T>& P, const T ab[], const T ac[],
                      const T aa[], const T bs[], T cm[], T cp[]) {
    rpt<F, T>(P, ab, ac, aa, bs, cm, cp);
  }
};

// ---- Burgers: one equation, one wave; p0 (vel[0]) the efix flag ---------
struct Burgers3D {
  static constexpr int NEQ = 1, NW = 1, NAUX = 0;
  static constexpr bool HAS_RPTT = true;
  // the splits read the receiving cell's state (in ac[0])
  static constexpr bool SPLIT_Q = true;

  template <int D, typename T>
  HD static void rpn(const Sys3<T>& P, const T ql[], const T qr[],
                     const T[], const T[], T w[][NEQ], T s[], T am[],
                     T ap[]) {
    const T dq = qr[0] - ql[0];
    const T sv = T(0.5) * (ql[0] + qr[0]);
    w[0][0] = dq;
    s[0] = sv;
    am[0] = mn(sv, T(0)) * dq;
    ap[0] = mx(sv, T(0)) * dq;
    if (P.vel[0] != T(0) && ql[0] < T(0) && qr[0] > T(0)) {
      am[0] = T(-0.5) * ql[0] * ql[0];     // transonic rarefaction
      ap[0] = T(0.5) * qr[0] * qr[0];
    }
  }

  // by the sign of the receiving cell's state qc = ac[0]
  template <int E, typename T>
  HD static void rpt(const Sys3<T>&, const T[], const T ac[], const T[],
                     const T asdq[], T bm[], T bp[]) {
    bm[0] = mn(ac[0], T(0)) * asdq[0];
    bp[0] = mx(ac[0], T(0)) * asdq[0];
  }

  // _rptt_burgers is _rpt_burgers on the part, by the same cell
  template <int F, typename T>
  HD static void rptt(const Sys3<T>& P, const T ab[], const T ac[],
                      const T aa[], const T bs[], T cm[], T cp[]) {
    rpt<F, T>(P, ab, ac, aa, bs, cm, cp);
  }
};

}  // namespace
