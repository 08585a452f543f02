// dq2_systems.cuh — the 2D systems of the SharpClaw dq kernels
// (dq2_weno5.cu: WENO5; dq2_weno.cu: WENO orders 7-17), each a struct that
// gives NEQ, NW, Par and make_par, admissible, nz, waves, speeds and flux:
// the Euler 4-wave system (Euler4), the Euler 5-wave system with its
// passive tracer (Euler5) and constant-coefficient acoustics_2D
// (Acoustics).  The algebra is riemann/euler.py's _rpn2_euler_soa and
// _flux_euler_2d_soa and riemann/acoustics.py's _rp_acoustics_soa and
// _flux_acoustics_soa, operation for operation (the Python scalars folded
// in double as there).
//
// Compiles with nvcc and, without __CUDACC__, with a host C++ compiler
// for the kernels' host emulation (ops/_build.py:build_host_emulation).

#pragma once

#include "euler2d.cuh"

namespace {

// ---- Euler physics (riemann/euler.py) ----------------------------------
template <typename T> struct EulerPar {
  T g1;   // gamma - 1
};

// positivity: rho > 0 and p > 0
template <typename T> HD bool euler_admissible(T g1, const T q[4]) {
  const T rho = q[0];
  const T ke = T(0.5) * (q[1] * q[1] + q[2] * q[2]) / (rho > T(0) ? rho : T(1));
  const T p = g1 * (q[3] - ke);
  return rho > T(0) && p > T(0);
}

// _flux_euler_2d_soa; float64 divides twice, float32 shares 1/rho
template <int IXY>
HD void flux_2d(double g1, const double q[4], double f[4]) {
  constexpr int mu = 1 + IXY, mv = 2 - IXY;
  const double u = q[mu] / q[0];
  const double p = g1 * (q[3] - 0.5 * (q[1] * q[1] + q[2] * q[2]) / q[0]);
  f[0] = q[mu];
  f[mu] = q[mu] * u + p;
  f[mv] = q[mv] * u;
  f[3] = u * (q[3] + p);
}
template <int IXY>
HD void flux_2d(float g1, const float q[4], float f[4]) {
  constexpr int mu = 1 + IXY, mv = 2 - IXY;
  const float rinv = 1.0f / q[0];
  const float u = q[mu] * rinv;
  const float p = g1 * (q[3] - 0.5f * (q[1] * q[1] + q[2] * q[2]) * rinv);
  f[0] = q[mu];
  f[mu] = q[mu] * u + p;
  f[mv] = q[mv] * u;
  f[3] = u * (q[3] + p);
}

// ---- euler_4wave_2D: q = (rho, rho u, rho v, E) ------------------------
struct Euler4 {
  static constexpr int NEQ = 4, NW = 4;
  template <typename T> using Par = EulerPar<T>;
  template <typename T> static EulerPar<T> make_par(double p0, double) {
    EulerPar<T> P;
    P.g1 = T(p0);
    return P;
  }
  template <typename T>
  static HD bool admissible(const EulerPar<T>& P, const T q[4]) {
    return euler_admissible(P.g1, q);
  }
  // every wave component takes part in the fluctuations
  template <int IXY> static HD constexpr bool nz(int, int) { return true; }
  template <int IXY, typename T>
  static HD void waves(const EulerPar<T>& P, const T ql[4], const T qr[4],
                       T w[4][4], T s[4]) {
    const Roe<T> rs = roe_2d<IXY>(P.g1, ql, qr);
    roe_waves<IXY>(rs, w, s);
  }
  template <int IXY, typename T>
  static HD void speeds(const EulerPar<T>& P, const T ql[4], const T qr[4],
                        T s[4]) {
    const Roe<T> rs = roe_2d<IXY>(P.g1, ql, qr);
    s[0] = rs.u - rs.a;
    s[1] = rs.u;
    s[2] = rs.u;
    s[3] = rs.u + rs.a;
  }
  template <int IXY, typename T>
  static HD void flux(const EulerPar<T>& P, const T q[4], T f[4]) {
    flux_2d<IXY>(P.g1, q, f);
  }
};

// ---- euler_5wave_2D: q = (rho, rho u, rho v, E, rho phi) ----------------
// Euler4's algebra for the first four components (roe_2d, the waves of
// roe_waves, flux_2d), and the passive tracer of _rpn2_euler_soa(tracer)
// and _flux_euler_2d_soa(tracer): phi_hat from sqrt(rho) (not the rsqrt
// form), the tracer parts of the waves that carry density, a fifth wave
// of speed u, and the flux u q[4] with u as flux_2d's form computes it
struct Euler5 {
  static constexpr int NEQ = 5, NW = 5;
  template <typename T> using Par = EulerPar<T>;
  template <typename T> static EulerPar<T> make_par(double p0, double) {
    EulerPar<T> P;
    P.g1 = T(p0);
    return P;
  }
  // positivity on rho and p (the tracer is not tested)
  template <typename T>
  static HD bool admissible(const EulerPar<T>& P, const T q[5]) {
    return euler_admissible(P.g1, q);
  }
  // the shear wave (p = 2) has the transverse momentum and the energy
  // only, the tracer wave (p = 4) the tracer only: the plain version's
  // None components
  template <int IXY> static HD constexpr bool nz(int p, int e) {
    return p == 2 ? (e == 2 - IXY || e == 3) : (p == 4 ? e == 4 : true);
  }
  template <int IXY, typename T>
  static HD void waves(const EulerPar<T>& P, const T ql[5], const T qr[5],
                       T w[5][5], T s[5]) {
    const Roe<T> rs = roe_2d<IXY>(P.g1, ql, qr);
    T w4[4][4], s4[4];
    roe_waves<IXY>(rs, w4, s4);
    const T srl = sqrt_(ql[0]), srr = sqrt_(qr[0]);
    const T phat = (srl * (ql[4] / ql[0]) + srr * (qr[4] / qr[0]))
                   / (srl + srr);
    for (int p = 0; p < 4; ++p) {
      for (int e = 0; e < 4; ++e) w[p][e] = w4[p][e];
      s[p] = s4[p];
    }
    w[0][4] = rs.a1 * phat;
    w[1][4] = rs.a3 * phat;
    w[2][4] = T(0);
    w[3][4] = rs.a4 * phat;
    for (int e = 0; e < 4; ++e) w[4][e] = T(0);
    w[4][4] = (qr[4] - ql[4]) - phat * (qr[0] - ql[0]);
    s[4] = rs.u;
  }
  template <int IXY, typename T>
  static HD void speeds(const EulerPar<T>& P, const T ql[5], const T qr[5],
                        T s[5]) {
    const Roe<T> rs = roe_2d<IXY>(P.g1, ql, qr);
    s[0] = rs.u - rs.a;
    s[1] = rs.u;
    s[2] = rs.u;
    s[3] = rs.u + rs.a;
    s[4] = rs.u;
  }
  template <int IXY>
  static HD void flux(const EulerPar<double>& P, const double q[5],
                      double f[5]) {
    flux_2d<IXY>(P.g1, q, f);
    f[4] = (q[1 + IXY] / q[0]) * q[4];
  }
  template <int IXY>
  static HD void flux(const EulerPar<float>& P, const float q[5],
                      float f[5]) {
    flux_2d<IXY>(P.g1, q, f);
    const float rinv = 1.0f / q[0];
    f[4] = (q[1 + IXY] * rinv) * q[4];
  }
};

// ---- acoustics_2D: q = (p, u, v) (riemann/acoustics.py) ----------------
template <typename T> struct AcPar {
  // impedance, sound speed, -cc, 2 zz, zz cc, cc / zz: each folded in
  // double and rounded once, as the plain version's Python scalars
  T zz, cc, mcc, z2, zc, cz;
};

struct Acoustics {
  static constexpr int NEQ = 3, NW = 2;
  template <typename T> using Par = AcPar<T>;
  template <typename T> static AcPar<T> make_par(double zz, double cc) {
    AcPar<T> P;
    P.zz = T(zz);
    P.cc = T(cc);
    P.mcc = T(-cc);
    P.z2 = T(2.0 * zz);
    P.zc = T(zz * cc);
    P.cz = T(cc / zz);
    return P;
  }
  // no positivity fallback
  template <typename T> static HD bool admissible(const AcPar<T>&, const T*) {
    return true;
  }
  // both waves have the pressure and the normal velocity only
  template <int IXY> static HD constexpr bool nz(int, int e) {
    return e != 2 - IXY;
  }
  // _rp_acoustics_soa
  template <int IXY, typename T>
  static HD void waves(const AcPar<T>& P, const T ql[3], const T qr[3],
                       T w[2][3], T s[2]) {
    constexpr int mu = 1 + IXY, mv = 2 - IXY;
    const T d0 = qr[0] - ql[0], dmu = qr[mu] - ql[mu];
    const T a1 = (-d0 + P.zz * dmu) / P.z2;    // left-going strength
    const T a2 = (d0 + P.zz * dmu) / P.z2;     // right-going strength
    w[0][0] = -a1 * P.zz; w[0][mu] = a1; w[0][mv] = T(0);
    w[1][0] = a2 * P.zz; w[1][mu] = a2; w[1][mv] = T(0);
    s[0] = P.mcc;
    s[1] = P.cc;
  }
  template <int IXY, typename T>
  static HD void speeds(const AcPar<T>& P, const T*, const T*, T s[2]) {
    s[0] = P.mcc;
    s[1] = P.cc;
  }
  // _flux_acoustics_soa
  template <int IXY, typename T>
  static HD void flux(const AcPar<T>& P, const T q[3], T f[3]) {
    constexpr int mu = 1 + IXY, mv = 2 - IXY;
    f[0] = P.zc * q[mu];
    f[mu] = P.cz * q[0];
    f[mv] = T(0);
  }
};

}  // namespace
