// euler3d.cuh — device code of the 3D Euler solver (5 equations) for
// step3_ctu.cu: the Roe average, the normal solve with its 5 explicit
// waves, the shared eigensystem of the splits, and the transverse split
// with the entropy and both shear waves summed into one wave
// (pyclaw_tpu_torch/riemann/euler.py: _roe_averages, _rpn3_euler,
// _prefactor_euler_3d, _split_transverse_euler), operation for
// operation.  Compiles with nvcc and, without __CUDACC__, with a host
// C++ compiler for the kernel's host emulation.
//
// step3_ctu.cu is built with contractions (fused multiply-adds), which
// move a result by roundoff wherever it is continuous in its inputs.  The
// f-wave correction 0.5 sign(s) is not: at a mirror-symmetric interface
// the sum of the normal momenta over sqrt(rho), m_l / sqrt(rho_l) +
// m_r / sqrt(rho_r), is exactly 0 in rounded arithmetic, and a fused
// multiply-add leaves the rounding error of one product instead: a speed
// of either sign, which moves a whole wave.  So with RN the normal solve
// sums its normal velocity with the rounding intrinsics (add_rn, mul_rn),
// which nvcc never contracts.

#pragma once

#include "euler2d.cuh"

namespace {

// one rounding per operation, never contracted
#if defined(__CUDACC__)
HD float add_rn(float a, float b) { return __fadd_rn(a, b); }
HD double add_rn(double a, double b) { return __dadd_rn(a, b); }
HD float mul_rn(float a, float b) { return __fmul_rn(a, b); }
HD double mul_rn(double a, double b) { return __dmul_rn(a, b); }
#else
template <typename T> HD T add_rn(T a, T b) { return a + b; }
template <typename T> HD T mul_rn(T a, T b) { return a * b; }
#endif

// Roe-averaged velocities (momentum rows M0, M1, M2, in that order),
// enthalpy and sound speed squared between ql and qr (equation order
// rho, rho u, rho v, rho w, E).  The order of the rows is part of the
// contract: the normal solve averages in the sweep's permuted order, the
// transverse splits in the fixed order (1, 2, 3).  With RN the first
// velocity is summed without contraction (see above).
template <int M0, int M1, int M2, bool RN = false, typename T>
HD void roe_avg3(T g1, const T ql[5], const T qr[5], T vel[3], T& H,
                 T& a2) {
  T irl = rsqrt_(ql[0]), irr = rsqrt_(qr[0]);
  T srl = ql[0] * irl, srr = qr[0] * irr;
  T rinv_l = irl * irl, rinv_r = irr * irr;
  T w = T(1) / (srl + srr);
  if (RN) {
    vel[0] = mul_rn(add_rn(mul_rn(ql[M0], irl), mul_rn(qr[M0], irr)), w);
  } else {
    vel[0] = (ql[M0] * irl + qr[M0] * irr) * w;
  }
  vel[1] = (ql[M1] * irl + qr[M1] * irr) * w;
  vel[2] = (ql[M2] * irl + qr[M2] * irr) * w;
  T ke_l = T(0.5) * (ql[M0] * ql[M0] + ql[M1] * ql[M1] + ql[M2] * ql[M2])
           * rinv_l;
  T ke_r = T(0.5) * (qr[M0] * qr[M0] + qr[M1] * qr[M1] + qr[M2] * qr[M2])
           * rinv_r;
  T p_l = g1 * (ql[4] - ke_l);
  T p_r = g1 * (qr[4] - ke_r);
  T H_l = (ql[4] + p_l) * rinv_l;
  T H_r = (qr[4] + p_r) * rinv_r;
  H = (srl * H_l + srr * H_r) * w;
  T ke = T(0.5) * (vel[0] * vel[0] + vel[1] * vel[1] + vel[2] * vel[2]);
  a2 = g1 * (H - ke);
}

// Roe data of the normal solve at one interface along axis D
template <typename T> struct Roe3 {
  T u, v, w, H, a;             // normal, two transverse velocities, H, a
  T a1, a3, ash, ash2, a5;     // wave strengths
};

template <int D, bool RN = false, typename T>
HD Roe3<T> roe_3d(T g1, const T ql[5], const T qr[5]) {
  constexpr int mu = 1 + D, mv = 1 + (D + 1) % 3, mw = 1 + (D + 2) % 3;
  Roe3<T> rs;
  T vel[3], H, a2;
  roe_avg3<mu, mv, mw, RN>(g1, ql, qr, vel, H, a2);
  const T u = vel[0], v = vel[1], w = vel[2];
  const T a = sqrt_(a2);
  T d0 = qr[0] - ql[0], dmu = qr[mu] - ql[mu], dmv = qr[mv] - ql[mv];
  T dmw = qr[mw] - ql[mw], dE = qr[4] - ql[4];
  T euv = H - (u * u + v * v + w * w);
  rs.a3 = g1 / a2 * (euv * d0 + u * dmu + v * dmv + w * dmw - dE);
  rs.ash = dmv - v * d0;
  rs.ash2 = dmw - w * d0;
  rs.a5 = (dmu + (a - u) * d0 - a * rs.a3) / (T(2) * a);
  rs.a1 = d0 - rs.a3 - rs.a5;
  rs.u = u;
  rs.v = v;
  rs.w = w;
  rs.H = H;
  rs.a = a;
  return rs;
}

// the 5 waves (wave p, equation e) and speeds of rpn3 from its Roe data;
// the components rpn3 leaves zero are zeros here
template <int D, typename T>
HD void waves3(const Roe3<T>& rs, T W[5][5], T s[5]) {
  constexpr int mu = 1 + D, mv = 1 + (D + 1) % 3, mw = 1 + (D + 2) % 3;
  const T u = rs.u, v = rs.v, w = rs.w, H = rs.H, a = rs.a;
  for (int p = 0; p < 5; ++p)
    for (int e = 0; e < 5; ++e) W[p][e] = T(0);
  W[0][0] = rs.a1; W[0][mu] = rs.a1 * (u - a); W[0][mv] = rs.a1 * v;
  W[0][mw] = rs.a1 * w; W[0][4] = rs.a1 * (H - u * a);
  W[1][0] = rs.a3; W[1][mu] = rs.a3 * u; W[1][mv] = rs.a3 * v;
  W[1][mw] = rs.a3 * w;
  W[1][4] = rs.a3 * T(0.5) * (u * u + v * v + w * w);
  W[2][mv] = rs.ash; W[2][4] = rs.ash * v;
  W[3][mw] = rs.ash2; W[3][4] = rs.ash2 * w;
  W[4][0] = rs.a5; W[4][mu] = rs.a5 * (u + a); W[4][mv] = rs.a5 * v;
  W[4][mw] = rs.a5 * w; W[4][4] = rs.a5 * (H + u * a);
  s[0] = u - a; s[1] = u; s[2] = u; s[3] = u; s[4] = u + a;
}

// the shared eigensystem of the transverse splits at one interface from
// its Roe average in the fixed order (1, 2, 3): (u1, u2, u3, H, a, g1/a2,
// 1/(2a)), _prefactor_euler_3d's with a2 taken as the quotient g1/a2
// that every split's entropy strength scales by, and the IEEE reciprocal
// of 2a that every split's acoustic strength is multiplied by (the plain
// version divides by 2a in each split: roundoff apart).  The sound speed
// and the quotient are the operations each split made before, done once
// per interface.
template <typename T>
HD void split_eig(T g1, const T vel[3], T H, T a2, T eig[7]) {
  eig[0] = vel[0];
  eig[1] = vel[1];
  eig[2] = vel[2];
  eig[3] = H;
  eig[4] = sqrt_(a2);
  eig[5] = g1 / a2;
  eig[6] = T(1) / (T(2) * eig[4]);
}

// transverse split of asdq along momentum row VC (1, 2, 3) with the
// shared eigensystem eig of split_eig
template <int VC, typename T>
HD void split3(const T eig[7], const T asdq[5], T bm[5], T bp[5]) {
  constexpr int s0 = VC == 1 ? 2 : 1;          // the two shear rows
  constexpr int s1 = VC == 3 ? 2 : 3;
  const T uu[4] = {T(0), eig[0], eig[1], eig[2]};
  const T H = eig[3], a = eig[4], ga2 = eig[5], r2a = eig[6];
  const T ke = T(0.5) * (uu[1] * uu[1] + uu[2] * uu[2] + uu[3] * uu[3]);
  const T vt = uu[VC];
  const T d0 = asdq[0], dE = asdq[4];
  T euv = H - T(2) * ke;
  T b3 = ga2 * (euv * d0 + uu[1] * asdq[1] + uu[2] * asdq[2]
                + uu[3] * asdq[3] - dE);
  T b5 = (asdq[VC] + (a - vt) * d0 - a * b3) * r2a;
  T b1 = d0 - b3 - b5;
  T bsh0 = asdq[s0] - uu[s0] * d0;
  T bsh1 = asdq[s1] - uu[s1] * d0;
  T w[3][5];
  w[0][0] = b1;
  w[1][0] = b3;
  w[2][0] = b5;
  for (int i = 1; i <= 3; ++i) {
    w[0][i] = b1 * uu[i];
    w[2][i] = b5 * uu[i];
  }
  w[0][VC] = b1 * (vt - a);
  w[2][VC] = b5 * (vt + a);
  w[1][s0] = b3 * uu[s0] + bsh0;
  w[1][s1] = b3 * uu[s1] + bsh1;
  w[1][VC] = b3 * vt;
  w[0][4] = b1 * (H - vt * a);
  w[1][4] = b3 * ke + bsh0 * uu[s0] + bsh1 * uu[s1];
  w[2][4] = b5 * (H + vt * a);
  const T sp[3] = {vt - a, vt, vt + a};
  for (int e = 0; e < 5; ++e) {
    T m = T(0), p = T(0);
    for (int k = 0; k < 3; ++k) {
      m = m + mn(sp[k], T(0)) * w[k][e];
      p = p + mx(sp[k], T(0)) * w[k][e];
    }
    bm[e] = m;
    bp[e] = p;
  }
}

}  // namespace
