// euler2d_aos.cuh — the 2D Euler systems of the generic CTU kernel
// (step2_aos.cu), operation for operation as in
// pyclaw_tpu_torch/riemann/euler.py:
//   EulerAoS2D<4>  euler_4wave_2D: _rpn2_euler + _rpt2_euler with the Roe
//                  average of _prefactor_euler_2d
//   EulerAoS2D<5>  euler_5wave_2D: the same with the passive tracer
//                  q[4] = rho phi (the tracer branches of _rpn2_euler and
//                  _rpt2_euler)
// q = (rho, rho u, rho v, E (, rho phi)); no aux.  gamma - 1 is folded in
// double by the wrapper (p0), as the plain version's Python scalar, and
// rounded once to T.  The system gives step2_aos.cu the hooks of its
// compact design (step2_aos.cu, "the Euler systems"): Par and make_par,
// prep (the per-cell quantities), nz (the wave components that can be
// nonzero), solve (the normal solve: the interface's record and its
// fluctuations), wave and speed (a wave's components and speed from a
// record) and Trans (the transverse split of one interface, from its
// record).
//
// The per-cell quantities of _roe_averages (rsqrt(rho), rho rsqrt(rho),
// the enthalpy (E + p)/rho, and for the tracer sqrt(rho) and phi =
// q[4]/rho) are computed once per staged cell: each is the same
// expression of the same cell's values at either of its interfaces (the
// kinetic energy's two squares commute), so the bits do not depend on
// where they are computed.  The record holds what determines the waves:
// the strengths and the Roe average (NR values where the waves and speeds
// are 30, 20 for 4 waves).  A component formed again from it by the
// expression the normal solve formed it by has the same bits (the source
// is built without contraction), and so does the Roe average the splits
// take from it.  Each sum runs over every wave, zero components included,
// in the plain version's order.
//
// Compiles with nvcc and, without __CUDACC__, with a host C++ compiler
// for the kernel's host emulation (ops/_build.py:build_host_emulation).

#pragma once

#include "euler2d.cuh"

namespace {

// physics scalar in the kernel's type
template <typename T> struct EulerP {
  T g1;   // gamma - 1
};

// the Roe average of one interface from the two cells' states and
// per-cell quantities (pc: rsqrt(rho), rho rsqrt(rho), H_cell):
// _roe_averages with vel_idx (mu, mv)
template <int IXY, typename T> struct RoeE {
  T u, v, H, a2, a;
  HD RoeE(T g1, const T ql[], const T qr[], const T pl[], const T pr[]) {
    constexpr int mu = 1 + IXY, mv = 2 - IXY;
    const T irl = pl[0], irr = pr[0], srl = pl[1], srr = pr[1];
    const T w = T(1) / (srl + srr);
    u = (ql[mu] * irl + qr[mu] * irr) * w;
    v = (ql[mv] * irl + qr[mv] * irr) * w;
    H = (srl * pl[2] + srr * pr[2]) * w;
    a2 = g1 * (H - T(0.5) * (u * u + v * v));
    a = sqrt_(a2);
  }
};

template <int NE> struct EulerAoS2D {
  static_assert(NE == 4 || NE == 5, "Euler 4-wave or 5-wave");
  static constexpr int NEQ = NE, NW = NE, NAUX = 0;
  static constexpr int NPC = NE == 5 ? 5 : 3;
  // the record of an interface's normal solve, which determines its waves
  // and speeds: the strengths a1, a3, a2w, a4 (and the tracer wave's
  // jump), then the Roe average u, v, H, a (and phi_hat)
  enum { R_A1 = 0, R_A3 = 1, R_A2W = 2, R_A4 = 3, R_W44 = 4,
         R_U = NE, R_V = NE + 1, R_H = NE + 2, R_A = NE + 3, R_PHAT = NE + 4 };
  static constexpr int NR = NE == 5 ? 10 : 8;

  template <typename T> using Par = EulerP<T>;
  template <typename T> static EulerP<T> make_par(double p0, double) {
    EulerP<T> P;
    P.g1 = T(p0);
    return P;
  }

  // rsqrt(rho), rho rsqrt(rho), (E + p)/rho with p = g1 (E - ke); the
  // tracer's sqrt(rho) and q[4]/rho
  template <typename T>
  static HD void prep(const EulerP<T>& P, const T q[], T pc[]) {
    const T ir = rsqrt_(q[0]);
    const T rinv = ir * ir;
    const T ke = T(0.5) * (q[1] * q[1] + q[2] * q[2]) * rinv;
    const T p = P.g1 * (q[3] - ke);
    pc[0] = ir;
    pc[1] = q[0] * ir;
    pc[2] = (q[3] + p) * rinv;
    if constexpr (NE == 5) {
      pc[3] = sqrt_(q[0]);
      pc[4] = q[4] / q[0];
    }
  }

  // the shear wave (p = 2) has the transverse momentum and the energy
  // only, the tracer wave (p = 4) the tracer only
  template <int IXY> static HD constexpr bool nz(int p, int e) {
    return p == 2 ? (e == 2 - IXY || e == 3) : (p == 4 ? e == 4 : true);
  }

  // the speed of wave p from an interface's record
  template <typename T> static HD T speed(const T r[], int p) {
    return p == 0 ? r[R_U] - r[R_A] : (p == 3 ? r[R_U] + r[R_A] : r[R_U]);
  }

  // the components of wave p from an interface's record, each the
  // expression _rpn2_euler forms it by
  template <int IXY, typename T>
  static HD void wave(const T r[], int p, T w[NE]) {
    constexpr int mu = 1 + IXY, mv = 2 - IXY;
    const T u = r[R_U], v = r[R_V], H = r[R_H], a = r[R_A];
    for (int e = 0; e < NE; ++e) w[e] = T(0);
    if (p == 0) {
      const T a1 = r[R_A1];
      w[0] = a1; w[mu] = a1 * (u - a); w[mv] = a1 * v;
      w[3] = a1 * (H - u * a);
    } else if (p == 1) {
      const T a3 = r[R_A3];
      w[0] = a3; w[mu] = a3 * u; w[mv] = a3 * v;
      w[3] = a3 * T(0.5) * (u * u + v * v);
    } else if (p == 2) {
      w[mv] = r[R_A2W]; w[3] = r[R_A2W] * v;
    } else if (p == 3) {
      const T a4 = r[R_A4];
      w[0] = a4; w[mu] = a4 * (u + a); w[mv] = a4 * v;
      w[3] = a4 * (H + u * a);
    }
    if constexpr (NE == 5) {
      // phi_hat from the cells' sqrt(rho) and phi (not the rsqrt form);
      // the rest of the tracer's jump is wave 4, of speed u
      if (p == 4) w[4] = r[R_W44];
      else if (p != 2) w[4] = r[p == 0 ? R_A1 : (p == 1 ? R_A3 : R_A4)]
                             * r[R_PHAT];
    }
  }

  // _rpn2_euler at one interface: its record and its fluctuations
  template <int IXY, typename T>
  static HD void solve(const EulerP<T>& P, const T ql[], const T qr[],
                       const T pl[], const T pr[], T rec[NR], T am[NE],
                       T ap[NE]) {
    constexpr int mu = 1 + IXY, mv = 2 - IXY;
    const RoeE<IXY, T> r(P.g1, ql, qr, pl, pr);
    const T u = r.u, v = r.v, H = r.H, a = r.a;
    const T d0 = qr[0] - ql[0], dmu = qr[mu] - ql[mu];
    const T dmv = qr[mv] - ql[mv], dE = qr[3] - ql[3];
    const T euv = H - (u * u + v * v);
    T a3, a4;
    alpha34(P.g1, a, r.a2, euv * d0 + u * dmu + v * dmv - dE,
            dmu + (a - u) * d0, a3, a4);
    rec[R_A1] = d0 - a3 - a4;
    rec[R_A3] = a3;
    rec[R_A2W] = dmv - v * d0;
    rec[R_A4] = a4;
    rec[R_U] = u;
    rec[R_V] = v;
    rec[R_H] = H;
    rec[R_A] = a;
    if constexpr (NE == 5) {
      const T phat = (pl[3] * pl[4] + pr[3] * pr[4]) / (pl[3] + pr[3]);
      rec[R_W44] = (qr[4] - ql[4]) - phat * d0;
      rec[R_PHAT] = phat;
    }
    // _wsum: the terms in wave order, from the first, zero components
    // included
    T w[NE][NE], s[NE];
#pragma unroll
    for (int p = 0; p < NE; ++p) {
      wave<IXY>(rec, p, w[p]);
      s[p] = speed(rec, p);
    }
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      T m = mn(s[0], T(0)) * w[0][e], p = mx(s[0], T(0)) * w[0][e];
      for (int k = 1; k < NE; ++k) {
        m = m + mn(s[k], T(0)) * w[k][e];
        p = p + mx(s[k], T(0)) * w[k][e];
      }
      am[e] = m;
      ap[e] = p;
    }
  }

  // _rpt2_euler: split asdq along the transverse direction into its
  // down-going (bm) and up-going (bp) parts at the interface's Roe
  // average, taken from its record (a2 formed again as RoeE forms it),
  // which the two splits share
  template <int IXY, typename T> struct Trans {
    T g1a2, u, v, H, a, ta, amv, euv, uv2;
    HD Trans(const EulerP<T>& P, const T rec[]) {
      u = rec[R_U];
      v = rec[R_V];
      H = rec[R_H];
      a = rec[R_A];
      const T a2 = P.g1 * (H - T(0.5) * (u * u + v * v));
      uv2 = u * u + v * v;
      euv = H - uv2;
      g1a2 = P.g1 / a2;
      ta = T(2) * a;
      amv = a - v;
    }
    HD void split(const T asdq[], T bm[], T bp[]) const {
      constexpr int mu = 1 + IXY, mv = 2 - IXY;
      const T d0 = asdq[0], dmu = asdq[mu], dmv = asdq[mv], dE = asdq[3];
      const T b3 = g1a2 * (euv * d0 + u * dmu + v * dmv - dE);
      const T b2w = dmu - u * d0;
      const T b4 = (dmv + amv * d0 - a * b3) / ta;
      const T b1 = d0 - b3 - b4;
      T w[4][4];
      w[0][0] = b1; w[0][mu] = b1 * u; w[0][mv] = b1 * (v - a);
      w[0][3] = b1 * (H - v * a);
      w[1][0] = b3; w[1][mu] = b3 * u; w[1][mv] = b3 * v;
      w[1][3] = b3 * T(0.5) * uv2;
      w[2][0] = T(0); w[2][mu] = b2w; w[2][mv] = T(0); w[2][3] = b2w * u;
      w[3][0] = b4; w[3][mu] = b4 * u; w[3][mv] = b4 * (v + a);
      w[3][3] = b4 * (H + v * a);
      const T sp[4] = {v - a, v, v, v + a};
      for (int e = 0; e < 4; ++e) {
        T m = T(0), p = T(0);
        for (int k = 0; k < 4; ++k) {
          m = m + mn(sp[k], T(0)) * w[k][e];
          p = p + mx(sp[k], T(0)) * w[k][e];
        }
        bm[e] = m;
        bp[e] = p;
      }
      if constexpr (NE == 5) {
        // the tracer rides the transverse flow (the waves' tracer
        // components are zeros: their sum is +0)
        bm[4] = T(0) + mn(v, T(0)) * asdq[4];
        bp[4] = T(0) + mx(v, T(0)) * asdq[4];
      }
    }
  };
};

using Euler4AoS2D = EulerAoS2D<4>;
using Euler5AoS2D = EulerAoS2D<5>;

}  // namespace
