// euler3d_aos.cuh — the 3D Euler system (5 equations, 5 waves) of the
// generic 3D CTU kernel (step3_aos.cu), operation for operation as in
// pyclaw_tpu_torch/riemann/euler.py: _rpn3_euler (the normal solve, its
// Roe average in the sweep's permuted order), _prefactor_euler_3d (the
// Roe average of a D-interface in the fixed order (1, 2, 3)) and
// _split_transverse_euler (rpt3 and rptt3: the entropy and both shear
// waves summed into one wave of speed vt, so a split has 3 speeds).
//
// A split takes the state of the normal D-interface whose fluctuation it
// splits (ql, qr: the interface's two staged cells), not the receiving
// cell's aux: the rptt3 split of a part too takes that interface's state.
// The Roe average of the splits is recomputed from ql, qr in each split,
// the same operations on the same values as the plain version's one
// prefactor per interface (the same bits); the shared memory holds no
// room to stage it.  The Roe functions of euler3d.cuh (roe_avg3, roe_3d,
// waves3) are the plain version's operations when built without
// contractions; the split here divides by 2a where euler3d.cuh's split3
// (for step3_ctu.cu) multiplies by a shared reciprocal.
//
// Compiles with nvcc and, without __CUDACC__, with a host C++ compiler
// for the kernel's host emulation (ops/_build.py:build_host_emulation).

#pragma once

#include "acoustics3d.cuh"
#include "euler3d.cuh"

namespace {

// _prefactor_euler_3d at one D-interface: the Roe velocities (u[1..3];
// u[0] unused), enthalpy, sound speed and its square, and the kinetic
// energy per unit mass of the Roe velocities
template <typename T> struct EulerEig {
  T u[4];
  T H, a, a2, ke;
};

template <typename T>
HD EulerEig<T> euler_eig(T g1, const T ql[5], const T qr[5]) {
  EulerEig<T> g;
  T vel[3];
  roe_avg3<1, 2, 3>(g1, ql, qr, vel, g.H, g.a2);
  g.u[0] = T(0);
  g.u[1] = vel[0];
  g.u[2] = vel[1];
  g.u[3] = vel[2];
  g.a = sqrt_(g.a2);
  g.ke = T(0.5) * (vel[0] * vel[0] + vel[1] * vel[1] + vel[2] * vel[2]);
  return g;
}

// _split_transverse_euler: asdq split along momentum row VC (1, 2, 3)
template <int VC, typename T>
HD void euler_split(T g1, const EulerEig<T>& g, const T asdq[5], T bm[5],
                    T bp[5]) {
  constexpr int s0 = VC == 1 ? 2 : 1;          // the two shear rows
  constexpr int s1 = VC == 3 ? 2 : 3;
  const T* uu = g.u;
  const T H = g.H, a = g.a, ke = g.ke;
  const T vt = uu[VC];
  const T d0 = asdq[0], dE = asdq[4];
  const T euv = H - T(2) * ke;
  const T b3 = g1 / g.a2 * (euv * d0 + uu[1] * asdq[1] + uu[2] * asdq[2]
                            + uu[3] * asdq[3] - dE);
  const T b5 = (asdq[VC] + (a - vt) * d0 - a * b3) / (T(2) * a);
  const T b1 = d0 - b3 - b5;
  const T bsh0 = asdq[s0] - uu[s0] * d0;
  const T bsh1 = asdq[s1] - uu[s1] * d0;
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

// ---- 3D Euler: q = (rho, rho u, rho v, rho w, E), gamma - 1 in Sys3::g1 --
struct Euler3D {
  static constexpr int NEQ = 5, NW = 5, NAUX = 0;
  static constexpr bool HAS_RPTT = true;

  template <int D, typename T>
  HD static void rpn(const Sys3<T>& P, const T ql[], const T qr[],
                     const T[], const T[], T w[][NEQ], T s[], T am[],
                     T ap[]) {
    waves3<D>(roe_3d<D>(P.g1, ql, qr), w, s);
    // _wsum: the waves in order, from the first term
    for (int e = 0; e < NEQ; ++e) {
      T m = mn(s[0], T(0)) * w[0][e];
      T p = mx(s[0], T(0)) * w[0][e];
      for (int k = 1; k < NW; ++k) {
        m = m + mn(s[k], T(0)) * w[k][e];
        p = p + mx(s[k], T(0)) * w[k][e];
      }
      am[e] = m;
      ap[e] = p;
    }
  }

  // rpt3: split along E with the state of the D-interface (ql, qr)
  template <int E, typename T>
  HD static void rpt(const Sys3<T>& P, const T ql[], const T qr[],
                     const T[], const T[], const T[], const T asdq[],
                     T bm[], T bp[]) {
    euler_split<1 + E>(P.g1, euler_eig(P.g1, ql, qr), asdq, bm, bp);
  }

  // rptt3: split of a part along F, with the same D-interface's state
  template <int F, typename T>
  HD static void rptt(const Sys3<T>& P, const T ql[], const T qr[],
                      const T ab[], const T ac[], const T aa[],
                      const T bs[], T cm[], T cp[]) {
    rpt<F, T>(P, ql, qr, ab, ac, aa, bs, cm, cp);
  }
};

}  // namespace
