// psystem2d.cuh — the 2D p-system of the generic CTU kernel (step2_aos.cu),
// operation for operation as in pyclaw_tpu_torch/riemann/psystem2d.py
// (_rpn2_psystem): q = (eps, rho u, rho v), aux rows (rho, K), the stress
// sigma = exp(K eps) - 1 or K eps, two f-waves at -c_l and c_r.
//
// The record has no transverse solver: Psystem2D is marked NO_TRANS, so
// step2_aos.cu runs it with transverse_waves 0, in a design of its own
// that stores each normal solve as its two strengths (strengths) and
// forms the waves again from them (wave).  Every interface of a cell
// takes the cell's u = rho u / rho and rho v / rho, its sigma, its
// impedance z = sqrt(rho sigma') and its sound speed c = sqrt(sigma' /
// rho): prep_aux stages them once a cell (the
// plain version computes them per interface, two exp a cell in the "exp"
// law, from the same operations on the same values, so the same bits).
// The stress law is the physics scalar p0 (0 "exp", 1 "linear"), each law
// a branch of its own.  exp is the device library's (expf in float32), as
// torch.exp on the card, never the fast intrinsic.
//
// Compiles with nvcc and, without __CUDACC__, with a host C++ compiler
// for the kernel's host emulation (ops/_build.py:build_host_emulation).

#pragma once

#include "euler2d.cuh"

namespace {

// the stress law: p0 = 1 for "linear", 0 for "exp"
template <typename T> struct Stress {
  bool linear;
};

struct Psystem2D {
  static constexpr int NEQ = 3, NW = 2, NAUX = 2, NPC = 5;
  static constexpr bool NO_TRANS = true;
  template <typename T> using Par = Stress<T>;
  template <typename T> static Stress<T> make_par(double p0, double) {
    Stress<T> P;
    P.linear = p0 != 0.0;
    return P;
  }

  // the cell's u (x), v (y), sigma, z and c from its state and aux (rho,
  // K); the plain version's stress() and the four expressions after it
  template <typename T>
  static HD void prep_aux(const Stress<T>& P, const T q[3], const T a[],
                          T pc[5]) {
    const T rho = a[0], K = a[1];
    pc[0] = q[1] / rho;
    pc[1] = q[2] / rho;
    T sigp;
    if (P.linear) {
      pc[2] = K * q[0];
      sigp = K;
    } else {
      const T e = exp_(K * q[0]);
      pc[2] = e - T(1);
      sigp = K * e;
    }
    pc[3] = sqrt_(rho * sigp);
    pc[4] = sqrt_(sigp / rho);
  }

  // both waves have eps and the normal momentum only
  template <int IXY> static HD constexpr bool nz(int, int e) {
    return e != 2 - IXY;
  }

  // the strengths b1, b2 of the two f-waves at an interface of axis IXY
  // from its cells' per-cell quantities (prep_aux)
  template <int IXY, typename T>
  static HD void strengths(const T pl[5], const T pr[5], T b[2]) {
    const T z_l = pl[3], z_r = pr[3];
    const T df1 = -(pr[IXY] - pl[IXY]);
    const T df2 = -(pr[2] - pl[2]);
    const T denom = z_l + z_r;
    b[0] = (df2 + z_r * df1) / denom;
    b[1] = (z_l * df1 - df2) / denom;
  }

  // component e of wave p of strength b at an interface of axis IXY whose
  // cells have the impedances z_l, z_r: (b1, b1 z_l) and (b2, -b2 z_r) in
  // eps and the normal momentum, 0 in the transverse momentum; the waves
  // are the fluctuations (amdq the first, apdq the second) and their
  // speeds -c_l and c_r
  template <int IXY, typename T>
  static HD T wave(int p, int e, T b, T z_l, T z_r) {
    if (e == 0) return b;
    if (e == 1 + IXY) return p == 0 ? b * z_l : -b * z_r;
    return T(0);
  }
};

}  // namespace
