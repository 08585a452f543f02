// acoustics2d.cuh — linear acoustics, constant and variable coefficient,
// systems of the generic 2D CTU kernel (step2_aos.cu), operation for
// operation as in pyclaw_tpu_torch/riemann/acoustics.py and
// acoustics_var.py:
//   Acoustics2D    _rp_acoustics (rpn2) + _rpt_acoustics (rpt2)
//   VcAcoustics2D  _rp_acoustics_var + _rpt_acoustics_var (aux rows: the
//                  impedance Z and the sound speed c of each cell)
// q = (p, u, v), two waves of speeds -c and +c, each with components p
// and the normal velocity only; no aux, nothing per cell.  The Python
// scalar factors fold as they do there: 2.0 * zz once in double (Ac2::z2),
// -cc as the negated double (Ac2::mcc), each rounded to T where it meets a
// tensor.  The system gives step2_aos.cu the hooks the shallow-water
// systems of shallow2d.cuh give it: Par and make_par (its physics scalars
// in Args), prep (per-cell quantities: none), nz (the wave components that
// can be nonzero), rpn and Trans (the transverse split of one interface).
// VcAcoustics2D splits a fluctuation by the cell it enters and that
// cell's two neighbours along the transverse axis (Z and c of each), so
// it gives the CELL_SPLIT hook rpt of scalar2d.cuh in place of Trans.
//
// Compiles with nvcc and, without __CUDACC__, with a host C++ compiler
// for the kernel's host emulation (ops/_build.py:build_host_emulation).

#pragma once

#include "euler2d.cuh"

namespace {

// physics scalars in the kernel's type
template <typename T> struct Ac2 {
  T zz, cc, mcc, z2;   // impedance, sound speed, -cc, 2.0 * zz
};

// ---- acoustics_2D: q = (p, u, v) -------------------------------------------
struct Acoustics2D {
  static constexpr int NEQ = 3, NW = 2, NAUX = 0, NPC = 0;

  // the physics scalars in Args, rounded once from the doubles the
  // wrapper passes (p0 = zz, p1 = cc)
  template <typename T> using Par = Ac2<T>;
  template <typename T> static Ac2<T> make_par(double p0, double p1) {
    Ac2<T> P;
    P.zz = T(p0);
    P.cc = T(p1);
    P.mcc = T(-p1);
    P.z2 = T(2.0 * p0);
    return P;
  }

  template <typename T> static HD void prep(const Ac2<T>&, const T*, T*) {}

  // both waves have the pressure and the normal velocity only
  template <int IXY> static HD constexpr bool nz(int, int e) {
    return e != 2 - IXY;
  }

  template <int IXY, typename T>
  static HD void rpn(const Ac2<T>& P, const T ql[3], const T qr[3],
                     const T*, const T*, const T*, const T*, T w[2][3],
                     T s[2], T am[3], T ap[3]) {
    constexpr int mu = 1 + IXY, mv = 2 - IXY;
    const T d0 = qr[0] - ql[0], dmu = qr[mu] - ql[mu];
    const T a1 = (-d0 + P.zz * dmu) / P.z2;    // left-going strength
    const T a2 = (d0 + P.zz * dmu) / P.z2;     // right-going strength
    w[0][0] = -a1 * P.zz; w[0][mu] = a1; w[0][mv] = T(0);
    w[1][0] = a2 * P.zz; w[1][mu] = a2; w[1][mv] = T(0);
    s[0] = P.mcc;
    s[1] = P.cc;
    for (int e = 0; e < 3; ++e) {
      am[e] = P.mcc * w[0][e];
      ap[e] = P.cc * w[1][e];
    }
  }

  // _rpt_acoustics: split asdq along the transverse direction into its
  // down-going (bm) and up-going (bp) parts; the same at every interface
  template <int IXY, typename T> struct Trans {
    Ac2<T> P;
    HD Trans(const Ac2<T>& p, const T*, const T*, const T*, const T*)
        : P(p) {}
    HD void split(const T asdq[3], T bm[3], T bp[3]) const {
      constexpr int mu = 1 + IXY, mv = 2 - IXY;
      const T a1 = (-asdq[0] + P.zz * asdq[mv]) / P.z2;   // down-going
      const T a2 = (asdq[0] + P.zz * asdq[mv]) / P.z2;    // up-going
      bm[0] = P.cc * a1 * P.zz; bm[mu] = T(0); bm[mv] = P.mcc * a1;
      bp[0] = P.cc * a2 * P.zz; bp[mu] = T(0); bp[mv] = P.cc * a2;
    }
  };
};

// ---- vc_acoustics_2D: q = (p, u, v), aux rows (Z, c) ----------------------
struct VcAcoustics2D {
  static constexpr int NEQ = 3, NW = 2, NAUX = 2, NPC = 0;
  static constexpr bool CELL_SPLIT = true;

  template <typename T> using Par = NoPar<T>;
  template <typename T> static NoPar<T> make_par(double, double) {
    return NoPar<T>();
  }

  template <typename T> static HD void prep(const NoPar<T>&, const T*, T*) {}

  // both waves have the pressure and the normal velocity only
  template <int IXY> static HD constexpr bool nz(int, int e) {
    return e != 2 - IXY;
  }

  // the jump splits against the one-sided impedances; speeds -c_l, +c_r
  template <int IXY, typename T>
  static HD void rpn(const NoPar<T>&, const T ql[3], const T qr[3],
                     const T al[], const T ar[], const T*, const T*,
                     T w[2][3], T s[2], T am[3], T ap[3]) {
    constexpr int mu = 1 + IXY, mv = 2 - IXY;
    const T z_l = al[0], c_l = al[1], z_r = ar[0], c_r = ar[1];
    const T d0 = qr[0] - ql[0], dmu = qr[mu] - ql[mu];
    const T denom = z_l + z_r;
    const T a1 = (-d0 + z_r * dmu) / denom;
    const T a2 = (d0 + z_l * dmu) / denom;
    w[0][0] = -a1 * z_l; w[0][mu] = a1; w[0][mv] = T(0);
    w[1][0] = a2 * z_r; w[1][mu] = a2; w[1][mv] = T(0);
    s[0] = -c_l;
    s[1] = c_r;
    for (int e = 0; e < 3; ++e) {
      am[e] = -c_l * w[0][e];
      ap[e] = c_r * w[1][e];
    }
  }

  // _rpt_acoustics_var: split asdq against the impedances of the
  // receiving cell (ac) and of its neighbours below (ab) and above (aa)
  // along the transverse axis
  template <int IXY, typename T>
  static HD void rpt(const NoPar<T>&, const T*, const T ab[], const T ac[],
                     const T aa[], const T asdq[3], T bm[3], T bp[3]) {
    constexpr int mu = 1 + IXY, mv = 2 - IXY;
    const T z_c = ac[0], z_b = ab[0], z_a = aa[0];
    const T c_b = ab[1], c_a = aa[1];
    const T a1 = (-asdq[0] + z_c * asdq[mv]) / (z_c + z_b);
    const T a2 = (asdq[0] + z_c * asdq[mv]) / (z_c + z_a);
    bm[0] = c_b * a1 * z_b; bm[mu] = T(0); bm[mv] = -c_b * a1;
    bp[0] = c_a * a2 * z_a; bp[mu] = T(0); bp[mv] = c_a * a2;
  }
};

}  // namespace
