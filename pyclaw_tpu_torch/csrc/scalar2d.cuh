// scalar2d.cuh — the scalar (one equation, one wave) 2D systems of the
// generic CTU kernel (step2_aos.cu), operation for operation as in
// pyclaw_tpu_torch/riemann:
//   Advection2D         advection.py  _rp_advection + _rpt_advection
//                       (constant u, v)
//   VcAdvection2D       advection.py  _rp_vc_advection + _rpt_vc_advection
//                       (aux rows: the edge velocities u, v)
//   VcAdvectionFwave2D  advection.py  _rp_vc_advection_fwave +
//                       _rpt_vc_advection (aux rows: cell velocities)
//   Kpp2D               kpp.py        _rp_kpp + _rpt_kpp
//   Burgers2D           burgers.py    _rp_burgers + _rpt_burgers (efix)
// Advection2D and Kpp2D split a fluctuation by the interface alone, so
// they give step2_aos.cu the hooks of shallow2d.cuh (Par and make_par,
// prep, nz, rpn, Trans).  The other three split it by the cell it enters
// (CELL_SPLIT): the state of that cell (Burgers) or the aux of that cell
// and of its upper neighbour along the transverse axis (the edge
// velocities of the variable-coefficient advection), which the plain
// version takes by a torch.roll of the receiving cells' aux; for them
// the hook is rpt<IXY>(P, qc, ab, ac, aa, asdq, bm, bp), with qc the
// receiving cell's state and ab, ac, aa the aux of the cell below it,
// of it and of the cell above it along the transverse axis
// (acoustics2d.cuh's VcAcoustics2D takes the same hook).
//
// kpp's sin and cos are the device library's (sinf / cosf in float32,
// euler2d.cuh sin_ / cos_), as torch.sin on the card, never the fast
// intrinsics; Kpp2D stages each
// cell's sin(q) and cos(q) once (prep).  The entropy fix of Burgers and
// the f-wave split of VcAdvectionFwave2D turn on signs: step2_aos.cu is
// built without fused multiply-adds, so a speed rounds as PyTorch's does.
//
// Compiles with nvcc and, without __CUDACC__, with a host C++ compiler
// for the kernel's host emulation (ops/_build.py:build_host_emulation).

#pragma once

#include "euler2d.cuh"

namespace {

// the hooks of a one-equation, one-wave system with no per-cell
// quantities: its one wave component is always nonzero
struct ScalarHooks {
  static constexpr int NEQ = 1, NW = 1, NPC = 0;
  template <typename P, typename T>
  static HD void prep(const P&, const T*, T*) {}
  template <int IXY> static HD constexpr bool nz(int, int) { return true; }
};

// the upwind split of one wave dq of speed s (advection.py _upwind)
template <typename T>
HD void upwind(const T ql[1], const T qr[1], T s_in, T w[1][1], T s[1],
               T am[1], T ap[1]) {
  const T dq = qr[0] - ql[0];
  w[0][0] = dq;
  s[0] = s_in;
  am[0] = mn(s_in, T(0)) * dq;
  ap[0] = mx(s_in, T(0)) * dq;
}

// ---- advection_2D: constant velocities (p0, p1) = (u, v) ----------------
template <typename T> struct Vel2 {
  T u[2];
};

struct Advection2D : ScalarHooks {
  static constexpr int NAUX = 0;
  template <typename T> using Par = Vel2<T>;
  template <typename T> static Vel2<T> make_par(double p0, double p1) {
    Vel2<T> P;
    P.u[0] = T(p0);
    P.u[1] = T(p1);
    return P;
  }

  template <int IXY, typename T>
  static HD void rpn(const Vel2<T>& P, const T ql[1], const T qr[1],
                     const T*, const T*, const T*, const T*, T w[1][1],
                     T s[1], T am[1], T ap[1]) {
    upwind(ql, qr, P.u[IXY], w, s, am, ap);
  }

  // the split by the transverse velocity: the same at every interface
  template <int IXY, typename T> struct Trans {
    T ut;
    HD Trans(const Vel2<T>& P, const T*, const T*, const T*, const T*)
        : ut(P.u[1 - IXY]) {}
    HD void split(const T asdq[1], T bm[1], T bp[1]) const {
      bm[0] = mn(ut, T(0)) * asdq[0];
      bp[0] = mx(ut, T(0)) * asdq[0];
    }
  };
};

// ---- vc_advection_2D: aux rows (u, v) at each cell's lower edges --------
struct VcAdvection2D : ScalarHooks {
  static constexpr int NAUX = 2;
  static constexpr bool CELL_SPLIT = true;
  template <typename T> using Par = NoPar<T>;
  template <typename T> static NoPar<T> make_par(double, double) {
    return NoPar<T>();
  }

  // the velocity at the shared interface: the right cell's lower edge
  template <int IXY, typename T>
  static HD void rpn(const NoPar<T>&, const T ql[1], const T qr[1],
                     const T*, const T* ar, const T*, const T*, T w[1][1],
                     T s[1], T am[1], T ap[1]) {
    upwind(ql, qr, ar[IXY], w, s, am, ap);
  }

  // _rpt_vc_advection: the down-going part by the receiving cell's lower
  // transverse edge, the up-going one by its upper edge (the lower edge
  // of the cell above)
  template <int IXY, typename T>
  static HD void rpt(const NoPar<T>&, const T*, const T*, const T ac[],
                     const T aa[], const T asdq[1], T bm[1], T bp[1]) {
    bm[0] = mn(ac[1 - IXY], T(0)) * asdq[0];
    bp[0] = mx(aa[1 - IXY], T(0)) * asdq[0];
  }
};

// ---- vc_advection_fwave_2D: aux rows (u, v) at the cell centres --------
struct VcAdvectionFwave2D : VcAdvection2D {
  // the f-wave Z = u_r q_r - u_l q_l, split by the sign of the average
  // speed (the where(s < 0) of the plain version)
  template <int IXY, typename T>
  static HD void rpn(const NoPar<T>&, const T ql[1], const T qr[1],
                     const T* al, const T* ar, const T*, const T*,
                     T w[1][1], T s[1], T am[1], T ap[1]) {
    const T ul = al[IXY], ur = ar[IXY];
    const T z = ur * qr[0] - ul * ql[0];
    const T sv = T(0.5) * (ul + ur);
    w[0][0] = z;
    s[0] = sv;
    am[0] = sv < T(0) ? z : T(0);
    ap[0] = sv >= T(0) ? z : T(0);
  }
};

// ---- kpp_2D: q_t + sin(q)_x + cos(q)_y = 0 -----------------------------
struct Kpp2D : ScalarHooks {
  static constexpr int NAUX = 0, NPC = 2;   // sin(q), cos(q)
  template <typename T> using Par = NoPar<T>;
  template <typename T> static NoPar<T> make_par(double, double) {
    return NoPar<T>();
  }

  template <typename T>
  static HD void prep(const NoPar<T>&, const T q[1], T pc[2]) {
    pc[0] = sin_(q[0]);
    pc[1] = cos_(q[0]);
  }

  // Rusanov with alpha = 1: amdq = (df - dq)/2, apdq = (df + dq)/2; the
  // speed is +-1 by the sign of the average f'(q) (x: cos q; y: -sin q)
  template <int IXY, typename T>
  static HD void rpn(const NoPar<T>&, const T ql[1], const T qr[1],
                     const T*, const T*, const T pl[2], const T pr[2],
                     T w[1][1], T s[1], T am[1], T ap[1]) {
    const T dq = qr[0] - ql[0];
    const T dfl = IXY == 0 ? pl[1] : -pl[0];
    const T dfr = IXY == 0 ? pr[1] : -pr[0];
    const T savg = T(0.5) * (dfl + dfr);
    const T fl = IXY == 0 ? pl[0] : pl[1];
    const T fr = IXY == 0 ? pr[0] : pr[1];
    const T dflux = fr - fl;
    w[0][0] = dq;
    s[0] = savg >= T(0) ? T(1) : T(-1);
    // alpha * dq with alpha = 1 is dq itself
    am[0] = T(0.5) * (dflux - dq);
    ap[0] = T(0.5) * (dflux + dq);
  }

  // the split by the transverse speed at the average state
  template <int IXY, typename T> struct Trans {
    T ut;
    HD Trans(const NoPar<T>&, const T ql[1], const T qr[1], const T*,
             const T*) {
      const T qa = T(0.5) * (ql[0] + qr[0]);
      ut = IXY == 0 ? cos_(qa) : -sin_(qa);
    }
    HD void split(const T asdq[1], T bm[1], T bp[1]) const {
      bm[0] = mn(ut, T(0)) * asdq[0];
      bp[0] = mx(ut, T(0)) * asdq[0];
    }
  };
};

// ---- burgers_2D: q_t + (q^2/2)_x + (q^2/2)_y = 0 -------------------------
template <typename T> struct Efix {
  bool on;   // the transonic entropy fix (problem_data['efix'])
};

struct Burgers2D : ScalarHooks {
  static constexpr int NAUX = 0;
  static constexpr bool CELL_SPLIT = true;
  template <typename T> using Par = Efix<T>;
  // p0: 1 with the entropy fix, 0 without
  template <typename T> static Efix<T> make_par(double p0, double) {
    Efix<T> P;
    P.on = p0 != 0.0;
    return P;
  }

  template <int IXY, typename T>
  static HD void rpn(const Efix<T>& P, const T ql[1], const T qr[1],
                     const T*, const T*, const T*, const T*, T w[1][1],
                     T s[1], T am[1], T ap[1]) {
    upwind(ql, qr, T(0.5) * (ql[0] + qr[0]), w, s, am, ap);
    if (P.on && ql[0] < T(0) && qr[0] > T(0)) {   // transonic rarefaction
      am[0] = T(-0.5) * ql[0] * ql[0];
      ap[0] = T(0.5) * qr[0] * qr[0];
    }
  }

  // _rpt_burgers: by the sign of the receiving cell's own state
  template <int IXY, typename T>
  static HD void rpt(const Efix<T>&, const T qc[1], const T*, const T*,
                     const T*, const T asdq[1], T bm[1], T bp[1]) {
    bm[0] = mn(qc[0], T(0)) * asdq[0];
    bp[0] = mx(qc[0], T(0)) * asdq[0];
  }
};

}  // namespace
