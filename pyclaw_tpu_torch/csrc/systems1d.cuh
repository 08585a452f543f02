// systems1d.cuh — the 1D systems of the classic sweep kernel (step1.cu),
// operation for operation as in pyclaw_tpu_torch/riemann/:
//   Advection1D       advection.py:_rp_advection
//   Acoustics1D       acoustics.py:_rp_acoustics
//   EulerRoe1D<EFIX>  euler.py:_rp1_euler_roe (with and without the Harten
//                     entropy fix)
//   EulerHlle1D       euler.py:_rp1_euler_hlle
//   SwAug1D           shallow.py:_rp1_sw_aug (with _sw_aug_core)
// A Python scalar is rounded to T where it meets a tensor (P1d holds the
// rounded values); PyTorch's `float / tensor` is reciprocal(tensor) * float
// and is written so here.  Each system's cell() computes NC quantities of
// one cell that its rp() reads at both of the cell's interfaces (the same
// expressions the interface would compute, so the bits do not depend on
// where they are computed); rp() takes the two cells' states (a system
// with NAUX > 0 also their first NAUX aux rows) and quantities and returns
// the waves w[p][e], the speeds s[p] and the fluctuations amdq, apdq of
// one interface.
//
// Compiles with nvcc and, without __CUDACC__, with a host C++ compiler for
// the kernel's host emulation (ops/_build.py:build_host_emulation).

#pragma once

#include "euler2d.cuh"

namespace {

// physics scalars in the kernel's type, rounded once from the doubles the
// wrapper passes (p0, p1: u | zz, cc | gamma | grav, dry_tolerance)
template <typename T> struct P1d {
  T u;              // advection speed
  T zz, cc, mcc;    // acoustic impedance, sound speed, -cc
  T z2;             // 2.0 * zz
  T gamma, g1;      // gamma, gamma - 1.0
  T g, hg, dry;     // grav, grav * 0.5 (= 0.5 * grav), dry_tolerance
  void set(double p0, double p1) {
    u = T(p0);
    zz = T(p0);
    cc = T(p1);
    mcc = T(-p1);
    z2 = T(2.0 * p0);
    gamma = T(p0);
    g1 = T(p0 - 1.0);
    g = T(p0);
    hg = T(p0 * 0.5);
    dry = T(p1);
  }
};

// ---- advection_1D ---------------------------------------------------------
struct Advection1D {
  static constexpr int NEQ = 1, NW = 1, NC = 0, NAUX = 0;
  template <typename T>
  static HD void cell(const P1d<T>&, const T*, T*) {}
  template <typename T>
  static HD void rp(const P1d<T>& P, const T ql[1], const T qr[1], const T*,
                    const T*, T w[1][1], T s[1], T am[1], T ap[1]) {
    const T dq = qr[0] - ql[0];
    w[0][0] = dq;
    s[0] = P.u;
    am[0] = mn(P.u, T(0)) * dq;
    ap[0] = mx(P.u, T(0)) * dq;
  }
};

// ---- acoustics_1D: q = (p, u) ----------------------------------------------
struct Acoustics1D {
  static constexpr int NEQ = 2, NW = 2, NC = 0, NAUX = 0;
  template <typename T>
  static HD void cell(const P1d<T>&, const T*, T*) {}
  template <typename T>
  static HD void rp(const P1d<T>& P, const T ql[2], const T qr[2], const T*,
                    const T*, T w[2][2], T s[2], T am[2], T ap[2]) {
    const T d0 = qr[0] - ql[0], d1 = qr[1] - ql[1];
    const T a1 = (-d0 + P.zz * d1) / P.z2;
    const T a2 = (d0 + P.zz * d1) / P.z2;
    w[0][0] = -a1 * P.zz;
    w[0][1] = a1;
    w[1][0] = a2 * P.zz;
    w[1][1] = a2;
    s[0] = P.mcc;
    s[1] = P.cc;
    for (int e = 0; e < 2; ++e) {
      am[e] = P.mcc * w[0][e];
      ap[e] = P.cc * w[1][e];
    }
  }
};

// ---- Euler 1D: q = (rho, rho u, E) -----------------------------------------
// A cell's part of the Roe average (euler.py:_roe_averages with vel_idx =
// (1,)): sqrt(rho) as rho * rsqrt(rho), mom * rsqrt(rho) and the enthalpy
// H = (E + p) / rho, with 1/rho as rsqrt(rho)^2
enum { C_SR = 0, C_MR = 1, C_H = 2, ROE_NC = 3 };
template <typename T> HD void roe_cell(const P1d<T>& P, const T q[3], T c[]) {
  const T ir = rsqrt_(q[0]);
  const T rinv = ir * ir;
  const T ke = T(0.5) * (q[1] * q[1]) * rinv;
  const T p = P.g1 * (q[2] - ke);
  c[C_SR] = q[0] * ir;
  c[C_MR] = q[1] * ir;
  c[C_H] = (q[2] + p) * rinv;
}

// Roe-averaged velocity, enthalpy and sound speed of two cells' parts
template <typename T> struct Roe1 {
  T u, H, a2, a;
  HD Roe1(const P1d<T>& P, const T cl[], const T cr[]) {
    const T w = T(1) / (cl[C_SR] + cr[C_SR]);
    u = (cl[C_MR] + cr[C_MR]) * w;
    H = (cl[C_SR] * cl[C_H] + cr[C_SR] * cr[C_H]) * w;
    a2 = P.g1 * (H - T(0.5) * (u * u));
    a = sqrt_(a2);
  }
};

// velocity and clamped sound speed of a state (the entropy fix's sound());
// the clamp 1e-300 rounds to 0 in float32, as in PyTorch and JAX
template <typename T>
HD void sound1(const P1d<T>& P, T rho, T mom, T E, T& u, T& c) {
  const T p = P.g1 * (E - T(0.5) * mom * mom / rho);
  u = mom / rho;
  c = sqrt_(mx(P.gamma * p / rho, T(1e-300)));
}

template <bool EFIX> struct EulerRoe1D {
  static constexpr int NEQ = 3, NW = 3, NAUX = 0;
  // the Roe parts and, for the entropy fix, sound1's u and c of the cell
  enum { C_U = ROE_NC, C_C = ROE_NC + 1 };
  static constexpr int NC = EFIX ? ROE_NC + 2 : ROE_NC;
  template <typename T>
  static HD void cell(const P1d<T>& P, const T q[3], T c[]) {
    roe_cell(P, q, c);
    if constexpr (EFIX) sound1(P, q[0], q[1], q[2], c[C_U], c[C_C]);
  }
  template <typename T>
  static HD void rp(const P1d<T>& P, const T ql[3], const T qr[3],
                    const T cl[], const T cr[], T w[3][3], T s[3], T am[3],
                    T ap[3]) {
    const Roe1<T> r(P, cl, cr);
    const T u = r.u, H = r.H, a = r.a;
    const T d0 = qr[0] - ql[0], d1 = qr[1] - ql[1], d2 = qr[2] - ql[2];
    const T a2c = ((T(1) / r.a2) * P.g1) * ((H - u * u) * d0 + u * d1 - d2);
    const T a3c = (d1 + (a - u) * d0 - a * a2c) / (T(2) * a);
    const T a1c = d0 - a2c - a3c;
    w[0][0] = a1c; w[0][1] = a1c * (u - a); w[0][2] = a1c * (H - u * a);
    w[1][0] = a2c; w[1][1] = a2c * u; w[1][2] = a2c * T(0.5) * u * u;
    w[2][0] = a3c; w[2][1] = a3c * (u + a); w[2][2] = a3c * (H + u * a);
    s[0] = u - a;
    s[1] = u;
    s[2] = u + a;
    if (!EFIX) {
      for (int e = 0; e < 3; ++e) {
        am[e] = mn(s[0], T(0)) * w[0][e] + mn(s[1], T(0)) * w[1][e]
              + mn(s[2], T(0)) * w[2][e];
        ap[e] = mx(s[0], T(0)) * w[0][e] + mx(s[1], T(0)) * w[1][e]
              + mx(s[2], T(0)) * w[2][e];
      }
      return;
    }
    // Harten entropy fix: transonic 1- and 3-rarefactions get a split speed
    T u_m, c_m;
    // state just right of the 1-wave
    sound1(P, ql[0] + w[0][0], ql[1] + w[0][1], ql[2] + w[0][2], u_m, c_m);
    const T lam1_l = cl[C_U] - cl[C_C], lam1_m = u_m - c_m;
    const bool trans1 = lam1_l < T(0) && lam1_m > T(0);
    const T den1 = lam1_m - lam1_l;
    const T sf1 = trans1
        ? lam1_l * (lam1_m - s[0]) / (den1 == T(0) ? T(1) : den1)
        : mn(s[0], T(0));
    const T sf2 = mn(s[1], T(0));
    // state just left of the 3-wave
    sound1(P, qr[0] - w[2][0], qr[1] - w[2][1], qr[2] - w[2][2], u_m, c_m);
    const T lam3_m = u_m + c_m, lam3_r = cr[C_U] + cr[C_C];
    const bool trans3 = lam3_m < T(0) && lam3_r > T(0);
    const T den3 = lam3_r - lam3_m;
    const T sf3 = trans3
        ? lam3_m * (lam3_r - s[2]) / (den3 == T(0) ? T(1) : den3)
        : mn(s[2], T(0));
    for (int e = 0; e < 3; ++e) {
      am[e] = sf1 * w[0][e] + sf2 * w[1][e] + sf3 * w[2][e];
      // conservation: amdq + apdq = sum_p s_p W_p, not a split of s
      ap[e] = (s[0] * w[0][e] + s[1] * w[1][e] + s[2] * w[2][e]) - am[e];
    }
  }
};

// ---- euler_hlle_1D: two waves through the intermediate state ---------------
struct EulerHlle1D {
  static constexpr int NEQ = 3, NW = 2, NAUX = 0;
  // the Roe parts, then the cell's velocity, pressure and sound speed
  enum { C_U = ROE_NC, C_P = ROE_NC + 1, C_C = ROE_NC + 2 };
  static constexpr int NC = ROE_NC + 3;
  template <typename T>
  static HD void cell(const P1d<T>& P, const T q[3], T c[]) {
    roe_cell(P, q, c);
    c[C_U] = q[1] / q[0];
    c[C_P] = P.g1 * (q[2] - T(0.5) * (q[1] * q[1]) / q[0]);
    c[C_C] = sqrt_(P.gamma * c[C_P] / q[0]);
  }
  template <typename T>
  static HD void rp(const P1d<T>& P, const T ql[3], const T qr[3],
                    const T cl[], const T cr[], T w[2][3], T s[2], T am[3],
                    T ap[3]) {
    const Roe1<T> r(P, cl, cr);
    const T u_l = cl[C_U], u_r = cr[C_U];
    const T p_l = cl[C_P], p_r = cr[C_P];
    const T s1 = mn(r.u - r.a, u_l - cl[C_C]);
    const T s2 = mx(r.u + r.a, u_r + cr[C_C]);
    const T f_l[3] = {ql[1], ql[1] * u_l + p_l, u_l * (ql[2] + p_l)};
    const T f_r[3] = {qr[1], qr[1] * u_r + p_r, u_r * (qr[2] + p_r)};
    const T ds = s2 - s1;
    const T denom = ds == T(0) ? T(1) : ds;
    s[0] = s1;
    s[1] = s2;
    for (int e = 0; e < 3; ++e) {
      const T q_m = (f_r[e] - f_l[e] - (s2 * qr[e] - s1 * ql[e])) / -denom;
      w[0][e] = q_m - ql[e];
      w[1][e] = qr[e] - q_m;
    }
    for (int e = 0; e < 3; ++e) {
      am[e] = mn(s1, T(0)) * w[0][e] + mn(s2, T(0)) * w[1][e];
      ap[e] = mx(s1, T(0)) * w[0][e] + mx(s2, T(0)) * w[1][e];
    }
  }
};

// ---- sw_aug_1D: q = (h, hu), aux[0] = b; f-wave form ----------------------
// The dry-state machinery of _sw_aug_core: a dry cell whose bottom lies
// above the wet neighbour's surface is a wall (it reflects the wet state);
// Einfeldt speeds, replaced by the Ritter front speed toward a dry side;
// the HLLE-type split of the bathymetry-augmented flux jump with the
// surface as the state jump.  Every branch is a select on a sign test of
// the plain version (h > dry, h + b <= b', the signs of s1 and s2), each
// operand rounded as there (the source is built without contractions).
struct SwAug1D {
  static constexpr int NEQ = 2, NW = 2, NC = 0, NAUX = 1;
  template <typename T>
  static HD void cell(const P1d<T>&, const T*, T*) {}
  template <typename T>
  static HD void rp(const P1d<T>& P, const T ql[2], const T qr[2],
                    const T al[], const T ar[], const T*, const T*,
                    T w[2][2], T s[2], T am[2], T ap[2]) {
    const T h_l = ql[0], h_r = qr[0], b_l = al[0], b_r = ar[0];
    const bool wet_l = h_l > P.dry, wet_r = h_r > P.dry;
    const T u_l0 = wet_l ? ql[1] / h_l : T(0);
    const T u_r0 = wet_r ? qr[1] / h_r : T(0);
    const bool wall_r = !wet_r && wet_l && h_l + b_l <= b_r;
    const bool wall_l = !wet_l && wet_r && h_r + b_r <= b_l;

    const T h_le = wall_l ? h_r : (wet_l ? h_l : T(0));
    const T u_le = wall_l ? -u_r0 : u_l0;
    const T b_le = wall_l ? b_r : b_l;
    const T h_re = wall_r ? h_l : (wet_r ? h_r : T(0));
    const T u_re = wall_r ? -u_l0 : u_r0;
    const T b_re = wall_r ? b_l : b_r;
    const bool wet_le = wet_l || wall_l, wet_re = wet_r || wall_r;
    const bool bothdry = !wet_le && !wet_re;

    const T c_l = sqrt_(P.g * h_le), c_r = sqrt_(P.g * h_re);
    const T sh_l = sqrt_(h_le), sh_r = sqrt_(h_re);
    const T wsum = sh_l + sh_r > T(0) ? sh_l + sh_r : T(1);
    const T u_hat = (sh_l * u_le + sh_r * u_re) / wsum;
    const T c_hat = sqrt_(P.hg * (h_le + h_re));
    T s1 = mn(u_le - c_l, u_hat - c_hat);
    T s2 = mx(u_re + c_r, u_hat + c_hat);
    // the exact rarefaction front toward a dry side (Ritter)
    if (wet_re && !wet_le) s1 = u_re - T(2) * c_r;
    if (wet_le && !wet_re) s2 = u_le + T(2) * c_l;
    if (bothdry) {
      s1 = T(0);
      s2 = T(0);
    }

    const T hu_le = h_le * u_le, hu_re = h_re * u_re;
    const T hbar = T(0.5) * (h_le + h_re);
    const T fd1 = hu_re - hu_le;
    const T fd2 = (hu_re * u_re + P.hg * h_re * h_re)
                - (hu_le * u_le + P.hg * h_le * h_le)
                + P.g * hbar * (b_re - b_le);
    // the dissipative state jump: surface and momentum
    const T dq1 = (h_re + b_re) - (h_le + b_le);
    const T dq2 = fd1;
    const T ds = s2 - s1;
    const T denom = ds == T(0) ? T(1) : ds;
    const T zero = bothdry ? T(0) : T(1) / denom;
    const T W1[2] = {(s2 * dq1 - fd1) * zero, (s2 * dq2 - fd2) * zero};
    const T W2[2] = {(fd1 - s1 * dq1) * zero, (fd2 - s1 * dq2) * zero};

    // f-waves s_p W_p, zeroed where either cell is dry (first order at
    // fronts); no fluctuation into a dry wall cell
    const bool frontal = h_l <= P.dry || h_r <= P.dry;
    s[0] = s1;
    s[1] = s2;
    for (int e = 0; e < 2; ++e) {
      w[0][e] = frontal ? T(0) : s1 * W1[e];
      w[1][e] = frontal ? T(0) : s2 * W2[e];
      am[e] = wall_l ? T(0) : mn(s1, T(0)) * W1[e] + mn(s2, T(0)) * W2[e];
      ap[e] = wall_r ? T(0) : mx(s1, T(0)) * W1[e] + mx(s2, T(0)) * W2[e];
    }
  }
};

}  // namespace
