// systems1d.cuh — the 1D systems of the classic sweep kernel (step1.cu),
// operation for operation as in pyclaw_tpu_torch/riemann/:
//   Advection1D       advection.py:_rp_advection
//   Acoustics1D       acoustics.py:_rp_acoustics
//   EulerRoe1D<EFIX>  euler.py:_rp1_euler_roe (with and without the Harten
//                     entropy fix)
//   EulerHlle1D       euler.py:_rp1_euler_hlle
//   SwAug1D           shallow.py:_rp1_sw_aug (with _sw_aug_core)
//   ShallowRoe1D<EFIX> shallow.py:_rp1_shallow_roe (shallow_roe_with_efix_1D:
//                     the Harten fix; EFIX false is the fix-free branch)
//   ShallowHlle1D     shallow.py:_rp1_shallow_hlle
//   ShallowBathyFwave1D shallow.py:_rp1_shallow_bathymetry_fwave (aux: b)
//   Psystem1D         psystem.py:_rp_psystem (aux: rho, K; exp or linear)
//   VcAdvection1D     advection.py:_rp_vc_advection (aux: edge velocity)
//   VcAdvectionFwave1D advection.py:_rp_vc_advection_fwave (aux: cell
//                     velocity)
//   AcousticsVar1D    acoustics_var.py:_rp_acoustics_var (aux: Z, c)
//   Burgers1D         burgers.py:_rp_burgers (with or without the fix)
//   Traffic1D         traffic.py:_rp_traffic
//   Mhd1D             mhd.py:_rp_mhd_hll (NEQ 7, two HLL waves)
// A Python scalar is rounded to T where it meets a tensor (P1d holds the
// rounded values); PyTorch's `float / tensor` is reciprocal(tensor) * float
// and is written so here.  Each system's cell() computes NC quantities of
// one cell that its rp() reads at both of the cell's interfaces (the same
// expressions the interface would compute, so the bits do not depend on
// where they are computed); rp() takes the two cells' states (a system
// with NAUX > 0 also their first NAUX aux rows) and quantities and returns
// the waves w[p][e], the speeds s[p] and the fluctuations amdq, apdq of
// one interface.  A system with NAUX > 0 and NC > 0 computes its cell
// quantities from the cell's aux rows too: cell(P, q, a, c).
//
// Compiles with nvcc and, without __CUDACC__, with a host C++ compiler for
// the kernel's host emulation (ops/_build.py:build_host_emulation).

#pragma once

#include "euler2d.cuh"

namespace {

// physics scalars in the kernel's type, rounded once from the doubles the
// wrapper passes (p0, p1: u | zz, cc | gamma | grav, dry_tolerance | grav
// | 1 for the linear stress law | 1 for Burgers' entropy fix | umax |
// gamma, bx); the fields of the later systems come last, so the earlier
// ones keep their offsets
template <typename T> struct P1d {
  T u;              // advection speed
  T zz, cc, mcc;    // acoustic impedance, sound speed, -cc
  T z2;             // 2.0 * zz
  T gamma, g1;      // gamma, gamma - 1.0
  T g, hg, dry;     // grav, grav * 0.5 (= 0.5 * grav), dry_tolerance
  T umax;           // traffic: the top speed
  T bx, bxx;        // MHD: bx, and bx * bx (a Python product, rounded once)
  bool linear;      // p-system: the linear stress law
  bool efix;        // Burgers: the entropy fix
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
    umax = T(p0);
    bx = T(p1);
    bxx = T(p1 * p1);
    linear = p0 != 0.0;
    efix = p0 != 0.0;
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

// ---- shallow water 1D: q = (h, hu) -----------------------------------------
// A cell's u = hu/h, sqrt(h) and sqrt(g h) (the entropy fix's and HLLE's
// cell speed), each the expression the plain version computes at both of
// the cell's interfaces
template <bool EFIX> struct ShallowRoe1D {
  static constexpr int NEQ = 2, NW = 2, NAUX = 0;
  enum { C_U = 0, C_SH = 1, C_C = 2 };
  static constexpr int NC = EFIX ? 3 : 2;
  template <typename T>
  static HD void cell(const P1d<T>& P, const T q[2], T c[]) {
    c[C_U] = q[1] / q[0];
    c[C_SH] = sqrt_(q[0]);
    if constexpr (EFIX) c[C_C] = sqrt_(P.g * q[0]);
  }
  template <typename T>
  static HD void rp(const P1d<T>& P, const T ql[2], const T qr[2],
                    const T cl[], const T cr[], T w[2][2], T s[2], T am[2],
                    T ap[2]) {
    const T sh_l = cl[C_SH], sh_r = cr[C_SH];
    const T u = (sh_l * cl[C_U] + sh_r * cr[C_U]) / (sh_l + sh_r);
    const T c = sqrt_(P.hg * (ql[0] + qr[0]));
    const T d0 = qr[0] - ql[0], d1 = qr[1] - ql[1];
    const T a1 = T(0.5) * ((u + c) * d0 - d1) / c;
    const T a2 = T(0.5) * (-(u - c) * d0 + d1) / c;
    w[0][0] = a1;
    w[0][1] = a1 * (u - c);
    w[1][0] = a2;
    w[1][1] = a2 * (u + c);
    s[0] = u - c;
    s[1] = u + c;
    if (!EFIX) {
      for (int e = 0; e < 2; ++e) {
        am[e] = mn(s[0], T(0)) * w[0][e] + mn(s[1], T(0)) * w[1][e];
        ap[e] = mx(s[0], T(0)) * w[0][e] + mx(s[1], T(0)) * w[1][e];
      }
      return;
    }
    // Harten entropy fix, at the state between the waves
    const T hm = ql[0] + a1;
    const T hum = ql[1] + a1 * (u - c);
    const T um = hum / (hm <= T(0) ? T(1) : hm);
    const T cm = sqrt_(P.g * mx(hm, T(0)));
    const T lam1_l = cl[C_U] - cl[C_C], lam1_m = um - cm;
    const bool trans1 = lam1_l < T(0) && lam1_m > T(0);
    const T den1 = lam1_m - lam1_l == T(0) ? T(1) : lam1_m - lam1_l;
    const T sf1 = trans1 ? lam1_l * (lam1_m - s[0]) / den1
                         : mn(s[0], T(0));
    const T lam2_m = um + cm, lam2_r = cr[C_U] + cr[C_C];
    const bool trans2 = lam2_m < T(0) && lam2_r > T(0);
    const T den2 = lam2_r - lam2_m == T(0) ? T(1) : lam2_r - lam2_m;
    const T sf2 = trans2 ? lam2_m * (lam2_r - s[1]) / den2
                         : mn(s[1], T(0));
    for (int e = 0; e < 2; ++e) {
      am[e] = sf1 * w[0][e] + sf2 * w[1][e];
      ap[e] = (s[0] * w[0][e] + s[1] * w[1][e]) - am[e];
    }
  }
};

struct ShallowHlle1D {
  static constexpr int NEQ = 2, NW = 2, NAUX = 0;
  // u, sqrt(h), sqrt(g h) and the momentum flux h u u + g/2 h h
  enum { C_U = 0, C_SH = 1, C_C = 2, C_F = 3 };
  static constexpr int NC = 4;
  template <typename T>
  static HD void cell(const P1d<T>& P, const T q[2], T c[]) {
    const T u = q[1] / q[0];
    c[C_U] = u;
    c[C_SH] = sqrt_(q[0]);
    c[C_C] = sqrt_(P.g * q[0]);
    c[C_F] = q[0] * u * u + P.hg * q[0] * q[0];
  }
  template <typename T>
  static HD void rp(const P1d<T>& P, const T ql[2], const T qr[2],
                    const T cl[], const T cr[], T w[2][2], T s[2], T am[2],
                    T ap[2]) {
    const T sh_l = cl[C_SH], sh_r = cr[C_SH];
    const T u = (sh_l * cl[C_U] + sh_r * cr[C_U]) / (sh_l + sh_r);
    const T c = sqrt_(P.hg * (ql[0] + qr[0]));
    const T s1 = mn(u - c, cl[C_U] - cl[C_C]);
    const T s2 = mx(u + c, cr[C_U] + cr[C_C]);
    const T f_l[2] = {ql[1], cl[C_F]}, f_r[2] = {qr[1], cr[C_F]};
    const T ds = s2 - s1;
    const T denom = ds == T(0) ? T(1) : ds;
    s[0] = s1;
    s[1] = s2;
    for (int e = 0; e < 2; ++e) {
      const T q_m = (s2 * qr[e] - s1 * ql[e] - (f_r[e] - f_l[e])) / denom;
      w[0][e] = q_m - ql[e];
      w[1][e] = qr[e] - q_m;
    }
    for (int e = 0; e < 2; ++e) {
      am[e] = mn(s1, T(0)) * w[0][e] + mn(s2, T(0)) * w[1][e];
      ap[e] = mx(s1, T(0)) * w[0][e] + mx(s2, T(0)) * w[1][e];
    }
  }
};

// aux[0] = b; f-wave form: the flux jump with the topography term
// g hbar (b_r - b_l), split at the Einfeldt speeds; each f-wave goes whole
// to the side its speed's sign (s < 0 left, s >= 0 right) names
struct ShallowBathyFwave1D {
  static constexpr int NEQ = 2, NW = 2, NAUX = 1;
  // u, sqrt(h), sqrt(g h) and the momentum flux hu u + g/2 h h
  enum { C_U = 0, C_SH = 1, C_C = 2, C_F = 3 };
  static constexpr int NC = 4;
  template <typename T>
  static HD void cell(const P1d<T>& P, const T q[2], const T*, T c[]) {
    const T u = q[1] / q[0];
    c[C_U] = u;
    c[C_SH] = sqrt_(q[0]);
    c[C_C] = sqrt_(P.g * q[0]);
    c[C_F] = q[1] * u + P.hg * q[0] * q[0];
  }
  template <typename T>
  static HD void rp(const P1d<T>& P, const T ql[2], const T qr[2],
                    const T al[], const T ar[], const T cl[], const T cr[],
                    T w[2][2], T s[2], T am[2], T ap[2]) {
    const T h_l = ql[0], h_r = qr[0];
    const T sh_l = cl[C_SH], sh_r = cr[C_SH];
    const T u = (sh_l * cl[C_U] + sh_r * cr[C_U]) / (sh_l + sh_r);
    const T c = sqrt_(P.hg * (h_l + h_r));
    const T s1 = mn(u - c, cl[C_U] - cl[C_C]);
    const T s2 = mx(u + c, cr[C_U] + cr[C_C]);
    const T hbar = T(0.5) * (h_l + h_r);
    const T fd1 = qr[1] - ql[1];
    const T fd2 = (cr[C_F] - cl[C_F]) + P.g * hbar * (ar[0] - al[0]);
    const T ds = s2 - s1;
    const T denom = ds == T(0) ? T(1) : ds;
    const T beta1 = (s2 * fd1 - fd2) / denom;
    const T beta2 = (fd2 - s1 * fd1) / denom;
    w[0][0] = beta1;
    w[0][1] = beta1 * s1;
    w[1][0] = beta2;
    w[1][1] = beta2 * s2;
    s[0] = s1;
    s[1] = s2;
    for (int e = 0; e < 2; ++e) {
      am[e] = (s1 < T(0) ? w[0][e] : T(0)) + (s2 < T(0) ? w[1][e] : T(0));
      ap[e] = (s1 >= T(0) ? w[0][e] : T(0)) + (s2 >= T(0) ? w[1][e] : T(0));
    }
  }
};

// ---- psystem_1D: q = (eps, rho u), aux = (rho, K); f-waves -----------------
// A cell's u, sigma, impedance z = sqrt(rho sigma') and sound speed
// c = sqrt(sigma' / rho) (one exp a cell in the "exp" law; the plain
// version computes the same expressions at both interfaces).  exp is the
// device library's (expf in float32), as torch.exp on the card.
struct Psystem1D {
  static constexpr int NEQ = 2, NW = 2, NAUX = 2;
  enum { C_U = 0, C_SIG = 1, C_Z = 2, C_C = 3 };
  static constexpr int NC = 4;
  template <typename T>
  static HD void cell(const P1d<T>& P, const T q[2], const T a[], T c[]) {
    const T rho = a[0], K = a[1];
    c[C_U] = q[1] / rho;
    T sigp;
    if (P.linear) {
      c[C_SIG] = K * q[0];
      sigp = K;
    } else {
      const T e = exp_(K * q[0]);
      c[C_SIG] = e - T(1);
      sigp = K * e;
    }
    c[C_Z] = sqrt_(rho * sigp);
    c[C_C] = sqrt_(sigp / rho);
  }
  template <typename T>
  static HD void rp(const P1d<T>&, const T*, const T*, const T*, const T*,
                    const T cl[], const T cr[], T w[2][2], T s[2], T am[2],
                    T ap[2]) {
    const T z_l = cl[C_Z], z_r = cr[C_Z];
    const T df1 = -(cr[C_U] - cl[C_U]);
    const T df2 = -(cr[C_SIG] - cl[C_SIG]);
    const T denom = z_l + z_r;
    const T b1 = (df2 + z_r * df1) / denom;
    const T b2 = (z_l * df1 - df2) / denom;
    w[0][0] = b1;
    w[0][1] = b1 * z_l;
    w[1][0] = b2;
    w[1][1] = -b2 * z_r;
    s[0] = -cl[C_C];
    s[1] = cr[C_C];
    for (int e = 0; e < 2; ++e) {
      am[e] = w[0][e];
      ap[e] = w[1][e];
    }
  }
};

// ---- vc_advection_1D: the color equation, aux[0] = the velocity at each
// cell's lower edge; the interface reads the right cell's ----------------
struct VcAdvection1D {
  static constexpr int NEQ = 1, NW = 1, NC = 0, NAUX = 1;
  template <typename T>
  static HD void cell(const P1d<T>&, const T*, const T*, T*) {}
  template <typename T>
  static HD void rp(const P1d<T>&, const T ql[1], const T qr[1], const T*,
                    const T ar[], const T*, const T*, T w[1][1], T s[1],
                    T am[1], T ap[1]) {
    const T u = ar[0];
    const T dq = qr[0] - ql[0];
    w[0][0] = dq;
    s[0] = u;
    am[0] = mn(u, T(0)) * dq;
    ap[0] = mx(u, T(0)) * dq;
  }
};

// ---- vc_advection_fwave_1D: q_t + (u q)_x = 0, aux[0] = the cell's
// velocity; the f-wave u_r q_r - u_l q_l goes whole to the side of the
// average speed's sign ---------------------------------------------------
struct VcAdvectionFwave1D {
  static constexpr int NEQ = 1, NW = 1, NC = 1, NAUX = 1;
  template <typename T>
  static HD void cell(const P1d<T>&, const T q[1], const T a[], T c[]) {
    c[0] = a[0] * q[0];          // the cell's flux u q
  }
  template <typename T>
  static HD void rp(const P1d<T>&, const T*, const T*, const T al[],
                    const T ar[], const T cl[], const T cr[], T w[1][1],
                    T s[1], T am[1], T ap[1]) {
    const T z = cr[0] - cl[0];
    const T sp = T(0.5) * (al[0] + ar[0]);
    w[0][0] = z;
    s[0] = sp;
    am[0] = sp < T(0) ? z : T(0);
    ap[0] = sp >= T(0) ? z : T(0);
  }
};

// ---- acoustics_variable_1D: q = (p, u), aux = (Z, c) -----------------------
struct AcousticsVar1D {
  static constexpr int NEQ = 2, NW = 2, NC = 0, NAUX = 2;
  template <typename T>
  static HD void cell(const P1d<T>&, const T*, const T*, T*) {}
  template <typename T>
  static HD void rp(const P1d<T>&, const T ql[2], const T qr[2],
                    const T al[], const T ar[], const T*, const T*,
                    T w[2][2], T s[2], T am[2], T ap[2]) {
    const T z_l = al[0], c_l = al[1], z_r = ar[0], c_r = ar[1];
    const T d0 = qr[0] - ql[0], d1 = qr[1] - ql[1];
    const T denom = z_l + z_r;
    const T a1 = (-d0 + z_r * d1) / denom;
    const T a2 = (d0 + z_l * d1) / denom;
    w[0][0] = -a1 * z_l;
    w[0][1] = a1;
    w[1][0] = a2 * z_r;
    w[1][1] = a2;
    s[0] = -c_l;
    s[1] = c_r;
    for (int e = 0; e < 2; ++e) {
      am[e] = -c_l * w[0][e];
      ap[e] = c_r * w[1][e];
    }
  }
};

// ---- burgers_1D: one wave at the Roe speed; the entropy fix (P.efix)
// replaces the fluctuations of a transonic rarefaction (q_l < 0 < q_r) ----
struct Burgers1D {
  static constexpr int NEQ = 1, NW = 1, NC = 0, NAUX = 0;
  template <typename T>
  static HD void cell(const P1d<T>&, const T*, T*) {}
  template <typename T>
  static HD void rp(const P1d<T>& P, const T ql[1], const T qr[1], const T*,
                    const T*, T w[1][1], T s[1], T am[1], T ap[1]) {
    const T dq = qr[0] - ql[0];
    const T sp = T(0.5) * (ql[0] + qr[0]);
    w[0][0] = dq;
    s[0] = sp;
    am[0] = mn(sp, T(0)) * dq;
    ap[0] = mx(sp, T(0)) * dq;
    if (P.efix && ql[0] < T(0) && qr[0] > T(0)) {
      am[0] = T(-0.5) * ql[0] * ql[0];
      ap[0] = T(0.5) * qr[0] * qr[0];
    }
  }
};

// ---- traffic_1D: f = umax q (1 - q); the flux difference goes to the side
// of the Roe speed's sign, a transonic rarefaction (q_l > 1/2 > q_r) splits
// at the sonic point ---------------------------------------------------------
struct Traffic1D {
  static constexpr int NEQ = 1, NW = 1, NC = 1, NAUX = 0;
  template <typename T>
  static HD void cell(const P1d<T>& P, const T q[1], T c[]) {
    c[0] = P.umax * q[0] * (T(1) - q[0]);
  }
  template <typename T>
  static HD void rp(const P1d<T>& P, const T ql[1], const T qr[1],
                    const T cl[], const T cr[], T w[1][1], T s[1], T am[1],
                    T ap[1]) {
    const T sp = P.umax * (T(1) - (ql[0] + qr[0]));
    const T df = cr[0] - cl[0];
    w[0][0] = qr[0] - ql[0];
    s[0] = sp;
    am[0] = sp < T(0) ? df : T(0);
    ap[0] = sp >= T(0) ? df : T(0);
    if (ql[0] > T(0.5) && qr[0] < T(0.5)) {
      const T f_sonic = P.umax * T(0.5) * (T(1) - T(0.5));
      am[0] = f_sonic - cl[0];
      ap[0] = cr[0] - f_sonic;
    }
  }
};

// ---- mhd_1D: q = (rho, rho u, rho v, rho w, By, Bz, E), Bx = P.bx ----------
// Two HLL waves at the Davis bounds of the fast magnetosonic speed.  A
// cell's flux (7), u and fast speed come from cell(): the plain version's
// _mhd_flux and _fast_speed, operation for operation.
struct Mhd1D {
  static constexpr int NEQ = 7, NW = 2, NAUX = 0;
  enum { C_F = 0, C_U = 7, C_CF = 8 };
  static constexpr int NC = 9;
  // the f64 instances stage about 75 KB a block: over the 48 KB a launch
  // takes without the opt-in attribute (step1.cu: launch)
  static constexpr bool SMEM_OPT_IN = true;
  template <typename T>
  static HD void cell(const P1d<T>& P, const T q[7], T c[]) {
    const T rho = q[0];
    const T u = q[1] / rho, v = q[2] / rho, w = q[3] / rho;
    const T by = q[4], bz = q[5], E = q[6];
    const T b2 = P.bxx + by * by + bz * bz;
    const T ke = T(0.5) * rho * (u * u + v * v + w * w);
    const T p = P.g1 * (E - ke - T(0.5) * b2);
    const T pt = p + T(0.5) * b2;
    c[C_F + 0] = q[1];
    c[C_F + 1] = q[1] * u + pt - P.bxx;
    c[C_F + 2] = q[2] * u - P.bx * by;
    c[C_F + 3] = q[3] * u - P.bx * bz;
    c[C_F + 4] = by * u - P.bx * v;
    c[C_F + 5] = bz * u - P.bx * w;
    c[C_F + 6] = (E + pt) * u - P.bx * (u * P.bx + v * by + w * bz);
    c[C_U] = q[1] / q[0];
    // the fast speed (_fast_speed); bx * bx / rho is PyTorch's
    // float / tensor, a reciprocal times the float
    const T a2 = P.gamma * p / rho;
    const T b2r = (P.bxx + q[4] * q[4] + q[5] * q[5]) / rho;
    const T bx2r = (T(1) / rho) * P.bxx;
    const T sum = a2 + b2r;
    const T disc = sqrt_(mx(sum * sum - T(4) * a2 * bx2r, T(0)));
    c[C_CF] = sqrt_(T(0.5) * (sum + disc));
  }
  template <typename T>
  static HD void rp(const P1d<T>&, const T ql[7], const T qr[7],
                    const T cl[], const T cr[], T w[2][7], T s[2], T am[7],
                    T ap[7]) {
    const T s_l = mn(cl[C_U] - cl[C_CF], cr[C_U] - cr[C_CF]);
    const T s_r = mx(cl[C_U] + cl[C_CF], cr[C_U] + cr[C_CF]);
    const T den = s_r - s_l;
    s[0] = s_l;
    s[1] = s_r;
    for (int e = 0; e < 7; ++e) {
      const T q_m = (s_r * qr[e] - s_l * ql[e] - (cr[C_F + e] - cl[C_F + e]))
                    / den;
      w[0][e] = q_m - ql[e];
      w[1][e] = qr[e] - q_m;
    }
    for (int e = 0; e < 7; ++e) {
      am[e] = mn(s_l, T(0)) * w[0][e] + mn(s_r, T(0)) * w[1][e];
      ap[e] = mx(s_l, T(0)) * w[0][e] + mx(s_r, T(0)) * w[1][e];
    }
  }
};

}  // namespace
