// sw_aug2d.cuh — the 2D augmented shallow-water system with wetting and
// drying of the generic CTU kernel (step2_aos.cu), operation for operation
// as in pyclaw_tpu_torch/riemann/shallow.py:
//   SwAug2D  _rpn2_sw_aug (with _sw_aug_core) + _rpt2_sw_aug
// q = (h, hu, hv), aux[0] = b; the f-wave form (the solver's fwave = True).
// The dry-state machinery is _sw_aug_core's, the same as SwAug1D's in
// systems1d.cuh (step1.cu), written here for the normal momentum of either
// direction; systems1d.cuh is left as it is, so step1.cu's instances keep
// their code.  Every branch is a select on a sign test of the plain
// version (h > dry, h + b <= b', the signs of the speeds), each operand
// rounded as there (the kernel is built without contractions).  The
// Python scalars fold as there: 0.5 * g and g * 0.5 once in double (hg),
// rounded to T where they meet a tensor.  The system gives step2_aos.cu
// the hooks of shallow2d.cuh: Par and make_par, prep (no per-cell
// quantities), nz, rpn and Trans.
//
// Compiles with nvcc and, without __CUDACC__, with a host C++ compiler
// for the kernel's host emulation (ops/_build.py:build_host_emulation).

#pragma once

#include "shallow2d.cuh"

namespace {

// _sw_aug_core of the interface between (h_l, hu_l, b_l) and (h_r, hu_r,
// b_r), hu the normal momentum: the speeds s1, s2, the (h, hu) parts of
// the two waves W1, W2, the Roe velocity and the wall flags
template <typename T> struct SwAugCore {
  T s1, s2, W1[2], W2[2], u_hat;
  bool wall_l, wall_r;
  HD SwAugCore(const Sw<T>& P, T h_l, T h_r, T hu_l, T hu_r, T b_l, T b_r) {
    const bool wet_l = h_l > P.dry, wet_r = h_r > P.dry;
    const T u_l0 = wet_l ? hu_l / h_l : T(0);
    const T u_r0 = wet_r ? hu_r / h_r : T(0);
    wall_r = !wet_r && wet_l && h_l + b_l <= b_r;
    wall_l = !wet_l && wet_r && h_r + b_r <= b_l;

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
    const T uh = (sh_l * u_le + sh_r * u_re) / wsum;
    const T c_hat = sqrt_(P.hg * (h_le + h_re));
    s1 = mn(u_le - c_l, uh - c_hat);
    s2 = mx(u_re + c_r, uh + c_hat);
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
    W1[0] = (s2 * dq1 - fd1) * zero;
    W1[1] = (s2 * dq2 - fd2) * zero;
    W2[0] = (fd1 - s1 * dq1) * zero;
    W2[1] = (fd2 - s1 * dq2) * zero;
    u_hat = bothdry ? T(0) : uh;
  }
};

// ---- sw_aug_2D (aux[0] = b) ---------------------------------------------
struct SwAug2D {
  static constexpr int NEQ = 3, NW = 3, NAUX = 1, NPC = 0;

  // the physics scalars in Args: (grav, dry_tolerance) as p0, p1
  template <typename T> using Par = Sw<T>;
  template <typename T> static Sw<T> make_par(double p0, double p1) {
    return ShallowHooks::make_par<T>(p0, p1);
  }

  template <typename T> static HD void prep(const Sw<T>&, const T*, T*) {}

  // the shear wave (p = 1) has the transverse momentum only
  template <int IXY> static HD constexpr bool nz(int p, int e) {
    return sw_nz<IXY>(p, e);
  }

  template <int IXY, typename T>
  static HD void rpn(const Sw<T>& P, const T ql[3], const T qr[3],
                     const T* al, const T* ar, const T*, const T*,
                     T w[3][3], T s[3], T am[3], T ap[3]) {
    constexpr int mu = 1 + IXY, mv = 2 - IXY;
    const T h_l = ql[0], h_r = qr[0];
    const bool wet_l = h_l > P.dry, wet_r = h_r > P.dry;
    const T v_l = wet_l ? ql[mv] / h_l : T(0);
    const T v_r = wet_r ? qr[mv] / h_r : T(0);
    const SwAugCore<T> c(P, h_l, h_r, ql[mu], qr[mu], al[0], ar[0]);
    const T s1 = c.s1, s2 = c.u_hat, s3 = c.s2;

    // the transverse momentum advects with the normal flow
    const T hu_le = (wet_l || c.wall_l) ? (c.wall_l ? -qr[mu] : ql[mu])
                                        : T(0);
    const T hu_re = (wet_r || c.wall_r) ? (c.wall_r ? -ql[mu] : qr[mu])
                                        : T(0);
    const T fd3 = hu_re * v_r - hu_le * v_l;

    // the f-waves (components h, normal and transverse momentum), zeroed
    // where either cell is dry (first order at fronts)
    T zv[3][3];
    zv[0][0] = s1 * c.W1[0]; zv[0][mu] = s1 * c.W1[1];
    zv[0][mv] = s1 * c.W1[0] * v_l;
    zv[2][0] = s3 * c.W2[0]; zv[2][mu] = s3 * c.W2[1];
    zv[2][mv] = s3 * c.W2[0] * v_r;
    zv[1][0] = T(0); zv[1][mu] = T(0);
    zv[1][mv] = fd3 - s1 * c.W1[0] * v_l - s3 * c.W2[0] * v_r;
    const bool frontal = !wet_l || !wet_r;
    for (int p = 0; p < 3; ++p)
      for (int e = 0; e < 3; ++e) w[p][e] = frontal ? T(0) : zv[p][e];
    s[0] = s1;
    s[1] = s2;
    s[2] = s3;

    T wv1[3], wv3[3];
    wv1[0] = c.W1[0]; wv1[mu] = c.W1[1]; wv1[mv] = c.W1[0] * v_l;
    wv3[0] = c.W2[0]; wv3[mu] = c.W2[1]; wv3[mv] = c.W2[0] * v_r;
    // no fluctuation into a dry wall cell
    for (int e = 0; e < 3; ++e) {
      const T m = mn(s1, T(0)) * wv1[e] + mn(s3, T(0)) * wv3[e]
                + (s2 < T(0) ? zv[1][e] : T(0));
      const T p = mx(s1, T(0)) * wv1[e] + mx(s3, T(0)) * wv3[e]
                + (s2 >= T(0) ? zv[1][e] : T(0));
      am[e] = c.wall_l ? T(0) : m;
      ap[e] = c.wall_r ? T(0) : p;
    }
  }

  // _rpt2_sw_aug: _rpt2_shallow_roe where both cells are wet, no split
  // elsewhere.  The Roe average divides by h and by c, as the plain
  // version does (shallow2d.cuh's RoeSw takes staged quantities and a
  // reciprocal of c instead).
  template <int IXY, typename T> struct Trans {
    bool wet;
    T u, v, c;
    HD Trans(const Sw<T>& P, const T ql[3], const T qr[3], const T*,
             const T*) {
      constexpr int mu = 1 + IXY, mv = 2 - IXY;
      wet = ql[0] > P.dry && qr[0] > P.dry;
      const T h_l = wet ? ql[0] : T(1), h_r = wet ? qr[0] : T(1);
      const T ul = wet ? ql[mu] : T(1), ur = wet ? qr[mu] : T(1);
      const T vl = wet ? ql[mv] : T(1), vr = wet ? qr[mv] : T(1);
      const T u_l = ul / h_l, u_r = ur / h_r;
      const T v_l = vl / h_l, v_r = vr / h_r;
      const T sh_l = sqrt_(h_l), sh_r = sqrt_(h_r);
      const T wgt = T(1) / (sh_l + sh_r);
      u = (sh_l * u_l + sh_r * u_r) * wgt;
      v = (sh_l * v_l + sh_r * v_r) * wgt;
      c = sqrt_(P.hg * (h_l + h_r));
    }
    HD void split(const T asdq[3], T bm[3], T bp[3]) const {
      constexpr int mu = 1 + IXY, mv = 2 - IXY;
      const T d0 = asdq[0], dmu = asdq[mu], dmv = asdq[mv];
      const T b1 = T(0.5) * ((v + c) * d0 - dmv) / c;
      const T b2 = dmu - u * d0;
      const T b3 = T(0.5) * (-(v - c) * d0 + dmv) / c;
      T w[3][3];
      w[0][0] = b1; w[0][mu] = b1 * u; w[0][mv] = b1 * (v - c);
      w[1][0] = T(0); w[1][mu] = b2; w[1][mv] = T(0);
      w[2][0] = b3; w[2][mu] = b3 * u; w[2][mv] = b3 * (v + c);
      const T sp[3] = {v - c, v, v + c};
      for (int e = 0; e < 3; ++e) {
        T m = T(0), p = T(0);
        for (int k = 0; k < 3; ++k) {
          m = m + mn(sp[k], T(0)) * w[k][e];
          p = p + mx(sp[k], T(0)) * w[k][e];
        }
        bm[e] = wet ? m : T(0);
        bp[e] = wet ? p : T(0);
      }
    }
  };
};

}  // namespace
