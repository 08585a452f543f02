// euler2d.cuh — device code shared by the 2D Euler kernels of this
// directory (step2_ctu.cu, dq2_weno5.cu): scalar helpers, NaN-propagating
// min/max, and the Roe solve of the 2D Euler 4-wave system
// (pyclaw_tpu_torch/riemann/euler.py: _alpha34, _roe_averages_soa,
// _rpn2_euler_soa), operation for operation.
//
// Compiles with nvcc and, without __CUDACC__, with a host C++ compiler
// for the kernels' host emulation (ops/_build.py:build_host_emulation).

#pragma once

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define HD __device__ __forceinline__
#else
#include <cmath>
#include <cstddef>
#include <vector>
#define HD inline
#endif

namespace {

// ---- scalar helpers -----------------------------------------------------
#if defined(__CUDACC__)
HD float rsqrt_(float x) { return rsqrtf(x); }
HD double rsqrt_(double x) { return rsqrt(x); }
HD float sqrt_(float x) { return sqrtf(x); }
HD double sqrt_(double x) { return sqrt(x); }
HD float pow_(float x, float y) { return powf(x, y); }
HD double pow_(double x, double y) { return pow(x, y); }
HD float fabs_(float x) { return fabsf(x); }
HD double fabs_(double x) { return fabs(x); }
HD float sin_(float x) { return sinf(x); }
HD double sin_(double x) { return sin(x); }
HD float cos_(float x) { return cosf(x); }
HD double cos_(double x) { return cos(x); }
HD float exp_(float x) { return expf(x); }
HD double exp_(double x) { return exp(x); }
#else
template <typename T> HD T rsqrt_(T x) { return T(1) / std::sqrt(x); }
template <typename T> HD T sqrt_(T x) { return std::sqrt(x); }
template <typename T> HD T pow_(T x, T y) { return std::pow(x, y); }
template <typename T> HD T fabs_(T x) { return std::fabs(x); }
template <typename T> HD T sin_(T x) { return std::sin(x); }
template <typename T> HD T cos_(T x) { return std::cos(x); }
template <typename T> HD T exp_(T x) { return std::exp(x); }
#endif

// the physics scalars of a system that takes none
template <typename T> struct NoPar {};

// NaN-propagating max/min (jnp.maximum / torch.maximum semantics)
template <typename T> HD T mx(T a, T b) { return (a != a || a > b) ? a : b; }
template <typename T> HD T mn(T a, T b) { return (a != a || a < b) ? a : b; }

// a / b, rounded as IEEE's division.  With ZQ (float64 only), a zero
// numerator over a finite nonzero denominator takes its signed zero from a
// product: the card's float64 division takes its slow path for every zero
// quotient, and a state with zero components (a tracer outside its
// bubble, a gas at rest) gives one in most cells.  Both go through
// rounding intrinsics; the quotient is the division's, bit for bit.  Used
// only where the quotient feeds no product or sum that FMA contraction
// could fuse otherwise than before: as a quotient of WENO5's weights
// (weno5.cuh) or of the positivity test (dq2_systems.cuh).  Where it feeds
// one (the flux's velocity, the tracer's Roe average), the card's build
// contracted differently and moved the bits.
template <bool ZQ> HD double qdiv(double a, double b) {
#if defined(__CUDACC__)
  if (ZQ) {
    if (a == 0.0 && b != 0.0 && fabs(b) <= 1.7976931348623157e308)
      return __dmul_rn(a, b);
    return __ddiv_rn(a, b);
  }
#endif
  return a / b;
}
template <bool ZQ> HD float qdiv(float a, float b) { return a / b; }

// riemann/euler.py:_alpha34 — the dtype branch is part of the contract
HD void alpha34(double g1, double a, double a2, double n3, double n4p,
                double& a3, double& a4) {
  a3 = g1 / a2 * n3;
  a4 = (n4p - a * a3) / (2.0 * a);
}
HD void alpha34(float g1, float a, float a2, float n3, float n4p,
                float& a3, float& a4) {
  float ia = rsqrt_(a2);
  a3 = g1 * (ia * ia) * n3;
  a4 = (n4p - a * a3) * (0.5f * ia);
}

// Roe averages and wave strengths at one interface between states ql, qr
// (components in equation order; IXY = 0 for an x-, 1 for a y-interface)
template <typename T> struct Roe {
  T u, v;         // Roe-averaged normal and transverse velocity
  T H, a2, a;     // enthalpy, sound speed squared, sound speed
  T a1, a3, a2w, a4;  // wave strengths
};

template <int IXY, typename T>
HD Roe<T> roe_2d(T g1, const T ql[4], const T qr[4]) {
  constexpr int mu = 1 + IXY, mv = 2 - IXY;
  Roe<T> rs;
  T irl = rsqrt_(ql[0]), irr = rsqrt_(qr[0]);
  T srl = ql[0] * irl, srr = qr[0] * irr;
  T rinv_l = irl * irl, rinv_r = irr * irr;
  T w = T(1) / (srl + srr);
  T u = (ql[mu] * irl + qr[mu] * irr) * w;
  T v = (ql[mv] * irl + qr[mv] * irr) * w;
  T ke_l = T(0.5) * (ql[mu] * ql[mu] + ql[mv] * ql[mv]) * rinv_l;
  T ke_r = T(0.5) * (qr[mu] * qr[mu] + qr[mv] * qr[mv]) * rinv_r;
  T p_l = g1 * (ql[3] - ke_l);
  T p_r = g1 * (qr[3] - ke_r);
  T H = (srl * ((ql[3] + p_l) * rinv_l) + srr * ((qr[3] + p_r) * rinv_r)) * w;
  T a2 = g1 * (H - T(0.5) * (u * u + v * v));
  T a = sqrt_(a2);

  T d0 = qr[0] - ql[0], dmu = qr[mu] - ql[mu], dmv = qr[mv] - ql[mv];
  T dE = qr[3] - ql[3];
  T euv = H - (u * u + v * v);
  alpha34(g1, a, a2, euv * d0 + u * dmu + v * dmv - dE, dmu + (a - u) * d0,
          rs.a3, rs.a4);
  rs.a2w = dmv - v * d0;
  rs.a1 = d0 - rs.a3 - rs.a4;
  rs.u = u;
  rs.v = v;
  rs.H = H;
  rs.a2 = a2;
  rs.a = a;
  return rs;
}

// waves (equation order) and speeds of rpn2 from the Roe data; the
// components that rpn2 leaves out (None) are zeros here
template <int IXY, typename T>
HD void roe_waves(const Roe<T>& rs, T w[4][4], T s[4]) {
  constexpr int mu = 1 + IXY, mv = 2 - IXY;
  const T u = rs.u, v = rs.v, H = rs.H, a = rs.a;
  const T a1 = rs.a1, a3 = rs.a3, a2w = rs.a2w, a4 = rs.a4;
  w[0][0] = a1; w[0][mu] = a1 * (u - a); w[0][mv] = a1 * v;
  w[0][3] = a1 * (H - u * a);
  w[1][0] = a3; w[1][mu] = a3 * u; w[1][mv] = a3 * v;
  w[1][3] = a3 * T(0.5) * (u * u + v * v);
  w[2][0] = T(0); w[2][mu] = T(0); w[2][mv] = a2w; w[2][3] = a2w * v;
  w[3][0] = a4; w[3][mu] = a4 * (u + a); w[3][mv] = a4 * v;
  w[3][3] = a4 * (H + u * a);
  s[0] = u - a; s[1] = u; s[2] = u; s[3] = u + a;
}

}  // namespace
