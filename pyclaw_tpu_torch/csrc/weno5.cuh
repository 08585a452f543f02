// weno5.cuh — Jiang-Shu WENO5 edge values of one five-value stencil, shared
// by dq2_weno5.cu and weno5.cu: pyclaw_tpu_torch/limiters/recon.py
// weno5_stencil, operation for operation, with its float32/float64 branch
// as an overload.  weno5.cu computes the betas and candidate values of
// consecutive stencils itself (sharing their common terms) and calls the
// weights part alone.
//
// Compiles with nvcc and, without __CUDACC__, with a host C++ compiler for
// the kernels' host emulation (ops/_build.py:build_host_emulation).

#pragma once

#include "euler2d.cuh"

namespace {

// ---- WENO5 edge values (limiters/recon.py:weno5_stencil) ---------------
template <typename T>
HD void weno5_betas_polys(T vm2, T vm1, T v0, T vp1, T vp2, T b[3], T p[3],
                          T m[3]) {
  const T c1312 = T(13.0 / 12.0);
  T d;
  d = vm2 - T(2) * vm1 + v0;
  T e = vm2 - T(4) * vm1 + T(3) * v0;
  b[0] = c1312 * (d * d) + T(0.25) * (e * e);
  d = vm1 - T(2) * v0 + vp1;
  e = vm1 - vp1;
  b[1] = c1312 * (d * d) + T(0.25) * (e * e);
  d = v0 - T(2) * vp1 + vp2;
  e = T(3) * v0 - T(4) * vp1 + vp2;
  b[2] = c1312 * (d * d) + T(0.25) * (e * e);

  p[0] = (T(2) * vm2 - T(7) * vm1 + T(11) * v0) / T(6);
  p[1] = (-vm1 + T(5) * v0 + T(2) * vp1) / T(6);
  p[2] = (T(2) * v0 + T(5) * vp1 - vp2) / T(6);
  m[0] = (-vm2 + T(5) * vm1 + T(2) * v0) / T(6);
  m[1] = (T(2) * vm1 + T(5) * v0 - vp1) / T(6);
  m[2] = (T(11) * v0 - T(7) * vp1 + T(2) * vp2) / T(6);
}

// The weights of a stencil's betas (weno5_w) and the edge values they
// give its candidate values (weno5_apply).
template <typename T> struct Weno5W;

// float64: the reference weights d_k / (EPWENO + beta_k)^2
template <> struct Weno5W<double> { double a0, a1, a2, c0, c1, c2; };
HD Weno5W<double> weno5_w(const double b[3]) {
  const double EPWENO = 1e-36;
  double t;
  t = EPWENO + b[0];
  const double ib0 = 1.0 / (t * t);
  t = EPWENO + b[1];
  const double ib1 = 1.0 / (t * t);
  t = EPWENO + b[2];
  const double ib2 = 1.0 / (t * t);
  return {0.1 * ib0, 0.6 * ib1, 0.3 * ib2, 0.3 * ib0, 0.6 * ib1, 0.1 * ib2};
}
// (ZQ: euler2d.cuh's qdiv)
template <bool ZQ = false>
HD void weno5_apply(const Weno5W<double>& w, const double p[3],
                    const double m[3], double& ql, double& qr) {
  qr = qdiv<ZQ>(w.a0 * p[0] + w.a1 * p[1] + w.a2 * p[2],
                w.a0 + w.a1 + w.a2);
  ql = qdiv<ZQ>(w.c0 * m[0] + w.c1 * m[1] + w.c2 * m[2],
                w.c0 + w.c1 + w.c2);
}

// float32: normalised betas scaled by 1e3, one reciprocal for both edges
template <> struct Weno5W<float> { float a0, a1, a2, c0, c1, c2, fr, fl; };
HD Weno5W<float> weno5_w(const float b[3]) {
  const float r = 1e3f / (b[0] + b[1] + b[2] + 1e-30f);
  const float e0 = 1e-3f + b[0] * r;
  const float e1 = 1e-3f + b[1] * r;
  const float e2 = 1e-3f + b[2] * r;
  float t;
  t = e0 * e1;
  const float s01 = t * t;
  t = e0 * e2;
  const float s02 = t * t;
  t = e1 * e2;
  const float s12 = t * t;
  const float a0 = 0.1f * s12, a1 = 0.6f * s02, a2 = 0.3f * s01;
  const float c0 = 0.3f * s12, c1 = 0.6f * s02, c2 = 0.1f * s01;
  const float den_r = a0 + a1 + a2;
  const float den_l = c0 + c1 + c2;
  const float inv = 1.0f / (den_r * den_l);
  return {a0, a1, a2, c0, c1, c2, den_l * inv, den_r * inv};
}
template <bool ZQ = false>
HD void weno5_apply(const Weno5W<float>& w, const float p[3],
                    const float m[3], float& ql, float& qr) {
  qr = (w.a0 * p[0] + w.a1 * p[1] + w.a2 * p[2]) * w.fr;
  ql = (w.c0 * m[0] + w.c1 * m[1] + w.c2 * m[2]) * w.fl;
}

// the edge values of one stencil: its betas and candidate values, then the
// weights of its type
template <bool ZQ = false, typename T>
HD void weno5(T vm2, T vm1, T v0, T vp1, T vp2, T& ql, T& qr) {
  T b[3], p[3], m[3];
  weno5_betas_polys(vm2, vm1, v0, vp1, vp2, b, p, m);
  weno5_apply<ZQ>(weno5_w(b), p, m, ql, qr);
}

}  // namespace
