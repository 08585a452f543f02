// dt_coef.cuh — the step's dt in device memory, and the shared-memory
// attribute set once, for the kernels that take a dt (step1.cu,
// step2_ctu.cu, step2_aos.cu, dq2_weno5.cu, step3_ctu.cu, step3_aos.cu).
//
// A kernel takes dt as a `const double*`: the solver's device loop
// (pyclaw_tpu_torch/solver.py) replays its step as a CUDA graph, and a
// value passed by value would stay the one the graph captured.  The
// double holds dt rounded to the kernel's type, as the host passed it
// before.  Each block computes its coefficients of dt (dt/dx and the
// like) into shared memory in its first phase, threads 0 .. NCOEF-1 one
// each, with the expressions the host used before, so the bits do not
// change; the first barrier publishes them.  A thread of the first phase
// that needs dt reads it from the pointer itself.
//
// Compiles with nvcc and, without __CUDACC__, with a host C++ compiler
// for the kernels' host emulation (ops/_build.py:build_host_emulation).

#pragma once

#include "euler2d.cuh"

namespace {

// the two operands of a coefficient that picks one of three deltas
HD double pick3(const double v[3], int i) {
  return i == 0 ? v[0] : (i == 1 ? v[1] : v[2]);
}

// Coefficient k of dt of the 3D CTU steps (step3_ctu.cu, step3_aos.cu),
// as the plain version's Python doubles, rounded once to T:
//   0       dt
//   1..3    dt / dD              (dtd)
//   4..6    0.5 (dt / dD)        (half)
//   7..9    dt / (6 dD)          (co6)
//   10..18  dt^2 / (6 dD dE)     (co2, D-major)
enum { K3_DT = 0, K3_DTD = 1, K3_HALF = 4, K3_CO6 = 7, K3_CO2 = 10,
       NCOEF3 = 19 };

template <typename T> HD T coef3(double dt, const double dd[3], int k) {
  if (k == K3_DT) return T(dt);
  double num = dt, den;
  if (k < K3_CO6) {
    den = pick3(dd, (k - K3_DTD) % 3);
  } else if (k < K3_CO2) {
    den = 6.0 * pick3(dd, k - K3_CO6);
  } else {
    num = dt * dt;
    den = 6.0 * pick3(dd, (k - K3_CO2) / 3) * pick3(dd, (k - K3_CO2) % 3);
  }
  const double q = num / den;
  return T(k >= K3_HALF && k < K3_CO6 ? 0.5 * q : q);
}

#if defined(__CUDACC__)
// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) once per kernel
// instance and device: the attribute holds for the current device only,
// and a call that is not stream-ordered has no place in a captured
// graph.  `done` is the instance's own bit set of devices.
inline cudaError_t smem_attr_once(const void* fn, int bytes,
                                  unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}
#endif

}  // namespace
