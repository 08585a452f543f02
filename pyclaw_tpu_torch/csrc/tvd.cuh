// tvd.cuh — the TVD wave limiters phi(theta, nu) of
// pyclaw_tpu_torch/limiters/tvd.py (_phi, _phi_cfl), operation for
// operation, shared by the classic kernels (step2_ctu.cu, step3_ctu.cu).

#pragma once

#include "euler2d.cuh"

namespace {

// TVD limiter phi(theta, nu): every id of limiters/tvd.py _phi and _phi_cfl
template <typename T> HD T phi_limiter(int lid, T t, T nu) {
  switch (lid) {
    case 0: return T(1);
    case 1: return mx(T(0), mn(T(1), t));
    case 2: return mx(T(0), mx(mn(T(1), T(2) * t), mn(T(2), t)));
    case 3: return (t + fabs_(t)) / (T(1) + fabs_(t));
    case 4: return mx(T(0), mn((T(1) + t) / T(2), mn(T(2), T(2) * t)));
    case 5: return t;
    case 6: return T(0.5) * (T(1) + t);
    case 7: return mx(T(0), (t * t + t) / (t * t + T(1)));
    case 8: return mx(T(0), T(2) * t / (t * t + T(1)));
    case 9: {
      T a = fabs_(t);
      T vl = (t + a) / (T(1) + a);
      return mx(vl, mn(T(1), T(2) * mx(T(0), t)));
    }
    case 16: return mx(T(0), mx(mn(T(1.5) * t, T(1)), mn(t, T(1.5))));
    case 19:
    case 20: {
      const double th = lid == 19 ? 1.0 : 0.95;
      T base = (T(2) + t) / T(3);
      return mx(T(0), mn(base, mx(T(-0.5 * th) * t,
                                  mn(T(2.0 * th) * t,
                                     mn(base, T(1.6 * th))))));
    }
    case 21: return mx(T(0), mn(T(2), T(2) * t));
    default: break;
  }
  // CFL-dependent ids (tvd.CFL_LIMITER_IDS)
  nu = mn(mx(nu, T(1e-8)), T(1.0 - 1e-8));
  T bound = mn(T(2) * t / nu, T(2) / (T(1) - nu));
  switch (lid) {
    case 10: return mx(T(0), mn(bound, T(1) + (T(1) + nu) / T(3) * (t - T(1))));
    case 11: return mx(T(0), mn(bound, T(1) + T(0.95) * (t - T(1))));
    case 12: return mx(T(0), mn(bound, T(1) + T(1.0) * (t - T(1))));
    case 13: return mx(T(0), mn(bound, T(1) + T(0.45) * (t - T(1))));
    case 14: return mx(T(0), bound);
    case 15: return mx(T(0), T(0.95) * bound);
    case 17:
      return mx(T(0), mn(bound, T(1) + T(0.5) * (T(1) + nu) * (t - T(1))));
    case 18:
      return mx(T(0), mn(bound, pow_(fabs_(t), (T(1) + nu) / T(3))));
    default: return T(1);  // unreachable: the wrappers check ids
  }
}

}  // namespace
