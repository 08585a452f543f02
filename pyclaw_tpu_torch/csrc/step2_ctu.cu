// step2_ctu.cu — the whole 2D unsplit classic (CTU) step for the Euler
// 4-wave Roe solver, one launch per step, for Hopper (sm_90a).
//
// Replaces the TPU kernel pyclaw_tpu/ops/tiled2d.py:step2_pallas_rows
// (pallas_call at :301) with its SoA body classic/soa.py:step2_soa_roll.
// It computes what pyclaw_tpu/classic/soa.py:step2_soa computes; its plain
// PyTorch version is pyclaw_tpu_torch/classic/soa.py:step2_soa, which it is
// held against on the card (chip_smoke.py) and, through the host emulation
// at the end of this file, on the CPU (tests/test_torch_step2.py).
//
// What bounds it on the card: per cell it reads 4 values of q and writes 4
// (the least traffic: 32 B/cell in f32, 64 B in f64), but it does ~1.3k
// floating-point operations per cell (two Roe solves, the limiter, four
// transverse solves, the fold), among them divides, square roots and
// reciprocal square roots.  So it is bound by operations, not bytes: at
// 67 TFLOP/s (f32) or 34 TFLOP/s (f64) the operation bound is above the
// byte bound at 3.35 TB/s.  chip_smoke.py computes both bounds from the
// count in `FLOPS_PER_CELL` there.
//
// What the design does about it: no intermediate touches device memory.
// A block owns a TX x TY tile of output cells and stages q with a 2-cell
// halo in shared memory; the interface quantities (Roe data, fluctuations,
// correction fluxes, transverse terms) live in shared memory only, and
// each is computed once per block (the halo interfaces are recomputed by
// the neighbouring block, the price of independent blocks).  The TPU's
// workarounds are gone: no roll form, no 8-row over-fetch, no 128-lane
// padding.  Ragged edges are masked, so any (nx, ny) works.
//
// Phases (each a loop of the block's threads over a region, separated by
// barriers):
//   load    q tile + halo -> shared (indices clamped to the padded grid;
//           clamped cells only feed masked-out results)
//   roe<0>  x-interface Roe averages and wave strengths -> W
//   sweep<0> x-interface limiter, amdq/apdq, correction flux cq, and the
//           rpt2 split of the fluctuations -> OX; x-speed CFL partial max
//   roe<1>, sweep<1>: the same for y -> W (reused), OY
//   update  each cell gathers the transverse terms of its four neighbour
//           interfaces (no atomics: rpt2's scatter written as a gather),
//           folds them into Fx/Gy and applies the conservative update
//   reduce  tree max of the CFL partials; one value per block
//
// The arithmetic repeats the plain version operation for operation,
// including the float32/float64 branch of riemann/euler.py:_alpha34; the
// Roe solve and the scalar helpers live in euler2d.cuh, shared with
// dq2_weno5.cu, and the limiters in tvd.cuh, shared with step3_ctu.cu.

#include "euler2d.cuh"
#include "tvd.cuh"

namespace {

constexpr int NT = 256;  // threads per block

// ---- block geometry and shared-memory layout --------------------------
template <typename T, int TX, int TY> struct Tile {
  static constexpr int QR = TX + 4, QC = TY + 4;      // q tile + halo
  static constexpr int WXR = TX + 3, WXC = TY + 2;    // x Roe region
  static constexpr int WYR = TX + 2, WYC = TY + 3;    // y Roe region
  static constexpr int WN = WXR * WXC > WYR * WYC ? WXR * WXC : WYR * WYC;
  static constexpr int OXR = TX + 1, OXC = TY + 2;    // x-interface outputs
  static constexpr int OYR = TX + 2, OYC = TY + 1;    // y-interface outputs
  static constexpr int NWF = 9;    // u v H a2 a a1 a3 a2w a4
  static constexpr int NOF = 28;   // amdq apdq cq bm(am) bp(am) bm(ap) bp(ap)
  static constexpr int OXN = OXR * OXC, OYN = OYR * OYC;
  static constexpr size_t elems =
      4 * QR * QC + NWF * WN + NOF * OXN + NOF * OYN + 2 * NT;
  static constexpr size_t bytes = elems * sizeof(T);
};

// Field offsets inside an O array (times the region size)
enum { F_AM = 0, F_AP = 4, F_CQ = 8, F_T0 = 12, F_T1 = 16, F_T2 = 20,
       F_T3 = 24 };

template <typename T> struct Args {
  const T* qbc;
  T* qout;
  T* cflb;
  int NX, NY;           // padded (ghost-extended) extents
  T dtdx, dtdy, hdx, hdy, g1;
  int order, tw;
  int lim[4];
};

template <typename T, int TX, int TY> struct Block {
  using L = Tile<T, TX, TY>;
  T* q;    // [4][QR][QC]
  T* W;    // [NWF][WN]
  T* OX;   // [NOF][OXN]
  T* OY;   // [NOF][OYN]
  T* rx;   // [NT] x-speed partial max
  T* ry;   // [NT] y-speed partial max
  int I0, J0, bid;  // first interior cell of the tile (padded indices)

  HD void bind(T* s, int bx, int by, int nbx) {
    q = s;
    W = q + 4 * L::QR * L::QC;
    OX = W + L::NWF * L::WN;
    OY = OX + L::NOF * L::OXN;
    rx = OY + L::NOF * L::OYN;
    ry = rx + NT;
    I0 = 2 + by * TX;
    J0 = 2 + bx * TY;
    bid = by * nbx + bx;
  }
  HD T qs(int e, int r, int c) const { return q[(e * L::QR + r) * L::QC + c]; }
};

// ---- phase: stage q tile + halo ----------------------------------------
template <typename T, int TX, int TY>
HD void phase_load(const Args<T>& A, Block<T, TX, TY>& B, int tid) {
  using L = Tile<T, TX, TY>;
  for (int idx = tid; idx < 4 * L::QR * L::QC; idx += NT) {
    int e = idx / (L::QR * L::QC);
    int r = (idx / L::QC) % L::QR;
    int c = idx % L::QC;
    int I = B.I0 - 2 + r, J = B.J0 - 2 + c;
    I = I < A.NX ? I : A.NX - 1;
    J = J < A.NY ? J : A.NY - 1;
    B.q[idx] = A.qbc[((long long)e * A.NX + I) * A.NY + J];
  }
  B.rx[tid] = T(0);
  B.ry[tid] = T(0);
}

// ---- phase: Roe averages + wave strengths at one set of interfaces ------
template <int IXY, typename T, int TX, int TY>
HD void phase_roe(const Args<T>& A, Block<T, TX, TY>& B, int tid) {
  using L = Tile<T, TX, TY>;
  constexpr int R = IXY == 0 ? L::WXR : L::WYR;
  constexpr int C = IXY == 0 ? L::WXC : L::WYC;
  const T g1 = A.g1;
  for (int idx = tid; idx < R * C; idx += NT) {
    int r = idx / C, c = idx % C;
    // left cell: x (r, c+1), y (r+1, c); right cell (r+1, c+1)
    int lr = IXY == 0 ? r : r + 1, lc = IXY == 0 ? c + 1 : c;
    T ql[4], qr[4];
    for (int e = 0; e < 4; ++e) {
      ql[e] = B.qs(e, lr, lc);
      qr[e] = B.qs(e, r + 1, c + 1);
    }
    const Roe<T> rs = roe_2d<IXY>(g1, ql, qr);
    T* Wp = B.W + idx;
    Wp[0 * L::WN] = rs.u;
    Wp[1 * L::WN] = rs.v;
    Wp[2 * L::WN] = rs.H;
    Wp[3 * L::WN] = rs.a2;
    Wp[4 * L::WN] = rs.a;
    Wp[5 * L::WN] = rs.a1;
    Wp[6 * L::WN] = rs.a3;
    Wp[7 * L::WN] = rs.a2w;
    Wp[8 * L::WN] = rs.a4;
  }
}

// waves (equation order) and speeds of rpn2 from stored Roe data
template <int IXY, typename T, int WN>
HD void waves_at(const T* W, int idx, T w[4][4], T s[4]) {
  Roe<T> rs;
  rs.u = W[0 * WN + idx];
  rs.v = W[1 * WN + idx];
  rs.H = W[2 * WN + idx];
  rs.a2 = W[3 * WN + idx];
  rs.a = W[4 * WN + idx];
  rs.a1 = W[5 * WN + idx];
  rs.a3 = W[6 * WN + idx];
  rs.a2w = W[7 * WN + idx];
  rs.a4 = W[8 * WN + idx];
  roe_waves<IXY>(rs, w, s);
}

// rpt2_euler: split asdq into transverse down-going bm / up-going bp
template <int IXY, typename T>
HD void rpt2(T g1, T u, T v, T H, T a2, T a, const T asdq[4], T bm[4],
             T bp[4]) {
  constexpr int mu = 1 + IXY, mv = 2 - IXY;
  T d0 = asdq[0], dmu = asdq[mu], dmv = asdq[mv], dE = asdq[3];
  T euv = H - (u * u + v * v);
  T b3 = g1 / a2 * (euv * d0 + u * dmu + v * dmv - dE);
  T b2w = dmu - u * d0;
  T b4 = (dmv + (a - v) * d0 - a * b3) / (T(2) * a);
  T b1 = d0 - b3 - b4;
  T r[4][4];
  r[0][0] = b1; r[0][mu] = b1 * u; r[0][mv] = b1 * (v - a);
  r[0][3] = b1 * (H - v * a);
  r[1][0] = b3; r[1][mu] = b3 * u; r[1][mv] = b3 * v;
  r[1][3] = b3 * T(0.5) * (u * u + v * v);
  r[2][0] = T(0); r[2][mu] = b2w; r[2][mv] = T(0); r[2][3] = b2w * u;
  r[3][0] = b4; r[3][mu] = b4 * u; r[3][mv] = b4 * (v + a);
  r[3][3] = b4 * (H + v * a);
  T sp[4] = {v - a, v, v, v + a};
  for (int e = 0; e < 4; ++e) {
    T m = T(0), p = T(0);
    for (int k = 0; k < 4; ++k) {
      T bm_t = mn(sp[k], T(0)) * r[k][e];
      T bp_t = mx(sp[k], T(0)) * r[k][e];
      m = k == 0 ? bm_t : m + bm_t;
      p = k == 0 ? bp_t : p + bp_t;
    }
    bm[e] = m;
    bp[e] = p;
  }
}

// ---- phase: limiter, fluctuations, correction flux, transverse split ---
template <int IXY, typename T, int TX, int TY>
HD void phase_sweep(const Args<T>& A, Block<T, TX, TY>& B, int tid) {
  using L = Tile<T, TX, TY>;
  constexpr int R = IXY == 0 ? L::OXR : L::OYR;
  constexpr int C = IXY == 0 ? L::OXC : L::OYC;
  constexpr int WC = IXY == 0 ? L::WXC : L::WYC;
  constexpr int ON = R * C;
  T* O = IXY == 0 ? B.OX : B.OY;
  const T dtdx = IXY == 0 ? A.dtdx : A.dtdy;
  T smax = IXY == 0 ? B.rx[tid] : B.ry[tid];
  for (int idx = tid; idx < ON; idx += NT) {
    int r = idx / C, c = idx % C;
    // own interface and its lower/upper neighbours along the sweep axis
    int own = IXY == 0 ? (r + 1) * WC + c : r * WC + c + 1;
    int lo = r * WC + c;
    int hi = IXY == 0 ? (r + 2) * WC + c : r * WC + c + 2;
    T w[4][4], s[4];
    waves_at<IXY, T, L::WN>(B.W, own, w, s);

    T phi[4] = {T(1), T(1), T(1), T(1)};
    if (A.order == 2) {
      T wn[4][4], sn[4], dl[4], dr[4];
      waves_at<IXY, T, L::WN>(B.W, lo, wn, sn);
      for (int p = 0; p < 4; ++p) {
        T d = wn[p][0] * w[p][0];
        for (int e = 1; e < 4; ++e) d = d + wn[p][e] * w[p][e];
        dl[p] = d;
      }
      waves_at<IXY, T, L::WN>(B.W, hi, wn, sn);
      for (int p = 0; p < 4; ++p) {
        T d = w[p][0] * wn[p][0];
        for (int e = 1; e < 4; ++e) d = d + w[p][e] * wn[p][e];
        dr[p] = d;
      }
      for (int p = 0; p < 4; ++p) {
        int lid = A.lim[p];
        if (lid == 0) continue;
        T wn2 = w[p][0] * w[p][0];
        for (int e = 1; e < 4; ++e) wn2 = wn2 + w[p][e] * w[p][e];
        T dotu = s[p] > T(0) ? dl[p] : dr[p];
        bool safe = wn2 > T(0);
        T theta = safe ? dotu / wn2 : T(0);
        T ph = phi_limiter<T>(lid, theta, fabs_(s[p]) * dtdx);
        phi[p] = safe ? ph : T(1);
      }
    }

    T am[4], ap[4], cq[4];
    for (int e = 0; e < 4; ++e) {
      T m = T(0), pp = T(0), cc = T(0);
      for (int p = 0; p < 4; ++p) {
        T am_t = mn(s[p], T(0)) * w[p][e];
        T ap_t = mx(s[p], T(0)) * w[p][e];
        m = p == 0 ? am_t : m + am_t;
        pp = p == 0 ? ap_t : pp + ap_t;
        if (A.order == 2) {
          T absp = fabs_(s[p]);
          T coef = T(0.5) * absp * (T(1) - absp * dtdx);
          T c_t = coef * phi[p] * w[p][e];
          cc = p == 0 ? c_t : cc + c_t;
        }
      }
      am[e] = m;
      ap[e] = pp;
      cq[e] = cc;
      O[(F_AM + e) * ON + idx] = m;
      O[(F_AP + e) * ON + idx] = pp;
      O[(F_CQ + e) * ON + idx] = cc;
    }

    if (A.tw > 0) {
      T amt[4], apt[4];
      bool both = A.tw >= 2 && A.order == 2;
      for (int e = 0; e < 4; ++e) {
        amt[e] = both ? am[e] + cq[e] : am[e];
        apt[e] = both ? ap[e] - cq[e] : ap[e];
      }
      T u = B.W[0 * L::WN + own], v = B.W[1 * L::WN + own];
      T H = B.W[2 * L::WN + own], a2 = B.W[3 * L::WN + own];
      T a = B.W[4 * L::WN + own];
      T bm[4], bp[4];
      rpt2<IXY, T>(A.g1, u, v, H, a2, a, amt, bm, bp);
      for (int e = 0; e < 4; ++e) {
        O[(F_T0 + e) * ON + idx] = bm[e];
        O[(F_T1 + e) * ON + idx] = bp[e];
      }
      rpt2<IXY, T>(A.g1, u, v, H, a2, a, apt, bm, bp);
      for (int e = 0; e < 4; ++e) {
        O[(F_T2 + e) * ON + idx] = bm[e];
        O[(F_T3 + e) * ON + idx] = bp[e];
      }
    }

    // CFL window: interfaces touching the interior (soa.py slx / sly)
    bool in_cfl;
    if (IXY == 0) {   // x-interface k = I0-1+r, column J = J0-1+c
      int k = B.I0 - 1 + r, J = B.J0 - 1 + c;
      in_cfl = k < A.NX - 2 && c >= 1 && c <= TY && J < A.NY - 2;
    } else {          // y-interface row i = I0-1+r, j = J0-1+c
      int i = B.I0 - 1 + r, j = B.J0 - 1 + c;
      in_cfl = r >= 1 && r <= TX && i < A.NX - 2 && j < A.NY - 2;
    }
    if (in_cfl) {
      for (int p = 0; p < 4; ++p) smax = mx(smax, fabs_(s[p]));
    }
  }
  if (IXY == 0) B.rx[tid] = smax; else B.ry[tid] = smax;
}

// ---- phase: transverse fold (gather) + conservative update ------------
template <typename T, int TX, int TY>
HD void phase_update(const Args<T>& A, Block<T, TX, TY>& B, int tid) {
  using L = Tile<T, TX, TY>;
  constexpr int OXC = L::OXC, OYC = L::OYC, OXN = L::OXN, OYN = L::OYN;
  const T* X = B.OX;
  const T* Y = B.OY;
  const int nx = A.NX - 4, ny = A.NY - 4;
  for (int idx = tid; idx < TX * TY; idx += NT) {
    int ti = idx / TY, tj = idx % TY;
    int I = B.I0 + ti, J = B.J0 + tj;
    if (I >= A.NX - 2 || J >= A.NY - 2) continue;
    for (int e = 0; e < 4; ++e) {
      // Fx at x-interfaces k = I-1 (OX row ti) and k = I (row ti+1),
      // column J (OX/OY col tj+1); y terms from OY rows rk, rk+1
      T F[2];
      for (int h = 0; h < 2; ++h) {
        int rk = ti + h;
        T f = X[(F_CQ + e) * OXN + rk * OXC + tj + 1];
        if (A.tw > 0) {
          int cJ = tj + 1;
          f = f - A.hdy * (Y[(F_T0 + e) * OYN + (rk + 1) * OYC + cJ]
                           + Y[(F_T1 + e) * OYN + rk * OYC + cJ])
                - A.hdy * (Y[(F_T2 + e) * OYN + (rk + 1) * OYC + cJ - 1]
                           + Y[(F_T3 + e) * OYN + rk * OYC + cJ - 1]);
        }
        F[h] = f;
      }
      // Gy at y-interfaces j = J-1 (OY col tj) and j = J (col tj+1),
      // row I (OY row ti+1); x terms from OX rows ti, ti+1
      T G[2];
      for (int h = 0; h < 2; ++h) {
        int cj = tj + h;
        T gy = Y[(F_CQ + e) * OYN + (ti + 1) * OYC + cj];
        if (A.tw > 0) {
          gy = gy - A.hdx * (X[(F_T0 + e) * OXN + (ti + 1) * OXC + cj + 1]
                             + X[(F_T1 + e) * OXN + (ti + 1) * OXC + cj])
                  - A.hdx * (X[(F_T2 + e) * OXN + ti * OXC + cj + 1]
                             + X[(F_T3 + e) * OXN + ti * OXC + cj]);
        }
        G[h] = gy;
      }
      T apx = X[(F_AP + e) * OXN + ti * OXC + tj + 1];
      T amx = X[(F_AM + e) * OXN + (ti + 1) * OXC + tj + 1];
      T apy = Y[(F_AP + e) * OYN + (ti + 1) * OYC + tj];
      T amy = Y[(F_AM + e) * OYN + (ti + 1) * OYC + tj + 1];
      T dq = (apx + amx + F[1] - F[0]) * A.dtdx
           + (apy + amy + G[1] - G[0]) * A.dtdy;
      A.qout[((long long)e * nx + (I - 2)) * ny + (J - 2)] =
          B.qs(e, ti + 2, tj + 2) - dq;
    }
  }
}

template <typename T, int TX, int TY>
HD void phase_reduce(Block<T, TX, TY>& B, int tid, int stride) {
  if (tid < stride) {
    B.rx[tid] = mx(B.rx[tid], B.rx[tid + stride]);
    B.ry[tid] = mx(B.ry[tid], B.ry[tid + stride]);
  }
}

template <typename T, int TX, int TY>
HD void phase_write_cfl(const Args<T>& A, Block<T, TX, TY>& B, int tid) {
  if (tid == 0) A.cflb[B.bid] = mx(A.dtdx * B.rx[0], A.dtdy * B.ry[0]);
}

// Tile shape per type: 16x16 cells in f32 (87 KB of shared memory,
// two blocks per SM), 8x16 in f64 (96 KB, two blocks per SM).
template <typename T> struct Shape;
template <> struct Shape<float> { static constexpr int TX = 16, TY = 16; };
template <> struct Shape<double> { static constexpr int TX = 8, TY = 16; };

template <typename T>
Args<T> make_args(const void* qbc, void* qout, void* cflb, int nxg, int nyg,
                  double dt, double dx, double dy, double g1, int order,
                  int tw, const int* lim) {
  Args<T> A;
  A.qbc = static_cast<const T*>(qbc);
  A.qout = static_cast<T*>(qout);
  A.cflb = static_cast<T*>(cflb);
  A.NX = nxg;
  A.NY = nyg;
  const T dt_ = T(dt);
  A.dtdx = dt_ / T(dx);
  A.dtdy = dt_ / T(dy);
  A.hdx = T(0.5) * A.dtdx;
  A.hdy = T(0.5) * A.dtdy;
  A.g1 = T(g1);
  A.order = order;
  A.tw = tw;
  for (int p = 0; p < 4; ++p) A.lim[p] = lim[p];
  return A;
}

template <typename T>
void grid_of(int nxg, int nyg, int& nbx, int& nby) {
  nbx = (nyg - 4 + Shape<T>::TY - 1) / Shape<T>::TY;
  nby = (nxg - 4 + Shape<T>::TX - 1) / Shape<T>::TX;
}

#if defined(__CUDACC__)
template <typename T, int TX, int TY>
__global__ void __launch_bounds__(NT) step2_ctu_kernel(Args<T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Block<T, TX, TY> B;
  B.bind(reinterpret_cast<T*>(smem_raw), blockIdx.x, blockIdx.y, gridDim.x);
  const int tid = threadIdx.x;
  phase_load<T, TX, TY>(A, B, tid);
  __syncthreads();
  phase_roe<0, T, TX, TY>(A, B, tid);
  __syncthreads();
  phase_sweep<0, T, TX, TY>(A, B, tid);
  __syncthreads();
  phase_roe<1, T, TX, TY>(A, B, tid);
  __syncthreads();
  phase_sweep<1, T, TX, TY>(A, B, tid);
  __syncthreads();
  phase_update<T, TX, TY>(A, B, tid);
  for (int s = NT / 2; s > 0; s >>= 1) {
    __syncthreads();
    phase_reduce<T, TX, TY>(B, tid, s);
  }
  __syncthreads();
  phase_write_cfl<T, TX, TY>(A, B, tid);
}

template <typename T>
int launch(const void* qbc, void* qout, void* cflb, int nxg, int nyg,
           double dt, double dx, double dy, double g1, int order, int tw,
           const int* lim, void* stream) {
  constexpr int TX = Shape<T>::TX, TY = Shape<T>::TY;
  using L = Tile<T, TX, TY>;
  // The limit applies to the current device only: set it on every launch.
  cudaError_t err = cudaFuncSetAttribute(
      step2_ctu_kernel<T, TX, TY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return (int)err;
  int nbx, nby;
  grid_of<T>(nxg, nyg, nbx, nby);
  Args<T> A = make_args<T>(qbc, qout, cflb, nxg, nyg, dt, dx, dy, g1, order,
                           tw, lim);
  step2_ctu_kernel<T, TX, TY><<<dim3(nbx, nby), NT, L::bytes,
                                static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}
#else
// Host emulation: the same phases, one block and one "thread" at a time,
// with each barrier between two phases kept by running the whole block
// through a phase before the next.  Used by the CPU tests to check the
// kernel's index algebra against the plain version without a card.
template <typename T>
int launch_host(const void* qbc, void* qout, void* cflb, int nxg, int nyg,
                double dt, double dx, double dy, double g1, int order,
                int tw, const int* lim) {
  constexpr int TX = Shape<T>::TX, TY = Shape<T>::TY;
  using L = Tile<T, TX, TY>;
  int nbx, nby;
  grid_of<T>(nxg, nyg, nbx, nby);
  Args<T> A = make_args<T>(qbc, qout, cflb, nxg, nyg, dt, dx, dy, g1, order,
                           tw, lim);
  std::vector<T> smem(L::elems);
  for (int by = 0; by < nby; ++by) {
    for (int bx = 0; bx < nbx; ++bx) {
      Block<T, TX, TY> B;
      B.bind(smem.data(), bx, by, nbx);
      for (int t = 0; t < NT; ++t) phase_load<T, TX, TY>(A, B, t);
      for (int t = 0; t < NT; ++t) phase_roe<0, T, TX, TY>(A, B, t);
      for (int t = 0; t < NT; ++t) phase_sweep<0, T, TX, TY>(A, B, t);
      for (int t = 0; t < NT; ++t) phase_roe<1, T, TX, TY>(A, B, t);
      for (int t = 0; t < NT; ++t) phase_sweep<1, T, TX, TY>(A, B, t);
      for (int t = 0; t < NT; ++t) phase_update<T, TX, TY>(A, B, t);
      for (int s = NT / 2; s > 0; s >>= 1)
        for (int t = 0; t < NT; ++t) phase_reduce<T, TX, TY>(B, t, s);
      for (int t = 0; t < NT; ++t) phase_write_cfl<T, TX, TY>(A, B, t);
    }
  }
  return 0;
}
#endif

}  // namespace

// ---- plain C interface (loaded with ctypes) ----------------------------
extern "C" {

// Number of blocks (= CFL partials) the kernel writes for a padded grid.
int step2_ctu_blocks(int nxg, int nyg, int is_double) {
  int nbx, nby;
  if (is_double) grid_of<double>(nxg, nyg, nbx, nby);
  else grid_of<float>(nxg, nyg, nbx, nby);
  return nbx * nby;
}

// Shared memory bytes per block (reported by chip_smoke.py).
int step2_ctu_smem_bytes(int is_double) {
  return is_double
      ? (int)Tile<double, Shape<double>::TX, Shape<double>::TY>::bytes
      : (int)Tile<float, Shape<float>::TX, Shape<float>::TY>::bytes;
}

// One CTU step.  qbc: (4, nxg, nyg) ghost-padded (2 ghost cells), qout:
// (4, nxg-4, nyg-4), cflb: step2_ctu_blocks(...) partial CFL maxima; all
// contiguous, of the type named by the entry.  lim: 4 limiter ids.
// Returns a cudaError_t (0 on success).
#if defined(__CUDACC__)
int step2_ctu_f32(const void* qbc, void* qout, void* cflb, int nxg, int nyg,
                  double dt, double dx, double dy, double g1, int order,
                  int tw, int l0, int l1, int l2, int l3, void* stream) {
  const int lim[4] = {l0, l1, l2, l3};
  return launch<float>(qbc, qout, cflb, nxg, nyg, dt, dx, dy, g1, order, tw,
                       lim, stream);
}

int step2_ctu_f64(const void* qbc, void* qout, void* cflb, int nxg, int nyg,
                  double dt, double dx, double dy, double g1, int order,
                  int tw, int l0, int l1, int l2, int l3, void* stream) {
  const int lim[4] = {l0, l1, l2, l3};
  return launch<double>(qbc, qout, cflb, nxg, nyg, dt, dx, dy, g1, order,
                        tw, lim, stream);
}
#else
int step2_ctu_host_f32(const void* qbc, void* qout, void* cflb, int nxg,
                       int nyg, double dt, double dx, double dy, double g1,
                       int order, int tw, int l0, int l1, int l2, int l3) {
  const int lim[4] = {l0, l1, l2, l3};
  return launch_host<float>(qbc, qout, cflb, nxg, nyg, dt, dx, dy, g1,
                            order, tw, lim);
}

int step2_ctu_host_f64(const void* qbc, void* qout, void* cflb, int nxg,
                       int nyg, double dt, double dx, double dy, double g1,
                       int order, int tw, int l0, int l1, int l2, int l3) {
  const int lim[4] = {l0, l1, l2, l3};
  return launch_host<double>(qbc, qout, cflb, nxg, nyg, dt, dx, dy, g1,
                             order, tw, lim);
}
#endif

}  // extern "C"
