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
// halo in shared memory (cp.async, csrc/async_copy.cuh); the interface
// quantities (Roe data, fluctuations, correction fluxes, transverse
// terms) live in shared memory only, and each is computed once per block
// (the halo interfaces are recomputed by the neighbouring block, the
// price of independent blocks).  The scatter of rpt2 into the fluxes is
// written as a gather (no atomics).  Ragged edges are masked, so any
// (nx, ny) works.  The kernel is bound by the latency of its dependent
// arithmetic more than by its instruction rate, so the design buys
// resident warps and drops barriers and instructions.  Measured at
// 1024^2 against the first port in one call (PERF.md section 6; H100,
// 700 W), 0.243 -> 0.157 ms in f32 and 0.405 -> 0.276 ms in f64, lever by
// lever:
//   - the rpt2 split parts are not kept for the whole step: the x parts
//     live in one scratch array S until the y-faces have gathered them
//     (into the y-flux accumulators), then S takes the y parts, which the
//     update gathers into the x-fluxes.  The first port kept both sets
//     (16 of each interface's 28 fields) to the end: 89,304 B a block in
//     f32, two blocks of 8 warps per SM; this layout takes 69,784 B on
//     the same 16x16 tile, three blocks per SM;
//   - 6 barriers a block in place of 13: the y Roe data are computed in
//     the phase of the y-face gather, and the CFL partial is a
//     warp-shuffle max and one slot per warp;
//   - the two rpt2 splits of an interface share its g1/a2 (kept with
//     the Roe data; in f64 the Roe strengths' own quotient) and its
//     H - (u^2 + v^2), the operations each split made, and one IEEE
//     reciprocal of 2a that both multiply by where each divided (the
//     plain version divides: roundoff apart);
//   - tiles fitted to the block (Shape below), 16x16 -> 12x16 in f32 and
//     8x16 -> 11x16 in f64;
//   - the limiter's dot products and the amdq/apdq/cq sums skip the two
//     components the shear wave never has (the same bits).
// Slower and not taken: a 16x16 f64 tile of 512 threads.  The limiter
// still rebuilds three wave sets per interface from 9 stored Roe fields:
// storing the waves (16 fields and 4 speeds) would cost more shared
// memory than the S array saves.

// Phases (each a loop of the block's threads over a region, separated by
// barriers):
//   load    q tile + halo -> shared (indices clamped to the padded grid;
//           clamped cells only feed masked-out results)
//   roe<0>  x-interface Roe averages and wave strengths -> W
//   sweep<0> x-interface limiter, amdq/apdq, correction flux cq -> OX,
//           the rpt2 split of the fluctuations -> S; x-speed CFL partial
//   gather_y + roe<1>  each y-face of the tile gathers the x parts of its
//           four neighbour x-interfaces from S into OY's flux; the
//           y-interface Roe data -> W
//   sweep<1> the same for y -> OY (cq added to the gathered terms), S
//   update  each cell gathers the y parts of its two x-faces' four
//           neighbour y-interfaces into Fx and applies the conservative
//           update; each warp's CFL maxima
//
// The arithmetic repeats the plain version operation for operation,
// including the float32/float64 branch of riemann/euler.py:_alpha34; the
// y-flux's transverse terms are summed before its cq is added, the first
// port's order after it (roundoff).  The Roe solve and the scalar helpers
// live in euler2d.cuh, shared with dq2_weno5.cu, and the limiters in
// tvd.cuh, shared with step3_ctu.cu.

#include "async_copy.cuh"
#include "dt_coef.cuh"
#include "euler2d.cuh"
#include "tvd.cuh"

namespace {

constexpr int NT = 256;  // threads per block

// Tile shape per type (TX x TY cells) and blocks per SM: 12x16 in f32
// (54,840 B of shared memory, three blocks per SM), 11x16 in f64
// (102,208 B, two blocks per SM).  The tiles are fitted to the block:
// each sweep region ((TX+1) x (TY+2), (TX+2) x (TY+1) interfaces) is one
// pass of its 256 threads (the first port's 16x16 and 8x16 left 50 items
// to a second pass, or 36% of the threads idle), and in f64 each Roe
// region too.
template <typename T> struct Shape;
template <> struct Shape<float> {
  static constexpr int TX = 12, TY = 16, PER_SM = 3;
};
template <> struct Shape<double> {
  static constexpr int TX = 11, TY = 16, PER_SM = 2;
};

// ---- block geometry and shared-memory layout --------------------------
template <typename T, int TX, int TY> struct Tile {
  static constexpr int QR = TX + 4, QC = TY + 4;      // q tile + halo
  static constexpr int WXR = TX + 3, WXC = TY + 2;    // x Roe region
  static constexpr int WYR = TX + 2, WYC = TY + 3;    // y Roe region
  static constexpr int WN = WXR * WXC > WYR * WYC ? WXR * WXC : WYR * WYC;
  static constexpr int OXR = TX + 1, OXC = TY + 2;    // x-interface outputs
  static constexpr int OYR = TX + 2, OYC = TY + 1;    // y-interface outputs
  static constexpr int NWF = 9;    // u v H g1/a2 a a1 a3 a2w a4
  static constexpr int NOF = 12;   // amdq apdq flux (cq + transverse terms)
  static constexpr int NSF = 16;   // bm(am) bp(am) bm(ap) bp(ap)
  static constexpr int OXN = OXR * OXC, OYN = OYR * OYC;
  static constexpr int SN = OXN > OYN ? OXN : OYN;
  static constexpr size_t elems = 4 * QR * QC + NWF * WN + NOF * OXN
                                  + NOF * OYN + NSF * SN + 2 * NT
                                  + 2 * (NT / 32);
  static constexpr size_t bytes = elems * sizeof(T);
};

// The coefficients of dt in Args::C: dt/dx, dt/dy, 0.5 dt/dx, 0.5 dt/dy
// in T, as the host computed them from T(dt) before (dt_coef.cuh)
enum { C_DTDX = 0, C_DTDY = 1, C_HDX = 2, C_HDY = 3, NCOEF = 4 };

// Field offsets inside an O array and inside S (times the region size)
enum { F_AM = 0, F_AP = 4, F_CQ = 8 };
enum { F_T0 = 0, F_T1 = 4, F_T2 = 8, F_T3 = 12 };

template <typename T> struct Args {
  const T* qbc;
  T* qout;
  T* cflb;
  int NX, NY;           // padded (ghost-extended) extents
  const double* dt;     // the step (dt_coef.cuh)
  T dx, dy, g1;
  T* C;                 // the block's coefficients of dt (shared memory)
  int order, tw;
  int lim[4];
};

// coefficient k of dt (C_*): T(dt)/T(dx) or T(dt)/T(dy), halved for
// C_HDX and C_HDY
template <typename T> HD T dt_coef(const Args<T>& A, int k) {
  const T q = T(*A.dt) / (k % 2 == 0 ? A.dx : A.dy);
  return k < C_HDX ? q : T(0.5) * q;
}

template <typename T, int TX, int TY> struct Block {
  using L = Tile<T, TX, TY>;
  T* q;    // [4][QR][QC]
  T* W;    // [NWF][WN]
  T* OX;   // [NOF][OXN]
  T* OY;   // [NOF][OYN]
  T* S;    // [NSF][SN]: the x, then the y, rpt2 split parts
  T* rx;   // [NT] x-speed partial max, then [NT / 32] per warp
  T* ry;   // the same for the y-speeds
  int I0, J0, bid;  // first interior cell of the tile (padded indices)

  HD void bind(T* s, int bx, int by, int nbx) {
    q = s;
    W = q + 4 * L::QR * L::QC;
    OX = W + L::NWF * L::WN;
    OY = OX + L::NOF * L::OXN;
    S = OY + L::NOF * L::OYN;
    rx = S + L::NSF * L::SN;
    ry = rx + NT + NT / 32;
    I0 = 2 + by * TX;
    J0 = 2 + bx * TY;
    bid = by * nbx + bx;
  }
  HD T qs(int e, int r, int c) const { return q[(e * L::QR + r) * L::QC + c]; }
};

// ---- phase: stage q tile + halo ----------------------------------------
// Every copy is started (cp.async) before any is waited on.
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
    copy_async(B.q + idx, A.qbc + ((long long)e * A.NX + I) * A.NY + J);
  }
  // the block's coefficients of dt while the copies land
  if (tid < NCOEF) A.C[tid] = dt_coef(A, tid);
  B.rx[tid] = T(0);
  B.ry[tid] = T(0);
  copy_wait_all();
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
    // the quotient both rpt2 splits take (in f64 alpha34's own)
    Wp[3 * L::WN] = g1 / rs.a2;
    Wp[4 * L::WN] = rs.a;
    Wp[5 * L::WN] = rs.a1;
    Wp[6 * L::WN] = rs.a3;
    Wp[7 * L::WN] = rs.a2w;
    Wp[8 * L::WN] = rs.a4;
  }
}

// whether component e of wave p of the normal solve along IXY can be
// nonzero: the shear wave of roe_waves has two components.  The sums
// below skip the others, which add zero products to a finite sum (the
// same bits) but cost the card an instruction each (IEEE arithmetic
// cannot drop x + 0 * y).
template <int IXY> HD constexpr bool nz(int p, int e) {
  return p != 2 || e == 2 - IXY || e == 3;
}

// waves (equation order) and speeds of rpn2 from stored Roe data
template <int IXY, typename T, int WN>
HD void waves_at(const T* W, int idx, T w[4][4], T s[4]) {
  Roe<T> rs;
  rs.u = W[0 * WN + idx];
  rs.v = W[1 * WN + idx];
  rs.H = W[2 * WN + idx];
  rs.a = W[4 * WN + idx];
  rs.a1 = W[5 * WN + idx];
  rs.a3 = W[6 * WN + idx];
  rs.a2w = W[7 * WN + idx];
  rs.a4 = W[8 * WN + idx];
  roe_waves<IXY>(rs, w, s);
}

// rpt2_euler: split asdq into transverse down-going bm / up-going bp; ga2
// is g1/a2, euv is H - (u^2 + v^2) and r2a 1/(2a), shared by both splits
// of an interface
template <int IXY, typename T>
HD void rpt2(T u, T v, T H, T a, T ga2, T euv, T r2a, const T asdq[4], T bm[4],
             T bp[4]) {
  constexpr int mu = 1 + IXY, mv = 2 - IXY;
  T d0 = asdq[0], dmu = asdq[mu], dmv = asdq[mv], dE = asdq[3];
  T b3 = ga2 * (euv * d0 + u * dmu + v * dmv - dE);
  T b2w = dmu - u * d0;
  T b4 = (dmv + (a - v) * d0 - a * b3) * r2a;
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
  const T dtdx = A.C[IXY == 0 ? C_DTDX : C_DTDY];
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
        T d = T(0);
        bool first = true;
        for (int e = 0; e < 4; ++e) {
          if (!nz<IXY>(p, e)) continue;
          d = first ? wn[p][e] * w[p][e] : d + wn[p][e] * w[p][e];
          first = false;
        }
        dl[p] = d;
      }
      waves_at<IXY, T, L::WN>(B.W, hi, wn, sn);
      for (int p = 0; p < 4; ++p) {
        T d = T(0);
        bool first = true;
        for (int e = 0; e < 4; ++e) {
          if (!nz<IXY>(p, e)) continue;
          d = first ? w[p][e] * wn[p][e] : d + w[p][e] * wn[p][e];
          first = false;
        }
        dr[p] = d;
      }
      for (int p = 0; p < 4; ++p) {
        int lid = A.lim[p];
        if (lid == 0) continue;
        T wn2 = T(0);
        bool first = true;
        for (int e = 0; e < 4; ++e) {
          if (!nz<IXY>(p, e)) continue;
          wn2 = first ? w[p][e] * w[p][e] : wn2 + w[p][e] * w[p][e];
          first = false;
        }
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
        if (!nz<IXY>(p, e)) continue;   // wave 0 has every component
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
      // the y-flux already holds its gathered transverse terms
      O[(F_CQ + e) * ON + idx] = IXY == 0 ? cc : O[(F_CQ + e) * ON + idx] + cc;
    }

    if (A.tw > 0) {
      T amt[4], apt[4];
      bool both = A.tw >= 2 && A.order == 2;
      for (int e = 0; e < 4; ++e) {
        amt[e] = both ? am[e] + cq[e] : am[e];
        apt[e] = both ? ap[e] - cq[e] : ap[e];
      }
      const T u = B.W[0 * L::WN + own], v = B.W[1 * L::WN + own];
      const T H = B.W[2 * L::WN + own], ga2 = B.W[3 * L::WN + own];
      const T a = B.W[4 * L::WN + own];
      const T euv = H - (u * u + v * v);
      const T r2a = T(1) / (T(2) * a);
      T bm[4], bp[4];
      rpt2<IXY, T>(u, v, H, a, ga2, euv, r2a, amt, bm, bp);
      for (int e = 0; e < 4; ++e) {
        B.S[(F_T0 + e) * L::SN + idx] = bm[e];
        B.S[(F_T1 + e) * L::SN + idx] = bp[e];
      }
      rpt2<IXY, T>(u, v, H, a, ga2, euv, r2a, apt, bm, bp);
      for (int e = 0; e < 4; ++e) {
        B.S[(F_T2 + e) * L::SN + idx] = bm[e];
        B.S[(F_T3 + e) * L::SN + idx] = bp[e];
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

// ---- phase: the y-faces gather the x split parts ----------------------
// Gy at y-interface (OY row ti+1, column cj) takes -dt/(2 dx) (bm(amdq)
// at x-interface (ti+1, cj+1) + bp(amdq) at (ti+1, cj)) and the same of
// apdq at row ti: rows 1 .. TX of OY are the tile's y-faces; the rest
// (read by no cell) start from 0.
template <typename T, int TX, int TY>
HD void phase_gather_y(const Args<T>& A, Block<T, TX, TY>& B, int tid) {
  using L = Tile<T, TX, TY>;
  constexpr int OXC = L::OXC, OYC = L::OYC, OYN = L::OYN, SN = L::SN;
  const T* X = B.S;
  for (int idx = tid; idx < OYN; idx += NT) {
    const int r = idx / OYC, cj = idx % OYC;
    const bool face = A.tw > 0 && r >= 1 && r <= TX;
    for (int e = 0; e < 4; ++e) {
      T gy = T(0);
      if (face) {
        const int ti = r - 1;
        gy = -A.C[C_HDX] * (X[(F_T0 + e) * SN + (ti + 1) * OXC + cj + 1]
                       + X[(F_T1 + e) * SN + (ti + 1) * OXC + cj])
             - A.C[C_HDX] * (X[(F_T2 + e) * SN + ti * OXC + cj + 1]
                        + X[(F_T3 + e) * SN + ti * OXC + cj]);
      }
      B.OY[(F_CQ + e) * OYN + idx] = gy;
    }
  }
}

// fold thread t's CFL partials into its warp's slots: a shuffle max on
// the card, a loop over the lanes on the host
template <typename T> HD void warp_fold(T* red, int t) {
#if defined(__CUDACC__)
  const T m = warp_max(red[t]);
  if (t % 32 == 0) red[NT + t / 32] = m;
#else
  red[NT + t / 32] = t % 32 == 0 ? red[t] : mx(red[NT + t / 32], red[t]);
#endif
}

// the block's maximum from the warps' slots
template <typename T> HD T block_max(const T* red) {
  T m = red[NT];
  for (int w = 1; w < NT / 32; ++w) m = mx(m, red[NT + w]);
  return m;
}

// ---- phase: x transverse gather + conservative update ------------------
template <typename T, int TX, int TY>
HD void phase_update(const Args<T>& A, Block<T, TX, TY>& B, int tid) {
  using L = Tile<T, TX, TY>;
  constexpr int OXC = L::OXC, OYC = L::OYC, OXN = L::OXN, OYN = L::OYN;
  constexpr int SN = L::SN;
  const T* X = B.OX;
  const T* Y = B.OY;
  const T* YS = B.S;
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
          f = f - A.C[C_HDY] * (YS[(F_T0 + e) * SN + (rk + 1) * OYC + cJ]
                           + YS[(F_T1 + e) * SN + rk * OYC + cJ])
                - A.C[C_HDY] * (YS[(F_T2 + e) * SN + (rk + 1) * OYC + cJ - 1]
                           + YS[(F_T3 + e) * SN + rk * OYC + cJ - 1]);
        }
        F[h] = f;
      }
      // Gy at y-interfaces j = J-1 (OY col tj) and j = J (col tj+1),
      // row I (OY row ti+1): cq and the gathered x terms
      T G[2];
      for (int h = 0; h < 2; ++h)
        G[h] = Y[(F_CQ + e) * OYN + (ti + 1) * OYC + tj + h];
      T apx = X[(F_AP + e) * OXN + ti * OXC + tj + 1];
      T amx = X[(F_AM + e) * OXN + (ti + 1) * OXC + tj + 1];
      T apy = Y[(F_AP + e) * OYN + (ti + 1) * OYC + tj];
      T amy = Y[(F_AM + e) * OYN + (ti + 1) * OYC + tj + 1];
      T dq = (apx + amx + F[1] - F[0]) * A.C[C_DTDX]
           + (apy + amy + G[1] - G[0]) * A.C[C_DTDY];
      A.qout[((long long)e * nx + (I - 2)) * ny + (J - 2)] =
          B.qs(e, ti + 2, tj + 2) - dq;
    }
  }
  warp_fold(B.rx, tid);
  warp_fold(B.ry, tid);
}

// ---- the phase sequence, shared by the kernel and the host emulation ---
// X(fn) runs fn(tid) for every thread of the block, then a barrier.
template <typename T, int TX, int TY, class X>
HD void step_block(const Args<T>& A, Block<T, TX, TY>& B, const X& run) {
  run([&](int t) { phase_load<T, TX, TY>(A, B, t); });
  run([&](int t) { phase_roe<0, T, TX, TY>(A, B, t); });
  run([&](int t) { phase_sweep<0, T, TX, TY>(A, B, t); });
  run([&](int t) {
    phase_gather_y<T, TX, TY>(A, B, t);
    phase_roe<1, T, TX, TY>(A, B, t);
  });
  run([&](int t) { phase_sweep<1, T, TX, TY>(A, B, t); });
  run([&](int t) { phase_update<T, TX, TY>(A, B, t); });
}

// the block's CFL: max speed times dt/dx, max over both directions
template <typename T, int TX, int TY>
HD T block_cfl(const Args<T>& A, const Block<T, TX, TY>& B) {
  return mx(A.C[C_DTDX] * block_max(B.rx), A.C[C_DTDY] * block_max(B.ry));
}

template <typename T>
Args<T> make_args(const void* qbc, void* qout, void* cflb, int nxg, int nyg,
                  const double* dt, double dx, double dy, double g1,
                  int order, int tw, const int* lim) {
  Args<T> A;
  A.qbc = static_cast<const T*>(qbc);
  A.qout = static_cast<T*>(qout);
  A.cflb = static_cast<T*>(cflb);
  A.NX = nxg;
  A.NY = nyg;
  A.dt = dt;
  A.dx = T(dx);
  A.dy = T(dy);
  A.C = nullptr;
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
struct DeviceRun {
  template <class Fn> __device__ void operator()(Fn&& fn) const {
    fn(static_cast<int>(threadIdx.x));
    __syncthreads();
  }
};

template <typename T, int TX, int TY>
__global__ void __launch_bounds__(NT, Shape<T>::PER_SM)
    step2_ctu_kernel(Args<T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T coef[NCOEF];
  A.C = coef;
  Block<T, TX, TY> B;
  B.bind(reinterpret_cast<T*>(smem_raw), blockIdx.x, blockIdx.y, gridDim.x);
  step_block(A, B, DeviceRun());
  if (threadIdx.x == 0) A.cflb[B.bid] = block_cfl(A, B);
}

template <typename T>
int launch(const void* qbc, void* qout, void* cflb, int nxg, int nyg,
           const double* dt, double dx, double dy, double g1, int order,
           int tw, const int* lim, void* stream) {
  constexpr int TX = Shape<T>::TX, TY = Shape<T>::TY;
  using L = Tile<T, TX, TY>;
  static unsigned long long attr_done = 0;
  cudaError_t err = smem_attr_once(
      reinterpret_cast<const void*>(step2_ctu_kernel<T, TX, TY>),
      (int)L::bytes, attr_done);
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
struct HostRun {
  template <class Fn> void operator()(Fn&& fn) const {
    for (int t = 0; t < NT; ++t) fn(t);
  }
};

template <typename T>
int launch_host(const void* qbc, void* qout, void* cflb, int nxg, int nyg,
                const double* dt, double dx, double dy, double g1,
                int order, int tw, const int* lim) {
  constexpr int TX = Shape<T>::TX, TY = Shape<T>::TY;
  using L = Tile<T, TX, TY>;
  int nbx, nby;
  grid_of<T>(nxg, nyg, nbx, nby);
  Args<T> A = make_args<T>(qbc, qout, cflb, nxg, nyg, dt, dx, dy, g1, order,
                           tw, lim);
  std::vector<T> smem(L::elems);
  T coef[NCOEF];
  A.C = coef;
  for (int by = 0; by < nby; ++by) {
    for (int bx = 0; bx < nbx; ++bx) {
      Block<T, TX, TY> B;
      B.bind(smem.data(), bx, by, nbx);
      step_block(A, B, HostRun());
      A.cflb[B.bid] = block_cfl(A, B);
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

// Threads per block and the blocks per SM the kernel is built for
// (reported by chip_smoke.py).
int step2_ctu_threads(int is_double) {
  (void)is_double;
  return NT;
}

int step2_ctu_blocks_per_sm(int is_double) {
  return is_double ? Shape<double>::PER_SM : Shape<float>::PER_SM;
}

// Shared memory bytes per block (reported by chip_smoke.py).
int step2_ctu_smem_bytes(int is_double) {
  return is_double
      ? (int)Tile<double, Shape<double>::TX, Shape<double>::TY>::bytes
      : (int)Tile<float, Shape<float>::TX, Shape<float>::TY>::bytes;
}

// One CTU step.  qbc: (4, nxg, nyg) ghost-padded (2 ghost cells), qout:
// (4, nxg-4, nyg-4), cflb: step2_ctu_blocks(...) partial CFL maxima; all
// contiguous, of the type named by the entry.  dt: the step in device
// memory (host memory for the host emulation), a double that is exact in
// the entry's type.  lim: 4 limiter ids.
// Returns a cudaError_t (0 on success).
#if defined(__CUDACC__)
int step2_ctu_f32(const void* qbc, void* qout, void* cflb, int nxg, int nyg,
                  const double* dt, double dx, double dy, double g1,
                  int order, int tw, int l0, int l1, int l2, int l3,
                  void* stream) {
  const int lim[4] = {l0, l1, l2, l3};
  return launch<float>(qbc, qout, cflb, nxg, nyg, dt, dx, dy, g1, order, tw,
                       lim, stream);
}

int step2_ctu_f64(const void* qbc, void* qout, void* cflb, int nxg, int nyg,
                  const double* dt, double dx, double dy, double g1,
                  int order, int tw, int l0, int l1, int l2, int l3,
                  void* stream) {
  const int lim[4] = {l0, l1, l2, l3};
  return launch<double>(qbc, qout, cflb, nxg, nyg, dt, dx, dy, g1, order,
                        tw, lim, stream);
}
#else
int step2_ctu_host_f32(const void* qbc, void* qout, void* cflb, int nxg,
                       int nyg, const double* dt, double dx, double dy,
                       double g1, int order, int tw, int l0, int l1, int l2,
                       int l3) {
  const int lim[4] = {l0, l1, l2, l3};
  return launch_host<float>(qbc, qout, cflb, nxg, nyg, dt, dx, dy, g1,
                            order, tw, lim);
}

int step2_ctu_host_f64(const void* qbc, void* qout, void* cflb, int nxg,
                       int nyg, const double* dt, double dx, double dy,
                       double g1, int order, int tw, int l0, int l1, int l2,
                       int l3) {
  const int lim[4] = {l0, l1, l2, l3};
  return launch_host<double>(qbc, qout, cflb, nxg, nyg, dt, dx, dy, g1,
                             order, tw, lim);
}
#endif

}  // extern "C"
