// step3_ctu.cu — the whole 3D unsplit classic (CTU) step of the Euler
// system (5 equations, 5 waves) with its CFL, one launch per step, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel pyclaw_tpu/ops/tiled2d.py:431 step3_pallas_xy
// (pallas_call at :592, body classic/kernels.py:806 step3_roll) in its
// wave form without aux arrays or a capacity function.  It computes what
// pyclaw_tpu/classic/kernels.py:step3 computes: in each direction the Roe
// solve, the 5-wave limiter and the correction flux; the rpt3 split of
// each fluctuation along both transverse axes into the fluxes of those
// axes; the rptt3 split of each rpt3 part along the third axis into the
// third axis' flux (the Langseth-LeVeque corner-of-corner terms); then
// the conservative update.  Its plain PyTorch version is
// pyclaw_tpu_torch/classic/kernels.py:step3, which it is held against on
// the card (chip_smoke.py) and, through the host emulation at the end of
// this file, on the CPU (tests/test_torch_step3.py).
//
// What bounds it on the card: per cell it reads 5 values of q and writes
// 5 (at 192^3, qbc read once and q written once are 5 x (196^3 + 192^3)
// values, 292 MB in f32: 0.087 ms at 3.35 TB/s), but the step needs about
// 7,900 floating-point operations per cell (3 normal Roe solves with the
// limiter, 3 eigensystems, 12 rpt3 and 24 rptt3 splits, the gathers and
// the update; chip_smoke.py:FLOPS_PER_CELL_3D counts them from this
// source), among them divides and square roots.  At 67 TFLOP/s (f32) or
// 34 TFLOP/s (f64) that is 0.84 ms (f32) or 1.65 ms (f64) at 192^3:
// operations bound it, not bytes.  chip_smoke.py computes both bounds.
//
// What the design does about it: no intermediate touches device memory.
// A block owns a tile of output cells and stages q with a 2-cell halo in
// shared memory.  It runs the three sweep directions one after the
// other and reuses one scratch area for each: the Roe data of the
// direction's interfaces, then its fluctuations, the shared eigensystem
// and the split parts.  Each quantity is computed once per block (the
// halo interfaces are recomputed by the neighbouring block, the price of
// independent blocks).  The three flux arrays of the tile's faces stay
// in shared memory until the update.  The scatter of the split parts
// into the fluxes of the other two axes (one-cell shifts along three
// axes) is written as a gather: each flux element adds the parts of its
// neighbouring interfaces in a fixed order, with no atomics.  The TPU's
// workarounds are gone: no roll form, no tile-divisibility rule, no
// 8-row over-fetch, no 128-lane padding.  Ragged edges are clamped on
// load and masked on store, so any (nx, ny, nz) works.
//
// Tile shape: 8x8x8 cells in f32 (about 206 KB of shared memory, one
// block of 256 threads per SM), 4x4x8 in f64 (about 147 KB).
//
// Phases (each a loop of the block's threads over a region, separated by
// barriers), for each sweep axis D in x, y, z:
//   roe<D>     Roe data of the normal solve at the D-interfaces the tile
//              needs (T+3 along D, T+2 across) -> scratch
//   sweep<D>   at T+1 x (T+2)^2 interfaces: the limiter (neighbour waves
//              rebuilt from the Roe data), amdq, apdq, the correction
//              flux cq, the fluctuations the transverse splits take,
//              the eigensystem of the splits; cq into the D-flux of the
//              tile's faces; the CFL partial max
//   fluct<D>   each cell: dt/dD (apdq + amdq) of its two D-faces
//   for each transverse axis E of D (F the third) and each of the two
//   fluctuations (A-, A+):
//     rpt      split along E -> bm, bp
//     gather_e the E-flux of each E-face takes -dt/(2 dD) (bm, bp) of
//              its two neighbour cells;  rptt of bm along F -> cm, cp
//     gather_f the F-flux of each F-face takes the bm parts (own e-row
//              minus the crossing one);  rptt of bp along F
//     gather_f the same for the bp parts
//   update     q - dq over the tile; reduce the CFL partials
//
// The arithmetic repeats the plain version's; the sums of the transverse
// terms into the fluxes and of the three directions into dq are taken in
// another order (roundoff).  The Roe solve and the split live in
// euler3d.cuh, the limiters in tvd.cuh, the tile geometry (shared with
// step3_aos.cu) in ctu3d.cuh.

#include "ctu3d.cuh"
#include "euler3d.cuh"
#include "tvd.cuh"

namespace {

// Tile shape per type (cells along x, y, z)
template <typename T> struct Shape;
template <> struct Shape<float> { static constexpr int X = 8, Y = 8, Z = 8; };
template <> struct Shape<double> { static constexpr int X = 4, Y = 4, Z = 8; };

// Shared-memory layout (offsets in elements)
template <typename T, class S> struct Lay {
  using R0 = Reg<S, 0>;
  using R1 = Reg<S, 1>;
  using R2 = Reg<S, 2>;
  static constexpr int Q0 = S::X + 4, Q1 = S::Y + 4, Q2 = S::Z + 4;
  static constexpr int QN = Q0 * Q1 * Q2;           // q tile + halo
  static constexpr int CN = S::X * S::Y * S::Z;     // tile cells
  static constexpr int AM = CMAX(R0::AN, CMAX(R1::AN, R2::AN));
  static constexpr int BM = CMAX(R0::BN, CMAX(R1::BN, R2::BN));
  static constexpr int FM = CMAX(R0::FN, CMAX(R1::FN, R2::FN));
  // scratch: [Roe data 10 x AN | ... | amdq, apdq at faces 10 x FM]
  //      or: [bm, bp 10 x BM | split parts along the third axis 10 x BM]
  static constexpr int US = CMAX(20 * BM, 10 * AM + 10 * FM);
  static constexpr int oF0 = 5 * QN;
  static constexpr int oF1 = oF0 + 5 * R0::FN;
  static constexpr int oF2 = oF1 + 5 * R1::FN;
  static constexpr int oDQ = oF2 + 5 * R2::FN;
  static constexpr int oTR = oDQ + 5 * CN;          // fluctuations to split
  static constexpr int oEIG = oTR + 10 * BM;        // u1 u2 u3 H a2
  static constexpr int oU = oEIG + 5 * BM;
  static constexpr int oRED = oU + US;
  static constexpr size_t elems = oRED + NT;
  static constexpr size_t bytes = elems * sizeof(T);
};

template <typename T> struct Args {
  const T* qbc;
  T* qout;
  T* cflb;
  int N[3];            // padded (ghost-extended) extents
  int nb[3];           // blocks along x, y, z
  T dtd[3];            // dt / dD
  T half[3];           // 0.5 dt / dD
  T co2[3][3];         // dt^2 / (6 dD dE)
  T g1;
  int order, tw;
  int lim[5];
};

template <typename T, class S> struct Block {
  using L = Lay<T, S>;
  T* Q;
  T* F[3];
  T* DQ;
  T* TR;
  T* EIG;
  T* U;
  T* RED;
  int C0[3];   // first interior cell of the tile (padded indices)
  int bid;

  HD void bind(T* s, int b) {
    Q = s;
    F[0] = s + L::oF0;
    F[1] = s + L::oF1;
    F[2] = s + L::oF2;
    DQ = s + L::oDQ;
    TR = s + L::oTR;
    EIG = s + L::oEIG;
    U = s + L::oU;
    RED = s + L::oRED;
    bid = b;
  }
  HD T qs(int e, int l0, int l1, int l2) const {
    return Q[((e * L::Q0 + l0) * L::Q1 + l1) * L::Q2 + l2];
  }
  HD T* AMf() const { return U + L::US - 10 * L::FM; }
  HD T* APf() const { return U + L::US - 5 * L::FM; }
};

// ---- phase: stage q tile + halo, zero the accumulators ----------------
template <typename T, class S>
HD void phase_load(const Args<T>& A, Block<T, S>& B, int tid) {
  using L = Lay<T, S>;
  for (int idx = tid; idx < 5 * L::QN; idx += NT) {
    int e = idx / L::QN;
    int c[3];
    dec<L::Q0, L::Q1, L::Q2>(idx % L::QN, c);
    long long g[3];
    for (int a = 0; a < 3; ++a) {
      int v = B.C0[a] - 2 + c[a];
      g[a] = v < A.N[a] ? v : A.N[a] - 1;
    }
    B.Q[idx] = A.qbc[((e * A.N[0] + g[0]) * A.N[1] + g[1]) * A.N[2] + g[2]];
  }
  for (int idx = tid; idx < L::oTR - L::oF0; idx += NT) B.F[0][idx] = T(0);
  B.RED[tid] = T(0);
}

// ---- phase: Roe data of the normal solve at the D-interfaces ----------
template <int D, typename T, class S>
HD void phase_roe(const Args<T>& A, Block<T, S>& B, int tid) {
  using R = Reg<S, D>;
  T* W = B.U;
  for (int idx = tid; idx < R::AN; idx += NT) {
    int c[3];
    dec<R::A0, R::A1, R::A2>(idx, c);
    int l[3] = {c[0] + 1, c[1] + 1, c[2] + 1};
    l[D] = c[D];
    T ql[5], qr[5];
    for (int e = 0; e < 5; ++e) {
      ql[e] = B.qs(e, l[0], l[1], l[2]);
      qr[e] = B.qs(e, l[0] + (D == 0), l[1] + (D == 1), l[2] + (D == 2));
    }
    const Roe3<T> rs = roe_3d<D>(A.g1, ql, qr);
    W[0 * R::AN + idx] = rs.u;
    W[1 * R::AN + idx] = rs.v;
    W[2 * R::AN + idx] = rs.w;
    W[3 * R::AN + idx] = rs.H;
    W[4 * R::AN + idx] = rs.a;
    W[5 * R::AN + idx] = rs.a1;
    W[6 * R::AN + idx] = rs.a3;
    W[7 * R::AN + idx] = rs.ash;
    W[8 * R::AN + idx] = rs.ash2;
    W[9 * R::AN + idx] = rs.a5;
  }
}

template <int D, int AN, typename T>
HD void waves_at(const T* W, int k, T w[5][5], T s[5]) {
  Roe3<T> rs;
  rs.u = W[0 * AN + k];
  rs.v = W[1 * AN + k];
  rs.w = W[2 * AN + k];
  rs.H = W[3 * AN + k];
  rs.a = W[4 * AN + k];
  rs.a1 = W[5 * AN + k];
  rs.a3 = W[6 * AN + k];
  rs.ash = W[7 * AN + k];
  rs.ash2 = W[8 * AN + k];
  rs.a5 = W[9 * AN + k];
  waves3<D>(rs, w, s);
}

// ---- phase: limiter, fluctuations, correction flux, eigensystem -------
template <int D, typename T, class S>
HD void phase_sweep(const Args<T>& A, Block<T, S>& B, int tid) {
  using R = Reg<S, D>;
  using L = Lay<T, S>;
  constexpr int step = D == 0 ? R::A1 * R::A2 : (D == 1 ? R::A2 : 1);
  const T* W = B.U;
  const T dtd = A.dtd[D];
  T* AMf = B.AMf();
  T* APf = B.APf();
  T cfl = B.RED[tid];
  for (int idx = tid; idx < R::BN; idx += NT) {
    int b[3];
    dec<R::B0, R::B1, R::B2>(idx, b);
    int a[3] = {b[0], b[1], b[2]};
    a[D] += 1;
    const int own = flat<R::A0, R::A1, R::A2>(a);
    T w[5][5], s[5];
    waves_at<D, R::AN>(W, own, w, s);

    T phi[5] = {T(1), T(1), T(1), T(1), T(1)};
    if (A.order == 2) {
      T wn[5][5], sn[5], dl[5], dr[5];
      waves_at<D, R::AN>(W, own - step, wn, sn);
      for (int p = 0; p < 5; ++p) {
        T d = wn[p][0] * w[p][0];
        for (int e = 1; e < 5; ++e) d = d + wn[p][e] * w[p][e];
        dl[p] = d;
      }
      waves_at<D, R::AN>(W, own + step, wn, sn);
      for (int p = 0; p < 5; ++p) {
        T d = w[p][0] * wn[p][0];
        for (int e = 1; e < 5; ++e) d = d + w[p][e] * wn[p][e];
        dr[p] = d;
      }
      for (int p = 0; p < 5; ++p) {
        const int lid = A.lim[p];
        if (lid == 0) continue;
        T wn2 = w[p][0] * w[p][0];
        for (int e = 1; e < 5; ++e) wn2 = wn2 + w[p][e] * w[p][e];
        T dotu = s[p] > T(0) ? dl[p] : dr[p];
        bool safe = wn2 > T(0);
        T theta = safe ? dotu / wn2 : T(0);
        T ph = phi_limiter<T>(lid, theta, fabs_(s[p]) * dtd);
        phi[p] = safe ? ph : T(1);
      }
    }

    T am[5], ap[5], cq[5];
    for (int e = 0; e < 5; ++e) {
      T m = T(0), pp = T(0), cc = T(0);
      for (int p = 0; p < 5; ++p) {
        T am_t = mn(s[p], T(0)) * w[p][e];
        T ap_t = mx(s[p], T(0)) * w[p][e];
        m = p == 0 ? am_t : m + am_t;
        pp = p == 0 ? ap_t : pp + ap_t;
        if (A.order == 2) {
          T absp = fabs_(s[p]);
          T coef = T(0.5) * absp * (T(1) - absp * dtd);
          T c_t = coef * phi[p] * w[p][e];
          cc = p == 0 ? c_t : cc + c_t;
        }
      }
      am[e] = m;
      ap[e] = pp;
      cq[e] = cc;
    }

    // the fluctuations the transverse splits take
    const bool both = A.tw >= 2 && A.order == 2;
    for (int e = 0; e < 5; ++e) {
      B.TR[e * L::BM + idx] = both ? am[e] + cq[e] : am[e];
      B.TR[(5 + e) * L::BM + idx] = both ? ap[e] - cq[e] : ap[e];
    }

    // the eigensystem of the splits (fixed component order 1, 2, 3)
    {
      T ql[5], qr[5], vel[3], H, a2;
      for (int e = 0; e < 5; ++e) {
        ql[e] = B.qs(e, b[0] + 1, b[1] + 1, b[2] + 1);
        qr[e] = B.qs(e, b[0] + 1 + (D == 0), b[1] + 1 + (D == 1),
                     b[2] + 1 + (D == 2));
      }
      roe_avg3<1, 2, 3>(A.g1, ql, qr, vel, H, a2);
      B.EIG[0 * L::BM + idx] = vel[0];
      B.EIG[1 * L::BM + idx] = vel[1];
      B.EIG[2 * L::BM + idx] = vel[2];
      B.EIG[3 * L::BM + idx] = H;
      B.EIG[4 * L::BM + idx] = a2;
    }

    // a face of the tile: cq into the D-flux, amdq/apdq for fluct<D>
    bool face = true;
    int f[3];
    for (int k = 0; k < 3; ++k) {
      if (k == D) {
        f[k] = b[k];
      } else {
        f[k] = b[k] - 1;
        face = face && b[k] >= 1
               && b[k] <= (k == 0 ? S::X : (k == 1 ? S::Y : S::Z));
      }
    }
    if (face) {
      const int fi = flat<R::F0, R::F1, R::F2>(f);
      for (int e = 0; e < 5; ++e) {
        if (A.order == 2) B.F[D][e * R::FN + fi] += cq[e];
        AMf[e * L::FM + fi] = am[e];
        APf[e * L::FM + fi] = ap[e];
      }
    }

    // CFL window: interfaces 1 .. N-3 along D, interior cells across
    bool in_cfl = true;
    for (int k = 0; k < 3; ++k) {
      const int g = B.C0[k] - 1 + b[k];
      in_cfl = in_cfl && (k == D ? (g >= 1 && g <= A.N[k] - 3)
                                 : (g >= 2 && g <= A.N[k] - 3));
    }
    if (in_cfl) {
      for (int p = 0; p < 5; ++p) cfl = mx(cfl, dtd * fabs_(s[p]));
    }
  }
  B.RED[tid] = cfl;
}

// ---- phase: first-order fluctuations of each cell ----------------------
template <int D, typename T, class S>
HD void phase_fluct(const Args<T>& A, Block<T, S>& B, int tid) {
  using R = Reg<S, D>;
  using L = Lay<T, S>;
  const T* AMf = B.AMf();
  const T* APf = B.APf();
  for (int idx = tid; idx < L::CN; idx += NT) {
    int c[3];
    dec<S::X, S::Y, S::Z>(idx, c);
    const int fl = flat<R::F0, R::F1, R::F2>(c);
    c[D] += 1;
    const int fr = flat<R::F0, R::F1, R::F2>(c);
    for (int e = 0; e < 5; ++e)
      B.DQ[e * L::CN + idx] += A.dtd[D] * (APf[e * L::FM + fl]
                                           + AMf[e * L::FM + fr]);
  }
}

template <typename T, class S>
HD void load_eig(const Block<T, S>& B, int idx, T eig[5]) {
  using L = Lay<T, S>;
  for (int k = 0; k < 5; ++k) eig[k] = B.EIG[k * L::BM + idx];
}

// ---- phase: rpt3 split of one fluctuation along E ----------------------
template <int D, int E, int IMP, typename T, class S>
HD void phase_rpt(const Args<T>& A, Block<T, S>& B, int tid) {
  using R = Reg<S, D>;
  using L = Lay<T, S>;
  T* BB = B.U;
  for (int idx = tid; idx < R::BN; idx += NT) {
    T asdq[5], eig[5], bm[5], bp[5];
    for (int e = 0; e < 5; ++e)
      asdq[e] = B.TR[((IMP - 1) * 5 + e) * L::BM + idx];
    load_eig(B, idx, eig);
    split3<1 + E>(A.g1, eig, asdq, bm, bp);
    for (int e = 0; e < 5; ++e) {
      BB[e * L::BM + idx] = bm[e];
      BB[(5 + e) * L::BM + idx] = bp[e];
    }
  }
}

// ---- phase: the E-flux gathers the rpt3 parts of its two neighbours ----
// F_E at (cell I along D, face J along E, cell K along F) takes
// -dt/(2 dD) (bm at e-cell J+1 + bp at e-cell J) of D-interface I-i0.
template <int D, int E, int IMP, typename T, class S>
HD void phase_gather_e(const Args<T>& A, Block<T, S>& B, int tid) {
  using R = Reg<S, D>;
  using RE = Reg<S, E>;
  using L = Lay<T, S>;
  constexpr int F = 3 - D - E;
  const T* BB = B.U;
  T* FE = B.F[E];
  const T h = A.half[D];
  for (int idx = tid; idx < RE::FN; idx += NT) {
    int c[3], k[3];
    dec<RE::F0, RE::F1, RE::F2>(idx, c);
    k[D] = c[D] + 1 - (IMP - 1);
    k[F] = c[F] + 1;
    k[E] = c[E] + 1;
    const int k_bm = flat<R::B0, R::B1, R::B2>(k);
    k[E] = c[E];
    const int k_bp = flat<R::B0, R::B1, R::B2>(k);
    for (int e = 0; e < 5; ++e)
      FE[e * RE::FN + idx] += -(h * BB[e * L::BM + k_bm]
                               + h * BB[(5 + e) * L::BM + k_bp]);
  }
}

// ---- phase: rptt3 split of one rpt3 part (PART 0: bm, 1: bp) along F,
// scaled by -+dt^2/(6 dD dE) (the down-going part flips its sign) --------
template <int D, int E, int PART, typename T, class S>
HD void phase_rptt(const Args<T>& A, Block<T, S>& B, int tid) {
  using R = Reg<S, D>;
  using L = Lay<T, S>;
  constexpr int F = 3 - D - E;
  const T* BB = B.U;
  T* TB = B.U + 10 * L::BM;
  const T co = PART == 0 ? -A.co2[D][E] : A.co2[D][E];
  for (int idx = tid; idx < R::BN; idx += NT) {
    T bs[5], eig[5], cm[5], cp[5];
    for (int e = 0; e < 5; ++e) bs[e] = BB[(5 * PART + e) * L::BM + idx];
    load_eig(B, idx, eig);
    split3<1 + F>(A.g1, eig, bs, cm, cp);
    for (int e = 0; e < 5; ++e) {
      TB[e * L::BM + idx] = co * cm[e];
      TB[(5 + e) * L::BM + idx] = co * cp[e];
    }
  }
}

// ---- phase: the F-flux gathers the rptt3 parts of one rpt3 part -------
// F_F at (cell I along D, cell J along E, face K along F) takes, from
// D-interface I-i0: + (cm at f-cell K+1 + cp at f-cell K) of e-cell J,
// - the same of e-cell J+1 (bm parts) or J-1 (bp parts).
template <int D, int E, int IMP, int PART, typename T, class S>
HD void phase_gather_f(const Args<T>& A, Block<T, S>& B, int tid) {
  using R = Reg<S, D>;
  using L = Lay<T, S>;
  constexpr int F = 3 - D - E;
  using RF = Reg<S, F>;
  const T* TB = B.U + 10 * L::BM;
  T* FF = B.F[F];
  for (int idx = tid; idx < RF::FN; idx += NT) {
    int c[3], k[3];
    dec<RF::F0, RF::F1, RF::F2>(idx, c);
    k[D] = c[D] + 1 - (IMP - 1);
    k[E] = c[E] + 1;
    k[F] = c[F] + 1;
    const int own_m = flat<R::B0, R::B1, R::B2>(k);
    k[F] = c[F];
    const int own_p = flat<R::B0, R::B1, R::B2>(k);
    k[E] = c[E] + 1 + (PART == 0 ? 1 : -1);
    const int x_p = flat<R::B0, R::B1, R::B2>(k);
    k[F] = c[F] + 1;
    const int x_m = flat<R::B0, R::B1, R::B2>(k);
    for (int e = 0; e < 5; ++e) {
      T own = TB[e * L::BM + own_m] + TB[(5 + e) * L::BM + own_p];
      T cross = -TB[e * L::BM + x_m] - TB[(5 + e) * L::BM + x_p];
      FF[e * RF::FN + idx] += own + cross;
    }
  }
}

// ---- phase: conservative update of the tile ----------------------------
template <typename T, class S>
HD void phase_update(const Args<T>& A, Block<T, S>& B, int tid) {
  using L = Lay<T, S>;
  using R0 = Reg<S, 0>;
  using R1 = Reg<S, 1>;
  using R2 = Reg<S, 2>;
  const int n0 = A.N[0] - 4, n1 = A.N[1] - 4, n2 = A.N[2] - 4;
  for (int idx = tid; idx < L::CN; idx += NT) {
    int c[3];
    dec<S::X, S::Y, S::Z>(idx, c);
    const int I0 = B.C0[0] + c[0], I1 = B.C0[1] + c[1], I2 = B.C0[2] + c[2];
    if (I0 >= A.N[0] - 2 || I1 >= A.N[1] - 2 || I2 >= A.N[2] - 2) continue;
    int fx[3] = {c[0] + 1, c[1], c[2]};
    int fy[3] = {c[0], c[1] + 1, c[2]};
    int fz[3] = {c[0], c[1], c[2] + 1};
    const int x0 = flat<R0::F0, R0::F1, R0::F2>(c);
    const int x1 = flat<R0::F0, R0::F1, R0::F2>(fx);
    const int y0 = flat<R1::F0, R1::F1, R1::F2>(c);
    const int y1 = flat<R1::F0, R1::F1, R1::F2>(fy);
    const int z0 = flat<R2::F0, R2::F1, R2::F2>(c);
    const int z1 = flat<R2::F0, R2::F1, R2::F2>(fz);
    for (int e = 0; e < 5; ++e) {
      T dq = B.DQ[e * L::CN + idx];
      dq = dq + A.dtd[0] * (B.F[0][e * R0::FN + x1] - B.F[0][e * R0::FN + x0]);
      dq = dq + A.dtd[1] * (B.F[1][e * R1::FN + y1] - B.F[1][e * R1::FN + y0]);
      dq = dq + A.dtd[2] * (B.F[2][e * R2::FN + z1] - B.F[2][e * R2::FN + z0]);
      A.qout[((long long)(e * n0 + I0 - 2) * n1 + (I1 - 2)) * n2 + (I2 - 2)] =
          B.qs(e, c[0] + 2, c[1] + 2, c[2] + 2) - dq;
    }
  }
}

// ---- the phase sequence, shared by the kernel and the host emulation ---
// X(fn) runs fn(tid) for every thread of the block, then a barrier.
template <int D, int E, typename T, class S, class X>
HD void transverse(const Args<T>& A, Block<T, S>& B, const X& run) {
  run([&](int t) { phase_rpt<D, E, 1>(A, B, t); });
  run([&](int t) {
    phase_gather_e<D, E, 1>(A, B, t);
    if (A.tw >= 2) phase_rptt<D, E, 0>(A, B, t);
  });
  if (A.tw >= 2) {
    run([&](int t) { phase_gather_f<D, E, 1, 0>(A, B, t); });
    run([&](int t) { phase_rptt<D, E, 1>(A, B, t); });
    run([&](int t) { phase_gather_f<D, E, 1, 1>(A, B, t); });
  }
  run([&](int t) { phase_rpt<D, E, 2>(A, B, t); });
  run([&](int t) {
    phase_gather_e<D, E, 2>(A, B, t);
    if (A.tw >= 2) phase_rptt<D, E, 0>(A, B, t);
  });
  if (A.tw >= 2) {
    run([&](int t) { phase_gather_f<D, E, 2, 0>(A, B, t); });
    run([&](int t) { phase_rptt<D, E, 1>(A, B, t); });
    run([&](int t) { phase_gather_f<D, E, 2, 1>(A, B, t); });
  }
}

template <int D, typename T, class S, class X>
HD void sweep(const Args<T>& A, Block<T, S>& B, const X& run) {
  run([&](int t) { phase_roe<D>(A, B, t); });
  run([&](int t) { phase_sweep<D>(A, B, t); });
  run([&](int t) { phase_fluct<D>(A, B, t); });
  if (A.tw > 0) {
    constexpr int E1 = D == 0 ? 1 : 0;
    constexpr int E2 = D == 2 ? 1 : 2;
    transverse<D, E1>(A, B, run);
    transverse<D, E2>(A, B, run);
  }
}

template <typename T, class S, class X>
HD void step_block(const Args<T>& A, Block<T, S>& B, const X& run) {
  run([&](int t) { phase_load(A, B, t); });
  sweep<0>(A, B, run);
  sweep<1>(A, B, run);
  sweep<2>(A, B, run);
  run([&](int t) { phase_update(A, B, t); });
  for (int s = NT / 2; s > 0; s >>= 1) {
    run([&](int t) {
      if (t < s) B.RED[t] = mx(B.RED[t], B.RED[t + s]);
    });
  }
}

template <typename T>
Args<T> make_args(const void* qbc, void* qout, void* cflb, int nxg, int nyg,
                  int nzg, double dt, double dx, double dy, double dz,
                  double g1, int order, int tw, const int* lim) {
  using S = Shape<T>;
  Args<T> A;
  A.qbc = static_cast<const T*>(qbc);
  A.qout = static_cast<T*>(qout);
  A.cflb = static_cast<T*>(cflb);
  A.N[0] = nxg;
  A.N[1] = nyg;
  A.N[2] = nzg;
  tile_counts<S>(A.N, A.nb);
  // the plain version's coefficients: Python doubles rounded to T
  const double deltas[3] = {dx, dy, dz};
  for (int d = 0; d < 3; ++d) {
    A.dtd[d] = T(dt / deltas[d]);
    A.half[d] = T(0.5 * (dt / deltas[d]));
    for (int e = 0; e < 3; ++e)
      A.co2[d][e] = T((dt * dt) / (6.0 * deltas[d] * deltas[e]));
  }
  A.g1 = T(g1);
  A.order = order;
  A.tw = tw;
  for (int p = 0; p < 5; ++p) A.lim[p] = lim[p];
  return A;
}

template <typename T> int nblocks(const Args<T>& A) {
  return A.nb[0] * A.nb[1] * A.nb[2];
}

#if defined(__CUDACC__)
struct DeviceRun {
  template <class Fn> __device__ void operator()(Fn&& fn) const {
    fn(static_cast<int>(threadIdx.x));
    __syncthreads();
  }
};

template <typename T>
__global__ void __launch_bounds__(NT, 1) step3_ctu_kernel(Args<T> A) {
  using S = Shape<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Block<T, S> B;
  B.bind(reinterpret_cast<T*>(smem_raw), blockIdx.x);
  tile_origin<S>(A.nb, B.bid, B.C0);
  step_block(A, B, DeviceRun());
  if (threadIdx.x == 0) A.cflb[B.bid] = B.RED[0];
}

template <typename T>
int launch(const void* qbc, void* qout, void* cflb, int nxg, int nyg,
           int nzg, double dt, double dx, double dy, double dz, double g1,
           int order, int tw, const int* lim, void* stream) {
  using L = Lay<T, Shape<T>>;
  // The limit applies to the current device only: set it on every launch.
  cudaError_t err = cudaFuncSetAttribute(
      step3_ctu_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::bytes);
  if (err != cudaSuccess) return (int)err;
  Args<T> A = make_args<T>(qbc, qout, cflb, nxg, nyg, nzg, dt, dx, dy, dz,
                           g1, order, tw, lim);
  step3_ctu_kernel<T><<<nblocks(A), NT, L::bytes,
                        static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}
#else
// Host emulation: the same phases, one block and one "thread" at a time;
// each barrier is kept by running the whole block through a phase before
// the next.  Used by the CPU tests to check the kernel's index algebra
// against the plain version without a card.
struct HostRun {
  template <class Fn> void operator()(Fn&& fn) const {
    for (int t = 0; t < NT; ++t) fn(t);
  }
};

template <typename T>
int launch_host(const void* qbc, void* qout, void* cflb, int nxg, int nyg,
                int nzg, double dt, double dx, double dy, double dz,
                double g1, int order, int tw, const int* lim) {
  using L = Lay<T, Shape<T>>;
  Args<T> A = make_args<T>(qbc, qout, cflb, nxg, nyg, nzg, dt, dx, dy, dz,
                           g1, order, tw, lim);
  std::vector<T> smem(L::elems);
  for (int b = 0; b < nblocks(A); ++b) {
    Block<T, Shape<T>> B;
    B.bind(smem.data(), b);
    tile_origin<Shape<T>>(A.nb, B.bid, B.C0);
    step_block(A, B, HostRun());
    A.cflb[b] = B.RED[0];
  }
  return 0;
}
#endif

}  // namespace

// ---- plain C interface (loaded with ctypes) ----------------------------
extern "C" {

// Number of blocks (= CFL partials) the kernel writes for a padded grid.
int step3_ctu_blocks(int nxg, int nyg, int nzg, int is_double) {
  const int lim[5] = {0, 0, 0, 0, 0};
  if (is_double)
    return nblocks(make_args<double>(nullptr, nullptr, nullptr, nxg, nyg,
                                     nzg, 1, 1, 1, 1, 1, 1, 0, lim));
  return nblocks(make_args<float>(nullptr, nullptr, nullptr, nxg, nyg, nzg,
                                  1, 1, 1, 1, 1, 1, 0, lim));
}

// Shared memory bytes per block (reported by chip_smoke.py).
int step3_ctu_smem_bytes(int is_double) {
  return is_double ? (int)Lay<double, Shape<double>>::bytes
                   : (int)Lay<float, Shape<float>>::bytes;
}

// One CTU step.  qbc: (5, nxg, nyg, nzg) ghost-padded (2 ghost cells),
// qout: (5, nxg-4, nyg-4, nzg-4), cflb: step3_ctu_blocks(...) partial CFL
// maxima; all contiguous, of the type named by the entry.  l0..l4: the
// limiter id of each wave.  Returns a cudaError_t (0 on success).
#if defined(__CUDACC__)
int step3_ctu_f32(const void* qbc, void* qout, void* cflb, int nxg, int nyg,
                  int nzg, double dt, double dx, double dy, double dz,
                  double g1, int order, int tw, int l0, int l1, int l2,
                  int l3, int l4, void* stream) {
  const int lim[5] = {l0, l1, l2, l3, l4};
  return launch<float>(qbc, qout, cflb, nxg, nyg, nzg, dt, dx, dy, dz, g1,
                       order, tw, lim, stream);
}

int step3_ctu_f64(const void* qbc, void* qout, void* cflb, int nxg, int nyg,
                  int nzg, double dt, double dx, double dy, double dz,
                  double g1, int order, int tw, int l0, int l1, int l2,
                  int l3, int l4, void* stream) {
  const int lim[5] = {l0, l1, l2, l3, l4};
  return launch<double>(qbc, qout, cflb, nxg, nyg, nzg, dt, dx, dy, dz, g1,
                        order, tw, lim, stream);
}
#else
int step3_ctu_host_f32(const void* qbc, void* qout, void* cflb, int nxg,
                       int nyg, int nzg, double dt, double dx, double dy,
                       double dz, double g1, int order, int tw, int l0,
                       int l1, int l2, int l3, int l4) {
  const int lim[5] = {l0, l1, l2, l3, l4};
  return launch_host<float>(qbc, qout, cflb, nxg, nyg, nzg, dt, dx, dy, dz,
                            g1, order, tw, lim);
}

int step3_ctu_host_f64(const void* qbc, void* qout, void* cflb, int nxg,
                       int nyg, int nzg, double dt, double dx, double dy,
                       double dz, double g1, int order, int tw, int l0,
                       int l1, int l2, int l3, int l4) {
  const int lim[5] = {l0, l1, l2, l3, l4};
  return launch_host<double>(qbc, qout, cflb, nxg, nyg, nzg, dt, dx, dy, dz,
                             g1, order, tw, lim);
}
#endif

}  // extern "C"
