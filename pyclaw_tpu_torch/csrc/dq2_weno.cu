// dq2_weno.cu — one SharpClaw semidiscrete evaluation of a 2D system with
// componentwise WENO of order 2K-1 = 7, 9, 11, 13, 15 or 17 (Roe
// fluctuations, the per-system flux), one launch per RK stage, for Hopper
// (sm_90a).  The stencil half-width K is a template parameter of the tile,
// the phases and the shared-memory layout; each (system, K, type) is an
// instance of its own: the systems of dq2_systems.cuh (Euler4, the entries
// dq2_weno<order>_*; Acoustics, dq2_weno<order>_acoustics_*; Euler5,
// dq2_weno<order>_euler5_*), in float32 and float64: 36 entries.
//
// Replaces the TPU kernel pyclaw_tpu/ops/tiled2d.py:dq_pallas_rows
// (pallas_call at :415) at weno_order 7-17: its body sharpclaw/soa.py
// _dq_dir_roll takes any odd order (k = (order+1)/2 and
// recon.weno_stencil).  dq2_weno5.cu is the same kernel at order 5 and is
// left as it was (its SASS and bits are the SharpClaw main path's).  It
// computes what pyclaw_tpu_torch/sharpclaw/soa.py:dq_2d_soa computes at
// that order, with the positivity fallback (Euler's; acoustics has none)
// and the flux form of the in-cell fluctuation, which is its plain
// version: held against it on the card (chip_smoke.py [4y]) and, through
// the host emulation at the end of this file, on the CPU
// (tests/test_torch_sharpclaw_kernel.py).
//
// The WENO arithmetic is limiters/recon.py:weno_stencil's, operation for
// operation, and the source is built without FMA contraction
// (ops/_build.py), so each operation rounds as the plain version's PyTorch
// operation does: the betas v^T B_l v over the full K x K form, each term
// (v_a c) v_b added to a sum that starts at 0; float64 weights
// d_l (1/(EPWENO + beta_l)^2), float32 ones from the betas normalised by
// 1/(sum + 1e-30) with eps 1e-6 (not dq2_weno5.cu's float32 rule); a
// Python scalar over a tensor is PyTorch's reciprocal times the scalar.
// The coefficients are weno_tables.cuh's compile-time literals (the
// plain version's float64 tables, each rounded once to the kernel's type),
// so the compiler folds them.
//
// What bounds it on the card: per cell it reads the NEQ values of q and
// writes the NEQ values of dq (32 B a cell for Euler in float32), and
// per component and direction the WENO takes K betas over the full K x K
// form (3K^3 operations), 2K candidate values of K terms and the
// weights: operations bound it.  Bit-equality with the plain version
// fixes that arithmetic (the full form, no contraction, IEEE divisions),
// so every operation issues on its own: chip_smoke.py's bound counts the
// least the function needs (flops_per_cell_dq_weno, the symmetric form),
// its ceiling the kernel's own operations at half the peak
// (issued_ops_per_cell_dq_weno).  At K = 4 in float32 the SASS of one
// component's WENO is ~415 instructions, 292 of them the FMULs and FADDs
// of that arithmetic and most of the rest its 7 IEEE divisions'
// sequences, and the kernel issues close to one instruction a cycle per
// scheduler: there is little left to take at low order but the ring's
// 12.5% and the overhead around the WENO.  At high order the first port
// lost to its registers (float64 spilled and ran one block an SM).
//
// What the design does about it (with the first port's bits; PERF.md
// section 6): nothing but q and dq touches device memory; a block owns a
// 16 x 16 tile of cells, stages q with its K-cell halo in shared memory
// (cp.async), then in four passes (x's tile, x's ghost band, y's tile,
// y's ghost band) computes a direction's edge states of the tile plus a
// 1-cell ring along the sweep, the positivity fallback, the Roe
// fluctuations at the tile's interfaces and that direction's part of dq.
// The WENO is inlined and has one call site, so each instance compiles
// it once.  Per instance (Cfg, timed against each other on the card):
//   - one (component, cell) a thread in the edge phases (N x 288 items,
//     one component's 2K-1 values and K betas live), the fallback a pass
//     per cell after a barrier, one direction's E and F at a time: the
//     float64 instances (no spill, at least two blocks an SM: Euler at K
//     = 9 in 83 KB, the 5-wave system in 103 KB) and float32 Euler at K
//     >= 8, with 256-384 threads;
//   - one cell a thread (its components in turn, the fallback on the
//     states it wrote, no pass), 288 threads: float32 at K <= 7 and
//     acoustics, with both directions' E and F at once (one barrier less a
//     direction) where four blocks still fit an SM.
// The ghost band's cells are solved once each (the first port solved both
// cells of each interface) and only on the sides a block holds, spread
// over the whole block; acoustics' speeds are the constants -c, +c, so
// its band adds nothing to the CFL and is not solved.  Shared memory: N
// (16 + 2K)^2 + ND 2N 288 + ND 2N 272 + 256 N + NT values a block (ND = 1
// or 2 directions' buffers), past 48 KB for most instances, so each sets
// the opt-in attribute before its launches.
//
// The CFL window (sharpclaw/soa.py:_dq_dir_soa) covers the x-interfaces
// K-1 .. nxg-K-1 across the FULL y extent, ghost columns included, and the
// mirror window for y: blocks at the y (x) ends of the grid also solve the
// x- (y-) interfaces of the K-wide ghost band, for the CFL only.
//
// Phases (a barrier between two that share data):
//   load     q tile + K-cell halo -> shared (indices clamped to the padded
//            grid; clamped cells only feed masked-out results, or
//            replicate the last column/row, which is in the CFL window)
//   edges    WENO edge states of a pass's cells (the tile and ring, or a
//            ghost band) -> E; fallback (a pass, or in the same thread)
//   iface    Roe solve at each of the tile's interfaces along D: amdq,
//            apdq -> F; the CFL partial max (a ghost band: its speeds)
//   update   x: its part of dq -> DQ; y: DQ + its part, stored
//   reduce   warp-shuffle max of the CFL partials; one value per block

#include <type_traits>

#include "async_copy.cuh"
#include "dq2_systems.cuh"
#include "dt_coef.cuh"
#include "euler2d.cuh"
#include "weno_tables.cuh"

namespace {

// ---- WENO of order 2K-1 (limiters/recon.py:weno_stencil) --------------
template <typename T> struct Edges {
  T ql, qr;
};

template <typename T> struct Eps;
template <> struct Eps<double> {
  static constexpr double v = 1e-36;   // EPWENO
};
template <> struct Eps<float> {
  static constexpr float v = float(1e-6);   // the Python float, rounded
};

// the betas normalised by 1 / (their sum + 1e-30) in float32; float64
// keeps them
template <int K> HD void normalise_betas(double (&)[K]) {}
template <int K> HD void normalise_betas(float (&beta)[K]) {
  float s = 0.0f;
#pragma unroll
  for (int l = 0; l < K; ++l) s = s + beta[l];
  const float r = 1.0f / (s + float(1e-30));
#pragma unroll
  for (int l = 0; l < K; ++l) beta[l] = beta[l] * r;
}

// one edge: sum_l alpha_l p_l / sum_l alpha_l over the candidate stencils
template <int K, bool RIGHT, typename T>
HD T weno_edge(const T (&v)[2 * K - 1], const T (&beta)[K]) {
  using W = WenoTables<K>;
  T num = T(0), den = T(0);
#pragma unroll
  for (int l = 0; l < K; ++l) {
    T p = T(0);
#pragma unroll
    for (int j = 0; j < K; ++j)
      p = p + v[l + j] * T(RIGHT ? W::cr(l * K + j) : W::cl(l * K + j));
    const T e = beta[l] + Eps<T>::v;
    const T alpha = (T(1) / (e * e)) * T(RIGHT ? W::dr(l) : W::dl(l));
    num = num + alpha * p;
    den = den + alpha;
  }
  return num / den;
}

// the edge values of one cell of one component: its 2K-1 values at
// v[0], v[stride], ... (the staged tile), centred at v[(K-1) stride]
template <int K, typename T>
HD Edges<T> weno_edges(const T* v0, int stride) {
  using W = WenoTables<K>;
  T v[2 * K - 1];
#pragma unroll
  for (int m = 0; m < 2 * K - 1; ++m) v[m] = v0[m * stride];
  T beta[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    T b = T(0);
#pragma unroll
    for (int a = 0; a < K; ++a) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const double coef = W::b((l * K + a) * K + c);
        if (coef != 0.0) b = b + (v[l + a] * T(coef)) * v[l + c];
      }
    }
    beta[l] = b;
  }
  normalise_betas<K>(beta);
  Edges<T> out;
  out.qr = weno_edge<K, true>(v, beta);
  out.ql = weno_edge<K, false>(v, beta);
  return out;
}

// ---- block geometry and shared-memory layout --------------------------
// A block owns a TX x TY tile of cells (TX rows along x, TY columns along
// y) and runs NT threads.  Per direction D (0: x, 1: y) its edge states
// cover the tile plus a 1-cell ring along D (ER x EC cells), its
// interfaces the tile's FR x FC faces normal to D (Dir<K, D>); L is the
// tile's length along D, LA across it.
template <int K> struct Geo {
  static constexpr int TX = 16, TY = 16;
  static constexpr int QR = TX + 2 * K, QC = TY + 2 * K;   // q tile + halo
  static constexpr int EN = (TX + 2) * TY > TX * (TY + 2) ? (TX + 2) * TY
                                                        : TX * (TY + 2);
  static constexpr int FN = (TX + 1) * TY > TX * (TY + 1) ? (TX + 1) * TY
                                                        : TX * (TY + 1);
  // the ghost band's edge states (both sides: 2K lines of L + 2 cells),
  // kept where E and F lie once a direction's update is done
  static constexpr int GN = 2 * K * ((TX > TY ? TX : TY) + 2);
};

template <int K, int D> struct Dir {
  using G = Geo<K>;
  static constexpr int ER = D == 0 ? G::TX + 2 : G::TX;
  static constexpr int EC = D == 0 ? G::TY : G::TY + 2;
  static constexpr int FR = D == 0 ? G::TX + 1 : G::TX;
  static constexpr int FC = D == 0 ? G::TY : G::TY + 1;
  static constexpr int L = D == 0 ? G::TX : G::TY;
  static constexpr int LA = D == 0 ? G::TY : G::TX;
};

// The launch configuration of an instance, chosen by timing the choices
// against each other on the card (PERF.md section 6): the threads
// a block (NT) and the resident blocks an SM that the launch bounds ask
// the register allocation for (MIN_BLOCKS); CELLS: one cell a thread in
// the edge phases, its components in turn and the fallback on the states
// it wrote (else one (component, cell) a thread and a fallback pass);
// BOTH: both directions' E and F at once (else one direction at a time in
// one E and F).
//   float32: 288 threads (the 288 cells of a direction's edge region), 4
//     blocks, CELLS, BOTH where four blocks of that layout fit the SM's
//     228 KB; the Euler systems at K >= 8 (a WENO of many live values):
//     384 threads, 3 blocks, one (component, cell) a thread.
//   float64: one (component, cell) a thread, one direction at a time,
//     and the threads that fill the SM within its registers and shared
//     memory without a spill: acoustics and K = 9 256 threads, 2 blocks
//     (128 registers; acoustics at K = 6 3 blocks, 80); K = 8 320, 2
//     (96); Euler 5-wave 384, 2 (80; its shared memory holds two
//     blocks); Euler 4-wave 256, 3 (80).
template <typename S, int K, typename T> struct Cfg {
  using G = Geo<K>;
  static constexpr int N = S::NEQ;
  static constexpr bool F64 = sizeof(T) == 8;
  static constexpr bool ACOUSTICS = std::is_same<S, Acoustics>::value;
  static constexpr bool WIDE = !F64 && !ACOUSTICS && K >= 8;
  static constexpr int NT =
      !F64 ? (WIDE ? 384 : 288)
           : (ACOUSTICS || K == 9)
                 ? 256
                 : (K == 8 ? 320
                           : (std::is_same<S, Euler5>::value ? 384 : 256));
  static constexpr int MIN_BLOCKS =
      !F64 ? (WIDE ? 3 : 4)
           : ((!ACOUSTICS && K < 8 && !std::is_same<S, Euler5>::value) ||
              (ACOUSTICS && K == 6))
                 ? 3
                 : 2;
  static constexpr bool CELLS = !F64 && !WIDE;
  // the shared memory of a block with both directions' buffers
  static constexpr size_t BOTH_BYTES =
      (N * G::QR * G::QC + 4 * N * G::EN + 4 * N * G::FN +
       N * G::TX * G::TY + NT) * sizeof(T);
  static constexpr bool BOTH = CELLS && 4 * (BOTH_BYTES + 1024) <= 233472;
};

// whether the system's edge states fall back to the cell average where
// they are not admissible (Euler's positivity; acoustics has none), and
// whether its wave speeds depend on the states (acoustics' are the
// constants -c, +c: its ghost band's interfaces give the CFL the value
// that every interface of the tile gives it, so the band is not solved)
template <typename S> struct Fallback {
  static constexpr bool value = !std::is_same<S, Acoustics>::value;
};
template <typename S> struct StateSpeeds {
  static constexpr bool value = !std::is_same<S, Acoustics>::value;
};

template <typename S, int K, typename T> struct Layout {
  // Q [NEQ][QR][QC]; E [ND][2 NEQ][EN] (ql 0..NEQ-1, then qr) and F
  // [ND][2 NEQ][FN] (amdq, then apdq) of the ND = 1 or 2 directions in
  // hand, then the ghost band's edge states [2 NEQ][GN] from E on; DQ
  // [NEQ][TX*TY] (the x part of dq); R [NT] (CFL partials)
  using G = Geo<K>;
  static constexpr int N = S::NEQ, ND = Cfg<S, K, T>::BOTH ? 2 : 1;
  static_assert(G::GN <= (ND == 2 ? 2 * G::EN : G::EN + G::FN),
                "the ghost band fits from E on");
  static constexpr size_t elems = N * G::QR * G::QC + ND * 2 * N * G::EN +
                                  ND * 2 * N * G::FN + N * G::TX * G::TY +
                                  Cfg<S, K, T>::NT;
  static constexpr size_t bytes = elems * sizeof(T);
};

template <typename S, typename T> struct Args {
  const T* qbc;
  T* dq;
  T* cflb;
  int NX, NY;            // padded (ghost-extended) extents
  const double* dt;      // the step (dt_coef.cuh)
  T dx, dy;
  typename S::template Par<T> P;   // the system's physics scalars
  T* C;                  // the block's coefficients of dt (shared memory)
};

// The coefficients of dt in Args::C: dt/dx, dt/dy, -dt/dx, -dt/dy in T
enum { C_DTDX = 0, C_DTDY = 1, C_NDTDX = 2, C_NDTDY = 3, NCOEF = 4 };

template <typename S, typename T> HD T dt_coef(const Args<S, T>& A, int k) {
  const T q = T(*A.dt) / (k % 2 == 0 ? A.dx : A.dy);
  return k < C_NDTDX ? q : -q;
}

template <typename S, int K, typename T> struct Block {
  using G = Geo<K>;
  static constexpr int N = S::NEQ;
  T* Q;
  T* E0;     // edge states along x (the ghost band's from E0 on)
  T* E1;     // along y (E0 when not BOTH)
  T* F0;     // fluctuations at the x-interfaces
  T* F1;     // at the y-interfaces (F0 when not BOTH)
  T* DQ;
  T* R;
  int I0, J0, bx, by, nbx, nby;  // first interior cell (padded indices)

  HD void bind(T* s, int bx_, int by_, int nbx_, int nby_) {
    Q = s;
    constexpr int ND = Layout<S, K, T>::ND;
    E0 = Q + N * G::QR * G::QC;
    E1 = E0 + (ND - 1) * 2 * N * G::EN;
    F0 = E0 + ND * 2 * N * G::EN;
    F1 = F0 + (ND - 1) * 2 * N * G::FN;
    DQ = F0 + ND * 2 * N * G::FN;
    R = DQ + N * G::TX * G::TY;
    bx = bx_;
    by = by_;
    nbx = nbx_;
    nby = nby_;
    I0 = K + by * G::TX;
    J0 = K + bx * G::TY;
  }
  HD T* e_of(int D) const { return D == 0 ? E0 : E1; }
  HD T* f_of(int D) const { return D == 0 ? F0 : F1; }
  HD const T* at(int e, int r, int c) const {
    return Q + (e * G::QR + r) * G::QC + c;
  }
  // whether the block holds the low / high ghost band across D (x: the
  // columns 0..K-1 / nyg-K..nyg-1), and how many of the two
  template <int D> HD bool lo() const { return D == 0 ? bx == 0 : by == 0; }
  template <int D> HD bool hi() const {
    return D == 0 ? bx == nbx - 1 : by == nby - 1;
  }
  template <int D> HD int sides() const { return int(lo<D>()) + int(hi<D>()); }
  HD int sides(int D) const { return D == 0 ? sides<0>() : sides<1>(); }
};

// ---- phase: stage q tile + halo ----------------------------------------
template <typename S, int K, typename T>
HD void phase_load(const Args<S, T>& A, Block<S, K, T>& B, int tid) {
  constexpr int QR = Geo<K>::QR, QC = Geo<K>::QC, NT = Cfg<S, K, T>::NT;
  for (int idx = tid; idx < S::NEQ * QR * QC; idx += NT) {
    int e = idx / (QR * QC);
    int r = (idx / QC) % QR;
    int c = idx % QC;
    int I = B.I0 - K + r, J = B.J0 - K + c;
    I = I < A.NX ? I : A.NX - 1;
    J = J < A.NY ? J : A.NY - 1;
    copy_async(B.Q + idx, A.qbc + ((long long)e * A.NX + I) * A.NY + J);
  }
  B.R[tid] = T(0);
  if (tid < NCOEF) A.C[tid] = dt_coef(A, tid);
  copy_wait_all();
}

// The cells whose edge states a pass computes, each a staged (row, col).
// A pass is a direction D (0: x, 1: y) and a region, both known at run
// time, so that the kernel has one WENO call site: the tile plus its
// 1-cell ring along D (ghost false; cell i = (r, c) of ER x EC), or the
// ghost band across D at the sides the block holds (ghost true): K lines
// a side, the L + 2 cells of a line those of the tile's interfaces along
// D.
template <typename S, int K, typename T>
HD int region_cells(const Block<S, K, T>& B, int D, bool ghost) {
  using D0 = Dir<K, 0>;
  using D1 = Dir<K, 1>;
  if (ghost)
    return (D == 0 ? B.template sides<0>() * (D0::L + 2)
                   : B.template sides<1>() * (D1::L + 2)) * K;
  return D == 0 ? D0::ER * D0::EC : D1::ER * D1::EC;
}

// staged (row, col) of cell i of direction D's tile region
template <int D, int K> HD void tile_cell(int i, int& row, int& col) {
  // x: cell (I0-1+r, J0+c) = staged (r+K-1, c+K); y: (I0+r, J0-1+c)
  const int r = i / Dir<K, D>::EC, c = i % Dir<K, D>::EC;
  row = D == 0 ? r + K - 1 : r + K;
  col = D == 0 ? c + K : c + K - 1;
}

template <typename S, int K, typename T>
HD void region_cell(const Block<S, K, T>& B, int D, bool ghost, int i,
                    int& row, int& col) {
  using D0 = Dir<K, 0>;
  using D1 = Dir<K, 1>;
  if (!ghost) {
    if (D == 0)
      tile_cell<0, K>(i, row, col);
    else
      tile_cell<1, K>(i, row, col);
    return;
  }
  const int per_line = (D == 0 ? D0::L : D1::L) + 2;
  const int line = i / per_line, k = i % per_line;
  // the lines of the low side first, when the block holds it; staged
  // across D: 0..K-1 below the tile, LA+K.. above
  const bool low = (D == 0 ? B.template lo<0>() : B.template lo<1>()) &&
                   line < K;
  const int across = low ? line : (D == 0 ? D0::LA : D1::LA) + K + line % K;
  const int along = k + K - 1;   // cells I0-1+k (x) or J0-1+k (y)
  row = D == 0 ? along : across;
  col = D == 0 ? across : along;
}

// Where the WENO edge states of cell i of a pass's region (in E, planes
// of en values) are not both admissible, both take the cell average
template <typename S, int K, typename T>
HD void fall_back(const Args<S, T>& A, const Block<S, K, T>& B, T* E,
                  int en, int D, bool ghost, int i) {
  constexpr int N = S::NEQ;
  T ql[N], qr[N];
  for (int e = 0; e < N; ++e) {
    ql[e] = E[e * en + i];
    qr[e] = E[(N + e) * en + i];
  }
  if (S::admissible(A.P, ql) && S::admissible(A.P, qr)) return;
  int row, col;
  region_cell(B, D, ghost, i, row, col);
  for (int e = 0; e < N; ++e) {
    const T q = *B.at(e, row, col);
    E[e * en + i] = q;
    E[(N + e) * en + i] = q;
  }
}

// ---- phase: WENO edge states, one (component, cell) a thread -----------
// (item idx = e nc + i; the tile's index algebra with constant divisors)
template <typename S, int K, typename T>
HD void phase_edges(const Args<S, T>&, Block<S, K, T>& B, int tid, int D,
                    bool ghost) {
  using G = Geo<K>;
  constexpr int N = S::NEQ, NT = Cfg<S, K, T>::NT;
  constexpr int NC0 = Dir<K, 0>::ER * Dir<K, 0>::EC;
  constexpr int NC1 = Dir<K, 1>::ER * Dir<K, 1>::EC;
  const int en = ghost ? G::GN : G::EN;
  T* const E = ghost ? B.E0 : B.e_of(D);
  const int nc = region_cells(B, D, ghost);
  for (int idx = tid; idx < N * nc; idx += NT) {
    int e, i, row, col;
    if (ghost) {
      e = idx / nc;
      i = idx - e * nc;
      region_cell(B, D, true, i, row, col);
    } else if (D == 0) {
      e = idx / NC0;
      i = idx - e * NC0;
      tile_cell<0, K>(i, row, col);
    } else {
      e = idx / NC1;
      i = idx - e * NC1;
      tile_cell<1, K>(i, row, col);
    }
    // the 2K-1 values along D centred at the cell
    const Edges<T> ed = weno_edges<K, T>(
        D == 0 ? B.at(e, row - (K - 1), col) : B.at(e, row, col - (K - 1)),
        D == 0 ? G::QC : 1);
    E[e * en + i] = ed.ql;
    E[(N + e) * en + i] = ed.qr;
  }
}

// ---- phase: the same with one cell a thread (Cfg::CELLS): its N
// components' WENO in turn, then the fallback on the states it wrote
template <typename S, int K, typename T>
HD void phase_edges_cells(const Args<S, T>& A, Block<S, K, T>& B, int tid,
                          int D, bool ghost) {
  using G = Geo<K>;
  constexpr int N = S::NEQ, NT = Cfg<S, K, T>::NT;
  const int en = ghost ? G::GN : G::EN;
  T* const E = ghost ? B.E0 : B.e_of(D);
  const int nc = region_cells(B, D, ghost);
  for (int i = tid; i < nc; i += NT) {
    int row, col;
    region_cell(B, D, ghost, i, row, col);
    const T* v = D == 0 ? B.at(0, row - (K - 1), col)
                        : B.at(0, row, col - (K - 1));
#pragma unroll 1
    for (int e = 0; e < N; ++e) {
      const Edges<T> ed =
          weno_edges<K, T>(v + e * G::QR * G::QC, D == 0 ? G::QC : 1);
      E[e * en + i] = ed.ql;
      E[(N + e) * en + i] = ed.qr;
    }
    if (Fallback<S>::value) fall_back(A, B, E, en, D, ghost, i);
  }
}

// ---- phase: the positivity fallback to the cell average, one cell a
// thread (sharpclaw/soa.py:_dq_dir_soa) ------------------------------------
template <typename S, int K, typename T>
HD void phase_fallback(const Args<S, T>& A, Block<S, K, T>& B, int tid,
                       int D, bool ghost) {
  const int en = ghost ? Geo<K>::GN : Geo<K>::EN;
  T* const E = ghost ? B.E0 : B.e_of(D);
  const int nc = region_cells(B, D, ghost);
  for (int i = tid; i < nc; i += Cfg<S, K, T>::NT)
    fall_back(A, B, E, en, D, ghost, i);
}

template <int NW, typename T> HD T speed_max(const T s[NW], T dtdx) {
  T m = dtdx * fabs_(s[0]);
  for (int p = 1; p < NW; ++p) m = mx(m, dtdx * fabs_(s[p]));
  return m;
}

// ---- phase: Roe solves at the tile's interfaces along D, and the CFL ---
template <int D, typename S, int K, typename T>
HD void phase_iface(const Args<S, T>& A, Block<S, K, T>& B, int tid) {
  using G = Geo<K>;
  constexpr int N = S::NEQ, NW = S::NW, NT = Cfg<S, K, T>::NT;
  constexpr int FC = Dir<K, D>::FC, EC = Dir<K, D>::EC;
  constexpr int EN = G::EN, FN = G::FN;
  const T dtdx = A.C[D == 0 ? C_DTDX : C_DTDY];
  T* const E = B.e_of(D);
  T* const F = B.f_of(D);
  T smax = B.R[tid];
  for (int idx = tid; idx < Dir<K, D>::FR * FC; idx += NT) {
    int r = idx / FC, c = idx % FC;
    // interface between E cells (r, c) and x: (r+1, c), y: (r, c+1)
    int el = r * EC + c;
    int er = D == 0 ? el + EC : el + 1;
    T ql[N], qr[N];
    for (int e = 0; e < N; ++e) {
      ql[e] = E[(N + e) * EN + el];   // qr of the left cell
      qr[e] = E[e * EN + er];         // ql of the right cell
    }
    T w[NW][N], s[NW];
    S::template waves<D>(A.P, ql, qr, w, s);
    for (int e = 0; e < N; ++e) {
      // the sums over the waves that have component e, in wave order
      T m = T(0), pp = T(0);
      bool first = true;
      for (int p = 0; p < NW; ++p) {
        if (!S::template nz<D>(p, e)) continue;
        T am_t = mn(s[p], T(0)) * w[p][e];
        T ap_t = mx(s[p], T(0)) * w[p][e];
        m = first ? am_t : m + am_t;
        pp = first ? ap_t : pp + ap_t;
        first = false;
      }
      F[e * FN + idx] = m;
      F[(N + e) * FN + idx] = pp;
    }
    // x-interface k = I0-1+r (y: j = J0-1+c) is in the window up to
    // nxg-K-1
    bool in_cfl = D == 0 ? B.I0 - 1 + r <= A.NX - K - 1
                         : B.J0 - 1 + c <= A.NY - K - 1;
    if (in_cfl) smax = mx(smax, speed_max<NW>(s, dtdx));
  }
  B.R[tid] = smax;
}

// ---- phase: the ghost band's interfaces along D, for the CFL only ------
// (the edge states of the ghost pass, fallback applied): L + 1
// interfaces a line, in the window as the tile's
template <int D, typename S, int K, typename T>
HD void phase_ghost_cfl(const Args<S, T>& A, Block<S, K, T>& B, int tid) {
  using G = Geo<K>;
  constexpr int N = S::NEQ, NW = S::NW, NT = Cfg<S, K, T>::NT;
  constexpr int NI = Dir<K, D>::L + 1, GN = G::GN;
  const T dtdx = A.C[D == 0 ? C_DTDX : C_DTDY];
  const T* const E = B.E0;
  T smax = B.R[tid];
  const int n = B.template sides<D>() * K * NI;
  for (int idx = tid; idx < n; idx += NT) {
    const int line = idx / NI, k = idx % NI;
    bool in_cfl = D == 0 ? B.I0 - 1 + k <= A.NX - K - 1
                         : B.J0 - 1 + k <= A.NY - K - 1;
    if (!in_cfl) continue;
    // cells k and k + 1 of the line
    const int il = line * (NI + 1) + k;
    T ql[N], qr[N];
    for (int e = 0; e < N; ++e) {
      ql[e] = E[(N + e) * GN + il];      // qr of the left cell
      qr[e] = E[e * GN + il + 1];        // ql of the right cell
    }
    T s[NW];
    S::template speeds<D>(A.P, ql, qr, s);
    smax = mx(smax, speed_max<NW>(s, dtdx));
  }
  B.R[tid] = smax;
}

// ---- phase: one direction's part of dq --------------------------------
// x: DQ = -dt/dx (apdq_{I-1} + amdq_I + f(qr_I) - f(ql_I));
// y: dq = DQ + -dt/dy (...), stored to device memory (masked)
template <int D, typename S, int K, typename T>
HD void phase_update(const Args<S, T>& A, Block<S, K, T>& B, int tid) {
  using G = Geo<K>;
  constexpr int N = S::NEQ, NT = Cfg<S, K, T>::NT, TX = G::TX, TY = G::TY;
  constexpr int FC = Dir<K, D>::FC, EC = Dir<K, D>::EC;
  constexpr int EN = G::EN, FN = G::FN;
  const T ndt = A.C[D == 0 ? C_NDTDX : C_NDTDY];
  const T* const E = B.e_of(D);
  const T* const F = B.f_of(D);
  const int nx = A.NX - 2 * K, ny = A.NY - 2 * K;
  for (int idx = tid; idx < TX * TY; idx += NT) {
    int ti = idx / TY, tj = idx % TY;
    int I = B.I0 + ti, J = B.J0 + tj;
    // interfaces below / above the cell; the cell's own edge states
    int f_lo = ti * FC + tj;
    int f_hi = D == 0 ? f_lo + FC : f_lo + 1;
    int ec = D == 0 ? (ti + 1) * EC + tj : ti * EC + tj + 1;
    T ql[N], qr[N], fl[N], fr[N];
    for (int e = 0; e < N; ++e) {
      ql[e] = E[e * EN + ec];
      qr[e] = E[(N + e) * EN + ec];
    }
    S::template flux<D>(A.P, ql, fl);
    S::template flux<D>(A.P, qr, fr);
    if (D == 1 && (I >= A.NX - K || J >= A.NY - K)) continue;
    for (int e = 0; e < N; ++e) {
      T part = ndt * (F[(N + e) * FN + f_lo] + F[e * FN + f_hi]
                      + (fr[e] - fl[e]));
      if (D == 0) {
        B.DQ[e * TX * TY + idx] = part;
      } else {
        A.dq[((long long)e * nx + (I - K)) * ny + (J - K)] =
            B.DQ[e * TX * TY + idx] + part;
      }
    }
  }
}

// the block's CFL partial from the per-warp maxima in R[0 .. NT/32)
template <typename S, int K, typename T>
HD void phase_write_cfl(const Args<S, T>& A, Block<S, K, T>& B, int tid) {
  if (tid != 0) return;
  T c = B.R[0];
  for (int w = 1; w < Cfg<S, K, T>::NT / 32; ++w) c = mx(c, B.R[w]);
  A.cflb[B.by * B.nbx + B.bx] = c;
}

template <typename S, typename T>
Args<S, T> make_args(const void* qbc, void* dq, void* cflb, int nxg, int nyg,
                     const double* dt, double dx, double dy, double p0,
                     double p1) {
  Args<S, T> A;
  A.qbc = static_cast<const T*>(qbc);
  A.dq = static_cast<T*>(dq);
  A.cflb = static_cast<T*>(cflb);
  A.NX = nxg;
  A.NY = nyg;
  A.dt = dt;
  A.dx = T(dx);
  A.dy = T(dy);
  A.C = nullptr;
  A.P = S::template make_par<T>(p0, p1);
  return A;
}

template <int K> void grid_of(int nxg, int nyg, int& nbx, int& nby) {
  nbx = (nyg - 2 * K + Geo<K>::TY - 1) / Geo<K>::TY;
  nby = (nxg - 2 * K + Geo<K>::TX - 1) / Geo<K>::TX;
}

#if defined(__CUDACC__)
template <typename S, int K, typename T>
__global__ void __launch_bounds__(Cfg<S, K, T>::NT, Cfg<S, K, T>::MIN_BLOCKS)
    dq2_weno_kernel(Args<S, T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T coef[NCOEF];
  A.C = coef;
  Block<S, K, T> B;
  B.bind(reinterpret_cast<T*>(smem_raw), blockIdx.x, blockIdx.y, gridDim.x,
         gridDim.y);
  const int tid = threadIdx.x;
  using C = Cfg<S, K, T>;
  phase_load<S, K, T>(A, B, tid);
  // Four passes: x's tile (edge states and fallback, interfaces, its part
  // of dq), x's ghost band (edge states and fallback, CFL) at a block
  // that holds one, then y's; with BOTH, both tiles' edge states in one
  // phase, their interfaces in the next and their parts of dq in a third,
  // then the ghost bands.  A barrier between two phases that share data;
  // the edge states have one call site, so each instance compiles the
  // WENO once.
#pragma unroll 1
  for (int pass = 0; pass < 4; ++pass) {
    const int D = C::BOTH ? pass % 2 : pass / 2;
    const bool ghost = C::BOTH ? pass >= 2 : pass % 2 == 1;
    // the whole block skips a ghost band it does not hold
    if (ghost && (!StateSpeeds<S>::value || B.sides(D) == 0)) continue;
    if (!(C::BOTH && pass == 1)) __syncthreads();
    if constexpr (C::CELLS) {
      phase_edges_cells(A, B, tid, D, ghost);
    } else {
      phase_edges(A, B, tid, D, ghost);
      if (Fallback<S>::value) {
        __syncthreads();
        phase_fallback(A, B, tid, D, ghost);
      }
    }
    if (C::BOTH && pass == 0) continue;   // y's tile follows at once
    __syncthreads();
    if (ghost) {
      if (D == 0)
        phase_ghost_cfl<0>(A, B, tid);
      else
        phase_ghost_cfl<1>(A, B, tid);
      continue;
    }
    if (C::BOTH || D == 0) phase_iface<0>(A, B, tid);
    if (C::BOTH || D == 1) phase_iface<1>(A, B, tid);
    __syncthreads();
    // a thread owns the same cells in both parts of dq
    if (C::BOTH || D == 0) phase_update<0>(A, B, tid);
    if (C::BOTH || D == 1) phase_update<1>(A, B, tid);
  }
  // the CFL partial: a warp-shuffle max, then one slot per warp
  const T m = warp_max(B.R[tid]);
  __syncthreads();
  if (tid % 32 == 0) B.R[tid / 32] = m;
  __syncthreads();
  phase_write_cfl<S, K, T>(A, B, tid);
}

// the devices whose shared-memory attribute of the instance is set
template <typename S, int K, typename T> unsigned long long attr_done = 0;

template <typename S, int K, typename T> cudaError_t set_smem() {
  return smem_attr_once(
      reinterpret_cast<const void*>(dq2_weno_kernel<S, K, T>),
      (int)Layout<S, K, T>::bytes, attr_done<S, K, T>);
}

template <typename S, int K, typename T>
int launch(const void* qbc, void* dq, void* cflb, int nxg, int nyg,
           const double* dt, double dx, double dy, double p0, double p1,
           void* stream) {
  cudaError_t err = set_smem<S, K, T>();
  if (err != cudaSuccess) return (int)err;
  int nbx, nby;
  grid_of<K>(nxg, nyg, nbx, nby);
  Args<S, T> A = make_args<S, T>(qbc, dq, cflb, nxg, nyg, dt, dx, dy, p0, p1);
  dq2_weno_kernel<S, K, T><<<dim3(nbx, nby), Cfg<S, K, T>::NT,
                             Layout<S, K, T>::bytes,
                             static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

template <typename S, int K, typename T> int blocks_per_sm() {
  int per = 0;
  if (set_smem<S, K, T>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, dq2_weno_kernel<S, K, T>, Cfg<S, K, T>::NT,
          Layout<S, K, T>::bytes) != cudaSuccess)
    return -1;
  return per;
}
#else
// Host emulation: the same phases, one block and one "thread" at a time,
// with each barrier between two phases kept by running the whole block
// through a phase before the next.  Used by the CPU tests to check the
// kernel's index algebra against the plain version without a card.
template <typename S, int K, typename T>
int launch_host(const void* qbc, void* dq, void* cflb, int nxg, int nyg,
                const double* dt, double dx, double dy, double p0,
                double p1) {
  constexpr int NT = Cfg<S, K, T>::NT;
  int nbx, nby;
  grid_of<K>(nxg, nyg, nbx, nby);
  Args<S, T> A = make_args<S, T>(qbc, dq, cflb, nxg, nyg, dt, dx, dy, p0, p1);
  std::vector<T> smem(Layout<S, K, T>::elems);
  T coef[NCOEF];
  A.C = coef;
  using C = Cfg<S, K, T>;
  for (int by = 0; by < nby; ++by) {
    for (int bx = 0; bx < nbx; ++bx) {
      Block<S, K, T> B;
      B.bind(smem.data(), bx, by, nbx, nby);
      for (int t = 0; t < NT; ++t) phase_load<S, K, T>(A, B, t);
      for (int pass = 0; pass < 4; ++pass) {
        const int D = C::BOTH ? pass % 2 : pass / 2;
        const bool ghost = C::BOTH ? pass >= 2 : pass % 2 == 1;
        if (ghost && (!StateSpeeds<S>::value || B.sides(D) == 0)) continue;
        for (int t = 0; t < NT; ++t) {
          if constexpr (C::CELLS)
            phase_edges_cells(A, B, t, D, ghost);
          else
            phase_edges(A, B, t, D, ghost);
        }
        if (!C::CELLS && Fallback<S>::value)
          for (int t = 0; t < NT; ++t) phase_fallback(A, B, t, D, ghost);
        if (C::BOTH && pass == 0) continue;
        for (int t = 0; t < NT; ++t) {
          if (ghost && D == 0) phase_ghost_cfl<0>(A, B, t);
          if (ghost && D == 1) phase_ghost_cfl<1>(A, B, t);
          if (!ghost && (C::BOTH || D == 0)) phase_iface<0>(A, B, t);
          if (!ghost && (C::BOTH || D == 1)) phase_iface<1>(A, B, t);
        }
        if (ghost) continue;
        for (int t = 0; t < NT; ++t) {
          if (C::BOTH || D == 0) phase_update<0>(A, B, t);
          if (C::BOTH || D == 1) phase_update<1>(A, B, t);
        }
      }
      // the warp max as a loop over the lanes (R[t / 32] is written only
      // after thread t / 32's own value has been read)
      for (int t = 0; t < NT; ++t)
        B.R[t / 32] = t % 32 == 0 ? B.R[t] : mx(B.R[t / 32], B.R[t]);
      phase_write_cfl<S, K, T>(A, B, 0);
    }
  }
  return 0;
}
#endif

// the (system, K) of a system id (0 Euler4, 1 Acoustics, 2 Euler5) and an
// order: F<S, K>() for each, -1 for another
template <template <typename, int> class F>
int dispatch(int sys, int order) {
#define DQ2_ORDER(S)                             \
  switch (order) {                               \
    case 7: return F<S, 4>::call();              \
    case 9: return F<S, 5>::call();              \
    case 11: return F<S, 6>::call();             \
    case 13: return F<S, 7>::call();             \
    case 15: return F<S, 8>::call();             \
    case 17: return F<S, 9>::call();             \
    default: return -1;                          \
  }
  switch (sys) {
    case 0: DQ2_ORDER(Euler4)
    case 1: DQ2_ORDER(Acoustics)
    case 2: DQ2_ORDER(Euler5)
    default: return -1;
  }
#undef DQ2_ORDER
}

template <typename S, int K> struct SmemF32 {
  static int call() { return (int)Layout<S, K, float>::bytes; }
};
template <typename S, int K> struct SmemF64 {
  static int call() { return (int)Layout<S, K, double>::bytes; }
};
template <typename S, int K> struct ThreadsF32 {
  static int call() { return Cfg<S, K, float>::NT; }
};
template <typename S, int K> struct ThreadsF64 {
  static int call() { return Cfg<S, K, double>::NT; }
};
#if defined(__CUDACC__)
template <typename S, int K> struct BpsF32 {
  static int call() { return blocks_per_sm<S, K, float>(); }
};
template <typename S, int K> struct BpsF64 {
  static int call() { return blocks_per_sm<S, K, double>(); }
};
#endif

}  // namespace

// ---- plain C interface (loaded with ctypes) ----------------------------
extern "C" {

// Number of blocks (= CFL partials) the kernel writes for a padded grid
// with K = (order + 1) / 2 ghost cells (any system and type), or -1 for
// another order.
int dq2_weno_blocks(int nxg, int nyg, int order) {
  int nbx = 0, nby = 0;
  switch (order) {
    case 7: grid_of<4>(nxg, nyg, nbx, nby); break;
    case 9: grid_of<5>(nxg, nyg, nbx, nby); break;
    case 11: grid_of<6>(nxg, nyg, nbx, nby); break;
    case 13: grid_of<7>(nxg, nyg, nbx, nby); break;
    case 15: grid_of<8>(nxg, nyg, nbx, nby); break;
    case 17: grid_of<9>(nxg, nyg, nbx, nby); break;
    default: return -1;
  }
  return nbx * nby;
}

// Shared memory bytes per block of the instance of system id sys (0 Euler
// 4-wave, 1 acoustics, 2 Euler 5-wave) and order, or -1.
int dq2_weno_smem_bytes(int sys, int order, int is_double) {
  return is_double ? dispatch<SmemF64>(sys, order)
                   : dispatch<SmemF32>(sys, order);
}

// Threads a block of the instance, or -1.
int dq2_weno_threads(int sys, int order, int is_double) {
  return is_double ? dispatch<ThreadsF64>(sys, order)
                   : dispatch<ThreadsF32>(sys, order);
}

#if defined(__CUDACC__)
// Resident blocks per SM of an instance on the current device, or -1.
int dq2_weno_blocks_per_sm(int sys, int order, int is_double) {
  return is_double ? dispatch<BpsF64>(sys, order)
                   : dispatch<BpsF32>(sys, order);
}
#endif

// One SharpClaw dq.  qbc: (NEQ, nxg, nyg) ghost-padded (K = (order+1)/2
// ghost cells), dq: (NEQ, nxg-2K, nyg-2K), cflb: dq2_weno_blocks(...)
// partial CFL maxima; all contiguous, of the type named by the entry.  dt:
// the step in device memory (host memory for the host emulation), a double
// that is exact in the entry's type.  The Euler entries take g1 = gamma -
// 1, the acoustics entries the impedance zz and the sound speed cc.
// Returns a cudaError_t (0 on success).
#if defined(__CUDACC__)
#define DQ2_EULER(NAME, S, K, T)                                            \
  int NAME(const void* qbc, void* dq, void* cflb, int nxg, int nyg,         \
           const double* dt, double dx, double dy, double g1,               \
           void* stream) {                                                  \
    return launch<S, K, T>(qbc, dq, cflb, nxg, nyg, dt, dx, dy, g1, 0.0,    \
                           stream);                                         \
  }
#define DQ2_ACOUSTICS(NAME, K, T)                                           \
  int NAME(const void* qbc, void* dq, void* cflb, int nxg, int nyg,         \
           const double* dt, double dx, double dy, double zz, double cc,    \
           void* stream) {                                                  \
    return launch<Acoustics, K, T>(qbc, dq, cflb, nxg, nyg, dt, dx, dy, zz, \
                                   cc, stream);                             \
  }
#define DQ2_ENTRIES(ORDER, K)                                               \
  DQ2_EULER(dq2_weno##ORDER##_f32, Euler4, K, float)                        \
  DQ2_EULER(dq2_weno##ORDER##_f64, Euler4, K, double)                       \
  DQ2_EULER(dq2_weno##ORDER##_euler5_f32, Euler5, K, float)                 \
  DQ2_EULER(dq2_weno##ORDER##_euler5_f64, Euler5, K, double)                \
  DQ2_ACOUSTICS(dq2_weno##ORDER##_acoustics_f32, K, float)                  \
  DQ2_ACOUSTICS(dq2_weno##ORDER##_acoustics_f64, K, double)
#else
#define DQ2_EULER(NAME, S, K, T)                                            \
  int NAME(const void* qbc, void* dq, void* cflb, int nxg, int nyg,         \
           const double* dt, double dx, double dy, double g1) {             \
    return launch_host<S, K, T>(qbc, dq, cflb, nxg, nyg, dt, dx, dy, g1,    \
                                0.0);                                       \
  }
#define DQ2_ACOUSTICS(NAME, K, T)                                           \
  int NAME(const void* qbc, void* dq, void* cflb, int nxg, int nyg,         \
           const double* dt, double dx, double dy, double zz, double cc) {  \
    return launch_host<Acoustics, K, T>(qbc, dq, cflb, nxg, nyg, dt, dx,    \
                                        dy, zz, cc);                        \
  }
#define DQ2_ENTRIES(ORDER, K)                                               \
  DQ2_EULER(dq2_weno##ORDER##_host_f32, Euler4, K, float)                   \
  DQ2_EULER(dq2_weno##ORDER##_host_f64, Euler4, K, double)                  \
  DQ2_EULER(dq2_weno##ORDER##_euler5_host_f32, Euler5, K, float)            \
  DQ2_EULER(dq2_weno##ORDER##_euler5_host_f64, Euler5, K, double)           \
  DQ2_ACOUSTICS(dq2_weno##ORDER##_acoustics_host_f32, K, float)             \
  DQ2_ACOUSTICS(dq2_weno##ORDER##_acoustics_host_f64, K, double)
#endif

DQ2_ENTRIES(7, 4)
DQ2_ENTRIES(9, 5)
DQ2_ENTRIES(11, 6)
DQ2_ENTRIES(13, 7)
DQ2_ENTRIES(15, 8)
DQ2_ENTRIES(17, 9)

}  // extern "C"
