// step3_aos.cu — the whole 3D unsplit classic (CTU) step of the generic
// AoS form, one launch per step, for Hopper (sm_90a): any system of
// csrc/acoustics3d.cuh (heterogeneous and constant acoustics, advection,
// Burgers),
// with aux arrays, a capacity function and the f-wave correction form,
// for any (nx, ny, nz).  (Euler, with or without a capacity function or
// f-waves, runs step3_ctu.cu.)
//
// Replaces the TPU kernel pyclaw_tpu/ops/tiled2d.py:431 step3_pallas_xy in
// its aux form: kernel_aux (:490-518), launched by the pallas_call at
// :592-605, with the body pyclaw_tpu/classic/kernels.py:806 step3_roll
// with aux=, index_capa and fwave.  It computes what
// pyclaw_tpu/classic/kernels.py:step3 computes with aux: in each direction
// the normal solve, the limiter and the correction flux (with per-cell
// dt/(dD kappa) under a capacity function); the rpt3 split of each
// fluctuation along both transverse axes into the fluxes of those axes,
// with the receiving cell's coefficient (flux3.f90 dtdx1d(i1)); the rptt3
// split of each part along the third axis (systems that have one, with
// transverse_waves = 2); then the conservative update.  Its plain PyTorch
// version is pyclaw_tpu_torch/classic/kernels.py:step3, which it is held
// against on the card (chip_smoke.py) and, through the host emulation at
// the end of this file, on the CPU (tests/test_torch_step3_aos.py).
//
// What bounds it on the card: heterogeneous acoustics reads 4 values of q
// and 2 of aux per cell and writes 4 (at 192^3 in f32, (6 x 196^3 +
// 4 x 192^3) x 4 B = 294 MB: 0.0877 ms at 3.35 TB/s; 0.1755 ms in f64),
// and with transverse_waves = 1 does 823 operations per cell
// (chip_smoke.py:flops_per_cell_3d_aos counts them from this source: the
// normal solve, two limited waves, the correction, the CFL, the flux terms,
// four splits and their gathers, the update), 19.8 operations per byte
// against the card's 20 (f32, 67 TFLOP/s over 3.35 TB/s): bytes bound it,
// just.  Tensor cores do not apply: there is no
// matrix product, only per-cell scalar arithmetic (the Riemann solves, the
// limiter, the splits), so the levers are the work the halo repeats, the
// phases and their barriers, the warps per SM and the staging.
//
// Burgers (burgers_3D, added after the redesign) splits each fluctuation,
// and each split part again (rptt3), by the sign of the state of the
// cell the fluctuation enters; split_aux hands a SPLIT_Q system that
// cell's staged state in place of its aux, and the other systems' code
// is unchanged (the same SASS and bits, time_kernels --sass).  At 192^3
// on the Gaussian pulse (PERF.md section 6; H100, 700 W) it takes 2.54 /
// 6.01 ms (f32 / f64) with transverse_waves 2: its twenty rptt3 phases a
// sweep cost more than the heterogeneous system's two.
//
// Design: a block owns a tile of output cells and stages q, the aux rows
// the system reads and, with a capacity function, the per-cell
// dt/(dD kappa) of the three axes, each with a 2-cell halo on all three
// axes, in shared memory.  The heterogeneous split reads the impedance and
// sound speed of the receiving cell's two neighbours along the split axis;
// the split region reaches C0-1 .. C0+T across, so the neighbours lie in
// C0-2 .. C0+T+1, inside the halo.  The three sweep directions run one
// after the other.  The scatter of the split parts into the fluxes of the
// other two axes is written as a gather in a fixed order (no atomics).
// Loads are clamped to the padded grid and stores masked, so any (nx, ny,
// nz) works; clamped cells feed only masked-out results.
//
// What the first port did differently, measured lever by lever at
// 192^3 against it in one call (PERF.md section 6; H100, 700 W): it kept
// step3_ctu.cu's structure, one 256-thread block per SM and 51 barriers a
// block at transverse_waves = 1, and took 4.96 ms (f32) / 8.18 ms (f64).
//   - staging: every copy is issued (cp.async) before any is waited on;
//     the first port waited on each global load before its shared store;
//   - threads: 1024 a block in f32 and 512 in f64 (as many as the
//     registers allow; the first port's 256 left the SM 8 warps);
//   - the normal solve is folded into the sweep phase: each interface
//     solves its own Riemann problem and those of its two neighbours along
//     D that the limiter reads, from the staged cells (the same operations
//     on the same values: the same bits), so no waves go through shared
//     memory and a phase and its barrier go;
//   - without rptt3 (the heterogeneous path), the E-flux gathers split the
//     fluctuations themselves, the half of each split they use, so the
//     splits along both transverse axes and the cell fluctuations share
//     one phase, no split is staged, and the across-ring that only rptt3
//     reads is not split: two phases per direction, 8 barriers a block;
//   - the CFL partial is a warp-shuffle max and one slot per warp.
// Two blocks per SM on smaller tiles (8x8x4, 6x6x6, 4x6x8; 4x4x4 in f64)
// were slower: the halo work grows faster than the overlap pays.
// Not taken: a z-march (a block walks a column along z over a ring of
// planes, staging each plane once and solving each z-interface once).
// Probes of this source (PERF.md section 6, runs 12-15; f32 at 192^3)
// put the staging and the update alone at 0.63 of 2.11 ms and the work
// with no global load at 1.64-1.88 ms; the transverse splits take 24%,
// the limiter's neighbour solves 13%.  Over 8x8 columns a march stages 8
// of today's 12 planes and drops the z-ring of the x and y sweeps (a fifth
// of their interfaces): a gain of a fifth at most by that count, with a
// barrier per plane, and a plane gives a 1024-thread block 64-100 items
// a phase.  Every probe that removed the z-halo's work changed the data
// the arithmetic sees and ran slower; the kernel's time depends on the
// data (2.11 ms on the path's first state, 1.65 ms on its last) more than
// on that work.  A prefetch of the next tile needs a second buffer the
// shared memory does not hold (186 KB of 227 KB).
//
// Tile shape, chosen from the shared-memory budget (227 KB a block):
// 8x8x8 cells in f32 and 4x6x8 in f64 for every system, one block per SM:
// 32 warps (f32) / 16 warps (f64).  The faces' amdq/apdq share the rptt3
// parts' scratch (they are read before the first rptt3 phase writes it).
// step3_aos_smem_bytes reports each variant's bytes (f32 / f64, without
// and with a capacity function):
//   heterogeneous acoustics  128,768 / 121,216 B; 149,504 / 144,256 B
//   acoustics                154,112 / 145,792 B; 174,848 / 168,832 B
//   advection, Burgers        41,696 /  39,616 B;  62,432 /  62,656 B
//
// Phases (each a loop of the block's threads over a region, separated by
// barriers), for each sweep axis D in x, y, z:
//   sweep<D>   at T+1 x (T+2)^2 interfaces: the normal solve, the limiter
//              (with the neighbours' solves), the correction flux cq, the
//              fluctuations the splits take (amdq + cq, apdq - cq with
//              transverse_waves = 2) -> TR, cq into the D-flux of the
//              tile's faces, amdq/apdq of those faces; the CFL partial max
//   without rptt3 (one phase):
//     fluct<D>          each cell: dt/dD (apdq + amdq) of its two D-faces
//     gather_split<E>   for both transverse axes E: the E-flux of each
//                       E-face takes -dt/(2 dD) (bm, bp) of the splits of
//                       amdq, then apdq, at its two neighbour cells
//   with rptt3 (transverse_waves = 2), for each E and each fluctuation:
//     rpt      split along E -> bm, bp (fluct<D> in the first one's phase)
//     gather_e the E-flux of each E-face takes -dt/(2 dD) (bm, bp) of its
//              two neighbour cells; rptt of bm along F
//     gather_f the F-flux of each F-face takes the bm parts (own e-row
//              minus the crossing one); rptt of bp along F
//     gather_f the same for the bp parts
//   update     q - dq over the tile (with transverse_waves = 0 after
//              fluct<2>); each warp's CFL max
//
// Template parameters: the system, the type, the tile, CAPA (per-cell
// dt/(dD kappa)) and FWAVE (the correction 0.5 sign(s) (1 - |s| dt/dD),
// with sign(0) = 0).  The arithmetic repeats the plain version's, built
// without fused multiply-adds (ops/_build.py: -fmad=false), so each
// operation rounds as PyTorch's; the sums of the transverse terms into the
// fluxes and of the three directions into dq are taken in another order
// (roundoff), the same order as the first port's.  The systems live in
// acoustics3d.cuh, the limiters in tvd.cuh, the tile geometry (shared with
// step3_ctu.cu) in ctu3d.cuh, the asynchronous copies in async_copy.cuh.

#include <type_traits>

#include "acoustics3d.cuh"
#include "async_copy.cuh"
#include "ctu3d.cuh"
#include "dt_coef.cuh"
#include "tvd.cuh"

namespace {

// Whether system S's splits read the receiving cell's state (S::SPLIT_Q,
// Burgers) rather than aux (the systems without the member)
template <class S, class = void> struct SplitQ : std::false_type {};
template <class S>
struct SplitQ<S, std::void_t<decltype(S::SPLIT_Q)>>
    : std::integral_constant<bool, S::SPLIT_Q> {};

// Tile shape per type: cells along x, y, z
template <typename T> struct Shape;
template <> struct Shape<float> {
  static constexpr int X = 8, Y = 8, Z = 8;
};
template <> struct Shape<double> {
  static constexpr int X = 4, Y = 6, Z = 8;
};

// Threads per block per type: as many warps as the registers allow over the
// one tile that the shared memory holds
template <typename T> struct Threads;
template <> struct Threads<float> {
  static constexpr int N = 1024;
};
template <> struct Threads<double> {
  static constexpr int N = 512;
};
template <typename T> constexpr int NTB = Threads<T>::N;
// the CFL fold keeps one slot per whole warp
static_assert(NTB<float> % 32 == 0 && NTB<double> % 32 == 0,
              "whole warps per block");
// limiter ids an entry takes (one per wave; a system with fewer waves
// reads the first of them)
constexpr int NLIM = 5;

// Shared-memory layout (offsets in elements)
template <class S, typename T, class H, bool CAPA> struct Lay {
  static constexpr int NEQ = S::NEQ, NW = S::NW, NAUX = S::NAUX;
  using R0 = Reg<H, 0>;
  using R1 = Reg<H, 1>;
  using R2 = Reg<H, 2>;
  static constexpr int Q0 = H::X + 4, Q1 = H::Y + 4, Q2 = H::Z + 4;
  static constexpr int QN = Q0 * Q1 * Q2;           // tile + halo
  static constexpr int CN = H::X * H::Y * H::Z;     // tile cells
  static constexpr int BM = CMAX(R0::BN, CMAX(R1::BN, R2::BN));
  static constexpr int FM = CMAX(R0::FN, CMAX(R1::FN, R2::FN));
  // scratch (rptt3 only): [bm, bp 2 NEQ x BM | split parts along F
  // 2 NEQ x BM]
  static constexpr int US = S::HAS_RPTT ? 4 * NEQ * BM : 0;
  static_assert(FM <= BM, "the faces' fluctuations fit the parts' scratch");
  static constexpr int oAX = NEQ * QN;
  static constexpr int oDT = oAX + NAUX * QN;
  static constexpr int oF0 = oDT + (CAPA ? 3 * QN : 0);
  static constexpr int oF1 = oF0 + NEQ * R0::FN;
  static constexpr int oF2 = oF1 + NEQ * R1::FN;
  static constexpr int oDQ = oF2 + NEQ * R2::FN;
  static constexpr int oTR = oDQ + NEQ * CN;        // fluctuations to split
  static constexpr int oU = oTR + 2 * NEQ * BM;
  // amdq, apdq at the faces: written in the sweep phase and read by
  // fluct<D> before the first rptt3 phase writes the split parts along F,
  // so with rptt3 they take the parts' scratch
  static constexpr int oAMF = oU + (S::HAS_RPTT ? 2 * NEQ * BM : 0);
  static constexpr int oRED = CMAX(oU + US, oAMF + 2 * NEQ * FM);
  // RED: the CFL partial of each thread, then of each warp
  static constexpr size_t elems = oRED + NTB<T> + NTB<T> / 32;
  static constexpr size_t bytes = elems * sizeof(T);
};

template <typename T> struct Args {
  const T* qbc;
  const T* aux;
  T* qout;
  T* cflb;
  int N[3];            // padded (ghost-extended) extents
  int nb[3];           // blocks along x, y, z
  int capa;            // aux row of the capacity function (CAPA only)
  const double* dt;    // the step (dt_coef.cuh)
  double dd[3];        // dx, dy, dz for the coefficients of dt
  T d[3];              // dx, dy, dz
  T* C;                // the block's coefficients of dt (dt_coef.cuh:
                       // coef3), in shared memory: dt/dD, 0.5 dt/dD,
                       // dt/(6 dE) (the kappa-scaled rptt factor),
                       // dt^2/(6 dD dE)
  Sys3<T> P;
  int order, tw;
  int lim[NLIM];       // the limiter id of each wave
};

template <class S, typename T, class H, bool CAPA> struct Block {
  using L = Lay<S, T, H, CAPA>;
  T* Q;
  T* AX;
  T* DT;
  T* F[3];
  T* DQ;
  T* TR;
  T* U;
  T* RED;
  int C0[3];   // first interior cell of the tile (padded indices)
  int bid;

  HD void bind(T* s, int b) {
    Q = s;
    AX = s + L::oAX;
    DT = s + L::oDT;
    F[0] = s + L::oF0;
    F[1] = s + L::oF1;
    F[2] = s + L::oF2;
    DQ = s + L::oDQ;
    TR = s + L::oTR;
    U = s + L::oU;
    RED = s + L::oRED;
    bid = b;
  }
  HD static int cell(int l0, int l1, int l2) {
    return (l0 * L::Q1 + l1) * L::Q2 + l2;
  }
  HD void load_cell(int c, T qv[], T av[]) const {
    for (int e = 0; e < L::NEQ; ++e) qv[e] = Q[e * L::QN + c];
    for (int m = 0; m < L::NAUX; ++m) av[m] = AX[m * L::QN + c];
  }
  HD void load_aux(int c, T av[]) const {
    for (int m = 0; m < L::NAUX; ++m) av[m] = AX[m * L::QN + c];
  }
  // dt/dD of the staged cell c: per cell with a capacity function
  template <int D> HD T dtd(const Args<T>& A, int c) const {
    if (CAPA) return DT[D * L::QN + c];
    return A.C[K3_DTD + D];
  }
  HD T* AMf() const { return U + (L::oAMF - L::oU); }
  HD T* APf() const { return AMf() + L::NEQ * L::FM; }
};

// the staged stride along D
template <class L, int D>
constexpr int stride_of = D == 0 ? L::Q1 * L::Q2 : (D == 1 ? L::Q2 : 1);

// ---- phase: stage q, aux and dt/(dD kappa) + halo, zero the accumulators
// Every copy is issued (cp.async) before any is waited on; kappa lands in
// the third dt/(dD kappa) plane, and the thread that copied it turns it
// into the three dt/(dD kappa) in place after its own wait.
template <class S, typename T, class H, bool CAPA>
HD void phase_load(const Args<T>& A, Block<S, T, H, CAPA>& B, int tid) {
  using L = Lay<S, T, H, CAPA>;
  constexpr int NF = L::NEQ + L::NAUX + (CAPA ? 1 : 0);
  const long long plane = (long long)A.N[0] * A.N[1] * A.N[2];
  for (int idx = tid; idx < NF * L::QN; idx += NTB<T>) {
    const int f = idx / L::QN, r = idx % L::QN;
    int c[3];
    dec<L::Q0, L::Q1, L::Q2>(r, c);
    long long g[3];
    for (int a = 0; a < 3; ++a) {
      const int v = B.C0[a] - 2 + c[a];
      g[a] = v < A.N[a] ? v : A.N[a] - 1;
    }
    const long long off = (g[0] * A.N[1] + g[1]) * A.N[2] + g[2];
    if (f < L::NEQ) {
      copy_async(B.Q + idx, A.qbc + f * plane + off);
    } else if (f < L::NEQ + L::NAUX) {
      copy_async(B.AX + (f - L::NEQ) * L::QN + r,
                 A.aux + (f - L::NEQ) * plane + off);
    } else {
      copy_async(B.DT + 2 * L::QN + r, A.aux + A.capa * plane + off);
    }
  }
  for (int idx = tid; idx < L::oTR - L::oF0; idx += NTB<T>) B.F[0][idx] = T(0);
  B.RED[tid] = T(0);
  // the block's coefficients of dt while the copies land
  if (tid < NCOEF3) A.C[tid] = coef3<T>(*A.dt, A.dd, tid);
  copy_wait_all();
  if (CAPA) {
    for (int idx = tid; idx < NF * L::QN; idx += NTB<T>) {
      if (idx < (NF - 1) * L::QN) continue;
      const int r = idx - (NF - 1) * L::QN;
      // dt / (dD kappa): the plain version's 0-d dt over (dD * kappa)
      const T kappa = B.DT[2 * L::QN + r], dt = T(*A.dt);
      for (int d = 0; d < 3; ++d)
        B.DT[d * L::QN + r] = dt / (A.d[d] * kappa);
    }
  }
}

// the waves of the normal solve between the staged cells cl and cr
template <int D, class S, typename T, class H, bool CAPA>
HD void rpn_waves(const Args<T>& A, const Block<S, T, H, CAPA>& B, int cl,
                  int cr, T w[][S::NEQ]) {
  using L = Lay<S, T, H, CAPA>;
  T ql[L::NEQ], qr[L::NEQ], al[L::NAUX + 1], ar[L::NAUX + 1];
  B.load_cell(cl, ql, al);
  B.load_cell(cr, qr, ar);
  T s[L::NW], am[L::NEQ], ap[L::NEQ];
  S::template rpn<D, T>(A.P, ql, qr, al, ar, w, s, am, ap);
}

// ---- phase: normal solve, limiter, correction flux, fluctuations, CFL ---
// at the D-interfaces C0-1 .. C0+T-1 (cells C0-1 .. C0+T across).  The
// limiter's neighbour interfaces along D are solved again here (the same
// operations on the same staged values: the same bits), which spares the
// first port's separate normal-solve phase, its barrier and its waves in
// shared memory.
template <int D, bool FWAVE, class S, typename T, class H, bool CAPA>
HD void phase_sweep(const Args<T>& A, Block<S, T, H, CAPA>& B, int tid) {
  using R = Reg<H, D>;
  using L = Lay<S, T, H, CAPA>;
  constexpr int NEQ = L::NEQ, NW = L::NW;
  constexpr int sD = stride_of<L, D>;
  T* AMf = B.AMf();
  T* APf = B.APf();
  T cfl = B.RED[tid];
  for (int idx = tid; idx < R::BN; idx += NTB<T>) {
    int b[3];
    dec<R::B0, R::B1, R::B2>(idx, b);
    // the interface's left and right cells (staged indices)
    const int cl = B.cell(b[0] + 1, b[1] + 1, b[2] + 1);
    const int cr = cl + sD;
    const T dl = B.template dtd<D>(A, cl);
    const T dr = B.template dtd<D>(A, cr);
    const T dtdx = CAPA ? T(0.5) * (dl + dr) : dl;
    T w[NW][NEQ], s[NW], am[NEQ], ap[NEQ];
    {
      T ql[NEQ], qr[NEQ], al[L::NAUX + 1], ar[L::NAUX + 1];
      B.load_cell(cl, ql, al);
      B.load_cell(cr, qr, ar);
      S::template rpn<D, T>(A.P, ql, qr, al, ar, w, s, am, ap);
    }

    T cq[NEQ];
    for (int e = 0; e < NEQ; ++e) cq[e] = T(0);
    if (A.order == 2) {
      // the dot products with the neighbour interfaces' waves, one
      // neighbour at a time (the waves of only one are live at once)
      T dlo[NW], dhi[NW];
      {
        T wn[NW][NEQ];
        rpn_waves<D>(A, B, cl - sD, cl, wn);
        for (int p = 0; p < NW; ++p) {
          dlo[p] = wn[p][0] * w[p][0];
          for (int e = 1; e < NEQ; ++e) dlo[p] = dlo[p] + wn[p][e] * w[p][e];
        }
        rpn_waves<D>(A, B, cr, cr + sD, wn);
        for (int p = 0; p < NW; ++p) {
          dhi[p] = w[p][0] * wn[p][0];
          for (int e = 1; e < NEQ; ++e) dhi[p] = dhi[p] + w[p][e] * wn[p][e];
        }
      }
      T cf[NW];
      for (int p = 0; p < NW; ++p) {
        T wn2 = w[p][0] * w[p][0];
        for (int e = 1; e < NEQ; ++e) wn2 = wn2 + w[p][e] * w[p][e];
        T phi = T(1);
        const int lid = A.lim[p];
        if (lid != 0) {
          const bool safe = wn2 > T(0);
          const T theta =
              safe ? (s[p] > T(0) ? dlo[p] : dhi[p]) / wn2 : T(0);
          const T ph = phi_limiter<T>(lid, theta, fabs_(s[p]) * dtdx);
          phi = safe ? ph : T(1);
        }
        const T abss = fabs_(s[p]);
        const T lead = FWAVE
            ? T(0.5) * T((s[p] > T(0)) - (s[p] < T(0)))
            : T(0.5) * abss;
        cf[p] = lead * (T(1) - abss * dtdx) * phi;
      }
      for (int e = 0; e < NEQ; ++e) {
        T acc = cf[0] * w[0][e];
        for (int p = 1; p < NW; ++p) acc = acc + cf[p] * w[p][e];
        cq[e] = acc;
      }
    }

    // the fluctuations the transverse splits take
    const bool both = A.tw >= 2 && A.order == 2;
    for (int e = 0; e < NEQ; ++e) {
      B.TR[e * L::BM + idx] = both ? am[e] + cq[e] : am[e];
      B.TR[(NEQ + e) * L::BM + idx] = both ? ap[e] - cq[e] : ap[e];
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
               && b[k] <= (k == 0 ? H::X : (k == 1 ? H::Y : H::Z));
      }
    }
    if (face) {
      const int fi = flat<R::F0, R::F1, R::F2>(f);
      for (int e = 0; e < NEQ; ++e) {
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
      for (int p = 0; p < NW; ++p) {
        if (CAPA) cfl = mx(cfl, mx(s[p] * dr, -s[p] * dl));
        else cfl = mx(cfl, dtdx * fabs_(s[p]));
      }
    }
  }
  B.RED[tid] = cfl;
}

// ---- phase: first-order fluctuations of each cell -----------------------
template <int D, class S, typename T, class H, bool CAPA>
HD void phase_fluct(const Args<T>& A, Block<S, T, H, CAPA>& B, int tid) {
  using R = Reg<H, D>;
  using L = Lay<S, T, H, CAPA>;
  const T* AMf = B.AMf();
  const T* APf = B.APf();
  for (int idx = tid; idx < L::CN; idx += NTB<T>) {
    int c[3];
    dec<H::X, H::Y, H::Z>(idx, c);
    const T dtd = B.template dtd<D>(A, B.cell(c[0] + 2, c[1] + 2, c[2] + 2));
    const int fl = flat<R::F0, R::F1, R::F2>(c);
    c[D] += 1;
    const int fr = flat<R::F0, R::F1, R::F2>(c);
    for (int e = 0; e < L::NEQ; ++e)
      B.DQ[e * L::CN + idx] += dtd * (APf[e * L::FM + fl]
                                      + AMf[e * L::FM + fr]);
  }
}

// aux of the staged cell c and of its neighbours below and above along E;
// for a SPLIT_Q system, the cell's state in ac (its splits read no aux)
template <int E, class S, typename T, class H, bool CAPA>
HD void split_aux(const Block<S, T, H, CAPA>& B, const int l[3], T ab[],
                  T ac[], T aa[]) {
  using L = Lay<S, T, H, CAPA>;
  if constexpr (SplitQ<S>::value) {
    const int c = B.cell(l[0], l[1], l[2]);
    for (int e = 0; e < L::NEQ; ++e) ac[e] = B.Q[e * L::QN + c];
  } else {
    int m[3] = {l[0], l[1], l[2]};
    B.load_aux(B.cell(m[0], m[1], m[2]), ac);
    m[E] = l[E] - 1;
    B.load_aux(B.cell(m[0], m[1], m[2]), ab);
    m[E] = l[E] + 1;
    B.load_aux(B.cell(m[0], m[1], m[2]), aa);
  }
}

// ---- phase: rpt3 split of one fluctuation along E -----------------------
template <int D, int E, int IMP, class S, typename T, class H, bool CAPA>
HD void phase_rpt(const Args<T>& A, Block<S, T, H, CAPA>& B, int tid) {
  using R = Reg<H, D>;
  using L = Lay<S, T, H, CAPA>;
  constexpr int NEQ = L::NEQ;
  T* BB = B.U;
  for (int idx = tid; idx < R::BN; idx += NTB<T>) {
    int b[3];
    dec<R::B0, R::B1, R::B2>(idx, b);
    // the receiving cell: left (IMP 1) or right (IMP 2) of the interface
    int l[3] = {b[0] + 1, b[1] + 1, b[2] + 1};
    l[D] += IMP - 1;
    T ab[L::NAUX + 1], ac[L::NAUX + 1], aa[L::NAUX + 1];
    split_aux<E>(B, l, ab, ac, aa);
    T asdq[NEQ], bm[NEQ], bp[NEQ];
    for (int e = 0; e < NEQ; ++e)
      asdq[e] = B.TR[((IMP - 1) * NEQ + e) * L::BM + idx];
    S::template rpt<E, T>(A.P, ab, ac, aa, asdq, bm, bp);
    for (int e = 0; e < NEQ; ++e) {
      BB[e * L::BM + idx] = bm[e];
      BB[(NEQ + e) * L::BM + idx] = bp[e];
    }
  }
}

// ---- phase: the E-flux gathers the rpt3 parts of its two neighbours -----
// F_E at (cell I along D, face J along E, cell K along F) takes
// -(c_bm bm at e-cell J+1 + c_bp bp at e-cell J) of D-interface I-i0, with
// c = dt/(2 dD) or 0.5 dt/(dD kappa) of the cells (I, J+1, K), (I, J, K)
template <int D, int E, int IMP, class S, typename T, class H, bool CAPA>
HD void phase_gather_e(const Args<T>& A, Block<S, T, H, CAPA>& B, int tid) {
  using R = Reg<H, D>;
  using RE = Reg<H, E>;
  using L = Lay<S, T, H, CAPA>;
  constexpr int F = 3 - D - E;
  const T* BB = B.U;
  T* FE = B.F[E];
  for (int idx = tid; idx < RE::FN; idx += NTB<T>) {
    int c[3], k[3];
    dec<RE::F0, RE::F1, RE::F2>(idx, c);
    k[D] = c[D] + 1 - (IMP - 1);
    k[F] = c[F] + 1;
    k[E] = c[E] + 1;
    const int k_bm = flat<R::B0, R::B1, R::B2>(k);
    k[E] = c[E];
    const int k_bp = flat<R::B0, R::B1, R::B2>(k);
    T h_bm = A.C[K3_HALF + D], h_bp = h_bm;
    if (CAPA) {
      int l[3] = {c[0] + 2, c[1] + 2, c[2] + 2};
      l[E] = c[E] + 2;
      h_bm = T(0.5) * B.DT[D * L::QN + B.cell(l[0], l[1], l[2])];
      l[E] = c[E] + 1;
      h_bp = T(0.5) * B.DT[D * L::QN + B.cell(l[0], l[1], l[2])];
    }
    for (int e = 0; e < L::NEQ; ++e)
      FE[e * RE::FN + idx] += -(h_bm * BB[e * L::BM + k_bm]
                                + h_bp * BB[(L::NEQ + e) * L::BM + k_bp]);
  }
}

// ---- without rptt3: the E-flux gathers the rpt3 parts, splitting as it
// goes.  F_E at (cell I along D, face J along E, cell K along F) takes, for
// each fluctuation (amdq, then apdq), -(c_bm bm + c_bp bp) where bm is the
// split of D-interface I-i0 at e-cell J+1 and bp that at e-cell J: the
// gather of phase_gather_e with the split of phase_rpt done in place, for
// the half it uses.  No split is staged, so the splits along both
// transverse axes and the cell fluctuations share one phase, and the
// across-ring that only rptt3 reads is not split.
template <int D, int E, int IMP, class S, typename T, class H, bool CAPA>
HD void split_at(const Args<T>& A, const Block<S, T, H, CAPA>& B,
                 const int k[3], T bm[], T bp[]) {
  using R = Reg<H, D>;
  using L = Lay<S, T, H, CAPA>;
  // the receiving cell: left (IMP 1) or right (IMP 2) of the interface
  int l[3] = {k[0] + 1, k[1] + 1, k[2] + 1};
  l[D] += IMP - 1;
  T ab[L::NAUX + 1], ac[L::NAUX + 1], aa[L::NAUX + 1];
  split_aux<E>(B, l, ab, ac, aa);
  const int kf = flat<R::B0, R::B1, R::B2>(k);
  T asdq[L::NEQ];
  for (int e = 0; e < L::NEQ; ++e)
    asdq[e] = B.TR[((IMP - 1) * L::NEQ + e) * L::BM + kf];
  S::template rpt<E, T>(A.P, ab, ac, aa, asdq, bm, bp);
}

template <int D, int E, int IMP, class S, typename T, class H, bool CAPA>
HD void gather_split_one(const Args<T>& A, const Block<S, T, H, CAPA>& B,
                         const int c[3], T h_bm, T h_bp, T* fe) {
  using L = Lay<S, T, H, CAPA>;
  constexpr int F = 3 - D - E;
  int k[3];
  k[D] = c[D] + 1 - (IMP - 1);
  k[F] = c[F] + 1;
  k[E] = c[E] + 1;
  T bm[L::NEQ], unused[L::NEQ], bp[L::NEQ];
  split_at<D, E, IMP>(A, B, k, bm, unused);
  k[E] = c[E];
  split_at<D, E, IMP>(A, B, k, unused, bp);
  for (int e = 0; e < L::NEQ; ++e) fe[e] += -(h_bm * bm[e] + h_bp * bp[e]);
}

template <int D, int E, class S, typename T, class H, bool CAPA>
HD void phase_gather_split(const Args<T>& A, Block<S, T, H, CAPA>& B,
                           int tid) {
  using RE = Reg<H, E>;
  using L = Lay<S, T, H, CAPA>;
  T* FE = B.F[E];
  for (int idx = tid; idx < RE::FN; idx += NTB<T>) {
    int c[3];
    dec<RE::F0, RE::F1, RE::F2>(idx, c);
    T h_bm = A.C[K3_HALF + D], h_bp = h_bm;
    if (CAPA) {
      int l[3] = {c[0] + 2, c[1] + 2, c[2] + 2};
      l[E] = c[E] + 2;
      h_bm = T(0.5) * B.DT[D * L::QN + B.cell(l[0], l[1], l[2])];
      l[E] = c[E] + 1;
      h_bp = T(0.5) * B.DT[D * L::QN + B.cell(l[0], l[1], l[2])];
    }
    T fe[L::NEQ];
    for (int e = 0; e < L::NEQ; ++e) fe[e] = FE[e * RE::FN + idx];
    gather_split_one<D, E, 1>(A, B, c, h_bm, h_bp, fe);
    gather_split_one<D, E, 2>(A, B, c, h_bm, h_bp, fe);
    for (int e = 0; e < L::NEQ; ++e) FE[e * RE::FN + idx] = fe[e];
  }
}

// ---- phase: rptt3 split of one rpt3 part (PART 0: bm, 1: bp) along F,
// scaled by -+dt^2/(6 dD dE) or -+(dt/(6 dE)) dt/(dD kappa) of the
// receiving cell (the down-going part flips its sign) ---------------------
template <int D, int E, int IMP, int PART, class S, typename T, class H,
          bool CAPA>
HD void phase_rptt(const Args<T>& A, Block<S, T, H, CAPA>& B, int tid) {
  using R = Reg<H, D>;
  using L = Lay<S, T, H, CAPA>;
  constexpr int NEQ = L::NEQ;
  constexpr int F = 3 - D - E;
  const T* BB = B.U;
  T* TB = B.U + 2 * NEQ * L::BM;
  for (int idx = tid; idx < R::BN; idx += NTB<T>) {
    int b[3];
    dec<R::B0, R::B1, R::B2>(idx, b);
    int l[3] = {b[0] + 1, b[1] + 1, b[2] + 1};
    l[D] += IMP - 1;
    T co = A.C[K3_CO2 + 3 * D + E];
    if (CAPA)
      co = A.C[K3_CO6 + E] * B.DT[D * L::QN + B.cell(l[0], l[1], l[2])];
    if (PART == 0) co = -co;
    T ab[L::NAUX + 1], ac[L::NAUX + 1], aa[L::NAUX + 1];
    split_aux<F>(B, l, ab, ac, aa);
    T bs[NEQ], cm[NEQ], cp[NEQ];
    for (int e = 0; e < NEQ; ++e) bs[e] = BB[(NEQ * PART + e) * L::BM + idx];
    S::template rptt<F, T>(A.P, ab, ac, aa, bs, cm, cp);
    for (int e = 0; e < NEQ; ++e) {
      TB[e * L::BM + idx] = co * cm[e];
      TB[(NEQ + e) * L::BM + idx] = co * cp[e];
    }
  }
}

// ---- phase: the F-flux gathers the rptt3 parts of one rpt3 part ---------
// F_F at (cell I along D, cell J along E, face K along F) takes, from
// D-interface I-i0: + (cm at f-cell K+1 + cp at f-cell K) of e-cell J,
// - the same of e-cell J+1 (bm parts) or J-1 (bp parts).
template <int D, int E, int IMP, int PART, class S, typename T, class H,
          bool CAPA>
HD void phase_gather_f(const Args<T>& A, Block<S, T, H, CAPA>& B, int tid) {
  using R = Reg<H, D>;
  using L = Lay<S, T, H, CAPA>;
  constexpr int NEQ = L::NEQ;
  constexpr int F = 3 - D - E;
  using RF = Reg<H, F>;
  const T* TB = B.U + 2 * NEQ * L::BM;
  T* FF = B.F[F];
  for (int idx = tid; idx < RF::FN; idx += NTB<T>) {
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
    for (int e = 0; e < NEQ; ++e) {
      T own = TB[e * L::BM + own_m] + TB[(NEQ + e) * L::BM + own_p];
      T cross = -TB[e * L::BM + x_m] - TB[(NEQ + e) * L::BM + x_p];
      FF[e * RF::FN + idx] += own + cross;
    }
  }
}

// ---- phase: conservative update of the tile -----------------------------
template <class S, typename T, class H, bool CAPA>
HD void phase_update(const Args<T>& A, Block<S, T, H, CAPA>& B, int tid) {
  using L = Lay<S, T, H, CAPA>;
  using R0 = Reg<H, 0>;
  using R1 = Reg<H, 1>;
  using R2 = Reg<H, 2>;
  const int n0 = A.N[0] - 4, n1 = A.N[1] - 4, n2 = A.N[2] - 4;
  for (int idx = tid; idx < L::CN; idx += NTB<T>) {
    int c[3];
    dec<H::X, H::Y, H::Z>(idx, c);
    const int I0 = B.C0[0] + c[0], I1 = B.C0[1] + c[1], I2 = B.C0[2] + c[2];
    if (I0 >= A.N[0] - 2 || I1 >= A.N[1] - 2 || I2 >= A.N[2] - 2) continue;
    const int cc = B.cell(c[0] + 2, c[1] + 2, c[2] + 2);
    const T d0 = B.template dtd<0>(A, cc);
    const T d1 = B.template dtd<1>(A, cc);
    const T d2 = B.template dtd<2>(A, cc);
    int fx[3] = {c[0] + 1, c[1], c[2]};
    int fy[3] = {c[0], c[1] + 1, c[2]};
    int fz[3] = {c[0], c[1], c[2] + 1};
    const int x0 = flat<R0::F0, R0::F1, R0::F2>(c);
    const int x1 = flat<R0::F0, R0::F1, R0::F2>(fx);
    const int y0 = flat<R1::F0, R1::F1, R1::F2>(c);
    const int y1 = flat<R1::F0, R1::F1, R1::F2>(fy);
    const int z0 = flat<R2::F0, R2::F1, R2::F2>(c);
    const int z1 = flat<R2::F0, R2::F1, R2::F2>(fz);
    for (int e = 0; e < L::NEQ; ++e) {
      T dq = B.DQ[e * L::CN + idx];
      dq = dq + d0 * (B.F[0][e * R0::FN + x1] - B.F[0][e * R0::FN + x0]);
      dq = dq + d1 * (B.F[1][e * R1::FN + y1] - B.F[1][e * R1::FN + y0]);
      dq = dq + d2 * (B.F[2][e * R2::FN + z1] - B.F[2][e * R2::FN + z0]);
      A.qout[((long long)(e * n0 + I0 - 2) * n1 + (I1 - 2)) * n2 + (I2 - 2)] =
          B.Q[e * L::QN + cc] - dq;
    }
  }
}

// ---- the phase sequence, shared by the kernel and the host emulation ----
// X(fn) runs fn(tid) for every thread of the block, then a barrier.
// pre(t) runs in the first phase, before the split
template <int D, int E, int IMP, class S, typename T, class H, bool CAPA,
          class X, class P>
HD void transverse_one(const Args<T>& A, Block<S, T, H, CAPA>& B,
                       const X& run, const P& pre) {
  run([&](int t) {
    pre(t);
    phase_rpt<D, E, IMP>(A, B, t);
  });
  run([&](int t) {
    phase_gather_e<D, E, IMP>(A, B, t);
    phase_rptt<D, E, IMP, 0>(A, B, t);
  });
  run([&](int t) { phase_gather_f<D, E, IMP, 0>(A, B, t); });
  run([&](int t) { phase_rptt<D, E, IMP, 1>(A, B, t); });
  run([&](int t) { phase_gather_f<D, E, IMP, 1>(A, B, t); });
}

// Per sweep: the sweep phase, then fluct<D> in the same phase as the first
// split (they touch different scratch); with transverse_waves 0, fluct<0>
// and fluct<1> alone and fluct<2> in the update's phase (the same thread
// owns a cell in both).
template <int D, bool FWAVE, class S, typename T, class H, bool CAPA,
          class X>
HD void sweep(const Args<T>& A, Block<S, T, H, CAPA>& B, const X& run) {
  run([&](int t) { phase_sweep<D, FWAVE>(A, B, t); });
  constexpr int E1 = D == 0 ? 1 : 0;
  constexpr int E2 = D == 2 ? 1 : 2;
  if (A.tw == 0) {
    if (D < 2) run([&](int t) { phase_fluct<D>(A, B, t); });
    return;
  }
  // the rptt3 phases exist only for systems that have rptt3 (their scratch,
  // Lay::US, is empty in the others)
  if constexpr (S::HAS_RPTT) {
    if (A.tw >= 2) {
      transverse_one<D, E1, 1>(A, B, run, [&](int t) {
        phase_fluct<D>(A, B, t);
      });
      transverse_one<D, E1, 2>(A, B, run, [](int) {});
      transverse_one<D, E2, 1>(A, B, run, [](int) {});
      transverse_one<D, E2, 2>(A, B, run, [](int) {});
      return;
    }
  }
  run([&](int t) {
    phase_fluct<D>(A, B, t);
    phase_gather_split<D, E1>(A, B, t);
    phase_gather_split<D, E2>(A, B, t);
  });
}

// fold thread t's CFL partial into its warp's slot: a shuffle max on the
// card, a loop over the lanes on the host
template <typename T> HD void warp_fold(T* red, int t) {
#if defined(__CUDACC__)
  const T m = warp_max(red[t]);
  if (t % 32 == 0) red[NTB<T> + t / 32] = m;
#else
  red[NTB<T> + t / 32] = t % 32 == 0 ? red[t] : mx(red[NTB<T> + t / 32], red[t]);
#endif
}

// the block's CFL partial from the warps' slots
template <typename T> HD T block_cfl(const T* red) {
  T m = red[NTB<T>];
  for (int w = 1; w < NTB<T> / 32; ++w) m = mx(m, red[NTB<T> + w]);
  return m;
}

template <bool FWAVE, class S, typename T, class H, bool CAPA, class X>
HD void step_block(const Args<T>& A, Block<S, T, H, CAPA>& B, const X& run) {
  run([&](int t) { phase_load(A, B, t); });
  sweep<0, FWAVE>(A, B, run);
  sweep<1, FWAVE>(A, B, run);
  sweep<2, FWAVE>(A, B, run);
  run([&](int t) {
    if (A.tw == 0) phase_fluct<2>(A, B, t);
    phase_update(A, B, t);
    warp_fold(B.RED, t);
  });
}

template <typename T>
Args<T> make_args(const void* qbc, const void* aux, void* qout, void* cflb,
                  int nxg, int nyg, int nzg, int capa, const double* dt,
                  double dx,
                  double dy, double dz, const double* prm, int order, int tw,
                  const int* lim) {
  using H = Shape<T>;
  Args<T> A;
  A.qbc = static_cast<const T*>(qbc);
  A.aux = static_cast<const T*>(aux);
  A.qout = static_cast<T*>(qout);
  A.cflb = static_cast<T*>(cflb);
  A.N[0] = nxg;
  A.N[1] = nyg;
  A.N[2] = nzg;
  tile_counts<H>(A.N, A.nb);
  A.capa = capa;
  A.dt = dt;
  A.dd[0] = dx;
  A.dd[1] = dy;
  A.dd[2] = dz;
  for (int d = 0; d < 3; ++d) A.d[d] = T(A.dd[d]);
  A.C = nullptr;
  // advection: u, v, w; acoustics: zz, cc; Burgers: the efix flag
  for (int d = 0; d < 3; ++d) A.P.vel[d] = T(prm[d]);
  A.P.zz = T(prm[0]);
  A.P.cc = T(prm[1]);
  A.P.p2z = T(2.0 * prm[0]);
  A.order = order;
  A.tw = tw;
  for (int p = 0; p < NLIM; ++p) A.lim[p] = lim[p];
  return A;
}

template <typename T> int nblocks(const Args<T>& A) {
  return A.nb[0] * A.nb[1] * A.nb[2];
}

template <class S, typename T, bool CAPA> constexpr size_t smem_bytes() {
  return Lay<S, T, Shape<T>, CAPA>::bytes;
}

template <class S> int smem_of(bool capa, bool is_double) {
  if (is_double) {
    return (int)(capa ? smem_bytes<S, double, true>()
                      : smem_bytes<S, double, false>());
  }
  return (int)(capa ? smem_bytes<S, float, true>()
                    : smem_bytes<S, float, false>());
}

#if defined(__CUDACC__)
struct DeviceRun {
  template <class Fn> __device__ void operator()(Fn&& fn) const {
    fn(static_cast<int>(threadIdx.x));
    __syncthreads();
  }
};

template <class S, typename T, bool CAPA, bool FWAVE>
__global__ void __launch_bounds__(NTB<T>, 1) step3_aos_kernel(Args<T> A) {
  using H = Shape<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T coef[NCOEF3];
  A.C = coef;
  Block<S, T, H, CAPA> B;
  B.bind(reinterpret_cast<T*>(smem_raw), blockIdx.x);
  tile_origin<H>(A.nb, B.bid, B.C0);
  step_block<FWAVE>(A, B, DeviceRun());
  if (threadIdx.x == 0) A.cflb[B.bid] = block_cfl(B.RED);
}

template <class S, typename T, bool CAPA, bool FWAVE>
int launch(const Args<T>& A, void* stream) {
  constexpr size_t bytes = smem_bytes<S, T, CAPA>();
  static unsigned long long attr_done = 0;
  cudaError_t err = smem_attr_once(
      reinterpret_cast<const void*>(step3_aos_kernel<S, T, CAPA, FWAVE>),
      (int)bytes, attr_done);
  if (err != cudaSuccess) return (int)err;
  step3_aos_kernel<S, T, CAPA, FWAVE>
      <<<nblocks(A), NTB<T>, bytes, static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}
#else
// Host emulation: the same phases, one block and one "thread" at a time;
// each barrier is kept by running the whole block through a phase before
// the next.  Used by the CPU tests to check the kernel's index algebra
// against the plain version without a card.
template <int N> struct HostRun {
  template <class Fn> void operator()(Fn&& fn) const {
    for (int t = 0; t < N; ++t) fn(t);
  }
};

template <class S, typename T, bool CAPA, bool FWAVE>
int launch(Args<T> A, void*) {
  using H = Shape<T>;
  std::vector<T> smem(Lay<S, T, H, CAPA>::elems);
  T coef[NCOEF3];
  A.C = coef;
  for (int b = 0; b < nblocks(A); ++b) {
    Block<S, T, H, CAPA> B;
    B.bind(smem.data(), b);
    tile_origin<H>(A.nb, B.bid, B.C0);
    step_block<FWAVE>(A, B, HostRun<NTB<T>>());
    A.cflb[b] = block_cfl(B.RED);
  }
  return 0;
}
#endif

// system ids of the C interface (ops/tiled2d.py:STEP3_SYSTEMS)
enum { SYS_VC_ACOUSTICS = 0, SYS_ACOUSTICS = 1, SYS_ADVECTION = 2,
       SYS_BURGERS = 3, NUM_SYSTEMS = 4 };

template <typename T, class S>
int dispatch_flags(const Args<T>& A, bool capa, bool fwave, void* stream) {
  if (capa) {
    return fwave ? launch<S, T, true, true>(A, stream)
                 : launch<S, T, true, false>(A, stream);
  }
  return fwave ? launch<S, T, false, true>(A, stream)
               : launch<S, T, false, false>(A, stream);
}

template <typename T>
int step(const void* qbc, const void* aux, void* qout, void* cflb, int nxg,
         int nyg, int nzg, int system, int capa, int fwave, const double* dt,
         double dx, double dy, double dz, const double* prm, int order,
         int tw, const int* lim, void* stream) {
  const Args<T> A = make_args<T>(qbc, aux, qout, cflb, nxg, nyg, nzg, capa,
                                 dt, dx, dy, dz, prm, order, tw, lim);
  switch (system) {
    case SYS_VC_ACOUSTICS:
      return dispatch_flags<T, VcAcoustics3D>(A, capa >= 0, fwave != 0,
                                              stream);
    case SYS_ACOUSTICS:
      return dispatch_flags<T, Acoustics3D>(A, capa >= 0, fwave != 0,
                                            stream);
    case SYS_ADVECTION:
      return dispatch_flags<T, Advection3D>(A, capa >= 0, fwave != 0,
                                            stream);
    case SYS_BURGERS:
      return dispatch_flags<T, Burgers3D>(A, capa >= 0, fwave != 0, stream);
    default:
      return -1;
  }
}

}  // namespace

// ---- plain C interface (loaded with ctypes) -----------------------------
extern "C" {

// Number of blocks (= CFL partials) the kernel writes for a padded grid.
int step3_aos_blocks(int nxg, int nyg, int nzg, int is_double) {
  const int lim[NLIM] = {0, 0, 0, 0, 0};
  const double prm[3] = {0, 0, 0};
  if (is_double)
    return nblocks(make_args<double>(nullptr, nullptr, nullptr, nullptr, nxg,
                                     nyg, nzg, -1, nullptr, 1, 1, 1, prm, 1,
                                     0, lim));
  return nblocks(make_args<float>(nullptr, nullptr, nullptr, nullptr, nxg,
                                  nyg, nzg, -1, nullptr, 1, 1, 1, prm, 1, 0,
                                  lim));
}

// Threads per block (reported by chip_smoke.py).
int step3_aos_threads(int is_double) {
  return is_double ? NTB<double> : NTB<float>;
}

// Shared memory bytes per block (reported by chip_smoke.py).
int step3_aos_smem_bytes(int system, int capa, int is_double) {
  switch (system) {
    case SYS_VC_ACOUSTICS:
      return smem_of<VcAcoustics3D>(capa != 0, is_double != 0);
    case SYS_ACOUSTICS:
      return smem_of<Acoustics3D>(capa != 0, is_double != 0);
    case SYS_ADVECTION:
      return smem_of<Advection3D>(capa != 0, is_double != 0);
    case SYS_BURGERS:
      return smem_of<Burgers3D>(capa != 0, is_double != 0);
    default:
      return -1;
  }
}

// Limiter ids an entry takes (l0 .. l4: one per wave; a system with fewer
// waves reads the first of them).
int step3_aos_limiter_ids() { return NLIM; }

// Number of systems the build takes (system ids 0 .. this - 1; an earlier
// build without this entry takes three).
int step3_aos_num_systems() { return NUM_SYSTEMS; }

// One CTU step.  qbc: (num_eqn, nxg, nyg, nzg) ghost-padded (2 ghost
// cells); aux: (num_aux, nxg, nyg, nzg) or null when the system reads none
// and capa < 0; qout: (num_eqn, nxg-4, nyg-4, nzg-4); cflb:
// step3_aos_blocks(...) partial CFL maxima; all contiguous, of the type
// named by the entry.  dt: the step in device memory (host memory for the
// host emulation), a double that is exact in the entry's type.  system:
// SYS_*; capa: aux row of the capacity
// function or -1; fwave: the f-wave correction form; p0..p2: u, v, w
// (advection), zz, cc (acoustics) or the efix flag (Burgers: 1 or 0);
// l0..l4: the limiter ids of the
// waves.  Returns a cudaError_t (0 on success), or -1 for an
// unknown system.
#if defined(__CUDACC__)
#define STEP3_AOS_ENTRY(NAME, T)                                              \
  int NAME(const void* qbc, const void* aux, void* qout, void* cflb, int nxg, \
           int nyg, int nzg, int system, int capa, int fwave,                 \
           const double* dt,                                                  \
           double dx, double dy, double dz, double p0, double p1, double p2,  \
           int order, int tw, int l0, int l1, int l2, int l3, int l4,         \
           void* stream) {                                                    \
    const int lim[NLIM] = {l0, l1, l2, l3, l4};                               \
    const double prm[3] = {p0, p1, p2};                                       \
    return step<T>(qbc, aux, qout, cflb, nxg, nyg, nzg, system, capa, fwave,  \
                   dt, dx, dy, dz, prm, order, tw, lim, stream);              \
  }
STEP3_AOS_ENTRY(step3_aos_f32, float)
STEP3_AOS_ENTRY(step3_aos_f64, double)
#else
#define STEP3_AOS_ENTRY(NAME, T)                                              \
  int NAME(const void* qbc, const void* aux, void* qout, void* cflb, int nxg, \
           int nyg, int nzg, int system, int capa, int fwave,                 \
           const double* dt,                                                  \
           double dx, double dy, double dz, double p0, double p1, double p2,  \
           int order, int tw, int l0, int l1, int l2, int l3, int l4) {       \
    const int lim[NLIM] = {l0, l1, l2, l3, l4};                               \
    const double prm[3] = {p0, p1, p2};                                       \
    return step<T>(qbc, aux, qout, cflb, nxg, nyg, nzg, system, capa, fwave,  \
                   dt, dx, dy, dz, prm, order, tw, lim, nullptr);             \
  }
STEP3_AOS_ENTRY(step3_aos_host_f32, float)
STEP3_AOS_ENTRY(step3_aos_host_f64, double)
#endif
#undef STEP3_AOS_ENTRY

}  // extern "C"
