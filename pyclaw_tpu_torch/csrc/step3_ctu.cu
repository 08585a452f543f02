// step3_ctu.cu — the whole 3D unsplit classic (CTU) step of the Euler
// system (5 equations, 5 waves) with its CFL, one launch per step, for
// Hopper (sm_90a), with or without a capacity function kappa, in the wave
// or the f-wave correction form.
//
// Replaces the TPU kernel pyclaw_tpu/ops/tiled2d.py:431 step3_pallas_xy
// (pallas_call at :592, body classic/kernels.py:806 step3_roll) for Euler:
// its body kernel (:520-563) in the wave and the f-wave form, and its body
// kernel_aux (:490-518) with a capacity function (Euler reads no other
// aux).  It computes what
// pyclaw_tpu/classic/kernels.py:step3 computes: in each direction the Roe
// solve, the 5-wave limiter and the correction flux; the rpt3 split of
// each fluctuation along both transverse axes into the fluxes of those
// axes; the rptt3 split of each rpt3 part along the third axis into the
// third axis' flux (the Langseth-LeVeque corner-of-corner terms); then
// the conservative update.  With a capacity function every dt/dD becomes
// the per-cell dt/(dD kappa), the transverse coefficients those of the
// receiving cell (flux3.f90 dtdx1d(i1)) and the CFL window upwinded.  Its
// plain PyTorch version is pyclaw_tpu_torch/classic/kernels.py:step3,
// which it is held against on the card (chip_smoke.py) and, through the
// host emulation at the end of this file, on the CPU
// (tests/test_torch_step3.py).
//
// What bounds it on the card: per cell it reads 5 values of q and writes
// 5 (at 192^3, qbc read once and q written once are 5 x (196^3 + 192^3)
// values, 292 MB in f32: 0.087 ms at 3.35 TB/s), but the step needs about
// 7,600 floating-point operations per cell (3 normal Roe solves with the
// limiter, 3 eigensystems, 12 rpt3 and 24 rptt3 splits, the gathers and
// the update; chip_smoke.py:FLOPS_PER_CELL_3D counts them from this
// source), among them divides and square roots.  At 67 TFLOP/s (f32) or
// 34 TFLOP/s (f64) that is 0.81 ms (f32) or 1.59 ms (f64) at 192^3:
// operations bound it, not bytes.  chip_smoke.py computes both bounds.
//
// What the design does about it: no intermediate touches device memory.
// A block owns a tile of output cells and stages q with a 2-cell halo in
// shared memory (cp.async, csrc/async_copy.cuh).  It runs the three sweep
// directions one after the other.  The three flux arrays of the tile's
// faces stay in shared memory until the update.  The scatter of the split
// parts into the fluxes of the other two axes (one-cell shifts along
// three axes) is written as a gather: each flux element adds the parts of
// its neighbouring interfaces in a fixed order, with no atomics.  Ragged
// edges are clamped on load and masked on store, so any (nx, ny, nz)
// works.  Measured at 192^3 against the first port in one call (PERF.md
// section 6; H100, 700 W), 13.15 -> 6.6 ms in f32 and 33.2 -> 15.0 ms in
// f64, lever by lever:
//   - threads: 1024 a block in f32, 384 in f64 (the first port's 256
//     left the SM 8 warps; ptxas, chip_smoke.py [2], gives 64 and 156
//     registers);
//   - barriers, 79 -> 45: five scratch slots of one split region each,
//     used in rotation (Rot below), let a rptt3 split run in the phase of
//     the gather that consumes the previous part, an rpt3 split in the
//     phase of the last gather of the previous fluctuation and the next
//     sweep's Roe data in the last phase of a sweep: three phases a
//     fluctuation in place of five;
//   - a split runs only where its result is read: a fluctuation reaches a
//     tile cell from T of the T+1 interfaces along D, and an rptt3 part
//     is gathered from T_E+1 of the T_E+2 cells along E (800 and 720
//     splits in place of 900 at 8^3);
//   - the eigensystem of the splits is computed with the Roe data, whose
//     normal solve shares its reciprocal square roots, division and
//     velocities, and keeps each interface's sound speed, the quotient
//     g1/a2 (the operations each split made: the same bits) and one IEEE
//     reciprocal of 2a that the split multiplies by where the plain
//     version divides (roundoff): a split takes no division and no square
//     root, where it took two and one;
//   - the limiter's dot products and the amdq/apdq/cq sums skip the
//     components that the two shear waves never have (the same bits:
//     IEEE arithmetic cannot drop x + 0 * y itself);
//   - each phase runs its two regions in one index space, so a gather's
//     items fill the last pass of a split region;
//   - the rptt3 scale multiplies the split's input (5 products in place
//     of 10: roundoff), and the CFL partial is a warp-shuffle max.
// Slower or no better, and not taken: 512, 640, 800 (72 registers) or 960
// threads in f32; the first port's full split regions.  Probes of this
// source (wrong results, one share each; f32 at 192^3): the splits take
// 31% of the time, the rptt3 splits alone 20%, the limiter 15%.
//
// Tile shape: 8x8x8 cells in f32, 6x6x6 in f64 (the first port's 4x4x8
// repeated the normal solves 3.22x and the splits 2.41x over the tile's
// interfaces), one block per SM.  Shared memory (step3_ctu_smem_bytes):
// 224,784 B in f32 and 219,776 B in f64 without a capacity function,
// 231,696 B and 227,776 B with one (kappa over the staged tile), within
// the 232,448 B a block may use.
//
// The capacity function (CAPA): the block stages kappa with its halo, by
// cp.async like q, into one per-cell array K, and turns it in place into
// dt/(dx kappa) (the plain version's product and IEEE division: its
// bits) in the phase of roe<0>.  Every use of sweep D reads dt/(dD kappa)
// there: the interface average and the upwinded CFL window of the sweep
// phase, the cell's fluctuation term, the receiving cells' rpt3 and rptt3
// coefficients.  In the last phase of sweep D, which reads no K, each
// thread stages kappa again and turns it into dt/(dE kappa) of the next
// axis E: one division per staged cell and sweep, where dividing at each
// use would take one per interface, gather and split point.  After the
// last sweep K keeps kappa, and the update divides on the fly (3 a cell).
// With transverse_waves < 2 the last phase of a sweep reads K, so the
// restaging takes a phase of its own.  Measured at 192^3 against the
// Euler system step3_aos.cu ran before (PERF.md section 6; H100,
// 700 W): 11.48 -> 7.17 ms in f32, 28.18 -> 15.98 ms in f64.
// The f-wave form (FWAVE): the correction 0.5 sign(s) (1 - |s| dt/dD)
// with sign(0) = 0, and the normal velocity that feeds sign summed
// without contraction (euler3d.cuh: RN).
//
// Phases (each a loop of the block's threads over one or two regions,
// separated by barriers), after load and roe<0>, for each sweep axis D in
// x, y, z:
//   sweep<D>   at T+1 x (T+2)^2 interfaces: the limiter (neighbour waves
//              rebuilt from the Roe data), amdq, apdq, the correction
//              flux cq, the fluctuations the transverse splits take; cq
//              into the D-flux of the tile's faces; the CFL partial max
//   fluct<D>   each cell: dt/dD (apdq + amdq) of its two D-faces; with
//              it, the rpt3 split of the first fluctuation
//   for each transverse axis E of D (F the third) and each of the two
//   fluctuations (A-, A+), with transverse_waves = 2:
//     A  gather_e: the E-flux of each E-face takes -dt/(2 dD) (bm, bp) of
//        its two neighbour cells; rptt of bm along F -> cm, cp
//     B  gather_f: the F-flux of each F-face takes the bm parts (own
//        e-row minus the crossing one); rptt of bp along F
//     C  gather_f of the bp parts; the rpt3 split of the next
//        fluctuation (after the last one: roe<D+1>, the next sweep's Roe
//        data and eigensystem)
//   with transverse_waves = 1 each fluctuation's gather_e shares a phase
//   with the next split; with 0, fluct<D> shares one with roe<D+1>
//   update     q - dq over the tile (with transverse_waves = 0 after
//              fluct<2>); each warp's CFL max
//
// The arithmetic repeats the plain version's but for the reciprocal, the
// rptt3 scale and the contractions; the sums of the transverse terms into
// the fluxes
// and of the three directions into dq are taken in another order
// (roundoff).  The Roe solve and the split live in euler3d.cuh, the
// limiters in tvd.cuh, the tile geometry (shared with step3_aos.cu) in
// ctu3d.cuh.  The entry step3_ctu_f32/f64 runs the wave form without a
// capacity function; step3_ctu_aux_f32/f64 takes the aux array, the
// capacity row and the f-wave form and runs any of the four variants.

#include "async_copy.cuh"
#include "ctu3d.cuh"
#include "dt_coef.cuh"
#include "euler3d.cuh"
#include "tvd.cuh"

namespace {

// Tile shape per type (cells along x, y, z)
template <typename T> struct Shape;
template <> struct Shape<float> { static constexpr int X = 8, Y = 8, Z = 8; };
template <> struct Shape<double> { static constexpr int X = 6, Y = 6, Z = 6; };

// Threads per block per type: as many warps as the registers allow over
// the one tile that the shared memory holds
template <typename T> struct Threads;
template <> struct Threads<float> { static constexpr int N = 1024; };
template <> struct Threads<double> { static constexpr int N = 384; };

// One variant of the kernel: the type's tile and threads, with or without
// a capacity function (CAPA), in the wave or the f-wave form (FWAVE)
template <typename T, bool CAPA, bool FWAVE> struct Var : Shape<T> {
  static constexpr bool capa = CAPA, fwave = FWAVE;
  static constexpr int NT = Threads<T>::N;
  static_assert(NT % 32 == 0, "whole warps per block");
};

// Region of the transverse splits of one fluctuation of the sweep along
// D: the T interfaces along D whose fluctuation reaches a tile cell (the
// left-going one skips the tile's first face, the right-going one its
// last), cells C0-1 .. C0+T across.  s = b - (IMP == 1) e_D in the
// coordinates of Reg's B region.
template <class H, int D> struct SReg {
  static constexpr int S0 = H::X + (D == 0 ? 0 : 2);
  static constexpr int S1 = H::Y + (D == 1 ? 0 : 2);
  static constexpr int S2 = H::Z + (D == 2 ? 0 : 2);
  static constexpr int SN = S0 * S1 * S2;
};

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
  static constexpr int SN0 = SReg<S, 0>::SN, SN1 = SReg<S, 1>::SN;
  static constexpr int SN2 = SReg<S, 2>::SN;
  static constexpr int SR = CMAX(SN0, CMAX(SN1, SN2));
  // scratch U: five slots of 5 fields x SR (the split parts in rotation);
  // amdq/apdq of the faces (10 x FM) in slots 0-1 and the Roe data of
  // the normal solves (10 x AM) from slot 2 on: the sweep reads the one
  // and writes the other, fluct<D> reads amdq/apdq beside the first
  // split's slots 2-3, and roe<D+1> writes beside the last gather's
  // slots 0-1
  static constexpr int SL = 5 * SR;
  static constexpr int oRS = 2 * SL;
  static constexpr int US = CMAX(5 * SL, oRS + 10 * AM);
  static_assert(10 * FM <= 2 * SL, "amdq/apdq of the faces in slots 0-1");
  static constexpr int oF0 = 5 * QN;
  static constexpr int oF1 = oF0 + 5 * R0::FN;
  static constexpr int oF2 = oF1 + 5 * R1::FN;
  static constexpr int oDQ = oF2 + 5 * R2::FN;
  static constexpr int oTR = oDQ + 5 * CN;          // fluctuations to split
  static constexpr int oEIG = oTR + 10 * BM;        // u1 u2 u3 H a g1/a2 1/(2a)
  static constexpr int oU = oEIG + 7 * BM;
  // K: kappa, or dt/(dD kappa) of the sweep's axis, over the staged tile
  static constexpr int oK = oU + US;
  static constexpr int oRED = oK + (S::capa ? QN : 0);
  // RED: the CFL partial of each thread, then of each warp
  static constexpr size_t elems = oRED + S::NT + S::NT / 32;
  static constexpr size_t bytes = elems * sizeof(T);
};

// The slots of iteration I (0..3: (E1, A-), (E1, A+), (E2, A-), (E2, A+))
// with rptt3: bm, bp in (m, p); the rptt3 parts of bm in (a, b) (cm, cp);
// those of bp in (m, x), over bm once it is split.  Each phase writes
// only slots that no thread reads in it: A reads m, p, writes a, b; B
// reads a, b, p, writes m, x; C reads m, x and writes the next
// iteration's m, p (after the last: the Roe data, slots 2-4).
template <int I> struct Rot;
template <> struct Rot<0> {
  static constexpr int m = 2, p = 3, a = 0, b = 1, x = 4;
};
template <> struct Rot<1> {
  static constexpr int m = 0, p = 1, a = 2, b = 3, x = 4;
};
template <> struct Rot<2> {
  static constexpr int m = 2, p = 3, a = 0, b = 4, x = 1;
};
template <> struct Rot<3> {
  static constexpr int m = 0, p = 3, a = 2, b = 4, x = 1;
};
// without rptt3, iteration I's bm, bp in slots (2, 3) or (0, 1)
template <int I> struct Rot1 {
  static constexpr int m = I % 2 == 0 ? 2 : 0, p = m + 1;
};

template <typename T> struct Args {
  const T* qbc;
  const T* aux;        // with CAPA: the capacity function in row capa
  T* qout;
  T* cflb;
  int N[3];            // padded (ghost-extended) extents
  int nb[3];           // blocks along x, y, z
  int capa;
  const double* dt;    // the step (dt_coef.cuh)
  double dd[3];        // dx, dy, dz for the coefficients of dt
  T d[3];              // dx, dy, dz
  T* C;                // the block's coefficients of dt (dt_coef.cuh:
                       // coef3), in shared memory: dt (for the per-cell
                       // dt/(dD kappa)), dt/dD, 0.5 dt/dD, dt/(6 dE) (the
                       // kappa-scaled rptt factor), dt^2/(6 dD dE)
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
  T* K;
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
    K = s + L::oK;
    RED = s + L::oRED;
    bid = b;
  }
  HD T qs(int e, int l0, int l1, int l2) const {
    return Q[((e * L::Q0 + l0) * L::Q1 + l1) * L::Q2 + l2];
  }
  // index of the staged cell l (its K element)
  HD static int cell(const int l[3]) {
    return (l[0] * L::Q1 + l[1]) * L::Q2 + l[2];
  }
  HD T* slot(int k) const { return U + k * L::SL; }
  HD T* AMf() const { return U; }
  HD T* APf() const { return U + 5 * L::FM; }
  HD T* RS() const { return U + L::oRS; }
};

// offset in one plane of the padded grid of staged cell r (loads are
// clamped to the grid: clamped cells feed only masked-out results)
template <typename T, class S>
HD long long staged_offset(const Args<T>& A, const Block<T, S>& B, int r) {
  using L = Lay<T, S>;
  int c[3];
  dec<L::Q0, L::Q1, L::Q2>(r, c);
  long long g[3];
  for (int a = 0; a < 3; ++a) {
    const int v = B.C0[a] - 2 + c[a];
    g[a] = v < A.N[a] ? v : A.N[a] - 1;
  }
  return (g[0] * A.N[1] + g[1]) * A.N[2] + g[2];
}

template <typename T> HD long long plane_of(const Args<T>& A) {
  return (long long)A.N[0] * A.N[1] * A.N[2];
}

// ---- phase: stage q (and kappa) tile + halo, zero the accumulators -----
// Every copy is started (cp.async) before any is waited on.
template <typename T, class S>
HD void phase_load(const Args<T>& A, Block<T, S>& B, int tid) {
  using L = Lay<T, S>;
  constexpr int NF = S::capa ? 6 : 5;
  const long long plane = plane_of(A);
  for (int idx = tid; idx < NF * L::QN; idx += S::NT) {
    const int e = idx / L::QN, r = idx % L::QN;
    const long long off = staged_offset(A, B, r);
    if (e < 5) copy_async(B.Q + idx, A.qbc + e * plane + off);
    else copy_async(B.K + r, A.aux + A.capa * plane + off);
  }
  for (int idx = tid; idx < L::oTR - L::oF0; idx += S::NT) B.F[0][idx] = T(0);
  B.RED[tid] = T(0);
  // the block's coefficients of dt while the copies land
  if (tid < NCOEF3) A.C[tid] = coef3<T>(*A.dt, A.dd, tid);
  copy_wait_all();
}

// ---- K: the per-cell dt/(dD kappa) of the sweep along D ----------------
// the plain version's 0-d dt over (dD * kappa)
template <int D, typename T> HD T dtd_of(const Args<T>& A, T kappa) {
  return A.C[K3_DT] / (A.d[D] * kappa);
}

// turn the staged kappa into dt/(dD kappa) in place (the roe<0> phase)
template <int D, typename T, class S>
HD void turn(const Args<T>& A, Block<T, S>& B, int tid) {
  for (int r = tid; r < Lay<T, S>::QN; r += S::NT)
    B.K[r] = dtd_of<D>(A, B.K[r]);
}

// stage kappa again, in a phase that reads no K: the copies are issued
// first, and after its own wait each thread turns the elements it copied
// into dt/(dD kappa) (D < 3) or leaves kappa (D = 3, for the update)
template <typename T, class S>
HD void restage_issue(const Args<T>& A, Block<T, S>& B, int tid) {
  const long long plane = plane_of(A);
  for (int r = tid; r < Lay<T, S>::QN; r += S::NT)
    copy_async(B.K + r, A.aux + A.capa * plane + staged_offset(A, B, r));
}

template <int D, typename T, class S>
HD void restage_finish(const Args<T>& A, Block<T, S>& B, int tid) {
  copy_wait_all();
  if constexpr (D < 3) turn<D>(A, B, tid);
}

// dt/dD at staged cell c: per cell with a capacity function
template <int D, typename T, class S>
HD T dtd_at(const Args<T>& A, const Block<T, S>& B, int c) {
  if constexpr (S::capa) return B.K[c];
  return A.C[K3_DTD + D];
}

// ---- Roe data of the normal solve at D-interface idx (Reg's A region);
// at the B region's interfaces also the eigensystem of the splits (fixed
// component order 1, 2, 3), whose Roe average shares the normal one's
// square roots, quotient and velocities -----------------------------------
template <int D, typename T, class S>
HD void item_roe(const Args<T>& A, Block<T, S>& B, int idx) {
  using R = Reg<S, D>;
  using L = Lay<T, S>;
  T* W = B.RS();
  int c[3];
  dec<R::A0, R::A1, R::A2>(idx, c);
  int l[3] = {c[0] + 1, c[1] + 1, c[2] + 1};
  l[D] = c[D];
  T ql[5], qr[5];
  for (int e = 0; e < 5; ++e) {
    ql[e] = B.qs(e, l[0], l[1], l[2]);
    qr[e] = B.qs(e, l[0] + (D == 0), l[1] + (D == 1), l[2] + (D == 2));
  }
  const Roe3<T> rs = roe_3d<D, S::fwave>(A.g1, ql, qr);
  if (A.tw > 0 && c[D] >= 1 && c[D] <= R::B0 * (D == 0) + R::B1 * (D == 1)
                                       + R::B2 * (D == 2)) {
    int b[3] = {c[0], c[1], c[2]};
    b[D] -= 1;
    const int bi = flat<R::B0, R::B1, R::B2>(b);
    T vel[3], H, a2, eig[7];
    roe_avg3<1, 2, 3>(A.g1, ql, qr, vel, H, a2);
    split_eig(A.g1, vel, H, a2, eig);
    for (int k = 0; k < 7; ++k) B.EIG[k * L::BM + bi] = eig[k];
  }
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

// whether component e of wave p of the normal solve along D can be
// nonzero: the two shear waves of waves3 have two components each.  The
// sums below skip the others, which add zero products to a finite sum
// (the same bits) but cost the card an instruction each (IEEE arithmetic
// cannot drop x + 0 * y).
template <int D> HD constexpr bool nz(int p, int e) {
  return (p != 2 && p != 3) || e == 4
         || e == (p == 2 ? 1 + (D + 1) % 3 : 1 + (D + 2) % 3);
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

// ---- limiter, fluctuations, correction flux at D-interface idx (Reg's B
// region); the CFL partial max into cfl ---------------------------------
template <int D, typename T, class S>
HD void item_sweep(const Args<T>& A, Block<T, S>& B, int idx, T& cfl) {
  using R = Reg<S, D>;
  using L = Lay<T, S>;
  constexpr int step = D == 0 ? R::A1 * R::A2 : (D == 1 ? R::A2 : 1);
  const T* W = B.RS();
  T* AMf = B.AMf();
  T* APf = B.APf();
  int b[3];
  dec<R::B0, R::B1, R::B2>(idx, b);
  // dt/dD of the interface's left and right cells, and at the interface
  // (the average of the two with a capacity function)
  T dl = A.C[K3_DTD + D], dr = dl, dtd = dl;
  if constexpr (S::capa) {
    int l[3] = {b[0] + 1, b[1] + 1, b[2] + 1};
    dl = B.K[B.cell(l)];
    l[D] += 1;
    dr = B.K[B.cell(l)];
    dtd = T(0.5) * (dl + dr);
  }
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
      T d = T(0);
      bool first = true;
      for (int e = 0; e < 5; ++e) {
        if (!nz<D>(p, e)) continue;
        d = first ? wn[p][e] * w[p][e] : d + wn[p][e] * w[p][e];
        first = false;
      }
      dl[p] = d;
    }
    waves_at<D, R::AN>(W, own + step, wn, sn);
    for (int p = 0; p < 5; ++p) {
      T d = T(0);
      bool first = true;
      for (int e = 0; e < 5; ++e) {
        if (!nz<D>(p, e)) continue;
        d = first ? w[p][e] * wn[p][e] : d + w[p][e] * wn[p][e];
        first = false;
      }
      dr[p] = d;
    }
    for (int p = 0; p < 5; ++p) {
      const int lid = A.lim[p];
      if (lid == 0) continue;
      T wn2 = T(0);
      bool first = true;
      for (int e = 0; e < 5; ++e) {
        if (!nz<D>(p, e)) continue;
        wn2 = first ? w[p][e] * w[p][e] : wn2 + w[p][e] * w[p][e];
        first = false;
      }
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
      if (!nz<D>(p, e)) continue;   // wave 0 has every component
      T am_t = mn(s[p], T(0)) * w[p][e];
      T ap_t = mx(s[p], T(0)) * w[p][e];
      m = p == 0 ? am_t : m + am_t;
      pp = p == 0 ? ap_t : pp + ap_t;
      if (A.order == 2) {
        T absp = fabs_(s[p]);
        // 0.5 |s| (wave form) or 0.5 sign(s) (f-wave form), sign(0) = 0
        T lead = S::fwave ? T(0.5) * T((s[p] > T(0)) - (s[p] < T(0)))
                          : T(0.5) * absp;
        T coef = lead * (T(1) - absp * dtd);
        T c_t = coef * phi[p] * w[p][e];
        cc = p == 0 ? c_t : cc + c_t;
      }
    }
    am[e] = m;
    ap[e] = pp;
    cq[e] = cc;
  }

  if (A.tw > 0) {
    // the fluctuations the transverse splits take
    const bool both = A.tw >= 2 && A.order == 2;
    for (int e = 0; e < 5; ++e) {
      B.TR[e * L::BM + idx] = both ? am[e] + cq[e] : am[e];
      B.TR[(5 + e) * L::BM + idx] = both ? ap[e] - cq[e] : ap[e];
    }
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
    for (int p = 0; p < 5; ++p) {
      // upwinded with a capacity function: the right cell's dt/(dD kappa)
      // for a right-going wave, the left cell's for a left-going one
      if constexpr (S::capa) cfl = mx(cfl, mx(s[p] * dr, -s[p] * dl));
      else cfl = mx(cfl, dtd * fabs_(s[p]));
    }
  }
}

// ---- first-order fluctuations of tile cell idx -------------------------
// (KAPPA: K holds kappa, and dt/(dD kappa) is divided here)
template <int D, bool KAPPA = false, typename T, class S>
HD void item_fluct(const Args<T>& A, Block<T, S>& B, int idx) {
  using R = Reg<S, D>;
  using L = Lay<T, S>;
  const T* AMf = B.AMf();
  const T* APf = B.APf();
  int c[3];
  dec<S::X, S::Y, S::Z>(idx, c);
  const int l[3] = {c[0] + 2, c[1] + 2, c[2] + 2};
  T dtd = dtd_at<D>(A, B, B.cell(l));
  if constexpr (KAPPA) dtd = dtd_of<D>(A, dtd);
  const int fl = flat<R::F0, R::F1, R::F2>(c);
  c[D] += 1;
  const int fr = flat<R::F0, R::F1, R::F2>(c);
  for (int e = 0; e < 5; ++e)
    B.DQ[e * L::CN + idx] += dtd * (APf[e * L::FM + fl]
                                    + AMf[e * L::FM + fr]);
}

// the B-region index of split-region point s of fluctuation IMP
template <int D, int IMP, class S> HD int b_of(const int s[3]) {
  using R = Reg<S, D>;
  int b[3] = {s[0], s[1], s[2]};
  b[D] += IMP == 1 ? 1 : 0;
  return flat<R::B0, R::B1, R::B2>(b);
}

template <typename T, class S>
HD void load_eig(const Block<T, S>& B, int bi, T eig[7]) {
  using L = Lay<T, S>;
  for (int k = 0; k < 7; ++k) eig[k] = B.EIG[k * L::BM + bi];
}

// ---- rpt3 split of fluctuation IMP along E -> bm (slot sm), bp (sp) ----
template <int D, int E, int IMP, typename T, class S>
HD void item_rpt(const Args<T>& A, Block<T, S>& B, int idx, int sm,
                 int sp) {
  using SR = SReg<S, D>;
  using L = Lay<T, S>;
  T* BM = B.slot(sm);
  T* BP = B.slot(sp);
  int s[3];
  dec<SR::S0, SR::S1, SR::S2>(idx, s);
  const int bi = b_of<D, IMP, S>(s);
  T asdq[5], eig[7], bm[5], bp[5];
  for (int e = 0; e < 5; ++e)
    asdq[e] = B.TR[((IMP - 1) * 5 + e) * L::BM + bi];
  load_eig(B, bi, eig);
  split3<1 + E>(eig, asdq, bm, bp);
  for (int e = 0; e < 5; ++e) {
    BM[e * L::SR + idx] = bm[e];
    BP[e * L::SR + idx] = bp[e];
  }
}

// ---- the E-flux gathers the rpt3 parts of its two neighbours -----------
// F_E at (cell I along D, face J along E, cell K along F) takes
// -(c_bm bm at e-cell J+1 + c_bp bp at e-cell J) of the interface of the
// fluctuation that reaches cell I (split-region index I along D), with c
// = dt/(2 dD), or 0.5 dt/(dD kappa) of the cells (I, J, K) and (I, J-1,
// K) (the tile cells the two parts come from).
template <int D, int E, typename T, class S>
HD void item_gather_e(const Args<T>& A, Block<T, S>& B, int idx, int sm,
                      int sp) {
  using SR = SReg<S, D>;
  using RE = Reg<S, E>;
  using L = Lay<T, S>;
  constexpr int F = 3 - D - E;
  const T* BM = B.slot(sm);
  const T* BP = B.slot(sp);
  T* FE = B.F[E];
  int c[3], k[3];
  dec<RE::F0, RE::F1, RE::F2>(idx, c);
  T h_bm = A.C[K3_HALF + D], h_bp = h_bm;
  if constexpr (S::capa) {
    int l[3] = {c[0] + 2, c[1] + 2, c[2] + 2};
    h_bm = T(0.5) * B.K[B.cell(l)];
    l[E] -= 1;
    h_bp = T(0.5) * B.K[B.cell(l)];
  }
  k[D] = c[D];
  k[F] = c[F] + 1;
  k[E] = c[E] + 1;
  const int k_bm = flat<SR::S0, SR::S1, SR::S2>(k);
  k[E] = c[E];
  const int k_bp = flat<SR::S0, SR::S1, SR::S2>(k);
  for (int e = 0; e < 5; ++e)
    FE[e * RE::FN + idx] += -(h_bm * BM[e * L::SR + k_bm]
                             + h_bp * BP[e * L::SR + k_bp]);
}

// ---- rptt3 split of one rpt3 part (PART 0: bm, 1: bp; slot src) along
// F, scaled by -+dt^2/(6 dD dE), or -+(dt/(6 dE)) dt/(dD kappa) of the
// split point's cell (the down-going part flips its sign), -> cm (slot
// dm), cp (slot dp).  Only where the F-flux gathers read it: e-cells
// 1 .. T_E+1 (bm) or 0 .. T_E (bp) of the split region.
template <int D, int E, int IMP, int PART, typename T, class S>
HD void item_rptt(const Args<T>& A, Block<T, S>& B, int idx, int src,
                  int dm, int dp) {
  using SR = SReg<S, D>;
  using L = Lay<T, S>;
  constexpr int F = 3 - D - E;
  constexpr int N0 = SR::S0 - (E == 0), N1 = SR::S1 - (E == 1);
  constexpr int N2 = SR::S2 - (E == 2);
  const T* BS = B.slot(src);
  T* CM = B.slot(dm);
  T* CP = B.slot(dp);
  int s[3];
  dec<N0, N1, N2>(idx, s);
  s[E] += PART == 0 ? 1 : 0;
  const int si = flat<SR::S0, SR::S1, SR::S2>(s);
  T co = A.C[K3_CO2 + 3 * D + E];
  if constexpr (S::capa) {
    // the split point's cell: the receiving tile cell s[D] along D
    int l[3] = {s[0] + 1, s[1] + 1, s[2] + 1};
    l[D] += 1;
    co = A.C[K3_CO6 + E] * B.K[B.cell(l)];
  }
  if (PART == 0) co = -co;
  T bs[5], eig[7], cm[5], cp[5];
  for (int e = 0; e < 5; ++e) bs[e] = co * BS[e * L::SR + si];
  load_eig(B, b_of<D, IMP, S>(s), eig);
  split3<1 + F>(eig, bs, cm, cp);
  for (int e = 0; e < 5; ++e) {
    CM[e * L::SR + si] = cm[e];
    CP[e * L::SR + si] = cp[e];
  }
}

// ---- the F-flux gathers the rptt3 parts of one rpt3 part ---------------
// F_F at (cell I along D, cell J along E, face K along F) takes, from the
// fluctuation that reaches cell I: + (cm at f-cell K+1 + cp at f-cell K)
// of e-cell J, - the same of e-cell J+1 (bm parts) or J-1 (bp parts).
template <int D, int E, int PART, typename T, class S>
HD void item_gather_f(const Args<T>& A, Block<T, S>& B, int idx, int sm,
                      int sp) {
  using SR = SReg<S, D>;
  using L = Lay<T, S>;
  constexpr int F = 3 - D - E;
  using RF = Reg<S, F>;
  const T* CM = B.slot(sm);
  const T* CP = B.slot(sp);
  T* FF = B.F[F];
  int c[3], k[3];
  dec<RF::F0, RF::F1, RF::F2>(idx, c);
  k[D] = c[D];
  k[E] = c[E] + 1;
  k[F] = c[F] + 1;
  const int own_m = flat<SR::S0, SR::S1, SR::S2>(k);
  k[F] = c[F];
  const int own_p = flat<SR::S0, SR::S1, SR::S2>(k);
  k[E] = c[E] + 1 + (PART == 0 ? 1 : -1);
  const int x_p = flat<SR::S0, SR::S1, SR::S2>(k);
  k[F] = c[F] + 1;
  const int x_m = flat<SR::S0, SR::S1, SR::S2>(k);
  for (int e = 0; e < 5; ++e) {
    T own = CM[e * L::SR + own_m] + CP[e * L::SR + own_p];
    T cross = -CM[e * L::SR + x_m] - CP[e * L::SR + x_p];
    FF[e * RF::FN + idx] += own + cross;
  }
}

// ---- conservative update of tile cell idx ------------------------------
template <typename T, class S>
HD void item_update(const Args<T>& A, Block<T, S>& B, int idx) {
  using L = Lay<T, S>;
  using R0 = Reg<S, 0>;
  using R1 = Reg<S, 1>;
  using R2 = Reg<S, 2>;
  const int n0 = A.N[0] - 4, n1 = A.N[1] - 4, n2 = A.N[2] - 4;
  int c[3];
  dec<S::X, S::Y, S::Z>(idx, c);
  const int I0 = B.C0[0] + c[0], I1 = B.C0[1] + c[1], I2 = B.C0[2] + c[2];
  if (I0 >= A.N[0] - 2 || I1 >= A.N[1] - 2 || I2 >= A.N[2] - 2) return;
  T d0 = A.C[K3_DTD], d1 = A.C[K3_DTD + 1], d2 = A.C[K3_DTD + 2];
  if constexpr (S::capa) {
    // K holds kappa after the last sweep
    const int l[3] = {c[0] + 2, c[1] + 2, c[2] + 2};
    const T kappa = B.K[B.cell(l)];
    d0 = dtd_of<0>(A, kappa);
    d1 = dtd_of<1>(A, kappa);
    d2 = dtd_of<2>(A, kappa);
  }
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
    dq = dq + d0 * (B.F[0][e * R0::FN + x1] - B.F[0][e * R0::FN + x0]);
    dq = dq + d1 * (B.F[1][e * R1::FN + y1] - B.F[1][e * R1::FN + y0]);
    dq = dq + d2 * (B.F[2][e * R2::FN + z1] - B.F[2][e * R2::FN + z0]);
    A.qout[((long long)(e * n0 + I0 - 2) * n1 + (I1 - 2)) * n2 + (I2 - 2)] =
        B.qs(e, c[0] + 2, c[1] + 2, c[2] + 2) - dq;
  }
}

// ---- the phase sequence, shared by the kernel and the host emulation ---
// X(fn) runs fn(tid) for every thread of the block, then a barrier.  A
// phase runs the items of two regions in one index space: f(i) for i in
// [0, n), then g(i) for i in [0, m), so the second region's items fill
// the first's last pass (an rpt3 region of 800 items over 768 threads
// would leave its second pass to one warp).
template <class S, class F, class G>
HD void items2(int tid, int n, const F& f, int m, const G& g) {
  for (int idx = tid; idx < n + m; idx += S::NT) {
    if (idx < n) f(idx);
    else g(idx - n);
  }
}

// items of an rptt3 split region (e-cells 1 .. T_E+1 or 0 .. T_E)
template <class S, int D, int E> struct RReg {
  using SR = SReg<S, D>;
  static constexpr int N = (SR::S0 - (E == 0)) * (SR::S1 - (E == 1))
                           * (SR::S2 - (E == 2));
};

// One fluctuation with rptt3 (iteration I of Rot), in three phases; C
// runs tail(i) over tail_n items, the next split or the next sweep's Roe
// data, beside the last gather; after the last fluctuation (RESTAGE) it
// also stages kappa again: dt/(dE kappa) for the next sweep's axis E, or
// kappa itself for the update.
template <int D, int E, int IMP, int I, bool RESTAGE = false,
          typename T, class S, class X, class C>
HD void transverse_one(const Args<T>& A, Block<T, S>& B, const X& run,
                       int tail_n, const C& tail) {
  using P = Rot<I>;
  constexpr int NE = Reg<S, E>::FN, NF = Reg<S, 3 - D - E>::FN;
  constexpr int NR = RReg<S, D, E>::N;
  run([&](int t) {
    items2<S>(t, NE, [&](int i) {
      item_gather_e<D, E>(A, B, i, P::m, P::p);
    }, NR, [&](int i) {
      item_rptt<D, E, IMP, 0>(A, B, i, P::m, P::a, P::b);
    });
  });
  run([&](int t) {
    items2<S>(t, NF, [&](int i) {
      item_gather_f<D, E, 0>(A, B, i, P::a, P::b);
    }, NR, [&](int i) {
      item_rptt<D, E, IMP, 1>(A, B, i, P::p, P::m, P::x);
    });
  });
  run([&](int t) {
    if constexpr (RESTAGE) restage_issue(A, B, t);
    items2<S>(t, NF, [&](int i) {
      item_gather_f<D, E, 1>(A, B, i, P::m, P::x);
    }, tail_n, tail);
    if constexpr (RESTAGE) restage_finish<D + 1>(A, B, t);
  });
}

// With a capacity function and transverse_waves < 2 the last phase of a
// sweep reads K: kappa is staged again in a phase of its own
template <int NEXT, typename T, class S, class X>
HD void restage_phase(const Args<T>& A, Block<T, S>& B, const X& run) {
  if constexpr (S::capa) {
    run([&](int t) {
      restage_issue(A, B, t);
      restage_finish<NEXT>(A, B, t);
    });
  }
}

template <int D, typename T, class S, class X>
HD void sweep(const Args<T>& A, Block<T, S>& B, const X& run) {
  using R = Reg<S, D>;
  constexpr int E1 = D == 0 ? 1 : 0;
  constexpr int E2 = D == 2 ? 1 : 2;
  constexpr int CN = Lay<T, S>::CN, SN = SReg<S, D>::SN;
  // the next sweep's Roe data, beside this sweep's last phase
  constexpr int NNEXT = D < 2 ? Reg<S, D < 2 ? D + 1 : D>::AN : 0;
  const auto next = [&](int i) {
    if constexpr (D < 2) item_roe<D + 1>(A, B, i);
  };
  const auto fluct = [&](int i) { item_fluct<D>(A, B, i); };
  run([&](int t) {
    T cfl = B.RED[t];
    for (int i = t; i < R::BN; i += S::NT) item_sweep<D>(A, B, i, cfl);
    B.RED[t] = cfl;
  });
  if (A.tw == 0) {
    // fluct<2> runs in the update's phase
    if (D < 2) run([&](int t) { items2<S>(t, CN, fluct, NNEXT, next); });
    restage_phase<D + 1>(A, B, run);
    return;
  }
  if (A.tw == 1) {
    using P0 = Rot1<0>;
    using P1 = Rot1<1>;
    constexpr int NE1 = Reg<S, E1>::FN, NE2 = Reg<S, E2>::FN;
    run([&](int t) {
      items2<S>(t, CN, fluct, SN, [&](int i) {
        item_rpt<D, E1, 1>(A, B, i, P0::m, P0::p);
      });
    });
    run([&](int t) {
      items2<S>(t, NE1, [&](int i) {
        item_gather_e<D, E1>(A, B, i, P0::m, P0::p);
      }, SN, [&](int i) {
        item_rpt<D, E1, 2>(A, B, i, P1::m, P1::p);
      });
    });
    run([&](int t) {
      items2<S>(t, NE1, [&](int i) {
        item_gather_e<D, E1>(A, B, i, P1::m, P1::p);
      }, SN, [&](int i) {
        item_rpt<D, E2, 1>(A, B, i, P0::m, P0::p);
      });
    });
    run([&](int t) {
      items2<S>(t, NE2, [&](int i) {
        item_gather_e<D, E2>(A, B, i, P0::m, P0::p);
      }, SN, [&](int i) {
        item_rpt<D, E2, 2>(A, B, i, P1::m, P1::p);
      });
    });
    run([&](int t) {
      items2<S>(t, NE2, [&](int i) {
        item_gather_e<D, E2>(A, B, i, P1::m, P1::p);
      }, NNEXT, next);
    });
    restage_phase<D + 1>(A, B, run);
    return;
  }
  run([&](int t) {
    items2<S>(t, CN, fluct, SN, [&](int i) {
      item_rpt<D, E1, 1>(A, B, i, Rot<0>::m, Rot<0>::p);
    });
  });
  transverse_one<D, E1, 1, 0>(A, B, run, SN, [&](int i) {
    item_rpt<D, E1, 2>(A, B, i, Rot<1>::m, Rot<1>::p);
  });
  transverse_one<D, E1, 2, 1>(A, B, run, SN, [&](int i) {
    item_rpt<D, E2, 1>(A, B, i, Rot<2>::m, Rot<2>::p);
  });
  transverse_one<D, E2, 1, 2>(A, B, run, SN, [&](int i) {
    item_rpt<D, E2, 2>(A, B, i, Rot<3>::m, Rot<3>::p);
  });
  transverse_one<D, E2, 2, 3, S::capa>(A, B, run, NNEXT, next);
}

// fold thread t's CFL partial into its warp's slot: a shuffle max on the
// card, a loop over the lanes on the host
template <class S, typename T> HD void warp_fold(T* red, int t) {
#if defined(__CUDACC__)
  const T m = warp_max(red[t]);
  if (t % 32 == 0) red[S::NT + t / 32] = m;
#else
  red[S::NT + t / 32] =
      t % 32 == 0 ? red[t] : mx(red[S::NT + t / 32], red[t]);
#endif
}

// the block's CFL partial from the warps' slots
template <typename T, class S> HD T block_cfl(const Block<T, S>& B) {
  T m = B.RED[S::NT];
  for (int w = 1; w < S::NT / 32; ++w) m = mx(m, B.RED[S::NT + w]);
  return m;
}

template <typename T, class S, class X>
HD void step_block(const Args<T>& A, Block<T, S>& B, const X& run) {
  run([&](int t) { phase_load(A, B, t); });
  run([&](int t) {
    for (int i = t; i < Reg<S, 0>::AN; i += S::NT) item_roe<0>(A, B, i);
    if constexpr (S::capa) turn<0>(A, B, t);
  });
  sweep<0>(A, B, run);
  sweep<1>(A, B, run);
  sweep<2>(A, B, run);
  run([&](int t) {
    for (int i = t; i < Lay<T, S>::CN; i += S::NT) {
      if (A.tw == 0) item_fluct<2, S::capa>(A, B, i);
      item_update(A, B, i);
    }
    warp_fold<S>(B.RED, t);
  });
}

template <typename T>
Args<T> make_args(const void* qbc, const void* aux, void* qout, void* cflb,
                  int nxg, int nyg, int nzg, int capa, const double* dt,
                  double dx,
                  double dy, double dz, double g1, int order, int tw,
                  const int* lim) {
  Args<T> A;
  A.qbc = static_cast<const T*>(qbc);
  A.aux = static_cast<const T*>(aux);
  A.qout = static_cast<T*>(qout);
  A.cflb = static_cast<T*>(cflb);
  A.N[0] = nxg;
  A.N[1] = nyg;
  A.N[2] = nzg;
  tile_counts<Shape<T>>(A.N, A.nb);
  A.capa = capa;
  A.dt = dt;
  A.dd[0] = dx;
  A.dd[1] = dy;
  A.dd[2] = dz;
  for (int d = 0; d < 3; ++d) A.d[d] = T(A.dd[d]);
  A.C = nullptr;
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

template <typename T, class S>
__global__ void __launch_bounds__(S::NT, 1) step3_ctu_kernel(Args<T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T coef[NCOEF3];
  A.C = coef;
  Block<T, S> B;
  B.bind(reinterpret_cast<T*>(smem_raw), blockIdx.x);
  tile_origin<S>(A.nb, B.bid, B.C0);
  step_block(A, B, DeviceRun());
  if (threadIdx.x == 0) A.cflb[B.bid] = block_cfl(B);
}

template <typename T, class S> int launch(const Args<T>& A, void* stream) {
  using L = Lay<T, S>;
  static unsigned long long attr_done = 0;
  cudaError_t err = smem_attr_once(
      reinterpret_cast<const void*>(step3_ctu_kernel<T, S>), (int)L::bytes,
      attr_done);
  if (err != cudaSuccess) return (int)err;
  step3_ctu_kernel<T, S><<<nblocks(A), S::NT, L::bytes,
                           static_cast<cudaStream_t>(stream)>>>(A);
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

template <typename T, class S> int launch(Args<T> A, void*) {
  std::vector<T> smem(Lay<T, S>::elems);
  T coef[NCOEF3];
  A.C = coef;
  for (int b = 0; b < nblocks(A); ++b) {
    Block<T, S> B;
    B.bind(smem.data(), b);
    tile_origin<S>(A.nb, B.bid, B.C0);
    step_block(A, B, HostRun<S::NT>());
    A.cflb[b] = block_cfl(B);
  }
  return 0;
}
#endif

// one CTU step in the variant of the capacity row (capa >= 0) and form
template <typename T>
int step(const void* qbc, const void* aux, void* qout, void* cflb, int nxg,
         int nyg, int nzg, int capa, int fwave, const double* dt, double dx,
         double dy, double dz, double g1, int order, int tw, const int* lim,
         void* stream) {
  const Args<T> A = make_args<T>(qbc, aux, qout, cflb, nxg, nyg, nzg, capa,
                                 dt, dx, dy, dz, g1, order, tw, lim);
  if (capa >= 0) {
    return fwave ? launch<T, Var<T, true, true>>(A, stream)
                 : launch<T, Var<T, true, false>>(A, stream);
  }
  return fwave ? launch<T, Var<T, false, true>>(A, stream)
               : launch<T, Var<T, false, false>>(A, stream);
}

template <typename T, bool CAPA, bool FWAVE> constexpr int threads_of() {
  return Var<T, CAPA, FWAVE>::NT;
}

template <typename T, bool CAPA> constexpr int smem_of() {
  return (int)Lay<T, Var<T, CAPA, false>>::bytes;
}

}  // namespace

// ---- plain C interface (loaded with ctypes) ----------------------------
extern "C" {

// Number of blocks (= CFL partials) the kernel writes for a padded grid.
int step3_ctu_blocks(int nxg, int nyg, int nzg, int is_double) {
  const int N[3] = {nxg, nyg, nzg};
  int nb[3];
  if (is_double) tile_counts<Shape<double>>(N, nb);
  else tile_counts<Shape<float>>(N, nb);
  return nb[0] * nb[1] * nb[2];
}

// Threads per block of a variant (reported by chip_smoke.py).
int step3_ctu_threads(int capa, int fwave, int is_double) {
  if (is_double) {
    return capa ? (fwave ? threads_of<double, true, true>()
                         : threads_of<double, true, false>())
                : (fwave ? threads_of<double, false, true>()
                         : threads_of<double, false, false>());
  }
  return capa ? (fwave ? threads_of<float, true, true>()
                       : threads_of<float, true, false>())
              : (fwave ? threads_of<float, false, true>()
                       : threads_of<float, false, false>());
}

// Shared memory bytes per block, without or with a capacity function
// (reported by chip_smoke.py; the f-wave form takes no more).
int step3_ctu_smem_bytes(int capa, int is_double) {
  if (is_double)
    return capa ? smem_of<double, true>() : smem_of<double, false>();
  return capa ? smem_of<float, true>() : smem_of<float, false>();
}

// One CTU step.  qbc: (5, nxg, nyg, nzg) ghost-padded (2 ghost cells),
// qout: (5, nxg-4, nyg-4, nzg-4), cflb: step3_ctu_blocks(...) partial CFL
// maxima; all contiguous, of the type named by the entry.  dt: the step
// in device memory (host memory for the host emulation), a double that
// is exact in the entry's type.  l0..l4: the
// limiter id of each wave.  step3_ctu_<type> runs the wave form without a
// capacity function; step3_ctu_aux_<type> also takes aux (num_aux, nxg,
// nyg, nzg), null when capa < 0, the aux row capa of the capacity
// function or -1, and fwave, the f-wave correction form.  Returns a
// cudaError_t (0 on success).
#if defined(__CUDACC__)
#define STEP3_CTU_ENTRIES(NAME, AUX_NAME, T)                                 \
  int NAME(const void* qbc, void* qout, void* cflb, int nxg, int nyg,        \
           int nzg, const double* dt, double dx, double dy, double dz,      \
           double g1,                                                        \
           int order, int tw, int l0, int l1, int l2, int l3, int l4,       \
           void* stream) {                                                   \
    const int lim[5] = {l0, l1, l2, l3, l4};                                 \
    return step<T>(qbc, nullptr, qout, cflb, nxg, nyg, nzg, -1, 0, dt, dx,   \
                   dy, dz, g1, order, tw, lim, stream);                      \
  }                                                                          \
  int AUX_NAME(const void* qbc, const void* aux, void* qout, void* cflb,     \
               int nxg, int nyg, int nzg, int capa, int fwave,               \
               const double* dt,                                             \
               double dx, double dy, double dz, double g1, int order,        \
               int tw, int l0, int l1, int l2, int l3, int l4,               \
               void* stream) {                                               \
    const int lim[5] = {l0, l1, l2, l3, l4};                                 \
    return step<T>(qbc, aux, qout, cflb, nxg, nyg, nzg, capa, fwave, dt, dx, \
                   dy, dz, g1, order, tw, lim, stream);                      \
  }
STEP3_CTU_ENTRIES(step3_ctu_f32, step3_ctu_aux_f32, float)
STEP3_CTU_ENTRIES(step3_ctu_f64, step3_ctu_aux_f64, double)
#else
#define STEP3_CTU_ENTRIES(NAME, AUX_NAME, T)                                 \
  int NAME(const void* qbc, void* qout, void* cflb, int nxg, int nyg,        \
           int nzg, const double* dt, double dx, double dy, double dz,      \
           double g1,                                                        \
           int order, int tw, int l0, int l1, int l2, int l3, int l4) {     \
    const int lim[5] = {l0, l1, l2, l3, l4};                                 \
    return step<T>(qbc, nullptr, qout, cflb, nxg, nyg, nzg, -1, 0, dt, dx,   \
                   dy, dz, g1, order, tw, lim, nullptr);                     \
  }                                                                          \
  int AUX_NAME(const void* qbc, const void* aux, void* qout, void* cflb,     \
               int nxg, int nyg, int nzg, int capa, int fwave,               \
               const double* dt,                                             \
               double dx, double dy, double dz, double g1, int order,        \
               int tw, int l0, int l1, int l2, int l3, int l4) {             \
    const int lim[5] = {l0, l1, l2, l3, l4};                                 \
    return step<T>(qbc, aux, qout, cflb, nxg, nyg, nzg, capa, fwave, dt, dx, \
                   dy, dz, g1, order, tw, lim, nullptr);                     \
  }
STEP3_CTU_ENTRIES(step3_ctu_host_f32, step3_ctu_aux_host_f32, float)
STEP3_CTU_ENTRIES(step3_ctu_host_f64, step3_ctu_aux_host_f64, double)
#endif
#undef STEP3_CTU_ENTRIES

}  // extern "C"
