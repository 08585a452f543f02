// step2_aos.cu — the whole 2D unsplit classic (CTU) step of the generic
// AoS form, one launch per step, for Hopper (sm_90a): any registered
// system of csrc/shallow2d.cuh, csrc/acoustics2d.cuh, csrc/euler2d_aos.cuh,
// csrc/sw_aug2d.cuh, csrc/scalar2d.cuh, csrc/psystem2d.cuh or
// csrc/shallow_sphere2d.cuh, with aux arrays, a capacity function and the
// f-wave correction form.  Fourteen systems, each a template instance of
// its own (SYS_* below): shallow_roe_with_efix_2D,
// shallow_bathymetry_fwave_2D, acoustics_2D, euler_4wave_2D,
// euler_5wave_2D, sw_aug_2D, advection_2D, vc_advection_2D,
// vc_advection_fwave_2D, vc_acoustics_2D, kpp_2D, burgers_2D, psystem_2D
// and shallow_sphere_fwave_2D.
//
// Replaces the TPU kernels that run the generic body
// pyclaw_tpu/classic/kernels.py:step2 (and its roll form step2_roll):
// pyclaw_tpu/ops/tiled2d.py:step2_pallas_rows with rpn_soa=None
// (pallas_call at :301), ops/tiled2d.py:step2_pallas_tiled_generic (:609)
// and ops/sweep2d.py:step2_pallas (:41), which the JAX package picks by
// grid shape; this kernel takes any (nx, ny).  Its plain PyTorch version
// is pyclaw_tpu_torch/classic/kernels.py:step2, which it is held against on
// the card (chip_smoke.py) and, through the host emulation at the end of
// this file, on the CPU (tests/test_torch_step2_aos.py).
//
// What bounds it on the card: per cell it reads 3 values of q (and 0-2 of
// aux) and writes 3 (least traffic 24 B/cell in f32).  The shallow-water
// systems do ~800 floating-point operations per cell (two normal solves
// with the entropy fix, the limiter, four transverse splits, the fold),
// among them divides and square roots, so they are bound by operations;
// acoustics does ~280 (two waves, no square root): 12 operations per byte
// in f32 and 6 in f64, below the card's 20 and 10, so bytes bound it.
// chip_smoke.py computes both bounds from the counts in
// `FLOPS_PER_CELL_AOS` and `FLOPS_PER_CELL_AOS_ACOUSTICS` there.
//
// Design (that of step2_ctu.cu): a block owns a TX x TY tile of output
// cells and stages q, the aux fields the system reads and, with a capacity
// function, kappa, with a 2-cell halo in shared memory (cp.async,
// csrc/async_copy.cuh).  Each thread stages every field of its cells and,
// after its own wait, computes their per-cell quantities (hu/h, hv/h,
// sqrt(h), sqrt(g h): shallow2d.cuh cell_prep) and turns kappa into the
// per-cell dt/(dx kappa) and dt/(dy kappa).
// Interface quantities live in shared memory only: the waves and speeds of
// each normal solve (for the limiter), the fluctuations, the correction
// flux and the rpt2 parts.  rpt2's scatter into the orthogonal flux is
// written as a gather (no atomics), with the coefficient of the receiving
// cell (flux2.f90 dtdx1d(i1)).  Ragged edges are masked, so any (nx, ny)
// works.  Measured at 1024^2 against the first port in one call (PERF.md
// section 6; H100, 700 W), 0.2435 -> 0.1359 ms in f32 and 0.5398 ->
// 0.2994 ms in f64, lever by lever:
//   - the rpt2 parts live in one scratch array P: the x parts until the
//     y-faces have gathered them, then the y parts, which the update
//     gathers into the x-fluxes.  The first port kept seven fields per
//     interface of each direction to the end (amdq, apdq, cq and the four
//     parts): 74,672 B a block in f32 on a 16x16 tile; now 50,276 B on a
//     12x15 tile (Shape below), with 61-64 registers four blocks of 8
//     warps per SM (two in f64); 6 barriers a block in place of 14 (the
//     y-faces gather the x parts in the phase of the y normal solves, the
//     CFL partial is a warp-shuffle max and one slot per warp); cp.async
//     staging; the two splits of an interface share its Roe average; the
//     limiter's dot products and the correction sums skip the components
//     the shear wave never has (sw_nz): 0.2090 / 0.4515 ms, the same bits;
//   - the f32 tile 12x16 -> 12x15, so that the x normal-solve region
//     (15 x 17 interfaces) takes one pass of the 256 threads: 0.1887 ms;
//   - the per-cell quantities computed once per staged cell where each
//     normal solve and each split's Roe average took them per interface
//     (four divisions and four square roots fewer per normal solve, four
//     and two per split pair): 0.1522 / 0.3428 ms, the same bits;
//   - one IEEE reciprocal of c per interface that its two splits multiply
//     by where each divided twice (roundoff; no gate reads it: the
//     splits' speeds and the normal solve's strengths keep their
//     divisions): 0.1359 / 0.2994 ms.
// The gathered sums keep the first port's order: each flux takes its cq,
// then the sum of the parts of amdq, then that of apdq.
//
// The Euler 4- and 5-wave systems and sw_aug_2D were added after the
// redesign; their Args take one limiter id per wave (five for the 5-wave
// system; the first three systems' Args keep their three, so their code
// is unchanged: the same SASS and bits as before, ops/time_kernels.py
// step2_aos against the earlier build).  sw_aug_2D keeps the design.
// The Euler systems have a design of their own (the section "the Euler
// systems" below; S::NR marks it), fitted to them later with the same
// bits (the host emulations and the card agree with the earlier design
// bit for bit, q and the CFL): their first port in this design held every
// interface's 20 / 30 wave components and speeds in shared memory, 69 /
// 93 KB a block in f32 and 137 / 184 KB in f64, so f64 ran 1 block (8
// warps) an SM, 3.4-3.6x its f32 time where shallow water's is 2.2x.  Now
//   - each normal solve stores a record of 8 / 10 values (the strengths
//     and the Roe average), from which the sweep forms again each wave's
//     components and speed by the expressions the solve formed them by
//     (the same bits under -fmad=false), and the splits take their Roe
//     average (no division or square root of their own, no cell read);
//   - the buffers are laid out by lifetime: the x parts die at the
//     gather, which has a phase of its own; the x fluctuations at
//     sweep<0>, after each cell keeps apdq + amdq of its x-faces (the
//     first sum of its update); q and the per-cell quantities after the
//     y normal solves (the update reads q from the grid);
//   - a tile and launch bound of their own (SysShape): 12x15 in f32 at 3
//     blocks an SM (4 for 5 waves), 11x15 at 2 in f64.
// 44 / 57 KB a block in f32, 82 / 106 KB in f64; no spills.  Measured
// against the earlier design in one call (PERF.md section 6; H100,
// 700 W), device ms f32 / f64: Euler 4-wave 0.179 -> 0.156 / 0.648 ->
// 0.338, Euler 5-wave 0.257 -> 0.215 / 0.865 -> 0.377, and 0.195 in f32
// at 4 blocks an SM (another call); sw_aug_2D 0.18 / 0.50 ms.
//
// The scalar and variable-coefficient systems (advection_2D,
// vc_advection_2D, vc_advection_fwave_2D, vc_acoustics_2D, kpp_2D,
// burgers_2D; added after the Euler ones) keep the design, the tile and
// the first systems' Args (two physics scalars: (u, v) for advection_2D,
// the efix flag for Burgers).  Four of them split a fluctuation by the
// cell it enters, not by the interface: Burgers by that cell's state,
// the variable-coefficient advection by the transverse edge velocities
// of that cell and of the one above it, the heterogeneous acoustics by
// the impedance and sound speed of that cell and of its two transverse
// neighbours, which the plain version takes by a torch.roll of the
// receiving cells' aux.  Their hook is S::rpt, marked by S::CELL_SPLIT
// (cell_split below): it reads the staged cells, which the split region
// and its neighbours keep inside the tile and its halo; the Trans hook of
// the earlier systems and their code are unchanged (the same SASS and
// bits, time_kernels --sass against the earlier build).  Measured on each
// run's first state at 1024^2 (PERF.md section 6; H100, 700 W), device
// ms f32 / f64: kpp_2D 0.040 / 0.074, vc_acoustics_2D 0.096 / 0.207,
// vc_advection_2D 0.033 / 0.048, advection_2D 0.039 / 0.066,
// vc_advection_fwave_2D 0.042 / 0.071, burgers_2D 0.036 / 0.050: bytes
// bound them at 2.5-10 µs.
//
// psystem_2D and shallow_sphere_fwave_2D (added after the scalar ones)
// have no transverse solver, as their records have no rpt: the JAX
// package's generic body skips the transverse pass for them
// (pyclaw_tpu/classic/kernels.py:237).  Their system structs say so
// (S::NO_TRANS): the step runs with transverse_waves 0 whatever the caller
// passes, and no split is compiled for them.  shallow_sphere_fwave_2D
// reads aux row 1 alone (kappa): it stages that row only (S::AUX0, Aux0
// below).  psystem_2D's per-cell
// quantities need the cell's aux (rho, K): its hook is S::prep_aux
// (PrepAux below), called where the others' S::prep is.  The earlier
// systems' code is unchanged (time_kernels --sass against the earlier
// build).
//
// psystem_2D and vc_advection_2D have designs of their own (the section
// "psystem_2D and vc_advection_2D" below; Own marks them by their exact
// type, so that VcAdvectionFwave2D keeps the generic design), fitted to
// them later with the same bits (the host emulations and the card agree
// with the generic design bit for bit, q and the CFL).  The generic
// design, fitted to shallow water's ~800 operations a cell, gave them
// scratch they never read: the p-system runs no transverse pass, yet its
// 12x15 tile held the rpt2 parts and their sums and every wave's three
// components and speed (50 / 98 KB a block, 2 blocks an SM in f64); the
// scalar advection's 16 B and ~70 operations a cell went through six
// barrier-separated phases on a tile of 180 cells.  Now
//   - psystem_2D stores each normal solve as its two strengths and forms
//     the waves again from them and the cells' impedances by the solve's
//     own expressions (the same bits under -fmad=false); the sweeps keep
//     each wave's correction coefficient over the dead u, v and sigma;
//     four phases on a 16x32 tile (rows x columns), 24 / 48 KB;
//   - vc_advection_2D stages q and its edge velocities and stores only
//     each interface's correction flux: the wave, speed, fluctuations
//     and rpt2 parts are a difference and a few products of staged
//     values, formed where they are used (the update forms the parts of
//     the twelve interfaces around its cell in place of a gather); three
//     phases on a 32x32 tile, 25 / 49 KB.
// No spills in the paths' variants.  Measured on each run's first state
// at 1024^2 against the generic design in one call (PERF.md section 6,
// PR 25, run 2; H100 80GB HBM3, 700 W), device ms f32 / f64: psystem_2D
// 0.0818 -> 0.0487 / 0.1613 -> 0.0834, vc_advection_2D (tw 0) 0.0333 ->
// 0.0198 / 0.0482 -> 0.0294 (tw 1 and 2 -32..-43%).
//
// Phases (each a loop of the block's threads over one or two regions,
// separated by barriers):
//   load      q, aux, kappa tile + halo -> shared (indices clamped to the
//             padded grid; clamped cells only feed masked-out results)
//   rpn<0>    x-interface waves, speeds -> W; fluctuations -> OX
//   sweep<0>  x-interface limiter, correction flux cq -> OX, the rpt2
//             splits of amdq(+cq) and apdq(-cq) -> P; CFL partial max
//   gather_y + rpn<1>  each y-face of the tile sums the x parts of its
//             four neighbour x-interfaces from P into OY; the y-interface
//             waves -> W (reused), fluctuations -> OY
//   sweep<1>  the same for y: the y-face flux is cq minus the two sums;
//             the y parts -> P
//   update    each cell gathers the y parts of its two x-faces' four
//             neighbour y-interfaces into Fx and applies the conservative
//             update; each warp's CFL maxima
//
// Template parameters: the system (its hooks: the type of its physics
// scalars in Args (Par, set by make_par), its per-cell quantities (prep,
// NPC of them), the wave components that can be nonzero (nz: the
// limiter's dot products and the correction sums skip the others), its
// normal solve (rpn) and the transverse split of an interface (Trans) or
// of a receiving cell (rpt, CELL_SPLIT);
// every per-wave loop runs over its NW waves), the type, the tile, CAPA
// (per-cell dtdx) and FWAVE (the correction form 0.5 sign(s) (1 - |s|
// dt/dx), with sign(0) = 0).  The arithmetic
// repeats the plain version operation for operation, and the source is
// built without fused multiply-adds (ops/_build.py: -fmad=false), so each
// operation rounds as PyTorch's does: the f-wave correction and split
// jump where a speed crosses zero, and a contracted multiply-add that
// moved such a speed across zero moved the result by a whole wave.

#include <type_traits>

#include "acoustics2d.cuh"
#include "async_copy.cuh"
#include "dt_coef.cuh"
#include "euler2d_aos.cuh"
#include "psystem2d.cuh"
#include "scalar2d.cuh"
#include "shallow2d.cuh"
#include "shallow_sphere2d.cuh"
#include "sw_aug2d.cuh"
#include "tvd.cuh"

namespace {

// Whether system S splits a fluctuation by the cell it enters (S::rpt: the
// state of that cell and the aux of it and of its two neighbours along the
// transverse axis; S::CELL_SPLIT) rather than by the interface (S::Trans,
// the systems without the member)
template <class S, class = void> struct CellSplit : std::false_type {};
template <class S>
struct CellSplit<S, std::void_t<decltype(S::CELL_SPLIT)>>
    : std::integral_constant<bool, S::CELL_SPLIT> {};

// Whether system S has no transverse solver (S::NO_TRANS): its step runs
// no transverse pass
template <class S, class = void> struct NoTrans : std::false_type {};
template <class S>
struct NoTrans<S, std::void_t<decltype(S::NO_TRANS)>>
    : std::integral_constant<bool, S::NO_TRANS> {};

// The first aux row system S reads (S::AUX0; 0 for the systems without
// the member): its solvers read aux rows AUX0 .. AUX0 + NAUX - 1, which
// make_args hands the kernel as its rows 0 .. NAUX - 1
template <class S, class = void>
struct Aux0 : std::integral_constant<int, 0> {};
template <class S>
struct Aux0<S, std::void_t<decltype(S::AUX0)>>
    : std::integral_constant<int, S::AUX0> {};

// Whether system S's per-cell quantities take the cell's aux as well as
// its state (S::prep_aux(P, q, aux, pc)) rather than its state alone
// (S::prep(P, q, pc))
template <class S, class = void> struct PrepAux : std::false_type {};
template <class S>
struct PrepAux<S, std::void_t<decltype(&S::template prep_aux<float>)>>
    : std::true_type {};

constexpr int NT = 256;  // threads per block

// Whether system S stores its normal solves compactly (S::NR values a
// record; the Euler systems): the design of the section "the Euler
// systems" below
template <class S, class = void> struct Compact : std::false_type {};
template <class S>
struct Compact<S, std::void_t<decltype(S::NR)>> : std::true_type {};

// Tile shape per type (TX x TY cells) and blocks per SM (the launch
// bound; f32 fits four by its registers and shared memory): 12x15 in f32,
// 11x16 in f64, so that each normal-solve region ((TX+3) x (TY+2),
// (TX+2) x (TY+3) interfaces) and each sweep region ((TX+1) x (TY+2),
// (TX+2) x (TY+1)) is one pass of the 256 threads (the first port's 16x16
// and 8x16 left up to 86 items to a second pass; step2_ctu.cu's 12x16
// left 14 of the x normal solves, the costliest items here).
template <typename T> struct Shape;
template <> struct Shape<float> {
  static constexpr int TX = 12, TY = 15, PER_SM = 3;
};
template <> struct Shape<double> {
  static constexpr int TX = 11, TY = 16, PER_SM = 2;
};
// Tile and blocks per SM of system S: Shape's, but for the compact
// systems, whose tile sets their shared memory (CTile below): 12x15 in
// f32 at 4 blocks an SM for 5 waves (64 registers, no spills) and 3 for
// 4 waves (4 were 1% slower), 11x15 at 2 in f64 (11x16 would not leave
// room for two blocks with a capacity function; 12x14 spilled in the
// f-wave variants); every region but sweep<0>'s is one pass of the 256
// threads (its AX items fill a second)
template <typename S, typename T, bool = Compact<S>::value>
struct SysShape : Shape<T> {};
template <typename S> struct SysShape<S, float, true> {
  static constexpr int TX = 12, TY = 15, PER_SM = S::NW == 5 ? 4 : 3;
};
template <typename S> struct SysShape<S, double, true> {
  static constexpr int TX = 11, TY = 15, PER_SM = 2;
};

// The systems with a design of their own (the section "psystem_2D and
// vc_advection_2D" below), keyed on the exact type: a system derived from
// one of them (VcAdvectionFwave2D from VcAdvection2D) keeps the generic
// design
enum { OWN_NONE = 0, OWN_PSYSTEM = 1, OWN_VC_ADVECTION = 2 };
template <class S> struct Own : std::integral_constant<int, OWN_NONE> {};
template <> struct Own<Psystem2D>
    : std::integral_constant<int, OWN_PSYSTEM> {};
template <> struct Own<VcAdvection2D>
    : std::integral_constant<int, OWN_VC_ADVECTION> {};
// their tiles (rows x columns; a warp spans a row of 32 columns) and
// blocks per SM, each the fastest of those timed without spills in a
// path's variant (PERF.md section 6, PR 25): the p-system 16x32 at 4 / 3
// (8x32 and 32x32 slower; 5 and 6 blocks in f32 no faster; 4 in f64
// spilled), the advection 32x32 at 4 / 3 (6 / 4 spilled in the variants
// without capacity; 16x32 slower; 64x32 5% faster at tw 0 in f32, 13%
// slower at tw 2)
template <> struct SysShape<Psystem2D, float, false> {
  static constexpr int TX = 16, TY = 32, PER_SM = 4;
};
template <> struct SysShape<Psystem2D, double, false> {
  static constexpr int TX = 16, TY = 32, PER_SM = 3;
};
template <> struct SysShape<VcAdvection2D, float, false> {
  static constexpr int TX = 32, TY = 32, PER_SM = 4;
};
template <> struct SysShape<VcAdvection2D, double, false> {
  static constexpr int TX = 32, TY = 32, PER_SM = 3;
};

template <typename S, typename T, int TX, int TY, bool CAPA> struct Tile {
  static constexpr int NEQ = S::NEQ, NW = S::NW, NAUX = S::NAUX;
  static constexpr int NPC = S::NPC;                  // per-cell quantities
  static constexpr int NPL = NPC > 0 ? NPC : 1;       // (a local array's)
  static constexpr int QR = TX + 4, QC = TY + 4, QN = QR * QC;  // + halo
  static constexpr int WXR = TX + 3, WXC = TY + 2;    // x solve region
  static constexpr int WYR = TX + 2, WYC = TY + 3;    // y solve region
  static constexpr int WN = WXR * WXC > WYR * WYC ? WXR * WXC : WYR * WYC;
  static constexpr int NWF = NW * NEQ + NW;           // waves, speeds
  static constexpr int OXR = TX + 1, OXC = TY + 2;    // x-interface outputs
  static constexpr int OYR = TX + 2, OYC = TY + 1;    // y-interface outputs
  static constexpr int OXN = OXR * OXC, OYN = OYR * OYC;
  static constexpr int SN = OXN > OYN ? OXN : OYN;
  // OX: amdq apdq cq; OY: amdq apdq and the two sums of gathered x parts
  // (the first becomes the y-face flux); P: the four rpt2 parts; NEQ each
  static constexpr int NOX = 3 * NEQ, NOY = 4 * NEQ, NSF = 4 * NEQ;
  static constexpr size_t elems = NEQ * QN + NAUX * QN + (CAPA ? 2 * QN : 0)
      + NPC * QN + NWF * WN + NOX * OXN + NOY * OYN + NSF * SN + 2 * (NT / 32);
  static constexpr size_t bytes = elems * sizeof(T);
};

// field offsets inside an O array (times NEQ): in OY, F_CQ holds the sum
// of the amdq parts, then the flux, and F_SB the sum of the apdq parts
enum { F_AM = 0, F_AP = 1, F_CQ = 2, F_SB = 3 };
// the rpt2 parts in P (times NEQ): bm, bp of amdq(+cq), of apdq(-cq)
enum { F_T0 = 0, F_T1 = 1, F_T2 = 2, F_T3 = 3 };

// NL limiter ids: one per wave, three for the systems of fewer waves (the
// Args of the first three systems, as they were before the Euler ones)
template <typename T, typename Par, int NL> struct Args {
  const T* qbc;
  const T* aux;
  T* qout;
  T* cflb;
  int NX, NY;           // padded (ghost-extended) extents
  int capa;             // aux row of the capacity function (CAPA only)
  const double* dt;     // the step (dt_coef.cuh)
  T dx, dy;             // for the per-cell dt/(dx kappa)
  double ddx, ddy;      // for the coefficients of dt
  T* C;                 // the block's coefficients of dt (shared memory)
  Par P;                // the system's physics scalars (S::Par<T>)
  int order, tw;
  int lim[NL];
};

// the limiter ids of system S's Args
template <typename S> constexpr int nlim() { return S::NW > 3 ? S::NW : 3; }

// the arguments of a step of system S in type T
template <typename S, typename T>
using SysArgs = Args<T, typename S::template Par<T>, nlim<S>()>;

// The coefficients of dt in Args::C: dt/dx, dt/dy, 0.5 dt/dx, 0.5 dt/dy,
// the plain version's Python floats rounded once to T (dt_coef.cuh)
enum { C_DTDX = 0, C_DTDY = 1, C_HDX = 2, C_HDY = 3, NCOEF = 4 };

template <typename T, typename Par, int NL>
HD T dt_coef(const Args<T, Par, NL>& A, int k) {
  const double q = *A.dt / (k % 2 == 0 ? A.ddx : A.ddy);
  return T(k < C_HDX ? q : 0.5 * q);
}

template <typename S, typename T, int TX, int TY, bool CAPA_> struct Block {
  using Sys = S;
  using Type = T;
  static constexpr bool CAPA = CAPA_;
  using L = Tile<S, T, TX, TY, CAPA>;
  T* q;    // [NEQ][QR][QC]
  T* a;    // [NAUX][QR][QC]
  T* DX;   // [QR][QC] dt/(dx kappa) (CAPA)
  T* DY;   // [QR][QC] dt/(dy kappa) (CAPA)
  T* PC;   // [NPC][QR][QC] the per-cell quantities (S::prep)
  T* W;    // [NWF][WN]: wave p component e at (p*NEQ+e), speeds after
  T* OX;   // [NOX][OXN]
  T* OY;   // [NOY][OYN]
  T* P;    // [NSF][SN]: the x, then the y, rpt2 parts
  T* rx;   // [NT / 32] x CFL partial max of each warp
  T* ry;   // the same for y
  int I0, J0, bid;  // first interior cell of the tile (padded indices)

  HD void bind(T* s, int bx, int by, int nbx) {
    q = s;
    a = q + L::NEQ * L::QN;
    DX = a + L::NAUX * L::QN;
    DY = DX + (CAPA ? L::QN : 0);
    PC = DY + (CAPA ? L::QN : 0);
    W = PC + L::NPC * L::QN;
    OX = W + L::NWF * L::WN;
    OY = OX + L::NOX * L::OXN;
    P = OY + L::NOY * L::OYN;
    rx = P + L::NSF * L::SN;
    ry = rx + NT / 32;
    I0 = 2 + by * TX;
    J0 = 2 + bx * TY;
    bid = by * nbx + bx;
  }
  HD void cell(int r, int c, T qv[], T av[]) const {
    for (int e = 0; e < L::NEQ; ++e) qv[e] = q[e * L::QN + r * L::QC + c];
    for (int m = 0; m < L::NAUX; ++m) av[m] = a[m * L::QN + r * L::QC + c];
  }
  HD void aux_of(int r, int c, T av[]) const {
    for (int m = 0; m < L::NAUX; ++m) av[m] = a[m * L::QN + r * L::QC + c];
  }
  HD void prep(int r, int c, T pv[]) const {
    for (int k = 0; k < L::NPC; ++k) pv[k] = PC[k * L::QN + r * L::QC + c];
  }
  // dt/dx (D = 0) or dt/dy (D = 1) of the tile cell (r, c)
  template <int D> HD T dtd(const SysArgs<S, T>& A, int r, int c) const {
    if (CAPA) return (D == 0 ? DX : DY)[r * L::QC + c];
    return A.C[D == 0 ? C_DTDX : C_DTDY];
  }
};

// ---- phase: stage q, aux, kappa tile + halo ------------------------------
// Every copy is issued (cp.async) before any is waited on; kappa lands in
// DX, and the thread that copied it turns it into dt/(dx kappa) and
// dt/(dy kappa) in place after its own wait.
template <class Blk>
HD void phase_load(const SysArgs<typename Blk::Sys, typename Blk::Type>& A,
                   Blk& B, int tid) {
  using S = typename Blk::Sys;
  using T = typename Blk::Type;
  using L = typename Blk::L;
  constexpr bool CAPA = Blk::CAPA;
  const long long plane = (long long)A.NX * A.NY;
  // each thread stages every field of its cells
  for (int rc = tid; rc < L::QN; rc += NT) {
    int r = rc / L::QC, c = rc % L::QC;
    int I = B.I0 - 2 + r, J = B.J0 - 2 + c;
    I = I < A.NX ? I : A.NX - 1;
    J = J < A.NY ? J : A.NY - 1;
    const long long off = (long long)I * A.NY + J;
    for (int f = 0; f < L::NEQ; ++f)
      copy_async(B.q + f * L::QN + rc, A.qbc + f * plane + off);
    for (int m = 0; m < L::NAUX; ++m)
      copy_async(B.a + m * L::QN + rc, A.aux + m * plane + off);
    if (CAPA) copy_async(B.DX + rc, A.aux + A.capa * plane + off);
  }
  if (tid < NT / 32) {
    B.rx[tid] = T(0);
    B.ry[tid] = T(0);
  }
  // the block's coefficients of dt while the copies land
  if (tid < NCOEF) A.C[tid] = dt_coef(A, tid);
  copy_wait_all();
  for (int rc = tid; rc < L::QN; rc += NT) {
    T qv[L::NEQ], pv[L::NPL];
    for (int f = 0; f < L::NEQ; ++f) qv[f] = B.q[f * L::QN + rc];
    if constexpr (PrepAux<S>::value) {
      T av[L::NAUX];
      for (int m = 0; m < L::NAUX; ++m) av[m] = B.a[m * L::QN + rc];
      S::prep_aux(A.P, qv, av, pv);
    } else {
      S::prep(A.P, qv, pv);
    }
    for (int k = 0; k < L::NPC; ++k) B.PC[k * L::QN + rc] = pv[k];
    if (CAPA) {
      // dt / (dx kappa): the plain version's 0-d dt over (dx * kappa)
      const T kappa = B.DX[rc], dt = T(*A.dt);
      B.DY[rc] = dt / (A.dy * kappa);
      B.DX[rc] = dt / (A.dx * kappa);
    }
  }
}

// ---- normal solve at one interface of the region of axis IXY ------------
template <int IXY, typename S, typename T, int TX, int TY, bool CAPA>
HD void item_rpn(const SysArgs<S, T>& A, Block<S, T, TX, TY, CAPA>& B,
                 int idx) {
  using L = Tile<S, T, TX, TY, CAPA>;
  constexpr int NEQ = L::NEQ, NW = L::NW;
  constexpr int C = IXY == 0 ? L::WXC : L::WYC;
  constexpr int OC = IXY == 0 ? L::OXC : L::OYC;
  constexpr int ON = IXY == 0 ? L::OXN : L::OYN;
  T* O = IXY == 0 ? B.OX : B.OY;
  int r = idx / C, c = idx % C;
  // left cell: x (r, c+1), y (r+1, c); right cell (r+1, c+1)
  T ql[NEQ], qr[NEQ], al[L::NAUX + 1], ar[L::NAUX + 1], pl[L::NPL];
  T pr[L::NPL];
  B.cell(IXY == 0 ? r : r + 1, IXY == 0 ? c + 1 : c, ql, al);
  B.prep(IXY == 0 ? r : r + 1, IXY == 0 ? c + 1 : c, pl);
  B.cell(r + 1, c + 1, qr, ar);
  B.prep(r + 1, c + 1, pr);
  T w[NW][NEQ], s[NW], am[NEQ], ap[NEQ];
  S::template rpn<IXY, T>(A.P, ql, qr, al, ar, pl, pr, w, s, am, ap);
  for (int p = 0; p < NW; ++p) {
    for (int e = 0; e < NEQ; ++e) B.W[(p * NEQ + e) * L::WN + idx] = w[p][e];
    B.W[(NW * NEQ + p) * L::WN + idx] = s[p];
  }
  // the fluctuations of the interfaces the sweep phase keeps
  int orow = IXY == 0 ? r - 1 : r, ocol = IXY == 0 ? c : c - 1;
  int orows = IXY == 0 ? L::OXR : L::OYR;
  if (orow >= 0 && orow < orows && ocol >= 0 && ocol < OC) {
    int o = orow * OC + ocol;
    for (int e = 0; e < NEQ; ++e) {
      O[(F_AM * NEQ + e) * ON + o] = am[e];
      O[(F_AP * NEQ + e) * ON + o] = ap[e];
    }
  }
}

// ---- the transverse split of a CELL_SPLIT system: the fluctuation asdq
// entering the staged cell (r, c), by its state and the aux of it and of
// its neighbours below and above along the transverse axis (y for an
// x-interface, x for a y-interface).  The split regions reach cells
// 1 .. TX+2 (TY+2) of the staged tile along the transverse axis, so the
// neighbours lie in 0 .. TX+3 (TY+3): inside the tile and its halo; a
// neighbour clamped at the padded grid's upper edge feeds only parts
// that no kept face gathers (the plain version's wrapped row) ----------
template <int IXY, typename S, typename T, int TX, int TY, bool CAPA>
HD void cell_split(const SysArgs<S, T>& A,
                   const Block<S, T, TX, TY, CAPA>& B, int r, int c,
                   const T asdq[], T bm[], T bp[]) {
  using L = Tile<S, T, TX, TY, CAPA>;
  constexpr int dr = IXY == 0 ? 0 : 1, dc = IXY == 0 ? 1 : 0;
  T qc[L::NEQ], ab[L::NAUX + 1], ac[L::NAUX + 1], aa[L::NAUX + 1];
  B.cell(r, c, qc, ac);
  B.aux_of(r - dr, c - dc, ab);
  B.aux_of(r + dr, c + dc, aa);
  S::template rpt<IXY, T>(A.P, qc, ab, ac, aa, asdq, bm, bp);
}

// fold thread t's CFL partial into its warp's slot: a shuffle max on the
// card, a loop over the lanes on the host
template <typename T> HD void warp_fold(T* red, int t, T v) {
#if defined(__CUDACC__)
  const T m = warp_max(v);
  if (t % 32 == 0) red[t / 32] = mx(red[t / 32], m);
#else
  red[t / 32] = mx(red[t / 32], v);
#endif
}

// ---- phase: limiter, correction flux, transverse split, CFL --------------
template <int IXY, bool FWAVE, typename S, typename T, int TX, int TY,
          bool CAPA>
HD void phase_sweep(const SysArgs<S, T>& A, Block<S, T, TX, TY, CAPA>& B,
                    int tid) {
  using L = Tile<S, T, TX, TY, CAPA>;
  constexpr int NEQ = L::NEQ, NW = L::NW, WN = L::WN, SN = L::SN;
  constexpr int R = IXY == 0 ? L::OXR : L::OYR;
  constexpr int C = IXY == 0 ? L::OXC : L::OYC;
  constexpr int WC = IXY == 0 ? L::WXC : L::WYC;
  constexpr int ON = R * C;
  T* O = IXY == 0 ? B.OX : B.OY;
  T cmax = T(0);
  for (int idx = tid; idx < ON; idx += NT) {
    int r = idx / C, c = idx % C;
    // own interface and its lower/upper neighbours along the sweep axis
    int own = IXY == 0 ? (r + 1) * WC + c : r * WC + c + 1;
    int lo = r * WC + c;
    int hi = IXY == 0 ? (r + 2) * WC + c : r * WC + c + 2;
    // the interface's left and right cells in the tile
    int lr = r + 1, lc = c + 1;
    int rr = IXY == 0 ? r + 2 : r + 1, rc = IXY == 0 ? c + 1 : c + 2;
    const T dl = B.template dtd<IXY>(A, lr, lc);
    const T dr = B.template dtd<IXY>(A, rr, rc);
    const T dtdx = CAPA ? T(0.5) * (dl + dr) : dl;
    T w[NW][NEQ], s[NW];
    for (int p = 0; p < NW; ++p) {
      for (int e = 0; e < NEQ; ++e) w[p][e] = B.W[(p * NEQ + e) * WN + own];
      s[p] = B.W[(NW * NEQ + p) * WN + own];
    }

    T cq[NEQ];
    for (int e = 0; e < NEQ; ++e) cq[e] = T(0);
    if (A.order == 2) {
      T cf[NW];
      for (int p = 0; p < NW; ++p) {
        // the products with the shear wave's zero components are skipped
        // (each adds a zero to a finite sum: the same bits)
        T wn2 = T(0), dlo = T(0), dhi = T(0);
        bool first = true;
        for (int e = 0; e < NEQ; ++e) {
          if (!S::template nz<IXY>(p, e)) continue;
          const T wl = B.W[(p * NEQ + e) * WN + lo];
          const T wh = B.W[(p * NEQ + e) * WN + hi];
          wn2 = first ? w[p][e] * w[p][e] : wn2 + w[p][e] * w[p][e];
          dlo = first ? wl * w[p][e] : dlo + wl * w[p][e];
          dhi = first ? w[p][e] * wh : dhi + w[p][e] * wh;
          first = false;
        }
        T phi = T(1);
        const int lid = A.lim[p];
        if (lid != 0) {
          const bool safe = wn2 > T(0);
          const T theta = safe ? (s[p] > T(0) ? dlo : dhi) / wn2 : T(0);
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
        for (int p = 1; p < NW; ++p) {
          if (S::template nz<IXY>(p, e)) acc = acc + cf[p] * w[p][e];
        }
        cq[e] = acc;
      }
    }
    if (IXY == 0) {
      for (int e = 0; e < NEQ; ++e) O[(F_CQ * NEQ + e) * ON + idx] = cq[e];
    } else {
      // a y-face of the tile: cq minus the gathered sums, in the first
      // port's order
      const bool face = A.tw > 0 && r >= 1 && r <= TX;
      for (int e = 0; e < NEQ; ++e) {
        T* g = O + (F_CQ * NEQ + e) * ON + idx;
        *g = face ? cq[e] - *g - O[(F_SB * NEQ + e) * ON + idx] : cq[e];
      }
    }

    if constexpr (!NoTrans<S>::value) if (A.tw > 0) {
      const bool both = A.tw >= 2 && A.order == 2;
      T amt[NEQ], apt[NEQ], bm[NEQ], bp[NEQ], ql[NEQ], qr[NEQ];
      T ax[L::NAUX + 1], pl[L::NPL], pr[L::NPL];
      for (int e = 0; e < NEQ; ++e) {
        const T am = O[(F_AM * NEQ + e) * ON + idx];
        const T ap = O[(F_AP * NEQ + e) * ON + idx];
        amt[e] = both ? am + cq[e] : am;
        apt[e] = both ? ap - cq[e] : ap;
      }
      if constexpr (CellSplit<S>::value) {
        // amdq enters the left cell, apdq the right one
        cell_split<IXY>(A, B, lr, lc, amt, bm, bp);
        for (int e = 0; e < NEQ; ++e) {
          B.P[(F_T0 * NEQ + e) * SN + idx] = bm[e];
          B.P[(F_T1 * NEQ + e) * SN + idx] = bp[e];
        }
        cell_split<IXY>(A, B, rr, rc, apt, bm, bp);
        for (int e = 0; e < NEQ; ++e) {
          B.P[(F_T2 * NEQ + e) * SN + idx] = bm[e];
          B.P[(F_T3 * NEQ + e) * SN + idx] = bp[e];
        }
      } else {
        B.cell(lr, lc, ql, ax);
        B.cell(rr, rc, qr, ax);
        B.prep(lr, lc, pl);
        B.prep(rr, rc, pr);
        const typename S::template Trans<IXY, T> tr(A.P, ql, qr, pl, pr);
        tr.split(amt, bm, bp);
        for (int e = 0; e < NEQ; ++e) {
          B.P[(F_T0 * NEQ + e) * SN + idx] = bm[e];
          B.P[(F_T1 * NEQ + e) * SN + idx] = bp[e];
        }
        tr.split(apt, bm, bp);
        for (int e = 0; e < NEQ; ++e) {
          B.P[(F_T2 * NEQ + e) * SN + idx] = bm[e];
          B.P[(F_T3 * NEQ + e) * SN + idx] = bp[e];
        }
      }
    }

    // CFL window: interfaces touching the interior (kernels.py step2)
    bool in_cfl;
    if (IXY == 0) {   // x-interface k = I0-1+r, column J = J0-1+c
      int k = B.I0 - 1 + r, J = B.J0 - 1 + c;
      in_cfl = k < A.NX - 2 && c >= 1 && c <= TY && J < A.NY - 2;
    } else {          // y-interface row i = I0-1+r, j = J0-1+c
      int i = B.I0 - 1 + r, j = B.J0 - 1 + c;
      in_cfl = r >= 1 && r <= TX && i < A.NX - 2 && j < A.NY - 2;
    }
    if (in_cfl) {
      for (int p = 0; p < NW; ++p) {
        if (CAPA) cmax = mx(cmax, mx(s[p] * dr, -s[p] * dl));
        else cmax = mx(cmax, fabs_(s[p]));
      }
    }
  }
  warp_fold(IXY == 0 ? B.rx : B.ry, tid, cmax);
}

// ---- the y-face (OY row ti+1, column cj) sums the x parts of its four
// neighbour x-interfaces: (bm(amdq) at (ti+1, cj+1), bp(amdq) at (ti+1,
// cj)) into F_CQ, the same of apdq at row ti into F_SB, each part times
// the receiving cell's 0.5 dt/dx ------------------------------------------
template <typename S, typename T, int TX, int TY, bool CAPA>
HD void item_gather_y(const SysArgs<S, T>& A, Block<S, T, TX, TY, CAPA>& B,
                      int idx) {
  using L = Tile<S, T, TX, TY, CAPA>;
  constexpr int NEQ = L::NEQ, OXC = L::OXC, OYC = L::OYC, OYN = L::OYN;
  constexpr int SN = L::SN;
  const T* X = B.P;
  const int ti = idx / OYC, cj = idx % OYC;
  const int o = (ti + 1) * OYC + cj;
  T lo = A.C[C_HDX], hi = lo;
  if (CAPA) {
    lo = T(0.5) * B.template dtd<0>(A, ti + 2, cj + 2);
    hi = T(0.5) * B.template dtd<0>(A, ti + 2, cj + 1);
  }
  for (int e = 0; e < NEQ; ++e) {
    B.OY[(F_CQ * NEQ + e) * OYN + o] =
        lo * X[(F_T0 * NEQ + e) * SN + (ti + 1) * OXC + cj + 1]
        + hi * X[(F_T1 * NEQ + e) * SN + (ti + 1) * OXC + cj];
    B.OY[(F_SB * NEQ + e) * OYN + o] =
        lo * X[(F_T2 * NEQ + e) * SN + ti * OXC + cj + 1]
        + hi * X[(F_T3 * NEQ + e) * SN + ti * OXC + cj];
  }
}

// ---- conservative update of tile cell idx, with the x-flux's gather ----
template <typename S, typename T, int TX, int TY, bool CAPA>
HD void item_update(const SysArgs<S, T>& A, Block<S, T, TX, TY, CAPA>& B,
                    int idx) {
  using L = Tile<S, T, TX, TY, CAPA>;
  constexpr int NEQ = L::NEQ;
  constexpr int OXC = L::OXC, OYC = L::OYC, OXN = L::OXN, OYN = L::OYN;
  constexpr int SN = L::SN;
  const T* OX = B.OX;
  const T* OY = B.OY;
  const T* YS = B.P;
  // field f, component e of the x- (X) or y-interface (Y) at (r, c); the
  // y parts in P (YP)
  auto X = [&](int f, int e, int r, int c) {
    return OX[(f * NEQ + e) * OXN + r * OXC + c];
  };
  auto Y = [&](int f, int e, int r, int c) {
    return OY[(f * NEQ + e) * OYN + r * OYC + c];
  };
  auto YP = [&](int f, int e, int r, int c) {
    return YS[(f * NEQ + e) * SN + r * OYC + c];
  };
  const int nx = A.NX - 4, ny = A.NY - 4;
  int ti = idx / TY, tj = idx % TY;
  int I = B.I0 + ti, J = B.J0 + tj;
  if (I >= A.NX - 2 || J >= A.NY - 2) return;
  // coefficients of the receiving cells: Fx at x-interface k = I-1+h
  // takes the y parts of cells k (hi) and k+1 (lo) of column J
  T fy_lo[2], fy_hi[2];
  for (int h = 0; h < 2; ++h) {
    if (CAPA) {
      fy_lo[h] = T(0.5) * B.template dtd<1>(A, ti + 2 + h, tj + 2);
      fy_hi[h] = T(0.5) * B.template dtd<1>(A, ti + 1 + h, tj + 2);
    } else {
      fy_lo[h] = fy_hi[h] = A.C[C_HDY];
    }
  }
  const T dxc = B.template dtd<0>(A, ti + 2, tj + 2);
  const T dyc = B.template dtd<1>(A, ti + 2, tj + 2);
  for (int e = 0; e < NEQ; ++e) {
    T F[2], G[2];
    for (int h = 0; h < 2; ++h) {
      // Fx at OX row ti+h, column tj+1; y parts from OY rows rk, rk+1
      int rk = ti + h;
      T f = X(F_CQ, e, rk, tj + 1);
      if (A.tw > 0) {
        f = f - (fy_lo[h] * YP(F_T0, e, rk + 1, tj + 1)
                 + fy_hi[h] * YP(F_T1, e, rk, tj + 1));
        f = f - (fy_lo[h] * YP(F_T2, e, rk + 1, tj)
                 + fy_hi[h] * YP(F_T3, e, rk, tj));
      }
      F[h] = f;
      // Gy at OY row ti+1, column tj+h: cq and the gathered x parts
      G[h] = Y(F_CQ, e, ti + 1, tj + h);
    }
    const T apx = X(F_AP, e, ti, tj + 1), amx = X(F_AM, e, ti + 1, tj + 1);
    const T apy = Y(F_AP, e, ti + 1, tj), amy = Y(F_AM, e, ti + 1, tj + 1);
    const T dq = (apx + amx + F[1] - F[0]) * dxc
               + (apy + amy + G[1] - G[0]) * dyc;
    A.qout[((long long)e * nx + (I - 2)) * ny + (J - 2)] =
        B.q[e * L::QN + (ti + 2) * L::QC + tj + 2] - dq;
  }
}

// ---- the phase sequence, shared by the kernel and the host emulation ---
// X(fn) runs fn(tid) for every thread of the block, then a barrier.  A
// phase of two regions runs them in one index space: f(i) for i in [0,
// n), then g(i) for i in [0, m), so the second fills the first's last
// pass.
template <class F, class G>
HD void items2(int tid, int n, const F& f, int m, const G& g) {
  for (int idx = tid; idx < n + m; idx += NT) {
    if (idx < n) f(idx);
    else g(idx - n);
  }
}

template <bool FWAVE, typename S, typename T, int TX, int TY, bool CAPA,
          class X>
HD void step_block(const SysArgs<S, T>& A, Block<S, T, TX, TY, CAPA>& B,
                   const X& run) {
  using L = Tile<S, T, TX, TY, CAPA>;
  constexpr int NX0 = L::WXR * L::WXC, NY0 = L::WYR * L::WYC;
  run([&](int t) { phase_load(A, B, t); });
  run([&](int t) {
    for (int i = t; i < NX0; i += NT) item_rpn<0>(A, B, i);
  });
  run([&](int t) { phase_sweep<0, FWAVE>(A, B, t); });
  run([&](int t) {
    items2(t, A.tw > 0 ? TX * L::OYC : 0, [&](int i) {
      item_gather_y(A, B, i);
    }, NY0, [&](int i) { item_rpn<1>(A, B, i); });
  });
  run([&](int t) { phase_sweep<1, FWAVE>(A, B, t); });
  run([&](int t) {
    for (int i = t; i < TX * TY; i += NT) item_update(A, B, i);
  });
}

// one CFL value per block: max(s dt/dx) over the block's window; without a
// capacity function the partials hold max|s| and the scalar dt/dx is
// applied here (the same value: the product is monotone)
template <class Blk>
HD typename Blk::Type block_cfl(
    const SysArgs<typename Blk::Sys, typename Blk::Type>& A, const Blk& B) {
  using T = typename Blk::Type;
  constexpr bool CAPA = Blk::CAPA;
  T mx_x = B.rx[0], mx_y = B.ry[0];
  for (int w = 1; w < NT / 32; ++w) {
    mx_x = mx(mx_x, B.rx[w]);
    mx_y = mx(mx_y, B.ry[w]);
  }
  return CAPA ? mx(mx_x, mx_y)
              : mx(A.C[C_DTDX] * mx_x, A.C[C_DTDY] * mx_y);
}

// ---- the Euler systems: compact records, buffers by lifetime ------------
// The interfaces' waves live as records (S::NR values: the strengths and
// the Roe average, S::solve) from which the sweep forms again each wave's
// components and speed (S::wave, S::speed) and the splits their Roe
// average (S::Trans), so the sweep reads no cell; the update reads its q
// from the padded grid.  Shared memory is laid out by lifetime (element
// offsets; the phases as step_block's, with the gather of the x parts a
// phase of its own before the y normal solves):
//   Z0  XC (the x-face cq) and AX (each cell's apdq of its lower x-face
//       plus amdq of its upper one, the first sum of its x difference),
//       from sweep<0> to the update; DX, DY (CAPA) throughout
//   Z1  q and the per-cell quantities, from the load to rpn<1>
//   Z4  PX (the x parts), from sweep<0> to gather_y; then YAM (the
//       y-interface amdq, apdq) at its end, from rpn<1> to the update
//   Z2  WX (the x records) and XAM (the x-interface amdq, apdq), from
//       rpn<0> to sweep<0>; then YS (the gathered sums; the first becomes
//       the y-face flux), from gather_y to the update, and WY (the y
//       records), from rpn<1> to sweep<1>
//   PY  (the y parts), from sweep<1> to the update, over Z1 and Z4's head
template <typename S, typename T, int TX, int TY, bool CAPA> struct CTile {
  static constexpr int NEQ = S::NEQ, NW = S::NW, NAUX = S::NAUX;
  static constexpr int NR = S::NR, NPC = S::NPC, NPL = NPC;
  static constexpr int QR = TX + 4, QC = TY + 4, QN = QR * QC;
  static constexpr int WXR = TX + 3, WXC = TY + 2, WXN = WXR * WXC;
  static constexpr int WYR = TX + 2, WYC = TY + 3, WYN = WYR * WYC;
  static constexpr int OXR = TX + 1, OXC = TY + 2, OXN = OXR * OXC;
  static constexpr int OYR = TX + 2, OYC = TY + 1, OYN = OYR * OYC;
  static constexpr int NC = TX * TY;
  static constexpr int Z0 = NEQ * OXN + NEQ * NC + (CAPA ? 2 * QN : 0);
  static constexpr int Z1 = (NEQ + NAUX + NPC) * QN;
  static constexpr int Z4 = 4 * NEQ * OXN;
  static constexpr int ZX = NR * WXN + 2 * NEQ * OXN;
  static constexpr int ZY = 2 * NEQ * OYN + NR * WYN;
  static constexpr int Z2 = ZX > ZY ? ZX : ZY;
  static constexpr int YAM_AT = Z0 + Z1 + Z4 - 2 * NEQ * OYN;
  static_assert(2 * NEQ * OYN <= Z4, "YAM fits in Z4");
  static_assert(Z0 + 4 * NEQ * OYN <= YAM_AT, "PY ends before YAM");
  static constexpr size_t elems = Z0 + Z1 + Z4 + Z2 + 2 * (NT / 32);
  static constexpr size_t bytes = elems * sizeof(T);
};

template <typename S, typename T, int TX, int TY, bool CAPA_> struct CBlock {
  using Sys = S;
  using Type = T;
  static constexpr bool CAPA = CAPA_;
  using L = CTile<S, T, TX, TY, CAPA>;
  T* XC;   // [NEQ][OXN]
  T* AX;   // [NEQ][NC]
  T* DX;   // [QR][QC] dt/(dx kappa) (CAPA)
  T* DY;   // [QR][QC] dt/(dy kappa) (CAPA)
  T* q;    // [NEQ][QR][QC]
  T* a;    // [NAUX][QR][QC]
  T* PC;   // [NPC][QR][QC]
  T* PX;   // [4][NEQ][OXN]: bm, bp of amdq(+cq), of apdq(-cq)
  T* WX;   // [NR][WXN]
  T* XAM;  // [2][NEQ][OXN]: amdq, apdq
  T* YS;   // [2][NEQ][OYN]: the sums of the gathered amdq and apdq parts
  T* WY;   // [NR][WYN]
  T* YAM;  // [2][NEQ][OYN]
  T* PY;   // [4][NEQ][OYN]
  T* rx;   // [NT / 32] x CFL partial max of each warp
  T* ry;   // the same for y
  int I0, J0, bid;

  HD void bind(T* s, int bx, int by, int nbx) {
    XC = s;
    AX = XC + L::NEQ * L::OXN;
    DX = AX + L::NEQ * L::NC;
    DY = DX + (CAPA ? L::QN : 0);
    q = s + L::Z0;
    a = q + L::NEQ * L::QN;
    PC = a + L::NAUX * L::QN;
    PX = s + L::Z0 + L::Z1;
    WX = PX + L::Z4;
    XAM = WX + L::NR * L::WXN;
    YS = WX;
    WY = YS + 2 * L::NEQ * L::OYN;
    YAM = s + L::YAM_AT;
    PY = q;
    rx = WX + L::Z2;
    ry = rx + NT / 32;
    I0 = 2 + by * TX;
    J0 = 2 + bx * TY;
    bid = by * nbx + bx;
  }
  HD void cell(int r, int c, T qv[], T pv[]) const {
    for (int e = 0; e < L::NEQ; ++e) qv[e] = q[e * L::QN + r * L::QC + c];
    for (int k = 0; k < L::NPC; ++k) pv[k] = PC[k * L::QN + r * L::QC + c];
  }
  template <int D> HD T dtd(const SysArgs<S, T>& A, int r, int c) const {
    if (CAPA) return (D == 0 ? DX : DY)[r * L::QC + c];
    return A.C[D == 0 ? C_DTDX : C_DTDY];
  }
};

// ---- normal solve at one interface of the region of axis IXY: its
// record, and the fluctuations of the interfaces the sweep keeps ---------
template <int IXY, typename S, typename T, int TX, int TY, bool CAPA>
HD void citem_rpn(const SysArgs<S, T>& A, CBlock<S, T, TX, TY, CAPA>& B,
                  int idx) {
  using L = CTile<S, T, TX, TY, CAPA>;
  constexpr int NEQ = L::NEQ, NR = L::NR;
  constexpr int C = IXY == 0 ? L::WXC : L::WYC;
  constexpr int WN = IXY == 0 ? L::WXN : L::WYN;
  constexpr int OC = IXY == 0 ? L::OXC : L::OYC;
  constexpr int ON = IXY == 0 ? L::OXN : L::OYN;
  T* W = IXY == 0 ? B.WX : B.WY;
  T* O = IXY == 0 ? B.XAM : B.YAM;
  int r = idx / C, c = idx % C;
  // left cell: x (r, c+1), y (r+1, c); right cell (r+1, c+1)
  T ql[NEQ], qr[NEQ], pl[L::NPL], pr[L::NPL];
  B.cell(IXY == 0 ? r : r + 1, IXY == 0 ? c + 1 : c, ql, pl);
  B.cell(r + 1, c + 1, qr, pr);
  T rec[NR], am[NEQ], ap[NEQ];
  S::template solve<IXY, T>(A.P, ql, qr, pl, pr, rec, am, ap);
  for (int k = 0; k < NR; ++k) W[k * WN + idx] = rec[k];
  int orow = IXY == 0 ? r - 1 : r, ocol = IXY == 0 ? c : c - 1;
  int orows = IXY == 0 ? L::OXR : L::OYR;
  if (orow >= 0 && orow < orows && ocol >= 0 && ocol < OC) {
    int o = orow * OC + ocol;
    for (int e = 0; e < NEQ; ++e) {
      O[(F_AM * NEQ + e) * ON + o] = am[e];
      O[(F_AP * NEQ + e) * ON + o] = ap[e];
    }
  }
}

// ---- limiter, correction flux, transverse split and CFL of one interface
// of the sweep region of axis IXY: each wave of the own interface, and of
// its lower and upper neighbours for the limiter's dot products, formed
// from their records in wave order; cq accumulates wave by wave in the
// order of phase_sweep's sum ------------------------------------------------
template <int IXY, bool FWAVE, typename S, typename T, int TX, int TY,
          bool CAPA>
HD void citem_sweep(const SysArgs<S, T>& A, CBlock<S, T, TX, TY, CAPA>& B,
                    int idx, T& cmax) {
  using L = CTile<S, T, TX, TY, CAPA>;
  constexpr int NEQ = L::NEQ, NW = L::NW, NR = L::NR;
  constexpr int C = IXY == 0 ? L::OXC : L::OYC;
  constexpr int WC = IXY == 0 ? L::WXC : L::WYC;
  constexpr int WN = IXY == 0 ? L::WXN : L::WYN;
  constexpr int ON = IXY == 0 ? L::OXN : L::OYN;
  const T* W = IXY == 0 ? B.WX : B.WY;
  const T* O = IXY == 0 ? B.XAM : B.YAM;
  T* PP = IXY == 0 ? B.PX : B.PY;
  int r = idx / C, c = idx % C;
  int own = IXY == 0 ? (r + 1) * WC + c : r * WC + c + 1;
  int lo = r * WC + c;
  int hi = IXY == 0 ? (r + 2) * WC + c : r * WC + c + 2;
  int lr = r + 1, lc = c + 1;
  int rr = IXY == 0 ? r + 2 : r + 1, rc = IXY == 0 ? c + 1 : c + 2;
  const T dl = B.template dtd<IXY>(A, lr, lc);
  const T dr = B.template dtd<IXY>(A, rr, rc);
  const T dtdx = CAPA ? T(0.5) * (dl + dr) : dl;
  T rec[NR], s[NW];
  for (int k = 0; k < NR; ++k) rec[k] = W[k * WN + own];
  for (int p = 0; p < NW; ++p) s[p] = S::speed(rec, p);

  // CFL window: interfaces touching the interior (kernels.py step2); read
  // first, so that dl and dr die here
  bool in_cfl;
  if (IXY == 0) {
    int k = B.I0 - 1 + r, J = B.J0 - 1 + c;
    in_cfl = k < A.NX - 2 && c >= 1 && c <= TY && J < A.NY - 2;
  } else {
    int i = B.I0 - 1 + r, j = B.J0 - 1 + c;
    in_cfl = r >= 1 && r <= TX && i < A.NX - 2 && j < A.NY - 2;
  }
  if (in_cfl) {
    for (int p = 0; p < NW; ++p) {
      if (CAPA) cmax = mx(cmax, mx(s[p] * dr, -s[p] * dl));
      else cmax = mx(cmax, fabs_(s[p]));
    }
  }

  T cq[NEQ];
  for (int e = 0; e < NEQ; ++e) cq[e] = T(0);
  if (A.order == 2) {
    // unrolled, so that every index of a record and of s is a constant
#pragma unroll
    for (int p = 0; p < NW; ++p) {
      T w[NEQ], wl[NEQ], wh[NEQ], rl[NR], rh[NR];
      for (int k = 0; k < NR; ++k) {
        rl[k] = W[k * WN + lo];
        rh[k] = W[k * WN + hi];
      }
      S::template wave<IXY>(rec, p, w);
      S::template wave<IXY>(rl, p, wl);
      S::template wave<IXY>(rh, p, wh);
      T wn2 = T(0), dlo = T(0), dhi = T(0);
      bool first = true;
      for (int e = 0; e < NEQ; ++e) {
        if (!S::template nz<IXY>(p, e)) continue;
        wn2 = first ? w[e] * w[e] : wn2 + w[e] * w[e];
        dlo = first ? wl[e] * w[e] : dlo + wl[e] * w[e];
        dhi = first ? w[e] * wh[e] : dhi + w[e] * wh[e];
        first = false;
      }
      T phi = T(1);
      const int lid = A.lim[p];
      if (lid != 0) {
        const bool safe = wn2 > T(0);
        const T theta = safe ? (s[p] > T(0) ? dlo : dhi) / wn2 : T(0);
        const T ph = phi_limiter<T>(lid, theta, fabs_(s[p]) * dtdx);
        phi = safe ? ph : T(1);
      }
      const T abss = fabs_(s[p]);
      const T lead = FWAVE
          ? T(0.5) * T((s[p] > T(0)) - (s[p] < T(0)))
          : T(0.5) * abss;
      const T cf = lead * (T(1) - abss * dtdx) * phi;
      for (int e = 0; e < NEQ; ++e) {
        if (p == 0) cq[e] = cf * w[e];
        else if (S::template nz<IXY>(p, e)) cq[e] = cq[e] + cf * w[e];
      }
    }
  }
  if (IXY == 0) {
    for (int e = 0; e < NEQ; ++e) B.XC[e * ON + idx] = cq[e];
  } else {
    // a y-face of the tile: cq minus the gathered sums, in the first
    // port's order
    const bool face = A.tw > 0 && r >= 1 && r <= TX;
    for (int e = 0; e < NEQ; ++e) {
      T* g = B.YS + e * ON + idx;
      *g = face ? cq[e] - *g - B.YS[(NEQ + e) * ON + idx] : cq[e];
    }
  }

  if (A.tw > 0) {
    const bool both = A.tw >= 2 && A.order == 2;
    T amt[NEQ], apt[NEQ], bm[NEQ], bp[NEQ];
    for (int e = 0; e < NEQ; ++e) {
      const T am = O[(F_AM * NEQ + e) * ON + idx];
      const T ap = O[(F_AP * NEQ + e) * ON + idx];
      amt[e] = both ? am + cq[e] : am;
      apt[e] = both ? ap - cq[e] : ap;
    }
    const typename S::template Trans<IXY, T> tr(A.P, rec);
    tr.split(amt, bm, bp);
    for (int e = 0; e < NEQ; ++e) {
      PP[(F_T0 * NEQ + e) * ON + idx] = bm[e];
      PP[(F_T1 * NEQ + e) * ON + idx] = bp[e];
    }
    tr.split(apt, bm, bp);
    for (int e = 0; e < NEQ; ++e) {
      PP[(F_T2 * NEQ + e) * ON + idx] = bm[e];
      PP[(F_T3 * NEQ + e) * ON + idx] = bp[e];
    }
  }

}

// ---- cell idx's AX: apdq of its lower x-face plus amdq of its upper one
template <typename S, typename T, int TX, int TY, bool CAPA>
HD void citem_ax(CBlock<S, T, TX, TY, CAPA>& B, int idx) {
  using L = CTile<S, T, TX, TY, CAPA>;
  constexpr int NEQ = L::NEQ, OXC = L::OXC, OXN = L::OXN;
  const int ti = idx / TY, tj = idx % TY;
  for (int e = 0; e < NEQ; ++e) {
    B.AX[e * L::NC + idx] = B.XAM[(F_AP * NEQ + e) * OXN + ti * OXC + tj + 1]
        + B.XAM[(F_AM * NEQ + e) * OXN + (ti + 1) * OXC + tj + 1];
  }
}

// ---- item_gather_y's sums from PX into YS ---------------------------------
template <typename S, typename T, int TX, int TY, bool CAPA>
HD void citem_gather_y(const SysArgs<S, T>& A, CBlock<S, T, TX, TY, CAPA>& B,
                       int idx) {
  using L = CTile<S, T, TX, TY, CAPA>;
  constexpr int NEQ = L::NEQ, OXC = L::OXC, OXN = L::OXN, OYC = L::OYC;
  constexpr int OYN = L::OYN;
  const T* X = B.PX;
  const int ti = idx / OYC, cj = idx % OYC;
  const int o = (ti + 1) * OYC + cj;
  T lo = A.C[C_HDX], hi = lo;
  if (CAPA) {
    lo = T(0.5) * B.template dtd<0>(A, ti + 2, cj + 2);
    hi = T(0.5) * B.template dtd<0>(A, ti + 2, cj + 1);
  }
  for (int e = 0; e < NEQ; ++e) {
    B.YS[e * OYN + o] =
        lo * X[(F_T0 * NEQ + e) * OXN + (ti + 1) * OXC + cj + 1]
        + hi * X[(F_T1 * NEQ + e) * OXN + (ti + 1) * OXC + cj];
    B.YS[(NEQ + e) * OYN + o] =
        lo * X[(F_T2 * NEQ + e) * OXN + ti * OXC + cj + 1]
        + hi * X[(F_T3 * NEQ + e) * OXN + ti * OXC + cj];
  }
}

// ---- item_update's conservative update from the compact buffers ----------
template <typename S, typename T, int TX, int TY, bool CAPA>
HD void citem_update(const SysArgs<S, T>& A, CBlock<S, T, TX, TY, CAPA>& B,
                     int idx) {
  using L = CTile<S, T, TX, TY, CAPA>;
  constexpr int NEQ = L::NEQ, OXC = L::OXC, OYC = L::OYC, OXN = L::OXN;
  constexpr int OYN = L::OYN;
  const int nx = A.NX - 4, ny = A.NY - 4;
  int ti = idx / TY, tj = idx % TY;
  int I = B.I0 + ti, J = B.J0 + tj;
  if (I >= A.NX - 2 || J >= A.NY - 2) return;
  // y part f, component e at OY (r, c)
  auto YP = [&](int f, int e, int r, int c) {
    return B.PY[(f * NEQ + e) * OYN + r * OYC + c];
  };
  T fy_lo[2], fy_hi[2];
  for (int h = 0; h < 2; ++h) {
    if (CAPA) {
      fy_lo[h] = T(0.5) * B.template dtd<1>(A, ti + 2 + h, tj + 2);
      fy_hi[h] = T(0.5) * B.template dtd<1>(A, ti + 1 + h, tj + 2);
    } else {
      fy_lo[h] = fy_hi[h] = A.C[C_HDY];
    }
  }
  const T dxc = B.template dtd<0>(A, ti + 2, tj + 2);
  const T dyc = B.template dtd<1>(A, ti + 2, tj + 2);
  const long long plane = (long long)A.NX * A.NY;
  for (int e = 0; e < NEQ; ++e) {
    T F[2], G[2];
    for (int h = 0; h < 2; ++h) {
      int rk = ti + h;
      T f = B.XC[e * OXN + rk * OXC + tj + 1];
      if (A.tw > 0) {
        f = f - (fy_lo[h] * YP(F_T0, e, rk + 1, tj + 1)
                 + fy_hi[h] * YP(F_T1, e, rk, tj + 1));
        f = f - (fy_lo[h] * YP(F_T2, e, rk + 1, tj)
                 + fy_hi[h] * YP(F_T3, e, rk, tj));
      }
      F[h] = f;
      G[h] = B.YS[e * OYN + (ti + 1) * OYC + tj + h];
    }
    const T ax = B.AX[e * L::NC + idx];
    const T apy = B.YAM[(F_AP * NEQ + e) * OYN + (ti + 1) * OYC + tj];
    const T amy = B.YAM[(F_AM * NEQ + e) * OYN + (ti + 1) * OYC + tj + 1];
    const T dq = (ax + F[1] - F[0]) * dxc + (apy + amy + G[1] - G[0]) * dyc;
    A.qout[((long long)e * nx + (I - 2)) * ny + (J - 2)] =
        A.qbc[e * plane + (long long)I * A.NY + J] - dq;
  }
}

template <bool FWAVE, typename S, typename T, int TX, int TY, bool CAPA,
          class X>
HD void cstep_block(const SysArgs<S, T>& A, CBlock<S, T, TX, TY, CAPA>& B,
                    const X& run) {
  using L = CTile<S, T, TX, TY, CAPA>;
  run([&](int t) { phase_load(A, B, t); });
  run([&](int t) {
    for (int i = t; i < L::WXN; i += NT) citem_rpn<0>(A, B, i);
  });
  run([&](int t) {
    T cmax = T(0);
    items2(t, L::OXN, [&](int i) {
      citem_sweep<0, FWAVE>(A, B, i, cmax);
    }, L::NC, [&](int i) { citem_ax(B, i); });
    warp_fold(B.rx, t, cmax);
  });
  if (A.tw > 0) {
    run([&](int t) {
      for (int i = t; i < TX * L::OYC; i += NT) citem_gather_y(A, B, i);
    });
  }
  run([&](int t) {
    for (int i = t; i < L::WYN; i += NT) citem_rpn<1>(A, B, i);
  });
  run([&](int t) {
    T cmax = T(0);
    for (int i = t; i < L::OYN; i += NT) citem_sweep<1, FWAVE>(A, B, i, cmax);
    warp_fold(B.ry, t, cmax);
  });
  run([&](int t) {
    for (int i = t; i < L::NC; i += NT) citem_update(A, B, i);
  });
}

// ---- psystem_2D and vc_advection_2D: designs of their own ---------------
// The two systems run no rpt2 parts' scratch and no stored waves: the
// p-system has no transverse pass, the variable-coefficient advection one
// equation whose wave, speed and fluctuations are a difference and two
// products of the staged q and aux.  Each phase is a loop of the block's
// threads over one region, as in step_block; the shared arrays (element
// offsets in the design's Tile) are named by what they hold.  The
// arithmetic of each interface and cell is the generic design's, operation
// for operation and in its order of sums (the same bits).

// the correction coefficient of one wave, lead (1 - |s| dt/dx) phi, from
// its speed s, dt/dx and the limiter's sums |w|^2, w_lo . w and w . w_hi
// (phase_sweep's)
template <bool FWAVE, typename T>
HD T wave_coef(int lid, T s, T dtdx, T wn2, T dlo, T dhi) {
  T phi = T(1);
  if (lid != 0) {
    const bool safe = wn2 > T(0);
    const T theta = safe ? (s > T(0) ? dlo : dhi) / wn2 : T(0);
    const T ph = phi_limiter<T>(lid, theta, fabs_(s) * dtdx);
    phi = safe ? ph : T(1);
  }
  const T abss = fabs_(s);
  const T lead = FWAVE ? T(0.5) * T((s > T(0)) - (s < T(0)))
                       : T(0.5) * abss;
  return lead * (T(1) - abss * dtdx) * phi;
}

// whether the interface of the sweep region of axis IXY at (r, c) (the
// generic design's OX / OY indices) is in the CFL window: it touches the
// interior (kernels.py step2)
template <int IXY, int TX, int TY, class Blk, class A_>
HD bool in_cfl(const A_& A, const Blk& B, int r, int c) {
  if (IXY == 0) {
    const int k = B.I0 - 1 + r, J = B.J0 - 1 + c;
    return k < A.NX - 2 && c >= 1 && c <= TY && J < A.NY - 2;
  }
  const int i = B.I0 - 1 + r, j = B.J0 - 1 + c;
  return r >= 1 && r <= TX && i < A.NX - 2 && j < A.NY - 2;
}

// ---- psystem_2D: each normal solve a record of its two strengths ---------
// Shared memory (element offsets):
//   PC  q and aux as staged, then in place the per-cell quantities u, v,
//       sigma, z, c (S::prep_aux; the update reads its q from the grid);
//       DX, DY (CAPA) after them
//   RX  the x normal solves' strengths b1, b2 over (TX+3) x TY interfaces
//       (rows -3/2 .. TX+1/2 of the tile, its columns), RY the y ones over
//       TX x (TY+3); the waves are formed again from them and the cells'
//       z by the solve's own expressions (S::wave), their speeds are -c_l
//       and c_r
//   CX  the x sweeps' correction coefficient of each wave over (TX+1) x
//       TY interfaces, CY the y ones over TX x (TY+1): over u, v and sigma
//       of PC, which die with the normal solves
// Phases: load | the normal solves | the sweeps and the CFL | the update.
// No transverse pass, so the normal solves and sweeps cover the tile's
// own columns (rows) alone.
template <typename S, typename T, int TX, int TY, bool CAPA> struct PTile {
  static constexpr int NEQ = S::NEQ, NW = S::NW, NAUX = S::NAUX;
  static constexpr int NPC = S::NPC, NPL = NPC;
  static_assert(NPC <= NEQ + NAUX, "the per-cell quantities fit over q, aux");
  static constexpr int QR = TX + 4, QC = TY + 4, QN = QR * QC;
  static constexpr int XSN = (TX + 3) * TY;             // x normal solves
  static constexpr int YSC = TY + 3, YSN = TX * YSC;    // y normal solves
  static constexpr int XFN = (TX + 1) * TY;             // x sweeps
  static constexpr int YFC = TY + 1, YFN = TX * YFC;    // y sweeps
  static_assert(NW * (XFN + YFN) <= 3 * QN, "CX, CY fit over u, v, sigma");
  static constexpr int ZS = (NEQ + NAUX) * QN + (CAPA ? 2 * QN : 0);
  static constexpr size_t elems = ZS + NW * (XSN + YSN) + 2 * (NT / 32);
  static constexpr size_t bytes = elems * sizeof(T);
};

template <typename S, typename T, int TX, int TY, bool CAPA_> struct PBlock {
  using Sys = S;
  using Type = T;
  static constexpr bool CAPA = CAPA_;
  using L = PTile<S, T, TX, TY, CAPA>;
  T* q;    // [NEQ][QR][QC] as staged
  T* a;    // [NAUX][QR][QC] as staged
  T* PC;   // [NPC][QR][QC] over q and a
  T* DX;   // [QR][QC] dt/(dx kappa) (CAPA)
  T* DY;   // [QR][QC] dt/(dy kappa) (CAPA)
  T* RX;   // [NW][XSN]
  T* RY;   // [NW][YSN]
  T* CX;   // [NW][XFN]
  T* CY;   // [NW][YFN]
  T* rx;   // [NT / 32] x CFL partial max of each warp
  T* ry;   // the same for y
  int I0, J0, bid;

  HD void bind(T* s, int bx, int by, int nbx) {
    q = s;
    a = q + L::NEQ * L::QN;
    PC = s;
    DX = s + (L::NEQ + L::NAUX) * L::QN;
    DY = DX + (CAPA ? L::QN : 0);
    RX = s + L::ZS;
    RY = RX + L::NW * L::XSN;
    CX = s;
    CY = CX + L::NW * L::XFN;
    rx = RY + L::NW * L::YSN;
    ry = rx + NT / 32;
    I0 = 2 + by * TX;
    J0 = 2 + bx * TY;
    bid = by * nbx + bx;
  }
  // per-cell quantity k of the tile cell (r, c)
  HD T pc(int k, int r, int c) const { return PC[k * L::QN + r * L::QC + c]; }
  template <int D> HD T dtd(const SysArgs<S, T>& A, int r, int c) const {
    if (CAPA) return (D == 0 ? DX : DY)[r * L::QC + c];
    return A.C[D == 0 ? C_DTDX : C_DTDY];
  }
};

// ---- normal solve idx of axis IXY: x, between tile rows r and r+1 at
// column c+2; y, between columns c and c+1 at row r+2 -----------------------
template <int IXY, typename S, typename T, int TX, int TY, bool CAPA>
HD void pitem_solve(PBlock<S, T, TX, TY, CAPA>& B, int idx) {
  using L = PTile<S, T, TX, TY, CAPA>;
  constexpr int C = IXY == 0 ? TY : L::YSC;
  constexpr int N = IXY == 0 ? L::XSN : L::YSN;
  const int r = idx / C, c = idx % C;
  const int lr = IXY == 0 ? r : r + 2, lc = IXY == 0 ? c + 2 : c;
  T pl[L::NPC], pr[L::NPC], b[L::NW];
  for (int k = 0; k < L::NPC; ++k) {
    pl[k] = B.pc(k, lr, lc);
    pr[k] = B.pc(k, IXY == 0 ? lr + 1 : lr, IXY == 0 ? lc : lc + 1);
  }
  S::template strengths<IXY>(pl, pr, b);
  T* R = IXY == 0 ? B.RX : B.RY;
  for (int p = 0; p < L::NW; ++p) R[p * N + idx] = b[p];
}

// ---- limiter and correction coefficients of sweep idx of axis IXY (x:
// between tile rows r+1 and r+2 at column c+2; y: between columns c+1 and
// c+2 at row r+2), from the records of its solve and of the solves below
// and above it along the axis (cells k = 0 .. 3 along the axis, its own
// 1 and 2) ------------------------------------------------------------------
template <int IXY, bool FWAVE, typename S, typename T, int TX, int TY,
          bool CAPA>
HD void pitem_sweep(const SysArgs<S, T>& A, PBlock<S, T, TX, TY, CAPA>& B,
                    int idx, T& cmax) {
  using L = PTile<S, T, TX, TY, CAPA>;
  constexpr int NEQ = L::NEQ, NW = L::NW;
  constexpr int C = IXY == 0 ? TY : L::YFC;
  constexpr int SC = IXY == 0 ? TY : L::YSC;
  constexpr int SN = IXY == 0 ? L::XSN : L::YSN;
  constexpr int FN = IXY == 0 ? L::XFN : L::YFN;
  const int r = idx / C, c = idx % C;
  const int r0 = IXY == 0 ? r : r + 2, c0 = IXY == 0 ? c + 2 : c;
  constexpr int dr = IXY == 0 ? 1 : 0, dc = IXY == 0 ? 0 : 1;
  const T* R = IXY == 0 ? B.RX : B.RY;
  T b[3][NW], z[4];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int s = IXY == 0 ? (r + m) * SC + c : r * SC + c + m;
    for (int p = 0; p < NW; ++p) b[m][p] = R[p * SN + s];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) z[k] = B.pc(3, r0 + k * dr, c0 + k * dc);
  static_assert(NW == 2, "the speeds -c_l and c_r");
  const T s[2] = {-B.pc(4, r0 + dr, c0 + dc),
                  B.pc(4, r0 + 2 * dr, c0 + 2 * dc)};
  const T dl = B.template dtd<IXY>(A, r0 + dr, c0 + dc);
  const T dh = B.template dtd<IXY>(A, r0 + 2 * dr, c0 + 2 * dc);
  const T dtdx = CAPA ? T(0.5) * (dl + dh) : dl;
  // the generic design's indices of the sweep region (its column, row
  // counted from the halo's)
  if (in_cfl<IXY, TX, TY>(A, B, IXY == 0 ? r : r + 1, IXY == 0 ? c + 1 : c)) {
    for (int p = 0; p < NW; ++p) {
      if (CAPA) cmax = mx(cmax, mx(s[p] * dh, -s[p] * dl));
      else cmax = mx(cmax, fabs_(s[p]));
    }
  }
  if (A.order != 2) return;
  T* CF = IXY == 0 ? B.CX : B.CY;
#pragma unroll
  for (int p = 0; p < NW; ++p) {
    T wn2 = T(0), dlo = T(0), dhi = T(0);
    bool first = true;
    for (int e = 0; e < NEQ; ++e) {
      if (!S::template nz<IXY>(p, e)) continue;
      const T w = S::template wave<IXY>(p, e, b[1][p], z[1], z[2]);
      const T wl = S::template wave<IXY>(p, e, b[0][p], z[0], z[1]);
      const T wh = S::template wave<IXY>(p, e, b[2][p], z[2], z[3]);
      wn2 = first ? w * w : wn2 + w * w;
      dlo = first ? wl * w : dlo + wl * w;
      dhi = first ? w * wh : dhi + w * wh;
      first = false;
    }
    CF[p * FN + idx] = wave_coef<FWAVE>(A.lim[p], s[p], dtdx, wn2, dlo, dhi);
  }
}

// ---- conservative update of tile cell idx: the fluctuations and
// correction fluxes of its four faces formed from the records ---------------
template <typename S, typename T, int TX, int TY, bool CAPA>
HD void pitem_update(const SysArgs<S, T>& A, PBlock<S, T, TX, TY, CAPA>& B,
                     int idx) {
  using L = PTile<S, T, TX, TY, CAPA>;
  constexpr int NEQ = L::NEQ, NW = L::NW;
  const int nx = A.NX - 4, ny = A.NY - 4;
  const int ti = idx / TY, tj = idx % TY;
  const int I = B.I0 + ti, J = B.J0 + tj;
  if (I >= A.NX - 2 || J >= A.NY - 2) return;
  // face h of axis D (0 lower, 1 upper): its strengths, correction
  // coefficients and the impedances of its cells
  T b[2][2][NW], cf[2][2][NW], z[2][3];
  for (int k = 0; k < 3; ++k) {
    z[0][k] = B.pc(3, ti + 1 + k, tj + 2);
    z[1][k] = B.pc(3, ti + 2, tj + 1 + k);
  }
  for (int h = 0; h < 2; ++h) {
    const int sx = (ti + 1 + h) * TY + tj, fx = (ti + h) * TY + tj;
    const int sy = ti * L::YSC + tj + 1 + h, fy = ti * L::YFC + tj + h;
    for (int p = 0; p < NW; ++p) {
      b[0][h][p] = B.RX[p * L::XSN + sx];
      b[1][h][p] = B.RY[p * L::YSN + sy];
      if (A.order == 2) {
        cf[0][h][p] = B.CX[p * L::XFN + fx];
        cf[1][h][p] = B.CY[p * L::YFN + fy];
      }
    }
  }
  const T dxc = B.template dtd<0>(A, ti + 2, tj + 2);
  const T dyc = B.template dtd<1>(A, ti + 2, tj + 2);
  const long long plane = (long long)A.NX * A.NY;
#pragma unroll
  for (int e = 0; e < NEQ; ++e) {
    // the correction flux of face h of axis D (phase_sweep's sum)
    auto cq = [&](auto D, int h) {
      constexpr int d = decltype(D)::value;
      if (A.order != 2) return T(0);
      T acc = cf[d][h][0]
          * S::template wave<d>(0, e, b[d][h][0], z[d][h], z[d][h + 1]);
      for (int p = 1; p < NW; ++p) {
        if (S::template nz<d>(p, e))
          acc = acc + cf[d][h][p] * S::template wave<d>(
              p, e, b[d][h][p], z[d][h], z[d][h + 1]);
      }
      return acc;
    };
    using X0 = std::integral_constant<int, 0>;
    using Y1 = std::integral_constant<int, 1>;
    // apdq of the lower face (its second wave), amdq of the upper one
    const T apx = S::template wave<0>(1, e, b[0][0][1], z[0][0], z[0][1]);
    const T amx = S::template wave<0>(0, e, b[0][1][0], z[0][1], z[0][2]);
    const T apy = S::template wave<1>(1, e, b[1][0][1], z[1][0], z[1][1]);
    const T amy = S::template wave<1>(0, e, b[1][1][0], z[1][1], z[1][2]);
    const T dq = (apx + amx + cq(X0(), 1) - cq(X0(), 0)) * dxc
               + (apy + amy + cq(Y1(), 1) - cq(Y1(), 0)) * dyc;
    A.qout[((long long)e * nx + (I - 2)) * ny + (J - 2)] =
        A.qbc[e * plane + (long long)I * A.NY + J] - dq;
  }
}

template <bool FWAVE, typename S, typename T, int TX, int TY, bool CAPA,
          class X>
HD void pstep_block(const SysArgs<S, T>& A, PBlock<S, T, TX, TY, CAPA>& B,
                    const X& run) {
  using L = PTile<S, T, TX, TY, CAPA>;
  run([&](int t) { phase_load(A, B, t); });
  run([&](int t) {
    items2(t, L::XSN, [&](int i) { pitem_solve<0>(B, i); },
           L::YSN, [&](int i) { pitem_solve<1>(B, i); });
  });
  run([&](int t) {
    T cx = T(0), cy = T(0);
    items2(t, L::XFN, [&](int i) { pitem_sweep<0, FWAVE>(A, B, i, cx); },
           L::YFN, [&](int i) { pitem_sweep<1, FWAVE>(A, B, i, cy); });
    warp_fold(B.rx, t, cx);
    warp_fold(B.ry, t, cy);
  });
  run([&](int t) {
    for (int i = t; i < TX * TY; i += NT) pitem_update(A, B, i);
  });
}

// ---- vc_advection_2D: one equation formed again from the staged cells ----
// Shared memory: q and the edge velocities u, v as staged (DX, DY with
// CAPA), then each interface's correction flux cq: CQX over the generic
// design's OX region, (TX+1) x (TY+2), CQY over its OY region, (TX+2) x
// (TY+1); without transverse waves only the tile's own columns (rows) of
// them.  Every other quantity of an interface (the wave, its speed, amdq,
// apdq and the split parts) is a difference and a few products of staged
// values (S::rpn, S::rpt), formed where it is used: the update forms the
// parts of the six x- and six y-interfaces around its cell in place of
// gathering stored ones.  Phases: load | the sweeps and the CFL | the
// update (two barriers where the generic design has six).
template <typename S, typename T, int TX, int TY, bool CAPA> struct VTile {
  static constexpr int NEQ = S::NEQ, NW = S::NW, NAUX = S::NAUX;
  static_assert(NEQ == 1 && NW == 1 && S::NPC == 0, "a scalar system");
  static constexpr int NPC = 0, NPL = 1;
  static constexpr int QR = TX + 4, QC = TY + 4, QN = QR * QC;
  static constexpr int OXR = TX + 1, OXC = TY + 2, OXN = OXR * OXC;
  static constexpr int OYR = TX + 2, OYC = TY + 1, OYN = OYR * OYC;
  static constexpr size_t elems = (NEQ + NAUX + (CAPA ? 2 : 0)) * QN + OXN
      + OYN + 2 * (NT / 32);
  static constexpr size_t bytes = elems * sizeof(T);
};

template <typename S, typename T, int TX, int TY, bool CAPA_> struct VBlock {
  using Sys = S;
  using Type = T;
  static constexpr bool CAPA = CAPA_;
  using L = VTile<S, T, TX, TY, CAPA>;
  T* q;    // [QR][QC]
  T* a;    // [NAUX][QR][QC]
  T* DX;   // [QR][QC] dt/(dx kappa) (CAPA)
  T* DY;   // [QR][QC] dt/(dy kappa) (CAPA)
  T* PC;   // (no per-cell quantities)
  T* CQX;  // [OXR][OXC]
  T* CQY;  // [OYR][OYC]
  T* rx;   // [NT / 32] x CFL partial max of each warp
  T* ry;   // the same for y
  int I0, J0, bid;

  HD void bind(T* s, int bx, int by, int nbx) {
    q = s;
    a = q + L::QN;
    DX = a + L::NAUX * L::QN;
    DY = DX + (CAPA ? L::QN : 0);
    PC = nullptr;
    CQX = DY + (CAPA ? L::QN : 0);
    CQY = CQX + L::OXN;
    rx = CQY + L::OYN;
    ry = rx + NT / 32;
    I0 = 2 + by * TX;
    J0 = 2 + bx * TY;
    bid = by * nbx + bx;
  }
  HD T qc(int r, int c) const { return q[r * L::QC + c]; }
  HD void aux_of(int r, int c, T av[]) const {
    for (int m = 0; m < L::NAUX; ++m) av[m] = a[m * L::QN + r * L::QC + c];
  }
  template <int D> HD T dtd(const SysArgs<S, T>& A, int r, int c) const {
    if (CAPA) return (D == 0 ? DX : DY)[r * L::QC + c];
    return A.C[D == 0 ? C_DTDX : C_DTDY];
  }
  // the interface (r, c) of axis IXY (OX / OY indices): its cells, left
  // (lr, lc) and right (lr + 1 - IXY, lc + IXY), and S::rpn's wave, speed
  // and fluctuations
  template <int IXY>
  HD void solve(const SysArgs<S, T>& A, int r, int c, T& w, T& s, T& am,
                T& ap) const {
    const int lr = r + 1, lc = c + 1;
    const int rr = lr + 1 - IXY, rc = lc + IXY;
    T ql[1] = {qc(lr, lc)}, qr[1] = {qc(rr, rc)}, ar[L::NAUX];
    T wv[1][1], sv[1], amv[1], apv[1];
    aux_of(rr, rc, ar);
    S::template rpn<IXY, T>(A.P, ql, qr, nullptr, ar, nullptr, nullptr, wv,
                            sv, amv, apv);
    w = wv[0][0];
    s = sv[0];
    am = amv[0];
    ap = apv[0];
  }
  // cell_split's parts of the fluctuation asdq entering the tile cell (r,
  // c) along the transverse axis of IXY
  template <int IXY>
  HD void split(const SysArgs<S, T>& A, int r, int c, T asdq, T& bm,
                T& bp) const {
    constexpr int dr = IXY == 0 ? 0 : 1, dc = IXY == 0 ? 1 : 0;
    T qv[1] = {qc(r, c)}, ab[L::NAUX], ac[L::NAUX], aa[L::NAUX];
    T as[1] = {asdq}, bmv[1], bpv[1];
    aux_of(r - dr, c - dc, ab);
    aux_of(r, c, ac);
    aux_of(r + dr, c + dc, aa);
    S::template rpt<IXY, T>(A.P, qv, ab, ac, aa, as, bmv, bpv);
    bm = bmv[0];
    bp = bpv[0];
  }
  // part k of the interface (r, c) of axis IXY: bm (k = 0), bp (1) of
  // amdq(+cq) into its left cell, bm (2), bp (3) of apdq(-cq) into its
  // right one (phase_sweep's)
  template <int IXY>
  HD T part(const SysArgs<S, T>& A, int r, int c, int k) const {
    T w, s, am, ap, bm, bp;
    solve<IXY>(A, r, c, w, s, am, ap);
    const T cq = (IXY == 0 ? CQX[r * L::OXC + c] : CQY[r * L::OYC + c]);
    const bool both = A.tw >= 2 && A.order == 2;
    if (k < 2) {
      split<IXY>(A, r + 1, c + 1, both ? am + cq : am, bm, bp);
    } else {
      split<IXY>(A, r + 2 - IXY, c + 1 + IXY, both ? ap - cq : ap, bm,
                 bp);
    }
    return k % 2 == 0 ? bm : bp;
  }
};

// ---- limiter and correction flux of the interface (r, c) of axis IXY,
// its wave and those of its neighbours along the axis formed from the
// staged q ------------------------------------------------------------------
template <int IXY, bool FWAVE, typename S, typename T, int TX, int TY,
          bool CAPA>
HD void vitem_sweep(const SysArgs<S, T>& A, VBlock<S, T, TX, TY, CAPA>& B,
                    int r, int c, T& cmax) {
  using L = VTile<S, T, TX, TY, CAPA>;
  constexpr int dr = IXY == 0 ? 1 : 0, dc = IXY == 0 ? 0 : 1;
  T w, s, am, ap, wl, wh, x;
  B.template solve<IXY>(A, r, c, w, s, am, ap);
  const T dl = B.template dtd<IXY>(A, r + 1, c + 1);
  const T dh = B.template dtd<IXY>(A, r + 1 + dr, c + 1 + dc);
  const T dtdx = CAPA ? T(0.5) * (dl + dh) : dl;
  if (in_cfl<IXY, TX, TY>(A, B, r, c)) {
    if (CAPA) cmax = mx(cmax, mx(s * dh, -s * dl));
    else cmax = mx(cmax, fabs_(s));
  }
  T cq = T(0);
  if (A.order == 2) {
    B.template solve<IXY>(A, r - dr, c - dc, wl, x, x, x);
    B.template solve<IXY>(A, r + dr, c + dc, wh, x, x, x);
    cq = wave_coef<FWAVE>(A.lim[0], s, dtdx, w * w, wl * w, w * wh) * w;
  }
  if (IXY == 0) B.CQX[r * L::OXC + c] = cq;
  else B.CQY[r * L::OYC + c] = cq;
}

// ---- conservative update of tile cell idx: item_update's fluxes, the
// rpt2 parts of the interfaces around the cell formed in place ------------
template <typename S, typename T, int TX, int TY, bool CAPA>
HD void vitem_update(const SysArgs<S, T>& A, VBlock<S, T, TX, TY, CAPA>& B,
                     int idx) {
  using L = VTile<S, T, TX, TY, CAPA>;
  const int ny = A.NY - 4;
  const int ti = idx / TY, tj = idx % TY;
  const int I = B.I0 + ti, J = B.J0 + tj;
  if (I >= A.NX - 2 || J >= A.NY - 2) return;
  T w, s, apx, amx, apy, amy, x;
  B.template solve<0>(A, ti, tj + 1, w, s, x, apx);
  B.template solve<0>(A, ti + 1, tj + 1, w, s, amx, x);
  B.template solve<1>(A, ti + 1, tj, w, s, x, apy);
  B.template solve<1>(A, ti + 1, tj + 1, w, s, amy, x);
  T F[2], G[2];
  for (int h = 0; h < 2; ++h) {
    F[h] = B.CQX[(ti + h) * L::OXC + tj + 1];
    G[h] = B.CQY[(ti + 1) * L::OYC + tj + h];
  }
  if (A.tw > 0) {
    // each part formed where its sum takes it (registers: the update of
    // a cell would otherwise keep the 24 parts of twelve interfaces)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // Fx at OX row ti+h: the y parts of OY rows ti+h+1 (lo) and ti+h
      // (hi), of amdq at column tj+1 and apdq at column tj
      T fy_lo = A.C[C_HDY], fy_hi = fy_lo;
      if (CAPA) {
        fy_lo = T(0.5) * B.template dtd<1>(A, ti + 2 + h, tj + 2);
        fy_hi = T(0.5) * B.template dtd<1>(A, ti + 1 + h, tj + 2);
      }
      F[h] = F[h] - (fy_lo * B.template part<1>(A, ti + h + 1, tj + 1, 0)
                     + fy_hi * B.template part<1>(A, ti + h, tj + 1, 1));
      F[h] = F[h] - (fy_lo * B.template part<1>(A, ti + h + 1, tj, 2)
                     + fy_hi * B.template part<1>(A, ti + h, tj, 3));
      // Gy at OY row ti+1, column tj+h: item_gather_y's two sums, of the
      // x parts of OX rows ti+1 (amdq) and ti (apdq), columns tj+h+1 (lo)
      // and tj+h (hi)
      T lo = A.C[C_HDX], hi = lo;
      if (CAPA) {
        lo = T(0.5) * B.template dtd<0>(A, ti + 2, tj + h + 2);
        hi = T(0.5) * B.template dtd<0>(A, ti + 2, tj + h + 1);
      }
      const T sum_am = lo * B.template part<0>(A, ti + 1, tj + h + 1, 0)
                     + hi * B.template part<0>(A, ti + 1, tj + h, 1);
      const T sum_ap = lo * B.template part<0>(A, ti, tj + h + 1, 2)
                     + hi * B.template part<0>(A, ti, tj + h, 3);
      G[h] = G[h] - sum_am - sum_ap;
    }
  }
  const T dxc = B.template dtd<0>(A, ti + 2, tj + 2);
  const T dyc = B.template dtd<1>(A, ti + 2, tj + 2);
  const T dq = (apx + amx + F[1] - F[0]) * dxc
             + (apy + amy + G[1] - G[0]) * dyc;
  A.qout[(long long)(I - 2) * ny + (J - 2)] = B.qc(ti + 2, tj + 2) - dq;
}

template <bool FWAVE, typename S, typename T, int TX, int TY, bool CAPA,
          class X>
HD void vstep_block(const SysArgs<S, T>& A, VBlock<S, T, TX, TY, CAPA>& B,
                    const X& run) {
  using L = VTile<S, T, TX, TY, CAPA>;
  run([&](int t) { phase_load(A, B, t); });
  run([&](int t) {
    // with transverse waves the generic design's whole OX and OY regions
    // (the update's parts read them); without, the tile's own columns of
    // OX and rows of OY
    const bool tr = A.tw > 0;
    T cx = T(0), cy = T(0);
    items2(t, tr ? L::OXN : L::OXR * TY, [&](int i) {
      vitem_sweep<0, FWAVE>(A, B, tr ? i / L::OXC : i / TY,
                            tr ? i % L::OXC : i % TY + 1, cx);
    }, tr ? L::OYN : TX * L::OYC, [&](int i) {
      vitem_sweep<1, FWAVE>(A, B, tr ? i / L::OYC : i / L::OYC + 1,
                            i % L::OYC, cy);
    });
    warp_fold(B.rx, t, cx);
    warp_fold(B.ry, t, cy);
  });
  run([&](int t) {
    for (int i = t; i < TX * TY; i += NT) vitem_update(A, B, i);
  });
}

template <typename S, typename T>
SysArgs<S, T> make_args(const void* qbc, const void* aux, void* qout,
                        void* cflb, int nxg, int nyg, int capa,
                        const double* dt, double dx, double dy, double p0,
                        double p1, int order, int tw, const int* lim) {
  SysArgs<S, T> A;
  A.qbc = static_cast<const T*>(qbc);
  // a system that reads its aux from row AUX0 on gets the rows from
  // there, its capacity row counted from there too
  A.aux = static_cast<const T*>(aux)
      + (long long)Aux0<S>::value * nxg * nyg;
  A.qout = static_cast<T*>(qout);
  A.cflb = static_cast<T*>(cflb);
  A.NX = nxg;
  A.NY = nyg;
  A.capa = capa - Aux0<S>::value;
  A.dt = dt;
  A.dx = T(dx);
  A.dy = T(dy);
  A.ddx = dx;
  A.ddy = dy;
  A.C = nullptr;
  // the system's two physics scalars: (grav, dry_tolerance) for shallow
  // water, (zz, cc) for acoustics, (gamma - 1, unused) for Euler, (u, v)
  // for advection_2D, (efix, unused) for Burgers, (linear, unused) for
  // psystem_2D, (grav, unused) for shallow_sphere_fwave_2D; a system
  // without a transverse solver runs with transverse_waves 0 (its gather
  // and update phases read tw; no split is compiled for it)
  A.P = S::template make_par<T>(p0, p1);
  A.order = order;
  A.tw = NoTrans<S>::value ? 0 : tw;
  for (int p = 0; p < nlim<S>(); ++p) A.lim[p] = lim[p];
  return A;
}

// the block of system S in a tile of TX x TY: Block, CBlock for the
// compact systems, PBlock and VBlock for the systems of their own design
template <typename S, typename T, int TX, int TY, bool CAPA>
using BlockOf = std::conditional_t<
    Compact<S>::value, CBlock<S, T, TX, TY, CAPA>,
    std::conditional_t<
        Own<S>::value == OWN_PSYSTEM, PBlock<S, T, TX, TY, CAPA>,
        std::conditional_t<Own<S>::value == OWN_VC_ADVECTION,
                           VBlock<S, T, TX, TY, CAPA>,
                           Block<S, T, TX, TY, CAPA>>>>;

template <typename S, typename T>
void grid_of(int nxg, int nyg, int& nbx, int& nby) {
  nbx = (nyg - 4 + SysShape<S, T>::TY - 1) / SysShape<S, T>::TY;
  nby = (nxg - 4 + SysShape<S, T>::TX - 1) / SysShape<S, T>::TX;
}

template <typename S, typename T, bool CAPA> constexpr size_t smem_bytes() {
  return BlockOf<S, T, SysShape<S, T>::TX, SysShape<S, T>::TY,
                 CAPA>::L::bytes;
}

template <typename S> int smem_of(bool capa, bool is_double) {
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

template <typename S, typename T, int TX, int TY, bool CAPA, bool FWAVE>
__global__ void __launch_bounds__(NT, (SysShape<S, T>::PER_SM))
    step2_aos_kernel(SysArgs<S, T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T coef[NCOEF];
  A.C = coef;
  if constexpr (Compact<S>::value) {
    CBlock<S, T, TX, TY, CAPA> B;
    B.bind(reinterpret_cast<T*>(smem_raw), blockIdx.x, blockIdx.y,
           gridDim.x);
    cstep_block<FWAVE>(A, B, DeviceRun());
    if (threadIdx.x == 0) A.cflb[B.bid] = block_cfl(A, B);
  } else if constexpr (Own<S>::value != OWN_NONE) {
    BlockOf<S, T, TX, TY, CAPA> B;
    B.bind(reinterpret_cast<T*>(smem_raw), blockIdx.x, blockIdx.y,
           gridDim.x);
    if constexpr (Own<S>::value == OWN_PSYSTEM) {
      pstep_block<FWAVE>(A, B, DeviceRun());
    } else {
      vstep_block<FWAVE>(A, B, DeviceRun());
    }
    if (threadIdx.x == 0) A.cflb[B.bid] = block_cfl(A, B);
  } else {
    Block<S, T, TX, TY, CAPA> B;
    B.bind(reinterpret_cast<T*>(smem_raw), blockIdx.x, blockIdx.y,
           gridDim.x);
    step_block<FWAVE>(A, B, DeviceRun());
    if (threadIdx.x == 0) A.cflb[B.bid] = block_cfl(A, B);
  }
}

template <typename S, typename T, bool CAPA, bool FWAVE>
int launch(const SysArgs<S, T>& A, int nbx, int nby, void* stream) {
  constexpr int TX = SysShape<S, T>::TX, TY = SysShape<S, T>::TY;
  constexpr size_t bytes = smem_bytes<S, T, CAPA>();
  static unsigned long long attr_done = 0;
  cudaError_t err = smem_attr_once(
      reinterpret_cast<const void*>(
          step2_aos_kernel<S, T, TX, TY, CAPA, FWAVE>),
      (int)bytes, attr_done);
  if (err != cudaSuccess) return (int)err;
  step2_aos_kernel<S, T, TX, TY, CAPA, FWAVE>
      <<<dim3(nbx, nby), NT, bytes, static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

// Blocks of system S's instance without capacity or f-waves resident on
// an SM of this card (its registers, shared memory and launch bound), or
// -1 when the query fails
template <typename S, typename T> int resident_blocks() {
  constexpr int TX = SysShape<S, T>::TX, TY = SysShape<S, T>::TY;
  constexpr size_t bytes = smem_bytes<S, T, false>();
  const void* fn = reinterpret_cast<const void*>(
      step2_aos_kernel<S, T, TX, TY, false, false>);
  int per = 0;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, step2_aos_kernel<S, T, TX, TY, false, false>, NT,
          bytes) != cudaSuccess)
    return -1;
  return per;
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

template <typename S, typename T, bool CAPA, bool FWAVE>
int launch(SysArgs<S, T> A, int nbx, int nby, void*) {
  constexpr int TX = SysShape<S, T>::TX, TY = SysShape<S, T>::TY;
  using Blk = BlockOf<S, T, TX, TY, CAPA>;
  std::vector<T> smem(Blk::L::elems);
  T coef[NCOEF];
  A.C = coef;
  for (int by = 0; by < nby; ++by) {
    for (int bx = 0; bx < nbx; ++bx) {
      Blk B;
      B.bind(smem.data(), bx, by, nbx);
      if constexpr (Compact<S>::value) cstep_block<FWAVE>(A, B, HostRun());
      else if constexpr (Own<S>::value == OWN_PSYSTEM)
        pstep_block<FWAVE>(A, B, HostRun());
      else if constexpr (Own<S>::value == OWN_VC_ADVECTION)
        vstep_block<FWAVE>(A, B, HostRun());
      else step_block<FWAVE>(A, B, HostRun());
      A.cflb[B.bid] = block_cfl(A, B);
    }
  }
  return 0;
}
#endif

// system ids of the C interface (ops/tiled2d.py:AOS_SYSTEMS); each a
// template instance of its own
enum { SYS_SHALLOW_ROE_EFIX = 0, SYS_SHALLOW_BATHY_FWAVE = 1,
       SYS_ACOUSTICS_2D = 2, SYS_EULER_4WAVE_2D = 3, SYS_EULER_5WAVE_2D = 4,
       SYS_SW_AUG_2D = 5, SYS_ADVECTION_2D = 6, SYS_VC_ADVECTION_2D = 7,
       SYS_VC_ADVECTION_FWAVE_2D = 8, SYS_VC_ACOUSTICS_2D = 9,
       SYS_KPP_2D = 10, SYS_BURGERS_2D = 11, SYS_PSYSTEM_2D = 12,
       SYS_SHALLOW_SPHERE_2D = 13, NUM_SYSTEMS = 14 };
// the limiter ids an entry takes (one per wave of the widest system)
constexpr int NLIM_ENTRY = 5;

template <typename T, typename S>
int dispatch_flags(const SysArgs<S, T>& A, bool capa, bool fwave,
                   void* stream) {
  int nbx, nby;
  grid_of<S, T>(A.NX, A.NY, nbx, nby);
  if (capa) {
    return fwave ? launch<S, T, true, true>(A, nbx, nby, stream)
                 : launch<S, T, true, false>(A, nbx, nby, stream);
  }
  return fwave ? launch<S, T, false, true>(A, nbx, nby, stream)
               : launch<S, T, false, false>(A, nbx, nby, stream);
}

template <class S> struct Sys { using type = S; };

// fn(Sys<S>()) for the system of id `system`; -1 for an unknown id
template <class F> int with_system(int system, const F& fn) {
  switch (system) {
    case SYS_SHALLOW_ROE_EFIX: return fn(Sys<ShallowRoeEfix2D>());
    case SYS_SHALLOW_BATHY_FWAVE: return fn(Sys<ShallowBathyFwave2D>());
    case SYS_ACOUSTICS_2D: return fn(Sys<Acoustics2D>());
    case SYS_EULER_4WAVE_2D: return fn(Sys<Euler4AoS2D>());
    case SYS_EULER_5WAVE_2D: return fn(Sys<Euler5AoS2D>());
    case SYS_SW_AUG_2D: return fn(Sys<SwAug2D>());
    case SYS_ADVECTION_2D: return fn(Sys<Advection2D>());
    case SYS_VC_ADVECTION_2D: return fn(Sys<VcAdvection2D>());
    case SYS_VC_ADVECTION_FWAVE_2D: return fn(Sys<VcAdvectionFwave2D>());
    case SYS_VC_ACOUSTICS_2D: return fn(Sys<VcAcoustics2D>());
    case SYS_KPP_2D: return fn(Sys<Kpp2D>());
    case SYS_BURGERS_2D: return fn(Sys<Burgers2D>());
    case SYS_PSYSTEM_2D: return fn(Sys<Psystem2D>());
    case SYS_SHALLOW_SPHERE_2D: return fn(Sys<ShallowSphere2D>());
    default: return -1;
  }
}

template <typename T>
int step(const void* qbc, const void* aux, void* qout, void* cflb, int nxg,
         int nyg, int system, int capa, int fwave, const double* dt,
         double dx, double dy, double p0, double p1, int order, int tw,
         const int* lim, void* stream) {
  return with_system(system, [&](auto sys) {
    using S = typename decltype(sys)::type;
    return dispatch_flags<T, S>(
        make_args<S, T>(qbc, aux, qout, cflb, nxg, nyg, capa, dt, dx, dy,
                        p0, p1, order, tw, lim),
        capa >= 0, fwave != 0, stream);
  });
}

}  // namespace

// ---- plain C interface (loaded with ctypes) ------------------------------
extern "C" {

// Number of blocks (= CFL partials) the kernel writes for a padded grid:
// of every system but the compact ones (step2_aos_system_blocks), and of
// system's.
int step2_aos_blocks(int nxg, int nyg, int is_double) {
  int nbx, nby;
  if (is_double) grid_of<ShallowRoeEfix2D, double>(nxg, nyg, nbx, nby);
  else grid_of<ShallowRoeEfix2D, float>(nxg, nyg, nbx, nby);
  return nbx * nby;
}
int step2_aos_system_blocks(int system, int nxg, int nyg, int is_double) {
  return with_system(system, [&](auto sys) {
    using S = typename decltype(sys)::type;
    int nbx, nby;
    if (is_double) grid_of<S, double>(nxg, nyg, nbx, nby);
    else grid_of<S, float>(nxg, nyg, nbx, nby);
    return nbx * nby;
  });
}

// Number of systems the build takes (system ids 0 .. this - 1).
int step2_aos_num_systems() { return NUM_SYSTEMS; }

// Number of limiter ids an entry takes.
int step2_aos_limiter_ids() { return NLIM_ENTRY; }

// Threads per block (reported by chip_smoke.py).
int step2_aos_threads() { return NT; }

// Blocks per SM system's instances are built for (the launch bound;
// reported by chip_smoke.py).
int step2_aos_system_blocks_per_sm(int system, int is_double) {
  return with_system(system, [&](auto sys) {
    using S = typename decltype(sys)::type;
    return is_double ? SysShape<S, double>::PER_SM
                     : SysShape<S, float>::PER_SM;
  });
}

#if defined(__CUDACC__)
// Blocks of system's instance without capacity or f-waves resident on an
// SM of this card (reported by chip_smoke.py), or -1.
int step2_aos_system_resident_blocks(int system, int is_double) {
  return with_system(system, [&](auto sys) {
    using S = typename decltype(sys)::type;
    return is_double ? resident_blocks<S, double>()
                     : resident_blocks<S, float>();
  });
}
#endif

// Shared memory bytes per block (reported by chip_smoke.py).
int step2_aos_smem_bytes(int system, int capa, int is_double) {
  return with_system(system, [&](auto sys) {
    return smem_of<typename decltype(sys)::type>(capa != 0, is_double != 0);
  });
}

// One CTU step.  qbc: (NEQ, nxg, nyg) ghost-padded (2 ghost cells), NEQ
// the system's; aux: (num_aux, nxg, nyg) or null when the system reads
// none and capa < 0; qout: (NEQ, nxg-4, nyg-4); cflb:
// step2_aos_system_blocks(system, ...) partial CFL maxima;
// all contiguous, of the type named by the entry.  system: SYS_*; capa:
// aux row of the capacity function or -1; fwave: the f-wave correction
// form; dt: the step in device memory (host memory for the host
// emulation), a double that is exact in the entry's type; p0, p1: the
// system's two physics scalars ((grav, dry_tolerance) for shallow water,
// (zz, cc) for acoustics, (gamma - 1, 0) for Euler, (u, v) for
// advection_2D, (efix, 0) for Burgers, (linear, 0) for psystem_2D, (grav,
// 0) for shallow_sphere_fwave_2D, unread by the other scalar systems
// and vc_acoustics_2D); l0..l4: the limiter
// ids of the waves (the kernel reads the system's NW).  Returns a
// cudaError_t (0 on success), or -1 for an unknown system.
#if defined(__CUDACC__)
#define STEP2_AOS_ENTRY(NAME, T)                                             \
  int NAME(const void* qbc, const void* aux, void* qout, void* cflb,         \
           int nxg, int nyg, int system, int capa, int fwave,                \
           const double* dt,                                                 \
           double dx, double dy, double p0, double p1, int order, int tw,     \
           int l0, int l1, int l2, int l3, int l4, void* stream) {           \
    const int lim[NLIM_ENTRY] = {l0, l1, l2, l3, l4};                        \
    return step<T>(qbc, aux, qout, cflb, nxg, nyg, system, capa, fwave, dt,  \
                   dx, dy, p0, p1, order, tw, lim, stream);                  \
  }
STEP2_AOS_ENTRY(step2_aos_f32, float)
STEP2_AOS_ENTRY(step2_aos_f64, double)
#else
#define STEP2_AOS_ENTRY(NAME, T)                                             \
  int NAME(const void* qbc, const void* aux, void* qout, void* cflb,         \
           int nxg, int nyg, int system, int capa, int fwave,                \
           const double* dt,                                                 \
           double dx, double dy, double p0, double p1, int order, int tw,     \
           int l0, int l1, int l2, int l3, int l4) {                         \
    const int lim[NLIM_ENTRY] = {l0, l1, l2, l3, l4};                        \
    return step<T>(qbc, aux, qout, cflb, nxg, nyg, system, capa, fwave, dt,  \
                   dx, dy, p0, p1, order, tw, lim, nullptr);                 \
  }
STEP2_AOS_ENTRY(step2_aos_host_f32, float)
STEP2_AOS_ENTRY(step2_aos_host_f64, double)
#endif
#undef STEP2_AOS_ENTRY

}  // extern "C"
