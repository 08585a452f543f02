// dq2_weno5.cu — one SharpClaw semidiscrete evaluation (WENO5, Roe,
// per-system flux) of a 2D system, one launch per RK stage, for Hopper
// (sm_90a).  Three systems, each a template instance of its own (a system
// struct gives NEQ, NW, Par and make_par, admissible, nz, waves, speeds
// and flux): the Euler 4-wave system (Euler4, the entries dq2_weno5_*),
// constant-coefficient acoustics_2D (Acoustics, dq2_weno5_acoustics_*)
// and the Euler 5-wave system with its passive tracer (Euler5,
// dq2_weno5_euler5_*).  The systems' structs are in dq2_systems.cuh,
// shared with dq2_weno.cu (the same kernel at WENO orders 7-17).
//
// Replaces the TPU kernel pyclaw_tpu/ops/tiled2d.py:dq_pallas_rows
// (pallas_call at :415) with its SoA body sharpclaw/soa.py:dq_2d_soa_roll.
// It computes what pyclaw_tpu/sharpclaw/soa.py:dq_2d_soa computes for
// componentwise WENO5 with the positivity fallback (Euler's; acoustics has
// none) and the flux form of the in-cell fluctuation; its plain PyTorch
// version is pyclaw_tpu_torch/sharpclaw/soa.py:dq_2d_soa with the system's
// SoA hooks, which it is held against on the card (chip_smoke.py [3b],
// [3j]) and, through the host emulation at the end of this file, on the
// CPU (tests/test_torch_sharpclaw_kernel.py, tests/test_torch_sharpclaw_nd.py).
//
// The Euler 5-wave instance (added after the acoustics one): Euler4's
// algebra on the first four components and the tracer of
// riemann/euler.py's _rpn2_euler_soa and _flux_euler_2d_soa (tracer=True):
// 5 equations and 5 waves, the positivity fallback on rho and p only.
// Its block takes 60,752 B (f32) / 121,504 B (f64) of shared memory, so
// f64 runs one block an SM.  Measured on the shock bubble at 2048x512
// (PERF.md section 6; H100, 700 W): 0.23 / 1.01 ms (f32 / f64).
//
// The acoustics instance (added after the Euler one was redesigned): 3
// equations, 2 waves of the constant speeds -c and +c whose transverse
// velocity component is zero (nz skips it, as the plain version's None
// components are skipped), the flux (zz cc u_n, cc/zz p, 0).  Per cell it
// moves 24 B in f32 (3 values in, 3 out) and does 761 (f32) / 695 (f64)
// operations (chip_smoke.py:FLOPS_PER_CELL_DQ_ACOUSTICS), most of them
// WENO5's: operations bound it, as they bound Euler.  It keeps Euler's
// tile and phases.  The Euler instance's code is the same template with
// Euler's hooks, and its bits are unchanged (ops/time_kernels.py
// dq2_weno5 against the parent's build).
//
// What bounds it on the card: per cell it must read the 4 values of q
// (with the 3-cell ghost band) and write the 4 values of dq, about 32 B
// per cell in f32 (33.8 MB at 1024^2) and 64 B in f64.  It does 1348 (f32)
// / 1252 (f64) floating-point operations per cell
// (chip_smoke.py:FLOPS_PER_CELL_DQ): two directions of WENO5 for four
// components (smoothness indicators, six candidate values, the weights and
// their divides), two positivity tests, one Roe solve per interface, two
// flux evaluations per cell.  At 67 TFLOP/s (f32) or 34 TFLOP/s (f64) the
// operation bound (0.0211 / 0.0386 ms at 1024^2) is above the byte bound
// at 3.35 TB/s, so operations bound it.  Tensor cores do not apply: there
// is no matrix product, only per-cell scalar arithmetic (the WENO weights,
// the Roe solves).
//
// What the design does about it: nothing but q and dq touches device
// memory, and each quantity is computed once per block.  A block owns a
// TX x TY tile of cells and stages q with a 3-cell halo in shared memory.
// Each direction computes the WENO edge states of the tile plus a 1-cell
// ring along the sweep (positivity fallback applied) into shared memory,
// then the Roe fluctuations at the tile's interfaces, then that
// direction's part of dq.  The tile is 16 x 16 cells and a block has 288
// threads, so the edge phases (18 x 16 cells) keep every thread busy.  The
// TPU's workarounds are gone: no roll form, no 8-row over-fetch, no
// 128-lane padding, no prepadded interior.  Ragged edges are masked, so
// any (nx, ny) works.
//
// What changed since the first port, measured against it in one
// call at 1024^2 (PERF.md section 6; H100, 700 W): 7.0% (f32) / 6.5%
// (f64), with the same bits:
//   - staging: every copy is issued (cp.async, 4 or 8 B: the padded rows
//     are not 16-byte aligned) before the thread waits on any;
//   - each direction's edge states and fluctuations have their own arrays,
//     so both directions' edges share a phase, both directions' interfaces
//     the next, and both parts of dq a third with no barrier between them
//     (a thread owns the same cells in both);
//   - the CFL partial is a warp-shuffle max and one slot per warp, not a
//     tree: 5 barriers a block, not 16.
// What did not pay, measured the same way: persistent blocks that prefetch
// the next tile into a second buffer; 2 or 4 blocks per SM in place of 3
// (f32) and 1 or 3 in place of 2 (f64); a division by 6 as an exact FMA
// sequence; handing a zero numerator back without dividing (bit for bit,
// 3% slower: zero numerators do not take the division's slow path).  The kernel is bound by its instructions: built with
// -prec-div=false (a probe only, not IEEE) it takes 28% less time in f32.
// Its arithmetic code is the first port's as compiled (FMA contraction on,
// ops/_build.py), bit for bit: a version with the same operations but
// another contraction moved one dq by 2.9e-8 and the SharpClaw quadrants
// run from 744 + 8 steps to 748 + 8.
//
// Resources (ptxas and the occupancy query, chip_smoke.py [2]): f32 71
// registers, no spills, 3 blocks (27 warps) per SM; f64 96 registers with
// 116 B of spill stores (a 136 B stack, as the first port), 2 blocks (18
// warps) per SM: without spills (one block, 139 registers) it ran 35%
// slower; 48,832 / 97,664 B of shared memory a block.
//
// The CFL window (sharpclaw/soa.py:_dq_dir_soa) covers the x-interfaces
// g-1 .. nxg-g-1 across the FULL y extent, ghost columns included, and the
// mirror window for y.  Blocks at the y (x) ends of the grid therefore
// also solve the x- (y-) interfaces of the ghost band, for the CFL only.
//
// Phases (each a loop of the block's threads over a region), with a
// barrier after the load, the edges and the interfaces, and two for the
// CFL max:
//   load     q tile + 3-cell halo -> shared (indices clamped to the padded
//            grid; clamped cells only feed masked-out results, or
//            replicate the last column/row, which is in the CFL window)
//   edges<0>, edges<1>   WENO5 edge states of each component along x and
//            y, positivity fallback -> E[0], E[1]
//   iface<0>, iface<1>   Roe solve at each x- and y-interface: amdq, apdq
//            -> F[0], F[1]; CFL partial max, including the ghost band at
//            the grid's ends
//   update<0>, update<1> the x part of dq from F[0] and f(qr) - f(ql) of
//            E[0] -> DQ; the y part added to it and dq stored
//   reduce   warp-shuffle max of the CFL partials; one value per block
//
// The arithmetic repeats the plain version operation for operation,
// including the float32/float64 branches of limiters/recon.py (WENO
// weights) and riemann/euler.py (_alpha34, _flux_euler_2d_soa); the
// acoustics algebra is riemann/acoustics.py's _rp_acoustics_soa and
// _flux_acoustics_soa, the Python scalars folded in double as there.

#include "async_copy.cuh"
#include "dq2_systems.cuh"
#include "dt_coef.cuh"
#include "euler2d.cuh"
#include "weno5.cuh"

namespace {

constexpr int NT = 288;      // threads per block (9 warps)
constexpr int TX = 16, TY = 16;  // cells per tile along x (rows), y (cols)
constexpr int G = 3;         // ghost cells (WENO5)

// ---- block geometry and shared-memory layout --------------------------
constexpr int QR = TX + 2 * G, QC = TY + 2 * G;   // q tile + halo
constexpr int EXR = TX + 2, EXC = TY;             // x edge states
constexpr int EYR = TX, EYC = TY + 2;             // y edge states
constexpr int FXR = TX + 1, FXC = TY;             // x interfaces
constexpr int FYR = TX, FYC = TY + 1;             // y interfaces
constexpr int EN = EXR * EXC > EYR * EYC ? EXR * EXC : EYR * EYC;
constexpr int FN = FXR * FXC > FYR * FYC ? FXR * FXC : FYR * FYC;

template <typename S, typename T> struct Layout {
  // Q [NEQ][QR][QC], E [2][2 NEQ][EN] (per direction: ql 0..NEQ-1, qr
  // NEQ..2 NEQ-1), F [2][2 NEQ][FN] (per direction: amdq, then apdq),
  // DQ [NEQ][TX*TY] (the x part of dq), R [NT] (CFL partials)
  static constexpr int N = S::NEQ;
  static constexpr size_t elems =
      N * QR * QC + 2 * 2 * N * EN + 2 * 2 * N * FN + N * TX * TY + NT;
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

// The coefficients of dt in Args::C: dt/dx, dt/dy, -dt/dx, -dt/dy in T,
// as the host computed them from T(dt) before (dt_coef.cuh)
enum { C_DTDX = 0, C_DTDY = 1, C_NDTDX = 2, C_NDTDY = 3, NCOEF = 4 };

// coefficient k of dt (C_*): T(dt)/T(dx) or T(dt)/T(dy), negated for
// C_NDTDX and C_NDTDY
template <typename S, typename T> HD T dt_coef(const Args<S, T>& A, int k) {
  const T q = T(*A.dt) / (k % 2 == 0 ? A.dx : A.dy);
  return k < C_NDTDX ? q : -q;
}

template <typename S, typename T> struct Block {
  static constexpr int N = S::NEQ;
  T* Q;
  T* E[2];   // edge states along x, y
  T* F[2];   // fluctuations at the x-, y-interfaces
  T* DQ;
  T* R;
  int I0, J0, bx, by, nbx, nby;  // first interior cell (padded indices)

  HD void bind(T* s, int bx_, int by_, int nbx_, int nby_) {
    Q = s;
    E[0] = Q + N * QR * QC;
    E[1] = E[0] + 2 * N * EN;
    F[0] = E[1] + 2 * N * EN;
    F[1] = F[0] + 2 * N * FN;
    DQ = F[1] + 2 * N * FN;
    R = DQ + N * TX * TY;
    bx = bx_;
    by = by_;
    nbx = nbx_;
    nby = nby_;
    I0 = G + by * TX;
    J0 = G + bx * TY;
  }
  HD T q(int e, int r, int c) const { return Q[(e * QR + r) * QC + c]; }
};

// ---- phase: stage q tile + halo ----------------------------------------
// every copy is issued (cp.async) before the thread waits on any
template <typename S, typename T>
HD void phase_load(const Args<S, T>& A, Block<S, T>& B, int tid) {
  for (int idx = tid; idx < S::NEQ * QR * QC; idx += NT) {
    int e = idx / (QR * QC);
    int r = (idx / QC) % QR;
    int c = idx % QC;
    int I = B.I0 - G + r, J = B.J0 - G + c;
    I = I < A.NX ? I : A.NX - 1;
    J = J < A.NY ? J : A.NY - 1;
    copy_async(B.Q + idx, A.qbc + ((long long)e * A.NX + I) * A.NY + J);
  }
  B.R[tid] = T(0);
  // the block's coefficients of dt while the copies land
  if (tid < NCOEF) A.C[tid] = dt_coef(A, tid);
  copy_wait_all();
}

// WENO edge states of the cell at staged (row, col) along D, with the
// positivity fallback to the cell average (sharpclaw/soa.py:89-92)
template <int D, typename S, typename T>
HD void edge_states(const Args<S, T>& A, const Block<S, T>& B, int row,
                    int col, T ql[S::NEQ], T qr[S::NEQ]) {
  for (int e = 0; e < S::NEQ; ++e) {
    T v[5];
    for (int k = 0; k < 5; ++k)
      v[k] = D == 0 ? B.q(e, row - 2 + k, col) : B.q(e, row, col - 2 + k);
    weno5(v[0], v[1], v[2], v[3], v[4], ql[e], qr[e]);
  }
  if (!(S::admissible(A.P, ql) && S::admissible(A.P, qr))) {
    for (int e = 0; e < S::NEQ; ++e) {
      ql[e] = B.q(e, row, col);
      qr[e] = ql[e];
    }
  }
}

// ---- phase: edge states of the tile plus a 1-cell ring along D ---------
template <int D, typename S, typename T>
HD void phase_edges(const Args<S, T>& A, Block<S, T>& B, int tid) {
  constexpr int N = S::NEQ;
  constexpr int ER = D == 0 ? EXR : EYR, EC = D == 0 ? EXC : EYC;
  for (int idx = tid; idx < ER * EC; idx += NT) {
    int r = idx / EC, c = idx % EC;
    // x: cell (I0-1+r, J0+c) = staged (r+2, c+3); y: (I0+r, J0-1+c)
    int row = D == 0 ? r + 2 : r + 3, col = D == 0 ? c + 3 : c + 2;
    T ql[N], qr[N];
    edge_states<D>(A, B, row, col, ql, qr);
    for (int e = 0; e < N; ++e) {
      B.E[D][e * EN + idx] = ql[e];
      B.E[D][(N + e) * EN + idx] = qr[e];
    }
  }
}

template <int NW, typename T> HD T speed_max(const T s[NW], T dtdx) {
  T m = dtdx * fabs_(s[0]);
  for (int p = 1; p < NW; ++p) m = mx(m, dtdx * fabs_(s[p]));
  return m;
}

// ---- phase: Roe solves at the tile's interfaces along D, and the CFL ---
template <int D, typename S, typename T>
HD void phase_iface(const Args<S, T>& A, Block<S, T>& B, int tid) {
  constexpr int N = S::NEQ, NW = S::NW;
  constexpr int FR = D == 0 ? FXR : FYR, FC = D == 0 ? FXC : FYC;
  constexpr int EC = D == 0 ? EXC : EYC;
  const T dtdx = A.C[D == 0 ? C_DTDX : C_DTDY];
  T smax = B.R[tid];
  for (int idx = tid; idx < FR * FC; idx += NT) {
    int r = idx / FC, c = idx % FC;
    // interface between E cells (r, c) and x: (r+1, c), y: (r, c+1)
    int el = r * EC + c;
    int er = D == 0 ? el + EC : el + 1;
    T ql[N], qr[N];
    for (int e = 0; e < N; ++e) {
      ql[e] = B.E[D][(N + e) * EN + el];   // qr of the left cell
      qr[e] = B.E[D][e * EN + er];         // ql of the right cell
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
      B.F[D][e * FN + idx] = m;
      B.F[D][(N + e) * FN + idx] = pp;
    }
    // x-interface k = I0-1+r (y: j = J0-1+c) is in the window up to nxg-4
    bool in_cfl = D == 0 ? B.I0 - 1 + r <= A.NX - 4 : B.J0 - 1 + c <= A.NY - 4;
    if (in_cfl) smax = mx(smax, speed_max<NW>(s, dtdx));
  }

  // ghost band across the sweep (x: columns 0..2 and nyg-3..nyg-1), for
  // the CFL only: 3 lines at each end of the grid, FR or FC interfaces each
  constexpr int NL = D == 0 ? FR : FC;
  const bool lo = D == 0 ? B.bx == 0 : B.by == 0;
  const bool hi = D == 0 ? B.bx == B.nbx - 1 : B.by == B.nby - 1;
  for (int idx = tid; idx < 2 * G * NL; idx += NT) {
    int side = idx / (G * NL), line = (idx / NL) % G, k = idx % NL;
    if (!(side == 0 ? lo : hi)) continue;
    // staged line across the sweep: 0..2 below the tile, TY+3.. above
    int across = side == 0 ? line : (D == 0 ? TY : TX) + G + line;
    // cells k and k+1 along the sweep, staged index k+2 and k+3
    int row_l = D == 0 ? k + 2 : across, col_l = D == 0 ? across : k + 2;
    int row_r = D == 0 ? k + 3 : across, col_r = D == 0 ? across : k + 3;
    bool in_cfl = D == 0 ? B.I0 - 1 + k <= A.NX - 4 : B.J0 - 1 + k <= A.NY - 4;
    if (!in_cfl) continue;
    T ql_l[N], qr_l[N], ql_r[N], qr_r[N];
    edge_states<D>(A, B, row_l, col_l, ql_l, qr_l);
    edge_states<D>(A, B, row_r, col_r, ql_r, qr_r);
    T s[NW];
    S::template speeds<D>(A.P, qr_l, ql_r, s);
    smax = mx(smax, speed_max<NW>(s, dtdx));
  }
  B.R[tid] = smax;
}

// ---- phase: one direction's part of dq --------------------------------
// x: DQ = -dt/dx (apdq_{I-1} + amdq_I + f(qr_I) - f(ql_I));
// y: dq = DQ + -dt/dy (...), stored to device memory (masked)
template <int D, typename S, typename T>
HD void phase_update(const Args<S, T>& A, Block<S, T>& B, int tid) {
  constexpr int N = S::NEQ;
  constexpr int FC = D == 0 ? FXC : FYC, EC = D == 0 ? EXC : EYC;
  const T ndt = A.C[D == 0 ? C_NDTDX : C_NDTDY];
  const int nx = A.NX - 2 * G, ny = A.NY - 2 * G;
  for (int idx = tid; idx < TX * TY; idx += NT) {
    int ti = idx / TY, tj = idx % TY;
    int I = B.I0 + ti, J = B.J0 + tj;
    // interfaces below / above the cell; the cell's own edge states
    int f_lo = ti * FC + tj;
    int f_hi = D == 0 ? f_lo + FC : f_lo + 1;
    int ec = D == 0 ? (ti + 1) * EC + tj : ti * EC + tj + 1;
    T ql[N], qr[N], fl[N], fr[N];
    for (int e = 0; e < N; ++e) {
      ql[e] = B.E[D][e * EN + ec];
      qr[e] = B.E[D][(N + e) * EN + ec];
    }
    S::template flux<D>(A.P, ql, fl);
    S::template flux<D>(A.P, qr, fr);
    if (D == 1 && (I >= A.NX - G || J >= A.NY - G)) continue;
    for (int e = 0; e < N; ++e) {
      T part = ndt * (B.F[D][(N + e) * FN + f_lo] + B.F[D][e * FN + f_hi]
                      + (fr[e] - fl[e]));
      if (D == 0) {
        B.DQ[e * TX * TY + idx] = part;
      } else {
        A.dq[((long long)e * nx + (I - G)) * ny + (J - G)] =
            B.DQ[e * TX * TY + idx] + part;
      }
    }
  }
}

// the block's CFL partial from the per-warp maxima in R[0 .. NT/32)
template <typename S, typename T>
HD void phase_write_cfl(const Args<S, T>& A, Block<S, T>& B, int tid) {
  if (tid != 0) return;
  T c = B.R[0];
  for (int w = 1; w < NT / 32; ++w) c = mx(c, B.R[w]);
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

void grid_of(int nxg, int nyg, int& nbx, int& nby) {
  nbx = (nyg - 2 * G + TY - 1) / TY;
  nby = (nxg - 2 * G + TX - 1) / TX;
}

#if defined(__CUDACC__)
template <typename S, typename T>
__global__ void __launch_bounds__(NT, 2) dq2_weno5_kernel(Args<S, T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T coef[NCOEF];
  A.C = coef;
  Block<S, T> B;
  B.bind(reinterpret_cast<T*>(smem_raw), blockIdx.x, blockIdx.y, gridDim.x,
         gridDim.y);
  const int tid = threadIdx.x;
  phase_load<S, T>(A, B, tid);
  __syncthreads();
  phase_edges<0, S, T>(A, B, tid);
  phase_edges<1, S, T>(A, B, tid);
  __syncthreads();
  phase_iface<0, S, T>(A, B, tid);
  phase_iface<1, S, T>(A, B, tid);
  __syncthreads();
  // a thread owns the same cells in both: no barrier between
  phase_update<0, S, T>(A, B, tid);
  phase_update<1, S, T>(A, B, tid);
  // the CFL partial: a warp-shuffle max, then one slot per warp
  const T m = warp_max(B.R[tid]);
  __syncthreads();
  if (tid % 32 == 0) B.R[tid / 32] = m;
  __syncthreads();
  phase_write_cfl<S, T>(A, B, tid);
}

// the devices whose shared-memory attribute of dq2_weno5_kernel<S, T> is set
template <typename S, typename T> unsigned long long attr_done = 0;

template <typename S, typename T>
int launch(const void* qbc, void* dq, void* cflb, int nxg, int nyg,
           const double* dt, double dx, double dy, double p0, double p1,
           void* stream) {
  cudaError_t err = smem_attr_once(
      reinterpret_cast<const void*>(dq2_weno5_kernel<S, T>),
      (int)Layout<S, T>::bytes, attr_done<S, T>);
  if (err != cudaSuccess) return (int)err;
  int nbx, nby;
  grid_of(nxg, nyg, nbx, nby);
  Args<S, T> A = make_args<S, T>(qbc, dq, cflb, nxg, nyg, dt, dx, dy, p0, p1);
  dq2_weno5_kernel<S, T><<<dim3(nbx, nby), NT, Layout<S, T>::bytes,
                           static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}
template <typename S, typename T> int blocks_per_sm() {
  int per = 0;
  if (smem_attr_once(reinterpret_cast<const void*>(dq2_weno5_kernel<S, T>),
                     (int)Layout<S, T>::bytes, attr_done<S, T>) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, dq2_weno5_kernel<S, T>, NT, Layout<S, T>::bytes) !=
          cudaSuccess)
    return -1;
  return per;
}
#else
// Host emulation: the same phases, one block and one "thread" at a time,
// with each barrier between two phases kept by running the whole block
// through a phase before the next.  Used by the CPU tests to check the
// kernel's index algebra against the plain version without a card.
template <typename S, typename T>
int launch_host(const void* qbc, void* dq, void* cflb, int nxg, int nyg,
                const double* dt, double dx, double dy, double p0,
                double p1) {
  int nbx, nby;
  grid_of(nxg, nyg, nbx, nby);
  Args<S, T> A = make_args<S, T>(qbc, dq, cflb, nxg, nyg, dt, dx, dy, p0, p1);
  std::vector<T> smem(Layout<S, T>::elems);
  T coef[NCOEF];
  A.C = coef;
  for (int by = 0; by < nby; ++by) {
    for (int bx = 0; bx < nbx; ++bx) {
      Block<S, T> B;
      B.bind(smem.data(), bx, by, nbx, nby);
      for (int t = 0; t < NT; ++t) phase_load<S, T>(A, B, t);
      for (int t = 0; t < NT; ++t) {
        phase_edges<0, S, T>(A, B, t);
        phase_edges<1, S, T>(A, B, t);
      }
      for (int t = 0; t < NT; ++t) {
        phase_iface<0, S, T>(A, B, t);
        phase_iface<1, S, T>(A, B, t);
      }
      for (int t = 0; t < NT; ++t) {
        phase_update<0, S, T>(A, B, t);
        phase_update<1, S, T>(A, B, t);
      }
      // the warp max as a loop over the lanes (R[t / 32] is written only
      // after thread t / 32's own value has been read)
      for (int t = 0; t < NT; ++t)
        B.R[t / 32] = t % 32 == 0 ? B.R[t] : mx(B.R[t / 32], B.R[t]);
      phase_write_cfl<S, T>(A, B, 0);
    }
  }
  return 0;
}
#endif

}  // namespace

// ---- plain C interface (loaded with ctypes) ----------------------------
extern "C" {

// Number of blocks (= CFL partials) the kernel writes for a padded grid
// (either system).
int dq2_weno5_blocks(int nxg, int nyg) {
  int nbx, nby;
  grid_of(nxg, nyg, nbx, nby);
  return nbx * nby;
}

// Shared memory bytes per block (reported by chip_smoke.py): Euler, and the
// acoustics instance.
int dq2_weno5_smem_bytes(int is_double) {
  return is_double ? (int)Layout<Euler4, double>::bytes
                   : (int)Layout<Euler4, float>::bytes;
}
int dq2_weno5_acoustics_smem_bytes(int is_double) {
  return is_double ? (int)Layout<Acoustics, double>::bytes
                   : (int)Layout<Acoustics, float>::bytes;
}
int dq2_weno5_euler5_smem_bytes(int is_double) {
  return is_double ? (int)Layout<Euler5, double>::bytes
                   : (int)Layout<Euler5, float>::bytes;
}

// One SharpClaw dq.  qbc: (NEQ, nxg, nyg) ghost-padded (3 ghost cells), dq:
// (NEQ, nxg-6, nyg-6), cflb: dq2_weno5_blocks(...) partial CFL maxima; all
// contiguous, of the type named by the entry.  dt: the step in device
// memory (host memory for the host emulation), a double that is exact in
// the entry's type.  The Euler entries (NEQ 4) take g1 = gamma - 1, the
// acoustics entries (NEQ 3) the impedance zz and the sound speed cc.
// Returns a cudaError_t (0 on success).
#if defined(__CUDACC__)
int dq2_weno5_f32(const void* qbc, void* dq, void* cflb, int nxg, int nyg,
                  const double* dt, double dx, double dy, double g1,
                  void* stream) {
  return launch<Euler4, float>(qbc, dq, cflb, nxg, nyg, dt, dx, dy, g1, 0.0,
                               stream);
}

int dq2_weno5_f64(const void* qbc, void* dq, void* cflb, int nxg, int nyg,
                  const double* dt, double dx, double dy, double g1,
                  void* stream) {
  return launch<Euler4, double>(qbc, dq, cflb, nxg, nyg, dt, dx, dy, g1, 0.0,
                                stream);
}

int dq2_weno5_euler5_f32(const void* qbc, void* dq, void* cflb, int nxg,
                         int nyg, const double* dt, double dx, double dy,
                         double g1, void* stream) {
  return launch<Euler5, float>(qbc, dq, cflb, nxg, nyg, dt, dx, dy, g1, 0.0,
                               stream);
}

int dq2_weno5_euler5_f64(const void* qbc, void* dq, void* cflb, int nxg,
                         int nyg, const double* dt, double dx, double dy,
                         double g1, void* stream) {
  return launch<Euler5, double>(qbc, dq, cflb, nxg, nyg, dt, dx, dy, g1,
                                0.0, stream);
}

int dq2_weno5_acoustics_f32(const void* qbc, void* dq, void* cflb, int nxg,
                            int nyg, const double* dt, double dx, double dy,
                            double zz, double cc, void* stream) {
  return launch<Acoustics, float>(qbc, dq, cflb, nxg, nyg, dt, dx, dy, zz,
                                  cc, stream);
}

int dq2_weno5_acoustics_f64(const void* qbc, void* dq, void* cflb, int nxg,
                            int nyg, const double* dt, double dx, double dy,
                            double zz, double cc, void* stream) {
  return launch<Acoustics, double>(qbc, dq, cflb, nxg, nyg, dt, dx, dy, zz,
                                   cc, stream);
}

// Resident blocks per SM on the current device (reported by
// chip_smoke.py), or -1 on an error.
int dq2_weno5_blocks_per_sm(int is_double) {
  return is_double ? blocks_per_sm<Euler4, double>()
                   : blocks_per_sm<Euler4, float>();
}
int dq2_weno5_acoustics_blocks_per_sm(int is_double) {
  return is_double ? blocks_per_sm<Acoustics, double>()
                   : blocks_per_sm<Acoustics, float>();
}
int dq2_weno5_euler5_blocks_per_sm(int is_double) {
  return is_double ? blocks_per_sm<Euler5, double>()
                   : blocks_per_sm<Euler5, float>();
}
#else
int dq2_weno5_host_f32(const void* qbc, void* dq, void* cflb, int nxg,
                       int nyg, const double* dt, double dx, double dy,
                       double g1) {
  return launch_host<Euler4, float>(qbc, dq, cflb, nxg, nyg, dt, dx, dy, g1,
                                    0.0);
}

int dq2_weno5_host_f64(const void* qbc, void* dq, void* cflb, int nxg,
                       int nyg, const double* dt, double dx, double dy,
                       double g1) {
  return launch_host<Euler4, double>(qbc, dq, cflb, nxg, nyg, dt, dx, dy, g1,
                                     0.0);
}

int dq2_weno5_euler5_host_f32(const void* qbc, void* dq, void* cflb,
                              int nxg, int nyg, const double* dt, double dx,
                              double dy, double g1) {
  return launch_host<Euler5, float>(qbc, dq, cflb, nxg, nyg, dt, dx, dy, g1,
                                    0.0);
}

int dq2_weno5_euler5_host_f64(const void* qbc, void* dq, void* cflb,
                              int nxg, int nyg, const double* dt, double dx,
                              double dy, double g1) {
  return launch_host<Euler5, double>(qbc, dq, cflb, nxg, nyg, dt, dx, dy,
                                     g1, 0.0);
}

int dq2_weno5_acoustics_host_f32(const void* qbc, void* dq, void* cflb,
                                 int nxg, int nyg, const double* dt,
                                 double dx, double dy, double zz, double cc) {
  return launch_host<Acoustics, float>(qbc, dq, cflb, nxg, nyg, dt, dx, dy,
                                       zz, cc);
}

int dq2_weno5_acoustics_host_f64(const void* qbc, void* dq, void* cflb,
                                 int nxg, int nyg, const double* dt,
                                 double dx, double dy, double zz, double cc) {
  return launch_host<Acoustics, double>(qbc, dq, cflb, nxg, nyg, dt, dx, dy,
                                        zz, cc);
}
#endif

}  // extern "C"
