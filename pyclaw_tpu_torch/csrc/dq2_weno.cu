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
// per component and direction the WENO takes K betas of K^2 products
// each, 2K candidate values of K terms and the weights: at order 17
// about 3,000 operations a component and direction against order 5's
// 109.  Operations bound it (chip_smoke.py:flops_per_cell_dq_weno).
//
// What the design does about it: dq2_weno5.cu's tile, phases and CFL
// windows with a K-cell halo: nothing but q and dq touches device memory;
// a block owns a 16 x 16 tile of cells, stages q with its halo in shared
// memory, computes each direction's edge states of the tile plus a 1-cell
// ring along the sweep (positivity fallback applied), the Roe
// fluctuations at the tile's interfaces, then dq.  The WENO of one
// component is one function (weno_edges<K, T>), called and not inlined,
// reading its 2K-1 values from the staged tile: its many live values stay
// out of the phases' registers, and each order and type compiles it once
// for its three systems.  Shared memory: N (16 + 2K)^2 + 4N 288 + 4N 272
// + 256 N + 288 values a block (Euler at K = 9: 59.6 KB float32, 119 KB
// float64), past 48 KB for every float64 instance and the larger float32
// ones, so each instance sets the opt-in attribute before its launches.
//
// The CFL window (sharpclaw/soa.py:_dq_dir_soa) covers the x-interfaces
// K-1 .. nxg-K-1 across the FULL y extent, ghost columns included, and the
// mirror window for y: blocks at the y (x) ends of the grid also solve the
// x- (y-) interfaces of the K-wide ghost band, for the CFL only.
//
// Phases, with a barrier after the load, the edges and the interfaces, and
// two for the CFL max:
//   load     q tile + K-cell halo -> shared (indices clamped to the padded
//            grid; clamped cells only feed masked-out results, or
//            replicate the last column/row, which is in the CFL window)
//   edges<0>, edges<1>   WENO edge states along x and y, positivity
//            fallback -> E[0], E[1]
//   iface<0>, iface<1>   Roe solve at each x- and y-interface: amdq, apdq
//            -> F[0], F[1]; CFL partial max, including the ghost band
//   update<0>, update<1> the x part of dq -> DQ; the y part added, stored
//   reduce   warp-shuffle max of the CFL partials; one value per block

#include "async_copy.cuh"
#include "dq2_systems.cuh"
#include "dt_coef.cuh"
#include "euler2d.cuh"
#include "weno_tables.cuh"

namespace {

constexpr int NT = 288;      // threads per block (9 warps)
constexpr int TX = 16, TY = 16;  // cells per tile along x (rows), y (cols)

#if defined(__CUDACC__)
#define NOINLINE __device__ __noinline__
#else
#define NOINLINE inline
#endif

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
NOINLINE Edges<T> weno_edges(const T* v0, int stride) {
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
constexpr int EXR = TX + 2, EXC = TY;             // x edge states
constexpr int EYR = TX, EYC = TY + 2;             // y edge states
constexpr int FXR = TX + 1, FXC = TY;             // x interfaces
constexpr int FYR = TX, FYC = TY + 1;             // y interfaces
constexpr int EN = EXR * EXC > EYR * EYC ? EXR * EXC : EYR * EYC;
constexpr int FN = FXR * FXC > FYR * FYC ? FXR * FXC : FYR * FYC;

template <int K> struct Tile {
  static constexpr int QR = TX + 2 * K, QC = TY + 2 * K;   // q tile + halo
};

template <typename S, int K, typename T> struct Layout {
  // Q [NEQ][QR][QC], E [2][2 NEQ][EN] (per direction: ql 0..NEQ-1, qr
  // NEQ..2 NEQ-1), F [2][2 NEQ][FN] (per direction: amdq, then apdq),
  // DQ [NEQ][TX*TY] (the x part of dq), R [NT] (CFL partials)
  static constexpr int N = S::NEQ;
  static constexpr size_t elems = N * Tile<K>::QR * Tile<K>::QC +
                                  2 * 2 * N * EN + 2 * 2 * N * FN +
                                  N * TX * TY + NT;
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
  static constexpr int N = S::NEQ;
  static constexpr int QR = Tile<K>::QR, QC = Tile<K>::QC;
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
    I0 = K + by * TX;
    J0 = K + bx * TY;
  }
  HD const T* at(int e, int r, int c) const {
    return Q + (e * QR + r) * QC + c;
  }
};

// ---- phase: stage q tile + halo ----------------------------------------
template <typename S, int K, typename T>
HD void phase_load(const Args<S, T>& A, Block<S, K, T>& B, int tid) {
  constexpr int QR = Tile<K>::QR, QC = Tile<K>::QC;
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

// WENO edge states of the cell at staged (row, col) along D, with the
// positivity fallback to the cell average (sharpclaw/soa.py:_dq_dir_soa)
template <int D, typename S, int K, typename T>
HD void edge_states(const Args<S, T>& A, const Block<S, K, T>& B, int row,
                    int col, T ql[S::NEQ], T qr[S::NEQ]) {
  constexpr int QC = Tile<K>::QC;
  for (int e = 0; e < S::NEQ; ++e) {
    const Edges<T> ed =
        D == 0 ? weno_edges<K, T>(B.at(e, row - (K - 1), col), QC)
               : weno_edges<K, T>(B.at(e, row, col - (K - 1)), 1);
    ql[e] = ed.ql;
    qr[e] = ed.qr;
  }
  if (!(S::admissible(A.P, ql) && S::admissible(A.P, qr))) {
    for (int e = 0; e < S::NEQ; ++e) {
      ql[e] = *B.at(e, row, col);
      qr[e] = ql[e];
    }
  }
}

// ---- phase: edge states of the tile plus a 1-cell ring along D ---------
template <int D, typename S, int K, typename T>
HD void phase_edges(const Args<S, T>& A, Block<S, K, T>& B, int tid) {
  constexpr int N = S::NEQ;
  constexpr int ER = D == 0 ? EXR : EYR, EC = D == 0 ? EXC : EYC;
  for (int idx = tid; idx < ER * EC; idx += NT) {
    int r = idx / EC, c = idx % EC;
    // x: cell (I0-1+r, J0+c) = staged (r+K-1, c+K); y: (I0+r, J0-1+c)
    int row = D == 0 ? r + K - 1 : r + K, col = D == 0 ? c + K : c + K - 1;
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
template <int D, typename S, int K, typename T>
HD void phase_iface(const Args<S, T>& A, Block<S, K, T>& B, int tid) {
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
    // x-interface k = I0-1+r (y: j = J0-1+c) is in the window up to
    // nxg-K-1
    bool in_cfl = D == 0 ? B.I0 - 1 + r <= A.NX - K - 1
                         : B.J0 - 1 + c <= A.NY - K - 1;
    if (in_cfl) smax = mx(smax, speed_max<NW>(s, dtdx));
  }

  // ghost band across the sweep (x: columns 0..K-1 and nyg-K..nyg-1), for
  // the CFL only: K lines at each end of the grid, FR or FC interfaces each
  constexpr int NL = D == 0 ? FR : FC;
  const bool lo = D == 0 ? B.bx == 0 : B.by == 0;
  const bool hi = D == 0 ? B.bx == B.nbx - 1 : B.by == B.nby - 1;
  for (int idx = tid; idx < 2 * K * NL; idx += NT) {
    int side = idx / (K * NL), line = (idx / NL) % K, k = idx % NL;
    if (!(side == 0 ? lo : hi)) continue;
    // staged line across the sweep: 0..K-1 below the tile, T+K.. above
    int across = side == 0 ? line : (D == 0 ? TY : TX) + K + line;
    // cells k and k+1 along the sweep, staged index k+K-1 and k+K
    int row_l = D == 0 ? k + K - 1 : across, col_l = D == 0 ? across : k + K - 1;
    int row_r = D == 0 ? k + K : across, col_r = D == 0 ? across : k + K;
    bool in_cfl = D == 0 ? B.I0 - 1 + k <= A.NX - K - 1
                         : B.J0 - 1 + k <= A.NY - K - 1;
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
template <int D, typename S, int K, typename T>
HD void phase_update(const Args<S, T>& A, Block<S, K, T>& B, int tid) {
  constexpr int N = S::NEQ;
  constexpr int FC = D == 0 ? FXC : FYC, EC = D == 0 ? EXC : EYC;
  const T ndt = A.C[D == 0 ? C_NDTDX : C_NDTDY];
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
      ql[e] = B.E[D][e * EN + ec];
      qr[e] = B.E[D][(N + e) * EN + ec];
    }
    S::template flux<D>(A.P, ql, fl);
    S::template flux<D>(A.P, qr, fr);
    if (D == 1 && (I >= A.NX - K || J >= A.NY - K)) continue;
    for (int e = 0; e < N; ++e) {
      T part = ndt * (B.F[D][(N + e) * FN + f_lo] + B.F[D][e * FN + f_hi]
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

void grid_of(int k, int nxg, int nyg, int& nbx, int& nby) {
  nbx = (nyg - 2 * k + TY - 1) / TY;
  nby = (nxg - 2 * k + TX - 1) / TX;
}

#if defined(__CUDACC__)
template <typename S, int K, typename T>
__global__ void __launch_bounds__(NT, 2) dq2_weno_kernel(Args<S, T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T coef[NCOEF];
  A.C = coef;
  Block<S, K, T> B;
  B.bind(reinterpret_cast<T*>(smem_raw), blockIdx.x, blockIdx.y, gridDim.x,
         gridDim.y);
  const int tid = threadIdx.x;
  phase_load<S, K, T>(A, B, tid);
  __syncthreads();
  phase_edges<0, S, K, T>(A, B, tid);
  phase_edges<1, S, K, T>(A, B, tid);
  __syncthreads();
  phase_iface<0, S, K, T>(A, B, tid);
  phase_iface<1, S, K, T>(A, B, tid);
  __syncthreads();
  // a thread owns the same cells in both: no barrier between
  phase_update<0, S, K, T>(A, B, tid);
  phase_update<1, S, K, T>(A, B, tid);
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
  grid_of(K, nxg, nyg, nbx, nby);
  Args<S, T> A = make_args<S, T>(qbc, dq, cflb, nxg, nyg, dt, dx, dy, p0, p1);
  dq2_weno_kernel<S, K, T><<<dim3(nbx, nby), NT, Layout<S, K, T>::bytes,
                             static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

template <typename S, int K, typename T> int blocks_per_sm() {
  int per = 0;
  if (set_smem<S, K, T>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, dq2_weno_kernel<S, K, T>, NT, Layout<S, K, T>::bytes) !=
          cudaSuccess)
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
  int nbx, nby;
  grid_of(K, nxg, nyg, nbx, nby);
  Args<S, T> A = make_args<S, T>(qbc, dq, cflb, nxg, nyg, dt, dx, dy, p0, p1);
  std::vector<T> smem(Layout<S, K, T>::elems);
  T coef[NCOEF];
  A.C = coef;
  for (int by = 0; by < nby; ++by) {
    for (int bx = 0; bx < nbx; ++bx) {
      Block<S, K, T> B;
      B.bind(smem.data(), bx, by, nbx, nby);
      for (int t = 0; t < NT; ++t) phase_load<S, K, T>(A, B, t);
      for (int t = 0; t < NT; ++t) {
        phase_edges<0, S, K, T>(A, B, t);
        phase_edges<1, S, K, T>(A, B, t);
      }
      for (int t = 0; t < NT; ++t) {
        phase_iface<0, S, K, T>(A, B, t);
        phase_iface<1, S, K, T>(A, B, t);
      }
      for (int t = 0; t < NT; ++t) {
        phase_update<0, S, K, T>(A, B, t);
        phase_update<1, S, K, T>(A, B, t);
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
// with K = (order + 1) / 2 ghost cells (any system).
int dq2_weno_blocks(int nxg, int nyg, int order) {
  int nbx, nby;
  grid_of((order + 1) / 2, nxg, nyg, nbx, nby);
  return nbx * nby;
}

// Shared memory bytes per block of the instance of system id sys (0 Euler
// 4-wave, 1 acoustics, 2 Euler 5-wave) and order, or -1.
int dq2_weno_smem_bytes(int sys, int order, int is_double) {
  return is_double ? dispatch<SmemF64>(sys, order)
                   : dispatch<SmemF32>(sys, order);
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
