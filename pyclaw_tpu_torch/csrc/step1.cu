// step1.cu — the 1D classic sweep (step1.f90) of a system of
// csrc/systems1d.cuh, one launch per step, for Hopper (sm_90a): Riemann
// solve, limiter (the CFL-dependent ids included), wave- or f-wave-form
// correction flux, per-cell dt/(dx kappa) with a capacity function, update
// and CFL.
//
// Replaces the TPU kernel pyclaw_tpu/ops/sweep.py:step1_pallas (pallas_call
// at :132, body :45-123), which runs every classic 1D step of the JAX
// package under backend="pallas".  Its plain PyTorch version is
// pyclaw_tpu_torch/classic/kernels.py:step1, which it is held against on
// the card (chip_smoke.py) and, through the host emulation at the end of
// this file, on the CPU (tests/test_torch_step1.py).
//
// What bounds it on the card: per cell it reads num_eqn values of q (and
// one of the capacity function, and the aux rows the system reads) and
// writes num_eqn (24 B per cell for
// Euler in f32, 48 B in f64), and does 279 floating-point operations per
// cell for Euler with the entropy fix and MC (chip_smoke.py:
// FLOPS_PER_CELL_STEP1), among them divides and square roots: 12 (f32)
// and 6 (f64) operations per byte, below the card's 20 and 10, so bytes
// bound it; the augmented shallow-water solver (sw_aug_1D, with the
// bathymetry row: 20 B per cell in f32) does about 175 operations a cell
// with minmod and f-waves (chip_smoke.py: FLOPS_PER_CELL_SW_AUG), bytes-
// bound too; so are the library systems (ids 6-15, 31-355 operations
// and 8-56 B a cell in f32, chip_smoke.py: flops_per_cell_library);
// chip_smoke.py computes every bound.  At the examples' sizes
// (100-800 cells) a launch does nanoseconds of work, so launch latency and
// the host loop's CFL readback set the step.
//
// Design: a block of NT threads owns a tile of TILE = NT - 4 interior
// cells, so that its staged cells (the tile and a 2-cell halo on each
// side) are one a thread, and each phase's region (NT - 1 interfaces for
// the Riemann solves, TILE + 1 for the limiter, TILE cells for the update)
// takes one pass of the block.  Thread t owns staged cell t and the
// interface to its right, so what a thread computes for its interface and
// reads again in a later phase (the speeds, amdq, the correction flux)
// stays in its registers; shared memory holds what a neighbour reads: q
// (with the aux rows the system reads, staged beside it) and the
// system's per-cell quantities (csrc/systems1d.cuh: cell(),
// computed once a cell in the load phase instead of at both of its
// interfaces), with a capacity function the per-cell dt/(dx kappa), and
// the waves, apdq and the correction flux of each interface (the last
// aliases the per-cell quantities, dead by then).  q is read with plain
// loads, not cp.async: the load phase computes each cell's quantities from
// the values in registers.  The CFL partials fold by warp shuffles; three
// barriers a block.  Any n >= 1 and num_ghost >=
// 2 work: loads are clamped to the padded array, and results past the
// last interior cell are masked.  Every variant's shared memory is below
// the 48 KB a launch takes without an attribute but MHD's in float64
// (seven equations: 75.7 KB), which set the opt-in attribute (Mhd1D's
// SMEM_OPT_IN; 2 blocks an SM).
//
// Phases (separated by barriers; staged cell j is padded cell c0-2+j,
// interface m lies between staged cells m and m+1):
//   load    q (+ the system's aux rows, + dt/(dx kappa)) of staged cell t
//           into shared memory, and its per-cell quantities
//   rp      waves, speeds, amdq, apdq at interface t (0 .. NT-2); the
//           waves and apdq to shared memory
//   limit   at interfaces 1 .. TILE+1: theta from the upwind neighbour's
//           wave (dot product over all num_eqn components), phi
//           (csrc/tvd.cuh), correction flux; CFL partial max over the
//           window g-1 .. n-g-1 (classic/kernels.py:step1), folded per warp
//   update  staged cells 2 .. TILE+1: q - dtdx (apdq_{i-1/2} +
//           amdq_{i+1/2}), then - dtdx (cq_{i+1/2} - cq_{i-1/2}) for order
//           2; thread 0 writes the block's CFL value
//
// Template parameters: the system, the type, CAPA (per-cell dtdx) and FWAVE
// (the correction form 0.5 sign(s) (1 - |s| dt/dx), with sign(0) = 0).  The
// arithmetic repeats the plain version operation for operation, and the
// source is built without fused multiply-adds (ops/_build.py:
// -fmad=false): the entropy fix, the limiter's upwind choice and the f-wave
// sign branch on signs, so a contracted multiply-add that moved a speed
// across zero would move the result by a whole wave.

#include "async_copy.cuh"
#include "dt_coef.cuh"
#include "systems1d.cuh"
#include "tvd.cuh"

namespace {

constexpr int NT = 256;        // threads per block = staged cells per tile
constexpr int TILE = NT - 4;   // interior cells per tile
constexpr int NWARP = NT / 32;
constexpr int NCOEF = 1;  // coefficients of dt a block keeps: dt/dx

// whether system S stages more than the 48 KB a launch takes without the
// opt-in attribute (S::SMEM_OPT_IN; false where S does not say)
template <typename S, typename = void> struct OptIn {
  static constexpr bool value = false;
};
template <typename S>
struct OptIn<S, decltype(void(S::SMEM_OPT_IN))> {
  static constexpr bool value = S::SMEM_OPT_IN;
};

template <typename S, typename T, bool CAPA> struct Tile {
  static constexpr int NEQ = S::NEQ, NW = S::NW, NC = S::NC;
  static constexpr int NAUX = S::NAUX;       // aux rows the system reads
  static constexpr int QN = NT;              // staged cells c0-2 .. c0+TILE+1
  static constexpr int WN = NT - 1;          // interfaces between them
  // per-cell quantities, then the correction flux in the same space
  static constexpr int UN = NC * QN > NEQ * WN ? NC * QN : NEQ * WN;
  static constexpr size_t elems = NEQ * QN + NAUX * QN + (CAPA ? QN : 0)
      + UN + NW * NEQ * WN + NEQ * WN + NWARP;  // + waves, apdq; CFL
  static constexpr size_t bytes = elems * sizeof(T);
  // over 48 KB (with the coefficients of dt, in static shared memory) a
  // launch needs the opt-in attribute; only a system that says so may
  // take it, and no block takes more than an SM's 227 KB
  static constexpr bool opt_in = bytes + NCOEF * sizeof(T) > 48 * 1024;
  static_assert(!opt_in || OptIn<S>::value,
                "a launch takes 48 KB without an attribute");
  static_assert(bytes + NCOEF * sizeof(T) <= 227 * 1024,
                "a block takes at most 227 KB of shared memory");
};

template <typename T> struct Args {
  const T* qbc;
  const T* aux;
  T* qout;
  T* cflb;
  int N, g;        // padded length, ghost cells
  int capa;        // aux row of the capacity function (CAPA only)
  const double* dt;  // the step (dt_coef.cuh)
  T dx;            // for the per-cell dt/(dx kappa)
  double ddx;      // for dt/dx
  T* C;            // the block's dt/dx without a capacity function, the
                   // plain version's Python float rounded once (shared
                   // memory)
  P1d<T> P;
  int order;
  int lim[3];
};

template <typename S, typename T, bool CAPA> struct Block {
  using L = Tile<S, T, CAPA>;
  T* q;    // [NEQ][QN]
  T* a;    // [NAUX][QN] the aux rows the system reads
  T* DX;   // [QN] dt/(dx kappa) (CAPA)
  T* C;    // [NC][QN] per-cell quantities (load, rp)
  T* CQ;   // [NEQ][WN] correction flux (limit, update), aliasing C
  T* W;    // [NW*NEQ][WN]: wave p component e at (p*NEQ+e)
  T* AP;   // [NEQ][WN] apdq
  T* R;    // [NWARP] CFL partial max of each warp
  int c0;  // padded index of the tile's first interior cell

  HD void bind(T* s, int b, int g) {
    q = s;
    a = q + L::NEQ * L::QN;
    DX = a + L::NAUX * L::QN;
    C = DX + (CAPA ? L::QN : 0);
    CQ = C;
    W = C + L::UN;
    AP = W + L::NW * L::NEQ * L::WN;
    R = AP + L::NEQ * L::WN;
    c0 = g + b * TILE;
  }
  HD T dtd(const Args<T>& A, int j) const { return CAPA ? DX[j] : A.C[0]; }
};

// what a thread computes for its interface and reads again in a later
// phase: in registers on the card, one per "thread" in the host emulation
template <typename S, typename T> struct Regs {
  T s[S::NW];      // speeds (rp -> limit)
  T am[S::NEQ];    // amdq (rp -> update)
  T cq[S::NEQ];    // correction flux (limit -> update)
};

// ---- phase: stage q (its aux rows, dt/(dx kappa)) of cell t, its
// quantities ----------------------------------------------------------------
template <typename S, typename T, bool CAPA>
HD void phase_load(const Args<T>& A, Block<S, T, CAPA>& B, int t) {
  using L = Tile<S, T, CAPA>;
  constexpr int NEQ = L::NEQ, NC = L::NC, QN = L::QN;
  // dt/dx first: its division overlaps the loads of q
  if (t < NCOEF) A.C[t] = T(*A.dt / A.ddx);
  int I = B.c0 - 2 + t;
  I = I < A.N ? I : A.N - 1;
  T q[NEQ];
  for (int e = 0; e < NEQ; ++e) {
    q[e] = A.qbc[(long long)e * A.N + I];
    B.q[e * QN + t] = q[e];
  }
  for (int m = 0; m < L::NAUX; ++m)
    B.a[m * QN + t] = A.aux[(long long)m * A.N + I];
  if (CAPA) {
    B.DX[t] = T(*A.dt) / (A.dx * A.aux[(long long)A.capa * A.N + I]);
  }
  if constexpr (NC > 0) {
    T c[NC];
    if constexpr (L::NAUX > 0) {
      // the cell's aux rows, as this thread staged them
      T a[L::NAUX];
      for (int m = 0; m < L::NAUX; ++m) a[m] = B.a[m * QN + t];
      S::cell(A.P, q, a, c);
    } else {
      S::cell(A.P, q, c);
    }
    for (int k = 0; k < NC; ++k) B.C[k * QN + t] = c[k];
  }
}

// ---- phase: the Riemann solve at interface t -------------------------------
template <typename S, typename T, bool CAPA>
HD void phase_rp(const Args<T>& A, Block<S, T, CAPA>& B, Regs<S, T>& r,
                 int t) {
  using L = Tile<S, T, CAPA>;
  constexpr int NEQ = L::NEQ, NW = L::NW, NC = L::NC, QN = L::QN;
  constexpr int WN = L::WN;
  if (t >= WN) return;
  T ql[NEQ], qr[NEQ], cl[NC > 0 ? NC : 1], cr[NC > 0 ? NC : 1];
  for (int e = 0; e < NEQ; ++e) {
    ql[e] = B.q[e * QN + t];
    qr[e] = B.q[e * QN + t + 1];
  }
  for (int k = 0; k < NC; ++k) {
    cl[k] = B.C[k * QN + t];
    cr[k] = B.C[k * QN + t + 1];
  }
  T w[NW][NEQ], ap[NEQ];
  if constexpr (L::NAUX > 0) {
    T al[L::NAUX], ar[L::NAUX];
    for (int m = 0; m < L::NAUX; ++m) {
      al[m] = B.a[m * QN + t];
      ar[m] = B.a[m * QN + t + 1];
    }
    S::template rp<T>(A.P, ql, qr, al, ar, cl, cr, w, r.s, r.am, ap);
  } else {
    S::template rp<T>(A.P, ql, qr, cl, cr, w, r.s, r.am, ap);
  }
  for (int p = 0; p < NW; ++p)
    for (int e = 0; e < NEQ; ++e) B.W[(p * NEQ + e) * WN + t] = w[p][e];
  for (int e = 0; e < NEQ; ++e) B.AP[e * WN + t] = ap[e];
}

// fold thread t's CFL partial into its warp's slot: a shuffle max on the
// card, a loop over the lanes on the host
template <typename T> HD void warp_fold(T* red, int t, T v) {
#if defined(__CUDACC__)
  const T m = warp_max(v);
  if (t % 32 == 0) red[t / 32] = m;
#else
  red[t / 32] = t % 32 == 0 ? v : mx(red[t / 32], v);
#endif
}

// ---- phase: limiter, correction flux, CFL at interface t -------------------
template <bool FWAVE, typename S, typename T, bool CAPA>
HD void phase_limit(const Args<T>& A, Block<S, T, CAPA>& B, Regs<S, T>& r,
                    int t) {
  using L = Tile<S, T, CAPA>;
  constexpr int NEQ = L::NEQ, NW = L::NW, WN = L::WN;
  T cmax = T(0);
  const int m = t;
  if (m >= 1 && m <= TILE + 1) {
    // interface m lies between staged cells m (left) and m+1 (right)
    const T dl = B.dtd(A, m), dr = B.dtd(A, m + 1);
    const T dtdx = CAPA ? T(0.5) * (dl + dr) : dl;
    const T* s = r.s;
    T w[NW][NEQ];
    for (int p = 0; p < NW; ++p)
      for (int e = 0; e < NEQ; ++e) w[p][e] = B.W[(p * NEQ + e) * WN + m];
    T* cq = r.cq;
    for (int e = 0; e < NEQ; ++e) cq[e] = T(0);
    if (A.order == 2) {
      T cf[NW];
      for (int p = 0; p < NW; ++p) {
        const T* lo = B.W + (p * NEQ) * WN + m - 1;
        const T* hi = B.W + (p * NEQ) * WN + m + 1;
        T wn2 = w[p][0] * w[p][0];
        T dlo = lo[0] * w[p][0];
        T dhi = w[p][0] * hi[0];
        for (int e = 1; e < NEQ; ++e) {
          wn2 = wn2 + w[p][e] * w[p][e];
          dlo = dlo + lo[e * WN] * w[p][e];
          dhi = dhi + w[p][e] * hi[e * WN];
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
        for (int p = 1; p < NW; ++p) acc = acc + cf[p] * w[p][e];
        cq[e] = acc;
      }
    }
    for (int e = 0; e < NEQ; ++e) B.CQ[e * WN + m] = cq[e];
    // CFL window: padded interfaces g-1 .. N-g-1
    if (B.c0 - 2 + m < A.N - A.g) {
      for (int p = 0; p < NW; ++p) {
        if (CAPA) cmax = mx(cmax, mx(s[p] * dr, -s[p] * dl));
        else cmax = mx(cmax, fabs_(s[p]));
      }
    }
  }
  warp_fold(B.R, t, cmax);
}

// ---- phase: conservative update of staged cell t ---------------------------
template <typename S, typename T, bool CAPA>
HD void phase_update(const Args<T>& A, Block<S, T, CAPA>& B,
                     const Regs<S, T>& r, int t) {
  using L = Tile<S, T, CAPA>;
  constexpr int NEQ = L::NEQ, QN = L::QN, WN = L::WN;
  const int i = B.c0 - 2 + t;   // padded cell
  if (t < 2 || t > TILE + 1 || i >= A.N - A.g) return;
  const int mx_cells = A.N - 2 * A.g;
  const T dtc = B.dtd(A, t);
  for (int e = 0; e < NEQ; ++e) {
    const T ap = B.AP[e * WN + t - 1];   // interface i-1/2
    const T am = r.am[e];                // interface i+1/2
    T qn = B.q[e * QN + t] - dtc * (ap + am);
    if (A.order == 2) qn = qn - dtc * (r.cq[e] - B.CQ[e * WN + t - 1]);
    A.qout[(long long)e * mx_cells + (i - A.g)] = qn;
  }
}

// one CFL value per block: max(s dt/dx) over its window; without a
// capacity function the partials hold max|s| and the scalar dt/dx is
// applied here (the same value: the product is monotone)
template <typename S, typename T, bool CAPA>
HD T block_cfl(const Args<T>& A, const Block<S, T, CAPA>& B) {
  T m = B.R[0];
  for (int w = 1; w < NWARP; ++w) m = mx(m, B.R[w]);
  return CAPA ? m : A.C[0] * m;
}

template <typename T>
Args<T> make_args(const void* qbc, const void* aux, void* qout, void* cflb,
                  int n, int g, int capa, const double* dt, double dx,
                  double p0,
                  double p1, int order, const int* lim) {
  Args<T> A;
  A.qbc = static_cast<const T*>(qbc);
  A.aux = static_cast<const T*>(aux);
  A.qout = static_cast<T*>(qout);
  A.cflb = static_cast<T*>(cflb);
  A.N = n;
  A.g = g;
  A.capa = capa;
  A.dt = dt;
  A.dx = T(dx);
  A.ddx = dx;
  A.C = nullptr;
  A.P.set(p0, p1);
  A.order = order;
  for (int p = 0; p < 3; ++p) A.lim[p] = lim[p];
  return A;
}

int blocks_of(int n, int g) { return (n - 2 * g + TILE - 1) / TILE; }

#if defined(__CUDACC__)
template <typename S, typename T, bool CAPA, bool FWAVE>
__global__ void __launch_bounds__(NT) step1_kernel(Args<T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T coef[NCOEF];
  A.C = coef;
  Block<S, T, CAPA> B;
  B.bind(reinterpret_cast<T*>(smem_raw), blockIdx.x, A.g);
  Regs<S, T> r;
  const int t = threadIdx.x;
  phase_load<S, T, CAPA>(A, B, t);
  __syncthreads();
  phase_rp<S, T, CAPA>(A, B, r, t);
  __syncthreads();
  phase_limit<FWAVE, S, T, CAPA>(A, B, r, t);
  __syncthreads();
  phase_update<S, T, CAPA>(A, B, r, t);
  if (t == 0) A.cflb[blockIdx.x] = block_cfl(A, B);
}

// an instance over 48 KB of shared memory: the opt-in attribute, set
// before every launch (it is not a stream operation, so a launch captured
// into a CUDA graph sets it too); a no-op for the others
template <typename S, typename T, bool CAPA, bool FWAVE> int opt_in() {
  using L = Tile<S, T, CAPA>;
  if constexpr (L::opt_in) {
    return (int)cudaFuncSetAttribute(
        step1_kernel<S, T, CAPA, FWAVE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  }
  return 0;
}

template <typename S, typename T, bool CAPA, bool FWAVE>
int launch(const Args<T>& A, int nb, void* stream) {
  const int rc = opt_in<S, T, CAPA, FWAVE>();
  if (rc != 0) return rc;
  step1_kernel<S, T, CAPA, FWAVE>
      <<<nb, NT, Tile<S, T, CAPA>::bytes,
         static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

// resident blocks per SM of the wave-form variant of system S
template <typename S, typename T> int blocks_per_sm() {
  if (opt_in<S, T, false, false>() != 0) return -1;
  int nb = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, step1_kernel<S, T, false, false>, NT, Tile<S, T, false>::bytes);
  return nb;
}
#else
// Host emulation: the same phases, one block and one "thread" at a time,
// with each barrier between two phases kept by running the whole block
// through a phase before the next, and each thread's registers kept in an
// array.  Used by the CPU tests to check the kernel's index algebra against
// the plain version without a card.
template <typename S, typename T, bool CAPA, bool FWAVE>
int launch(Args<T> A, int nb, void*) {
  std::vector<T> smem(Tile<S, T, CAPA>::elems);
  T coef[NCOEF];
  A.C = coef;
  std::vector<Regs<S, T>> regs(NT);
  for (int b = 0; b < nb; ++b) {
    Block<S, T, CAPA> B;
    B.bind(smem.data(), b, A.g);
    for (int t = 0; t < NT; ++t) phase_load<S, T, CAPA>(A, B, t);
    for (int t = 0; t < NT; ++t) phase_rp<S, T, CAPA>(A, B, regs[t], t);
    for (int t = 0; t < NT; ++t)
      phase_limit<FWAVE, S, T, CAPA>(A, B, regs[t], t);
    for (int t = 0; t < NT; ++t) phase_update<S, T, CAPA>(A, B, regs[t], t);
    A.cflb[b] = block_cfl(A, B);
  }
  return 0;
}
#endif

// system ids of the C interface (ops/sweep.py:SYSTEMS_1D)
enum { SYS_ADVECTION = 0, SYS_ACOUSTICS = 1, SYS_EULER_EFIX = 2,
       SYS_EULER_ROE = 3, SYS_EULER_HLLE = 4, SYS_SW_AUG = 5,
       SYS_SHALLOW_ROE = 6, SYS_SHALLOW_HLLE = 7, SYS_SHALLOW_BATHY = 8,
       SYS_PSYSTEM = 9, SYS_VC_ADVECTION = 10, SYS_VC_ADVECTION_FWAVE = 11,
       SYS_ACOUSTICS_VAR = 12, SYS_BURGERS = 13, SYS_TRAFFIC = 14,
       SYS_MHD = 15, NUM_SYSTEMS = 16 };

// calls F::template run<S>() with the struct S of a system id; -1 for an
// unknown id
template <typename F> int with_system(int system, F&& f) {
  switch (system) {
    case SYS_ADVECTION: return f.template run<Advection1D>();
    case SYS_ACOUSTICS: return f.template run<Acoustics1D>();
    case SYS_EULER_EFIX: return f.template run<EulerRoe1D<true>>();
    case SYS_EULER_ROE: return f.template run<EulerRoe1D<false>>();
    case SYS_EULER_HLLE: return f.template run<EulerHlle1D>();
    case SYS_SW_AUG: return f.template run<SwAug1D>();
    case SYS_SHALLOW_ROE: return f.template run<ShallowRoe1D<true>>();
    case SYS_SHALLOW_HLLE: return f.template run<ShallowHlle1D>();
    case SYS_SHALLOW_BATHY: return f.template run<ShallowBathyFwave1D>();
    case SYS_PSYSTEM: return f.template run<Psystem1D>();
    case SYS_VC_ADVECTION: return f.template run<VcAdvection1D>();
    case SYS_VC_ADVECTION_FWAVE: return f.template run<VcAdvectionFwave1D>();
    case SYS_ACOUSTICS_VAR: return f.template run<AcousticsVar1D>();
    case SYS_BURGERS: return f.template run<Burgers1D>();
    case SYS_TRAFFIC: return f.template run<Traffic1D>();
    case SYS_MHD: return f.template run<Mhd1D>();
    default: return -1;
  }
}

template <typename T, typename S>
int dispatch_flags(const Args<T>& A, bool capa, bool fwave, int nb,
                   void* stream) {
  if (capa) {
    return fwave ? launch<S, T, true, true>(A, nb, stream)
                 : launch<S, T, true, false>(A, nb, stream);
  }
  return fwave ? launch<S, T, false, true>(A, nb, stream)
               : launch<S, T, false, false>(A, nb, stream);
}

template <typename T> struct Launch {
  const Args<T>& A;
  bool c, f;
  int nb;
  void* stream;
  template <typename S> int run() {
    return dispatch_flags<T, S>(A, c, f, nb, stream);
  }
};

template <typename T>
int step(const void* qbc, const void* aux, void* qout, void* cflb, int n,
         int g, int system, int capa, int fwave, const double* dt,
         double dx, double p0, double p1, int order, const int* lim,
         void* stream) {
  const Args<T> A = make_args<T>(qbc, aux, qout, cflb, n, g, capa, dt, dx,
                                 p0, p1, order, lim);
  return with_system(system, Launch<T>{A, capa >= 0, fwave != 0,
                                       blocks_of(n, g), stream});
}

#if defined(__CUDACC__)
struct BlocksPerSm {
  bool is_double;
  template <typename S> int run() {
    return is_double ? blocks_per_sm<S, double>() : blocks_per_sm<S, float>();
  }
};
#endif

struct SmemOf {
  bool capa, is_double;
  template <typename S> int run() {
    if (is_double) {
      return (int)(capa ? Tile<S, double, true>::bytes
                        : Tile<S, double, false>::bytes);
    }
    return (int)(capa ? Tile<S, float, true>::bytes
                      : Tile<S, float, false>::bytes);
  }
};

}  // namespace

// ---- plain C interface (loaded with ctypes) ------------------------------
extern "C" {

// Number of blocks (= CFL partials) the kernel writes for a padded length.
int step1_blocks(int n, int g) { return blocks_of(n, g); }

// Number of systems the build takes (system ids 0 .. step1_num_systems()-1).
int step1_num_systems() { return NUM_SYSTEMS; }

// Shared memory bytes per block (reported by chip_smoke.py); -1 for an
// unknown system.
int step1_smem_bytes(int system, int capa, int is_double) {
  return with_system(system, SmemOf{capa != 0, is_double != 0});
}

#if defined(__CUDACC__)
// Resident blocks per SM of a system's wave-form variant without a
// capacity function (an instance over 48 KB with its opt-in attribute);
// -1 for an unknown system.
int step1_system_blocks_per_sm(int system, int is_double) {
  return with_system(system, BlocksPerSm{is_double != 0});
}
#endif

// One 1D sweep.  qbc: (num_eqn, n) ghost-padded (g >= 2 ghost cells); aux:
// (num_aux, n) or null when the system reads none and capa < 0; qout:
// (num_eqn, n-2g); cflb:
// step1_blocks(n, g) partial CFL maxima; all contiguous, of the type named
// by the entry.  system: SYS_*; capa: aux row of the capacity function or
// -1; fwave: the f-wave correction form; dt: the step in device memory
// (host memory for the host emulation), a double that is exact in the
// entry's type; p0, p1: the physics scalars (u | zz, cc | gamma | grav,
// dry_tolerance); l0..l2: the limiter ids of the waves.  Returns a
// cudaError_t (0 on success), or -1 for an unknown system.
#if defined(__CUDACC__)
#define STEP1_ENTRY(NAME, T)                                                 \
  int NAME(const void* qbc, const void* aux, void* qout, void* cflb, int n,  \
           int g, int system, int capa, int fwave, const double* dt,         \
           double dx,                                                        \
           double p0, double p1, int order, int l0, int l1, int l2,          \
           void* stream) {                                                   \
    const int lim[3] = {l0, l1, l2};                                         \
    return step<T>(qbc, aux, qout, cflb, n, g, system, capa, fwave, dt, dx,  \
                   p0, p1, order, lim, stream);                              \
  }
STEP1_ENTRY(step1_f32, float)
STEP1_ENTRY(step1_f64, double)
#else
#define STEP1_ENTRY(NAME, T)                                                 \
  int NAME(const void* qbc, const void* aux, void* qout, void* cflb, int n,  \
           int g, int system, int capa, int fwave, const double* dt,         \
           double dx,                                                        \
           double p0, double p1, int order, int l0, int l1, int l2) {        \
    const int lim[3] = {l0, l1, l2};                                         \
    return step<T>(qbc, aux, qout, cflb, n, g, system, capa, fwave, dt, dx,  \
                   p0, p1, order, lim, nullptr);                             \
  }
STEP1_ENTRY(step1_host_f32, float)
STEP1_ENTRY(step1_host_f64, double)
#endif
#undef STEP1_ENTRY

}  // extern "C"
