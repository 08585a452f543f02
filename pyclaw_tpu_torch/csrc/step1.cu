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
// one of the capacity function) and writes num_eqn (24 B per cell for
// Euler in f32, 48 B in f64), and does 290 floating-point operations per
// cell for Euler with the entropy fix and MC (chip_smoke.py:
// FLOPS_PER_CELL_STEP1), among them divides and square roots: 12 (f32)
// and 6 (f64) operations per byte, below the card's 20 and 10, so bytes
// bound it; chip_smoke.py computes both bounds.  At the examples' sizes
// (100-800 cells) a launch does nanoseconds of work, so launch latency and
// the host loop's CFL readback set the step.
//
// Design (that of step2_aos.cu, in one dimension): a block owns a tile of
// NT interior cells and stages q, and with a capacity function the per-cell
// dt/(dx kappa), with a 2-cell halo in shared memory.  Interface quantities
// live in shared memory only.  Any n >= 1 and num_ghost >= 2 work: loads
// are clamped to the padded array, and results past the last interior cell
// are masked.
//
// Phases (each a loop of the block's threads over a region, separated by
// barriers):
//   load    q (+ dt/(dx kappa)) of cells c0-2 .. c0+NT+1 -> shared
//   rp      waves, speeds, amdq, apdq at interfaces c0-2 .. c0+NT -> shared
//   limit   at interfaces c0-1 .. c0+NT-1: theta from the upwind
//           neighbour's wave (dot product over all num_eqn components),
//           phi (csrc/tvd.cuh), correction flux -> shared; CFL partial max
//           over the window g-1 .. n-g-1 (classic/kernels.py:step1)
//   update  q - dtdx (apdq_{i-1/2} + amdq_{i+1/2}), then
//           - dtdx (cq_{i+1/2} - cq_{i-1/2}) for order 2
//   reduce  tree max of the CFL partials; one value per block
//
// Template parameters: the system, the type, CAPA (per-cell dtdx) and FWAVE
// (the correction form 0.5 sign(s) (1 - |s| dt/dx), with sign(0) = 0).  The
// arithmetic repeats the plain version operation for operation, and the
// source is built without fused multiply-adds (ops/_build.py:
// -fmad=false): the entropy fix, the limiter's upwind choice and the f-wave
// sign branch on signs, so a contracted multiply-add that moved a speed
// across zero would move the result by a whole wave.

#include "systems1d.cuh"
#include "tvd.cuh"

namespace {

constexpr int NT = 256;  // threads per block = interior cells per tile

template <typename S, typename T, bool CAPA> struct Tile {
  static constexpr int NEQ = S::NEQ, NW = S::NW;
  static constexpr int QN = NT + 4;          // cells c0-2 .. c0+NT+1
  static constexpr int WN = NT + 3;          // interfaces c0-2 .. c0+NT
  static constexpr int NWF = NW * NEQ + NW;  // waves, speeds
  static constexpr size_t elems = NEQ * QN + (CAPA ? QN : 0) + NWF * WN
      + 3 * NEQ * WN + NT;                   // + amdq, apdq, cq; CFL
  static constexpr size_t bytes = elems * sizeof(T);
};

template <typename T> struct Args {
  const T* qbc;
  const T* aux;
  T* qout;
  T* cflb;
  int N, g;        // padded length, ghost cells
  int capa;        // aux row of the capacity function (CAPA only)
  T dt, dx;        // for the per-cell dt/(dx kappa)
  T dtdx;          // dt/dx without a capacity function
  P1d<T> P;
  int order;
  int lim[3];
};

template <typename S, typename T, bool CAPA> struct Block {
  using L = Tile<S, T, CAPA>;
  T* q;    // [NEQ][QN]
  T* DX;   // [QN] dt/(dx kappa) (CAPA)
  T* W;    // [NWF][WN]: wave p component e at (p*NEQ+e), speeds after
  T* F;    // [3*NEQ][WN]: amdq, apdq, cq
  T* R;    // [NT] CFL partial max
  int c0;  // padded index of the tile's first interior cell

  HD void bind(T* s, int b, int g) {
    q = s;
    DX = q + L::NEQ * L::QN;
    W = DX + (CAPA ? L::QN : 0);
    F = W + L::NWF * L::WN;
    R = F + 3 * L::NEQ * L::WN;
    c0 = g + b * NT;
  }
  HD T dtd(const Args<T>& A, int j) const { return CAPA ? DX[j] : A.dtdx; }
};

// ---- phase: stage q (and dt/(dx kappa)) of the tile + halo ----------------
template <typename S, typename T, bool CAPA>
HD void phase_load(const Args<T>& A, Block<S, T, CAPA>& B, int tid) {
  using L = Tile<S, T, CAPA>;
  constexpr int NF = L::NEQ + (CAPA ? 1 : 0);
  for (int idx = tid; idx < NF * L::QN; idx += NT) {
    const int f = idx / L::QN, j = idx % L::QN;
    int I = B.c0 - 2 + j;
    I = I < A.N ? I : A.N - 1;
    if (f < L::NEQ) {
      B.q[idx] = A.qbc[(long long)f * A.N + I];
    } else {
      B.DX[j] = A.dt / (A.dx * A.aux[(long long)A.capa * A.N + I]);
    }
  }
  B.R[tid] = T(0);
}

// ---- phase: Riemann solves at the tile's interfaces -----------------------
template <typename S, typename T, bool CAPA>
HD void phase_rp(const Args<T>& A, Block<S, T, CAPA>& B, int tid) {
  using L = Tile<S, T, CAPA>;
  constexpr int NEQ = L::NEQ, NW = L::NW, QN = L::QN, WN = L::WN;
  for (int m = tid; m < WN; m += NT) {
    T ql[NEQ], qr[NEQ], w[NW][NEQ], s[NW], am[NEQ], ap[NEQ];
    for (int e = 0; e < NEQ; ++e) {
      ql[e] = B.q[e * QN + m];
      qr[e] = B.q[e * QN + m + 1];
    }
    S::template rp<T>(A.P, ql, qr, w, s, am, ap);
    for (int p = 0; p < NW; ++p) {
      for (int e = 0; e < NEQ; ++e) B.W[(p * NEQ + e) * WN + m] = w[p][e];
      B.W[(NW * NEQ + p) * WN + m] = s[p];
    }
    for (int e = 0; e < NEQ; ++e) {
      B.F[e * WN + m] = am[e];
      B.F[(NEQ + e) * WN + m] = ap[e];
    }
  }
}

// ---- phase: limiter, correction flux, CFL ---------------------------------
template <bool FWAVE, typename S, typename T, bool CAPA>
HD void phase_limit(const Args<T>& A, Block<S, T, CAPA>& B, int tid) {
  using L = Tile<S, T, CAPA>;
  constexpr int NEQ = L::NEQ, NW = L::NW, WN = L::WN;
  T cmax = B.R[tid];
  for (int m = 1 + tid; m <= NT + 1; m += NT) {
    // interface m lies between tile cells m (left) and m+1 (right)
    const T dl = B.dtd(A, m), dr = B.dtd(A, m + 1);
    const T dtdx = CAPA ? T(0.5) * (dl + dr) : dl;
    T w[NW][NEQ], s[NW];
    for (int p = 0; p < NW; ++p) {
      for (int e = 0; e < NEQ; ++e) w[p][e] = B.W[(p * NEQ + e) * WN + m];
      s[p] = B.W[(NW * NEQ + p) * WN + m];
    }
    T cq[NEQ];
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
    for (int e = 0; e < NEQ; ++e) B.F[(2 * NEQ + e) * WN + m] = cq[e];
    // CFL window: padded interfaces g-1 .. N-g-1
    if (B.c0 - 2 + m < A.N - A.g) {
      for (int p = 0; p < NW; ++p) {
        if (CAPA) cmax = mx(cmax, mx(s[p] * dr, -s[p] * dl));
        else cmax = mx(cmax, fabs_(s[p]));
      }
    }
  }
  B.R[tid] = cmax;
}

// ---- phase: conservative update ---------------------------------------------
template <typename S, typename T, bool CAPA>
HD void phase_update(const Args<T>& A, Block<S, T, CAPA>& B, int tid) {
  using L = Tile<S, T, CAPA>;
  constexpr int NEQ = L::NEQ, QN = L::QN, WN = L::WN;
  const int i = B.c0 + tid;   // padded cell; tile cell tid+2
  if (i >= A.N - A.g) return;
  const int mx_cells = A.N - 2 * A.g;
  const T dtc = B.dtd(A, tid + 2);
  for (int e = 0; e < NEQ; ++e) {
    const T ap = B.F[(NEQ + e) * WN + tid + 1];   // interface i-1/2
    const T am = B.F[e * WN + tid + 2];           // interface i+1/2
    T qn = B.q[e * QN + tid + 2] - dtc * (ap + am);
    if (A.order == 2) {
      const T* cq = B.F + (2 * NEQ + e) * WN;
      qn = qn - dtc * (cq[tid + 2] - cq[tid + 1]);
    }
    A.qout[(long long)e * mx_cells + (i - A.g)] = qn;
  }
}

template <typename S, typename T, bool CAPA>
HD void phase_reduce(Block<S, T, CAPA>& B, int tid, int stride) {
  if (tid < stride) B.R[tid] = mx(B.R[tid], B.R[tid + stride]);
}

// one CFL value per block: max(s dt/dx) over its window; without a
// capacity function the partials hold max|s| and the scalar dt/dx is
// applied here (the same value: the product is monotone)
template <typename S, typename T, bool CAPA>
HD void phase_write_cfl(const Args<T>& A, Block<S, T, CAPA>& B, int b,
                        int tid) {
  if (tid != 0) return;
  A.cflb[b] = CAPA ? B.R[0] : A.dtdx * B.R[0];
}

template <typename T>
Args<T> make_args(const void* qbc, const void* aux, void* qout, void* cflb,
                  int n, int g, int capa, double dt, double dx, double p0,
                  double p1, int order, const int* lim) {
  Args<T> A;
  A.qbc = static_cast<const T*>(qbc);
  A.aux = static_cast<const T*>(aux);
  A.qout = static_cast<T*>(qout);
  A.cflb = static_cast<T*>(cflb);
  A.N = n;
  A.g = g;
  A.capa = capa;
  A.dt = T(dt);
  A.dx = T(dx);
  A.dtdx = T(dt / dx);   // the plain version's Python float, rounded once
  A.P.set(p0, p1);
  A.order = order;
  for (int p = 0; p < 3; ++p) A.lim[p] = lim[p];
  return A;
}

int blocks_of(int n, int g) { return (n - 2 * g + NT - 1) / NT; }

#if defined(__CUDACC__)
template <typename S, typename T, bool CAPA, bool FWAVE>
__global__ void __launch_bounds__(NT) step1_kernel(Args<T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Block<S, T, CAPA> B;
  B.bind(reinterpret_cast<T*>(smem_raw), blockIdx.x, A.g);
  const int t = threadIdx.x;
  phase_load<S, T, CAPA>(A, B, t);
  __syncthreads();
  phase_rp<S, T, CAPA>(A, B, t);
  __syncthreads();
  phase_limit<FWAVE, S, T, CAPA>(A, B, t);
  __syncthreads();
  phase_update<S, T, CAPA>(A, B, t);
  for (int s = NT / 2; s > 0; s >>= 1) {
    phase_reduce<S, T, CAPA>(B, t, s);
    __syncthreads();
  }
  phase_write_cfl<S, T, CAPA>(A, B, blockIdx.x, t);
}

template <typename S, typename T, bool CAPA, bool FWAVE>
int launch(const Args<T>& A, int nb, void* stream) {
  constexpr size_t bytes = Tile<S, T, CAPA>::bytes;
  // The limit applies to the current device only: set it on every launch.
  cudaError_t err = cudaFuncSetAttribute(
      step1_kernel<S, T, CAPA, FWAVE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  step1_kernel<S, T, CAPA, FWAVE>
      <<<nb, NT, bytes, static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}
#else
// Host emulation: the same phases, one block and one "thread" at a time,
// with each barrier between two phases kept by running the whole block
// through a phase before the next.  Used by the CPU tests to check the
// kernel's index algebra against the plain version without a card.
template <typename S, typename T, bool CAPA, bool FWAVE>
int launch(const Args<T>& A, int nb, void*) {
  std::vector<T> smem(Tile<S, T, CAPA>::elems);
  for (int b = 0; b < nb; ++b) {
    Block<S, T, CAPA> B;
    B.bind(smem.data(), b, A.g);
    for (int t = 0; t < NT; ++t) phase_load<S, T, CAPA>(A, B, t);
    for (int t = 0; t < NT; ++t) phase_rp<S, T, CAPA>(A, B, t);
    for (int t = 0; t < NT; ++t) phase_limit<FWAVE, S, T, CAPA>(A, B, t);
    for (int t = 0; t < NT; ++t) phase_update<S, T, CAPA>(A, B, t);
    for (int s = NT / 2; s > 0; s >>= 1)
      for (int t = 0; t < NT; ++t) phase_reduce<S, T, CAPA>(B, t, s);
    for (int t = 0; t < NT; ++t) phase_write_cfl<S, T, CAPA>(A, B, b, t);
  }
  return 0;
}
#endif

// system ids of the C interface (ops/sweep.py:SYSTEMS_1D)
enum { SYS_ADVECTION = 0, SYS_ACOUSTICS = 1, SYS_EULER_EFIX = 2,
       SYS_EULER_ROE = 3, SYS_EULER_HLLE = 4 };

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

template <typename T>
int step(const void* qbc, const void* aux, void* qout, void* cflb, int n,
         int g, int system, int capa, int fwave, double dt, double dx,
         double p0, double p1, int order, const int* lim, void* stream) {
  const Args<T> A = make_args<T>(qbc, aux, qout, cflb, n, g, capa, dt, dx,
                                 p0, p1, order, lim);
  const int nb = blocks_of(n, g);
  const bool c = capa >= 0, f = fwave != 0;
  switch (system) {
    case SYS_ADVECTION:
      return dispatch_flags<T, Advection1D>(A, c, f, nb, stream);
    case SYS_ACOUSTICS:
      return dispatch_flags<T, Acoustics1D>(A, c, f, nb, stream);
    case SYS_EULER_EFIX:
      return dispatch_flags<T, EulerRoe1D<true>>(A, c, f, nb, stream);
    case SYS_EULER_ROE:
      return dispatch_flags<T, EulerRoe1D<false>>(A, c, f, nb, stream);
    case SYS_EULER_HLLE:
      return dispatch_flags<T, EulerHlle1D>(A, c, f, nb, stream);
    default:
      return -1;
  }
}

template <typename S> int smem_of(bool capa, bool is_double) {
  if (is_double) {
    return (int)(capa ? Tile<S, double, true>::bytes
                      : Tile<S, double, false>::bytes);
  }
  return (int)(capa ? Tile<S, float, true>::bytes
                    : Tile<S, float, false>::bytes);
}

}  // namespace

// ---- plain C interface (loaded with ctypes) ------------------------------
extern "C" {

// Number of blocks (= CFL partials) the kernel writes for a padded length.
int step1_blocks(int n, int g) { return blocks_of(n, g); }

// Shared memory bytes per block (reported by chip_smoke.py).
int step1_smem_bytes(int system, int capa, int is_double) {
  switch (system) {
    case SYS_ADVECTION: return smem_of<Advection1D>(capa, is_double);
    case SYS_ACOUSTICS: return smem_of<Acoustics1D>(capa, is_double);
    case SYS_EULER_HLLE: return smem_of<EulerHlle1D>(capa, is_double);
    default: return smem_of<EulerRoe1D<true>>(capa, is_double);
  }
}

// One 1D sweep.  qbc: (num_eqn, n) ghost-padded (g >= 2 ghost cells); aux:
// (num_aux, n) or null when capa < 0; qout: (num_eqn, n-2g); cflb:
// step1_blocks(n, g) partial CFL maxima; all contiguous, of the type named
// by the entry.  system: SYS_*; capa: aux row of the capacity function or
// -1; fwave: the f-wave correction form; p0, p1: the physics scalars (u |
// zz, cc | gamma); l0..l2: the limiter ids of the waves.  Returns a
// cudaError_t (0 on success), or -1 for an unknown system.
#if defined(__CUDACC__)
#define STEP1_ENTRY(NAME, T)                                                 \
  int NAME(const void* qbc, const void* aux, void* qout, void* cflb, int n,  \
           int g, int system, int capa, int fwave, double dt, double dx,     \
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
           int g, int system, int capa, int fwave, double dt, double dx,     \
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
