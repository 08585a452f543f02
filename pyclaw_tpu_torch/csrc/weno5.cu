// weno5.cu — Jiang-Shu WENO5 left and right edge values along the last axis
// of a contiguous (rows, n) array, one launch per call, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel pyclaw_tpu/ops/weno.py:weno5_pallas (pallas_call
// at :94, body _weno5_kernel :36-72), the reconstruction of every SharpClaw
// stage that does not run a fused dq kernel (sharpclaw/kernels.py:_recon).
// Its plain PyTorch version is pyclaw_tpu_torch/limiters/recon.py:weno5,
// which it is held against on the card (chip_smoke.py) and, through the
// host emulation at the end of this file, on the CPU
// (tests/test_torch_weno5.py).  At the two ends of each row the stencil
// wraps around as torch.roll does, so the kernel equals its plain version
// everywhere, the invalid band included.
//
// Weights: float64 takes the reference weights d_k / (EPWENO + beta_k)^2,
// as weno5_pallas does; float32 takes recon.py's normalised-beta branch,
// not weno5_pallas's single formula, whose (1e-36 + beta)^2 underflows to 0
// in float32 and gives NaN on constant data (csrc/weno5.cuh).
//
// What bounds it on the card: per entry it reads 1 value and writes 2
// (12 B in f32, 24 B in f64) and does ~80-90 floating-point operations,
// below the card's 20 (f32) and 10 (f64) operations per byte, so bytes
// bound it (chip_smoke.py computes both bounds from
// `FLOPS_PER_ENTRY_WENO5`).  What holds it back is the IEEE divisions: the
// candidate values' divisions by 6 and the weights' two (f32) or five
// (f64), each a chain that a warp waits out before its branch to the slow
// path.
//
// Design: a block of NT = 128 threads owns E * NT consecutive entries of
// one row (the row is blockIdx.y, the tile blockIdx.x, so no index is
// divided by a runtime value).  It stages them with a 2-entry halo on each
// side by cp.async (csrc/async_copy.cuh); only the first and last tile of
// a row wrap an index.  Each thread then slides a window along E
// consecutive entries (8 in f32, 4 in f64), read from shared memory by
// 16-byte loads: p1(i) and m0(i+1) are one expression on the same three
// values, and so are p2(i) and m1(i+1), and the curvature term 13/12 d^2
// of b2(i) is that of b1(i+1) and b0(i+2).  An entry then takes four
// divisions by 6 and one curvature term, with the same operations on the
// same values as csrc/weno5.cuh's single stencil, so the bits do not
// change.  The edge values go back through shared memory, each as soon as
// it is known (which keeps the registers to the window), so the writes to
// device memory are coalesced: a thread's own 8 writes, 32 bytes apart,
// took the kernel to 2.5 times its time.  The load and store loops are
// unrolled with their bounds and row pointers hoisted: the store loop of
// one entry at a time took 28 instructions an entry, against ~130 of
// arithmetic, and 7-9% of the time.  A stencil whose three betas are
// 0 (a constant stencil: most of a piecewise constant state such as the
// Sod tube's) takes the weights of zero betas, computed once a block: the
// values weno5_w would compute, without the weights' divisions.  The
// launch bounds keep the registers to 48 (f32) and 64 (f64), so that 40
// and 32 warps an SM hide the divisions' waits.  Arrays of fewer than
// LARGE_MIN entries (the examples' (3, 806)), or of rows shorter than half
// a large tile, take E = 1: there a launch is a short chain of phases on a
// few blocks, and more blocks shorten it.
//
// The arithmetic repeats the plain version operation for operation (see
// csrc/weno5.cuh), and the source is built without fused multiply-adds
// (ops/_build.py: -fmad=false).

#include "async_copy.cuh"
#include "weno5.cuh"

namespace {

constexpr int NT = 128;           // threads per block
// entries per thread on large arrays: a window sliding over 8 (f32) or 4
// (f64) entries, so a large tile holds 1024 or 512 entries.  8 entries in
// f64 spill under the launch bounds below (PERF.md, §6)
template <typename T> constexpr int E_LARGE = sizeof(T) == 4 ? 8 : 4;
// blocks an SM the registers must leave room for: 48 (f32) and 64 (f64)
// registers a thread.  A warp waits out each IEEE division, so more warps
// hide more of the wait: against the compiler's own 57 and 88 registers,
// these bounds took 7% and 25% off the large tile's time on the smooth
// state (PERF.md, §6)
template <typename T> constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 10 : 8;
// arrays of at least this many entries, in rows of at least half a large
// tile, take the large tile: 256 or more blocks, two or more a streaming
// multiprocessor of the H100
constexpr long long LARGE_MIN = 1LL << 18;
constexpr int MAX_GRID_Y = 65535;

template <typename T> struct Args {
  const T* q;
  T* ql;
  T* qr;
  int rows;
  int n;       // row length
};

template <typename T, int E> struct Smem {
  static constexpr int TW = NT * E;   // entries per tile
  // edge value k of thread t at k * OS + t: without bank conflicts both
  // when the threads write their k-th values and when they read
  // consecutive entries back (t % E picks one of E runs of banks, 32 / E
  // banks apart)
  static constexpr int OS = NT + (E > 1 ? 128 / (E * (int)sizeof(T)) : 0);
  alignas(16) T s[TW + 4];            // entries i0-2 .. i0+TW+1
  T l[E * OS];                        // left edge values of the tile
  T r[E * OS];                        // right edge values
  Weno5W<T> w0;                       // the weights of zero betas
  // position of the tile's entry j in l and r
  static HD int at(int j) { return (j % E) * OS + j / E; }
};

// stage the tile's entries and their 2-entry halos; the first and last
// tile of a row wrap the index modulo n
template <typename T, int E>
HD void phase_load(const Args<T>& A, Smem<T, E>& S, int row, int tile,
                   int tid) {
  constexpr int TW = Smem<T, E>::TW;
  const T* src = A.q + (long long)row * A.n;
  const long long i0 = (long long)tile * TW - 2;
  if (i0 >= 0 && i0 + TW + 4 <= A.n) {
    const T* g = src + i0;
#pragma unroll
    for (int m = 0; m < E; ++m)
      copy_async(&S.s[tid + m * NT], g + tid + m * NT);
    if (tid < 4) copy_async(&S.s[TW + tid], g + TW + tid);   // the halo
  } else {
    for (int j = tid; j < TW + 4; j += NT) {
      long long i = i0 + j;
      if (i < 0 || i >= A.n) {
        i %= A.n;
        if (i < 0) i += A.n;
      }
      copy_async(&S.s[j], src + i);
    }
  }
  copy_commit();
  if (tid == 0) {
    const T zero[3] = {T(0), T(0), T(0)};
    S.w0 = weno5_w(zero);
  }
}

// the window of E + 4 staged values from w (16-byte aligned for E > 1)
template <typename T, int E> HD void load_window(const T* w, T* v) {
#if defined(__CUDACC__)
  if constexpr (E % 4 == 0 && sizeof(T) == 4) {
    for (int j = 0; j < E + 4; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(w + j);
      v[j] = x.x; v[j + 1] = x.y; v[j + 2] = x.z; v[j + 3] = x.w;
    }
    return;
  } else if constexpr (E % 2 == 0 && sizeof(T) == 8) {
    for (int j = 0; j < E + 4; j += 2) {
      const double2 x = *reinterpret_cast<const double2*>(w + j);
      v[j] = x.x; v[j + 1] = x.y;
    }
    return;
  }
#endif
  for (int j = 0; j < E + 4; ++j) v[j] = w[j];
}

// the stencil terms that neighbouring entries share (csrc/weno5.cuh:
// weno5_betas_polys, the same expressions): 13/12 d^2 of the curvature
// centred on b, and (-a + 5b + 2c)/6 (p1 of b's entry, m0 of c's) and
// (2a + 5b - c)/6 (p2 of a's entry, m1 of b's)
template <typename T> HD T curvature(T a, T b, T c) {
  const T d = a - T(2) * b + c;
  return T(13.0 / 12.0) * (d * d);
}
template <typename T> HD T poly1(T a, T b, T c) {
  return (-a + T(5) * b + T(2) * c) / T(6);
}
template <typename T> HD T poly2(T a, T b, T c) {
  return (T(2) * a + T(5) * b - c) / T(6);
}

// the edge values of the thread's E consecutive entries, a sliding window
// over the staged values, into the tile's edge arrays
template <typename T, int E>
HD void phase_edges(Smem<T, E>& S, int tid) {
  T v[E + 4];
  load_window<T, E>(S.s + tid * E, v);
  // the terms the first entry shares with the entry before it
  T c_lo = curvature(v[0], v[1], v[2]);
  T c_mid = curvature(v[1], v[2], v[3]);
  T m0 = poly1(v[0], v[1], v[2]);
  T m1 = poly2(v[1], v[2], v[3]);
  for (int k = 0; k < E; ++k) {
    const T vm2 = v[k], vm1 = v[k + 1], v0 = v[k + 2], vp1 = v[k + 3],
            vp2 = v[k + 4];
    const T c_hi = curvature(v0, vp1, vp2);
    T b[3], p[3], m[3];
    T e = vm2 - T(4) * vm1 + T(3) * v0;
    b[0] = c_lo + T(0.25) * (e * e);
    e = vm1 - vp1;
    b[1] = c_mid + T(0.25) * (e * e);
    e = T(3) * v0 - T(4) * vp1 + vp2;
    b[2] = c_hi + T(0.25) * (e * e);
    p[0] = (T(2) * vm2 - T(7) * vm1 + T(11) * v0) / T(6);
    p[1] = poly1(vm1, v0, vp1);
    p[2] = poly2(v0, vp1, vp2);
    m[0] = m0;
    m[1] = m1;
    m[2] = (T(11) * v0 - T(7) * vp1 + T(2) * vp2) / T(6);
    // a constant stencil (all three betas 0, as in most of a piecewise
    // constant state) takes the block's weights of zero betas: the same
    // values weno5_w would compute, without its divisions.  Betas are
    // never negative, so their sum is 0 only when all three are.
    T& l = S.l[k * S.OS + tid];
    T& r = S.r[k * S.OS + tid];
    if (b[0] + b[1] + b[2] == T(0))
      weno5_apply(S.w0, p, m, l, r);
    else
      weno5_apply(weno5_w(b), p, m, l, r);
    c_lo = c_mid;
    c_mid = c_hi;
    m0 = p[1];
    m1 = p[2];
  }
}

// the tile's edge values to device memory, coalesced, up to the row's end:
// thread t stores entries t + m NT, whose edge values sit at at(t) + m NT/E
template <typename T, int E>
HD void phase_store(const Args<T>& A, const Smem<T, E>& S, int row, int tile,
                    int tid) {
  constexpr int TW = Smem<T, E>::TW;
  static_assert(NT % E == 0, "entry t + m NT is entry t's run, m NT/E on");
  const long long left = (long long)A.n - (long long)tile * TW;
  const int count = left < TW ? (int)left : TW;
  const long long i0 = (long long)row * A.n + (long long)tile * TW;
  T* ql = A.ql + i0;
  T* qr = A.qr + i0;
  const int at = S.at(tid);
#pragma unroll
  for (int m = 0; m < E; ++m) {
    if (tid + m * NT < count) {
      ql[tid + m * NT] = S.l[at + m * (NT / E)];
      qr[tid + m * NT] = S.r[at + m * (NT / E)];
    }
  }
}

template <int E> int tiles_of(int n) {
  return (n + NT * E - 1) / (NT * E);
}

template <typename T>
Args<T> make_args(const void* q, void* ql, void* qr, int rows, int n) {
  Args<T> A;
  A.q = static_cast<const T*>(q);
  A.ql = static_cast<T*>(ql);
  A.qr = static_cast<T*>(qr);
  A.rows = rows;
  A.n = n;
  return A;
}

template <typename T> bool large(int rows, int n) {
  return (long long)rows * n >= LARGE_MIN && 2 * n >= NT * E_LARGE<T>;
}

#if defined(__CUDACC__)
template <typename T, int E>
__global__ void __launch_bounds__(NT, MIN_BLOCKS<T>)
weno5_kernel(Args<T> A) {
  __shared__ Smem<T, E> S;
  const int t = threadIdx.x;
  for (int row = blockIdx.y; row < A.rows; row += gridDim.y) {
    phase_load<T, E>(A, S, row, blockIdx.x, t);
    copy_wait_all();
    __syncthreads();
    phase_edges<T, E>(S, t);
    __syncthreads();
    phase_store<T, E>(A, S, row, blockIdx.x, t);
  }
}

template <typename T, int E>
int launch_tile(const Args<T>& A, void* stream) {
  const dim3 grid(tiles_of<E>(A.n), A.rows < MAX_GRID_Y ? A.rows : MAX_GRID_Y);
  weno5_kernel<T, E><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}

template <typename T> int blocks_per_sm() {
  int nb = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, weno5_kernel<T, E_LARGE<T>>, NT, 0);
  return nb;
}
#else
// Host emulation: the same phases, one block and one "thread" at a time,
// each barrier kept by running the whole block through a phase before the
// next.
template <typename T, int E>
int launch_tile(const Args<T>& A, void*) {
  std::vector<Smem<T, E>> smem(1);
  Smem<T, E>& S = smem[0];
  for (int row = 0; row < A.rows; ++row) {
    for (int tile = 0; tile < tiles_of<E>(A.n); ++tile) {
      for (int t = 0; t < NT; ++t) phase_load<T, E>(A, S, row, tile, t);
      for (int t = 0; t < NT; ++t) phase_edges<T, E>(S, t);
      for (int t = 0; t < NT; ++t) phase_store<T, E>(A, S, row, tile, t);
    }
  }
  return 0;
}
#endif

template <typename T>
int launch(const void* q, void* ql, void* qr, int rows, int n, void* stream) {
  const Args<T> A = make_args<T>(q, ql, qr, rows, n);
  return large<T>(rows, n) ? launch_tile<T, E_LARGE<T>>(A, stream)
                           : launch_tile<T, 1>(A, stream);
}

}  // namespace

// ---- plain C interface (loaded with ctypes) ------------------------------
extern "C" {

// Entries per tile that a launch on a (rows, n) array of the type takes.
int weno5_tile(int rows, int n, int is_double) {
  return is_double ? NT * (large<double>(rows, n) ? E_LARGE<double> : 1)
                   : NT * (large<float>(rows, n) ? E_LARGE<float> : 1);
}

// WENO5 edge values of q (rows, n) into ql, qr (rows, n); all contiguous,
// of the type named by the entry.  Returns a cudaError_t (0 on success).
#if defined(__CUDACC__)
// Resident blocks per SM of the large tile (reported by chip_smoke.py).
int weno5_blocks_per_sm(int is_double) {
  return is_double ? blocks_per_sm<double>() : blocks_per_sm<float>();
}
int weno5_f32(const void* q, void* ql, void* qr, int rows, int n,
              void* stream) {
  return launch<float>(q, ql, qr, rows, n, stream);
}
int weno5_f64(const void* q, void* ql, void* qr, int rows, int n,
              void* stream) {
  return launch<double>(q, ql, qr, rows, n, stream);
}
#else
int weno5_host_f32(const void* q, void* ql, void* qr, int rows, int n) {
  return launch<float>(q, ql, qr, rows, n, nullptr);
}
int weno5_host_f64(const void* q, void* ql, void* qr, int rows, int n) {
  return launch<double>(q, ql, qr, rows, n, nullptr);
}
#endif

}  // extern "C"
