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
// (12 B in f32, 24 B in f64) and does ~100 floating-point operations, below
// the card's 20 (f32) and 10 (f64) operations per byte, so bytes bound it
// (chip_smoke.py computes both bounds from `FLOPS_PER_ENTRY_WENO5`).
//
// Design: a fused elementwise stencil pass.  A block owns TW consecutive
// entries of one row and stages them with a 2-entry halo on each side
// (indices wrapped modulo n) in shared memory; each thread then computes
// the two edge values of one entry and writes them.  Nothing but q, ql and
// qr touches device memory.  Blocks walk the rows one after the other
// (block b: row b / tiles, tile b % tiles), so any (rows, n) works.
//
// The arithmetic repeats the plain version operation for operation (see
// csrc/weno5.cuh), and the source is built without fused multiply-adds
// (ops/_build.py: -fmad=false).

#include "weno5.cuh"

namespace {

constexpr int TW = 256;  // entries per block = threads per block

template <typename T> struct Args {
  const T* q;
  T* ql;
  T* qr;
  int n;       // row length
  int tiles;   // blocks per row
};

// stage the block's entries and their 2-entry halos (wrapped modulo n)
template <typename T>
HD void phase_load(const Args<T>& A, T* s, int b, int tid) {
  const long long row = b / A.tiles;
  const long long i0 = (long long)(b % A.tiles) * TW;
  for (int j = tid; j < TW + 4; j += TW) {
    long long i = (i0 + j - 2) % A.n;
    if (i < 0) i += A.n;
    s[j] = A.q[row * A.n + i];
  }
}

// the two edge values of entry i0 + tid
template <typename T>
HD void phase_edges(const Args<T>& A, const T* s, int b, int tid) {
  const long long row = b / A.tiles;
  const long long i = (long long)(b % A.tiles) * TW + tid;
  if (i >= A.n) return;
  T l, r;
  weno5(s[tid], s[tid + 1], s[tid + 2], s[tid + 3], s[tid + 4], l, r);
  A.ql[row * A.n + i] = l;
  A.qr[row * A.n + i] = r;
}

template <typename T>
Args<T> make_args(const void* q, void* ql, void* qr, int n) {
  Args<T> A;
  A.q = static_cast<const T*>(q);
  A.ql = static_cast<T*>(ql);
  A.qr = static_cast<T*>(qr);
  A.n = n;
  A.tiles = (n + TW - 1) / TW;
  return A;
}

#if defined(__CUDACC__)
template <typename T>
__global__ void __launch_bounds__(TW) weno5_kernel(Args<T> A) {
  __shared__ T s[TW + 4];
  phase_load<T>(A, s, blockIdx.x, threadIdx.x);
  __syncthreads();
  phase_edges<T>(A, s, blockIdx.x, threadIdx.x);
}

template <typename T>
int launch(const void* q, void* ql, void* qr, int rows, int n, void* stream) {
  const Args<T> A = make_args<T>(q, ql, qr, n);
  weno5_kernel<T><<<rows * A.tiles, TW, 0,
                    static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}
#else
// Host emulation: the same phases, one block and one "thread" at a time,
// the barrier kept by running the whole block through the load first.
template <typename T>
int launch(const void* q, void* ql, void* qr, int rows, int n, void*) {
  const Args<T> A = make_args<T>(q, ql, qr, n);
  std::vector<T> s(TW + 4);
  for (int b = 0; b < rows * A.tiles; ++b) {
    for (int t = 0; t < TW; ++t) phase_load<T>(A, s.data(), b, t);
    for (int t = 0; t < TW; ++t) phase_edges<T>(A, s.data(), b, t);
  }
  return 0;
}
#endif

}  // namespace

// ---- plain C interface (loaded with ctypes) ------------------------------
extern "C" {

// WENO5 edge values of q (rows, n) into ql, qr (rows, n); all contiguous,
// of the type named by the entry.  Returns a cudaError_t (0 on success).
#if defined(__CUDACC__)
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
