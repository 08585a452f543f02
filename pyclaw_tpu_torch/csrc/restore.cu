// restore.cu — the guarded restore of the solver's device loop, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: it is the port's form of the accept/reject
// select of the JAX package's traced loop, `q_ = jnp.where(ok, q_new, q_)`
// (pyclaw_tpu/solver.py:320), which XLA fuses into the while_loop's body.
// The port's loop (pyclaw_tpu_torch/solver.py) alternates two q buffers:
// an attempted step reads one and writes its result into the other, so an
// accepted step costs no copy.  Only a rejected step copies the step's
// input back over its output.  This kernel reads the loop's device flag
// `ok` and, when it is false, copies `src` over `dst`; when it is true
// every block returns after one load of the flag.  Its plain version is
// `torch.where(ok, dst, src)` (ops/restore.py), which reads both buffers
// and writes one on every step.
//
// What bounds it: bytes.  A rejected step moves 2 x nbytes (read src,
// write dst); an accepted one reads one byte a block.
//
// Compiles with nvcc and, without __CUDACC__, with a host C++ compiler for
// the host emulation (ops/_build.py:build_host_emulation).

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif
#include <cstdint>

namespace {

constexpr int NT = 256;           // threads per block
constexpr int BLOCKS_PER_SM = 2;  // the grid: this many blocks an SM

#if defined(__CUDACC__)
#define HD __device__ __forceinline__
#else
#define HD inline
struct uint4 { unsigned int x, y, z, w; };
#endif

// thread tid's part of the copy: 16-byte chunks of the buffers (both
// 16-byte aligned), then the bytes of the tail, by a grid-stride loop
HD void copy_part(unsigned char* dst, const unsigned char* src,
                  long long nbytes, long long tid, long long stride) {
  const long long nvec = nbytes / 16;
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (long long i = tid; i < nvec; i += stride) d[i] = s[i];
  for (long long i = nvec * 16 + tid; i < nbytes; i += stride)
    dst[i] = src[i];
}

// blocks of the grid: enough for the chunks, at most BLOCKS_PER_SM an SM
int grid_of(long long nbytes, int sms) {
  const long long need = (nbytes / 16 + NT - 1) / NT;
  const long long most = (long long)sms * BLOCKS_PER_SM;
  return (int)(need < 1 ? 1 : (need < most ? need : most));
}

#if defined(__CUDACC__)
__global__ void __launch_bounds__(NT) restore_kernel(
    unsigned char* dst, const unsigned char* src, const bool* ok,
    long long nbytes) {
  if (*ok) return;
  copy_part(dst, src, nbytes, (long long)blockIdx.x * NT + threadIdx.x,
            (long long)gridDim.x * NT);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
            != cudaSuccess)
      sms = 132;
  }
  return sms;
}
#endif

}  // namespace

// ---- plain C interface (loaded with ctypes) ------------------------------
extern "C" {

// dst = ok ? dst : src over nbytes bytes.  dst, src: 16-byte aligned
// buffers of nbytes bytes (device memory, host memory for the host
// emulation); ok: one bool.  Returns a cudaError_t (0 on success), or -1
// for buffers that are not 16-byte aligned.
#if defined(__CUDACC__)
int restore(void* dst, const void* src, const void* ok, long long nbytes,
            void* stream) {
  if ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src))
      % 16 != 0)
    return -1;
  restore_kernel<<<grid_of(nbytes, sm_count()), NT, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned char*>(dst),
      static_cast<const unsigned char*>(src), static_cast<const bool*>(ok),
      nbytes);
  return (int)cudaGetLastError();
}
#else
int restore_host(void* dst, const void* src, const void* ok,
                 long long nbytes) {
  if ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src))
      % 16 != 0)
    return -1;
  if (*static_cast<const bool*>(ok)) return 0;
  // the card's grid on 132 SMs, one block and one thread at a time
  const int nb = grid_of(nbytes, 132);
  for (long long t = 0; t < (long long)nb * NT; ++t)
    copy_part(static_cast<unsigned char*>(dst),
              static_cast<const unsigned char*>(src), nbytes, t,
              (long long)nb * NT);
  return 0;
}
#endif

}  // extern "C"
