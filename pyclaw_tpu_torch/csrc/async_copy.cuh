// async_copy.cuh — asynchronous global -> shared copies (cp.async) and the
// warp-shuffle max, shared by dq2_weno5.cu and step3_aos.cu.
//
// A copy moves one element of 4 B (float) or 8 B (double): the kernels
// stage rows of a ghost-padded grid whose starts are not 16-byte aligned.
// Without __CUDACC__ (the kernels' host emulation,
// ops/_build.py:build_host_emulation) a copy is a plain assignment, the
// waits are no-ops, and the warp max is the caller's loop over the lanes.

#pragma once

#include "euler2d.cuh"

namespace {

#if defined(__CUDACC__)
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte elements");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src) : "memory");
  }
}
// close the group of copies this thread has issued since the last commit
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait for every copy this thread has issued (other threads' copies are
// visible after a barrier that follows their wait)
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// NaN-propagating max over the 32 lanes of a warp, in every lane
template <typename T> __device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1)
    v = mx(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
#else
template <typename T> inline void copy_async(T* dst, const T* src) {
  *dst = *src;
}
inline void copy_commit() {}
inline void copy_wait_all() {}
#endif

}  // namespace
