// Asynchronous copies for K2 (resolve.cu) and K5 (relabel.cu): 1-D bulk
// copies (TMA) from global to shared memory, completed on an mbarrier, and
// from shared to global memory, completed by bulk groups; and the window of
// a token or unit range that such a copy moves.
//
// A bulk copy moves a multiple of 16 bytes between 16-byte aligned
// addresses, so a range of 4-byte words is staged as the 16-byte aligned
// window that holds it: `shift` words before its first word and up to three
// after its last.  Those extra words lie in the same 16-byte segment as a
// word of the range, so in the same allocation (device allocations are at
// least 256-byte aligned); they are copied and never read.
#pragma once

#include <cuda/atomic>

#include "common.cuh"

namespace zlt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

// after every mbar_init, before the barriers are used by other threads
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// True once the phase of parity `parity` has completed.
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One thread: copy `bytes` (a multiple of 16) from global `src` to shared
// `dst` (both 16-byte aligned); the copy's bytes complete `bar`'s phase,
// which this call also arrives on once.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One thread: copy `bytes` (a multiple of 16) from shared `src` to global
// `dst` (both 16-byte aligned) in the current bulk group; the shared
// memory's earlier writes by this thread are made visible to the copy.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int bytes) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's bulk groups are in flight; the
// others' writes are then complete and visible to its global loads.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// The 16-byte aligned window of the n words at p: its first byte, its
// length in bytes (0 when n == 0) and the words before p in it.
struct Window {
  const char* start;
  int bytes, shift;
};

__device__ __forceinline__ Window window_of(const int* p, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t a0 = a & ~uintptr_t{15};
  const uintptr_t a1 = (a + 4 * static_cast<uintptr_t>(n) + 15) & ~uintptr_t{15};
  return Window{reinterpret_cast<const char*>(a0),
                n > 0 ? static_cast<int>(a1 - a0) : 0,
                static_cast<int>((a - a0) >> 2)};
}

using Flag = cuda::atomic_ref<int, cuda::thread_scope_block>;

__device__ __forceinline__ int flag_get(int& x) {
  return Flag(x).load(cuda::memory_order_acquire);
}

__device__ __forceinline__ void flag_set(int& x, int v) {
  Flag(x).store(v, cuda::memory_order_release);
}

}  // namespace zlt
