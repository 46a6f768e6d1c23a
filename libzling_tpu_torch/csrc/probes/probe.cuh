// Shared helpers of the card's cost probes (csrc/probes/*.cu), the
// counterparts of the TPU probes in tools/probe_*.py.
//
// A probe kernel is one CTA in which thread 0 walks a loop, as the TPU
// probes' while_loops run on the scalar core and as K1, K2 and K4 walk
// their chains.  It writes three 64-bit words:
//   out[0]  word 0, the TPU probe's result;
//   out[1]  word 1, a checksum of the values the loop loads, so that nvcc
//           can neither delete nor hoist the work being measured;
//   out[2]  the clock64() cycles thread 0 spent in the loop.
// Every measured loop is `#pragma unroll 1`: one body per trip, as a
// while_loop.  The TPU probes' int32 arithmetic wraps; here it is done in
// uint32_t, and shifts follow XLA's rule (an amount outside [0, 32) gives
// 0), which C++ leaves undefined.  The plain versions beside the wrappers
// (probes/*.py) compute the same words in Python.
#pragma once

#include "../common.cuh"

namespace zlp {

using zlt::kThreads;

__device__ __forceinline__ uint32_t shl(uint32_t x, int s) {
  return static_cast<unsigned>(s) < 32u ? x << s : 0u;
}

__device__ __forceinline__ uint32_t srl(uint32_t x, int s) {
  return static_cast<unsigned>(s) < 32u ? x >> s : 0u;
}

__device__ __forceinline__ int i32(uint32_t x) { return static_cast<int>(x); }

__device__ __forceinline__ void finish(unsigned long long* out, uint32_t w0,
                                       uint32_t w1, long long t0) {
  const long long t1 = clock64();
  out[0] = w0;
  out[1] = w1;
  out[2] = static_cast<unsigned long long>(t1 - t0);
}

// Copy n 32-bit words with every thread of the CTA, 16 bytes a step
// (n % 4 == 0, both pointers 16-byte aligned).  The caller synchronises.
__device__ __forceinline__ void cta_copy(int* dst, const int* src, int n) {
  const int4* s = reinterpret_cast<const int4*>(src);
  int4* d = reinterpret_cast<int4*>(dst);
  for (int k = threadIdx.x; k < n / 4; k += blockDim.x) d[k] = s[k];
}

}  // namespace zlp
