// Shared constants and helpers of the zling Hopper kernels.
//
// Most kernels are serial state machines over bytes: one CTA per
// independent lane, one thread walks the lane, and the CTA's other threads
// clear state and load tables between __syncthreads() (K1 instead walks
// the segments of each chunk side by side).  Entry points have
// a plain C interface (pointers and the stream as void*) and return
// cudaGetLastError() after their launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define ZLT_API extern "C" __attribute__((visibility("default")))

namespace zlt {

constexpr int kThreads = 256;          // threads of every CTA
constexpr int kRing = 4096;            // ring slots per context
constexpr int kHash = 8192;            // hash heads per context
constexpr int kMatchMin = 4;
constexpr int kMatchMax = 259;
constexpr int kLazyMaxLen = 128;       // lazy probes only below this length
constexpr uint32_t kNil = 0xFFFF;

}  // namespace zlt
