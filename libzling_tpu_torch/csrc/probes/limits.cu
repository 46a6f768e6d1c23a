// Card counterparts of tools/probe_limits.py.  The TPU probes only compile
// (a lowering that fails is the TPU's "FAIL"); these launch, because a
// refused launch is the card's "FAIL" and shows only in cudaGetLastError().
// The plain versions and the wrappers are in probes/limits.py.
//
//   resident_kernel    PL1, probe_vmem (:30, pallas_call :38): does per-lane
//                      state stay on chip?  On this card that is the 50 MB
//                      L2: a one-thread dependent chase over a random single
//                      cycle of u32 indices, at a footprint and a dynamic
//                      shared-memory size (which shrinks L1) of the caller's;
//   smem_kernel        PL2, probe_smem (:50, pallas_call :58): the dynamic
//                      shared-memory ceiling; writes x to the first word,
//                      reads back the last and sums the whole allocation;
//   shift_bytes_kernel PL3, probe_dyn_roll (:70, pallas_call :75): rotate a
//                      128-byte row held by one warp (4 bytes a lane) by a
//                      run-time shift, with two shuffles and a funnel shift;
//   shift_words_kernel PL4, probe_dyn_roll2d (:88, pallas_call :93): rotate
//                      an (8, 128) i32 array along its lanes, 4 words a row
//                      a lane, with shuffles and a register rotation;
//   index_*_kernel     PL5, PL6, probe_onehot_read (:106, pallas_call :116)
//                      and probe_onehot_write (:129, pallas_call :138): read
//                      a byte at a run-time row and lane and write the lane
//                      there, in a (64, 128) u8 shared array, and the same in
//                      a 32-entry per-thread array (which nvcc puts in local
//                      memory: ptxas reports its stack bytes);
//   warp_mix_kernel    PL7, probe_scalar_while_vector_mix (:151, pallas_call
//                      :167): a scalar loop reading one byte of a row a
//                      step, alone and with one warp-wide __ballot_sync
//                      compare of 32 bytes a step (the card's vector op, the
//                      one a warp-parallel LCP in K4 would use).
// Each loop runs `n` times so that clock64() gives its cost per step.
#include "probe.cuh"

namespace {

using namespace zlp;

constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void resident_kernel(int steps, const uint32_t* __restrict__ nxt,
                                unsigned long long* out) {
  if (threadIdx.x != 0) return;
  uint32_t x = 0, ck = 0;
  const long long t0 = clock64();
#pragma unroll 1
  for (int k = 0; k < steps; ++k) {
    x = nxt[x];
    ck += x;
  }
  finish(out, x, ck, t0);
}

__global__ void __launch_bounds__(kThreads)
smem_kernel(int nwords, int x, unsigned long long* out) {
  extern __shared__ int s[];
  const long long t0 = clock64();
  for (int k = threadIdx.x; k < nwords; k += blockDim.x) s[k] = k ^ x;
  __syncthreads();
  if (threadIdx.x == 0) s[0] = x;
  __syncthreads();
  uint32_t ck = 0;
  for (int k = threadIdx.x; k < nwords; k += blockDim.x) ck += s[k];
  const long long t1 = clock64();
  atomicAdd(&out[1], static_cast<unsigned long long>(ck));
  if (threadIdx.x == 0) {
    out[0] = static_cast<uint32_t>(s[nwords - 1]);
    out[2] = static_cast<unsigned long long>(t1 - t0);
  }
}

// Word 1 of the shift probes: sum over the output of (index + 1) * value.
__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  return __reduce_add_sync(kFull, v);
}

__global__ void shift_bytes_kernel(int n, int s, const uint32_t* __restrict__ x,
                                   uint32_t* y, unsigned long long* out) {
  const int lane = threadIdx.x;
  const int q = s >> 2, r = 8 * (s & 3);
  uint32_t w = x[lane];
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const uint32_t hi = __shfl_sync(kFull, w, (lane - q) & 31);
    const uint32_t lo = __shfl_sync(kFull, w, (lane - q - 1) & 31);
    w = __funnelshift_l(lo, hi, r);
  }
  y[lane] = w;
  const uint32_t ck = warp_sum(w * static_cast<uint32_t>(lane + 1));
  if (lane == 0) finish(out, w, ck, t0);
}

__global__ void shift_words_kernel(int n, int s, const int* __restrict__ x,
                                   int* y, unsigned long long* out) {
  const int lane = threadIdx.x;
  const int src = (lane - s) & 31, b = ((lane - s) & 127) >> 5;
  int v[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int m = 0; m < 4; ++m) v[r][m] = x[r * 128 + lane + 32 * m];
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      int t[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) t[m] = __shfl_sync(kFull, v[r][m], src);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        v[r][m] = b == 0 ? t[m] : b == 1 ? t[(m + 1) & 3]
                : b == 2 ? t[(m + 2) & 3] : t[(m + 3) & 3];
    }
  }
  uint32_t ck = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int c = r * 128 + lane + 32 * m;
      y[c] = v[r][m];
      ck += static_cast<uint32_t>(v[r][m]) * (c + 1);
    }
  ck = warp_sum(ck);
  if (lane == 0) finish(out, v[0][0], ck, t0);
}

// The read and the write of PL5/PL6, chained: v = a[r][l]; a[r][l] = l;
// then the next row and lane come from v.
__global__ void index_shared_kernel(int n, int row, int lane,
                                    const uint8_t* __restrict__ x, uint8_t* y,
                                    unsigned long long* out) {
  __shared__ uint8_t s[64 * 128];
  for (int k = threadIdx.x; k < 64 * 128; k += blockDim.x) s[k] = x[k];
  __syncthreads();
  if (threadIdx.x == 0) {
    int r = row, l = lane;
    uint32_t v = 0, ck = 0;
    const long long t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      v = s[r * 128 + l];
      s[r * 128 + l] = static_cast<uint8_t>(l);
      ck += v;
      l = (l + v + 1) & 127;
      r = (r + v) & 63;
    }
    finish(out, v, ck, t0);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 64 * 128; k += blockDim.x) y[k] = s[k];
}

__global__ void index_local_kernel(int n, int lane, const int* __restrict__ x,
                                   int* y, unsigned long long* out) {
  if (threadIdx.x != 0) return;
  int t[32];
  for (int k = 0; k < 32; ++k) t[k] = x[k];
  int l = lane;
  uint32_t v = 0, ck = 0;
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    v = t[l & 31];
    t[l & 31] = l;
    ck += v;
    l = (l + v + 1) & 127;
  }
  finish(out, v, ck, t0);
  for (int k = 0; k < 32; ++k) y[k] = t[k];
}

template <bool kBallot>
__global__ void warp_mix_kernel(int n, const uint8_t* __restrict__ x,
                                unsigned long long* out) {
  __shared__ uint8_t s[64 * 128];
  for (int k = threadIdx.x; k < 64 * 128; k += blockDim.x) s[k] = x[k];
  __syncthreads();
  const int lane = threadIdx.x;
  if (!kBallot && lane != 0) return;
  uint32_t acc = 0, ck = 0;
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    if constexpr (kBallot) {
      const int c = (i + lane) & 127;
      const int a = s[(i & 63) * 128 + c];
      const int b = s[((i + 1) & 63) * 128 + c];
      const unsigned m = __ballot_sync(kFull, a != b);
      acc += a;
      ck += m ? __ffs(m) - 1 : 32;
    } else {
      const int a = s[(i & 63) * 128 + (i & 127)];
      acc += a;
      ck += a;
    }
  }
  if (lane == 0) finish(out, acc, ck, t0);
}

}  // namespace

ZLT_API int zlp_resident(int steps, const void* nxt, int smem_bytes, void* out,
                         void* stream) {
  cudaFuncSetAttribute(resident_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  resident_kernel<<<1, 32, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<const uint32_t*>(nxt),
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

ZLT_API int zlp_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// Refused past the opt-in ceiling: the attribute call fails, and so does
// the launch; cudaGetLastError() returns the launch's error.
ZLT_API int zlp_smem_ceiling(int bytes, int x, void* out, void* stream) {
  if (bytes < 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  smem_kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      bytes / 4, x, static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

ZLT_API int zlp_dyn_shift(int kind, int n, int s, const void* x, void* y,
                          void* out, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<unsigned long long*>(out);
  if (s < 0 || s >= 128) return static_cast<int>(cudaErrorInvalidValue);
  if (kind == 0)
    shift_bytes_kernel<<<1, 32, 0, st>>>(n, s, static_cast<const uint32_t*>(x),
                                         static_cast<uint32_t*>(y), o);
  else
    shift_words_kernel<<<1, 32, 0, st>>>(n, s, static_cast<const int*>(x),
                                         static_cast<int*>(y), o);
  return static_cast<int>(cudaGetLastError());
}

ZLT_API int zlp_dyn_index(int kind, int n, int row, int lane, const void* x,
                          void* y, void* out, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<unsigned long long*>(out);
  if (kind == 0)
    index_shared_kernel<<<1, 32, 0, st>>>(
        n, row & 63, lane & 127, static_cast<const uint8_t*>(x),
        static_cast<uint8_t*>(y), o);
  else
    index_local_kernel<<<1, 32, 0, st>>>(n, lane & 127,
                                         static_cast<const int*>(x),
                                         static_cast<int*>(y), o);
  return static_cast<int>(cudaGetLastError());
}

ZLT_API int zlp_warp_mix(int ballot, int n, const void* x, void* out,
                         void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(x);
  auto* o = static_cast<unsigned long long*>(out);
  if (ballot)
    warp_mix_kernel<true><<<1, 32, 0, st>>>(n, in, o);
  else
    warp_mix_kernel<false><<<1, 32, 0, st>>>(n, in, o);
  return static_cast<int>(cudaGetLastError());
}
