// K5: sticky-MTF relabel -- each literal unit's raw byte becomes its rank
// in its context's permutation, then rank i swaps with rank MTF_NEXT[i].
// Replaces libzling_tpu/ops/relabel_kernel.py::_relabel_kernel; the plain
// version and the source note are in ops/relabel_kernel.py.
//
// One CTA for the whole walk: the MTF chain crosses blocks.  r2s and s2r
// (u8 [256][256] each, 128 KB) live in dynamic shared memory; the CTA
// loads them, thread 0 walks the units block after block, and the CTA
// stores the exit state for the next group.
#include "common.cuh"

namespace {

using namespace zlt;

constexpr int kSmem = 2 * 65536;
constexpr int kBatch = 8;  // units loaded ahead of the serial walk

__device__ __forceinline__ int relabel_unit(int w, uint8_t* r2s, uint8_t* s2r,
                                            const int* nxt) {
  if (((w >> 10) & 3) != 1) return w;
  const int sym = w & 255, ctx = (w >> 14) & 255;
  uint8_t* r = r2s + ctx * 256;
  uint8_t* s = s2r + ctx * 256;
  const int i = s[sym];
  const int j = nxt[i];
  const int other = r[j];
  r[i] = static_cast<uint8_t>(other);
  r[j] = static_cast<uint8_t>(sym);
  s[sym] = static_cast<uint8_t>(j);
  s[other] = static_cast<uint8_t>(i);
  return (w & ~1023) | i;
}

__global__ void __launch_bounds__(kThreads)
relabel_kernel(const int* __restrict__ units,
               const int64_t* __restrict__ unit_off,
               const int* __restrict__ unit_cnt, int n_blocks,
               const uint8_t* __restrict__ state_in,
               const int* __restrict__ mtfnext, int* units_out,
               uint8_t* state_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_nxt[256];
  const int tid = threadIdx.x;
  for (int i = tid; i < kSmem / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = reinterpret_cast<const uint4*>(state_in)[i];
  for (int i = tid; i < 256; i += kThreads) s_nxt[i] = mtfnext[i];
  __syncthreads();
  if (tid == 0) {
    uint8_t* r2s = smem;
    uint8_t* s2r = smem + 65536;
    for (int b = 0; b < n_blocks; ++b) {
      const int* in = units + unit_off[b];
      int* out = units_out + unit_off[b];
      const int n = unit_cnt[b];
      int k = 0;
      for (; k + kBatch <= n; k += kBatch) {
        int w[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) w[q] = in[k + q];
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          out[k + q] = relabel_unit(w[q], r2s, s2r, s_nxt);
      }
      for (; k < n; ++k) out[k] = relabel_unit(in[k], r2s, s2r, s_nxt);
    }
  }
  __syncthreads();
  for (int i = tid; i < kSmem / 16; i += kThreads)
    reinterpret_cast<uint4*>(state_out)[i] = reinterpret_cast<const uint4*>(smem)[i];
}

}  // namespace

ZLT_API int zlt_relabel(const void* units, const void* unit_off,
                        const void* unit_cnt, int n_blocks,
                        const void* state_in, const void* mtfnext,
                        void* units_out, void* state_out, void* stream) {
  cudaFuncSetAttribute(relabel_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  relabel_kernel<<<1, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(units), static_cast<const int64_t*>(unit_off),
      static_cast<const int*>(unit_cnt), n_blocks,
      static_cast<const uint8_t*>(state_in), static_cast<const int*>(mtfnext),
      static_cast<int*>(units_out), static_cast<uint8_t*>(state_out));
  return static_cast<int>(cudaGetLastError());
}
