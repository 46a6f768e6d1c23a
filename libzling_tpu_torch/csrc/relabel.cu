// K5: sticky-MTF relabel -- each literal unit's raw byte becomes its rank
// in its context's permutation, then rank i swaps with rank MTF_NEXT[i].
// Replaces libzling_tpu/ops/relabel_kernel.py::_relabel_kernel; the plain
// version and the source note are in ops/relabel_kernel.py.
//
// The walk is 256 chains, not one: a literal reads and writes only row ctx
// of r2s and s2r, and MTF_NEXT is constant, so each context's literals form
// a chain in stream order and the contexts are independent.  One CTA of
// 256 threads walks them side by side, thread c owning context c; a tile's
// time is set by its busiest context.
//
// One CTA for the whole stream: r2s and s2r (u8 [256][256] each, 128 KB)
// live in dynamic shared memory, loaded from state_in and stored to
// state_out at the end.  The units of each range [unit_off[b], +unit_cnt[b]),
// ranges in order, go through shared memory in tiles of kTile units:
//
//   * thread 0 stages the next tile by one bulk copy (async.cuh) into the
//     other of two buffers while the CTA works on this one;
//   * a stable partition of the tile's literal units by context: each warp
//     counts its 512 units' contexts (__match_any_sync: one leader a
//     context and round), an exclusive scan over (context, warp) gives each
//     warp's first slot in each context's list, and a second pass writes
//     (tile index << 8 | byte) there, ranked within the warp in lane order;
//   * thread c walks context c's list in order (three dependent loads and
//     four stores a literal) and writes each rank beside the tile;
//   * the CTA stores the tile, literals with their ranks, coalesced.
//
// Units outside the ranges are not touched (the wrapper's copy of the input
// holds them).
#include "async.cuh"

namespace {

using namespace zlt;

constexpr int kTile = 4096;                 // units a tile
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = kTile / kWarps;        // units a warp partitions
constexpr int kBuf = kTile + 8;             // a tile's 16-byte aligned window
constexpr int kSmem = 2 * 65536 + 2 * 4 * kBuf + 4 * kTile + kTile +
                      4 * kWarps * 256;

// The first tile at or after unit `pos` of range b: (b, pos), b == n_blocks
// when none is left.
__device__ __forceinline__ void seek(const int* __restrict__ unit_cnt,
                                     int n_blocks, int& b, int& pos) {
  while (b < n_blocks && pos >= unit_cnt[b]) {
    ++b;
    pos = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
relabel_kernel(const int* __restrict__ units,
               const int64_t* __restrict__ unit_off,
               const int* __restrict__ unit_cnt, int n_blocks,
               const uint8_t* __restrict__ state_in,
               const int* __restrict__ mtfnext, int* units_out,
               uint8_t* state_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* r2s = smem;
  uint8_t* s2r = smem + 65536;
  int* s_buf = reinterpret_cast<int*>(smem + 2 * 65536);   // [2][kBuf]
  int* s_list = s_buf + 2 * kBuf;                          // [kTile]
  int* s_cur = s_list + kTile;                             // [kWarps][256]
  uint8_t* s_rank = reinterpret_cast<uint8_t*>(s_cur + kWarps * 256);
  __shared__ int s_nxt[256], s_start[256], s_count[256], s_wsum[kWarps];
  __shared__ __align__(8) uint64_t s_full[2];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < 2 * 65536 / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = reinterpret_cast<const uint4*>(state_in)[i];
  s_nxt[tid] = mtfnext[tid];
  if (tid == 0) {
    mbar_init(&s_full[0], 1);
    mbar_init(&s_full[1], 1);
    mbar_init_fence();
  }
  __syncthreads();

  // every thread follows the same tile sequence; thread 0 stages a tile
  // one step ahead
  auto stage = [&](int b, int pos, int buf) {
    const int n = min(kTile, unit_cnt[b] - pos);
    const Window w = window_of(units + unit_off[b] + pos, n);
    bulk_load(s_buf + buf * kBuf, w.start, w.bytes, &s_full[buf]);
  };
  int b = 0, pos = 0;
  seek(unit_cnt, n_blocks, b, pos);
  if (tid == 0 && b < n_blocks) stage(b, pos, 0);
  for (int it = 0; b < n_blocks; ++it) {
    const int buf = it & 1;
    const int n = min(kTile, unit_cnt[b] - pos);
    const int64_t first = unit_off[b] + pos;
    int nb = b, npos = pos + n;
    seek(unit_cnt, n_blocks, nb, npos);
    // the other buffer's tile (it - 1) was stored before the last barrier
    if (tid == 0 && nb < n_blocks) stage(nb, npos, buf ^ 1);
    for (int i = tid; i < kWarps * 256; i += kThreads) s_cur[i] = 0;
    mbar_wait(&s_full[buf], (it >> 1) & 1);
    const int* tile = s_buf + buf * kBuf + window_of(units + first, n).shift;
    __syncthreads();

    // 1. count each warp's literals by context
    int* cur = s_cur + warp * 256;
    for (int u0 = warp * kSeg; u0 < min(n, (warp + 1) * kSeg); u0 += 32) {
      const int u = u0 + lane;
      const int w = u < n ? tile[u] : 0;
      const bool lit = u < n && ((w >> 10) & 3) == 1;
      const unsigned m = __ballot_sync(0xFFFFFFFFu, lit);
      if (lit) {
        const int ctx = (w >> 14) & 255;
        const unsigned peers = __match_any_sync(m, ctx);
        if (lane == __ffs(peers) - 1) cur[ctx] += __popc(peers);
      }
      __syncwarp();
    }
    __syncthreads();

    // 2. context tid's list: its start (an exclusive scan over contexts)
    // and each warp's first slot in it
    int total = 0;
    for (int k = 0; k < kWarps; ++k) {
      const int h = s_cur[k * 256 + tid];
      s_cur[k * 256 + tid] = total;
      total += h;
    }
    int incl = total;
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) s_wsum[warp] = incl;
    __syncthreads();
    int start = incl - total;
    for (int k = 0; k < warp; ++k) start += s_wsum[k];
    s_start[tid] = start;
    s_count[tid] = total;
    for (int k = 0; k < kWarps; ++k) s_cur[k * 256 + tid] += start;
    __syncthreads();

    // 3. write each literal to its context's list, stably
    for (int u0 = warp * kSeg; u0 < min(n, (warp + 1) * kSeg); u0 += 32) {
      const int u = u0 + lane;
      const int w = u < n ? tile[u] : 0;
      const bool lit = u < n && ((w >> 10) & 3) == 1;
      const unsigned m = __ballot_sync(0xFFFFFFFFu, lit);
      int ctx = 0, next = 0;
      bool leader = false;
      if (lit) {
        ctx = (w >> 14) & 255;
        const unsigned peers = __match_any_sync(m, ctx);
        const int at = cur[ctx];
        s_list[at + __popc(peers & ((1u << lane) - 1))] = (u << 8) | (w & 255);
        leader = lane == __ffs(peers) - 1;
        next = at + __popc(peers);
      }
      __syncwarp();
      if (leader) cur[ctx] = next;
      __syncwarp();
    }
    __syncthreads();

    // 4. walk context tid's literals in stream order
    {
      uint8_t* r = r2s + tid * 256;
      uint8_t* s = s2r + tid * 256;
      const int end = s_start[tid] + s_count[tid];
      for (int k = s_start[tid]; k < end; ++k) {
        const int e = s_list[k];
        const int sym = e & 255;
        const int i = s[sym];
        const int j = s_nxt[i];
        const int other = r[j];
        r[i] = static_cast<uint8_t>(other);
        r[j] = static_cast<uint8_t>(sym);
        s[sym] = static_cast<uint8_t>(j);
        s[other] = static_cast<uint8_t>(i);
        s_rank[e >> 8] = static_cast<uint8_t>(i);
      }
    }
    __syncthreads();

    // 5. store the tile
    int* out = units_out + first;
    for (int u = tid; u < n; u += kThreads) {
      const int w = tile[u];
      out[u] = ((w >> 10) & 3) == 1 ? (w & ~1023) | s_rank[u] : w;
    }
    __syncthreads();
    b = nb;
    pos = npos;
  }

  for (int i = tid; i < 2 * 65536 / 16; i += kThreads)
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
