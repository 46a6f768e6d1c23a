// K1: per-chunk Huffman entropy decode -- every chunk's LSB-first canonical
// Huffman bitstream to its token array.  Replaces
// libzling_tpu/ops/entropy_kernel.py::_decode_chunk_kernel; the plain
// version is ops/entropy_kernel.py::decode_chunks_plain.
//
// Bound: one dependent chain per symbol (LUT load -> code length -> shift
// -> next LUT address, all in shared memory), serial within a chunk.
// Chunks decode independently (their own tables and payload), so the grid
// is one CTA per chunk: the 32 MiB e0 stream has 47 chunks, about a third
// of the card's 132 SMs, each bound by its chain's shared-memory latency,
// not by bandwidth.
//
// Design: the CTA's threads load the chunk's tables (lut1 16 KB, order
// 4 KB, lut2 1 KB, the 48 tier words) into static shared memory, then
// thread 0 walks the chunk with the shared 64-bit reader (huffman.cuh).
// The TPU kernel's chunk pairs, payload slabs and flush bursts are its
// layout and are not ported: tokens go straight to their flat offset
// `tok_off[c]`.  The rules are the JAX kernel's: a symbol >= 258 takes an
// index only when `emitted + 1 < rlen` (a match symbol in last place is
// emitted alone); a missing code emits token 0, consumes one bit and sets
// bad; `wpos > n_words` is checked once per two units and the consumed bit
// count against `n_words * 32` at the end.  The reader reads at most two
// words past `n_words`, inside the chunk's 512-byte zero pad.
#include "huffman.cuh"

namespace {

using namespace zlt;

__global__ void __launch_bounds__(kThreads)
entropy_decode_kernel(const int* __restrict__ meta,
                      const int* __restrict__ order1,
                      const int* __restrict__ lut1,
                      const int* __restrict__ lut2,
                      const uint32_t* __restrict__ words,
                      const int64_t* __restrict__ tok_off,
                      int* __restrict__ tokens, int* __restrict__ status) {
  __shared__ int s_lut1[kLut1];
  __shared__ int s_order[kOrder];
  __shared__ int s_lut2[kLut2];
  __shared__ int s_tier[kTier];
  const int c = blockIdx.x;
  load_chunk_tables(c, meta, order1, lut1, lut2, s_lut1, s_order, s_lut2,
                    s_tier);
  __syncthreads();
  if (threadIdx.x != 0) return;

  const int* m = meta + static_cast<size_t>(c) * 1024;
  const int n_words = m[0], rlen = m[1];
  const uint32_t* wp = words + m[2];
  int* out = tokens + tok_off[c];
  uint64_t acc = wp[0] | (static_cast<uint64_t>(wp[1]) << 32);
  int nbits = 64, wpos = 2, emitted = 0;
  bool bad = false;

  while (emitted < rlen && !bad) {
    // two units (an alphabet-1 symbol, and for a match its index), then
    // the overrun check, as the JAX kernel's loop body
    for (int u = 0; u < 2 && emitted < rlen && !bad; ++u) {
      refill(acc, nbits, wpos, wp);
      int e = peek_symbol(acc, s_lut1, s_tier, s_order);
      if (e < 0) {
        bad = true;
        e = 0;
      }
      const int sym = e & 0xFFFF;
      const int hl = max((e >> 16) & 31, 1);
      acc >>= hl;
      nbits -= hl;
      if (sym >= 258 && emitted + 1 < rlen) {
        int e2 = s_lut2[acc & 0xFF];
        if (e2 < 0) {
          bad = true;
          e2 = 0;
        }
        const int hl2 = e2 & 0xFF, blen = (e2 >> 8) & 0xFF;
        const int idx = (e2 >> 16) +
            static_cast<int>((acc >> hl2) & ((1u << blen) - 1));
        acc >>= hl2 + blen;
        nbits -= hl2 + blen;
        out[emitted] = sym;
        out[emitted + 1] = idx;
        emitted += 2;
      } else {
        out[emitted++] = sym;
      }
    }
    bad = bad || wpos > n_words;
  }
  const int bit_pos = wpos * 32 - nbits;
  int* st = status + 3 * c;
  st[0] = emitted;
  st[1] = bit_pos;
  st[2] = (bad || bit_pos > n_words * 32) ? 1 : 0;
}

}  // namespace

ZLT_API int zlt_entropy_decode(const void* meta, const void* order1,
                               const void* lut1, const void* lut2,
                               const void* words, const void* tok_off,
                               int n_chunks, void* tokens, void* status,
                               void* stream) {
  entropy_decode_kernel<<<n_chunks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(meta), static_cast<const int*>(order1),
      static_cast<const int*>(lut1), static_cast<const int*>(lut2),
      static_cast<const uint32_t*>(words),
      static_cast<const int64_t*>(tok_off), static_cast<int*>(tokens),
      static_cast<int*>(status));
  return static_cast<int>(cudaGetLastError());
}
