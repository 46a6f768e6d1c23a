// The LSB-first canonical Huffman reader shared by K1 (entropy_decode.cu)
// and K3 (decode_fused.cu), so the two readers cannot drift apart.
//
// A chunk's tables come from ops/entropy_kernel.py::build_chunk_tables:
// the 12-bit window LUT of alphabet 1 (sym | len << 16, -1 for a miss or a
// longer code), the symbols in canonical order, the alphabet-2 LUT
// (len2 | matchidx bits << 8 | matchidx base << 16) and the canonical tiers
// (start, count, base for lengths 0..15) from meta rows 1-3.  The bit
// reader is a 64-bit accumulator of `nbits` valid bits from its LSB; one
// unit consumes at most 15 + 8 + 8 = 31 bits, so a top-up to >= 32 bits
// once per unit keeps every peek inside it.
#pragma once

#include "common.cuh"

namespace zlt {

constexpr int kLut1 = 4096;      // 12-bit window LUT: sym | len << 16
constexpr int kOrder = 1024;     // symbols by (length, id), per chunk
constexpr int kLut2 = 256;       // len2 | matchidx bits << 8 | base << 16
constexpr int kTier = 48;        // start[16], count[16], base[16]

// Load chunk c's tables into shared memory: threads tid, tid + nthreads,
// ... of the CTA (by default all of them) take part; the caller
// synchronises them before reading the tables.
__device__ __forceinline__ void load_chunk_tables(
    int c, const int* __restrict__ meta, const int* __restrict__ order1,
    const int* __restrict__ lut1, const int* __restrict__ lut2, int* s_lut1,
    int* s_order, int* s_lut2, int* s_tier, int tid = -1, int nthreads = 0) {
  if (tid < 0) {
    tid = threadIdx.x;
    nthreads = blockDim.x;
  }
  const int* m = meta + static_cast<size_t>(c) * 1024;
  for (int i = tid; i < kLut1; i += nthreads)
    s_lut1[i] = lut1[static_cast<size_t>(c) * kLut1 + i];
  for (int i = tid; i < kOrder; i += nthreads)
    s_order[i] = order1[static_cast<size_t>(c) * kOrder + i];
  for (int i = tid; i < kLut2; i += nthreads)
    s_lut2[i] = lut2[static_cast<size_t>(c) * 1024 + i];
  for (int i = tid; i < kTier; i += nthreads)
    s_tier[i] = m[128 * (1 + i / 16) + i % 16];
}

// Top the accumulator up to >= 32 bits: at most one word per unit, read
// where the JAX reader reads it, so `wpos > n_words` rejects the same
// streams.
__device__ __forceinline__ void refill(uint64_t& acc, int& nbits, int& wpos,
                                       const uint32_t* wp) {
  if (nbits < 32) {
    acc |= static_cast<uint64_t>(wp[wpos]) << nbits;
    ++wpos;
    nbits += 32;
  }
}

// The reader's state at bit p of a chunk, as a walk from bit 0 has it at
// the start of a unit once it has refilled: `nbits` in [32, 63] (64 at bit
// 0), so `wpos` -- which `wpos > n_words` tests -- is the walk's too.
__device__ __forceinline__ void seek_bit(int p, const uint32_t* wp,
                                         uint64_t& acc, int& nbits,
                                         int& wpos) {
  const int k = p >> 5, r = p & 31;
  if (r == 0 && p > 0) {
    acc = wp[k];
    nbits = 32;
    wpos = k + 1;
  } else {
    acc = (wp[k] | (static_cast<uint64_t>(wp[k + 1]) << 32)) >> r;
    nbits = 64 - r;
    wpos = k + 2;
  }
}

// Codes of 13..15 bits: the unique tier whose MSB-first range holds the
// reversed window's top bits.
__device__ __forceinline__ int tier_lookup(uint32_t lo, const int* tier,
                                           const int* order) {
  const int v15 = static_cast<int>(__brev(lo & 0x7FFFu) >> 17);
  for (int ln = 13; ln <= 15; ++ln) {
    const int top = v15 >> (15 - ln);
    const int s = tier[ln], cnt = tier[16 + ln];
    if (top >= s && top < s + cnt) {
      const int pos = min(max(tier[32 + ln] + top - s, 0), kOrder - 1);
      return order[pos] | (ln << 16);
    }
  }
  return -1;
}

// The alphabet-1 entry at the accumulator's window (sym | len << 16), or
// -1 when no code matches.  Does not consume.
__device__ __forceinline__ int peek_symbol(uint64_t acc, const int* s_lut1,
                                           const int* s_tier,
                                           const int* s_order) {
  const int e = s_lut1[acc & 0xFFF];
  return e >= 0 ? e : tier_lookup(static_cast<uint32_t>(acc), s_tier, s_order);
}

}  // namespace zlt
