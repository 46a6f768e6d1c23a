// K3: fused chunk decode -- LSB-first canonical Huffman bit reader feeding
// the ROLZ resolve state machine, one serial pass over every chunk of a
// stream.  Replaces libzling_tpu/ops/decode_fused.py::_fused_kernel; the
// plain version and the source note are in ops/decode_fused.py.
//
// One CTA per stream.  Dynamic shared memory holds the sticky-MTF table
// (u8 [256][256], carried across the whole stream), the current chunk's
// tables (12-bit alphabet-1 LUT, canonical tiers for 13..15-bit codes, the
// 8-bit alphabet-2 LUT) and the word-MRU (reset per chunk).  The ring of
// token-start positions ([256][4096] i32) is in global memory, cleared by
// the whole CTA at each new block.  Thread 0 walks each chunk.
#include "common.cuh"

namespace {

using namespace zlt;

constexpr int kLut1 = 4096;      // 12-bit window LUT: sym | len << 16
constexpr int kOrder = 1024;     // symbols by (length, id), per chunk
constexpr int kLut2 = 256;       // len2 | matchidx bits << 8 | base << 16
constexpr int kTier = 48;        // start[16], count[16], base[16]
constexpr int kMru = 512;        // [ctx][2] words, newest first
constexpr int kSmem = 65536 + 4 * (kLut1 + kOrder + kLut2 + kTier + kMru + 256);

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

// Forward copy with the format's overlap semantics (out[opos+k] =
// out[src+k], byte by byte).  Sources at least 8 bytes back are moved in
// groups of 8 independent loads.
__device__ __forceinline__ void copy_match(uint8_t* o, int opos, int src,
                                           int mlen) {
  int k = 0;
  if (opos - src >= 8) {
    for (; k + 8 <= mlen; k += 8) {
      uint8_t v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = o[src + k + q];
#pragma unroll
      for (int q = 0; q < 8; ++q) o[opos + k + q] = v[q];
    }
  }
  for (; k < mlen; ++k) o[opos + k] = o[src + k];
}

__global__ void __launch_bounds__(kThreads)
decode_fused_kernel(const int* __restrict__ meta,
                    const int* __restrict__ order1,
                    const int* __restrict__ lut1,
                    const int* __restrict__ lut2,
                    const uint8_t* __restrict__ mtf0,
                    const int* __restrict__ mtfnext,
                    const uint32_t* __restrict__ words,
                    const int64_t* __restrict__ out_base, int n_chunks,
                    uint8_t* out, int* ring, int* status) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* s_mtf = smem;
  int* s_lut1 = reinterpret_cast<int*>(smem + 65536);
  int* s_order = s_lut1 + kLut1;
  int* s_lut2 = s_order + kOrder;
  int* s_tier = s_lut2 + kLut2;
  int* s_mru = s_tier + kTier;
  int* s_head = s_mru + kMru;
  __shared__ int s_nxt[256];
  __shared__ int s_opos, s_stop;
  const int tid = threadIdx.x;

  for (int i = tid; i < 65536 / 16; i += kThreads)
    reinterpret_cast<uint4*>(s_mtf)[i] = reinterpret_cast<const uint4*>(mtf0)[i];
  for (int i = tid; i < 256; i += kThreads) s_nxt[i] = mtfnext[i];
  if (tid == 0) {
    s_opos = 0;
    s_stop = 0;
  }

  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();
    if (s_stop) {  // an earlier chunk was bad: the rest is not decoded
      if (tid == 0) {
        int* st = status + 4 * c;
        st[0] = 0; st[1] = 0; st[2] = 1; st[3] = 0;
      }
      continue;
    }
    const int* m = meta + static_cast<size_t>(c) * 1024;
    const int new_block = m[4];
    for (int i = tid; i < kLut1; i += kThreads) s_lut1[i] = lut1[c * kLut1 + i];
    for (int i = tid; i < kOrder; i += kThreads) s_order[i] = order1[c * kOrder + i];
    for (int i = tid; i < kLut2; i += kThreads) s_lut2[i] = lut2[c * 1024 + i];
    for (int i = tid; i < kTier; i += kThreads)
      s_tier[i] = m[128 * (1 + i / 16) + i % 16];
    for (int i = tid; i < kMru; i += kThreads) s_mru[i] = 0;
    if (new_block) {
      for (int i = tid; i < 256; i += kThreads) s_head[i] = 0;
      int4* r4 = reinterpret_cast<int4*>(ring);
      for (int i = tid; i < 256 * kRing / 4; i += kThreads)
        r4[i] = make_int4(0, 0, 0, 0);
    }
    __syncthreads();
    if (tid != 0) continue;

    const int n_words = m[0], rlen = m[1], encpos = m[3];
    const uint32_t* wp = words + m[2];
    uint8_t* o = out + out_base[c];
    int opos = new_block ? 0 : s_opos;
    const int opos0 = opos;
    int l1 = opos >= 1 ? o[opos - 1] : 0;
    int l2 = opos >= 2 ? o[opos - 2] : 0;
    uint64_t acc = wp[0] | (static_cast<uint64_t>(wp[1]) << 32);
    int nbits = 64, wpos = 2, emitted = 0;
    bool bad = false;
    while (emitted < rlen) {
      // alphabet-1 symbol: refill to >= 32 bits, LUT, tiers, consume
      if (nbits < 32) {
        acc |= static_cast<uint64_t>(wp[wpos]) << nbits;
        ++wpos;
        nbits += 32;
      }
      int e = s_lut1[acc & 0xFFF];
      if (e < 0) e = tier_lookup(static_cast<uint32_t>(acc), s_tier, s_order);
      if (e < 0) { bad = true; break; }
      const int t = e & 0xFFFF;
      const int hl = max((e >> 16) & 31, 1);
      acc >>= hl;
      nbits -= hl;
      if (wpos > n_words) { bad = true; break; }

      if (opos <= 1) {  // the two raw head bytes of a block
        if (opos + 1 > encpos) { bad = true; break; }
        const int b = t & 255;
        o[opos++] = static_cast<uint8_t>(b);
        ++emitted;
        l2 = l1;
        l1 = b;
        continue;
      }
      const int ctx = l1;
      int* rg = ring + ctx * kRing;
      if (t >= 258) {  // match: alphabet-2 code + extra bits, ring source
        if (emitted + 1 >= rlen) { bad = true; break; }
        const int e2 = s_lut2[acc & 0xFF];
        if (e2 < 0) { bad = true; break; }
        const int hl2 = e2 & 0xFF, blen = (e2 >> 8) & 0xFF;
        const int midx = (e2 >> 16) +
            static_cast<int>((acc >> hl2) & ((1u << blen) - 1));
        acc >>= hl2 + blen;
        nbits -= hl2 + blen;
        emitted += 2;
        const int h = (s_head[ctx] + 1) & (kRing - 1);
        s_head[ctx] = h;
        const int src = rg[(h - midx) & (kRing - 1)];
        rg[h] = opos;
        const int mlen = t - 258 + kMatchMin;
        if (midx == 0 || src == 0 || src >= opos || opos + mlen > encpos) {
          bad = true;
          break;
        }
        copy_match(o, opos, src, mlen);
        opos += mlen;
        const int cu = o[opos - 3];
        l2 = o[opos - 2];
        l1 = o[opos - 1];
        const int wu = (l2 << 8) | l1;
        if (s_mru[cu * 2] != wu) {
          s_mru[cu * 2 + 1] = s_mru[cu * 2];
          s_mru[cu * 2] = wu;
        }
        continue;
      }
      const int n = t < 256 ? 1 : 2;
      if (opos + n > encpos) { bad = true; break; }
      const int h = (s_head[ctx] + 1) & (kRing - 1);
      s_head[ctx] = h;
      rg[h] = opos;
      ++emitted;
      if (t < 256) {  // literal: sticky-MTF rank -> byte, swap with MTF_NEXT
        uint8_t* row = s_mtf + ctx * 256;
        const int lit = row[t];
        const int j = s_nxt[t];
        row[t] = row[j];
        row[j] = static_cast<uint8_t>(lit);
        o[opos++] = static_cast<uint8_t>(lit);
        s_mru[l2 * 2 + 1] = s_mru[l2 * 2];
        s_mru[l2 * 2] = (ctx << 8) | lit;
        l2 = ctx;
        l1 = lit;
      } else {  // word-MRU hit (256: newest, 257: second)
        const int wv = s_mru[ctx * 2 + (t & 1)];
        const int b0 = (wv >> 8) & 255, b1 = wv & 255;
        o[opos] = static_cast<uint8_t>(b0);
        o[opos + 1] = static_cast<uint8_t>(b1);
        if (t == 257) {
          s_mru[ctx * 2 + 1] = s_mru[ctx * 2];
          s_mru[ctx * 2] = wv;
        }
        opos += 2;
        l2 = b0;
        l1 = b1;
      }
    }
    bad = bad || (wpos * 32 - nbits > n_words * 32) || opos != encpos;
    int* st = status + 4 * c;
    st[0] = opos;
    st[1] = emitted;
    st[2] = bad ? 1 : 0;
    st[3] = opos0;
    s_opos = opos;
    s_stop = bad ? 1 : 0;
  }
}

}  // namespace

ZLT_API int zlt_decode_fused(const void* meta, const void* order1,
                             const void* lut1, const void* lut2,
                             const void* mtf0, const void* mtfnext,
                             const void* words, const void* out_base,
                             int n_chunks, void* out, void* ring,
                             void* status, void* stream) {
  cudaFuncSetAttribute(decode_fused_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  decode_fused_kernel<<<1, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(meta), static_cast<const int*>(order1),
      static_cast<const int*>(lut1), static_cast<const int*>(lut2),
      static_cast<const uint8_t*>(mtf0), static_cast<const int*>(mtfnext),
      static_cast<const uint32_t*>(words),
      static_cast<const int64_t*>(out_base), n_chunks,
      static_cast<uint8_t*>(out), static_cast<int*>(ring),
      static_cast<int*>(status));
  return static_cast<int>(cudaGetLastError());
}
