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
// the whole CTA at each new block.  Thread 0 walks each chunk: the reader
// is K1's (huffman.cuh), the resolve steps are K2's (rolz.cuh).
#include "huffman.cuh"
#include "rolz.cuh"

namespace {

using namespace zlt;

constexpr int kMru = 512;        // [ctx][2] words, newest first
constexpr int kSmem = 65536 + 4 * (kLut1 + kOrder + kLut2 + kTier + kMru + 256);

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
    load_chunk_tables(c, meta, order1, lut1, lut2, s_lut1, s_order, s_lut2,
                      s_tier);
    for (int i = tid; i < kMru; i += kThreads) s_mru[i] = 0;
    if (new_block) {
      for (int i = tid; i < 256; i += kThreads) s_head[i] = 0;
      int4* r4 = reinterpret_cast<int4*>(ring);
      for (int i = tid; i < 256 * kRing / 4; i += kThreads)
        r4[i] = make_int4(0, 0, 0, 0);
    }
    __syncthreads();
    if (tid != 0) continue;

    const int n_words = m[0], rlen = m[1];
    const uint32_t* wp = words + m[2];
    const int opos0 = new_block ? 0 : s_opos;
    uint8_t* o = out + out_base[c];
    Resolver r{o, ring, s_head, s_mru, s_mtf, s_nxt, opos0,
               opos0 >= 1 ? o[opos0 - 1] : 0, opos0 >= 2 ? o[opos0 - 2] : 0,
               m[3]};
    uint64_t acc = wp[0] | (static_cast<uint64_t>(wp[1]) << 32);
    int nbits = 64, wpos = 2, emitted = 0;
    bool bad = false;
    while (emitted < rlen) {
      // alphabet-1 symbol: refill to >= 32 bits, LUT, tiers, consume
      refill(acc, nbits, wpos, wp);
      const int e = peek_symbol(acc, s_lut1, s_tier, s_order);
      if (e < 0) { bad = true; break; }
      const int t = e & 0xFFFF;
      const int hl = max((e >> 16) & 31, 1);
      acc >>= hl;
      nbits -= hl;
      if (wpos > n_words) { bad = true; break; }

      if (r.opos <= 1) {  // the two raw head bytes of a block
        if (!r.head_byte(t)) { bad = true; break; }
        ++emitted;
        continue;
      }
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
        if (!r.match(t, midx)) { bad = true; break; }
        continue;
      }
      if (!r.simple(t)) { bad = true; break; }
      ++emitted;
    }
    const int opos = r.opos;
    bad = bad || (wpos * 32 - nbits > n_words * 32) || opos != r.encpos;
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
