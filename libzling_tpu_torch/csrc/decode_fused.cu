// K3: fused chunk decode -- LSB-first canonical Huffman bit reader feeding
// the ROLZ resolve state machine, one serial pass over every chunk of a
// stream.  Replaces libzling_tpu/ops/decode_fused.py::_fused_kernel; the
// plain version and the source note are in ops/decode_fused.py.
//
// One CTA of two warps per stream; no token array in global memory.
//
//   * the producer (warp 1): its lanes load a chunk's tables (12-bit
//     alphabet-1 LUT, canonical tiers for 13..15-bit codes, the 8-bit
//     alphabet-2 LUT) into shared memory, then lane 0 runs K1's reader
//     (huffman.cuh) over the chunk with the fused decoder's reading rules
//     and writes one entry a token into a ring in shared memory: the symbol
//     and, for a match, its index; after the chunk's last token an end
//     entry (kEnd, or kOverrun when the reader went past n_words); on an
//     invalid code, a read past n_words or a match without room for its
//     index, kError, and it stops.  A block's raw head bytes (the first
//     2 - opos0 tokens of a chunk, opos0 being the previous chunk's encpos
//     or 0 at a new block) read no index bits.
//   * the resolver (warp 0): its lanes clear the ring of token-start
//     positions ([256][4096] i32, global memory) at each new block and the
//     word-MRU at each chunk; lane 0 runs K2's resolve steps (rolz.cuh)
//     over the entries, one entry ahead, so that a coming match's ring slot
//     is loaded as soon as the context before it is known.
//
// The two meet through the entry ring's write and read counts (release /
// acquire in shared memory).  The resolver writes every chunk's status
// (opos, tokens, bad, opos at the chunk's start); after a bad chunk it
// marks the rest bad and raises the stop flag, which ends the producer.
#include <cuda/atomic>

#include "huffman.cuh"
#include "rolz.cuh"

namespace {

using namespace zlt;

constexpr int kWarp = 32;
constexpr int kMru = 512;        // [ctx][2] words, newest first
constexpr int kTok = 8192;       // entries of the producer -> resolver ring
constexpr int kError = -1;       // the reader rejected the chunk here
constexpr int kEnd = -2;         // the chunk's tokens are all read
constexpr int kOverrun = -3;     // ... but the reader went past n_words
constexpr int kSmem = 65536 +
    4 * (kLut1 + kOrder + kLut2 + kTier + kMru + 256 + 256 + kTok);

using Count = cuda::atomic_ref<int, cuda::thread_scope_block>;

__device__ __forceinline__ int acquire(int& x) {
  return Count(x).load(cuda::memory_order_acquire);
}

__device__ __forceinline__ void release(int& x, int v) {
  Count(x).store(v, cuda::memory_order_release);
}

struct Shared {
  int* tok;      // [kTok] entries
  int* tail;     // entries written (producer)
  int* taken;    // entries read (resolver)
  int* stop;     // the resolver stopped: the producer ends
};

// Warp 1: decode every chunk into entries.
__device__ void produce(const int* __restrict__ meta,
                        const int* __restrict__ order1,
                        const int* __restrict__ lut1,
                        const int* __restrict__ lut2,
                        const uint32_t* __restrict__ words, int n_chunks,
                        int* s_lut1, int* s_order, int* s_lut2, int* s_tier,
                        Shared q, int lane) {
  int w = 0, seen = 0;   // entries written; the resolver's count, as seen
  bool quit = false;
  // one entry (lane 0); false once the resolver has stopped
  auto push = [&](int e) {
    while (w - seen >= kTok) {
      release(*q.tail, w);
      if (acquire(*q.stop)) return false;
      seen = acquire(*q.taken);
    }
    q.tok[w & (kTok - 1)] = e;
    ++w;
    if ((w & 7) == 0) release(*q.tail, w);
    return true;
  };
  for (int c = 0; c < n_chunks && !quit; ++c) {
    load_chunk_tables(c, meta, order1, lut1, lut2, s_lut1, s_order, s_lut2,
                      s_tier, lane, kWarp);
    __syncwarp();
    if (lane == 0) {
      const int* m = meta + static_cast<size_t>(c) * 1024;
      const int n_words = m[0], rlen = m[1];
      const uint32_t* wp = words + m[2];
      const int opos0 = m[4] ? 0 : meta[static_cast<size_t>(c - 1) * 1024 + 3];
      const int nhead = max(2 - opos0, 0);
      uint64_t acc = wp[0] | (static_cast<uint64_t>(wp[1]) << 32);
      int nbits = 64, wpos = 2, emitted = 0, last = kEnd;
      bool ok = true;
      while (emitted < rlen && ok) {
        refill(acc, nbits, wpos, wp);
        const int e = peek_symbol(acc, s_lut1, s_tier, s_order);
        if (e < 0) { last = kError; break; }
        const int t = e & 0xFFFF;
        const int hl = max((e >> 16) & 31, 1);
        acc >>= hl;
        nbits -= hl;
        if (wpos > n_words) { last = kError; break; }
        if (emitted < nhead || t < 258) {  // a head byte, literal or MRU hit
          ok = push(t);
          ++emitted;
          continue;
        }
        if (emitted + 1 >= rlen) { last = kError; break; }
        const int e2 = s_lut2[acc & 0xFF];
        if (e2 < 0) { last = kError; break; }
        const int hl2 = e2 & 0xFF, blen = (e2 >> 8) & 0xFF;
        const int midx = (e2 >> 16) +
            static_cast<int>((acc >> hl2) & ((1u << blen) - 1));
        acc >>= hl2 + blen;
        nbits -= hl2 + blen;
        ok = push(t | midx << 16);
        emitted += 2;
      }
      if (ok && last == kEnd && wpos * 32 - nbits > n_words * 32)
        last = kOverrun;
      quit = !ok || !push(last) || last == kError;
      release(*q.tail, w);
    }
    quit = __shfl_sync(0xFFFFFFFFu, quit, 0);
  }
}

__global__ void __launch_bounds__(2 * kWarp)
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
  int* s_nxt = s_head + 256;
  int* s_tok = s_nxt + 256;
  __shared__ int s_tail, s_taken, s_stop;
  const int tid = threadIdx.x, lane = tid % kWarp;

  for (int i = tid; i < 65536 / 16; i += 2 * kWarp)
    reinterpret_cast<uint4*>(s_mtf)[i] = reinterpret_cast<const uint4*>(mtf0)[i];
  for (int i = tid; i < 256; i += 2 * kWarp) s_nxt[i] = mtfnext[i];
  if (tid == 0) {
    s_tail = 0;
    s_taken = 0;
    s_stop = 0;
  }
  __syncthreads();
  const Shared q{s_tok, &s_tail, &s_taken, &s_stop};
  if (tid >= kWarp) {
    produce(meta, order1, lut1, lut2, words, n_chunks, s_lut1, s_order,
            s_lut2, s_tier, q, lane);
    return;
  }

  // the resolver warp
  int rd = 0, avail = 0, opos_carry = 0;
  bool stop = false;
  // the next entry (lane 0): waits for the producer
  auto take = [&]() {
    while (rd == avail) avail = acquire(s_tail);
    const int e = s_tok[rd & (kTok - 1)];
    ++rd;
    if ((rd & 63) == 0) release(s_taken, rd);
    return e;
  };
  for (int c = 0; c < n_chunks; ++c) {
    if (stop) {  // an earlier chunk was bad: the rest is not decoded
      if (lane == 0) {
        int* st = status + 4 * c;
        st[0] = 0; st[1] = 0; st[2] = 1; st[3] = 0;
      }
      continue;
    }
    const int* m = meta + static_cast<size_t>(c) * 1024;
    const int new_block = m[4];
    for (int i = lane; i < kMru; i += kWarp) s_mru[i] = 0;
    if (new_block) {
      for (int i = lane; i < 256; i += kWarp) s_head[i] = 0;
      int4* r4 = reinterpret_cast<int4*>(ring);
      for (int i = lane; i < 256 * kRing / 4; i += kWarp)
        r4[i] = make_int4(0, 0, 0, 0);
    }
    __syncwarp();
    if (lane == 0) {
      const int rlen = m[1];
      const int opos0 = new_block ? 0 : opos_carry;
      uint8_t* o = out + out_base[c];
      Resolver r{o, ring, s_head, s_mru, s_mtf, s_nxt, opos0,
                 opos0 >= 1 ? o[opos0 - 1] : 0, opos0 >= 2 ? o[opos0 - 2] : 0,
                 m[3]};
      int emitted = 0;
      bool bad = false;
      int e = take();
      while (emitted < rlen) {
        if (e < 0) { bad = true; break; }   // the reader rejected the chunk
        const int en = take();              // the entry after it
        const int nt = en >= 0 ? (en & 0xFFFF) : -1, nm = en >> 16;
        const int t = e & 0xFFFF;
        if (r.opos <= 1) {  // the two raw head bytes of a block
          if (!r.head_byte(t, nt, nm)) { bad = true; break; }
          ++emitted;
        } else if (t >= 258) {  // match: ring source of its index
          emitted += 2;
          if (!r.match(t, e >> 16, nt, nm)) { bad = true; break; }
        } else {
          if (!r.simple(t, nt, nm)) { bad = true; break; }
          ++emitted;
        }
        e = en;
      }
      bad = bad || e != kEnd || r.opos != r.encpos;
      int* st = status + 4 * c;
      st[0] = r.opos;
      st[1] = emitted;
      st[2] = bad ? 1 : 0;
      st[3] = opos0;
      opos_carry = r.opos;
      stop = bad;
      if (bad) release(s_stop, 1);
    }
    stop = __shfl_sync(0xFFFFFFFFu, stop, 0);
    __syncwarp();
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
  decode_fused_kernel<<<1, 2 * kWarp, kSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(meta), static_cast<const int*>(order1),
      static_cast<const int*>(lut1), static_cast<const int*>(lut2),
      static_cast<const uint8_t*>(mtf0), static_cast<const int*>(mtfnext),
      static_cast<const uint32_t*>(words),
      static_cast<const int64_t*>(out_base), n_chunks,
      static_cast<uint8_t*>(out), static_cast<int*>(ring),
      static_cast<int*>(status));
  return static_cast<int>(cudaGetLastError());
}
