// K2: serial ROLZ resolve -- the token stream of every chunk to bytes.
// Replaces libzling_tpu/ops/resolve_kernel.py::_resolve_kernel; the plain
// version is ops/resolve_kernel.py::resolve_stream_plain.
//
// Bound: one dependent chain per token, as in K3 without the bit reader.
// The resolve is serial over the whole stream (a literal's context is the
// byte just decoded, the MTF table crosses blocks), so one thread walks it
// and the kernel is bound by the latency of its loads: shared memory for
// the MTF table and word-MRU, L1/L2 for the tokens, the ring and match
// sources.
//
// Design: one CTA for the stream, as K3.  Dynamic shared memory holds the
// u8 sticky-MTF table (64 KB, loaded from mtf0, written to mtf_out after
// the last chunk), the 256 ring heads and the word-MRU (reset per chunk).
// The ring of token-start positions ([256][4096] i32, 4 MB) is in global
// memory; the wrapper zeroes it and the whole CTA clears it at each new
// block before thread 0 reads it (0 means an unwritten slot).  Thread 0
// walks the chunk's tokens from global memory and writes bytes straight
// into the u8 output at the block's offset, through the resolve steps it
// shares with K3 (rolz.cuh), telling them the next token so that a coming
// match's ring slot is loaded as soon as its context is known.  The TPU
// kernel's token slabs, one-byte-per-word rows, flush bursts and literal
// fast loop are its layout and scheduling and are not ported.
//
// A block's first two bytes take one token each, whatever its value (the
// low byte is the output), as the JAX split decoder does.  Rejections
// (resolve_kernel.py:226-227,311,414): midx == 0, an unwritten slot,
// src >= opos, a match whose index would lie at or past rlen, opos > encpos,
// opos != encpos at the chunk's end.  Every overrun check runs before any
// byte is written, so a corrupt stream never writes past its block.  After
// the first bad chunk the rest are marked bad and not decoded.
#include "rolz.cuh"

namespace {

using namespace zlt;

constexpr int kMru = 512;        // [ctx][2] words, newest first
constexpr int kSmem = 65536 + 4 * (kMru + 256);

__global__ void __launch_bounds__(kThreads)
resolve_kernel(const int* __restrict__ tokens,
               const int64_t* __restrict__ tok_off,
               const int* __restrict__ rlens, const int* __restrict__ encposs,
               const int* __restrict__ new_blocks,
               const int64_t* __restrict__ out_base,
               const uint8_t* __restrict__ mtf0,
               const int* __restrict__ mtfnext, int n_chunks, uint8_t* out,
               int* ring, int* status, uint8_t* mtf_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* s_mtf = smem;
  int* s_mru = reinterpret_cast<int*>(smem + 65536);
  int* s_head = s_mru + kMru;
  __shared__ int s_nxt[256];
  __shared__ int s_opos, s_stop;
  const int tid = threadIdx.x;

  for (int i = tid; i < 65536 / 16; i += kThreads)
    reinterpret_cast<uint4*>(s_mtf)[i] = reinterpret_cast<const uint4*>(mtf0)[i];
  for (int i = tid; i < 256; i += kThreads) {
    s_nxt[i] = mtfnext[i];
    s_head[i] = 0;
  }
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
    const int new_block = new_blocks[c];
    for (int i = tid; i < kMru; i += kThreads) s_mru[i] = 0;
    if (new_block) {
      for (int i = tid; i < 256; i += kThreads) s_head[i] = 0;
      int4* r4 = reinterpret_cast<int4*>(ring);
      for (int i = tid; i < 256 * kRing / 4; i += kThreads)
        r4[i] = make_int4(0, 0, 0, 0);
    }
    __syncthreads();
    if (tid != 0) continue;

    const int rlen = rlens[c];
    const int* tk = tokens + tok_off[c];
    const int opos0 = new_block ? 0 : s_opos;
    uint8_t* o = out + out_base[c];
    Resolver r{o, ring, s_head, s_mru, s_mtf, s_nxt, opos0,
               opos0 >= 1 ? o[opos0 - 1] : 0, opos0 >= 2 ? o[opos0 - 2] : 0,
               encposs[c]};
    int tpos = 0;
    bool bad = false;
    // the token at n and its index word, for the resolver to load a coming
    // match's ring slot ahead (-1: past the chunk)
    auto peek = [&](int n, int& nm) {
      if (n + 1 >= rlen) return -1;
      nm = tk[n + 1];
      return tk[n];
    };
    while (tpos < rlen) {
      const int t = tk[tpos];
      int nm = 0;
      if (r.opos <= 1) {  // the two raw head bytes of a block: one token each
        const int nt = peek(tpos + 1, nm);
        if (!r.head_byte(t, nt, nm)) { bad = true; break; }
        ++tpos;
      } else if (t >= 258) {  // match: the next token is its ring index
        if (tpos + 1 >= rlen) { bad = true; break; }
        const int nt = peek(tpos + 2, nm);
        if (!r.match(t, tk[tpos + 1], nt, nm)) { bad = true; break; }
        tpos += 2;
      } else {
        const int nt = peek(tpos + 1, nm);
        if (!r.simple(t, nt, nm)) { bad = true; break; }
        ++tpos;
      }
    }
    const int opos = r.opos;
    bad = bad || opos != r.encpos;
    int* st = status + 4 * c;
    st[0] = opos;
    st[1] = tpos;
    st[2] = bad ? 1 : 0;
    st[3] = opos0;
    s_opos = opos;
    s_stop = bad ? 1 : 0;
  }
  __syncthreads();
  for (int i = tid; i < 65536 / 16; i += kThreads)
    reinterpret_cast<uint4*>(mtf_out)[i] = reinterpret_cast<const uint4*>(s_mtf)[i];
}

}  // namespace

ZLT_API int zlt_resolve(const void* tokens, const void* tok_off,
                        const void* rlens, const void* encpos,
                        const void* new_block, const void* out_base,
                        const void* mtf0, const void* mtfnext, int n_chunks,
                        void* out, void* ring, void* status, void* mtf_out,
                        void* stream) {
  cudaFuncSetAttribute(resolve_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  resolve_kernel<<<1, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tokens), static_cast<const int64_t*>(tok_off),
      static_cast<const int*>(rlens), static_cast<const int*>(encpos),
      static_cast<const int*>(new_block),
      static_cast<const int64_t*>(out_base),
      static_cast<const uint8_t*>(mtf0), static_cast<const int*>(mtfnext),
      n_chunks, static_cast<uint8_t*>(out), static_cast<int*>(ring),
      static_cast<int*>(status), static_cast<uint8_t*>(mtf_out));
  return static_cast<int>(cudaGetLastError());
}
