// K2: serial ROLZ resolve -- the token stream of every chunk to bytes.
// Replaces libzling_tpu/ops/resolve_kernel.py::_resolve_kernel; the plain
// version is ops/resolve_kernel.py::resolve_stream_plain.
//
// Bound: one dependent chain per token, as in K3 without the bit reader.
// The resolve is serial over the whole stream (a literal's context is the
// byte just decoded, the MTF table crosses blocks), so one thread walks it
// and the kernel is bound by the latency of its loads and instructions.  A
// match's chain is its ring slot (L2: the ring is 4 MB) then its source
// bytes, whose last one is the next context.
//
// One CTA of two warps for the stream:
//
//   * the producer (warp 1, lane 0) stages every chunk's tokens into a
//     ring of kPieces pieces of kPiece tokens in shared memory, one bulk
//     copy (async.cuh) a piece, ahead of the resolver: piece p goes to
//     slot p mod kPieces once the resolver has released the slot's last
//     piece (`s_empty`), and completes `s_full` of its slot.  A chunk is
//     staged as the 16-byte aligned window of its tokens.  It tests the
//     stop flag once a piece; after a bad chunk the resolver releases every
//     piece, so that no wait of the producer's hangs.
//   * the resolver (warp 0): its lanes clear the ring of token-start
//     positions ([256][4096] i32, global memory) at each new block and the
//     word-MRU at each chunk; lane 0 runs the resolve steps it shares with
//     K3 (rolz.cuh) with the output window: every byte goes to a window
//     of the block's latest 128 KiB in shared memory, and a match whose
//     source is in the window reads it there.  It walks a chunk in batches
//     of kBatch tokens.  Before a batch it releases the pieces behind it,
//     waits for the pieces the batch reads (its steps read at most three
//     tokens ahead) and moves the window's new bytes to the output by bulk
//     copies (`Flusher`); the steps of a batch test nothing but the end of
//     the batch, and read each token, its match index and the next token
//     (for the next match's ring slot, loaded ahead) from the token ring.
//
// Dynamic shared memory: the u8 sticky-MTF table (64 KB, from mtf0, to
// mtf_out after the last chunk), the window, the token ring, the word-MRU
// and the ring heads.  The launch asks for the least shared memory that
// holds them, the rest of the SM's 256 KB being L1.  The TPU kernel's
// token slabs, one-byte-per-word rows, flush bursts and literal fast loop
// are its layout and scheduling and are not ported.
//
// A block's first two bytes take one token each, whatever its value (the
// low byte is the output), as the JAX split decoder does.  Rejections
// (resolve_kernel.py:226-227,311,414): midx == 0, an unwritten slot,
// src >= opos, a match whose index would lie at or past rlen, opos > encpos,
// opos != encpos at the chunk's end.  Every overrun check runs before any
// byte is written, so a corrupt stream never writes past its block.  After
// the first bad chunk the rest are marked bad and not decoded, and the
// producer stops.
#include "async.cuh"
#include "rolz.cuh"

namespace {

using namespace zlt;

constexpr int kWarp = 32;
constexpr int kMru = 512;          // [ctx][2] words, newest first
using Res = ResolverT<17>;          // the output window: 128 KiB
constexpr int kWin = Res::kWin;
constexpr int kPiece = 1024;       // tokens a bulk copy (4 KB)
constexpr int kPieces = 4;         // pieces in the token ring
constexpr int kTok = kPiece * kPieces;
constexpr int kBatch = 256;        // tokens between the resolver's waits
constexpr int kSmem = 65536 + kWin + Res::kMirror + 4 * (kTok + kMru + 256);

// A batch's steps take at most kBatch + 1 tokens, so write at most
// kBatchBytes between two flushes (`Flusher`): a source more than kWin back
// is in the output when read, and no slot is rewritten before its group has
// read it.
constexpr int kBatchBytes = (kBatch + 2) / 2 * kMatchMax;
static_assert(2 * (kBatchBytes + 15) + kMatchMax < kWin);
static_assert(kBatch + 3 <= kPiece);   // a batch reads at most two pieces
using Flush = Flusher<kWin>;

// The pieces of a chunk's token window.
__device__ __forceinline__ int pieces_of(const Window& w) {
  return (w.bytes + 4 * kPiece - 1) / (4 * kPiece);
}

// Warp 1, lane 0: stage every chunk's tokens, piece by piece.  Ends early
// once the resolver has stopped (it then releases every piece, so no wait
// here hangs); publishes the pieces issued (plus one) in done.
__device__ void produce(const int* __restrict__ tokens,
                        const int64_t* __restrict__ tok_off,
                        const int* __restrict__ rlens, int n_chunks,
                        int* s_tok, uint64_t* s_full, uint64_t* s_empty,
                        int& stop, int& done) {
  int p = 0;   // pieces issued
  for (int c = 0; c < n_chunks; ++c) {
    const Window w = window_of(tokens + tok_off[c], rlens[c]);
    const int np = pieces_of(w);
    for (int k = 0; k < np && !flag_get(stop); ++k, ++p) {
      const int slot = p % kPieces;
      if (p >= kPieces)   // the slot's last piece must be released
        mbar_wait(&s_empty[slot], (p / kPieces - 1) & 1);
      bulk_load(s_tok + slot * kPiece, w.start + 4 * kPiece * k,
                min(4 * kPiece, w.bytes - 4 * kPiece * k), &s_full[slot]);
    }
  }
  flag_set(done, p + 1);
}

__global__ void __launch_bounds__(2 * kWarp)
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
  uint8_t* s_win = smem + 65536;
  int* s_tok = reinterpret_cast<int*>(smem + 65536 + kWin + Res::kMirror);
  int* s_mru = s_tok + kTok;
  int* s_head = s_mru + kMru;
  __shared__ int s_nxt[256];
  __shared__ int s_stop, s_done;
  __shared__ __align__(8) uint64_t s_full[kPieces], s_empty[kPieces];
  const int tid = threadIdx.x, lane = tid % kWarp;

  for (int i = tid; i < 65536 / 16; i += 2 * kWarp)
    reinterpret_cast<uint4*>(s_mtf)[i] = reinterpret_cast<const uint4*>(mtf0)[i];
  for (int i = tid; i < 256; i += 2 * kWarp) s_nxt[i] = mtfnext[i];
  if (tid == 0) {
    s_stop = 0;
    s_done = 0;
    for (int i = 0; i < kPieces; ++i) {
      mbar_init(&s_full[i], 1);
      mbar_init(&s_empty[i], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid >= kWarp) {
    if (lane == 0)
      produce(tokens, tok_off, rlens, n_chunks, s_tok, s_full, s_empty,
              s_stop, s_done);
    return;
  }

  // the resolver warp
  int taken = 0;       // pieces waited for (lane 0)
  int opos_carry = 0;
  bool stop = false;
  Flush fl{out, s_win, 0, 0};
  for (int c = 0; c < n_chunks; ++c) {
    if (stop) {  // an earlier chunk was bad: the rest is not decoded
      if (lane == 0) {
        int* st = status + 4 * c;
        st[0] = 0; st[1] = 0; st[2] = 1; st[3] = 0;
      }
      continue;
    }
    const int new_block = new_blocks[c];
    for (int i = lane; i < kMru; i += kWarp) s_mru[i] = 0;
    if (new_block) {
      for (int i = lane; i < 256; i += kWarp) s_head[i] = 0;
      int4* r4 = reinterpret_cast<int4*>(ring);
      for (int i = lane; i < 256 * kRing / 4; i += kWarp)
        r4[i] = make_int4(0, 0, 0, 0);
    }
    __syncwarp();
    if (lane == 0) {
      const int rlen = rlens[c];
      const Window w = window_of(tokens + tok_off[c], rlen);
      int np = pieces_of(w);
      // token n of the chunk is s_tok[(base + n) % kTok], in piece (n +
      // shift) / kPiece; pieces [p0, p0 + have) are in, [p0, p0 + freed)
      // released
      const int p0 = taken;
      const int base = (p0 % kPieces) * kPiece + w.shift;
      int have = 0, freed = 0;
      auto tok = [&](int n) { return s_tok[(base + n) & (kTok - 1)]; };
      const int opos0 = new_block ? 0 : opos_carry;
      uint8_t* o = out + out_base[c];
      if (opos0 == 0)
        fl = Flush{o, s_win, static_cast<int>(reinterpret_cast<uintptr_t>(o) & 15), 0};
      Res r{o, ring, s_head, s_mru, s_mtf, s_nxt, opos0,
            opos0 >= 1 ? fl.at(opos0 - 1) : 0,
            opos0 >= 2 ? fl.at(opos0 - 2) : 0, encposs[c]};
      r.win = s_win;
      r.wofs = fl.wofs;
      int tpos = 0;
      bool bad = false;
      // the token at n and its index word, for the resolver to load a coming
      // match's ring slot ahead (-1: past the chunk)
      auto peek = [&](int n, int& nm) {
        if (n + 1 >= rlen) return -1;
        nm = tok(n + 1);
        return tok(n);
      };
      while (tpos < rlen && !bad) {
        const int end = min(tpos + kBatch, rlen);
        for (; (freed + 1) * kPiece - w.shift <= tpos; ++freed)
          mbar_arrive(&s_empty[(p0 + freed) % kPieces]);
        for (const int last = min(end + 2, rlen - 1);
             have * kPiece - w.shift <= last; ++have) {
          const int p = p0 + have;
          mbar_wait(&s_full[p % kPieces], (p / kPieces) & 1);
        }
        fl.to(r.opos, false);
        while (tpos < end) {
          const int t = tok(tpos);
          int nm = 0;
          if (r.opos <= 1) {  // the two raw head bytes of a block: one token each
            const int nt = peek(tpos + 1, nm);
            if (!r.head_byte(t, nt, nm)) { bad = true; break; }
            ++tpos;
          } else if (t >= 258) {  // match: the next token is its ring index
            if (tpos + 1 >= rlen) { bad = true; break; }
            const int nt = peek(tpos + 2, nm);
            if (!r.match(t, tok(tpos + 1), nt, nm)) { bad = true; break; }
            tpos += 2;
          } else {
            const int nt = peek(tpos + 1, nm);
            if (!r.simple(t, nt, nm)) { bad = true; break; }
            ++tpos;
          }
        }
      }
      bad = bad || r.opos != r.encpos;
      int* st = status + 4 * c;
      st[0] = r.opos;
      st[1] = tpos;
      st[2] = bad ? 1 : 0;
      st[3] = opos0;
      opos_carry = r.opos;
      stop = bad;
      // the block's last chunk (or a bad one)
      if (bad || c + 1 == n_chunks || new_blocks[c + 1]) fl.to(r.opos, true);
      if (bad) {
        flag_set(s_stop, 1);
        np = have;
      } else {   // the chunk's pieces past its last token, if any
        for (; have < np; ++have) {
          const int p = p0 + have;
          mbar_wait(&s_full[p % kPieces], (p / kPieces) & 1);
        }
      }
      for (; freed < np; ++freed) mbar_arrive(&s_empty[(p0 + freed) % kPieces]);
      taken = p0 + np;
    }
    stop = __shfl_sync(0xFFFFFFFFu, stop, 0);
    __syncwarp();
  }
  // every staged piece lands before the CTA exits; after a bad chunk each
  // is released, so that the producer can reach its stop test
  if (lane == 0) {
    for (int issued; !(issued = flag_get(s_done)) || taken < issued - 1;) {
      if (mbar_try_wait(&s_full[taken % kPieces], (taken / kPieces) & 1)) {
        mbar_arrive(&s_empty[taken % kPieces]);
        ++taken;
      }
    }
  }
  __syncwarp();
  for (int i = lane; i < 65536 / 16; i += kWarp)
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
  cudaFuncSetAttribute(resolve_kernel,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxL1);
  resolve_kernel<<<1, 2 * kWarp, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tokens), static_cast<const int64_t*>(tok_off),
      static_cast<const int*>(rlens), static_cast<const int*>(encpos),
      static_cast<const int*>(new_block),
      static_cast<const int64_t*>(out_base),
      static_cast<const uint8_t*>(mtf0), static_cast<const int*>(mtfnext),
      n_chunks, static_cast<uint8_t*>(out), static_cast<int*>(ring),
      static_cast<int*>(status), static_cast<uint8_t*>(mtf_out));
  return static_cast<int>(cudaGetLastError());
}
