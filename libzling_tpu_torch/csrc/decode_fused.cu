// K3: fused chunk decode -- LSB-first canonical Huffman bit reader feeding
// the ROLZ resolve state machine, one serial pass over every chunk of a
// stream.  Replaces libzling_tpu/ops/decode_fused.py::_fused_kernel; the
// plain version and the source note are in ops/decode_fused.py.
//
// One CTA of two warps per stream; no token array in global memory.  It
// has K2's form (resolve.cu) with K1's reader in place of K2's bulk copies
// of tokens:
//
//   * the producer (warp 1): its lanes load a chunk's tables (12-bit
//     alphabet-1 LUT, canonical tiers for 13..15-bit codes, the 8-bit
//     alphabet-2 LUT) into shared memory, then lane 0 runs K1's reader
//     (huffman.cuh) over the chunk with the fused decoder's reading rules
//     and writes one entry a unit: the symbol and, for a match, its index;
//     after the chunk's last unit an end entry (kEnd, or kOverrun when the
//     reader went past n_words); on an invalid code, a read past n_words or
//     a match without room for its index, kError, and it stops.  A block's
//     raw head bytes (the first 2 - opos0 units of a chunk, opos0 being the
//     previous chunk's encpos or 0 at a new block) read no index bits.
//     The entries go into a ring of kPieces pieces of kPiece entries in
//     shared memory; a chunk starts a new piece, and its last piece goes
//     over however full it is, marked last (`s_last`).  Piece p goes to
//     slot p mod kPieces once the resolver has released the slot's last
//     piece (`s_empty`: a producer that is ahead sleeps there) and
//     completes `s_full` of its slot.  It tests the stop flag once a
//     piece; after a bad chunk the resolver releases every piece, so that
//     no wait of the producer's hangs.
//   * the resolver (warp 0): its lanes clear the ring of token-start
//     positions ([256][4096] i32, global memory) at each new block and the
//     word-MRU at each chunk; lane 0 runs the resolve steps it shares with
//     K2 (rolz.cuh) with the output window: every byte goes to a window of
//     the block's latest 128 KiB in shared memory, and a match whose
//     source is in the window reads it there.  It walks a chunk in batches
//     of kBatch entries, whole pieces from the chunk's first.  Before a
//     batch it releases the pieces behind it, waits for the batch's pieces
//     and, unless the chunk's last is among them, the next one (a step
//     reads the entry after its own, so as to load a coming match's ring
//     slot ahead), and
//     moves the window's new bytes to the output by bulk copies
//     (`Flusher`); the steps of a batch test nothing but the end of the
//     batch and the end entry.  A chunk's last bytes go out before its
//     status is written.
//
// Dynamic shared memory: the u8 sticky-MTF table (64 KB, from mtf0), the
// window, the mbarriers, the chunk's reader tables, the word-MRU, the ring
// heads, MTF_NEXT, the entry ring and its flags: kSmem, at most the
// card's opt-in of 227 KB.
//
// The resolver writes every chunk's status (opos, tokens, bad, opos at the
// chunk's start, matches, matches whose source it read in the window).
// Every overrun check runs before any byte is written, so a corrupt chunk
// never writes past its block; after the first bad chunk the rest are
// marked bad and not decoded, and the producer stops.
#include "async.cuh"
#include "huffman.cuh"
#include "rolz.cuh"

namespace {

using namespace zlt;

constexpr int kWarp = 32;
constexpr int kMru = 512;        // [ctx][2] words, newest first
using Res = ResolverT<17>;        // the output window: 128 KiB
constexpr int kWin = Res::kWin;
using Flush = Flusher<kWin>;
constexpr int kPiece = 128;      // entries a piece
constexpr int kPieces = 16;      // pieces in the entry ring
constexpr int kTok = kPiece * kPieces;
constexpr int kBatch = kPiece;   // entries between the resolver's waits
static_assert(kBatch % kPiece == 0 && kBatch / kPiece + 2 <= kPieces);
constexpr int kStatus = 6;       // status words a chunk
constexpr int kError = -1;       // the reader rejected the chunk here
constexpr int kEnd = -2;         // the chunk's tokens are all read
constexpr int kOverrun = -3;     // ... but the reader went past n_words
constexpr int kInts = kLut1 + kOrder + kLut2 + kTier + kMru + 256 + 256 +
                      kTok + kPieces + 2;
constexpr int kSmem = 65536 + kWin + Res::kMirror + 8 * 2 * kPieces + 4 * kInts;
static_assert(kSmem <= 232448, "over the H100's shared memory a block");
static_assert((kWin + Res::kMirror) % 16 == 0);

// A batch's kBatch steps take one entry each, a match of at most kMatchMax
// bytes: between two flushes the resolver writes at most kBatchBytes, so a
// source more than kWin back is in the output when read, and no slot is
// rewritten before its group has read it.
constexpr int kBatchBytes = kBatch * kMatchMax;
static_assert(2 * (kBatchBytes + 15) + kMatchMax < kWin);

// Warp 1: decode every chunk into entries, piece by piece.  Ends early once
// the resolver has stopped; publishes the pieces handed over (plus one) in
// done.
__device__ void produce(const int* __restrict__ meta,
                        const int* __restrict__ order1,
                        const int* __restrict__ lut1,
                        const int* __restrict__ lut2,
                        const uint32_t* __restrict__ words, int n_chunks,
                        int* s_lut1, int* s_order, int* s_lut2, int* s_tier,
                        int* s_tok, int* s_last, uint64_t* s_full,
                        uint64_t* s_empty, int& stop, int& done, int lane) {
  int p = 0, w = 0;   // pieces handed over; entries in piece p (lane 0)
  bool quit = false;
  // one entry (lane 0), the chunk's end entry when `end`; false once the
  // resolver has stopped
  auto push = [&](int e, bool end) {
    const int slot = p % kPieces;
    if (w == 0) {   // a new piece: its slot's last piece must be released
      if (flag_get(stop)) return false;
      if (p >= kPieces) mbar_wait(&s_empty[slot], (p / kPieces - 1) & 1);
    }
    s_tok[slot * kPiece + w] = e;
    if (++w == kPiece || end) {
      s_last[slot] = end;
      mbar_arrive(&s_full[slot]);
      ++p;
      w = 0;
    }
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
          ok = push(t, false);
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
        ok = push(t | midx << 16, false);
        emitted += 2;
      }
      if (ok && last == kEnd && wpos * 32 - nbits > n_words * 32)
        last = kOverrun;
      quit = !ok || !push(last, true) || last == kError;
    }
    quit = __shfl_sync(0xFFFFFFFFu, quit, 0);
  }
  if (lane == 0) flag_set(done, p + 1);
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
  uint8_t* s_win = smem + 65536;
  uint64_t* s_full =
      reinterpret_cast<uint64_t*>(smem + 65536 + kWin + Res::kMirror);
  uint64_t* s_empty = s_full + kPieces;
  int* s_lut1 = reinterpret_cast<int*>(s_empty + kPieces);
  int* s_order = s_lut1 + kLut1;
  int* s_lut2 = s_order + kOrder;
  int* s_tier = s_lut2 + kLut2;
  int* s_mru = s_tier + kTier;
  int* s_head = s_mru + kMru;
  int* s_nxt = s_head + 256;
  int* s_tok = s_nxt + 256;
  int* s_last = s_tok + kTok;
  int& s_stop = s_last[kPieces];
  int& s_done = s_last[kPieces + 1];
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
    produce(meta, order1, lut1, lut2, words, n_chunks, s_lut1, s_order,
            s_lut2, s_tier, s_tok, s_last, s_full, s_empty, s_stop, s_done,
            lane);
    return;
  }

  // the resolver warp
  int taken = 0;       // pieces waited for and released (lane 0)
  int opos_carry = 0;
  bool stop = false;
  Flush fl{out, s_win, 0, 0};
  for (int c = 0; c < n_chunks; ++c) {
    int* st = status + kStatus * c;
    if (stop) {  // an earlier chunk was bad: the rest is not decoded
      if (lane == 0) {
        st[0] = 0; st[1] = 0; st[2] = 1; st[3] = 0; st[4] = 0; st[5] = 0;
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
      // entry n of the chunk is s_tok[(base + n) % kTok], in piece n /
      // kPiece of the chunk; pieces [0, have) of the chunk are in, [0,
      // freed) released, and `last` once the chunk's last one is in
      const int p0 = taken;
      const int base = (p0 % kPieces) * kPiece;
      auto tok = [&](int n) { return s_tok[(base + n) & (kTok - 1)]; };
      int have = 0, freed = 0;
      bool last = false;
      const int opos0 = new_block ? 0 : opos_carry;
      uint8_t* o = out + out_base[c];
      if (opos0 == 0)
        fl = Flush{o, s_win, static_cast<int>(reinterpret_cast<uintptr_t>(o) & 15), 0};
      Res r{o, ring, s_head, s_mru, s_mtf, s_nxt, opos0,
            opos0 >= 1 ? fl.at(opos0 - 1) : 0,
            opos0 >= 2 ? fl.at(opos0 - 2) : 0, m[3]};
      r.win = s_win;
      r.wofs = fl.wofs;
      int n = 0, e = 0;   // entries walked; the entry at n
      bool bad = false;
      for (bool more = true; more;) {
        for (; freed < n / kPiece; ++freed)
          mbar_arrive(&s_empty[(p0 + freed) % kPieces]);
        for (; !last && have <= (n + kBatch) / kPiece; ++have) {
          const int p = p0 + have;
          mbar_wait(&s_full[p % kPieces], (p / kPieces) & 1);
          last = s_last[p % kPieces];
        }
        fl.to(r.opos, false);
        if (n == 0) e = tok(0);
        for (const int end = n + kBatch; n < end; ++n) {
          if (e < 0) { more = false; break; }   // the chunk's end entry
          const int en = tok(n + 1);            // the entry after it
          const int nt = en >= 0 ? (en & 0xFFFF) : -1, nm = en >> 16;
          const int t = e & 0xFFFF;
          const bool ok = r.opos <= 1 ? r.head_byte(t, nt, nm)   // raw head
                          : t >= 258 ? r.match(t, e >> 16, nt, nm)  // match
                                     : r.simple(t, nt, nm);
          if (!ok) { bad = true; more = false; break; }
          e = en;
        }
      }
      // the tokens read: an entry each, a match two, and a match that
      // failed its checks too
      const int emitted = n + r.matches +
          (bad && r.opos > 1 && (e & 0xFFFF) >= 258 ? 2 : 0);
      bad = bad || e != kEnd || r.opos != r.encpos;
      fl.to(r.opos, true);
      st[0] = r.opos;
      st[1] = emitted;
      st[2] = bad ? 1 : 0;
      st[3] = opos0;
      st[4] = r.matches;
      st[5] = r.near;
      opos_carry = r.opos;
      stop = bad;
      if (bad) flag_set(s_stop, 1);
      for (; freed < have; ++freed)
        mbar_arrive(&s_empty[(p0 + freed) % kPieces]);
      taken = p0 + have;
    }
    stop = __shfl_sync(0xFFFFFFFFu, stop, 0);
    __syncwarp();
  }
  // after a bad chunk the producer may have handed over pieces that were
  // never waited for, and may wait for a slot: release every piece, so
  // that it reaches its stop test
  if (lane == 0) {
    for (int issued; !(issued = flag_get(s_done)) || taken < issued - 1;) {
      if (mbar_try_wait(&s_full[taken % kPieces], (taken / kPieces) & 1)) {
        mbar_arrive(&s_empty[taken % kPieces]);
        ++taken;
      }
    }
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
