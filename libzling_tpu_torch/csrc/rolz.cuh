// The ROLZ resolve state machine shared by K2 (resolve.cu) and K3
// (decode_fused.cu), so the two decoders cannot drift apart: a block's raw
// head bytes, sticky-MTF literals, word-MRU hits and ring matches, with
// the format's rejections.  Each step checks before it writes, so a
// corrupt chunk never writes past its block's encpos.
//
// The chain from one token to the next runs through the context byte: a
// match's ring slot is read under the context its previous token left.  So
// each step settles its context first -- a match takes its last three
// bytes from the bytes it copies, loaded from where they already were --
// and, when the caller says the next token is a match (nt, nmidx), loads
// that match's ring slot at once (`ahead`), before its own stores: the
// copy, the MTF swap, the word-MRU update.  The caller passes nt < 0 when
// the next token is unknown or is no match.
//
// The output window: every byte of the block's output goes to a circular
// window of 1 << kWinLog bytes in shared memory, at slot (position + wofs)
// mod the window's size (the first kMirror slots also past its end), and
// to nowhere else: the caller moves the window to the output by bulk
// copies (`Flusher`), so that a source further back than the window is in
// the output by the time it is read.  A match whose source lies at most
// that far back (d = opos - src <= size) reads its bytes in the window.
// The window needs no reset: positions count from the block's start and a
// source lies in the block before opos, so d <= size means that its slot
// still holds that byte.  Each step counts the matches it resolved and
// those whose source it read in the window (`matches`, `near`).
#pragma once

#include "async.cuh"
#include "common.cuh"

namespace zlt {

// Forward copy with the format's overlap semantics (dp[k] = sp[k], byte by
// byte, where sp == dp - d when the two overlap).  Sources at least 8
// bytes back are moved in groups of 8 independent loads; a shorter period
// d is repeated from registers, without reading back the bytes just
// stored.
__device__ __forceinline__ void copy_from(uint8_t* dp, const uint8_t* sp,
                                          int d, int n) {
  int k = 0;
  if (d >= 8) {
    for (; k + 8 <= n; k += 8) {
      uint8_t v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = sp[k + q];
#pragma unroll
      for (int q = 0; q < 8; ++q) dp[k + q] = v[q];
    }
    for (; k < n; ++k) dp[k] = sp[k];
    return;
  }
  uint64_t pat = 0;
#pragma unroll
  for (int q = 0; q < 7; ++q)
    if (q < d) pat |= static_cast<uint64_t>(sp[q]) << (8 * q);
  for (int j = 0; k < n; ++k) {
    dp[k] = static_cast<uint8_t>(pat >> (8 * j));
    j = j + 1 == d ? 0 : j + 1;
  }
}

// out[opos + k] = out[src + k] for k < mlen
__device__ __forceinline__ void copy_match(uint8_t* o, int opos, int src,
                                           int mlen) {
  copy_from(o + opos, o + src, opos - src, mlen);
}

template <int kWinLog>
struct ResolverT {
  static constexpr int kWin = 1 << kWinLog;
  // the window's first slots again past its end, so that a match's bytes
  // (at most 259) lie at consecutive addresses wherever it starts
  static constexpr int kMirror = 272;

  uint8_t* o;          // the block's output bytes
  int* ring;           // [256][kRing] token-start positions, 0 = unwritten
  int* head;           // [256] ring heads
  int* mru;            // [256][2] word-MRU, newest first
  uint8_t* mtf;        // [256][256] rank -> byte per context
  const int* nxt;      // MTF_NEXT: rank i swaps with rank nxt[i]
  int opos, l1, l2, encpos;
  int pend_h = -1;     // the next match's ring slot, claimed by `ahead`
  int pend_src = 0;    // and the position it holds
  uint8_t* win = nullptr;  // [kWin + kMirror] the latest output bytes
  int wofs = 0;            // position p's slot: (p + wofs) mod kWin
  int matches = 0;         // matches resolved
  int near = 0;            // ... of them with their source in the window

  // Output byte p := b: its window slot and that slot's mirror.
  __device__ __forceinline__ void put(int p, int b) {
    const int s = (p + wofs) & (kWin - 1);
    win[s] = static_cast<uint8_t>(b);
    if (s < kMirror) win[s + kWin] = static_cast<uint8_t>(b);
  }

  // A match's mlen bytes from sp[] to position at; v[] holds the first
  // ones when d >= first.  In the window straight through when its slots
  // neither wrap nor reach the mirrored head, else byte by byte.
  __device__ __forceinline__ void store(int at, const uint8_t* sp, int d,
                                        int mlen, int first,
                                        const uint8_t* v) {
    const int s = (at + wofs) & (kWin - 1);
    if (s < kMirror || s + mlen > kWin) {
      for (int k = 0; k < mlen; ++k) put(at + k, sp[k]);
      return;
    }
    uint8_t* dp = win + s;
    if (d >= first) {
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (k < first) dp[k] = v[k];
      if (mlen > 16) copy_from(dp + 16, sp + 16, d, mlen - 16);
    } else {
      copy_from(dp, sp, d, mlen);
    }
  }

  // The current token's context is final and its ring insert done: if the
  // next token is a match (not a head byte), load its ring slot now.
  __device__ __forceinline__ void ahead(int nt, int nmidx) {
    if (nt >= 258 && opos > 1) {
      pend_h = (head[l1] + 1) & (kRing - 1);
      pend_src = ring[l1 * kRing + ((pend_h - nmidx) & (kRing - 1))];
    }
  }

  // A block's raw head byte: the token's low 8 bits.  False past encpos.
  __device__ __forceinline__ bool head_byte(int t, int nt, int nmidx) {
    if (opos + 1 > encpos) return false;
    const int b = t & 255;
    put(opos++, b);
    l2 = l1;
    l1 = b;
    ahead(nt, nmidx);
    return true;
  }

  // A match of symbol t (>= 258) from ring index midx of context l1.
  // False on midx == 0, an unwritten slot, src >= opos or a copy past
  // encpos.
  __device__ __forceinline__ bool match(int t, int midx, int nt, int nmidx) {
    const int ctx = l1;
    int* rg = ring + ctx * kRing;
    int h, src;
    if (pend_h >= 0) {  // loaded ahead by the previous token
      h = pend_h;
      src = pend_src;
      pend_h = -1;
    } else {
      h = (head[ctx] + 1) & (kRing - 1);
      src = rg[(h - midx) & (kRing - 1)];
    }
    head[ctx] = h;
    rg[h] = opos;
    const int mlen = t - 258 + kMatchMin;
    if (midx == 0 || src == 0 || src >= opos || opos + mlen > encpos)
      return false;
    // the copy's first bytes (up to 16) and its last three, the next
    // context, loaded at once from where they already are: output byte k
    // of the copy is the source's byte k mod d, d = opos - src
    const int d = opos - src;
    // source byte k: sp[k], from the window when it is near (its mirror
    // keeps sp[0..258] in it), else from the output
    const uint8_t* sp = o + src;
    if (d <= kWin) sp = win + ((src + wofs) & (kWin - 1));
    const int k3 = mlen - 3, k2 = mlen - 2, k1 = mlen - 1;
    const int cu = sp[k3 < d ? k3 : k3 % d];
    const int b2 = sp[k2 < d ? k2 : k2 % d];
    const int b1 = sp[k1 < d ? k1 : k1 % d];
    const int first = min(mlen, 16);
    uint8_t v[16];
    if (d >= first) {
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (k < first) v[k] = sp[k];
    }
    const int m0 = mru[cu * 2];
    const int at = opos;
    opos += mlen;
    l2 = b2;
    l1 = b1;
    ahead(nt, nmidx);
    store(at, sp, d, mlen, first, v);
    const int wu = (b2 << 8) | b1;
    if (m0 != wu) {
      mru[cu * 2 + 1] = m0;
      mru[cu * 2] = wu;
    }
    ++matches;          // off the chain: after every load and store
    near += d <= kWin;
    return true;
  }

  // A literal (t < 256: the sticky-MTF rank of its low 8 bits) or a
  // word-MRU hit (256: newest, 257: second).  False past encpos.  Every
  // shared-memory load is issued before the first store.
  __device__ __forceinline__ bool simple(int t, int nt, int nmidx) {
    const int ctx = l1;
    if (opos + (t < 256 ? 1 : 2) > encpos) return false;
    const int h = (head[ctx] + 1) & (kRing - 1);
    head[ctx] = h;
    ring[ctx * kRing + h] = opos;
    if (t < 256) {  // rank -> byte, then swap the rank with MTF_NEXT's
      const int r = t & 255;
      uint8_t* row = mtf + ctx * 256;
      const int lit = row[r], j = nxt[r];
      const int prev = l2;
      const int m0 = mru[prev * 2];
      const int rj = row[j];
      put(opos++, lit);
      l2 = ctx;
      l1 = lit;
      ahead(nt, nmidx);
      row[r] = static_cast<uint8_t>(rj);
      row[j] = static_cast<uint8_t>(lit);
      mru[prev * 2 + 1] = m0;
      mru[prev * 2] = (ctx << 8) | lit;
    } else {
      const int w0 = mru[ctx * 2], w1 = mru[ctx * 2 + 1];
      const int wv = t & 1 ? w1 : w0;
      const int b0 = (wv >> 8) & 255, b1 = wv & 255;
      put(opos, b0);
      put(opos + 1, b1);
      opos += 2;
      l2 = b0;
      l1 = b1;
      ahead(nt, nmidx);
      if (t == 257) {
        mru[ctx * 2 + 1] = w0;
        mru[ctx * 2] = wv;
      }
    }
    return true;
  }
};

// The window to the block's output: positions [0, done) are issued, a
// group of bulk copies at each call of `to` (the block's first bytes up to
// a 16-byte aligned address, and its last ones, byte by byte), and after
// each group all but the newest are complete.  So where the caller writes
// at most B bytes between two calls, at most 2 (B + 15) bytes are not yet
// in the output, and a source more than that plus a match back is in the
// output when it is read; each kernel asserts its B against kWin.
template <int kWin>
struct Flusher {
  uint8_t* o;
  const uint8_t* win;
  int wofs, done;

  __device__ __forceinline__ uint8_t at(int p) const {
    return win[(p + wofs) & (kWin - 1)];
  }

  // Issue [done, q) (q rounded down to 16 bytes unless last); last: all
  // of it, every group complete.
  __device__ __forceinline__ void to(int q, bool last) {
    for (; done < q && ((done + wofs) & 15); ++done) o[done] = at(done);
    for (const int end = done + ((q - done) & ~15); done < end;) {
      const int slot = (done + wofs) & (kWin - 1);
      const int n = min(end - done, kWin - slot);
      bulk_store(o + done, win + slot, n);
      done += n;
    }
    if (last) {
      for (; done < q; ++done) o[done] = at(done);
      bulk_commit();
      bulk_wait<0>();
    } else {
      bulk_commit();
      bulk_wait<1>();
    }
  }
};

}  // namespace zlt
