// The ROLZ resolve state machine shared by K2 (resolve.cu) and K3
// (decode_fused.cu), so the two decoders cannot drift apart: a block's raw
// head bytes, sticky-MTF literals, word-MRU hits and ring matches, with
// the format's rejections.  Each step checks before it writes, so a
// corrupt chunk never writes past its block's encpos.
#pragma once

#include "common.cuh"

namespace zlt {

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

struct Resolver {
  uint8_t* o;          // the block's output bytes
  int* ring;           // [256][kRing] token-start positions, 0 = unwritten
  int* head;           // [256] ring heads
  int* mru;            // [256][2] word-MRU, newest first
  uint8_t* mtf;        // [256][256] rank -> byte per context
  const int* nxt;      // MTF_NEXT: rank i swaps with rank nxt[i]
  int opos, l1, l2, encpos;

  // A block's raw head byte: the token's low 8 bits.  False past encpos.
  __device__ __forceinline__ bool head_byte(int t) {
    if (opos + 1 > encpos) return false;
    const int b = t & 255;
    o[opos++] = static_cast<uint8_t>(b);
    l2 = l1;
    l1 = b;
    return true;
  }

  // A match of symbol t (>= 258) from ring index midx of context l1.
  // False on midx == 0, an unwritten slot, src >= opos or a copy past
  // encpos.
  __device__ __forceinline__ bool match(int t, int midx) {
    const int ctx = l1;
    int* rg = ring + ctx * kRing;
    const int h = (head[ctx] + 1) & (kRing - 1);
    head[ctx] = h;
    const int src = rg[(h - midx) & (kRing - 1)];
    rg[h] = opos;
    const int mlen = t - 258 + kMatchMin;
    if (midx == 0 || src == 0 || src >= opos || opos + mlen > encpos)
      return false;
    copy_match(o, opos, src, mlen);
    opos += mlen;
    const int cu = o[opos - 3];
    l2 = o[opos - 2];
    l1 = o[opos - 1];
    const int wu = (l2 << 8) | l1;
    if (mru[cu * 2] != wu) {
      mru[cu * 2 + 1] = mru[cu * 2];
      mru[cu * 2] = wu;
    }
    return true;
  }

  // A literal (t < 256: the sticky-MTF rank of its low 8 bits) or a
  // word-MRU hit (256: newest, 257: second).  False past encpos.
  __device__ __forceinline__ bool simple(int t) {
    const int ctx = l1;
    if (opos + (t < 256 ? 1 : 2) > encpos) return false;
    const int h = (head[ctx] + 1) & (kRing - 1);
    head[ctx] = h;
    ring[ctx * kRing + h] = opos;
    if (t < 256) {  // rank -> byte, then swap the rank with MTF_NEXT's
      const int r = t & 255;
      uint8_t* row = mtf + ctx * 256;
      const int lit = row[r];
      const int j = nxt[r];
      row[r] = row[j];
      row[j] = static_cast<uint8_t>(lit);
      o[opos++] = static_cast<uint8_t>(lit);
      mru[l2 * 2 + 1] = mru[l2 * 2];
      mru[l2 * 2] = (ctx << 8) | lit;
      l2 = ctx;
      l1 = lit;
    } else {
      const int wv = mru[ctx * 2 + (t & 1)];
      const int b0 = (wv >> 8) & 255, b1 = wv & 255;
      o[opos] = static_cast<uint8_t>(b0);
      o[opos + 1] = static_cast<uint8_t>(b1);
      if (t == 257) {
        mru[ctx * 2 + 1] = mru[ctx * 2];
        mru[ctx * 2] = wv;
      }
      opos += 2;
      l2 = b0;
      l1 = b1;
    }
    return true;
  }
};

}  // namespace zlt
