// K1: per-chunk Huffman entropy decode -- every chunk's LSB-first canonical
// Huffman bitstream to its token array.  Replaces
// libzling_tpu/ops/entropy_kernel.py::_decode_chunk_kernel (:190, called at
// :407); the plain version is ops/entropy_kernel.py::decode_chunks_plain,
// the serial walk, whose tokens and status rows (emitted, bit_pos, bad)
// this kernel gives exactly, for valid and corrupt chunks alike.
//
// Bound: the bytes it must move (tables, payload words, tokens: 60.6 MB at
// the 32 MiB e0 shapes, 0.018 ms at 3.35 TB/s).  What holds it back is the
// walk: one chain of dependent steps a unit (LUT load -> code length ->
// shift -> next LUT address), ~210 cycles on one thread (probe PS10).  A
// walk from bit 0 serialises a chunk, and the e0 stream has 48 chunks of
// up to 262,144 tokens: one CTA a chunk took ~33 ms on 48 of 132 SMs.
//
// Design: each chunk is cut into segments of kSegBits payload bits and its
// segments are decoded in parallel, by four launches behind the one entry:
//
//   0. plan (one CTA): each chunk's segment count and first segment, and
//      which chunk each CTA ("item", kSegsPerItem segments) of phases 1
//      and 3 serves.
//   1. transfer (a CTA an item, a warp a segment at a time): a unit takes
//      at most 31 bits (huffman.cuh), so the walk's first unit boundary at
//      or past a segment's start lies within 31 bits of it.  Lane e walks
//      from the start + e to the segment's end and records its exit offset
//      past the end, the parity of its unit count and its tokens -- or
//      that it met a missing code (dead).  Walks that meet go on as one
//      walk, but lanes on one walk a unit or more apart stay apart in the
//      warp's lock step (a join table that stopped them cost more than
//      the divergence it saved, in development builds).
//   2. scan (a CTA a chunk): composes the rows from entry 0 of segment 0,
//      staged kScanRows rows at a time: each segment's true entry, the
//      tokens before it and the parity of the units before it, up to the
//      stop -- the first segment whose true walk is dead or reaches rlen,
//      else the last.  Only the last segment holds a bit at which the
//      walk's `wpos > n_words` test can hold (32 * n_words - 31 and on: it
//      runs to 32 * n_words + 32, so up to kSegBits + 63 bits), and before
//      the stop the serial rules never differ from the transfer walk's (a
//      match takes its index while emitted + 1 < rlen), so no row needs
//      them.
//   3. write (a CTA an item, a thread a segment): each segment up to the
//      stop re-decodes from its true entry and writes its tokens at
//      tok_off[c] + its prefix; the stop segment walks on under the serial
//      rules -- an index only when emitted + 1 < rlen; a missing code
//      emits 0 (alphabet 1: one bit) and is bad; `wpos > n_words` after
//      every unit of odd index (the unit parity says which) and after the
//      last -- and writes the status row.  Segments past the stop write
//      nothing: their tokens stay 0.
//
// kSegBits = 2048 gives ~42,700 segments at e0 and kSegsPerItem = 16 puts
// two on each warp of phase 1 and 16 threads to work in phase 3: phase 1
// is issue-bound across the card whatever the split (each segment is
// walked once by a warp), and shorter segments shorten phase 3's walks
// (~150-250 units, divergent across a warp's segments) at the cost of a
// longer scan (~900 steps a chunk); the rows take 124 bytes a segment
// (5.3 MB at e0, in L2).  Every walk
// reads what the serial walk reads: at most two words past n_words, in the
// chunk's 512-byte zero pad.  The scratch comes from the wrapper, sized by
// zlt_entropy_decode_scratch from the chunk count and the words' length:
// chunks laid as pack_payload_words lays them (in order, disjoint) have at
// most 32 * words / kSegBits + C segments; if they had more, every chunk
// would be bad and nothing written past the scratch.
#include <climits>

#include "huffman.cuh"

namespace {

using namespace zlt;

constexpr int kSegBits = 2048;     // payload bits of a segment
constexpr int kEntries = 31;       // entry offsets: a unit is <= 31 bits
constexpr int kSegsPerItem = 16;   // segments of a CTA in phases 1 and 3
constexpr int kWarps = kThreads / 32;
constexpr int kScanRows = 128;     // rows phase 2 stages at a time
constexpr uint32_t kDead = 31;     // a row entry's exit field: dead

// The scratch, laid out by carve() in the wrapper's int32 tensor.
struct Scratch {
  int* flag;        // [1] the segments overflowed the scratch
  int* seg_base;    // [C + 1] first segment of each chunk
  int* item_base;   // [C + 1] first item of each chunk
  int* item_chunk;  // [max_items] chunk of each item, -1 for none
  int* stop;        // [C] stop segment, -1 for none (overflow)
  int* seg_tok;     // [max_segs] tokens before the segment (phase 2)
  int* seg_entry;   // [max_segs] entry offset | unit parity << 5
  uint32_t* rows;   // [max_segs][kEntries] exit | parity << 5 | tokens << 6
};

struct Plan {
  long long max_segs, max_items, words;
};

Plan plan_for(int n_chunks, long long n_words) {
  Plan p;
  p.max_segs = 32 * n_words / kSegBits + n_chunks + 1;
  p.max_items = p.max_segs / kSegsPerItem + n_chunks + 1;
  p.words = 1 + 2 * (n_chunks + 1LL) + p.max_items + n_chunks +
            (2 + kEntries) * p.max_segs;
  return p;
}

Scratch carve(int* base, int n_chunks, const Plan& p) {
  Scratch s;
  s.flag = base;
  s.seg_base = s.flag + 1;
  s.item_base = s.seg_base + n_chunks + 1;
  s.item_chunk = s.item_base + n_chunks + 1;
  s.stop = s.item_chunk + p.max_items;
  s.seg_tok = s.stop + n_chunks;
  s.seg_entry = s.seg_tok + p.max_segs;
  s.rows = reinterpret_cast<uint32_t*>(s.seg_entry + p.max_segs);
  return s;
}

// Segments of a chunk of n_words words: all but the last end before bit
// 32 * n_words - 31.
__device__ __forceinline__ long long segments_of(int n_words) {
  const long long b = 32LL * n_words - 31;
  return b <= kSegBits ? 1 : (b + kSegBits - 1) / kSegBits;
}

// One unit at the reader under the serial walk's rules: the alphabet-1
// symbol and, for a match symbol when `index_ok`, its index (else idx =
// -1).  A missing alphabet-1 code reads as symbol 0 of one bit, a missing
// alphabet-2 code as index 0 of no more bits; either returns true (bad).
__device__ __forceinline__ bool read_unit(
    uint64_t& acc, int& nbits, int& wpos, const uint32_t* wp,
    const int* s_lut1, const int* s_order, const int* s_lut2,
    const int* s_tier, bool index_ok, int& sym, int& idx) {
  refill(acc, nbits, wpos, wp);
  int e = peek_symbol(acc, s_lut1, s_tier, s_order);
  bool bad = e < 0;
  if (bad) e = 0;
  sym = e & 0xFFFF;
  const int hl = max((e >> 16) & 31, 1);
  acc >>= hl;
  nbits -= hl;
  idx = -1;
  if (sym >= 258 && index_ok) {
    int e2 = s_lut2[acc & 0xFF];
    if (e2 < 0) {
      bad = true;
      e2 = 0;
    }
    const int hl2 = e2 & 0xFF, blen = (e2 >> 8) & 0xFF;
    idx = (e2 >> 16) + static_cast<int>((acc >> hl2) & ((1u << blen) - 1));
    acc >>= hl2 + blen;
    nbits -= hl2 + blen;
  }
  return bad;
}

// Phase 0.
__global__ void __launch_bounds__(kThreads)
plan_kernel(const int* __restrict__ meta, int n_chunks, int max_segs,
            int max_items, Scratch s) {
  __shared__ long long s_n[kThreads];
  __shared__ long long s_carry[2];
  __shared__ int s_over;
  if (threadIdx.x == 0) s_carry[0] = s_carry[1] = 0;
  for (int c0 = 0; c0 < n_chunks; c0 += kThreads) {
    const int c = c0 + threadIdx.x;
    __syncthreads();
    s_n[threadIdx.x] =
        c < n_chunks ? segments_of(meta[static_cast<size_t>(c) * 1024]) : 0;
    __syncthreads();
    if (threadIdx.x == 0) {
      long long segs = s_carry[0], items = s_carry[1];
      for (int i = 0; i < min(kThreads, n_chunks - c0); ++i) {
        s.seg_base[c0 + i] = static_cast<int>(min(segs, (long long)INT_MAX));
        s.item_base[c0 + i] =
            static_cast<int>(min(items, (long long)INT_MAX));
        segs += s_n[i];
        items += (s_n[i] + kSegsPerItem - 1) / kSegsPerItem;
      }
      s_carry[0] = segs;
      s_carry[1] = items;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s_over = s_carry[0] > max_segs || s_carry[1] > max_items;
    s.seg_base[n_chunks] = static_cast<int>(min(s_carry[0], (long long)INT_MAX));
    s.item_base[n_chunks] =
        static_cast<int>(min(s_carry[1], (long long)INT_MAX));
    *s.flag = s_over;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < max_items; i += kThreads) s.item_chunk[i] = -1;
  __syncthreads();
  if (s_over) return;
  for (int c = threadIdx.x; c < n_chunks; c += kThreads)
    for (int i = s.item_base[c]; i < s.item_base[c + 1]; ++i)
      s.item_chunk[i] = c;
}

// Phase 1.
__global__ void __launch_bounds__(kThreads)
transfer_kernel(const int* __restrict__ meta, const int* __restrict__ order1,
                const int* __restrict__ lut1, const int* __restrict__ lut2,
                const uint32_t* __restrict__ words, Scratch s) {
  __shared__ int s_lut1[kLut1];
  __shared__ int s_order[kOrder];
  __shared__ int s_lut2[kLut2];
  __shared__ int s_tier[kTier];
  const int c = s.item_chunk[blockIdx.x];
  if (c < 0) return;
  load_chunk_tables(c, meta, order1, lut1, lut2, s_lut1, s_order, s_lut2,
                    s_tier);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  if (lane >= kEntries) return;

  const uint32_t* wp = words + meta[static_cast<size_t>(c) * 1024 + 2];
  const int g0 = s.seg_base[c], last = s.seg_base[c + 1] - g0 - 1;
  const int j0 = (static_cast<int>(blockIdx.x) - s.item_base[c]) * kSegsPerItem;
  const int j1 = min(j0 + kSegsPerItem, last);
  for (int j = j0 + static_cast<int>(threadIdx.x >> 5); j < j1; j += kWarps) {
    const int end = (j + 1) * kSegBits;
    uint64_t acc;
    int nbits, wpos;
    seek_bit(j * kSegBits + lane, wp, acc, nbits, wpos);
    int ntok = 0, par = 0;
    bool dead = false;
    while (!dead && wpos * 32 - nbits < end) {
      int sym, idx;
      dead = read_unit(acc, nbits, wpos, wp, s_lut1, s_order, s_lut2, s_tier,
                       true, sym, idx);
      ntok += idx < 0 ? 1 : 2;
      par ^= 1;
    }
    s.rows[static_cast<size_t>(g0 + j) * kEntries + lane] =
        dead ? kDead
             : static_cast<uint32_t>(wpos * 32 - nbits - end) | par << 5 |
                   static_cast<uint32_t>(ntok) << 6;
  }
}

// Phase 2.
__global__ void __launch_bounds__(kThreads)
scan_kernel(const int* __restrict__ meta, Scratch s, int* __restrict__ status) {
  __shared__ uint32_t s_rows[kScanRows * kEntries];
  __shared__ int s_stop;
  const int c = blockIdx.x;
  if (*s.flag) {
    if (threadIdx.x == 0) {
      s.stop[c] = -1;
      status[3 * c] = 0;
      status[3 * c + 1] = 0;
      status[3 * c + 2] = 1;
    }
    return;
  }
  const int rlen = meta[static_cast<size_t>(c) * 1024 + 1];
  const int g0 = s.seg_base[c], last = s.seg_base[c + 1] - g0 - 1;
  int tok = 0, entry = 0;   // thread 0's walk over the rows
  if (threadIdx.x == 0) s_stop = -1;
  __syncthreads();
  for (int j0 = 0; j0 < last; j0 += kScanRows) {
    const int n = min(kScanRows, last - j0);
    const uint32_t* src = s.rows + static_cast<size_t>(g0 + j0) * kEntries;
    for (int i = threadIdx.x; i < n * kEntries; i += kThreads)
      s_rows[i] = src[i];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 0; j < n; ++j) {
        s.seg_tok[g0 + j0 + j] = tok;
        s.seg_entry[g0 + j0 + j] = entry;
        const uint32_t r = s_rows[j * kEntries + (entry & 31)];
        const int t = static_cast<int>(r >> 6);
        if ((r & 31) == kDead || static_cast<long long>(tok) + t >= rlen) {
          s_stop = j0 + j;
          break;
        }
        tok += t;
        entry = static_cast<int>(r & 31) | ((entry ^ static_cast<int>(r)) & 32);
      }
    }
    __syncthreads();
    if (s_stop >= 0) break;
  }
  if (threadIdx.x == 0) {
    if (s_stop < 0) {
      s_stop = last;
      s.seg_tok[g0 + last] = tok;
      s.seg_entry[g0 + last] = entry;
    }
    s.stop[c] = s_stop;
  }
}

// Phase 3.
__global__ void __launch_bounds__(kThreads)
write_kernel(const int* __restrict__ meta, const int* __restrict__ order1,
             const int* __restrict__ lut1, const int* __restrict__ lut2,
             const uint32_t* __restrict__ words,
             const int64_t* __restrict__ tok_off, Scratch s,
             int* __restrict__ tokens, int* __restrict__ status) {
  __shared__ int s_lut1[kLut1];
  __shared__ int s_order[kOrder];
  __shared__ int s_lut2[kLut2];
  __shared__ int s_tier[kTier];
  const int c = s.item_chunk[blockIdx.x];
  if (c < 0) return;
  load_chunk_tables(c, meta, order1, lut1, lut2, s_lut1, s_order, s_lut2,
                    s_tier);
  __syncthreads();
  const int stop = s.stop[c];
  const int j = (static_cast<int>(blockIdx.x) - s.item_base[c]) *
                    kSegsPerItem + static_cast<int>(threadIdx.x);
  if (threadIdx.x >= kSegsPerItem || j > stop) return;

  const int* m = meta + static_cast<size_t>(c) * 1024;
  const int n_words = m[0], rlen = m[1];
  const uint32_t* wp = words + m[2];
  int* out = tokens + tok_off[c];
  const int g = s.seg_base[c] + j;
  int emitted = s.seg_tok[g], par = s.seg_entry[g] >> 5;
  const int end = j < stop ? (j + 1) * kSegBits : INT_MAX;
  uint64_t acc;
  int nbits, wpos;
  seek_bit(j * kSegBits + (s.seg_entry[g] & 31), wp, acc, nbits, wpos);
  bool bad = false;
  while (emitted < rlen && !bad && wpos * 32 - nbits < end) {
    int sym, idx;
    bad = read_unit(acc, nbits, wpos, wp, s_lut1, s_order, s_lut2, s_tier,
                    emitted + 1 < rlen, sym, idx);
    out[emitted++] = sym;
    if (idx >= 0) out[emitted++] = idx;
    par ^= 1;
    // the serial walk tests after a pair of units, or after its last
    if (par == 0 || emitted >= rlen || bad) bad = bad || wpos > n_words;
  }
  if (j == stop) {
    const int bit_pos = wpos * 32 - nbits;
    int* st = status + 3 * c;
    st[0] = emitted;
    st[1] = bit_pos;
    st[2] = (bad || bit_pos > n_words * 32) ? 1 : 0;
  }
}

}  // namespace

// The int32 words of scratch zlt_entropy_decode needs for n_chunks chunks
// in n_words payload words.
ZLT_API long long zlt_entropy_decode_scratch(int n_chunks, long long n_words) {
  return plan_for(n_chunks, n_words).words;
}

ZLT_API int zlt_entropy_decode(const void* meta, const void* order1,
                               const void* lut1, const void* lut2,
                               const void* words, long long n_words,
                               const void* tok_off, int n_chunks,
                               void* scratch, void* tokens, void* status,
                               void* stream) {
  const Plan p = plan_for(n_chunks, n_words);
  if (p.max_items > INT_MAX || p.max_segs > INT_MAX / kEntries)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = carve(static_cast<int*>(scratch), n_chunks, p);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const int*>(meta);
  const auto* o = static_cast<const int*>(order1);
  const auto* l1 = static_cast<const int*>(lut1);
  const auto* l2 = static_cast<const int*>(lut2);
  const auto* w = static_cast<const uint32_t*>(words);
  const int items = static_cast<int>(p.max_items);
  plan_kernel<<<1, kThreads, 0, st>>>(m, n_chunks,
                                      static_cast<int>(p.max_segs), items, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  transfer_kernel<<<items, kThreads, 0, st>>>(m, o, l1, l2, w, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<n_chunks, kThreads, 0, st>>>(m, s, static_cast<int*>(status));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  write_kernel<<<items, kThreads, 0, st>>>(
      m, o, l1, l2, w, static_cast<const int64_t*>(tok_off), s,
      static_cast<int*>(tokens), static_cast<int*>(status));
  return static_cast<int>(cudaGetLastError());
}
