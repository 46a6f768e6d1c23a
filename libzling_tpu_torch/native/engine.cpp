// zling native host engine (the port's own copy of libzling_tpu/native/engine.cpp).
//
// A from-scratch C++ implementation of the zling bitstream format
// (order-1 ROLZ + two-alphabet canonical Huffman), bit-exact with the
// reference library (richox/libzling; see SURVEY.md section 8 for the
// normative format spec and libzling_tpu/spec.py for the readable
// executable specification this file mirrors).
//
// The port uses it on the host for two things: the exact Huffman length
// tables with the reference's heap tie-break (zlt_length_tables), and a
// canonical encoder/decoder that chip_smoke.py holds the card's streams to.
// Exposed as a C ABI consumed via ctypes (native/engine.py).
//
// Layout of the file:
//   1. format tables (generated at startup, same recipe as tables.py)
//   2. canonical Huffman (length/encode/decode table construction)
//   3. sticky MTF
//   4. ROLZ tokenizer / resolver
//   5. chunk entropy stage (bitpack/unpack)
//   6. stream container encode/decode
//   7. C ABI

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// 1. format constants & tables
// ---------------------------------------------------------------------------

constexpr int kRingSize = 4096;        // ROLZ ring slots per context
constexpr int kHashSize = 8192;        // hash heads per context
constexpr int kMinMatch = 4;
constexpr int kMaxMatch = 259;
constexpr int kLazyThreshold = 128;    // no lazy check for matches >= this
constexpr int kBlockIn = 16777216;     // 16 MB input blocks
constexpr int kChunkTokens = 262144;   // token budget per chunk
constexpr int kChunkPayloadMax = 393216;
constexpr int kSlack = kMaxMatch + 16; // buffer slack for word-wide probes
constexpr int kAlpha1 = 514;           // literal/word/length alphabet
constexpr int kAlpha2 = 32;            // match-index code alphabet
constexpr int kMaxLen1 = 15;
constexpr int kMaxLen2 = 8;
constexpr int kFastBits = 10;
constexpr uint16_t kNil = 0xffff;

constexpr int kInvalid = -1;

// match-index Golomb-style binning (recipe per reference src/tables/gen.py)
struct IdxTables {
  uint8_t blen[kAlpha2];
  uint16_t base[kAlpha2];
  uint8_t code[kRingSize];
  IdxTables() {
    static const uint8_t kBlen[18] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7};
    int n = 0, c = 0;
    while (n < kRingSize) {
      int b = c < 18 ? kBlen[c] : 8;
      blen[c] = (uint8_t)b;
      base[c] = (uint16_t)n;
      for (int k = 0; k < (1 << b); k++) code[n++] = (uint8_t)c;
      c++;
    }
  }
};
const IdxTables g_idx;

// enwik8-tuned initial MTF rank order (reference src/tables/gen.py:32-49)
const uint8_t g_mtf_init[256] = {
     32, 101, 116,  97, 105, 111, 110, 114, 115, 108, 104, 100,  99, 117,  93,  91,
    109, 112, 103, 102,  10, 121,  98,  39, 119,  46,  44, 118,  59,  38, 124,  47,
     49, 107,  61,  48,  67,  65,  58,  45,  84,  83,  60,  62,  50, 113,  73,  57,
     42, 120,  41,  40,  66,  77,  80,  69,  68,  53,  51,  72,  70,  56,  52,  71,
     82,  54,  76,  55,  78,  87, 122, 125, 123,  79, 106,  85,  74,  75, 208,  95,
    195,  35,  86, 215,  90,  34,  89, 209, 128, 224, 184, 131,  92, 227,  37,  33,
    176, 169, 206, 226, 130,  63,  88,  81, 161, 153,  43, 129, 188, 179, 216, 164,
    181, 189, 148, 190, 173, 187, 186, 229, 225, 167, 217, 177, 178, 168, 149, 185,
    197, 144, 147, 196, 207, 194, 180, 156, 132, 170, 166, 136, 182, 191,   9, 230,
    141, 160, 175,  36, 152, 140, 165, 145,  94, 133, 163, 183, 171, 157, 137, 174,
    134, 135, 236, 151, 231, 155, 201, 158, 138, 143, 150, 162, 159, 139, 172, 154,
    126, 232, 235, 146, 233, 228, 202, 203, 142, 214, 237, 204, 219, 234, 213,  96,
    218, 199,  64, 210, 239, 198, 211, 205, 212, 240, 222, 220, 200,   0,   1,   2,
      3,   4,   5,   6,   7,   8,  11,  12,  13,  14,  15,  16,  17,  18,  19,  20,
     21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31, 127, 192, 193, 221, 223,
    238, 241, 242, 243, 244, 245, 246, 247, 248, 249, 250, 251, 252, 253, 254, 255,
};

struct MtfNextTable {
  uint8_t next[256];
  MtfNextTable() {
    for (int i = 0; i < 256; i++)
      next[i] = (uint8_t)(i < 128 ? (int)(i * 0.95) : (int)(i * 0.55));
  }
};
const MtfNextTable g_mtf_next;

// per-level search parameters (reference src/libzling_lz.cpp:128-137).
// Levels 5-6 are framework extensions: deeper chain walks and lazy probes
// than the reference offers.  Their streams use only format features the
// reference decoder understands, so they remain fully reference-decodable --
// just smaller than e4 output.
struct LevelParams { int depth, lazy1, lazy2; };
const LevelParams g_levels[7] = {{2, 1, 0}, {4, 1, 0}, {6, 2, 0}, {8, 3, 1}, {16, 4, 2},
                                 {48, 8, 4}, {128, 16, 8}};
constexpr int kMaxLevel = 6;

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;  // little-endian hosts only (x86/arm); format hash is LE-defined
}
inline uint16_t load16(const uint8_t* p) {
  uint16_t v;
  memcpy(&v, p, 2);
  return v;
}

// ---------------------------------------------------------------------------
// 2. canonical Huffman
// ---------------------------------------------------------------------------

// Code-length construction must reproduce the reference's tie-breaking, which
// is determined by libstdc++'s binary-heap mechanics over weight-only
// comparisons (SURVEY.md section 9.5).  The three helpers implement that
// exact heap algorithm (bottom-up adjust variant) over node indices.

struct LengthBuilder {
  // node arena: leaves first (symbol order), then internal nodes
  std::vector<uint32_t> weight;
  std::vector<int16_t> sym;
  std::vector<int32_t> kid1, kid2;
  std::vector<int32_t> heap;

  void sift_up(int hole, int top, int32_t value) {
    int parent = (hole - 1) / 2;
    while (hole > top && weight[heap[parent]] > weight[value]) {
      heap[hole] = heap[parent];
      hole = parent;
      parent = (hole - 1) / 2;
    }
    heap[hole] = value;
  }

  void adjust(int hole, int len, int32_t value) {
    int top = hole;
    int second = hole;
    while (second < (len - 1) / 2) {
      second = 2 * (second + 1);
      if (weight[heap[second]] > weight[heap[second - 1]]) second--;
      heap[hole] = heap[second];
      hole = second;
    }
    if ((len & 1) == 0 && second == (len - 2) / 2) {
      second = 2 * (second + 1);
      heap[hole] = heap[second - 1];
      hole = second - 1;
    }
    sift_up(hole, top, value);
  }

  int32_t pop() {
    int32_t top = heap[0];
    int last = (int)heap.size() - 1;
    if (last > 0) {
      int32_t value = heap[last];
      heap[last] = heap[0];
      adjust(0, last, value);
    }
    heap.pop_back();
    return top;
  }

  void push(int32_t node) {
    heap.push_back(node);
    if (heap.size() > 1) sift_up((int)heap.size() - 1, 0, heap.back());
  }

  // freq[n] -> len[n], lengths limited to max_codelen via rescale-and-retry
  void build(const uint32_t* freq, uint32_t* len, int n, int max_codelen) {
    memset(len, 0, sizeof(uint32_t) * n);
    for (int scaling = 0;; scaling++) {
      weight.clear(); sym.clear(); kid1.clear(); kid2.clear(); heap.clear();
      for (int i = 0; i < n; i++) {
        if (freq[i] > 0) {
          weight.push_back((freq[i] + ((1u << scaling) - 1)) >> scaling);
          sym.push_back((int16_t)i);
          kid1.push_back(kInvalid);
          kid2.push_back(kInvalid);
        }
      }
      if (weight.empty()) return;
      heap.resize(weight.size());
      for (size_t i = 0; i < weight.size(); i++) heap[i] = (int32_t)i;
      // make_heap
      if (heap.size() >= 2) {
        for (int parent = ((int)heap.size() - 2) / 2;; parent--) {
          adjust(parent, (int)heap.size(), heap[parent]);
          if (parent == 0) break;
        }
      }
      while (heap.size() > 1) {
        int32_t a = pop();
        int32_t b = pop();
        weight.push_back(weight[a] + weight[b]);
        sym.push_back(-1);
        kid1.push_back(a);
        kid2.push_back(b);
        push((int32_t)weight.size() - 1);
      }
      // depth extraction
      uint32_t maxdepth = 0;
      std::vector<std::pair<int32_t, uint32_t>> stack;
      stack.push_back({heap[0], 0});
      while (!stack.empty()) {
        auto [node, depth] = stack.back();
        stack.pop_back();
        if (sym[node] >= 0) {
          uint32_t d = depth > 0 ? depth : 1;
          len[sym[node]] = d;
          if (d > maxdepth) maxdepth = d;
        } else {
          stack.push_back({kid2[node], depth + 1});
          stack.push_back({kid1[node], depth + 1});
        }
      }
      if ((int)maxdepth <= max_codelen) return;
      memset(len, 0, sizeof(uint32_t) * n);
    }
  }
};

inline uint16_t bitrev16(uint16_t x) {
  x = (uint16_t)(((x & 0xff00) >> 8) | ((x & 0x00ff) << 8));
  x = (uint16_t)(((x & 0xf0f0) >> 4) | ((x & 0x0f0f) << 4));
  x = (uint16_t)(((x & 0xcccc) >> 2) | ((x & 0x3333) << 2));
  x = (uint16_t)(((x & 0xaaaa) >> 1) | ((x & 0x5555) << 1));
  return x;
}

// lengths -> LSB-first codes (canonical order, then bit-reversed)
void make_encode_table(const uint32_t* len, uint16_t* enc, int n, int max_codelen) {
  int code = 0;
  memset(enc, 0, sizeof(uint16_t) * n);
  for (int cl = 1; cl <= max_codelen; cl++) {
    for (int i = 0; i < n; i++)
      if ((int)len[i] == cl) enc[i] = (uint16_t)code++;
    code *= 2;
  }
  for (int i = 0; i < n; i++)
    enc[i] = len[i] ? (uint16_t)(bitrev16(enc[i]) >> (16 - len[i])) : 0;
}

// lengths+codes -> flat LUT with 0xffff holes
void make_decode_table(const uint32_t* len, const uint16_t* enc, uint16_t* dec,
                       int n, int max_codelen) {
  memset(dec, 0xff, sizeof(uint16_t) << max_codelen);
  for (int c = 0; c < n; c++) {
    if (len[c] > 0 && (int)len[c] <= max_codelen) {
      for (int i = enc[c]; i < (1 << max_codelen); i += 1 << len[c]) dec[i] = (uint16_t)c;
    }
  }
}

// ---------------------------------------------------------------------------
// 3. sticky MTF (256 independent order-1 chains; survives block boundaries)
// ---------------------------------------------------------------------------

struct MtfState {
  uint8_t rank2sym[256][256];
  uint8_t sym2rank[256][256];  // encoder only
  void init() {
    for (int c = 0; c < 256; c++) {
      memcpy(rank2sym[c], g_mtf_init, 256);
      for (int i = 0; i < 256; i++) sym2rank[c][g_mtf_init[i]] = (uint8_t)i;
    }
  }
  inline uint8_t encode(int ctx, uint8_t symbol) {
    uint8_t* t = rank2sym[ctx];
    uint8_t* x = sym2rank[ctx];
    uint8_t i = x[symbol];
    uint8_t j = g_mtf_next.next[i];
    uint8_t other = t[j];
    uint8_t tmp = x[symbol]; x[symbol] = x[other]; x[other] = tmp;
    tmp = t[i]; t[i] = t[j]; t[j] = tmp;
    return i;
  }
  inline uint8_t decode(int ctx, uint8_t rank) {
    uint8_t* t = rank2sym[ctx];
    uint8_t c = t[rank];
    uint8_t j = g_mtf_next.next[rank];
    uint8_t tmp = t[rank]; t[rank] = t[j]; t[j] = tmp;
    return c;
  }
};

// ---------------------------------------------------------------------------
// 4. ROLZ tokenizer / resolver
// ---------------------------------------------------------------------------

struct EncRing {
  uint16_t chain[kRingSize];   // previous node with same hash slot
  uint32_t slot[kRingSize];    // pos | check<<24
  uint16_t hash_head[kHashSize];
  uint16_t head;
};

struct Tokenizer {
  EncRing* rings;  // [256]
  MtfState* mtf;
  // debug counters (reference gates these at compile time,
  // src/libzling_debug.h:38-49 + call sites src/libzling_lz.cpp:226-287;
  // compiled out by default like the reference -- measured ~7% of e0
  // encode -- and enabled by the ZLT_COUNTERS=1 build):
  // [0] bucket updates  [1] chain steps   [2] match succ  [3] match fail
  // [4] lazy skips      [5] word-MRU hits [6] literals    [7] match bytes
  unsigned long long cnt[8] = {};

#ifdef ZLT_NOCNT
#define ZLT_CNT(expr) ((void)0)
#else
#define ZLT_CNT(expr) (expr)
#endif

  void reset_rings() {
    for (int c = 0; c < 256; c++) {
      EncRing& r = rings[c];
      memset(r.slot, 0, sizeof(r.slot));
      memset(r.chain, 0xff, sizeof(r.chain));
      memset(r.hash_head, 0xff, sizeof(r.hash_head));
      r.head = 0;
    }
  }

  static inline uint32_t hash4(const uint8_t* p) {
    return load32(p) + p[2] * 137u + p[3] * 13337u;
  }

  static inline int common_len(const uint8_t* a, const uint8_t* b, int maxlen) {
    if (load32(a) != load32(b)) return 0;
    int n = 0;
    while (maxlen - n >= 4 && load32(a + n) == load32(b + n)) n += 4;
    if (maxlen - n >= 2 && load16(a + n) == load16(b + n)) n += 2;
    if (maxlen - n >= 1 && a[n] == b[n]) n += 1;
    return n;
  }

  // insert pos into its ring, then walk the chain for the best match
  inline bool find_match(const uint8_t* buf, int pos, const LevelParams& lp,
                         int* out_len, int* out_idx) {
    int best_len = kMinMatch - 1;
    int best_node = 0;
    uint32_t h = hash4(buf + pos);
    uint8_t check = (uint8_t)((h / kHashSize) % 256);
    uint32_t hs = h % kHashSize;
    EncRing& r = rings[buf[pos - 1]];
    int node = r.hash_head[hs];

    r.head = (uint16_t)((r.head + 1) & (kRingSize - 1));
    r.chain[r.head] = r.hash_head[hs];
    r.slot[r.head] = (uint32_t)pos | (uint32_t)check << 24;
    r.hash_head[hs] = r.head;
    ZLT_CNT(cnt[0]++);

    if (node == kNil || node == r.head) return false;

    for (int i = 0; i < lp.depth; i++) {
      ZLT_CNT(cnt[1]++);
      uint32_t off = r.slot[node] & 0xffffff;
      if ((r.slot[node] >> 24) == check && buf[pos + best_len] == buf[off + best_len]) {
        int len = common_len(buf + pos, buf + off, kMaxMatch);
        if (len > best_len) {
          best_node = node;
          best_len = len;
          if (best_len == kMaxMatch) break;
        }
      }
      node = r.chain[node];
      if (node == kNil || off <= (r.slot[node] & 0xffffff)) break;
    }

    if (best_len >= kMinMatch) {
      if (best_len < kLazyThreshold) {
        if (lp.lazy1 > 0 && lazy_probe(buf, pos + 1, best_len, lp.lazy1)) { ZLT_CNT(cnt[4]++); return false; }
        if (lp.lazy2 > 0 && lazy_probe(buf, pos + 2, best_len, lp.lazy2)) { ZLT_CNT(cnt[4]++); return false; }
      }
      *out_len = best_len;
      *out_idx = (r.head - best_node) & (kRingSize - 1);
      return true;
    }
    return false;
  }

  // would pos start a strictly longer match?  (single 4-byte probe per node)
  inline bool lazy_probe(const uint8_t* buf, int pos, int maxlen, int depth) {
    EncRing& r = rings[buf[pos - 1]];
    int node = r.hash_head[hash4(buf + pos) % kHashSize];
    if (node == kNil) return false;
    maxlen -= 3;
    for (int i = 0; i < depth; i++) {
      uint32_t off = r.slot[node] & 0xffffff;
      if (load32(buf + pos + maxlen) == load32(buf + off + maxlen)) return true;
      node = r.chain[node];
      if (node == kNil || off <= (r.slot[node] & 0xffffff)) break;
    }
    return false;
  }

  // tokenize one chunk; returns token count, advances *ipos.
  // raw_literals: emit literal bytes unencoded (MTF relabel happens later --
  // token boundaries never depend on MTF values, which is what makes
  // block-parallel tokenization legal; SURVEY.md section 7.0 phase (b)).
  int run_chunk(int level, const uint8_t* buf, int ilen, int* ipos_io, uint16_t* tok,
                bool raw_literals = false) {
    const LevelParams lp = g_levels[level];
    int ipos = *ipos_io;
    int ntok = 0;
    uint32_t mru[256][2] = {};

    if (ipos == 0 && ntok < kChunkTokens && ipos < ilen) tok[ntok++] = buf[ipos++];
    if (ipos == 1 && ntok < kChunkTokens && ipos < ilen) tok[ntok++] = buf[ipos++];

    const int match_limit = ilen - kMaxMatch - 16;
    while (ntok + 1 < kChunkTokens && ipos < ilen) {
      // Speculative prefetch of the NEXT position's hash head (the literal
      // case, the most common token).  The per-position cost is a serial
      // chain of L3-latency loads (hash_head -> slot/chain -> buf[off]);
      // issuing the first load of iteration k+1 during iteration k removes
      // one L3 round-trip per literal.  The same line also serves the lazy
      // probe at pos+1 when a match is found, so the prefetch is almost
      // never wasted.
      if (ipos + 5 < ilen) {
        const EncRing& rn = rings[buf[ipos]];
        __builtin_prefetch(&rn.hash_head[hash4(buf + ipos + 1) % kHashSize]);
      }
      if (ipos < match_limit) {
        int mlen, midx;
        if (find_match(buf, ipos, lp, &mlen, &midx)) {
          ZLT_CNT(cnt[2]++);
          ZLT_CNT(cnt[7] += (unsigned long long)mlen);
          tok[ntok++] = (uint16_t)(258 + mlen - kMinMatch);
          tok[ntok++] = (uint16_t)midx;
          ipos += mlen;
          uint32_t w = (uint32_t)(buf[ipos - 2] << 8 | buf[ipos - 1]);
          uint32_t* m = mru[buf[ipos - 3]];
          if (m[0] != w) { m[1] = m[0]; m[0] = w; }
          continue;
        }
        ZLT_CNT(cnt[3]++);
      }
      if (ipos + 1 < ilen) {
        uint32_t w = (uint32_t)(buf[ipos] << 8 | buf[ipos + 1]);
        uint32_t* m = mru[buf[ipos - 1]];
        if (m[0] == w) {
          ZLT_CNT(cnt[5]++);
          tok[ntok++] = 256;
          ipos += 2;
          continue;
        }
        if (m[1] == w) {
          ZLT_CNT(cnt[5]++);
          tok[ntok++] = 257;
          ipos += 2;
          uint32_t* m2 = mru[buf[ipos - 3]];
          m2[1] = m2[0];
          m2[0] = (uint32_t)(buf[ipos - 2] << 8 | buf[ipos - 1]);
          continue;
        }
      }
      ZLT_CNT(cnt[6]++);
      tok[ntok++] = raw_literals ? buf[ipos] : mtf->encode(buf[ipos - 1], buf[ipos]);
      ipos++;
      uint32_t* m = mru[buf[ipos - 3]];
      m[1] = m[0];
      m[0] = (uint32_t)(buf[ipos - 2] << 8 | buf[ipos - 1]);
    }
    *ipos_io = ipos;
    return ntok;
  }
};

struct Resolver {
  uint32_t ring[256][kRingSize];
  uint16_t head[256];
  MtfState* mtf;

  void reset_rings() {
    memset(ring, 0, sizeof(ring));
    memset(head, 0, sizeof(head));
  }

  inline uint32_t insert_and_get(const uint8_t* buf, int pos, int idx) {
    int ctx = buf[pos - 1];
    uint16_t h = (uint16_t)((head[ctx] + 1) & (kRingSize - 1));
    head[ctx] = h;
    ring[ctx][h] = (uint32_t)pos;
    return ring[ctx][(h - idx) & (kRingSize - 1)];
  }

  // tokens -> bytes; returns 0 ok / -1 corrupt, advances *opos
  int run_chunk(const uint16_t* tok, int ntok, uint8_t* buf, int encpos, int* opos_io) {
    int opos = *opos_io;
    int ipos = 0;
    uint32_t mru[256][2] = {};

    if (opos == 0 && ipos < ntok) buf[opos++] = (uint8_t)tok[ipos++];
    if (opos == 1 && ipos < ntok) buf[opos++] = (uint8_t)tok[ipos++];

    while (ipos < ntok) {
      uint16_t t = tok[ipos];
      if (t < 256) {
        buf[opos] = mtf->decode(buf[opos - 1], (uint8_t)t);
        ipos++;
        insert_and_get(buf, opos, 0);
        opos++;
        uint32_t* m = mru[buf[opos - 3]];
        m[1] = m[0];
        m[0] = (uint32_t)(buf[opos - 2] << 8 | buf[opos - 1]);
      } else if (t == 256 || t == 257) {
        uint32_t word = mru[buf[opos - 1]][t - 256];
        ipos++;
        buf[opos] = (uint8_t)(word >> 8);
        insert_and_get(buf, opos, 0);
        opos++;
        buf[opos] = (uint8_t)word;
        opos++;
        if (t == 257) {
          uint32_t* m = mru[buf[opos - 3]];
          m[1] = m[0];
          m[0] = (uint32_t)(buf[opos - 2] << 8 | buf[opos - 1]);
        }
      } else {
        int mlen = t - 258 + kMinMatch;
        if (ipos + 1 >= ntok) return -1;
        int midx = tok[ipos + 1];
        ipos += 2;
        uint32_t src = insert_and_get(buf, opos, midx);
        // reject streams no valid encoder can emit: self-copy (hangs the
        // reference) and never-written / forward ring slots (reference
        // reads garbage) -- SURVEY.md section 9.10
        if (midx == 0 || src == 0 || (int)src >= opos) return -1;
        if ((int)src + mlen <= opos) {
          memcpy(buf + opos, buf + src, mlen);
        } else {
          for (int k = 0; k < mlen; k++) buf[opos + k] = buf[src + k];
        }
        opos += mlen;
        uint32_t w = (uint32_t)(buf[opos - 2] << 8 | buf[opos - 1]);
        uint32_t* m = mru[buf[opos - 3]];
        if (m[0] != w) { m[1] = m[0]; m[0] = w; }
      }
      if (opos > encpos) return -1;
    }
    return opos == encpos ? (*opos_io = opos, 0) : -1;
  }
};

// ---------------------------------------------------------------------------
// 5. chunk entropy stage
// ---------------------------------------------------------------------------

// tokens -> payload bytes (length tables + LSB-first bitstream); returns olen
int entropy_encode_chunk(const uint16_t* tok, int ntok, uint8_t* out, LengthBuilder& lb) {
  uint32_t freq1[kAlpha1] = {};
  uint32_t freq2[kAlpha2] = {};
  for (int i = 0; i < ntok; i++) {
    freq1[tok[i]]++;
    if (tok[i] >= 258) freq2[g_idx.code[tok[++i]]]++;
  }
  uint32_t len1[kAlpha1], len2[kAlpha2];
  uint16_t enc1[kAlpha1], enc2[kAlpha2];
  lb.build(freq1, len1, kAlpha1, kMaxLen1);
  lb.build(freq2, len2, kAlpha2, kMaxLen2);
  make_encode_table(len1, enc1, kAlpha1, kMaxLen1);
  make_encode_table(len2, enc2, kAlpha2, kMaxLen2);

  int opos = 0;
  for (int i = 0; i < kAlpha1; i += 2) out[opos++] = (uint8_t)(len1[i] * 16 + len1[i + 1]);
  for (int i = 0; i < kAlpha2; i += 2) out[opos++] = (uint8_t)(len2[i] * 16 + len2[i + 1]);

  uint64_t acc = 0;
  int nbits = 0;
  for (int i = 0; i < ntok; i++) {
    uint16_t t = tok[i];
    acc |= (uint64_t)enc1[t] << nbits;
    nbits += len1[t];
    if (t >= 258) {
      uint16_t idx = tok[++i];
      uint8_t c = g_idx.code[idx];
      acc |= (uint64_t)enc2[c] << nbits;
      nbits += len2[c];
      acc |= (uint64_t)(idx - g_idx.base[c]) << nbits;
      nbits += g_idx.blen[c];
    }
    if (nbits >= 32) {
      memcpy(out + opos, &acc, 4);
      opos += 4;
      acc >>= 32;
      nbits -= 32;
    }
  }
  while (nbits > 0) {
    out[opos++] = (uint8_t)acc;
    acc >>= 8;
    nbits -= 8;
  }
  return opos;
}

// payload -> tokens; returns 0 ok / -1 corrupt.  `in` must have 8B of
// readable slack beyond olen (the word-wise reader can fetch 4B past the
// final payload byte, like the reference's sentinel; reads are bounded to
// olen+8 so corrupt rlen/olen combinations cannot over-read).
int entropy_decode_chunk(const uint8_t* in, int olen, int rlen, uint16_t* tok) {
  uint32_t len1[kAlpha1], len2[kAlpha2];
  int pos = 0;
  for (int i = 0; i < kAlpha1; i += 2) {
    len1[i] = in[pos] >> 4;
    len1[i + 1] = in[pos] & 15;
    pos++;
  }
  for (int i = 0; i < kAlpha2; i += 2) {
    len2[i] = in[pos] >> 4;
    len2[i + 1] = in[pos] & 15;
    pos++;
  }
  uint16_t enc1[kAlpha1], enc2[kAlpha2];
  make_encode_table(len1, enc1, kAlpha1, kMaxLen1);
  make_encode_table(len2, enc2, kAlpha2, kMaxLen2);
  static thread_local uint16_t dec1[1 << kMaxLen1];
  static thread_local uint16_t dec1_fast[1 << kFastBits];
  static thread_local uint16_t dec2[1 << kMaxLen2];
  make_decode_table(len1, enc1, dec1, kAlpha1, kMaxLen1);
  make_decode_table(len1, enc1, dec1_fast, kAlpha1, kFastBits);
  make_decode_table(len2, enc2, dec2, kAlpha2, kMaxLen2);

  uint64_t acc = 0;
  int nbits = 0;
  for (int i = 0; i < rlen; i++) {
    if (nbits < 32) {
      if (pos + 4 > olen + 8) return -1;  // corrupt: bits exhausted
      acc |= (uint64_t)load32(in + pos) << nbits;
      pos += 4;
      nbits += 32;
    }
    uint16_t t = dec1_fast[acc & ((1 << kFastBits) - 1)];
    if (t == kNil) t = dec1[acc & ((1 << kMaxLen1) - 1)];
    if (t >= kAlpha1) return -1;
    acc >>= len1[t];
    nbits -= (int)len1[t];
    tok[i] = t;
    if (t >= 258) {
      uint16_t c = dec2[acc & ((1 << kMaxLen2) - 1)];
      if (c >= kAlpha2) return -1;
      acc >>= len2[c];
      nbits -= (int)len2[c];
      int blen = g_idx.blen[c];
      uint32_t bits = (uint32_t)(acc & ((1u << blen) - 1));
      acc >>= blen;
      nbits -= blen;
      uint32_t idx = g_idx.base[c] + bits;
      if (idx >= kRingSize) return -1;
      tok[++i] = (uint16_t)idx;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// 6. stream container
// ---------------------------------------------------------------------------

inline void put_u32be(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)(v >> 24);
  p[1] = (uint8_t)(v >> 16);
  p[2] = (uint8_t)(v >> 8);
  p[3] = (uint8_t)v;
}
inline uint32_t get_u32be(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}

struct EncodeEngine {
  std::vector<EncRing> rings{256};
  MtfState mtf;
  Tokenizer tk;
  LengthBuilder lb;
  std::vector<uint16_t> tokens;

  EncodeEngine() {
    mtf.init();
    tk.rings = rings.data();
    tk.mtf = &mtf;
    tokens.resize(kChunkTokens + 16);
  }

  void reset_stream() { mtf.init(); }

  // The tokenizer never reads past ilen within a block (matches are only
  // attempted while ipos + kMaxMatch + 16 < ilen), so blocks are tokenized
  // straight out of the caller's buffer -- no staging copy, no sentinel.
  // Returns bytes written, or -1 if `cap` is too small.
  long long run(const uint8_t* in, size_t n, int level, uint8_t* out, size_t cap) {
    int current_level = level;
    size_t opos = 0;
    for (size_t bstart = 0; bstart < n; bstart += kBlockIn) {
      int ilen = (int)(n - bstart < kBlockIn ? n - bstart : kBlockIn);
      const uint8_t* block = in + bstart;
      tk.reset_rings();
      int ipos = 0;
      while (ipos < ilen) {
        if (opos + 13 + kChunkPayloadMax + kSlack > cap) return -1;
        out[opos++] = 1;  // chunk-continue flag
        int ipos_old = ipos;
        int ntok = tk.run_chunk(current_level, block, ilen, &ipos, tokens.data());
        int olen = entropy_encode_chunk(tokens.data(), ntok, out + opos + 12, lb);
        // adaptive level drop for incompressible chunks
        current_level = (1.0 * olen / (ipos - ipos_old + 1) > 0.95) ? 0 : level;
        put_u32be(out + opos, (uint32_t)ipos);
        put_u32be(out + opos + 4, (uint32_t)ntok);
        put_u32be(out + opos + 8, (uint32_t)olen);
        opos += 12 + olen;
      }
      if (opos >= cap) return -1;
      out[opos++] = 0;  // chunk-stop flag
    }
    return (long long)opos;
  }
};

struct DecodeEngine {
  Resolver rs;
  MtfState mtf;
  std::vector<uint16_t> tokens;
  std::vector<uint8_t> payload;

  DecodeEngine() {
    mtf.init();
    rs.mtf = &mtf;
    tokens.resize(kChunkTokens + 16);
    payload.resize(kChunkPayloadMax + kSlack);
  }

  void reset_stream() { mtf.init(); }

  // Decode straight into out (capacity `cap`): ROLZ positions are
  // block-relative, so each block resolves at out+done with no staging
  // buffer.  Returns bytes written, -1 corrupt, -2 cap too small.
  long long run(const uint8_t* in, size_t n, uint8_t* out, size_t cap) {
    size_t pos = 0;
    size_t done = 0;
    while (pos < n) {
      rs.reset_rings();
      int opos = 0;
      for (;;) {
        if (pos >= n) return -1;  // missing stop flag
        uint8_t flag = in[pos++];
        if (flag == 0) break;
        if (flag != 1) return -1;
        if (pos + 12 > n) return -1;
        uint32_t encpos = get_u32be(in + pos);
        uint32_t rlen = get_u32be(in + pos + 4);
        uint32_t olen = get_u32be(in + pos + 8);
        pos += 12;
        if (rlen > kChunkTokens || olen > kChunkPayloadMax || encpos > kBlockIn) return -1;
        if ((int)encpos < opos) return -1;  // non-monotonic: writes would pass cap
        if (pos + olen > n) return -1;
        if (done + encpos > cap) return -2;
        memcpy(payload.data(), in + pos, olen);
        memset(payload.data() + olen, 0, 8);
        pos += olen;
        if (entropy_decode_chunk(payload.data(), (int)olen, (int)rlen, tokens.data()) != 0)
          return -1;
        if (rs.run_chunk(tokens.data(), (int)rlen, out + done, (int)encpos, &opos) != 0)
          return -1;
      }
      done += (size_t)opos;
    }
    return (long long)done;
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// 7. C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Persistent engine handles: reusing an engine across calls keeps its state
// pages warm (first-touch page faults dominate one-shot codec calls).
void* zlt_encoder_new(void) { return new EncodeEngine(); }

// Match-loop observability (works on zlt_encoder_new and zlt_tokenizer_new
// handles).  Layout documented at Tokenizer::cnt.
void zlt_counters(void* h, unsigned long long* out8) {
  memcpy(out8, ((EncodeEngine*)h)->tk.cnt, 8 * sizeof(unsigned long long));
}
void zlt_counters_reset(void* h) {
  memset(((EncodeEngine*)h)->tk.cnt, 0, 8 * sizeof(unsigned long long));
}
void zlt_encoder_free(void* h) { delete (EncodeEngine*)h; }
void* zlt_decoder_new(void) { return new DecodeEngine(); }
void zlt_decoder_free(void* h) { delete (DecodeEngine*)h; }

// Compress in[0..n) at level 0..4 into out[0..cap).  Returns bytes written,
// -1 if cap is too small (use zlt_encode_bound), -3 bad args.
long long zlt_encode_with(void* h, const uint8_t* in, size_t n, int level,
                          uint8_t* out, size_t cap) {
  if (!h || level < 0 || level > kMaxLevel || (!in && n)) return -3;
  EncodeEngine* eng = (EncodeEngine*)h;
  eng->reset_stream();
  return eng->run(in, n, level, out, cap);
}

// One-shot wrapper kept for simple callers.
int zlt_encode(const uint8_t* in, size_t n, int level, uint8_t* out, size_t* out_len) {
  if (level < 0 || level > kMaxLevel || (!in && n) || !out_len) return -3;
  EncodeEngine eng;
  long long r = eng.run(in, n, level, out, *out_len);
  if (r < 0) return -2;
  *out_len = (size_t)r;
  return 0;
}

// Upper bound on encoded size.  A chunk holds <= 262144 tokens, each token
// consumes >= 1 input byte and codes in <= 15.5 bits, plus 13B header and
// 273B length tables per chunk; the encoder additionally requires headroom
// of one worst-case chunk payload while writing in place.
size_t zlt_encode_bound(size_t n) {
  size_t chunks = n / 262142 + n / kBlockIn + 2;
  return 2 * n + chunks * (13 + 273 + 8) + kChunkPayloadMax + kSlack + 4096;
}

// Decompress into out[0..cap).  Returns bytes written, -1 corrupt stream,
// -2 cap too small (call zlt_decoded_size first), -3 bad args.
long long zlt_decode_with(void* h, const uint8_t* in, size_t n, uint8_t* out, size_t cap) {
  if (!h || (!in && n)) return -3;
  DecodeEngine* eng = (DecodeEngine*)h;
  eng->reset_stream();
  return eng->run(in, n, out, cap);
}

// One-shot wrapper kept for simple callers.
int zlt_decode(const uint8_t* in, size_t n, uint8_t* out, size_t* out_len) {
  if ((!in && n) || !out_len) return -3;
  DecodeEngine eng;
  long long r = eng.run(in, n, out, *out_len);
  if (r == -1) return -1;
  if (r == -2) return -2;
  *out_len = (size_t)r;
  return 0;
}

// Scan chunk headers only; returns total decoded size or -1 if malformed.
// Applies the same header bounds the decoder enforces, so a tiny corrupt
// stream cannot claim a huge decoded size.
long long zlt_decoded_size(const uint8_t* in, size_t n) {
  size_t pos = 0;
  long long total = 0;
  uint32_t encpos = 0;
  while (pos < n) {
    uint8_t flag = in[pos++];
    if (flag == 0) {
      total += encpos;
      encpos = 0;
      continue;
    }
    if (flag != 1 || pos + 12 > n) return -1;
    uint32_t ep = get_u32be(in + pos);
    uint32_t rlen = get_u32be(in + pos + 4);
    uint32_t olen = get_u32be(in + pos + 8);
    if (ep > (uint32_t)kBlockIn || ep < encpos || rlen > (uint32_t)kChunkTokens ||
        olen > (uint32_t)kChunkPayloadMax)
      return -1;
    encpos = ep;
    pos += 12 + olen;
    if (pos > n) return -1;
  }
  return encpos == 0 ? total : -1;
}

// ---- split-stage pipeline ABI -------------------------------------------
//
// The parallel/hybrid pipelines drive the codec stage by stage: blocks are
// tokenized in parallel with raw literals (stateless per block), the MTF
// relabel runs as a cheap sequential carry pass, and the entropy stage can
// run on host or device.  Tokens (zling u16 streams) are the interface.

// Per-thread tokenizer context (rings only; ~5.6 MB, reused across blocks).
void* zlt_tokenizer_new(void) {
  auto* t = new EncodeEngine();
  return t;
}
void zlt_tokenizer_free(void* h) { delete (EncodeEngine*)h; }

// Tokenize one block with raw literals.  levels[] is the per-chunk level
// schedule (optimistic prediction; the relabel/entropy phase validates it).
// Outputs: tokens (concatenated chunks), rlens[], encpos[] per chunk.
// Returns the number of chunks, or -1 if max_chunks/max_tokens too small.
int zlt_tokenize_block_raw(void* h, const uint8_t* block, int ilen,
                           const int* levels, int max_chunks,
                           uint16_t* tokens, long long max_tokens,
                           int* rlens, int* encpos_out) {
  EncodeEngine* eng = (EncodeEngine*)h;
  eng->tk.reset_rings();
  int ipos = 0;
  int nchunks = 0;
  long long tpos = 0;
  while (ipos < ilen) {
    if (nchunks >= max_chunks || tpos + kChunkTokens > max_tokens) return -1;
    int ntok = eng->tk.run_chunk(levels[nchunks], block, ilen, &ipos,
                                 tokens + tpos, /*raw_literals=*/true);
    rlens[nchunks] = ntok;
    encpos_out[nchunks] = ipos;
    tpos += ntok;
    nchunks++;
  }
  return nchunks;
}

// Sequential MTF relabel pass: converts raw literals in `tokens` (chunked
// per rlens[], all chunks of ONE block, starting at block position 0) to
// final MTF ranks, carrying the stream-global MTF state in the handle.
void* zlt_mtf_new(void) {
  MtfState* m = new MtfState();
  m->init();
  return m;
}
void zlt_mtf_free(void* h) { delete (MtfState*)h; }
void zlt_mtf_reset(void* h) { ((MtfState*)h)->init(); }

// Snapshot/restore the 128 KB MTF state (for re-tokenization on adaptive-
// level mispredicts and for block-granular checkpoint/resume).
void zlt_mtf_save(void* h, uint8_t* buf) { memcpy(buf, h, sizeof(MtfState)); }
void zlt_mtf_load(void* h, const uint8_t* buf) { memcpy(h, buf, sizeof(MtfState)); }

void zlt_relabel_block(void* h, const uint8_t* block, uint16_t* tokens,
                       const int* rlens, int nchunks) {
  MtfState* mtf = (MtfState*)h;
  int pos = 0;
  long long t = 0;
  for (int c = 0; c < nchunks; c++) {
    long long end = t + rlens[c];
    if (pos == 0 && t < end) { pos++; t++; }
    if (pos == 1 && t < end) { pos++; t++; }
    while (t < end) {
      uint16_t tk = tokens[t];
      if (tk < 256) {
        tokens[t] = mtf->encode(block[pos - 1], (uint8_t)tk);
        pos += 1;
        t += 1;
      } else if (tk <= 257) {
        pos += 2;
        t += 1;
      } else {
        pos += tk - 258 + kMinMatch;
        t += 2;
      }
    }
  }
}

// Entropy stage, one chunk: tokens -> payload bytes.  Returns olen.
int zlt_entropy_encode(const uint16_t* tokens, int ntok, uint8_t* out) {
  static thread_local LengthBuilder lb;
  return entropy_encode_chunk(tokens, ntok, out, lb);
}

// Entropy decode, one chunk: payload (olen bytes + >=8B readable slack)
// -> rlen tokens.  Returns 0 ok / -1 corrupt.
int zlt_entropy_decode(const uint8_t* payload, int olen, int rlen, uint16_t* tokens) {
  return entropy_decode_chunk(payload, olen, rlen, tokens);
}

// Stateful ROLZ resolver for the decode pipeline: rings reset per block via
// zlt_resolver_reset_block; MTF carries across the whole stream.
void* zlt_resolver_new(void) { return new DecodeEngine(); }
void zlt_resolver_free(void* h) { delete (DecodeEngine*)h; }
void zlt_resolver_reset_stream(void* h) { ((DecodeEngine*)h)->reset_stream(); }
// decode-side MTF snapshot (for block-granular checkpoint/resume)
void zlt_resolver_mtf_save(void* h, uint8_t* buf) {
  memcpy(buf, &((DecodeEngine*)h)->mtf, sizeof(MtfState));
}
void zlt_resolver_mtf_load(void* h, const uint8_t* buf) {
  memcpy(&((DecodeEngine*)h)->mtf, buf, sizeof(MtfState));
}
void zlt_resolver_reset_block(void* h) { ((DecodeEngine*)h)->rs.reset_rings(); }

// Resolve one chunk of tokens into out (block-relative positions).
// Returns new opos, or -1 on corrupt input.
int zlt_resolve_chunk(void* h, const uint16_t* tokens, int rlen, int encpos,
                      uint8_t* out, int opos) {
  DecodeEngine* eng = (DecodeEngine*)h;
  if (eng->rs.run_chunk(tokens, rlen, out, encpos, &opos) != 0) return -1;
  return opos;
}

// Batch exact Huffman length-table construction for the device pipeline:
// freqs is nchunks rows of n frequencies; lengths (same shape) receives the
// length-limited code lengths with the reference's exact tie-breaking.
void zlt_length_tables(const uint32_t* freqs, int nchunks, int n, int max_codelen,
                       uint32_t* lengths) {
  LengthBuilder lb;
  for (int c = 0; c < nchunks; c++)
    lb.build(freqs + (size_t)c * n, lengths + (size_t)c * n, n, max_codelen);
}

int zlt_version(void) { return 1; }

}  // extern "C"
