// The benchmark's plain reference codec of the zling format.
//
// A line-by-line C++ transcription of the format's executable
// specification (the JAX package's libzling_tpu/spec.py and the constant
// tables of libzling_tpu/tables.py), written for the benchmark and shared
// with no program: each function below names the spec function it
// follows.  It is the yardstick every stream and output of a run is held
// to, so it is never edited to follow the program.  The benchmark builds it
// with g++ into its own cache folder and loads it with ctypes
// (benchmark/reference/codec.py).
//
//   stream       := input_block*
//   input_block  := (0x01 chunk)* 0x00
//   chunk        := encpos:u32be rlen:u32be olen:u32be payload[olen]
//   payload      := nibble-packed length tables (273 B) ++ LSB-first bits
//
// Every call owns its state, so calls may run on several threads at once.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>

namespace {

// ---- tables (tables.py) ----------------------------------------------------

constexpr int kBucketItemSize = 4096;
constexpr int kBucketItemHash = 8192;
constexpr int kMatchMinLen = 4;
constexpr int kMatchMaxLen = 259;
constexpr int kMatchMinLenEnableLazy = 128;
constexpr int kCodes1 = 258 + (kMatchMaxLen - kMatchMinLen + 1);  // 514
constexpr int kCodes2 = 32;
constexpr int kMaxLen1 = 15;
constexpr int kMaxLen2 = 8;
constexpr int kSentinel = kMatchMaxLen + 16;
constexpr uint32_t kBlockIn = 16777216;
constexpr uint32_t kBlockRolz = 262144;
constexpr uint32_t kBlockHuffman = 393216;
constexpr uint16_t kEmpty = 65535;

const int kLevelParams[7][3] = {{2, 1, 0},  {4, 1, 0},  {6, 2, 0},  {8, 3, 1},
                                {16, 4, 2}, {48, 8, 4}, {128, 16, 8}};

const uint8_t kMtfInit[256] = {
    32,  101, 116, 97,  105, 111, 110, 114, 115, 108, 104, 100, 99,  117, 93,  91,
    109, 112, 103, 102, 10,  121, 98,  39,  119, 46,  44,  118, 59,  38,  124, 47,
    49,  107, 61,  48,  67,  65,  58,  45,  84,  83,  60,  62,  50,  113, 73,  57,
    42,  120, 41,  40,  66,  77,  80,  69,  68,  53,  51,  72,  70,  56,  52,  71,
    82,  54,  76,  55,  78,  87,  122, 125, 123, 79,  106, 85,  74,  75,  208, 95,
    195, 35,  86,  215, 90,  34,  89,  209, 128, 224, 184, 131, 92,  227, 37,  33,
    176, 169, 206, 226, 130, 63,  88,  81,  161, 153, 43,  129, 188, 179, 216, 164,
    181, 189, 148, 190, 173, 187, 186, 229, 225, 167, 217, 177, 178, 168, 149, 185,
    197, 144, 147, 196, 207, 194, 180, 156, 132, 170, 166, 136, 182, 191, 9,   230,
    141, 160, 175, 36,  152, 140, 165, 145, 94,  133, 163, 183, 171, 157, 137, 174,
    134, 135, 236, 151, 231, 155, 201, 158, 138, 143, 150, 162, 159, 139, 172, 154,
    126, 232, 235, 146, 233, 228, 202, 203, 142, 214, 237, 204, 219, 234, 213, 96,
    218, 199, 64,  210, 239, 198, 211, 205, 212, 240, 222, 220, 200, 0,   1,   2,
    3,   4,   5,   6,   7,   8,   11,  12,  13,  14,  15,  16,  17,  18,  19,  20,
    21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,  127, 192, 193, 221, 223,
    238, 241, 242, 243, 244, 245, 246, 247, 248, 249, 250, 251, 252, 253, 254, 255};

struct Tables {
  uint8_t mtf_next[256];
  uint8_t idx_code[kBucketItemSize];  // MATCHIDX_CODE
  uint16_t idx_base[kCodes2];         // MATCHIDX_BASE
  uint8_t idx_blen[kCodes2];          // MATCHIDX_BLEN

  Tables() {
    for (int i = 0; i < 256; i++)
      mtf_next[i] = (uint8_t)(i < 128 ? (int)(i * 0.95) : (int)(i * 0.55));
    // _gen_matchidx_tables: 0,0,0,0,1,1,...,7,7 then 8s
    int n = 0, nbase = 0;
    while (n < kBucketItemSize) {
      int b = nbase < 18 ? (nbase < 4 ? 0 : (nbase - 2) / 2) : 8;
      for (int k = 0; k < (1 << b); k++) idx_code[n + k] = (uint8_t)nbase;
      idx_base[nbase] = (uint16_t)n;
      idx_blen[nbase] = (uint8_t)b;
      n += 1 << b;
      nbase++;
    }
  }
};

const Tables& T() {
  static const Tables t;
  return t;
}

// ---- Huffman table construction (huffman_length_table & co) ---------------

// The libstdc++ heap mechanics over weight-only comparisons (_heap_*).
void heap_sift_up(std::vector<int>& heap, const std::vector<int64_t>& w, int hole,
                  int top, int value) {
  int parent = (hole - 1) / 2;
  while (hole > top && w[heap[parent]] > w[value]) {
    heap[hole] = heap[parent];
    hole = parent;
    parent = (hole - 1) / 2;
  }
  heap[hole] = value;
}

void heap_adjust(std::vector<int>& heap, const std::vector<int64_t>& w, int hole,
                 int length, int value) {
  int top = hole, second = hole;
  while (second < (length - 1) / 2) {
    second = 2 * (second + 1);
    if (w[heap[second]] > w[heap[second - 1]]) second--;
    heap[hole] = heap[second];
    hole = second;
  }
  if ((length & 1) == 0 && second == (length - 2) / 2) {
    second = 2 * (second + 1);
    heap[hole] = heap[second - 1];
    hole = second - 1;
  }
  heap_sift_up(heap, w, hole, top, value);
}

void heap_make(std::vector<int>& heap, const std::vector<int64_t>& w) {
  int n = (int)heap.size();
  if (n < 2) return;
  for (int parent = (n - 2) / 2;; parent--) {
    heap_adjust(heap, w, parent, n, heap[parent]);
    if (parent == 0) return;
  }
}

void heap_push(std::vector<int>& heap, const std::vector<int64_t>& w, int node) {
  heap.push_back(node);
  if (heap.size() > 1)
    heap_sift_up(heap, w, (int)heap.size() - 1, 0, heap.back());
}

int heap_pop(std::vector<int>& heap, const std::vector<int64_t>& w) {
  int top = heap[0];
  int last = (int)heap.size() - 1;
  if (last > 0) {
    int value = heap[last];
    heap[last] = heap[0];
    heap_adjust(heap, w, 0, last, value);
  }
  heap.pop_back();
  return top;
}

// huffman_length_table: frequencies -> length-limited code lengths.
void length_table(const uint32_t* freq, int max_codes, int max_codelen,
                  uint32_t* lengths) {
  std::vector<int64_t> weight;
  std::vector<int> sym, kid1, kid2, heap;
  std::vector<std::pair<int, int>> stack;
  for (int scaling = 0;; scaling++) {
    for (int i = 0; i < max_codes; i++) lengths[i] = 0;
    weight.clear();
    sym.clear();
    kid1.clear();
    kid2.clear();
    for (int i = 0; i < max_codes; i++) {
      if (freq[i] > 0) {
        weight.push_back(((int64_t)freq[i] + (1LL << scaling) - 1) >> scaling);
        sym.push_back(i);
        kid1.push_back(-1);
        kid2.push_back(-1);
      }
    }
    if (weight.empty()) return;
    heap.clear();
    for (int i = 0; i < (int)weight.size(); i++) heap.push_back(i);
    heap_make(heap, weight);
    while (heap.size() > 1) {
      int min1 = heap_pop(heap, weight);
      int min2 = heap_pop(heap, weight);
      weight.push_back(weight[min1] + weight[min2]);
      sym.push_back(-1);
      kid1.push_back(min1);
      kid2.push_back(min2);
      heap_push(heap, weight, (int)weight.size() - 1);
    }
    int maxdepth = 0;
    stack.assign(1, {heap[0], 0});
    while (!stack.empty()) {
      auto [node, depth] = stack.back();
      stack.pop_back();
      if (sym[node] >= 0) {
        int d = depth > 1 ? depth : 1;
        lengths[sym[node]] = (uint32_t)d;
        if (d > maxdepth) maxdepth = d;
      } else {
        stack.push_back({kid2[node], depth + 1});
        stack.push_back({kid1[node], depth + 1});
      }
    }
    if (maxdepth <= max_codelen) return;
  }
}

uint32_t bitrev16(uint32_t x) {
  x = ((x & 0xFF00) >> 8) | ((x & 0x00FF) << 8);
  x = ((x & 0xF0F0) >> 4) | ((x & 0x0F0F) << 4);
  x = ((x & 0xCCCC) >> 2) | ((x & 0x3333) << 2);
  x = ((x & 0xAAAA) >> 1) | ((x & 0x5555) << 1);
  return x;
}

// huffman_encode_table: lengths -> bit-reversed LSB-first canonical codes.
void encode_table(const uint32_t* lengths, int max_codes, int max_codelen,
                  uint32_t* enc) {
  uint32_t code = 0;
  for (int codelen = 1; codelen <= max_codelen; codelen++) {
    for (int i = 0; i < max_codes; i++)
      if ((int)lengths[i] == codelen) enc[i] = code++;
    code *= 2;
  }
  for (int i = 0; i < max_codes; i++)
    enc[i] = lengths[i] > 0 ? bitrev16(enc[i]) >> (16 - lengths[i]) : 0;
}

// huffman_decode_table: lengths + codes -> flat table, 0xFFFF for holes.
void decode_table(const uint32_t* lengths, const uint32_t* enc, int max_codes,
                  int max_codelen, uint16_t* table) {
  for (int i = 0; i < (1 << max_codelen); i++) table[i] = 0xFFFF;
  for (int c = 0; c < max_codes; c++)
    if (lengths[c] > 0 && (int)lengths[c] <= max_codelen)
      for (uint32_t i = enc[c]; i < (1u << max_codelen); i += 1u << lengths[c])
        table[i] = (uint16_t)c;
}

// ---- sticky MTF (MtfEncoder, MtfDecoder) ------------------------------------

struct MtfEncoder {
  uint8_t table[256];  // rank -> symbol
  uint8_t index[256];  // symbol -> rank
  MtfEncoder() {
    for (int i = 0; i < 256; i++) {
      table[i] = kMtfInit[i];
      index[kMtfInit[i]] = (uint8_t)i;
    }
  }
  int encode(int c) {
    int i = index[c];
    int j = T().mtf_next[i];
    int s = table[j];
    uint8_t t = index[c];
    index[c] = index[s];
    index[s] = t;
    uint8_t u = table[i];
    table[i] = table[j];
    table[j] = u;
    return i;
  }
};

struct MtfDecoder {
  uint8_t table[256];
  MtfDecoder() { memcpy(table, kMtfInit, 256); }
  int decode(int i) {
    int c = table[i];
    int j = T().mtf_next[i];
    uint8_t t = table[i];
    table[i] = table[j];
    table[j] = t;
    return c;
  }
};

// ---- ROLZ tokenizer (RolzEncoder) -------------------------------------------

uint32_t hash_context(const uint8_t* buf, uint32_t pos) {
  uint32_t w = (uint32_t)buf[pos] | (uint32_t)buf[pos + 1] << 8 |
               (uint32_t)buf[pos + 2] << 16 | (uint32_t)buf[pos + 3] << 24;
  return w + buf[pos + 2] * 137u + buf[pos + 3] * 13337u;
}

// _common_length: 0 if the first four bytes differ anywhere, else the exact
// common prefix length capped at maxlen.
int common_length(const uint8_t* buf, uint32_t p1, uint32_t p2, int maxlen) {
  if (memcmp(buf + p1, buf + p2, 4) != 0) return 0;
  int n = 4;
  while (n < maxlen && buf[p1 + n] == buf[p2 + n]) n++;
  return n < maxlen ? n : maxlen;
}

struct RolzEncoder {
  uint32_t offset[256][kBucketItemSize];
  uint16_t suffix[256][kBucketItemSize];
  uint16_t hash[256][kBucketItemHash];
  uint32_t head[256];
  MtfEncoder mtf[256];

  RolzEncoder() { reset(); }

  void reset() {  // buckets only: the MTF state lives for the whole stream
    memset(offset, 0, sizeof offset);
    memset(suffix, 0xFF, sizeof suffix);
    memset(hash, 0xFF, sizeof hash);
    memset(head, 0, sizeof head);
  }

  // _match_and_update: insert pos into its bucket, then search the chain.
  // Returns the match length (0 for none) and sets *idx.
  int match_and_update(const uint8_t* buf, uint32_t pos, int depth, int lazy1,
                       int lazy2, int* idx) {
    int maxlen = kMatchMinLen - 1;
    int maxnode = 0;
    uint32_t h = hash_context(buf, pos);
    uint32_t hash_check = (h / kBucketItemHash) % 256;
    uint32_t hash_slot = h % kBucketItemHash;
    int ctx = buf[pos - 1];
    uint32_t* ofs = offset[ctx];
    uint16_t* sfx = suffix[ctx];
    uint16_t* hsh = hash[ctx];
    int node = hsh[hash_slot];

    uint32_t hd = (head[ctx] + 1) & (kBucketItemSize - 1);
    head[ctx] = hd;
    sfx[hd] = hsh[hash_slot];
    ofs[hd] = pos | hash_check << 24;
    hsh[hash_slot] = (uint16_t)hd;

    if (node == kEmpty || node == (int)hd) return 0;

    for (int d = 0; d < depth; d++) {
      uint32_t off = ofs[node] & 0xFFFFFF;
      uint32_t check = ofs[node] >> 24;
      if (check == hash_check && buf[pos + maxlen] == buf[off + maxlen]) {
        int n = common_length(buf, pos, off, kMatchMaxLen);
        if (n > maxlen) {
          maxnode = node;
          maxlen = n;
          if (maxlen == kMatchMaxLen) break;
        }
      }
      node = sfx[node];
      if (node == kEmpty || off <= (ofs[node] & 0xFFFFFF)) break;
    }

    if (maxlen >= kMatchMinLen) {
      if (maxlen < kMatchMinLenEnableLazy) {
        if (lazy1 > 0 && match_lazy(buf, pos + 1, maxlen, lazy1)) return 0;
        if (lazy2 > 0 && match_lazy(buf, pos + 2, maxlen, lazy2)) return 0;
      }
      *idx = (int)((hd - maxnode) & (kBucketItemSize - 1));
      return maxlen;
    }
    return 0;
  }

  // _match_lazy: could pos start a strictly longer match?
  bool match_lazy(const uint8_t* buf, uint32_t pos, int maxlen, int depth) {
    int ctx = buf[pos - 1];
    const uint32_t* ofs = offset[ctx];
    const uint16_t* sfx = suffix[ctx];
    int node = hash[ctx][hash_context(buf, pos) % kBucketItemHash];
    if (node == kEmpty) return false;
    maxlen -= 3;
    for (int d = 0; d < depth; d++) {
      uint32_t off = ofs[node] & 0xFFFFFF;
      if (memcmp(buf + pos + maxlen, buf + off + maxlen, 4) == 0) return true;
      node = sfx[node];
      if (node == kEmpty || off <= (ofs[node] & 0xFFFFFF)) break;
    }
    return false;
  }

  // encode_chunk: tokenize one chunk from `start`; returns the new position.
  // `buf` has kSentinel bytes of slack beyond ilen.
  uint32_t encode_chunk(int level, const uint8_t* buf, uint32_t ilen,
                        uint32_t start, uint32_t max_tokens,
                        std::vector<uint16_t>& tokens) {
    const int depth = kLevelParams[level][0], lazy1 = kLevelParams[level][1],
              lazy2 = kLevelParams[level][2];
    uint32_t ipos = start;
    tokens.clear();
    uint16_t mru0[256] = {0}, mru1[256] = {0};

    if (ipos == 0 && tokens.size() < max_tokens && ipos < ilen)
      tokens.push_back(buf[ipos++]);
    if (ipos == 1 && tokens.size() < max_tokens && ipos < ilen)
      tokens.push_back(buf[ipos++]);

    // matches are tried while ipos + 275 < ilen
    const int64_t match_limit = (int64_t)ilen - kMatchMaxLen - 16;
    while (tokens.size() + 1 < max_tokens && ipos < ilen) {
      if ((int64_t)ipos < match_limit) {
        int midx = 0;
        int mlen = match_and_update(buf, ipos, depth, lazy1, lazy2, &midx);
        if (mlen > 0) {
          tokens.push_back((uint16_t)(258 + mlen - kMatchMinLen));
          tokens.push_back((uint16_t)midx);
          ipos += mlen;
          int c = buf[ipos - 3];
          uint16_t w = (uint16_t)(buf[ipos - 2] << 8 | buf[ipos - 1]);
          if (mru0[c] != w) {
            mru1[c] = mru0[c];
            mru0[c] = w;
          }
          continue;
        }
      }
      if (ipos + 1 < ilen) {
        uint16_t w = (uint16_t)(buf[ipos] << 8 | buf[ipos + 1]);
        int ctx = buf[ipos - 1];
        if (mru0[ctx] == w) {
          tokens.push_back(256);
          ipos += 2;
          continue;
        }
        if (mru1[ctx] == w) {
          tokens.push_back(257);
          ipos += 2;
          int c = buf[ipos - 3];
          mru1[c] = mru0[c];
          mru0[c] = (uint16_t)(buf[ipos - 2] << 8 | buf[ipos - 1]);
          continue;
        }
      }
      tokens.push_back((uint16_t)mtf[buf[ipos - 1]].encode(buf[ipos]));
      ipos++;
      int c = buf[ipos - 3];
      mru1[c] = mru0[c];
      mru0[c] = (uint16_t)(buf[ipos - 2] << 8 | buf[ipos - 1]);
    }
    return ipos;
  }
};

// ---- ROLZ resolver (RolzDecoder) --------------------------------------------

struct RolzDecoder {
  uint32_t offset[256][kBucketItemSize];
  uint32_t head[256];
  MtfDecoder mtf[256];

  void reset() {
    memset(offset, 0, sizeof offset);
    memset(head, 0, sizeof head);
  }

  uint32_t ring_insert_and_get(const uint8_t* buf, uint32_t pos, uint32_t idx) {
    int ctx = buf[pos - 1];
    uint32_t hd = (head[ctx] + 1) & (kBucketItemSize - 1);
    head[ctx] = hd;
    offset[ctx][hd] = pos;
    return offset[ctx][(hd - idx) & (kBucketItemSize - 1)];
  }

  // decode_chunk: returns the new output position, or -1 if corrupt.  `buf`
  // holds kBlockIn + kSentinel bytes.
  int64_t decode_chunk(const uint16_t* tokens, uint32_t ilen, uint8_t* buf,
                       uint32_t encpos, uint32_t start) {
    uint32_t opos = start, ipos = 0;
    uint16_t mru0[256] = {0}, mru1[256] = {0};
    if (opos == 0 && ipos < ilen) buf[opos++] = (uint8_t)tokens[ipos++];
    if (opos == 1 && ipos < ilen) buf[opos++] = (uint8_t)tokens[ipos++];

    while (ipos < ilen) {
      uint32_t t = tokens[ipos];
      if (t < 256) {
        buf[opos] = (uint8_t)mtf[buf[opos - 1]].decode((int)t);
        ipos++;
        ring_insert_and_get(buf, opos, 0);
        opos++;
        int c = buf[opos - 3];
        mru1[c] = mru0[c];
        mru0[c] = (uint16_t)(buf[opos - 2] << 8 | buf[opos - 1]);
      } else if (t == 256 || t == 257) {
        uint16_t word = t == 256 ? mru0[buf[opos - 1]] : mru1[buf[opos - 1]];
        ipos++;
        buf[opos] = (uint8_t)(word >> 8);
        ring_insert_and_get(buf, opos, 0);
        opos++;
        buf[opos++] = (uint8_t)word;
        if (t == 257) {
          int c = buf[opos - 3];
          mru1[c] = mru0[c];
          mru0[c] = (uint16_t)(buf[opos - 2] << 8 | buf[opos - 1]);
        }
      } else {
        uint32_t mlen = t - 258 + kMatchMinLen;
        if (ipos + 1 >= ilen) return -1;  // truncated match token pair
        uint32_t midx = tokens[ipos + 1];
        ipos += 2;
        uint32_t src = ring_insert_and_get(buf, opos, midx);
        // a valid encoder emits neither a self-copy nor an unwritten slot
        if (midx == 0 || src == 0 || src >= opos) return -1;
        for (uint32_t k = 0; k < mlen; k++) buf[opos + k] = buf[src + k];
        opos += mlen;
        int c = buf[opos - 3];
        uint16_t w = (uint16_t)(buf[opos - 2] << 8 | buf[opos - 1]);
        if (mru0[c] != w) {
          mru1[c] = mru0[c];
          mru0[c] = w;
        }
      }
      if (opos > encpos) return -1;  // output overruns encpos
    }
    if (opos != encpos) return -1;   // output does not reach encpos
    return opos;
  }
};

// ---- chunk Huffman stage (huffman_encode_chunk, huffman_decode_chunk) -------

void huffman_encode_chunk(const std::vector<uint16_t>& tokens,
                          std::vector<uint8_t>& out) {
  const Tables& tb = T();
  uint32_t freq1[kCodes1] = {0}, freq2[kCodes2] = {0};
  size_t n = tokens.size();
  for (size_t i = 0; i < n; i++) {
    uint32_t t = tokens[i];
    freq1[t]++;
    if (t >= 258) freq2[tb.idx_code[tokens[++i]]]++;
  }
  uint32_t len1[kCodes1], len2[kCodes2], enc1[kCodes1], enc2[kCodes2];
  length_table(freq1, kCodes1, kMaxLen1, len1);
  length_table(freq2, kCodes2, kMaxLen2, len2);
  encode_table(len1, kCodes1, kMaxLen1, enc1);
  encode_table(len2, kCodes2, kMaxLen2, enc2);

  for (int i = 0; i < kCodes1; i += 2) out.push_back((uint8_t)(len1[i] * 16 + len1[i + 1]));
  for (int i = 0; i < kCodes2; i += 2) out.push_back((uint8_t)(len2[i] * 16 + len2[i + 1]));

  uint64_t acc = 0;
  int nbits = 0;
  for (size_t i = 0; i < n; i++) {
    uint32_t t = tokens[i];
    acc |= (uint64_t)enc1[t] << nbits;
    nbits += len1[t];
    if (t >= 258) {
      uint32_t idx = tokens[++i];
      uint32_t code = tb.idx_code[idx];
      acc |= (uint64_t)enc2[code] << nbits;
      nbits += len2[code];
      acc |= (uint64_t)(idx - tb.idx_base[code]) << nbits;
      nbits += tb.idx_blen[code];
    }
    if (nbits >= 32) {
      for (int k = 0; k < 4; k++) out.push_back((uint8_t)(acc >> (8 * k)));
      acc >>= 32;
      nbits -= 32;
    }
  }
  while (nbits > 0) {
    out.push_back((uint8_t)acc);
    acc >>= 8;
    nbits -= 8;
  }
}

// Returns 0, or -1 if the payload is corrupt.  tokens holds rlen.
int huffman_decode_chunk(const uint8_t* payload, uint32_t olen, uint32_t rlen,
                         uint16_t* tokens) {
  const Tables& tb = T();
  std::vector<uint8_t> buf(payload, payload + olen);
  buf.resize((size_t)olen + 8 + (kCodes1 + kCodes2) / 2, 0);  // over-read slack
  size_t pos = 0;
  uint32_t len1[kCodes1], len2[kCodes2], enc1[kCodes1], enc2[kCodes2];
  for (int i = 0; i < kCodes1; i += 2, pos++) {
    len1[i] = buf[pos] >> 4;
    len1[i + 1] = buf[pos] & 15;
  }
  for (int i = 0; i < kCodes2; i += 2, pos++) {
    len2[i] = buf[pos] >> 4;
    len2[i + 1] = buf[pos] & 15;
  }
  encode_table(len1, kCodes1, kMaxLen1, enc1);
  encode_table(len2, kCodes2, kMaxLen2, enc2);
  std::vector<uint16_t> dec1(1 << kMaxLen1), dec2(1 << kMaxLen2);
  decode_table(len1, enc1, kCodes1, kMaxLen1, dec1.data());
  decode_table(len2, enc2, kCodes2, kMaxLen2, dec2.data());

  uint64_t acc = 0;
  int nbits = 0;
  for (uint32_t i = 0; i < rlen;) {
    if (nbits < 32) {
      if (pos + 4 > buf.size()) return -1;
      uint64_t w = (uint64_t)buf[pos] | (uint64_t)buf[pos + 1] << 8 |
                   (uint64_t)buf[pos + 2] << 16 | (uint64_t)buf[pos + 3] << 24;
      acc |= w << nbits;
      pos += 4;
      nbits += 32;
    }
    uint32_t t = dec1[acc & ((1u << kMaxLen1) - 1)];
    if (t >= kCodes1) return -1;  // bad code1
    acc >>= len1[t];
    nbits -= len1[t];
    tokens[i++] = (uint16_t)t;
    if (t >= 258) {
      if (i >= rlen) return -1;   // a length without its index
      uint32_t code = dec2[acc & ((1u << kMaxLen2) - 1)];
      if (code >= kCodes2) return -1;  // bad code2
      acc >>= len2[code];
      nbits -= len2[code];
      uint32_t blen = tb.idx_blen[code];
      uint32_t bits = (uint32_t)(acc & ((1u << blen) - 1));
      acc >>= blen;
      nbits -= blen;
      uint32_t idx = tb.idx_base[code] + bits;
      if (idx >= kBucketItemSize) return -1;  // bad extra bits
      tokens[i++] = (uint16_t)idx;
    }
  }
  return 0;
}

void put_u32be(std::vector<uint8_t>& out, uint32_t v) {
  for (int k = 3; k >= 0; k--) out.push_back((uint8_t)(v >> (8 * k)));
}

uint32_t get_u32be(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}

uint8_t* release(std::vector<uint8_t>& v) {
  uint8_t* p = (uint8_t*)malloc(v.size() ? v.size() : 1);
  if (p && !v.empty()) memcpy(p, v.data(), v.size());
  return p;
}

}  // namespace

extern "C" {

// encode: the stream of in[0..n) at `level` (0..6) in blocks of `block_size`
// bytes and chunks of at most `max_tokens` tokens (the canonical geometry is
// 16777216 / 262144).  Sets *out to a malloc'd buffer (free with zr_free)
// and returns its size, or -3 on bad arguments.
long long zr_encode(const uint8_t* in, size_t n, int level, size_t block_size,
                    uint32_t max_tokens, uint8_t** out) {
  if (level < 0 || level > 6 || block_size == 0 || block_size > kBlockIn ||
      max_tokens < 2 || max_tokens > kBlockRolz)
    return -3;
  std::unique_ptr<RolzEncoder> enc(new RolzEncoder());
  std::vector<uint8_t> stream, payload;
  std::vector<uint8_t> block(block_size + kSentinel);
  std::vector<uint16_t> tokens;
  tokens.reserve(max_tokens + 2);
  int current_level = level;
  for (size_t bstart = 0; bstart < n; bstart += block_size) {
    uint32_t ilen = (uint32_t)(n - bstart < block_size ? n - bstart : block_size);
    memcpy(block.data(), in + bstart, ilen);
    memset(block.data() + ilen, 0, block.size() - ilen);
    enc->reset();
    uint32_t encpos = 0;
    while (encpos < ilen) {
      stream.push_back(1);
      uint32_t encpos_old = encpos;
      encpos = enc->encode_chunk(current_level, block.data(), ilen, encpos,
                                 max_tokens, tokens);
      payload.clear();
      huffman_encode_chunk(tokens, payload);
      uint32_t olen = (uint32_t)payload.size();
      // the adaptive level drop for incompressible chunks
      if (1.0 * olen / (encpos - encpos_old + 1) > 0.95)
        current_level = 0;
      else
        current_level = level;
      put_u32be(stream, encpos);
      put_u32be(stream, (uint32_t)tokens.size());
      put_u32be(stream, olen);
      stream.insert(stream.end(), payload.begin(), payload.end());
    }
    stream.push_back(0);
  }
  *out = release(stream);
  return *out ? (long long)stream.size() : -3;
}

// decode: the bytes of in[0..n).  Sets *out as zr_encode does and returns
// the size, or -1 if the stream is corrupt.
long long zr_decode(const uint8_t* in, size_t n, uint8_t** out) {
  std::unique_ptr<RolzDecoder> dec(new RolzDecoder());
  std::vector<uint8_t> result, block(kBlockIn + kSentinel);
  std::vector<uint16_t> tokens(kBlockRolz + 2);
  size_t pos = 0;
  while (pos < n) {
    dec->reset();
    memset(block.data(), 0, block.size());
    uint32_t decpos = 0;
    for (;;) {
      if (pos >= n) return -1;  // missing stop flag
      uint8_t flag = in[pos++];
      if (flag == 0) break;
      if (flag != 1 || pos + 12 > n) return -1;
      uint32_t encpos = get_u32be(in + pos), rlen = get_u32be(in + pos + 4),
               olen = get_u32be(in + pos + 8);
      pos += 12;
      if (rlen > kBlockRolz || olen > kBlockHuffman || encpos > kBlockIn ||
          pos + olen > n)
        return -1;
      if (huffman_decode_chunk(in + pos, olen, rlen, tokens.data()) != 0) return -1;
      pos += olen;
      int64_t r = dec->decode_chunk(tokens.data(), rlen, block.data(), encpos, decpos);
      if (r < 0) return -1;
      decpos = (uint32_t)r;
    }
    result.insert(result.end(), block.begin(), block.begin() + decpos);
  }
  *out = release(result);
  return *out ? (long long)result.size() : -1;
}

void zr_free(uint8_t* p) { free(p); }

// chunk_tokens: one chunk's payload -> its rlen tokens; 0, or -1 if corrupt.
int zr_chunk_tokens(const uint8_t* payload, uint32_t olen, uint32_t rlen,
                    uint16_t* tokens) {
  if (rlen > kBlockRolz) return -1;
  return huffman_decode_chunk(payload, olen, rlen, tokens);
}

}  // extern "C"
