// K4: ROLZ tokenizer -- one block's bytes to raw-literal units, run as the
// block's whole chunk sequence under a per-chunk level schedule.  Replaces
// libzling_tpu/ops/tokenize_kernel.py::_tokenize_kernel; semantics are
// libzling_tpu/spec.py::RolzEncoder.  The plain version and the source
// note are in ops/tokenize_kernel.py.
//
// One CTA of one warp per block (blocks are independent: the buckets reset
// per block).  The warp runs the parse converged, every lane holding the
// same position, main walk and decisions (loads of one address by every
// lane are one broadcast load).  Lane 0 is the walker: it alone stores to
// the bucket state (hash heads, suffix links, offsets, ring heads), the
// word-MRU and the outputs, in RolzEncoder's order.  A __syncwarp()
// separates every lane's loads of a word from lane 0's store to it, on
// both sides, so every lane decides on the same values whatever the
// lanes' timing.  The other lanes' work changes when and where the data
// is loaded, never the result:
//
//   * each chain step loads a node's offset and suffix link together and
//     issues the next node's loads before the candidate's bytes;
//   * lanes 1 and 2 walk the chains of the lazy probes at pos+1 and pos+2
//     beside the main walk (their context and slot come from the input
//     bytes alone) and keep the candidates for the probe test after the
//     walk, which lanes 0-31 then make at once;
//   * a candidate's common length is compared 32 bytes a step with
//     __ballot_sync.
//
// Bucket state is in global memory, allocated and initialised by the
// wrapper (hash heads and suffix links to 0xFFFF, offsets to 0); ring
// heads, the word-MRU and the lazy candidates are in shared memory.
#include "common.cuh"

namespace {

using namespace zlt;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarp = 32;
constexpr int kMaxLazy = 16;       // the deepest lazy probe of LEVEL_PARAMS

struct Bucket {
  uint16_t* hash;    // [256][kHash] newest ring slot of each hash chain
  uint16_t* sfx;     // [256][kRing] next-older slot of the same chain
  uint32_t* ofs;     // [256][kRing] position | check byte << 24
};

__device__ __forceinline__ uint32_t load4(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | static_cast<uint32_t>(p[1]) << 8 |
         static_cast<uint32_t>(p[2]) << 16 | static_cast<uint32_t>(p[3]) << 24;
}

__device__ __forceinline__ uint32_t hash4(const uint8_t* p) {
  return load4(p) + p[2] * 137u + p[3] * 13337u;
}

// 0 if the first four bytes differ, else the common prefix length capped
// at kMatchMax.  Computed by the converged warp, 32 bytes a step: lane k
// compares byte n + k; the first lane that differs (or reaches kMatchMax)
// ends it.
__device__ int common_length(const uint8_t* p, int a, int b, int lane) {
  int n = 0;
  for (;; n += kWarp) {
    const int k = n + lane;
    const unsigned m =
        __ballot_sync(kFull, k >= kMatchMax || p[a + k] != p[b + k]);
    if (m) {
      n += __ffs(m) - 1;
      break;
    }
  }
  return n < kMatchMin ? 0 : n;
}

constexpr uint32_t kNoCand = 0xFFFFFFFFu;   // an empty lazy candidate

// Insert pos into its bucket, then search the chain and run the lazy
// probes (spec.py RolzEncoder._match_and_update, _match_lazy).  Called by
// the converged warp; returns, on every lane, whether pos starts a match,
// with its length and index.
__device__ bool match_and_update(const uint8_t* p, int pos, int depth,
                                 int lazy1, int lazy2, const Bucket& bk,
                                 int* s_head, uint32_t* s_cand,
                                 int lane, int& mlen, int& midx) {
  const uint32_t h = hash4(p + pos);
  const uint32_t check = (h >> 13) & 255, slot = h & (kHash - 1);
  const int ctx = p[pos - 1];
  // lanes 1 and 2 walk the chains of the lazy probes at pos+1 and pos+2
  const int llim = lane == 1 ? lazy1 : lane == 2 ? lazy2 : 0;
  int lctx = ctx;
  uint32_t lslot = slot;
  if (llim > 0) {
    lctx = p[pos + lane - 1];
    lslot = hash4(p + pos + lane) & (kHash - 1);
  }
  const uint32_t node = bk.hash[ctx * kHash + slot];
  uint32_t lnode = llim > 0 ? bk.hash[lctx * kHash + lslot] : kNil;
  const int head = (s_head[ctx] + 1) & (kRing - 1);
  s_cand[lane] = kNoCand;
  __syncwarp();  // every lane's loads of the heads before the insert's stores
  if (lane == 0) {
    s_head[ctx] = head;
    bk.sfx[ctx * kRing + head] = static_cast<uint16_t>(node);
    bk.ofs[ctx * kRing + head] = static_cast<uint32_t>(pos) | check << 24;
    bk.hash[ctx * kHash + slot] = static_cast<uint16_t>(head);
  }
  // a lazy probe whose head entry is the one just written reads the new head
  if (llim > 0 && lctx == ctx && lslot == slot) lnode = head;
  __syncwarp();  // the insert's stores before every lane's chain loads
  if (node == kNil || node == static_cast<uint32_t>(head)) return false;

  const uint16_t* sfx = bk.sfx + ctx * kRing;
  const uint32_t* ofs = bk.ofs + ctx * kRing;
  const uint16_t* lsfx = bk.sfx + lctx * kRing;
  const uint32_t* lofs = bk.ofs + lctx * kRing;
  // a node's offset and suffix link depend only on the node
  uint32_t o = ofs[node], s = sfx[node], cur = node;
  bool lactive = llim > 0 && lnode != kNil;
  uint32_t lo = 0, ls = kNil;
  if (lactive) {
    lo = lofs[lnode];
    ls = lsfx[lnode];
  }
  bool active = true;
  int maxlen = kMatchMin - 1;
  uint32_t maxnode = 0;
  for (int i = 0;; ++i) {
    const uint32_t offset = o & 0xFFFFFF;
    // the next nodes' loads go out before this step's candidate bytes
    bool more = active && i + 1 < depth && s != kNil;
    uint32_t o2 = 0, s2 = kNil;
    if (more) {
      o2 = ofs[s];
      s2 = sfx[s];
    }
    const uint32_t loff = lo & 0xFFFFFF;
    const bool lmore = lactive && i + 1 < llim && ls != kNil;
    uint32_t lo2 = 0, ls2 = kNil;
    if (lmore) {
      lo2 = lofs[ls];
      ls2 = lsfx[ls];
    }
    if (lactive) s_cand[(lane - 1) * kMaxLazy + i] = loff;
    // the check byte alone selects a candidate: n > maxlen implies the
    // probe byte at maxlen is equal, so the probe-byte prefilter is moot
    if (active && (o >> 24) == check) {
      const int n = common_length(p, pos, static_cast<int>(offset), lane);
      if (n > maxlen) {
        maxnode = cur;
        maxlen = n;
        if (maxlen == kMatchMax) more = false;
      }
    }
    active = more && offset > (o2 & 0xFFFFFF);
    cur = s;
    o = o2;
    s = s2;
    lactive = lmore && loff > (lo2 & 0xFFFFFF);
    lo = lo2;
    ls = ls2;
    if (!active && !__any_sync(kFull, lactive)) break;
  }
  if (maxlen < kMatchMin) return false;
  if (maxlen < kLazyMaxLen && (lazy1 > 0 || lazy2 > 0)) {
    // lanes 0-15 test lazy1's candidates, lanes 16-31 lazy2's: four bytes
    // at maxlen - 3, no check byte
    __syncwarp();  // the candidates in shared memory
    const uint32_t c = s_cand[lane];
    const int ml = maxlen - 3;
    const bool hit = c != kNoCand &&
        load4(p + c + ml) == load4(p + pos + 1 + lane / kMaxLazy + ml);
    if (__ballot_sync(kFull, hit)) return false;
  }
  mlen = maxlen;
  midx = (head - static_cast<int>(maxnode)) & (kRing - 1);
  return true;
}

__device__ __forceinline__ void mru_push(int* mru, int c, int w) {
  mru[c * 2 + 1] = mru[c * 2];
  mru[c * 2] = w;
}

__global__ void __launch_bounds__(kWarp)
tokenize_kernel(const uint8_t* __restrict__ buf,
                const int64_t* __restrict__ block_off,
                const int* __restrict__ block_len,
                const int64_t* __restrict__ unit_off,
                const int* __restrict__ params, int max_chunks, int max_tokens,
                uint16_t* hash_all, uint16_t* sfx_all, uint32_t* ofs_all,
                int* units, int* upos, int* chunk_stat, int* block_stat) {
  __shared__ int s_head[256];
  __shared__ int s_mru[512];
  __shared__ uint32_t s_cand[2 * kMaxLazy];
  const int b = blockIdx.x, lane = threadIdx.x;
  for (int i = lane; i < 256; i += kWarp) s_head[i] = 0;
  __syncwarp();

  const uint8_t* p = buf + block_off[b];
  const int ilen = block_len[b];
  int* uo = units + unit_off[b];
  int* po = upos + unit_off[b];
  const Bucket bk{hash_all + static_cast<size_t>(b) * 256 * kHash,
                  sfx_all + static_cast<size_t>(b) * 256 * kRing,
                  ofs_all + static_cast<size_t>(b) * 256 * kRing};
  const int match_limit = ilen - kMatchMax - 16;
  int ipos = 0, cidx = 0, u = 0;
  while (ipos < ilen && cidx < max_chunks) {
    const int* prm = params + (static_cast<size_t>(b) * max_chunks + cidx) * 3;
    const int depth = prm[0], lazy1 = prm[1], lazy2 = prm[2];
    // no room for the candidates of a deeper lazy probe: the block stays
    // unfinished (its err)
    if (lazy1 > kMaxLazy || lazy2 > kMaxLazy) break;
    __syncwarp();  // lane 0's last word-MRU stores before the reset
    for (int i = lane; i < 512; i += kWarp) s_mru[i] = 0;  // resets per chunk
    __syncwarp();
    int nu = 0, nt = 0;
    while (ipos < ilen && (ipos <= 1 ? nt < max_tokens : nt + 1 < max_tokens)) {
      __syncwarp();  // lane 0's word-MRU stores before every lane reads it
      if (lane == 0) po[u] = ipos;
      ++nu;
      if (ipos <= 1) {  // the two raw head bytes of a block
        if (lane == 0) uo[u] = p[ipos];
        ++u;
        ++ipos;
        ++nt;
        continue;
      }
      int mlen = 0, midx = 0;
      if (ipos < match_limit &&
          match_and_update(p, ipos, depth, lazy1, lazy2, bk, s_head, s_cand,
                           lane, mlen, midx)) {
        if (lane == 0)
          uo[u] = (258 + mlen - kMatchMin) | (3 << 10) | (midx << 14);
        ++u;
        nt += 2;
        ipos += mlen;
        if (lane == 0) {
          const int c = p[ipos - 3], w = p[ipos - 2] << 8 | p[ipos - 1];
          if (s_mru[c * 2] != w) mru_push(s_mru, c, w);
        }
        continue;
      }
      // a literal, or a word-MRU hit: every lane reads the MRU, lane 0
      // writes
      const int ctx = p[ipos - 1];
      int adv = 1, sym = p[ipos] | (1 << 10) | (ctx << 14);
      const int w = p[ipos] << 8 | p[ipos + 1];
      if (ipos + 1 < ilen) {
        if (s_mru[ctx * 2] == w) {
          sym = 256 | (2 << 10);
          adv = 2;
        } else if (s_mru[ctx * 2 + 1] == w) {
          sym = 257 | (2 << 10);
          adv = 2;
        }
      }
      __syncwarp();  // every lane's loads of the word-MRU before lane 0's stores
      if (lane == 0) {
        uo[u] = sym;
        if (sym == (257 | (2 << 10))) mru_push(s_mru, ctx, w);
        else if (adv == 1)
          mru_push(s_mru, p[ipos - 2], p[ipos - 1] << 8 | p[ipos]);
      }
      ++u;
      ++nt;
      ipos += adv;
    }
    if (lane == 0) {
      int* cs = chunk_stat + (static_cast<size_t>(b) * max_chunks + cidx) * 3;
      cs[0] = nu;
      cs[1] = nt;
      cs[2] = ipos;
    }
    ++cidx;
  }
  if (lane == 0) {
    block_stat[b * 2] = cidx;
    block_stat[b * 2 + 1] = ipos != ilen;
  }
}

}  // namespace

ZLT_API int zlt_tokenize(const void* buf, const void* block_off,
                         const void* block_len, const void* unit_off,
                         const void* params, int n_blocks, int max_chunks,
                         int max_tokens, void* hash, void* suffix,
                         void* offset, void* units, void* upos,
                         void* chunk_stat, void* block_stat, void* stream) {
  tokenize_kernel<<<n_blocks, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), static_cast<const int64_t*>(block_off),
      static_cast<const int*>(block_len), static_cast<const int64_t*>(unit_off),
      static_cast<const int*>(params), max_chunks, max_tokens,
      static_cast<uint16_t*>(hash), static_cast<uint16_t*>(suffix),
      static_cast<uint32_t*>(offset), static_cast<int*>(units),
      static_cast<int*>(upos), static_cast<int*>(chunk_stat),
      static_cast<int*>(block_stat));
  return static_cast<int>(cudaGetLastError());
}

