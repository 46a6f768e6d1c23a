// K4: ROLZ tokenizer -- one block's bytes to raw-literal units, run as the
// block's whole chunk sequence under a per-chunk level schedule.  Replaces
// libzling_tpu/ops/tokenize_kernel.py::_tokenize_kernel; semantics are
// libzling_tpu/spec.py::RolzEncoder.  The plain version is in
// ops/tokenize_kernel.py.
//
// What bounds it: the latency of dependent loads, not bytes.  The parse is
// serial within a block, and each token start reads a hash head, then the
// node's offset and suffix link, then the candidate's bytes, each address
// known only from the load before, in ~10 MB of bucket state per block
// that, six blocks and the input beside it, does not stay in L2 (HBM ~675
// cycles a load, L2 ~300, L1 ~40).
//
// One CTA of four warps per block (blocks are independent: the buckets
// reset per block).  Warp 0 is the walker warp; warps 1-3 run ahead of it.
//
// The walker warp runs the parse converged, every lane holding the same
// position, main walk and decisions (loads of one address by every lane
// are one broadcast load).  Its lane 0 alone stores to the bucket state
// (hash heads, suffix links, offsets, ring heads), the word-MRU and the
// outputs, in RolzEncoder's order.  A __syncwarp() separates every lane's
// loads of a word from lane 0's store to it, on both sides, so every lane
// decides on the same values whatever the lanes' timing.  The other lanes'
// work changes when and where the data is loaded, never the result:
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
// The run-ahead warps take the latency off the walker's loads: they pull
// into L1 the lines that the walker will read at the positions just ahead
// of it.  A position's hash head depends only on its input bytes, and the
// bucket changes only at token starts, one insert each, so the lines read
// ahead of time are almost always the walker's.  Each of their 96 lanes
// takes positions of a window after the walker's (32-position groups, one
// warp's in three), and for each reads the hash head, the chain's nodes
// (offset and suffix link) under the walker's stopping test, and the
// first bytes of each candidate whose check byte matches.  The first
// nodes go to L1; the rest of the walker's depth to L2 only.  The
// window and the L1 depth follow from the L1 budget and the chunk's
// search depth (`window`; a lazy probe is never deeper than the search),
// and the window ends at the block's match limit.  They only read: a
// stale line costs a wasted prefetch, never a different result, and the
// walker never waits for them.  The walker publishes its position and
// depth in shared memory and counts its token starts, and those a
// run-ahead warp had reached first, into `k4stat`.  On an H100 they take
// ~30% off the head step and ~10% off a chain step; what is left of a
// unit is the walker's own chain of dependent instructions.
//
// Bucket state is in global memory, allocated and initialised by the
// wrapper (hash heads and suffix links to 0xFFFF, offsets to 0); ring
// heads, the word-MRU, the lazy candidates and the run-ahead's words are
// in shared memory, kept to a minimum carveout so that L1 has the rest.
#include "common.cuh"

namespace {

using namespace zlt;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarp = 32;
constexpr int kMaxLazy = 16;       // the deepest lazy probe of LEVEL_PARAMS
constexpr int kAhead = 3;          // run-ahead warps
constexpr int kCta = (1 + kAhead) * kWarp;

// The run-ahead's share of L1 in 128-byte lines, and the lines one chain
// node it reads takes: its offset's, its suffix link's and up to two of
// its candidate's bytes.  A position adds one line, its hash head's.  The
// share is 32 KB of the ~248 KB beside the minimum shared-memory carveout:
// on an H100 the walker lost time to every larger window (its own lines
// pushed out), and a window of 16-32 positions was best at e0 and e4.
constexpr int kL1Lines = 256;
constexpr int kNodeLines = 4;
// Chain nodes a position takes into L1 (the rest of the search depth goes
// to L2): the first three.  One node lost ~2% on an H100, eight gained
// nothing over three.
constexpr int kL1Chain = 3;
constexpr unsigned kNapNs = 256;   // a run-ahead warp's wait at the window

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

// What the walker and the run-ahead warps tell each other, in shared
// memory (read and written through a volatile reference).
struct RunAhead {
  int pos;            // the walker's position
  int depth;          // the current chunk's search depth
  int done;           // set once the walker has left the block
  int front[kAhead];  // run-ahead warp w has read every position of its
                      // groups below front[w]
};

// Positions a run-ahead warp may read ahead of the walker: as many as the
// L1 budget holds at the chunk's depth.
__device__ __forceinline__ int window(int depth) {
  return kL1Lines / (1 + kNodeLines * min(max(depth, 1), kL1Chain));
}

// A load whose value feeds nothing, kept by `asm volatile`: it leaves the
// line in L1 (prefetch.global.L1 fills L2 alone on this card).
__device__ __forceinline__ void touch(const void* a) {
  unsigned v;
  asm volatile("ld.global.u8 %0, [%1];" : "=r"(v) : "l"(a));
}

__device__ __forceinline__ void prefetch_l2(const void* a) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(a));
}

// The lines match_and_update reads at q (before its insert), read ahead of
// it: the hash head, then up to `depth` chain nodes, stopping where the
// walker does (nil, or an offset that does not decrease), and the lines
// of the first 32 bytes of each candidate whose check byte matches.  The
// first kL1Chain nodes are read into L1, the rest into L2 alone.  Any
// value read may be stale, so a node is used only if it is a ring slot
// and a candidate only if it lies before q.
__device__ void read_ahead(const uint8_t* p, int q, int depth,
                           const Bucket& bk) {
  const uint32_t h = hash4(p + q);
  const uint32_t check = (h >> 13) & 255;
  const int ctx = p[q - 1];
  uint32_t node = bk.hash[ctx * kHash + (h & (kHash - 1))];
  const uint16_t* sfx = bk.sfx + ctx * kRing;
  const uint32_t* ofs = bk.ofs + ctx * kRing;
  uint32_t last = 1u << 24;   // above every 24-bit offset
  for (int i = 0; node < static_cast<uint32_t>(kRing); ++i) {
    const bool near = i < kL1Chain;
    const uint32_t o = near ? ofs[node] : __ldcg(ofs + node);
    const uint32_t s = near ? sfx[node] : __ldcg(sfx + node);
    const uint32_t offset = o & 0xFFFFFF;
    if (offset >= last) break;
    if ((o >> 24) == check && offset < static_cast<uint32_t>(q)) {
      const uint8_t* c = p + offset;
      if (near) {
        touch(c);
        touch(c + kWarp - 1);
      } else {
        prefetch_l2(c);
        prefetch_l2(c + kWarp - 1);
      }
    }
    if (i + 1 >= depth) break;
    last = offset;
    node = s;
  }
}

// A run-ahead warp (ra = 0..kAhead-1): its groups of kWarp positions are
// g = ra, ra + kAhead, ...; it reads a group once its first position is
// within window(depth) of the walker's, skips the groups the walker has
// passed, and stops at match_limit or when the walker is done.  It stores
// nothing to global memory.
__device__ void run_ahead(const uint8_t* p, const Bucket& bk, int match_limit,
                          int ra, int lane, volatile RunAhead& s) {
  for (int g = ra;; g += kAhead) {
    int pos = 0, depth = 0;
    for (;;) {
      int done = 0;
      if (lane == 0) {
        done = s.done;
        pos = s.pos;
        depth = s.depth;
      }
      if (__shfl_sync(kFull, done, 0)) return;
      pos = __shfl_sync(kFull, pos, 0);
      depth = __shfl_sync(kFull, depth, 0);
      const int behind = (pos + 1) / kWarp - g;
      if (behind > 0) g += (behind + kAhead - 1) / kAhead * kAhead;
      if (g * kWarp <= pos + window(depth)) break;
      __nanosleep(kNapNs);
    }
    const int q0 = g * kWarp, q = q0 + lane;
    if (q0 >= match_limit) return;
    if (q > pos && q > 1 && q < match_limit) read_ahead(p, q, depth, bk);
    __syncwarp();
    if (lane == 0) s.front[ra] = q0 + kWarp;
  }
}

// One CTA an SM: ptxas then gives the walker the registers it had as a
// one-warp CTA (a bound of kCta threads alone cut them from 58 to 40, and
// the walk slowed by ~5%).
__global__ void __launch_bounds__(kCta, 1)
tokenize_kernel(const uint8_t* __restrict__ buf,
                const int64_t* __restrict__ block_off,
                const int* __restrict__ block_len,
                const int64_t* __restrict__ unit_off,
                const int* __restrict__ params, int max_chunks, int max_tokens,
                uint16_t* hash_all, uint16_t* sfx_all, uint32_t* ofs_all,
                int* units, int* upos, int* chunk_stat, int* block_stat,
                long long* k4stat) {
  __shared__ int s_head[256];
  __shared__ int s_mru[512];
  __shared__ uint32_t s_cand[2 * kMaxLazy];
  __shared__ RunAhead s_ra;
  volatile RunAhead& ra = s_ra;
  const int b = blockIdx.x, warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  for (int i = threadIdx.x; i < 256; i += kCta) s_head[i] = 0;
  if (threadIdx.x == 0) {
    ra.pos = 0;
    ra.depth = 0;   // until the walker publishes its chunk's depth
    ra.done = 0;
    for (int w = 0; w < kAhead; ++w) ra.front[w] = 0;
  }
  __syncthreads();

  const uint8_t* p = buf + block_off[b];
  const int ilen = block_len[b];
  const Bucket bk{hash_all + static_cast<size_t>(b) * 256 * kHash,
                  sfx_all + static_cast<size_t>(b) * 256 * kRing,
                  ofs_all + static_cast<size_t>(b) * 256 * kRing};
  const int match_limit = ilen - kMatchMax - 16;
  if (warp > 0) {
    run_ahead(p, bk, match_limit, warp - 1, lane, ra);
    return;
  }

  // warp 0: the walker
  int* uo = units + unit_off[b];
  int* po = upos + unit_off[b];
  int starts = 0, covered = 0;   // the same on every lane
  int ipos = 0, cidx = 0, u = 0;
  while (ipos < ilen && cidx < max_chunks) {
    const int* prm = params + (static_cast<size_t>(b) * max_chunks + cidx) * 3;
    const int depth = prm[0], lazy1 = prm[1], lazy2 = prm[2];
    // no room for the candidates of a deeper lazy probe: the block stays
    // unfinished (its err)
    if (lazy1 > kMaxLazy || lazy2 > kMaxLazy) break;
    if (lane == 0) ra.depth = depth;
    __syncwarp();  // lane 0's last word-MRU stores before the reset
    for (int i = lane; i < 512; i += kWarp) s_mru[i] = 0;  // resets per chunk
    __syncwarp();
    int nu = 0, nt = 0;
    while (ipos < ilen && (ipos <= 1 ? nt < max_tokens : nt + 1 < max_tokens)) {
      __syncwarp();  // lane 0's word-MRU stores before every lane reads it
      if (lane == 0) {
        po[u] = ipos;
        ra.pos = ipos;
      }
      ++nu;
      if (ipos <= 1) {  // the two raw head bytes of a block
        if (lane == 0) uo[u] = p[ipos];
        ++u;
        ++ipos;
        ++nt;
        continue;
      }
      // the run-ahead's frontier of ipos's group, read by every lane (one
      // broadcast load) and compared once the step is done, off the
      // walker's chain
      const int at = ipos;
      const int front = ra.front[static_cast<unsigned>(at) / kWarp % kAhead];
      int mlen = 0, midx = 0;
      const bool match = at < match_limit &&
          match_and_update(p, at, depth, lazy1, lazy2, bk, s_head, s_cand,
                           lane, mlen, midx);
      starts += at < match_limit;
      covered += at < match_limit && front > at;
      if (match) {
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
    ra.done = 1;
    block_stat[b * 2] = cidx;
    block_stat[b * 2 + 1] = ipos != ilen;
    k4stat[b * 2] = starts;
    k4stat[b * 2 + 1] = covered;
  }
}

}  // namespace

ZLT_API int zlt_tokenize(const void* buf, const void* block_off,
                         const void* block_len, const void* unit_off,
                         const void* params, int n_blocks, int max_chunks,
                         int max_tokens, void* hash, void* suffix,
                         void* offset, void* units, void* upos,
                         void* chunk_stat, void* block_stat, void* k4stat,
                         void* stream) {
  // L1 gets what shared memory leaves (a function attribute of the
  // current device)
  const cudaError_t e = cudaFuncSetAttribute(
      tokenize_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxL1);
  if (e != cudaSuccess) return static_cast<int>(e);
  tokenize_kernel<<<n_blocks, kCta, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), static_cast<const int64_t*>(block_off),
      static_cast<const int*>(block_len), static_cast<const int64_t*>(unit_off),
      static_cast<const int*>(params), max_chunks, max_tokens,
      static_cast<uint16_t*>(hash), static_cast<uint16_t*>(suffix),
      static_cast<uint32_t*>(offset), static_cast<int*>(units),
      static_cast<int*>(upos), static_cast<int*>(chunk_stat),
      static_cast<int*>(block_stat), static_cast<long long*>(k4stat));
  return static_cast<int>(cudaGetLastError());
}

