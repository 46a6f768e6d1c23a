// K4: ROLZ tokenizer -- one block's bytes to raw-literal units, run as the
// block's whole chunk sequence under a per-chunk level schedule.  Replaces
// libzling_tpu/ops/tokenize_kernel.py::_tokenize_kernel; semantics are
// libzling_tpu/spec.py::RolzEncoder.  The plain version and the source
// note are in ops/tokenize_kernel.py.
//
// One CTA per block (blocks are independent: the buckets reset per
// block); thread 0 walks the block.  Bucket state is in global memory,
// allocated and initialised by the wrapper (hash heads and suffix links to
// 0xFFFF, offsets to 0); ring heads and the word-MRU are in shared memory.
#include "common.cuh"

namespace {

using namespace zlt;

struct Bucket {
  uint16_t* hash;    // [256][kHash] newest ring slot of each hash chain
  uint16_t* sfx;     // [256][kRing] next-older slot of the same chain
  uint32_t* ofs;     // [256][kRing] position | check byte << 24
  int* head;         // [256] ring head (shared memory)
};

__device__ __forceinline__ uint32_t load4(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | static_cast<uint32_t>(p[1]) << 8 |
         static_cast<uint32_t>(p[2]) << 16 | static_cast<uint32_t>(p[3]) << 24;
}

__device__ __forceinline__ uint32_t hash4(const uint8_t* p) {
  return load4(p) + p[2] * 137u + p[3] * 13337u;
}

// 0 if the first four bytes differ, else the common prefix length capped
// at kMatchMax.  Eight independent byte loads per step.
__device__ int common_length(const uint8_t* p, int a, int b) {
  if (load4(p + a) != load4(p + b)) return 0;
  int n = 4;
  for (; n + 8 <= kMatchMax; n += 8) {
    uint8_t x[8], y[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      x[q] = p[a + n + q];
      y[q] = p[b + n + q];
    }
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (x[q] != y[q]) return n + q;
  }
  while (n < kMatchMax && p[a + n] == p[b + n]) ++n;
  return n;
}

// Whether pos could start a longer match: four bytes at maxlen-3, no check
// byte (spec.py RolzEncoder._match_lazy).
__device__ bool match_lazy(const uint8_t* p, int pos, int maxlen, int depth,
                           const Bucket& bk) {
  const int ctx = p[pos - 1];
  uint32_t node = bk.hash[ctx * kHash + (hash4(p + pos) & (kHash - 1))];
  if (node == kNil) return false;
  const uint16_t* sfx = bk.sfx + ctx * kRing;
  const uint32_t* ofs = bk.ofs + ctx * kRing;
  const int ml = maxlen - 3;
  const uint32_t want = load4(p + pos + ml);
  uint32_t o = ofs[node];
  for (int i = 0; i < depth; ++i) {
    const uint32_t offset = o & 0xFFFFFF;
    if (load4(p + offset + ml) == want) return true;
    node = sfx[node];
    if (node == kNil) break;
    o = ofs[node];
    if (offset <= (o & 0xFFFFFF)) break;
  }
  return false;
}

// Insert pos into its bucket, then search the chain (spec.py
// RolzEncoder._match_and_update).
__device__ bool match_and_update(const uint8_t* p, int pos, int depth,
                                 int lazy1, int lazy2, const Bucket& bk,
                                 int& mlen, int& midx) {
  const uint32_t h = hash4(p + pos);
  const uint32_t check = (h >> 13) & 255, slot = h & (kHash - 1);
  const int ctx = p[pos - 1];
  uint16_t* hsh = bk.hash + ctx * kHash;
  uint16_t* sfx = bk.sfx + ctx * kRing;
  uint32_t* ofs = bk.ofs + ctx * kRing;
  uint32_t node = hsh[slot];
  const int head = (bk.head[ctx] + 1) & (kRing - 1);
  bk.head[ctx] = head;
  sfx[head] = static_cast<uint16_t>(node);
  ofs[head] = static_cast<uint32_t>(pos) | check << 24;
  hsh[slot] = static_cast<uint16_t>(head);
  if (node == kNil || node == static_cast<uint32_t>(head)) return false;

  int maxlen = kMatchMin - 1;
  uint32_t maxnode = 0;
  uint32_t o = ofs[node];
  for (int i = 0; i < depth; ++i) {
    const uint32_t offset = o & 0xFFFFFF;
    if ((o >> 24) == check && p[pos + maxlen] == p[offset + maxlen]) {
      const int n = common_length(p, pos, static_cast<int>(offset));
      if (n > maxlen) {
        maxnode = node;
        maxlen = n;
        if (maxlen == kMatchMax) break;
      }
    }
    node = sfx[node];
    if (node == kNil) break;
    o = ofs[node];
    if (offset <= (o & 0xFFFFFF)) break;
  }
  if (maxlen < kMatchMin) return false;
  if (maxlen < kLazyMaxLen) {
    if (lazy1 > 0 && match_lazy(p, pos + 1, maxlen, lazy1, bk)) return false;
    if (lazy2 > 0 && match_lazy(p, pos + 2, maxlen, lazy2, bk)) return false;
  }
  mlen = maxlen;
  midx = (head - static_cast<int>(maxnode)) & (kRing - 1);
  return true;
}

__device__ __forceinline__ void mru_push(int* mru, int c, int w) {
  mru[c * 2 + 1] = mru[c * 2];
  mru[c * 2] = w;
}

__global__ void __launch_bounds__(kThreads)
tokenize_kernel(const uint8_t* __restrict__ buf,
                const int64_t* __restrict__ block_off,
                const int* __restrict__ block_len,
                const int64_t* __restrict__ unit_off,
                const int* __restrict__ params, int max_chunks, int max_tokens,
                uint16_t* hash_all, uint16_t* sfx_all, uint32_t* ofs_all,
                int* units, int* upos, int* chunk_stat, int* block_stat) {
  __shared__ int s_head[256];
  __shared__ int s_mru[512];
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < 256; i += kThreads) s_head[i] = 0;
  __syncthreads();
  if (threadIdx.x != 0) return;

  const uint8_t* p = buf + block_off[b];
  const int ilen = block_len[b];
  int* uo = units + unit_off[b];
  int* po = upos + unit_off[b];
  const Bucket bk{hash_all + static_cast<size_t>(b) * 256 * kHash,
                  sfx_all + static_cast<size_t>(b) * 256 * kRing,
                  ofs_all + static_cast<size_t>(b) * 256 * kRing, s_head};
  const int match_limit = ilen - kMatchMax - 16;
  int ipos = 0, cidx = 0, u = 0;
  while (ipos < ilen && cidx < max_chunks) {
    const int* prm = params + (static_cast<size_t>(b) * max_chunks + cidx) * 3;
    const int depth = prm[0], lazy1 = prm[1], lazy2 = prm[2];
    for (int i = 0; i < 512; ++i) s_mru[i] = 0;  // word-MRU resets per chunk
    int nu = 0, nt = 0;
    while (ipos < ilen && (ipos <= 1 ? nt < max_tokens : nt + 1 < max_tokens)) {
      po[u] = ipos;
      ++nu;
      if (ipos <= 1) {  // the two raw head bytes of a block
        uo[u++] = p[ipos++];
        ++nt;
        continue;
      }
      int mlen, midx;
      if (ipos < match_limit &&
          match_and_update(p, ipos, depth, lazy1, lazy2, bk, mlen, midx)) {
        uo[u++] = (258 + mlen - kMatchMin) | (3 << 10) | (midx << 14);
        nt += 2;
        ipos += mlen;
        const int c = p[ipos - 3], w = p[ipos - 2] << 8 | p[ipos - 1];
        if (s_mru[c * 2] != w) mru_push(s_mru, c, w);
        continue;
      }
      const int ctx = p[ipos - 1];
      ++nt;
      if (ipos + 1 < ilen) {
        const int w = p[ipos] << 8 | p[ipos + 1];
        if (s_mru[ctx * 2] == w) {
          uo[u++] = 256 | (2 << 10);
          ipos += 2;
          continue;
        }
        if (s_mru[ctx * 2 + 1] == w) {
          uo[u++] = 257 | (2 << 10);
          ipos += 2;
          mru_push(s_mru, ctx, w);
          continue;
        }
      }
      uo[u++] = p[ipos] | (1 << 10) | (ctx << 14);
      ++ipos;
      mru_push(s_mru, p[ipos - 3], p[ipos - 2] << 8 | p[ipos - 1]);
    }
    int* cs = chunk_stat + (static_cast<size_t>(b) * max_chunks + cidx) * 3;
    cs[0] = nu;
    cs[1] = nt;
    cs[2] = ipos;
    ++cidx;
  }
  block_stat[b * 2] = cidx;
  block_stat[b * 2 + 1] = ipos != ilen;
}

}  // namespace

ZLT_API int zlt_tokenize(const void* buf, const void* block_off,
                         const void* block_len, const void* unit_off,
                         const void* params, int n_blocks, int max_chunks,
                         int max_tokens, void* hash, void* suffix,
                         void* offset, void* units, void* upos,
                         void* chunk_stat, void* block_stat, void* stream) {
  tokenize_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), static_cast<const int64_t*>(block_off),
      static_cast<const int*>(block_len), static_cast<const int64_t*>(unit_off),
      static_cast<const int*>(params), max_chunks, max_tokens,
      static_cast<uint16_t*>(hash), static_cast<uint16_t*>(suffix),
      static_cast<uint32_t*>(offset), static_cast<int*>(units),
      static_cast<int*>(upos), static_cast<int*>(chunk_stat),
      static_cast<int*>(block_stat));
  return static_cast<int>(cudaGetLastError());
}
