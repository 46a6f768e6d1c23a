// Card counterparts of tools/probe_tokenize_cost.py: K4's per-unit cost in
// layers, on one thread of one CTA.  The plain versions and the wrappers
// are in probes/tokenize_cost.py.
//
//   unit_kernel<...>  PT1, build_kernel (:51, pallas_call :291 via run
//                     :290) in the nine configurations of main()
//                     (:368-386): the literal path, + the hash insert,
//                     + a chain walk (depth 1 as on the TPU, or deeper),
//                     + the probe byte and LCP regions behind a never- or
//                     an always-taken branch, the find_match call behind an
//                     always-taken branch (the TPU's pl.when wrap), + the
//                     lazy probe (never taken, taken, or its loads hoisted
//                     above the walk);
//   serial3_kernel    PT0, serial3_kernel (:326, pallas_call :349): three
//                     dependent loads per step from an i32 table of `rows`
//                     x 128 words -- 128 KB as on the TPU, or K4's 10.5 MB
//                     bucket footprint.
//
// Where the data sits is where K4 keeps it (csrc/tokenize.cu): the hash,
// suffix-chain and slot tables in global memory at K4's shapes and types
// (u16 [256][8192], u16 [256][4096], u32 [256][4096]), initialised by the
// CTA before the loop as the TPU probe initialises its VMEM; the block's
// bytes in global memory (u8, the TPU's (128, 128) i32 block); the ring
// heads, word-MRU and the slab in shared memory (the slab as i32 words, as
// on the TPU, so the gates' compares stay run-time compares); the TPU's SMEM
// `pers` words in registers; the staged units to global memory.  The
// funnel LCP (3 x 128 lanes compared at once) becomes a 12-byte compare of
// the two positions, as K4's common_length starts: it returns the first
// differing index below 12, else 999, as the funnel returns 999 when
// nothing differs.  What it measures on this card: the latency chain of
// one unit -- shared-memory loads for the slab and MRU, global (L1/L2)
// loads for the tables -- which is what bounds K4.
#include "probe.cuh"

namespace {

using namespace zlp;

constexpr uint32_t kNil = zlt::kNil;
constexpr int kHashWords = 256 * 8192;   // u16
constexpr int kRingWords = 256 * 4096;   // u16 chain, u32 slot
constexpr uint32_t kSpread = 0x9E3779B1u;  // PT0's first word at K4's size

enum Whens { kOff = 0, kNever = 1, kTaken = 2 };
enum Lazy { kLazyOff = 0, kLazyNever = 1, kLazyTaken = 2, kLazyPrefetch = 3 };

struct Tables {
  uint16_t* hash;
  uint16_t* chain;
  uint32_t* slot;
  const uint8_t* block;
  const int* slab;      // shared
  int* head;            // shared
};

__device__ __forceinline__ int sb(const int* slab, int p) {
  return slab[p & 2047];
}

__device__ __forceinline__ uint32_t u32le(const int* slab, int p) {
  return static_cast<uint32_t>(sb(slab, p)) | sb(slab, p + 1) << 8 |
         sb(slab, p + 2) << 16 | static_cast<uint32_t>(sb(slab, p + 3)) << 24;
}

__device__ __forceinline__ uint32_t hash4(const int* slab, int p) {
  return u32le(slab, p) + sb(slab, p + 2) * 137u + sb(slab, p + 3) * 13337u;
}

// First index k < 12 where the block's bytes at a + k and b + k differ,
// else 999.  Twelve independent loads of each side.
__device__ __forceinline__ int lcp12(const uint8_t* block, int a, int b) {
  int r = 999;
#pragma unroll
  for (int k = 11; k >= 0; --k)
    if (block[a + k] != block[b + k]) r = k;
  return r;
}

// The carried scalar state: the TPU probe's pers words 0-2 and 5-7.
struct Pers {
  int p0 = 0, p1 = 0, p2 = 0, p5 = 0, p6 = 0, p7 = 0;
};

template <bool kInsert, bool kWalk, int kWhens, int kLazy>
__device__ __forceinline__ void find_match(const Tables& tb, int ipos,
                                           int depth, Pers& ps,
                                           uint32_t& ck) {
  const int* slab = tb.slab;
  const int ctx = sb(slab, ipos - 1);
  const uint32_t h = hash4(slab, ipos);
  const uint32_t check = (h >> 13) & 255, hslot = h & 8191;
  uint32_t acc = 0;
  int node0, headv;
  if constexpr (kInsert) {
    const uint32_t raw = tb.hash[ctx * 8192 + hslot];
    ck += raw;
    node0 = raw & 4095;
    headv = (tb.head[ctx] + 1) & 4095;
    tb.head[ctx] = headv;
    tb.chain[ctx * 4096 + headv] = static_cast<uint16_t>(node0);
    tb.slot[ctx * 4096 + headv] = static_cast<uint32_t>(ipos) | check << 24;
    tb.hash[ctx * 8192 + hslot] = static_cast<uint16_t>(headv);
  } else {
    node0 = ipos & 4095;
    headv = node0;
  }
  acc += node0;
  if constexpr (kWalk) {
    const bool searchable = (node0 != static_cast<int>(kNil) && node0 != headv)
                            || slab[2046] < 999;
    uint32_t ls = 0, lnxt = 0;
    if constexpr (kLazy == kLazyPrefetch) {  // the lazy loads, hoisted
      const int lctx = sb(slab, ipos);
      const uint32_t lslot = hash4(slab, ipos + 1) & 8191;
      const uint32_t lraw = tb.hash[lctx * 8192 + lslot];
      const int lnode0 = lraw & 4095;
      ls = tb.slot[lctx * 4096 + lnode0];
      lnxt = tb.chain[lctx * 4096 + lnode0];
      ck += lraw + ls + lnxt;
    }
    int wi = 0, node = searchable ? node0 : 0, best_len = 3, best_node = 0;
    uint32_t prev_off = 0;
    bool done = !searchable;
#pragma unroll 1
    while (!done) {
      const uint32_t s = tb.slot[ctx * 4096 + node];
      const uint32_t nxt_raw = tb.chain[ctx * 4096 + node];
      ck += s + nxt_raw;
      const uint32_t off = s & 0xFFFFFF;
      done = done || (wi > 0 && static_cast<int>(prev_off) <= static_cast<int>(off));
      bool probe_ok = false;
      if constexpr (kWhens != kOff) {
        const int g = slab[(off + wi) & 2047];
        const bool gate = !done && (kWhens == kNever ? g > 500 : g >= 0);
        if (gate) {
          ps.p5 = tb.block[(off + best_len) & 1023];
          ck += ps.p5;
        }
        probe_ok = kWhens == kTaken
                       ? gate
                       : gate && ps.p5 == sb(slab, ipos + best_len);
        if (probe_ok) {
          ps.p6 = lcp12(tb.block, ipos & 1023, off & 1023);
          ck += ps.p6;
        }
      }
      int lcp = probe_ok ? min(ps.p6, 259) : 0;
      lcp = lcp >= 4 ? lcp : 0;
      if (lcp > best_len && !done) {
        best_node = node;
        best_len = lcp;
      }
      done = done || best_len == 259 || wi + 1 >= depth;
      const int nxt = done ? node : static_cast<int>(nxt_raw);
      done = done || nxt == static_cast<int>(kNil);
      node = done ? node : nxt;
      prev_off = off;
      ++wi;
    }
    acc += best_len + best_node;
    if constexpr (kLazy != kLazyOff) {
      const int g = slab[(acc + ipos) & 2047];
      ps.p7 = 0;
      if (kLazy == kLazyNever ? g > 500 : g >= 0) {
        uint32_t s, nxt;
        if constexpr (kLazy == kLazyPrefetch) {
          s = ls;
          nxt = lnxt;
        } else {
          const int lctx = sb(slab, ipos);
          const uint32_t lslot = hash4(slab, ipos + 1) & 8191;
          const uint32_t lraw = tb.hash[lctx * 8192 + lslot];
          const int lnode = lraw & 4095;
          s = tb.slot[lctx * 4096 + lnode];
          nxt = tb.chain[lctx * 4096 + lnode];
          ck += lraw + s + nxt;
        }
        const int probe_at = best_len - 3;
        const uint32_t want = u32le(slab, ipos + 1 + probe_at);
        const uint32_t off = s & 0xFFFFFF;
        const int got = tb.block[(off + probe_at) & 1023];
        ck += got;
        ps.p7 = (static_cast<uint32_t>(got) == (want & 255)) || nxt == kNil;
      }
      acc += ps.p7;
    }
  }
  ps.p0 = acc & 1;
  ps.p1 = acc & 255;
  ps.p2 = acc & 4095;
}

template <bool kInsert, bool kWalk, int kWhens, bool kWrap, int kLazy>
__global__ void __launch_bounds__(kThreads)
unit_kernel(int n, int depth, uint16_t* hash, uint16_t* chain, uint32_t* slot,
            const uint8_t* __restrict__ block, int* stg,
            unsigned long long* out) {
  __shared__ int s_slab[2048];
  __shared__ int s_mru[518];
  __shared__ int s_head[258];
  const int tid = threadIdx.x;
  for (int k = tid; k < 2048; k += blockDim.x) s_slab[k] = (k * 7 + 13) & 255;
  for (int k = tid; k < 518; k += blockDim.x) s_mru[k] = 0;
  for (int k = tid; k < 258; k += blockDim.x) s_head[k] = 0;
  const uint4 nil4 = make_uint4(~0u, ~0u, ~0u, ~0u), zero4 = make_uint4(0, 0, 0, 0);
  for (int k = tid; k < kHashWords / 8; k += blockDim.x)
    reinterpret_cast<uint4*>(hash)[k] = nil4;
  for (int k = tid; k < kRingWords / 8; k += blockDim.x)
    reinterpret_cast<uint4*>(chain)[k] = nil4;
  for (int k = tid; k < kRingWords / 4; k += blockDim.x)
    reinterpret_cast<uint4*>(slot)[k] = zero4;
  __syncthreads();
  if (tid != 0) return;

  const Tables tb{hash, chain, slot, block, s_slab, s_head};
  const int* slab = s_slab;
  Pers ps;
  uint32_t acc = 0, ck = 0;
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int ipos = 1 + (i & 1023);
    if (!kWrap || s_slab[2047] < 999)
      find_match<kInsert, kWalk, kWhens, kLazy>(tb, ipos, depth, ps, ck);
    const bool found = ps.p0 != 0;
    const int mlen = ps.p1, midx = ps.p2;
    // the literal path: word-MRU check and update, staging, carries
    const int ctx = sb(slab, ipos - 1);
    const int ww = sb(slab, ipos) * 256 + sb(slab, ipos + 1);
    const int m0 = s_mru[ctx * 2], m1 = s_mru[ctx * 2 + 1];
    const bool hit0 = !found && m0 == ww;
    const bool hit1 = !found && !hit0 && m1 == ww;
    const bool is_lit = !found && !hit0 && !hit1;
    const int sym = found ? 258 + mlen
                          : hit0 ? 256 : hit1 ? 257 : sb(slab, ipos);
    const int kind = is_lit ? 1 : (hit0 || hit1) ? 2 : 3;
    stg[i & 511] = sym | kind << 10 | midx << 14;
    const int new_ipos = ipos + (found ? mlen : (hit0 || hit1) ? 2 : 1);
    const int cu = sb(slab, new_ipos - 3);
    const int wu = sb(slab, new_ipos - 2) * 256 + sb(slab, new_ipos - 1);
    const int old0 = s_mru[cu * 2];
    const bool push = found ? old0 != wu : (is_lit || hit1);
    const int pb = push ? cu * 2 : 514;
    s_mru[pb + 1] = old0;
    s_mru[pb] = wu;
    ck += static_cast<uint32_t>(m0) + m1 + old0;
    acc += sym;
  }
  finish(out, acc, ck, t0);
}

// PT0: three dependent loads a step.  With a power-of-two row count the
// row of a word is the TPU's mask; with any other (K4's footprint) it is
// the high half of word x rows, one multiply, where a division would put
// tens of cycles on the chain that K4's head -> slot -> byte chain does
// not pay, and the first load's word is the step times an odd constant,
// so that its rows spread over the table too.
template <bool kPow2>
__global__ void __launch_bounds__(kThreads)
serial3_kernel(int n, int rows, const int* __restrict__ table,
               unsigned long long* out) {
  if (threadIdx.x != 0) return;
  const uint32_t r = static_cast<uint32_t>(rows);
  auto row = [r](uint32_t x) { return kPow2 ? x & (r - 1) : __umulhi(x, r); };
  uint32_t acc = 0, ck = 0;
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const uint32_t u = i;
    const uint32_t a = table[row(kPow2 ? u : u * kSpread) * 128 + (u & 127)];
    const uint32_t b = table[row(a + u) * 128 + (a & 127)];
    const uint32_t c = table[row(b + u) * 128 + (b & 127)];
    acc += c;
    ck += a + b;
  }
  finish(out, acc, ck, t0);
}

using UnitFn = void (*)(int, int, uint16_t*, uint16_t*, uint32_t*,
                        const uint8_t*, int*, unsigned long long*);

// The nine configurations of probe_tokenize_cost.py::main, in its order.
const UnitFn kUnit[] = {
    unit_kernel<false, false, kOff, false, kLazyOff>,     // lit
    unit_kernel<true, false, kOff, false, kLazyOff>,      // lit+insert
    unit_kernel<true, true, kOff, false, kLazyOff>,       // lit+insert+walk
    unit_kernel<true, true, kNever, false, kLazyOff>,     // +whens(never)
    unit_kernel<true, true, kTaken, false, kLazyOff>,     // +whens(taken)
    unit_kernel<true, true, kNever, true, kLazyOff>,      // when-wrapped
    unit_kernel<true, true, kNever, false, kLazyNever>,   // +lazy(never)
    unit_kernel<true, true, kNever, false, kLazyTaken>,   // +lazy(taken)
    unit_kernel<true, true, kNever, false, kLazyPrefetch>,  // +lazy(prefetch)
};

}  // namespace

ZLT_API int zlp_unit(int config, int n, int depth, void* hash, void* chain,
                     void* slot, const void* block, void* stg, void* out,
                     void* stream) {
  if (config < 0 || config >= static_cast<int>(sizeof(kUnit) / sizeof(kUnit[0])))
    return static_cast<int>(cudaErrorInvalidValue);
  kUnit[config]<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, depth, static_cast<uint16_t*>(hash), static_cast<uint16_t*>(chain),
      static_cast<uint32_t*>(slot), static_cast<const uint8_t*>(block),
      static_cast<int*>(stg), static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

ZLT_API int zlp_serial3(int n, int rows, const void* table, void* out,
                        void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const int*>(table);
  auto* o = static_cast<unsigned long long*>(out);
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((rows & (rows - 1)) == 0)
    serial3_kernel<true><<<1, kThreads, 0, st>>>(n, rows, t, o);
  else
    serial3_kernel<false><<<1, kThreads, 0, st>>>(n, rows, t, o);
  return static_cast<int>(cudaGetLastError());
}
