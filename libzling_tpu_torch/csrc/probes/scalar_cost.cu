// Card counterparts of tools/probe_scalar_cost.py: the cost of one loop
// step of the constructs K1 (entropy decode) and K2/K3 (resolve) are built
// from, on one thread of one CTA.  The plain versions and the wrappers are
// in probes/scalar_cost.py.
//
//   loop_kernel<V>   PS0-PS6, the bodies v0-v6 of main() (:46-146), run by
//                    `run` (:24, pallas_call :25): loop overhead, carries,
//                    shared-memory loads and stores, a rare branch, an
//                    indexed global load (the one-hot VMEM read), its
//                    read-modify-write, a register-array carry (the vreg
//                    blend, which nvcc has to put in local memory);
//   entropy_kernel   PS10, v10 of main2() (:153): K1's loop body with its
//                    tables in shared memory, tokens to global memory;
//   dma_whens_kernel PS11, v11 (:212, pallas_call :239): a loop with a rare
//                    16 KB refill and a rare 32 KB flush by the whole CTA;
//   dma_kernel       PS12, mk_dma (:263, pallas_call :283): one CTA copying
//                    global <-> shared, 16 bytes a thread-step;
//   match_kernel<L>  PS20, build_match_kernel (:307) via main3 (:510): K2's
//                    match step in layers.  The TPU's `+puts` layer (put()
//                    blends into staged vector rows, the row flush and the
//                    reload) has no counterpart: K2 writes bytes straight
//                    to the output, so it is dropped.
//
// What each measures on this card: cycles per loop step of one thread,
// i.e. the latency of its dependent chain of loads (shared memory, L1 or
// L2) and the instructions between them, which is what bounds K1 and K2.
#include "probe.cuh"
#include "../rolz.cuh"

namespace {

using namespace zlp;

constexpr int kVm = 256 * 128;      // the (256, 128) i32 VMEM array of v4-v6

// ---- PS0-PS6 -------------------------------------------------------------
// init: v2/v3 the 1024-word shared table, v4/v5 the (256, 128) array;
// g: the global (256, 128) array v5 writes and v6 flushes into.
template <int V>
__global__ void __launch_bounds__(kThreads)
loop_kernel(int n, const int* __restrict__ init, int* g,
            unsigned long long* out) {
  __shared__ int s[1024];
  if (V == 2 || V == 3)
    for (int k = threadIdx.x; k < 1024; k += blockDim.x) s[k] = init[k];
  if (V == 5) cta_copy(g, init, kVm);
  __syncthreads();
  if (threadIdx.x != 0) return;

  uint32_t a = 0, ck = 0;
  int i = 0;
  if constexpr (V == 0) {
    const long long t0 = clock64();
#pragma unroll 1
    for (; i < n; ++i) a += i & 7;
    finish(out, a, i, t0);
  } else if constexpr (V == 1) {
    uint32_t b = 0, d = 0, e = 0, f = 0, gg = 0, h = 0, k = 0;
    const long long t0 = clock64();
#pragma unroll 1
    for (uint32_t u = 0; i < n; ++i, ++u) {
      a += u & 7; b ^= u; d |= u & 1; e += a & 3;
      f += b & 1; gg ^= d + e; h += 1; k ^= h;
    }
    finish(out, a, b ^ d ^ e ^ f ^ gg ^ h ^ k, t0);
  } else if constexpr (V == 2) {
    const long long t0 = clock64();
#pragma unroll 1
    for (; i < n; ++i) {
      const int v = s[i & 1023];
      const int w = s[(i + a) & 1023];
      s[(i + 1) & 1023] = i32(static_cast<uint32_t>(v) + w);
      a += v & 3;
      ck += static_cast<uint32_t>(v) + w;
    }
    finish(out, a, ck, t0);
  } else if constexpr (V == 3) {
    const long long t0 = clock64();
#pragma unroll 1
    for (; i < n; ++i) {
      const int v = s[i & 1023];
      if (v > 100000) s[1023] = v;
      const int w = v > 100000 ? s[1023] : v;
      a += w & 3;
      ck += v;
    }
    finish(out, a, ck, t0);
  } else if constexpr (V == 4) {
    const long long t0 = clock64();
#pragma unroll 1
    for (; i < n; ++i) {
      const int v = init[(i & 255) * 128 + (i & 127)];
      a += v & 3;
      ck += v;
    }
    finish(out, a, ck, t0);
  } else if constexpr (V == 5) {
    const long long t0 = clock64();
#pragma unroll 1
    for (; i < n; ++i) {
      const int idx = (i & 255) * 128 + (i & 127);
      ck += g[idx];
      g[idx] = i32(a);
      a += 1;
    }
    finish(out, a, ck, t0);
  } else {  // V == 6: a [4][128] carry indexed at run time
    int cur[4][128];
    for (int r = 0; r < 4; ++r)
      for (int l = 0; l < 128; ++l) cur[r][l] = 0;
    const long long t0 = clock64();
#pragma unroll 1
    for (; i < n; ++i) {
      cur[i & 3][i & 127] = i32(a);
      if ((i & 511) == 511) {
        int* row = g + (((i >> 9) & 63) << 2) * 128;
        for (int r = 0; r < 4; ++r)
          for (int l = 0; l < 128; ++l) {
            row[r * 128 + l] = cur[r][l];
            ck += cur[r][l];
            cur[r][l] = 0;
          }
      }
      a += 1;
    }
    finish(out, a + cur[0][0], ck, t0);
  }
}

// ---- PS10: K1's loop body ------------------------------------------------
// init: slab [4096] | lut1 [8][512] | lut2 [8][128], all to shared memory.
__global__ void __launch_bounds__(kThreads)
entropy_kernel(int n, const int* __restrict__ init, int* obuf,
               unsigned long long* out) {
  __shared__ int s_slab[4096], s_lut1[4096], s_lut2[1024];
  for (int k = threadIdx.x; k < 4096; k += blockDim.x) {
    s_slab[k] = init[k];
    s_lut1[k] = init[4096 + k];
  }
  for (int k = threadIdx.x; k < 1024; k += blockDim.x)
    s_lut2[k] = init[8192 + k];
  __syncthreads();
  if (threadIdx.x != 0) return;

  uint32_t lo = 123456, hi = 777, ck = 0;
  int wpos = 2, nbits = 64, emitted = 0, obuf_n = 0, fb = 0;
  bool bad = false;
  const long long t0 = clock64();
#pragma unroll 1
  while (emitted < n && !bad) {
    const uint32_t w = static_cast<uint32_t>(s_slab[wpos & 4095]);
    if (nbits < 32) {
      lo = nbits == 0 ? w : lo | shl(w, nbits);
      hi = nbits == 0 ? 0u : srl(w, 32 - max(nbits, 1));
      wpos += 1;
      nbits += 32;
    }
    const int e = s_lut1[lo & 0xFFF];
    if (e < 0) fb = e & 7;
    int ev = e < 0 ? fb : e;
    bad = bad || ev < 0;
    ev = max(ev, 0);
    const int sym = ev & 0xFFFF;
    const int l1 = max(static_cast<int>(srl(ev, 16) & 31), 1);
    const bool is_match = sym >= 258 && emitted + 1 < n;
    const int p2 = static_cast<int>(srl(lo, l1) & 0xFF);
    int e2 = s_lut2[p2];
    bad = bad || (is_match && e2 < 0);
    e2 = max(e2, 0);
    const int l2 = e2 & 0xFF, blen = (e2 >> 8) & 0xFF;
    const uint32_t extra = srl(lo, l1 + l2) & (shl(1u, blen) - 1u);
    const uint32_t idxtok = srl(e2, 16) + extra;
    const int nc = l1 + (is_match ? l2 + blen : 0);
    lo = srl(lo, nc) | shl(hi, 32 - nc);
    hi = srl(hi, nc);
    nbits -= nc;
    obuf[obuf_n & 8191] = sym;
    obuf[(obuf_n + 1) & 8191] = i32(idxtok);
    ck += sym + idxtok;
    const int adv = 1 + (is_match ? 1 : 0);
    obuf_n += adv;
    emitted += adv;
    bad = bad || wpos > n;
  }
  finish(out, emitted, ck, t0);
}

// ---- PS11: a loop with a rare refill and a rare flush ---------------------
// init: the (64 x 8192)-word global buffer (copied to hbm first) | the
// 4096-word slab | the 8192-word staging buffer (to shared).  Thread 0
// runs the loop steps between two copies; at step i with (i & 4095) ==
// 4095 the whole CTA refills the 16 KB slab (if (i & 8191) == 8191) and
// then flushes the 32 KB staging buffer, as the TPU probe's two DMAs.
constexpr int kHbm = 8192 * 64;
constexpr int kWhensSmem = 4 * (4096 + 8192);

__global__ void __launch_bounds__(kThreads)
dma_whens_kernel(int n, const int* __restrict__ init, int* hbm,
                 unsigned long long* out) {
  extern __shared__ __align__(16) int smem[];
  int* s_slab = smem;
  int* s_obuf = smem + 4096;
  cta_copy(hbm, init, kHbm);
  cta_copy(smem, init + kHbm, 4096 + 8192);
  __syncthreads();

  uint32_t a = 0, ck = 0;
  int i = 0;
  const long long t0 = clock64();
#pragma unroll 1
  while (true) {
    const int stop = min(n, i | 4095);
    if (threadIdx.x == 0) {
#pragma unroll 1
      for (int j = i; j < stop; ++j) {
        const int v = s_slab[j & 4095];
        s_obuf[j & 8191] = i32(v + a);
        a += v & 3;
        ck += v;
      }
    }
    i = stop;
    if (i >= n) break;
    __syncthreads();
    if ((i & 8191) == 8191) {
      cta_copy(s_slab, hbm + ((i >> 13) & 63) * 4096, 4096);
      __syncthreads();
    }
    cta_copy(hbm + ((i >> 12) & 63) * 8192, s_obuf, 8192);
    __syncthreads();
    if (threadIdx.x == 0) {
      const int v = s_slab[i & 4095];
      s_obuf[i & 8191] = i32(v + a);
      a += v & 3;
      ck += v;
    }
    ++i;
  }
  if (threadIdx.x == 0) finish(out, a, ck, t0);
}

// ---- PS12: copies between global and shared memory ------------------------
// ndma copies of nwords words, to hbm + (i & 63) * nwords (toward_global)
// or from it.  smem_init: the shared buffer's first contents.  Word 1 is
// the sum of every word the CTA loaded (one atomicAdd a thread at the end).
__global__ void __launch_bounds__(kThreads)
dma_kernel(int ndma, int nwords, int toward_global,
           const int* __restrict__ smem_init, int* hbm,
           unsigned long long* out) {
  extern __shared__ __align__(16) int smem[];
  cta_copy(smem, smem_init, nwords);
  __syncthreads();
  int4* s4 = reinterpret_cast<int4*>(smem);
  uint32_t ck = 0;
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < ndma; ++i) {
    int4* g4 = reinterpret_cast<int4*>(hbm + (i & 63) * nwords);
    for (int k = threadIdx.x; k < nwords / 4; k += blockDim.x) {
      const int4 v = toward_global ? s4[k] : g4[k];
      if (toward_global) g4[k] = v; else s4[k] = v;
      ck += static_cast<uint32_t>(v.x) + v.y + v.z + v.w;
    }
    __syncthreads();
  }
  const long long t1 = clock64();
  atomicAdd(&out[1], static_cast<unsigned long long>(ck));
  if (threadIdx.x == 0) {
    out[0] = 1;
    out[2] = static_cast<unsigned long long>(t1 - t0);
  }
}

// ---- PS20: K2's match step in layers ---------------------------------------
// Layer bits: 1 ring (head bump, source slot load, insert; the ring in
// global memory as ResolverT has it), 2 MTF swap + word-MRU (shared), 4 the
// source-side tail (three byte loads that feed the next context), 8 the
// copy (copy_match, 6 bytes from 32 back).  init: lut1 [8][512] | lut2
// [8][128]; the rest is set up as build_match_kernel's init() does, but
// for the output's first 128 bytes, which start at 0: in the layers that
// read the output, the TPU probe's first staging-row store writes a zero
// row there before anything reads it.
constexpr int kOut = 1024 * 128;    // output bytes: the TPU's (1024, 128)
constexpr int kMatchSmem = 4 * (4096 + 4096 + 1024 + 516 + 258) + 257 * 256;

template <int L>
__global__ void __launch_bounds__(kThreads)
match_kernel(int n, const int* __restrict__ init, int* ring, uint8_t* o,
             unsigned long long* out) {
  extern __shared__ __align__(16) int smem[];
  int* slab = smem;
  int* lut1 = slab + 4096;
  int* lut2 = lut1 + 4096;
  int* mru = lut2 + 1024;
  int* head = mru + 516;
  uint8_t* mtf = reinterpret_cast<uint8_t*>(head + 258);
  for (int k = threadIdx.x; k < 4096; k += blockDim.x) {
    // the last write of init()'s loop over 257 * 256 steps to slot k
    const uint32_t j = k < 256 ? 16 * 4096 + k : 15 * 4096 + k;
    slab[k] = static_cast<int>((j * 40503u) & 0x7FFFFFFFu);
    lut1[k] = init[k];
  }
  for (int k = threadIdx.x; k < 1024; k += blockDim.x) lut2[k] = init[4096 + k];
  for (int k = threadIdx.x; k < 516; k += blockDim.x) mru[k] = 0;
  for (int k = threadIdx.x; k < 258; k += blockDim.x) head[k] = 0;
  for (int k = threadIdx.x; k < 257 * 256; k += blockDim.x) mtf[k] = k & 255;
  for (int k = threadIdx.x; k < 256 * zlt::kRing / 4; k += blockDim.x)
    reinterpret_cast<int4*>(ring)[k] = make_int4(0, 0, 0, 0);
  for (int k = threadIdx.x; k < kOut / 4; k += blockDim.x)
    reinterpret_cast<uint32_t*>(o)[k] = k < 32 ? 0u : 0x07070707u;
  __syncthreads();
  if (threadIdx.x != 0) return;

  uint32_t lo = 123456, hi = 777, ck = 0;
  int wpos = 2, nbits = 64, emitted = 0, opos = 2, l1 = 1, fb = 0;
  const long long t0 = clock64();
#pragma unroll 1
  while (emitted < n) {
    // bit read + match index (K1/K3's reader, tables in shared memory)
    const uint32_t w = static_cast<uint32_t>(slab[wpos & 4095]);
    if (nbits < 32) {
      const int nb = max(nbits, 1);
      lo |= shl(w, nb);
      hi = srl(w, 32 - nb);
      wpos += 1;
      nbits += 32;
    }
    const int e = lut1[lo & 0xFFF];
    if (e < 0) fb = e & 7;
    const int ev = max(e < 0 ? fb : e, 0);
    const int t = (ev & 0xFFFF) + 260;
    const int hl = max(static_cast<int>(srl(ev, 16) & 31), 1);
    lo = srl(lo, hl) | shl(hi, 32 - hl);
    hi = srl(hi, hl);
    nbits -= hl;
    const int e2 = max(lut2[lo & 0xFF], 0);
    const int hl2 = e2 & 0xFF, blen = (e2 >> 8) & 0xFF;
    const uint32_t extra = srl(lo, hl2) & (shl(1u, blen) - 1u);
    const uint32_t midx = (srl(e2, 16) + extra) | 32u;
    const int nc = max(hl2 + blen, 1);
    lo = srl(lo, nc) | shl(hi, 32 - nc);
    hi = srl(hi, nc);
    nbits -= nc;
    emitted += 2;
    ck += w + static_cast<uint32_t>(e) + e2;

    const int ctx = l1;
    if constexpr ((L & 1) != 0) {  // ring: head bump, source load, insert
      int* rg = ring + (ctx & 255) * zlt::kRing;
      const int h = (head[ctx] + 1) & 4095;
      head[ctx] = h;
      ck += rg[(h - midx) & 4095u];
      rg[h] = opos;
    }
    if constexpr ((L & 2) != 0) {  // sticky-MTF swap in the dummy row
      const int tl = t & 255;
      const int lit = mtf[ctx * 256 + tl];
      const int j = slab[tl] & 255;
      const int other = mtf[ctx * 256 + j];
      mtf[256 * 256 + tl] = static_cast<uint8_t>(other);
      mtf[256 * 256 + j] = static_cast<uint8_t>(lit);
      ck += lit + other + mru[514];
    }
    const int src = max(opos - 32, 0);
    constexpr int mlen = 6;
    const int delta = max(opos - src, 1);
    uint32_t comb = 0;
    if constexpr ((L & 4) != 0) {  // tail: the bytes at src + k1..k3
      const int k1 = (mlen - 1) % delta;
      const int k2 = k1 > 0 ? k1 - 1 : delta - 1;
      const int k3 = k2 > 0 ? k2 - 1 : delta - 1;
      const int pmax = kOut - 1;
      comb = o[min(max(src + k1, 0), pmax)] +
             (static_cast<uint32_t>(o[min(max(src + k2, 0), pmax)]) << 8) +
             (static_cast<uint32_t>(o[min(max(src + k3, 0), pmax)]) << 16);
      ck += comb;
    }
    if constexpr ((L & 8) != 0) zlt::copy_match(o, opos, src, mlen);
    const int cb1 = comb & 255, cb2 = (comb >> 8) & 255, cb3 = (comb >> 16) & 255;
    if constexpr ((L & 2) != 0) {  // word-MRU probe and push
      const int wu = cb2 * 256 + cb1;
      const int old0 = mru[cb3 * 2];
      const int pb = old0 != wu ? cb3 * 2 : 514;
      mru[pb + 1] = old0;
      mru[pb] = wu;
      ck += old0;
    }
    opos = ((opos + mlen) & 65535) | 2;
    l1 = cb1 | 1;
  }
  finish(out, emitted, ck, t0);
}

}  // namespace

ZLT_API int zlp_loop(int variant, int n, const void* init, void* g, void* out,
                     void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int* in = static_cast<const int*>(init);
  int* gg = static_cast<int*>(g);
  auto* o = static_cast<unsigned long long*>(out);
  switch (variant) {
    case 0: loop_kernel<0><<<1, kThreads, 0, st>>>(n, in, gg, o); break;
    case 1: loop_kernel<1><<<1, kThreads, 0, st>>>(n, in, gg, o); break;
    case 2: loop_kernel<2><<<1, kThreads, 0, st>>>(n, in, gg, o); break;
    case 3: loop_kernel<3><<<1, kThreads, 0, st>>>(n, in, gg, o); break;
    case 4: loop_kernel<4><<<1, kThreads, 0, st>>>(n, in, gg, o); break;
    case 5: loop_kernel<5><<<1, kThreads, 0, st>>>(n, in, gg, o); break;
    case 6: loop_kernel<6><<<1, kThreads, 0, st>>>(n, in, gg, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

ZLT_API int zlp_entropy(int n, const void* init, void* obuf, void* out,
                        void* stream) {
  entropy_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const int*>(init), static_cast<int*>(obuf),
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

ZLT_API int zlp_dma_whens(int n, const void* init, void* hbm, void* out,
                          void* stream) {
  cudaFuncSetAttribute(dma_whens_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kWhensSmem);
  dma_whens_kernel<<<1, kThreads, kWhensSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const int*>(init), static_cast<int*>(hbm),
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

ZLT_API int zlp_dma(int ndma, int nwords, int toward_global,
                    const void* smem_init, void* hbm, void* out, void* stream) {
  if (nwords % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = 4 * nwords;
  cudaFuncSetAttribute(dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  dma_kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      ndma, nwords, toward_global, static_cast<const int*>(smem_init),
      static_cast<int*>(hbm), static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int L>
static int launch_match(int n, const void* init, void* ring, void* o,
                        void* out, cudaStream_t st) {
  cudaFuncSetAttribute(match_kernel<L>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kMatchSmem);
  match_kernel<L><<<1, kThreads, kMatchSmem, st>>>(
      n, static_cast<const int*>(init), static_cast<int*>(ring),
      static_cast<uint8_t*>(o), static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

ZLT_API int zlp_match(int layers, int n, const void* init, void* ring,
                      void* obytes, void* out, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  switch (layers) {
    case 0: return launch_match<0>(n, init, ring, obytes, out, st);
    case 1: return launch_match<1>(n, init, ring, obytes, out, st);
    case 3: return launch_match<3>(n, init, ring, obytes, out, st);
    case 7: return launch_match<7>(n, init, ring, obytes, out, st);
    case 15: return launch_match<15>(n, init, ring, obytes, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
