// Inner sampling loop of the benchmark's corpus generator (order-3 byte
// Markov chain; a frozen copy of the repository's corpus sampler).  Built
// with g++ into the benchmark's cache folder and loaded with ctypes; see
// benchmark/harness/corpus.py for the model construction.
#include <cstdint>
#include <cstddef>

extern "C" {

// ctx_off[16M+1]: for context c, entries ctx_off[c]..ctx_off[c+1] of
// syms/cum describe its next-byte CDF (cum is inclusive cumulative counts).
// Fallback: uniform draw from fallback[0..nfall).
// xorshift64* PRNG seeded by `seed`; output `n` bytes continuing `c0`.
void markov_sample(const uint32_t* ctx_off, const uint8_t* syms, const uint32_t* cum,
                   const uint8_t* fallback, size_t nfall,
                   uint64_t seed, uint32_t c0, uint8_t* out, size_t n) {
  uint64_t s = seed ? seed : 0x9e3779b97f4a7c15ull;
  uint32_t c = c0;
  for (size_t i = 0; i < n; i++) {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    uint64_t r = s * 0x2545F4914F6CDD1Dull;
    uint32_t lo = ctx_off[c], hi = ctx_off[c + 1];
    uint8_t b;
    if (lo == hi) {
      b = fallback[(size_t)(r % nfall)];
    } else {
      uint32_t total = cum[hi - 1];
      uint32_t t = (uint32_t)(r % total);
      // binary search first cum[j] > t
      uint32_t a = lo, e = hi;
      while (a < e) {
        uint32_t m = (a + e) / 2;
        if (cum[m] > t) e = m; else a = m + 1;
      }
      b = syms[a];
    }
    out[i] = b;
    c = ((c << 8) & 0xFFFF00) | b;
  }
}

}  // extern "C"
