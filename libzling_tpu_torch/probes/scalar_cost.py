"""Per-step costs of K1's and K2's loop constructs on the card.

Counterpart of ``tools/probe_scalar_cost.py``, with the same command line:

    python -m libzling_tpu_torch.probes.scalar_cost           # main, main2
    python -m libzling_tpu_torch.probes.scalar_cost --match   # main3

Probes (kernels in ``csrc/probes/scalar_cost.cu``), each beside its plain
version:

  PS0-PS6 ``loop_body``   the bodies v0-v6 of ``main`` (:46-146, run by
          ``run`` :24): loop overhead, 9 carries, shared-memory loads and a
          store, a rare branch, an indexed global load (the TPU's one-hot
          VMEM read), its read-modify-write, a register-array carry;
  PS10    ``entropy_body`` v10 of ``main2`` (:153): K1's loop body, its
          tables in shared memory as K1 holds them, tokens to global memory;
  PS11    ``dma_whens``   v11 (:212): a loop with a rare 16 KB refill and a
          rare 32 KB flush, both copied by the whole CTA;
  PS12    ``dma_copy``    ``mk_dma`` (:263): one CTA copying 32 KB, 16 KB or
          512 B between global and shared memory, 2000 times;
  PS20    ``match_body``  ``build_match_kernel`` (:307) via ``main3`` (:510):
          K2's match step in layers -- bit read + index, + ring, + MTF/MRU,
          + tail, + copy.  The TPU's ``+puts`` layer (put() blends into
          staged vector rows, the row flush and the reload) has no
          counterpart, because K2 writes bytes straight to the output, and
          is dropped; so is the staging-row store in its ``+ring`` layer.

Each takes the initial contents of the scratch the TPU probe reads before
it writes (``init``; the TPU probe leaves it uninitialised, and the timed
runs take zeros); a CPU ``init`` runs the plain version, a CUDA one the
kernel.  The plain
versions also return the final contents of the TPU probe's scratch arrays
(``Result.state``).  Loop counts are the TPU probe's: N = 4,000,000 steps;
N // 4 tokens for ``--match`` (two tokens a step); 2000 copies.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..device import resolve_device
from . import (MASK, Result, i32, launch, measure, on_card, out_words, read,
               report, shl, srl)

SOURCE = "libzling_tpu_torch/csrc/probes/scalar_cost.cu"

N = 4_000_000
ND = 2000
VM = 256 * 128                     # the (256, 128) i32 array of v4-v6

# PS0-PS6: name -> (the TPU probe's label, words of init)
LOOP_BODIES = {
    "v0": ("while 2-carry arith", 0),
    "v1": ("while 9-carry ~15 ops", 0),
    "v2": ("while + 2 smem ld + 1 st", 1024),
    "v3": ("while + rare branch", 1024),
    "v4": ("while + indexed L1 load", VM),
    "v5": ("while + indexed L1 rmw", VM),
    "v6": ("while + local-array carry", 0),
}
ENTROPY_INIT = 4096 + 4096 + 1024          # slab | lut1 [8][512] | lut2
HBM = 8192 * 64                            # v11's global buffer, words
WHENS_INIT = HBM + 4096 + 8192             # global buffer | slab | staging
DMA = (("dma smem->hbm 32KB", 8192, True), ("dma hbm->smem 16KB", 4096, False),
       ("dma smem->hbm 512B", 128, True))
MATCH_INIT = 4096 + 1024                   # lut1 [8][512] | lut2 [8][128]
# PS20 layers: name -> bits (1 ring, 2 MTF/MRU, 4 tail, 8 copy)
MATCH_LAYERS = (("match: bitread+idx", 0), ("match: +ring", 1),
                ("match: +mtf/mru", 3), ("match: +tail", 7),
                ("match: +copy (full)", 15))


def zero_init(words: int, device) -> torch.Tensor:
    return torch.zeros(words, dtype=torch.int32, device=device)


def _check_init(init: torch.Tensor, words: int, name: str) -> torch.Tensor:
    if init.dtype != torch.int32 or init.numel() != words:
        raise ValueError(f"{name}: init must be {words} int32 words")
    return init.reshape(-1).contiguous()


# ---- PS0-PS6 -----------------------------------------------------------

def loop_body(variant: str, n: int, init: torch.Tensor) -> Result:
    """Run body ``variant`` (v0-v6) for ``n`` steps from scratch ``init``."""
    if not on_card(init, "loop_body"):
        return loop_body_plain(variant, n, init)
    init = _check_init(init, LOOP_BODIES[variant][1], "loop_body")
    g = torch.zeros(VM, dtype=torch.int32, device=init.device)
    out = out_words(init.device)
    launch("zlp_loop", int(variant[1:]), n, init if init.numel() else g, g,
           out, ref=out)
    loop_body.launches += 1
    return read(out)


loop_body.launches = 0


def loop_body_plain(variant: str, n: int, init: torch.Tensor) -> Result:
    """The plain version of PS0-PS6."""
    s = init.reshape(-1).tolist()
    a = ck = 0
    if variant == "v0":
        for i in range(n):
            a += i & 7
        return Result(i32(a), n & MASK)
    if variant == "v1":
        b = d = e = f = g = h = k = 0
        for i in range(n):
            a = (a + (i & 7)) & MASK
            b ^= i
            d |= i & 1
            e = (e + (a & 3)) & MASK
            f = (f + (b & 1)) & MASK
            g ^= (d + e) & MASK
            h = (h + 1) & MASK
            k ^= h
        return Result(i32(a), (b ^ d ^ e ^ f ^ g ^ h ^ k) & MASK)
    if variant in ("v2", "v3", "v4"):
        for i in range(n):
            if variant == "v2":
                v = s[i & 1023]
                w = s[(i + a) & 1023]
                s[(i + 1) & 1023] = i32(v + w)
                ck += v + w
            elif variant == "v3":
                v = s[i & 1023]
                if v > 100000:
                    s[1023] = v
                w = s[1023] if v > 100000 else v
                v, ck = w, ck + v
            else:
                v = s[(i & 255) * 128 + (i & 127)]
                ck += v
            a = (a + (v & 3)) & MASK
        return Result(i32(a), ck & MASK, state=dict(s=s))
    if variant == "v5":
        for i in range(n):
            idx = (i & 255) * 128 + (i & 127)
            ck += s[idx]
            s[idx] = i32(a)
            a += 1
        return Result(i32(a), ck & MASK, state=dict(vm=s))
    if variant == "v6":
        cur, vm = [0] * 512, [0] * VM
        for i in range(n):
            cur[(i & 3) * 128 + (i & 127)] = i32(a)
            if (i & 511) == 511:
                row = ((i >> 9) & 63) * 512
                vm[row:row + 512] = cur
                ck += sum(cur)
                cur = [0] * 512
            a += 1
        return Result(i32(a + cur[0]), ck & MASK, state=dict(vm=vm))
    raise ValueError(f"loop_body: unknown variant {variant!r}")


# ---- PS10 ----------------------------------------------------------------

def entropy_body(n: int, init: torch.Tensor) -> Result:
    """K1's body for ``n`` tokens; init: slab | lut1 | lut2 (9216 words)."""
    if not on_card(init, "entropy_body"):
        return entropy_body_plain(n, init)
    init = _check_init(init, ENTROPY_INIT, "entropy_body")
    obuf = torch.zeros(8192, dtype=torch.int32, device=init.device)
    out = out_words(init.device)
    launch("zlp_entropy", n, init, obuf, out, ref=out)
    entropy_body.launches += 1
    return read(out)


entropy_body.launches = 0


def entropy_body_plain(n: int, init: torch.Tensor) -> Result:
    """The plain version of PS10."""
    t = init.reshape(-1).tolist()
    slab, lut1, lut2 = t[:4096], t[4096:8192], t[8192:]
    lo, hi, ck, obuf = 123456, 777, 0, [0] * 8192
    wpos, nbits, emitted, fb, bad = 2, 64, 0, 0, False
    while emitted < n and not bad:
        w = slab[wpos & 4095] & MASK
        if nbits < 32:
            lo = w if nbits == 0 else lo | shl(w, nbits)
            hi = 0 if nbits == 0 else srl(w, 32 - max(nbits, 1))
            wpos += 1
            nbits += 32
        e = lut1[lo & 0xFFF]
        if e < 0:
            fb = e & 7
        ev = fb if e < 0 else e
        bad = bad or ev < 0
        ev = max(ev, 0)
        sym = ev & 0xFFFF
        l1 = max(srl(ev, 16) & 31, 1)
        is_match = sym >= 258 and emitted + 1 < n
        e2 = lut2[srl(lo, l1) & 0xFF]
        bad = bad or (is_match and e2 < 0)
        e2 = max(e2, 0)
        l2, blen = e2 & 0xFF, (e2 >> 8) & 0xFF
        extra = srl(lo, l1 + l2) & ((shl(1, blen) - 1) & MASK)
        idxtok = (srl(e2, 16) + extra) & MASK
        nc = l1 + (l2 + blen if is_match else 0)
        lo = srl(lo, nc) | shl(hi, 32 - nc)
        hi = srl(hi, nc)
        nbits -= nc
        obuf[emitted & 8191] = sym
        obuf[(emitted + 1) & 8191] = i32(idxtok)
        ck = (ck + sym + idxtok) & MASK
        emitted += 2 if is_match else 1
        bad = bad or wpos > n
    return Result(i32(emitted), ck, state=dict(obuf=obuf))


# ---- PS11 ----------------------------------------------------------------

def dma_whens(n: int, init: torch.Tensor) -> Result:
    """The loop with rare refills and flushes; init: the (64 x 8192)-word
    global buffer | the 4096-word slab | the 8192-word staging buffer."""
    if not on_card(init, "dma_whens"):
        return dma_whens_plain(n, init)
    init = _check_init(init, WHENS_INIT, "dma_whens")
    hbm = torch.empty(HBM, dtype=torch.int32, device=init.device)
    out = out_words(init.device)
    launch("zlp_dma_whens", n, init, hbm, out, ref=out)
    dma_whens.launches += 1
    return read(out)


dma_whens.launches = 0


def dma_whens_plain(n: int, init: torch.Tensor) -> Result:
    """The plain version of PS11."""
    t = init.reshape(-1).tolist()
    hbm, slab, obuf = t[:HBM], t[HBM:HBM + 4096], t[HBM + 4096:]
    a = ck = 0
    for i in range(n):
        if (i & 8191) == 8191:
            base = ((i >> 13) & 63) * 4096
            slab = hbm[base:base + 4096]
        if (i & 4095) == 4095:
            base = ((i >> 12) & 63) * 8192
            hbm[base:base + 8192] = obuf
        v = slab[i & 4095]
        obuf[i & 8191] = i32(v + a)
        a = (a + (v & 3)) & MASK
        ck += v
    return Result(i32(a), ck & MASK, state=dict(slab=slab, obuf=obuf))


# ---- PS12 ----------------------------------------------------------------

def dma_copy(ndma: int, nwords: int, toward_global: bool,
             init: torch.Tensor) -> Result:
    """``ndma`` copies of ``nwords`` words between global and shared
    memory; init: the global buffer (64 x nwords words) | the shared one."""
    if not on_card(init, "dma_copy"):
        return dma_copy_plain(ndma, nwords, toward_global, init)
    init = _check_init(init, 65 * nwords, "dma_copy")
    hbm = init[:64 * nwords].clone()
    out = out_words(init.device)
    launch("zlp_dma", ndma, nwords, int(toward_global), init[64 * nwords:],
           hbm, out, ref=out)
    dma_copy.launches += 1
    return read(out)


dma_copy.launches = 0


def dma_copy_plain(ndma: int, nwords: int, toward_global: bool,
                   init: torch.Tensor) -> Result:
    """The plain version of PS12: word 1 sums every word loaded."""
    t = init.reshape(-1).to(torch.int64)
    smem = t[64 * nwords:]
    if toward_global:
        ck = ndma * int(smem.sum())
    else:
        region = t[:64 * nwords].reshape(64, nwords)
        times = torch.bincount(torch.arange(ndma) & 63, minlength=64)
        ck = int((region.sum(1) * times).sum())
        if ndma:
            smem = region[(ndma - 1) & 63]
    return Result(1, ck & MASK, state=dict(smem=smem.tolist()))


# ---- PS20 ----------------------------------------------------------------

def match_body(layers: int, n: int, init: torch.Tensor) -> Result:
    """K2's match step with ``layers`` (bits: 1 ring, 2 MTF/MRU, 4 tail, 8
    copy) until ``n`` tokens; init: lut1 | lut2 (5120 words).  The output
    starts as byte 0 in its first 128 bytes and 7 after them: the TPU
    probe sets every byte to 7, but in the layers that read the output its
    first staging-row store writes a zero row over the first 128 before
    anything reads them."""
    if not on_card(init, "match_body"):
        return match_body_plain(layers, n, init)
    init = _check_init(init, MATCH_INIT, "match_body")
    ring = torch.empty(256 * 4096, dtype=torch.int32, device=init.device)
    obytes = torch.empty(1024 * 128, dtype=torch.uint8, device=init.device)
    out = out_words(init.device)
    launch("zlp_match", layers, n, init, ring, obytes, out, ref=out)
    match_body.launches += 1
    return read(out)


match_body.launches = 0


def match_body_plain(layers: int, n: int, init: torch.Tensor) -> Result:
    """The plain version of PS20."""
    t = init.reshape(-1).tolist()
    lut1, lut2 = t[:4096], t[4096:]
    # the last write of build_match_kernel's init() loop to each slab slot
    slab = [((k + (16 if k < 256 else 15) * 4096) * 40503) & 0x7FFFFFFF
            for k in range(4096)]
    mtf = bytearray(k & 255 for k in range(257 * 256))
    mru, head = [0] * 516, [0] * 258
    ring = [0] * (256 * 4096)
    o = bytearray(128) + bytearray([7]) * (1023 * 128)
    lo, hi, ck = 123456, 777, 0
    wpos, nbits, emitted, opos, l1, fb = 2, 64, 0, 2, 1, 0
    while emitted < n:
        w = slab[wpos & 4095]
        if nbits < 32:
            nb = max(nbits, 1)
            lo |= shl(w, nb)
            hi = srl(w, 32 - nb)
            wpos += 1
            nbits += 32
        e = lut1[lo & 0xFFF]
        if e < 0:
            fb = e & 7
        ev = max(fb if e < 0 else e, 0)
        t_ = (ev & 0xFFFF) + 260
        hl = max(srl(ev, 16) & 31, 1)
        lo = srl(lo, hl) | shl(hi, 32 - hl)
        hi = srl(hi, hl)
        nbits -= hl
        e2 = max(lut2[lo & 0xFF], 0)
        hl2, blen = e2 & 0xFF, (e2 >> 8) & 0xFF
        extra = srl(lo, hl2) & ((shl(1, blen) - 1) & MASK)
        midx = ((srl(e2, 16) + extra) | 32) & MASK
        nc = max(hl2 + blen, 1)
        lo = srl(lo, nc) | shl(hi, 32 - nc)
        hi = srl(hi, nc)
        nbits -= nc
        emitted += 2
        ck += w + (e & MASK) + e2
        ctx = l1
        if layers & 1:
            base = (ctx & 255) * 4096
            h = (head[ctx] + 1) & 4095
            head[ctx] = h
            ck += ring[base + ((h - midx) & 4095)]
            ring[base + h] = opos
        if layers & 2:
            tl = t_ & 255
            lit = mtf[ctx * 256 + tl]
            j = slab[tl] & 255
            other = mtf[ctx * 256 + j]
            mtf[65536 + tl] = other
            mtf[65536 + j] = lit
            ck += lit + other + mru[514]
        src = max(opos - 32, 0)
        delta = max(opos - src, 1)
        comb = 0
        if layers & 4:
            k1 = 5 % delta
            k2 = k1 - 1 if k1 > 0 else delta - 1
            k3 = k2 - 1 if k2 > 0 else delta - 1
            pmax = len(o) - 1
            comb = (o[min(max(src + k1, 0), pmax)]
                    + (o[min(max(src + k2, 0), pmax)] << 8)
                    + (o[min(max(src + k3, 0), pmax)] << 16))
            ck += comb
        if layers & 8:
            for k in range(6):
                o[opos + k] = o[src + k]
        cb1, cb2, cb3 = comb & 255, (comb >> 8) & 255, (comb >> 16) & 255
        if layers & 2:
            wu = cb2 * 256 + cb1
            old0 = mru[cb3 * 2]
            pb = cb3 * 2 if old0 != wu else 514
            mru[pb + 1] = old0
            mru[pb] = wu
            ck += old0
        opos = ((opos + 6) & 65535) | 2
        l1 = cb1 | 1
    return Result(i32(emitted), ck & MASK, state=dict(
        slab=slab, mtf=list(mtf), mru=mru, head=head, ring=ring, out=list(o)))


# ---- the command line ------------------------------------------------------

def seeded_init(words: int, seed: int, device) -> torch.Tensor:
    """Random int32 scratch contents from a numpy seed (the card checks use
    these beside the zeros, so that both words carry information)."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(-2**31, 2**31, words, dtype=np.int64)
                           .astype(np.int32)).to(device)


def decode_tables(seed: int, device) -> torch.Tensor:
    """lut1 [8][512] | lut2 [8][128] from a numpy seed, shaped like K1's
    tables so that PS10 and PS20 decode their whole length: lut1 a symbol
    below 320 and a length 1-12, one entry in 16 negative (the fallback);
    lut2 a length and an extra-bit count 0-8 and a base below 4096."""
    rng = np.random.default_rng(seed)
    lut1 = rng.integers(0, 320, 4096) | rng.integers(1, 13, 4096) << 16
    neg = rng.random(4096) < 1 / 16
    lut1[neg] = -rng.integers(1, 2**31, int(neg.sum()))
    lut2 = (rng.integers(0, 9, 1024) | rng.integers(0, 9, 1024) << 8
            | rng.integers(0, 4096, 1024) << 16)
    return torch.as_tensor(np.concatenate([lut1, lut2]).astype(np.int32)) \
        .to(device)


def cases(n: int, device, seed: int | None = None):
    """Every probe of this module at ``n`` steps, as (row, name, steps,
    call): zero scratch, or seeded scratch (K1-shaped decode tables for
    PS10 and PS20)."""
    def init(words):
        return (zero_init(words, device) if seed is None
                else seeded_init(words, seed + words, device))

    def tables(words):
        return (zero_init(words, device) if seed is None
                else decode_tables(seed, device))

    out = []
    for v, (label, words) in LOOP_BODIES.items():
        out.append(("PS0-PS6", f"{v} {label}", n,
                    lambda v=v, x=init(words): loop_body(v, n, x)))
    x = torch.cat([init(4096), tables(MATCH_INIT)])
    out.append(("PS10", "entropy body replica", n,
                lambda x=x: entropy_body(n, x)))
    x = init(WHENS_INIT)
    out.append(("PS11", "loop + rare refill/flush", n,
                lambda x=x: dma_whens(n, x)))
    nd = min(n, ND)
    for label, nw, toward in DMA:
        x = init(65 * nw)
        out.append(("PS12", label, nd,
                    lambda nw=nw, t=toward, x=x: dma_copy(nd, nw, t, x)))
    nm = n // 4
    x = tables(MATCH_INIT)
    for label, bits in MATCH_LAYERS:
        out.append(("PS20", label, nm,
                    lambda b=bits, x=x: match_body(b, nm, x)))
    return out


# probe row -> (wrapper, the TPU probe it replaces)
ROWS = {
    "PS0-PS6": (loop_body, ("tools/probe_scalar_cost.py:24",)),
    "PS10": (entropy_body, ("tools/probe_scalar_cost.py:153",)),
    "PS11": (dma_whens, ("tools/probe_scalar_cost.py:212",)),
    "PS12": (dma_copy, ("tools/probe_scalar_cost.py:263",)),
    "PS20": (match_body, ("tools/probe_scalar_cost.py:307",)),
}


def measure_all(device="cuda", which=("main", "main2", "match")):
    """Time each probe of ``which`` at the TPU probe's loop counts on the
    card; one row each (``probes.measure`` plus row and name)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("scalar_cost: timing needs a CUDA device")
    groups = {"main": ("PS0-PS6",), "main2": ("PS10", "PS11", "PS12"),
              "match": ("PS20",)}
    want = {r for w in which for r in groups[w]}
    rows = []
    for row, name, steps, call in cases(N, dev):
        if row in want:
            rows.append(dict(measure(call, steps), row=row, name=name))
    for r in rows:
        if r["row"] == "PS12":          # per copy: us and GB/s
            nw = next(nw for label, nw, _ in DMA if label == r["name"])
            r["GBps"] = nw * 4 / r["ns_per_iter"]
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    match = "--match" in argv
    rows = measure_all("cuda", which=("match",) if match else
                       ("main", "main2"))
    print(f"{torch.cuda.get_device_name(0)}; N={N}", flush=True)
    for title, row, unit in (("PS0-PS6 loop bodies", "PS0-PS6", "iter"),
                             ("PS10 entropy body", "PS10", "token"),
                             ("PS11 rare copies", "PS11", "iter"),
                             ("PS12 copies", "PS12", "copy"),
                             ("PS20 match layers", "PS20", "token")):
        sel = [r for r in rows if r["row"] == row]
        if sel:
            report(title, sel, unit)
    for r in rows:
        if "GBps" in r:
            print(f"  {r['name']:28s} {r['ns_per_iter'] / 1e3:8.2f} us/copy "
                  f"({r['GBps']:.2f} GB/s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
