"""K4's per-unit cost on the card, in layers.

Counterpart of ``tools/probe_tokenize_cost.py``, with the same command line:

    python -m libzling_tpu_torch.probes.tokenize_cost [N]   # N = 200,000

Probes (kernels in ``csrc/probes/tokenize_cost.cu``), each beside its plain
version:

  PT1 ``unit_body``  ``build_kernel`` (:51, via ``run`` :290) in the nine
      configurations of ``main`` (:368-386): the literal path (slab reads,
      word-MRU check and update, staging), + the hash insert, + a depth-1
      chain walk, + the probe-byte and LCP regions behind a never- or an
      always-taken branch, the call behind an always-taken branch, + the
      lazy probe never taken, taken, or with its loads hoisted above the
      walk.  The hash, chain and slot tables sit in global memory at K4's
      shapes and types, the block's bytes in global memory, the slab, heads
      and MRU in shared memory.  The TPU's funnel LCP is a 12-byte compare
      here (first differing index, else 999).  ``depth`` walks deeper than
      the TPU probe's one node.
  PT0 ``serial3``    ``serial3_kernel`` (:326): three dependent loads a step
      from an i32 table of rows x 128 words -- the TPU's (256, 128), or a
      seeded table at K4's 10.5 MB bucket footprint, whose 21,504 rows are
      reached by a multiply (``row_of``), not a division.

A CPU tensor (``block``, ``table``) runs the plain version, a CUDA one the
kernel.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..device import resolve_device
from . import (MASK, Result, i32, launch, measure, on_card, out_words, read,
               report)

SOURCE = "libzling_tpu_torch/csrc/probes/tokenize_cost.cu"

N = 200_000
NIL = 65535
BLOCK = 16384                 # the TPU probe's (128, 128) block, as bytes
# K4's bucket state of one block (hash, chain, slot): 10,485,760 bytes
K4_BUCKET_BYTES = 256 * (8192 * 2 + 4096 * 2 + 4096 * 4)
K4_ROWS = K4_BUCKET_BYTES // 512        # serial3 rows (128 i32 each)

# the nine configurations of probe_tokenize_cost.py::main, in its order:
# name, insert, walk, whens, when_wrap, lazy
CONFIGS = (
    ("lit", False, False, "off", False, "off"),
    ("lit+insert", True, False, "off", False, "off"),
    ("lit+insert+walk", True, True, "off", False, "off"),
    ("... +whens(never)", True, True, "never", False, "off"),
    ("... +whens(taken)", True, True, "taken", False, "off"),
    ("... when-wrapped", True, True, "never", True, "off"),
    ("... +lazy(never)", True, True, "never", False, "never"),
    ("... +lazy(taken)", True, True, "never", False, "taken"),
    ("... +lazy(prefetch)", True, True, "never", False, "prefetch"),
)


def default_block(device) -> torch.Tensor:
    """The TPU probe's block: every byte 7."""
    return torch.full((BLOCK,), 7, dtype=torch.uint8, device=device)


# ---- PT1 -------------------------------------------------------------------

def unit_body(config: int, n: int, block: torch.Tensor,
              depth: int = 1) -> Result:
    """``n`` units of configuration ``config`` (an index into CONFIGS) over
    the 16384-byte ``block``; ``depth`` chain nodes a walk at most."""
    if not on_card(block, "unit_body"):
        return unit_body_plain(config, n, block, depth)
    if block.dtype != torch.uint8 or block.numel() != BLOCK:
        raise ValueError("unit_body: block must be 16384 u8")
    if not 0 <= config < len(CONFIGS):
        raise ValueError(f"unit_body: no configuration {config}")
    dev = block.device
    hsh = torch.empty(256 * 8192, dtype=torch.int16, device=dev)
    chain = torch.empty(256 * 4096, dtype=torch.int16, device=dev)
    slot = torch.empty(256 * 4096, dtype=torch.int32, device=dev)
    stg = torch.empty(512, dtype=torch.int32, device=dev)
    out = out_words(dev)
    launch("zlp_unit", config, n, depth, hsh, chain, slot,
           block.contiguous(), stg, out, ref=out)
    unit_body.launches += 1
    return read(out)


unit_body.launches = 0


def unit_body_plain(config: int, n: int, block: torch.Tensor,
                    depth: int = 1) -> Result:
    """The plain version of PT1: the kernel's steps in Python."""
    _, insert, walk, whens, wrap, lazy = CONFIGS[config]
    blk = block.cpu().numpy().tobytes()
    slab = [(k * 7 + 13) & 255 for k in range(2048)]
    mru, head = [0] * 518, [0] * 258
    hsh = [NIL] * (256 * 8192)
    chain = [NIL] * (256 * 4096)
    slot = [0] * (256 * 4096)

    def sb(p):
        return slab[p & 2047]

    def u32le(p):
        return sb(p) | sb(p + 1) << 8 | sb(p + 2) << 16 | sb(p + 3) << 24

    def hash4(p):
        return (u32le(p) + sb(p + 2) * 137 + sb(p + 3) * 13337) & MASK

    def lcp12(a, b):
        for k in range(12):
            if blk[a + k] != blk[b + k]:
                return k
        return 999

    p0 = p1 = p2 = p5 = p6 = p7 = 0
    total = ck = 0
    for i in range(n):
        ipos = 1 + (i & 1023)
        if not wrap or slab[2047] < 999:            # find_match
            ctx = sb(ipos - 1)
            h = hash4(ipos)
            check, hslot = (h >> 13) & 255, h & 8191
            if insert:
                raw = hsh[ctx * 8192 + hslot]
                ck += raw
                node0 = raw & 4095
                headv = (head[ctx] + 1) & 4095
                head[ctx] = headv
                chain[ctx * 4096 + headv] = node0
                slot[ctx * 4096 + headv] = ipos | check << 24
                hsh[ctx * 8192 + hslot] = headv
            else:
                node0 = headv = ipos & 4095
            acc = node0
            if walk:
                searchable = (node0 != NIL and node0 != headv) \
                    or slab[2046] < 999
                if lazy == "prefetch":
                    lctx = sb(ipos)
                    lraw = hsh[lctx * 8192 + (hash4(ipos + 1) & 8191)]
                    lnode0 = lraw & 4095
                    ls = slot[lctx * 4096 + lnode0]
                    lnxt = chain[lctx * 4096 + lnode0]
                    ck += lraw + ls + lnxt
                wi, node = 0, node0 if searchable else 0
                best_len, best_node, prev_off = 3, 0, 0
                done = not searchable
                while not done:
                    s = slot[ctx * 4096 + node]
                    nxt_raw = chain[ctx * 4096 + node]
                    ck += s + nxt_raw
                    off = s & 0xFFFFFF
                    done = done or (wi > 0 and prev_off <= off)
                    probe_ok = False
                    if whens != "off":
                        g = slab[(off + wi) & 2047]
                        gate = not done and (g > 500 if whens == "never"
                                             else g >= 0)
                        if gate:
                            p5 = blk[(off + best_len) & 1023]
                            ck += p5
                        probe_ok = gate if whens == "taken" else \
                            gate and p5 == sb(ipos + best_len)
                        if probe_ok:
                            p6 = lcp12(ipos & 1023, off & 1023)
                            ck += p6
                    lcp = min(p6, 259) if probe_ok else 0
                    lcp = lcp if lcp >= 4 else 0
                    if lcp > best_len and not done:
                        best_node, best_len = node, lcp
                    done = done or best_len == 259 or wi + 1 >= depth
                    nxt = node if done else nxt_raw
                    done = done or nxt == NIL
                    node = node if done else nxt
                    prev_off = off
                    wi += 1
                acc += best_len + best_node
                if lazy != "off":
                    g = slab[(acc + ipos) & 2047]
                    p7 = 0
                    if g > 500 if lazy == "never" else g >= 0:
                        if lazy == "prefetch":
                            s, nxt = ls, lnxt
                        else:
                            lctx = sb(ipos)
                            lraw = hsh[lctx * 8192 + (hash4(ipos + 1) & 8191)]
                            lnode = lraw & 4095
                            s = slot[lctx * 4096 + lnode]
                            nxt = chain[lctx * 4096 + lnode]
                            ck += lraw + s + nxt
                        probe_at = best_len - 3
                        want = u32le(ipos + 1 + probe_at)
                        got = blk[((s & 0xFFFFFF) + probe_at) & 1023]
                        ck += got
                        p7 = int(got == (want & 255) or nxt == NIL)
                    acc += p7
            p0, p1, p2 = acc & 1, acc & 255, acc & 4095
        # the literal path: word-MRU check and update, staging, carries
        found, mlen, midx = p0 != 0, p1, p2
        ctx = sb(ipos - 1)
        ww = sb(ipos) * 256 + sb(ipos + 1)
        m0, m1 = mru[ctx * 2], mru[ctx * 2 + 1]
        hit0 = not found and m0 == ww
        hit1 = not found and not hit0 and m1 == ww
        is_lit = not (found or hit0 or hit1)
        sym = 258 + mlen if found else 256 if hit0 else 257 if hit1 \
            else sb(ipos)
        new_ipos = ipos + (mlen if found else 2 if hit0 or hit1 else 1)
        cu = sb(new_ipos - 3)
        wu = sb(new_ipos - 2) * 256 + sb(new_ipos - 1)
        old0 = mru[cu * 2]
        push = old0 != wu if found else (is_lit or hit1)
        pb = cu * 2 if push else 514
        mru[pb + 1] = old0
        mru[pb] = wu
        ck += m0 + m1 + old0
        total += sym
    return Result(i32(total), ck & MASK)


# ---- PT0 -------------------------------------------------------------------

def serial3(n: int, table: torch.Tensor) -> Result:
    """``n`` steps of three dependent loads from ``table`` (i32, rows x
    128)."""
    if not on_card(table, "serial3"):
        return serial3_plain(n, table)
    if table.dtype != torch.int32 or table.numel() % 128:
        raise ValueError("serial3: table must be i32 rows x 128")
    out = out_words(table.device)
    launch("zlp_serial3", n, table.numel() // 128, table.contiguous(), out,
           ref=out)
    serial3.launches += 1
    return read(out)


serial3.launches = 0


SPREAD = 0x9E3779B1


def row_of(x: int, rows: int) -> int:
    """PT0's row of the 32-bit word ``x``: the TPU's mask for a power of
    two, else the high half of x * rows."""
    x &= MASK
    return x & (rows - 1) if rows & (rows - 1) == 0 else (x * rows) >> 32


def serial3_plain(n: int, table: torch.Tensor) -> Result:
    """The plain version of PT0."""
    t = table.reshape(-1).tolist()
    rows = len(t) // 128
    first = 1 if rows & (rows - 1) == 0 else SPREAD
    acc = ck = 0
    for i in range(n):
        a = t[row_of(i * first, rows) * 128 + (i & 127)] & MASK
        b = t[row_of(a + i, rows) * 128 + (a & 127)] & MASK
        c = t[row_of(b + i, rows) * 128 + (b & 127)] & MASK
        acc += c
        ck += a + b
    return Result(i32(acc), ck & MASK)


def seeded_table(rows: int, seed: int, device) -> torch.Tensor:
    """A random i32 table of rows x 128 words from a numpy seed."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 2**32, rows * 128, dtype=np.uint64)
                           .astype(np.uint32).view(np.int32)).to(device)


# ---- the command line ------------------------------------------------------

def cases(n: int, device, seed: int | None = None):
    """Every probe of this module at ``n`` steps, as (row, name, steps,
    call): the TPU probe's block and a zero 128 KB serial3 table, or a
    random block and table from ``seed``; serial3 at K4's footprint is
    random in both.  Last, the walk layer at depths 2 and 4."""
    if seed is None:
        blk = default_block(device)
        small = torch.zeros(256 * 128, dtype=torch.int32, device=device)
    else:
        # a block of 3 byte values, so the LCP compares stop at varying k
        rng = np.random.default_rng(seed)
        blk = torch.as_tensor(rng.integers(0, 3, BLOCK, dtype=np.uint8)) \
            .to(device)
        small = seeded_table(256, seed, device)
    big = seeded_table(K4_ROWS, 7, device)      # random in both cases
    out = [("PT0", "serial3 (3 dep loads, 128 KB)", n,
            lambda: serial3(n, small)),
           ("PT0", "serial3 (random, 10.5 MB)", n, lambda: serial3(n, big))]
    for k, cfg in enumerate(CONFIGS):
        out.append(("PT1", cfg[0], n, lambda k=k: unit_body(k, n, blk)))
    for depth in (2, 4):        # deeper walks than the TPU probe's one node
        out.append(("PT1", f"lit+insert+walk depth {depth}", n,
                    lambda d=depth: unit_body(2, n, blk, d)))
    return out


# probe row -> (wrapper, the TPU probe it replaces)
ROWS = {
    "PT1": (unit_body, ("tools/probe_tokenize_cost.py:51",)),
    "PT0": (serial3, ("tools/probe_tokenize_cost.py:326",)),
}


def measure_all(device="cuda", n: int = N):
    """Time every probe at ``n`` steps on the card; one row each."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("tokenize_cost: timing needs a CUDA device")
    return [dict(measure(call, steps), row=row, name=name)
            for row, name, steps, call in cases(n, dev)]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else N
    rows = measure_all("cuda", n)
    print(f"{torch.cuda.get_device_name(0)}; N={n} units per variant",
          flush=True)
    report("PT0 serial3", [r for r in rows if r["row"] == "PT0"], "unit")
    report("PT1 unit body", [r for r in rows if r["row"] == "PT1"], "unit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
