"""K3: fused chunk decode (Huffman bit read + ROLZ resolve) on the card.

Counterpart of ``libzling_tpu/ops/decode_fused.py``: the kernel
``_fused_kernel`` (via ``_fused_call``) and ``prepare_fused``.  One serial
pass over every chunk of a stream: the LSB-first canonical Huffman reader
feeds the ROLZ resolve state machine directly, with no token array.

Source note (``csrc/decode_fused.cu``):
  * replaces ``libzling_tpu/ops/decode_fused.py::_fused_kernel``;
  * bound on this card: one dependent chain per token -- the resolve is
    serial over the whole stream (each literal's context is the byte just
    decoded, the MTF table crosses blocks), so the kernel runs on one
    thread of one CTA and is bound by the latency of its loads (shared
    memory for tables, L2 for the ring and match sources), not by
    bandwidth;
  * design: the chunk loop runs inside the CTA where the TPU ran a
    sequential grid.  The MTF table (u8 64 KB), the chunk's Huffman tables
    and the word-MRU live in dynamic shared memory; the ring ([256, 4096]
    positions, 4 MB) lives in global memory and is cleared by the whole CTA
    at each new block; all 256 threads load each chunk's tables between
    ``__syncthreads()``, then thread 0 walks the chunk.  Output bytes go
    straight into a u8 tensor at the block's offset.

Status per chunk is (opos, tokens, bad, opos at chunk start).  A chunk is
bad on an invalid code, a read past ``n_words``, a match without room for
its index, ``midx == 0``, an unwritten ring slot, ``src >= opos``,
``opos > encpos`` or ``opos != encpos`` at its end -- the rejections of the
JAX decoder.  After the first bad chunk the rest are not decoded and are
marked bad.
"""

from __future__ import annotations

import numpy as np
import torch

from libzling_tpu.tables import MATCH_MIN_LEN
from . import mtf as mops
from .entropy_kernel import build_chunk_tables, pack_payload_words

RING = 4096


def prepare_fused(len1, len2, payloads, rlens, encpos, new_block, out_base,
                  device):
    """Stage the per-chunk tables and payload words on ``device``.

    len1/len2 [C,514]/[C,32] code lengths; payloads: per-chunk Huffman
    bitstream bytes; rlens/encpos/new_block [C]; out_base [C]: byte offset
    of the chunk's block in the output.  Returns the argument tuple of
    ``fused_decode`` (without ``out_size``).
    """
    words, word_base, n_words = pack_payload_words(payloads)

    def t(a):
        return torch.as_tensor(np.asarray(a).astype(np.int64), device=device)

    meta, order1, lut1, lut2 = build_chunk_tables(
        t(len1), t(len2), t(n_words), t(word_base), t(rlens))
    meta[:, 0, 3] = t(encpos).to(torch.int32)
    meta[:, 0, 4] = t(new_block).to(torch.int32)
    return (meta, order1, lut1, lut2, mops.initial_table(device),
            mops.mtf_next(device), torch.as_tensor(words, device=device),
            t(out_base))


def fused_decode(meta, order1, lut1, lut2, mtf0, mtfnext, words, out_base,
                 out_size: int):
    """Decode every chunk; returns (out u8 [out_size], status i32 [C, 4]).

    CUDA tensors launch the kernel; CPU tensors run the plain version.
    """
    if meta.device.type == "cpu":
        return fused_decode_plain(meta, order1, lut1, lut2, mtf0, mtfnext,
                                  words, out_base, out_size)
    if meta.device.type != "cuda":
        raise ValueError(f"fused_decode: unsupported device {meta.device}")
    from .. import _build

    C = meta.shape[0]
    args = (meta, order1, lut1, lut2, words)
    for a in args:
        if a.dtype != torch.int32 or not a.is_contiguous():
            raise ValueError("fused_decode: int32 contiguous tables expected")
    if mtf0.dtype != torch.uint8 or mtf0.shape != (256, 256):
        raise ValueError("fused_decode: mtf0 must be u8 [256, 256]")
    mtfnext = mtfnext.to(torch.int32).contiguous()
    out_base = out_base.to(torch.int64).contiguous()
    mtf0 = mtf0.contiguous().clone()          # 16-byte aligned copy
    out = torch.zeros(max(out_size, 1), dtype=torch.uint8, device=meta.device)
    ring = torch.empty(256 * RING, dtype=torch.int32, device=meta.device)
    status = torch.empty((C, 4), dtype=torch.int32, device=meta.device)
    err = _build.lib().zlt_decode_fused(
        meta.data_ptr(), order1.data_ptr(), lut1.data_ptr(), lut2.data_ptr(),
        mtf0.data_ptr(), mtfnext.data_ptr(), words.data_ptr(),
        out_base.data_ptr(), C, out.data_ptr(), ring.data_ptr(),
        status.data_ptr(), _build.stream_ptr(meta))
    _build.check(err, "zlt_decode_fused")
    fused_decode.launches += 1
    return out[:out_size], status


fused_decode.launches = 0


def _tier_lookup(lo: int, tier, order) -> int:
    """Alphabet-1 codes of 13..15 bits: the canonical tier compare."""
    v = lo & 0x7FFF
    v15 = int(f"{v:015b}"[::-1], 2)          # the MSB-first view
    for ln in range(13, 16):
        top = v15 >> (15 - ln)
        s, cnt, base = tier[0][ln], tier[1][ln], tier[2][ln]
        if s <= top < s + cnt:
            pos = min(max(base + top - s, 0), 1023)
            return order[pos] | (ln << 16)
    return -1


def fused_decode_plain(meta, order1, lut1, lut2, mtf0, mtfnext, words,
                       out_base, out_size: int):
    """The plain version of K3: the same serial walk in Python.

    State lives in torch tensors (accessed through their numpy views);
    inputs are read as Python lists.
    """
    C = meta.shape[0]
    out = torch.zeros(max(out_size, 1), dtype=torch.uint8)
    ring_t = torch.zeros(256 * RING, dtype=torch.int32)
    mtf_t = mtf0.cpu().clone().reshape(-1)
    mru_t = torch.zeros(512, dtype=torch.int32)
    head_t = torch.zeros(256, dtype=torch.int32)
    status = torch.zeros((C, 4), dtype=torch.int32)
    o, ring, mtf, mru, head = (out.numpy(), ring_t.numpy(), mtf_t.numpy(),
                               mru_t.numpy(), head_t.numpy())
    nxt = mtfnext.cpu().tolist()
    wl = words.cpu().tolist()
    metal = meta.cpu().tolist()
    bases = out_base.cpu().tolist()
    opos = 0
    stop = False
    for c in range(C):
        if stop:
            status[c] = torch.tensor([0, 0, 1, 0])
            continue
        m = metal[c]
        n_words, rlen, wbase, encpos, new_block = m[0][:5]
        tier = (m[1], m[2], m[3])
        order = [x for row in order1[c].tolist() for x in row]
        l1t = [x for row in lut1[c].tolist() for x in row]
        l2t = [x for row in lut2[c].tolist() for x in row]
        if new_block:
            ring[:] = 0
            head[:] = 0
            opos = 0
        mru[:] = 0
        base = bases[c]
        opos0 = opos
        l1 = int(o[base + opos - 1]) if opos >= 1 else 0
        l2 = int(o[base + opos - 2]) if opos >= 2 else 0
        acc = (wl[wbase] & 0xFFFFFFFF) | (wl[wbase + 1] & 0xFFFFFFFF) << 32
        nbits, wpos, emitted, bad = 64, 2, 0, False
        while emitted < rlen:
            if nbits < 32:
                acc |= (wl[wbase + wpos] & 0xFFFFFFFF) << nbits
                wpos += 1
                nbits += 32
            e = l1t[acc & 0xFFF]
            if e < 0:
                e = _tier_lookup(acc & 0xFFFFFFFF, tier, order)
            if e < 0:
                bad = True
                break
            t = e & 0xFFFF
            hl = max((e >> 16) & 31, 1)
            acc >>= hl
            nbits -= hl
            if wpos > n_words:
                bad = True
                break
            if opos <= 1:                        # raw head byte
                if opos + 1 > encpos:
                    bad = True
                    break
                b = t & 255
                o[base + opos] = b
                opos += 1
                emitted += 1
                l1, l2 = b, l1
                continue
            ctx = l1
            if t >= 258:                         # match
                if emitted + 1 >= rlen:
                    bad = True
                    break
                e2 = l2t[acc & 0xFF]
                if e2 < 0:
                    bad = True
                    break
                hl2, blen = e2 & 0xFF, (e2 >> 8) & 0xFF
                midx = (e2 >> 16) + ((acc >> hl2) & ((1 << blen) - 1))
                acc >>= hl2 + blen
                nbits -= hl2 + blen
                emitted += 2
                h = (int(head[ctx]) + 1) & (RING - 1)
                head[ctx] = h
                src = int(ring[ctx * RING + ((h - midx) & (RING - 1))])
                ring[ctx * RING + h] = opos
                mlen = t - 258 + MATCH_MIN_LEN
                if midx == 0 or src == 0 or src >= opos \
                        or opos + mlen > encpos:
                    bad = True
                    break
                for k in range(mlen):
                    o[base + opos + k] = o[base + src + k]
                opos += mlen
                cu = int(o[base + opos - 3])
                l2, l1 = int(o[base + opos - 2]), int(o[base + opos - 1])
                wu = l2 << 8 | l1
                if mru[cu * 2] != wu:
                    mru[cu * 2 + 1] = mru[cu * 2]
                    mru[cu * 2] = wu
                continue
            n = 1 if t < 256 else 2
            if opos + n > encpos:
                bad = True
                break
            h = (int(head[ctx]) + 1) & (RING - 1)
            head[ctx] = h
            ring[ctx * RING + h] = opos
            emitted += 1
            if t < 256:                          # literal
                lit = int(mtf[ctx * 256 + t])
                j = nxt[t]
                mtf[ctx * 256 + t] = mtf[ctx * 256 + j]
                mtf[ctx * 256 + j] = lit
                o[base + opos] = lit
                mru[l2 * 2 + 1] = mru[l2 * 2]
                mru[l2 * 2] = ctx << 8 | lit
                opos += 1
                l1, l2 = lit, ctx
            else:                                # word-MRU hit
                wv = int(mru[ctx * 2 + (t & 1)])
                b0, b1 = (wv >> 8) & 255, wv & 255
                o[base + opos] = b0
                o[base + opos + 1] = b1
                if t == 257:
                    mru[ctx * 2 + 1] = mru[ctx * 2]
                    mru[ctx * 2] = wv
                opos += 2
                l1, l2 = b1, b0
        bad = bad or (wpos * 32 - nbits > n_words * 32) or opos != encpos
        status[c] = torch.tensor([opos, emitted, int(bad), opos0])
        stop = bad
    return out[:out_size], status
