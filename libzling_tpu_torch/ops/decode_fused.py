"""K3: fused chunk decode (Huffman bit read + ROLZ resolve) on the card.

Counterpart of ``libzling_tpu/ops/decode_fused.py``: the kernel
``_fused_kernel`` (via ``_fused_call``) and ``prepare_fused``.  One serial
pass over every chunk of a stream: the LSB-first canonical Huffman reader
feeds the ROLZ resolve state machine directly, with no token array.

Source note (``csrc/decode_fused.cu``, with K1's reader
``csrc/huffman.cuh`` and K2's resolve steps ``csrc/rolz.cuh``):
  * replaces ``libzling_tpu/ops/decode_fused.py::_fused_kernel``;
  * bound on this card: one dependent chain per token, not bandwidth (the
    payload and tables in, the bytes out: ~45 MB at 32 MiB, ~14 us at
    3.35 TB/s) -- the resolve is serial over the whole stream (each
    literal's context is the byte just decoded, the MTF table crosses
    blocks), and a match's ring slot is read under the context its
    previous token left: an L2 load (~300 cycles) on the chain, then its
    source bytes;
  * design: one CTA of two warps for the stream, no token array in global
    memory, in K2's form (``resolve_kernel.py``).  A producer warp loads
    each chunk's tables into shared memory and its lane 0 runs K1's reader
    ahead of the resolver, with the fused decoder's reading rules (no
    index bits for a block's two raw head bytes, a match without room for
    its index, a read past ``n_words`` and an invalid code end the chunk),
    into a ring of ``ENTRY_RING`` entries in shared memory, ``PIECE`` a
    piece, one entry a unit; mbarriers hand the pieces over and back, so a
    producer that is ahead sleeps.  The resolver warp clears the ring of
    token-start positions ([256, 4096], 4 MB, global memory) at each new
    block; its lane 0 runs K2's resolve steps one entry ahead (a match's
    last three bytes, the next context, are read from the copy's source,
    and the next match's ring slot is loaded as soon as that context is
    known) and walks a chunk a piece at a time: it waits for pieces and
    moves its output window (``WINDOW`` bytes of shared memory, the
    block's latest bytes, where a near match reads its source) to the u8
    output by bulk copies only between pieces.  The MTF table (u8 64 KB),
    the window, the entry ring and the word-MRU live in shared memory
    (231,192 B of the card's 232,448).

Status per chunk is (opos, tokens, bad, opos at chunk start, matches,
matches whose source lies at most ``WINDOW`` bytes back -- read from the
window on the card).  A chunk is bad on an invalid code, a read past
``n_words``, a match without room for its index, ``midx == 0``, an
unwritten ring slot, ``src >= opos``, ``opos > encpos`` or ``opos !=
encpos`` at its end -- the rejections of the JAX decoder.  After the first
bad chunk the rest are not decoded and are marked bad.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mtf as mops
from .entropy_kernel import M32, host_to, stage_chunks, tier_lookup
from .resolve_kernel import RING, WINDOW, Resolver
from ..utils import metrics

PIECE = 128            # csrc/decode_fused.cu: kPiece entries a piece (a batch)
ENTRY_RING = 2048      # csrc/decode_fused.cu: kTok entries in the entry ring
STATUS = 6             # status words a chunk


def prepare_fused(len1, len2, payloads, rlens, encpos, new_block, out_base,
                  device):
    """Stage the per-chunk tables and payload words on ``device``.

    len1/len2 [C,514]/[C,32] code lengths; payloads: per-chunk Huffman
    bitstream bytes; rlens/encpos/new_block [C]; out_base [C]: byte offset
    of the chunk's block in the output.  Returns the argument tuple of
    ``fused_decode`` (without ``out_size``).
    """
    with metrics.stage("dec.stage"):
        meta, order1, lut1, lut2, words, _, _ = stage_chunks(
            len1, len2, payloads, rlens, device)
        meta[:, 0, 3] = host_to(np.asarray(encpos, np.int32), device)
        meta[:, 0, 4] = host_to(np.asarray(new_block, np.int32), device)
        return (meta, order1, lut1, lut2, mops.initial_table(device),
                mops.mtf_next(device), words,
                host_to(np.asarray(out_base, np.int64), device))


def fused_decode(meta, order1, lut1, lut2, mtf0, mtfnext, words, out_base,
                 out_size: int):
    """Decode every chunk; returns (out u8 [out_size], status i32
    [C, STATUS]).

    CUDA tensors launch the kernel; CPU tensors run the plain version.
    """
    with metrics.stage("dec.k3"):
        if meta.device.type == "cpu":
            return fused_decode_plain(meta, order1, lut1, lut2, mtf0,
                                      mtfnext, words, out_base, out_size)
        if meta.device.type != "cuda":
            raise ValueError(
                f"fused_decode: unsupported device {meta.device}")
        from .. import _build

        C = meta.shape[0]
        args = (meta, order1, lut1, lut2, words)
        for a in args:
            if a.dtype != torch.int32 or not a.is_contiguous():
                raise ValueError(
                    "fused_decode: int32 contiguous tables expected")
        if mtf0.dtype != torch.uint8 or mtf0.shape != (256, 256):
            raise ValueError("fused_decode: mtf0 must be u8 [256, 256]")
        dev = meta.device
        _build.check_devices("fused_decode", dev, direct=args + (mtf0,),
                             copied=(mtfnext, out_base))
        with torch.cuda.device(dev):
            mtfnext = mtfnext.to(dev, torch.int32).contiguous()
            out_base = out_base.to(dev, torch.int64).contiguous()
            mtf0 = mtf0.contiguous().clone()          # 16-byte aligned copy
            out = torch.zeros(max(out_size, 1), dtype=torch.uint8,
                              device=dev)
            ring = torch.empty(256 * RING, dtype=torch.int32, device=dev)
            status = torch.empty((C, STATUS), dtype=torch.int32,
                                 device=dev)
            err = _build.lib().zlt_decode_fused(
                meta.data_ptr(), order1.data_ptr(), lut1.data_ptr(),
                lut2.data_ptr(), mtf0.data_ptr(), mtfnext.data_ptr(),
                words.data_ptr(), out_base.data_ptr(), C, out.data_ptr(),
                ring.data_ptr(), status.data_ptr(), _build.stream_ptr(meta))
        _build.check(err, "zlt_decode_fused")
        fused_decode.launches += 1
        return out[:out_size], status


fused_decode.launches = 0


def fused_decode_plain(meta, order1, lut1, lut2, mtf0, mtfnext, words,
                       out_base, out_size: int):
    """The plain version of K3: K1's reader (``entropy_kernel.py``) feeding
    K2's state machine (``resolve_kernel.Resolver``) in one Python walk."""
    C = meta.shape[0]
    o = bytearray(max(out_size, 1))
    r = Resolver(o, mtf0, mtfnext.cpu().tolist())
    status = torch.zeros((C, STATUS), dtype=torch.int32)
    wl = words.cpu().tolist()
    metal = meta[:, :4].cpu().tolist()
    bases = out_base.cpu().tolist()
    stop = False
    for c in range(C):
        if stop:
            status[c] = torch.tensor([0, 0, 1, 0, 0, 0])
            continue
        m = metal[c]
        n_words, rlen, wbase, encpos, new_block = m[0][:5]
        tier = (m[1], m[2], m[3])
        order = order1[c].reshape(-1).tolist()
        l1t = lut1[c].reshape(-1).tolist()
        l2t = lut2[c].reshape(-1).tolist()
        opos0 = r.start_chunk(bases[c], new_block, encpos)
        acc = (wl[wbase] & M32) | (wl[wbase + 1] & M32) << 32
        nbits, wpos, emitted, bad = 64, 2, 0, False
        while emitted < rlen:
            if nbits < 32:
                acc |= (wl[wbase + wpos] & M32) << nbits
                wpos += 1
                nbits += 32
            e = l1t[acc & 0xFFF]
            if e < 0:
                e = tier_lookup(acc & M32, tier, order)
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
            if r.opos <= 1:                      # raw head byte
                if not r.head_byte(t):
                    bad = True
                    break
                emitted += 1
                continue
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
                if not r.match(t, midx):
                    bad = True
                    break
                continue
            if not r.simple(t):                  # literal or word-MRU hit
                bad = True
                break
            emitted += 1
        bad = bad or (wpos * 32 - nbits > n_words * 32) or r.opos != encpos
        status[c] = torch.tensor([r.opos, emitted, int(bad), opos0,
                                  r.matches, r.near])
        stop = bad
    return torch.frombuffer(o, dtype=torch.uint8)[:out_size], status
