"""K2: the serial ROLZ resolve of a token stream to bytes, on the card.

Counterpart of ``libzling_tpu/ops/resolve_kernel.py``: the kernel
``_resolve_kernel`` (via ``_resolve_call``, entry ``resolve_stream``).  It
turns the tokens of every chunk (K1's flat layout, ``entropy_kernel.py``)
into bytes: a block's two raw head bytes, sticky-MTF literals, word-MRU hits
256/257 and ring matches (256 contexts x 4096 positions, reset per block),
with the MTF table carried in (``mtf0``) and out (``mtf_out``) so that a
stream can be resolved a group of blocks at a time (``group_decode.py``).

Source note (``csrc/resolve.cu``):
  * replaces ``libzling_tpu/ops/resolve_kernel.py::_resolve_kernel``;
  * bound on this card: one dependent chain per token, as K3 without the
    bit reader -- one thread of one CTA walks the stream, bound by the
    latency of its loads, not by bandwidth: a match's chain is its ring
    slot (L2: the ring is 4 MB) and then its source bytes, whose last one
    is the next context;
  * design: one CTA of two warps; the chunk loop runs inside it where the
    TPU ran a sequential grid.  A producer warp stages every chunk's tokens
    into a ring of ``TOKEN_RING`` tokens in shared memory by bulk copies
    (TMA, completed on mbarriers) ahead of the resolver, so no token load
    is on its chain.  The resolver shares K3's match step
    (``csrc/rolz.cuh``: the next context comes from the copy's source
    bytes, the next match's ring slot is loaded as soon as that context is
    known) with an output window on: every byte goes to a circular window
    of the block's latest ``WINDOW`` bytes in shared memory, a match whose
    source lies in it reads its bytes there, and bulk copies (TMA, in
    groups) move the window to the u8 output at the block's offset, so
    that a source further back has reached the output when it is read.
    The resolver waits for tokens and flushes the window once a batch of
    256 tokens, so that its steps test nothing else.
    The u8 MTF table (64 KB), the window, the token ring, the ring heads
    and the word-MRU live in dynamic shared memory; the ring (4 MB) in
    global memory, cleared at each new block.

Not ported, because it is TPU layout or scheduling: the one-byte-per-int32
output with its XLA repack, the ``FLUSH_ROWS`` row bases, the token slabs
and the literal fast loop.

A block's head bytes take one token each whatever its value, as the JAX
split decoder does (so a match symbol there leaves its index to be read as
the next token; the fused decoder K3 differs on such corrupt input exactly
as the JAX fused decoder does).  A status row is (opos, tpos, bad, opos at
chunk start).  A chunk is bad on ``midx == 0``, an unwritten ring slot,
``src >= opos``, a match whose index would lie at or past ``rlen``,
``opos > encpos`` or ``opos != encpos`` at its end.  The overrun checks run
before a byte is written; after the first bad chunk the rest are not
decoded and are marked bad (the JAX kernel goes on; only the first bad
chunk's flag is compared with it).
"""

from __future__ import annotations

import functools

import torch

from ..tables import MATCH_MIN_LEN
from . import mtf as mops

RING = 4096
WINDOW = 1 << 17       # resolve.cu, decode_fused.cu: the window, ResolverT<17>
TOKEN_RING = 4096      # csrc/resolve.cu: kTok tokens in the token ring


@functools.lru_cache(maxsize=None)
def _mtf_next(device: torch.device) -> torch.Tensor:
    """MTF_NEXT on ``device``, copied there once (a blocking copy per call
    would wait for the work queued before it)."""
    return mops.mtf_next(device)


def resolve_stream(tokens, tok_off, rlens, encpos, new_block, out_base,
                   out_size: int, mtf0):
    """Resolve every chunk's tokens to bytes.

    tokens i32 [N] (K1's flat layout); tok_off [C] int64 (chunk c's first
    token); rlens, encpos, new_block [C]; out_base [C] int64 (byte offset of
    the chunk's block in the output); mtf0 u8 [256, 256] (rank -> byte per
    context, ``ops/mtf.py``).  Returns (out u8 [out_size], status i32
    [C, 4], mtf_out u8 [256, 256]).  CUDA tensors launch the kernel; CPU
    tensors run the plain version.
    """
    if tokens.device.type == "cpu":
        return resolve_stream_plain(tokens, tok_off, rlens, encpos,
                                    new_block, out_base, out_size, mtf0)
    if tokens.device.type != "cuda":
        raise ValueError(f"resolve_stream: unsupported device {tokens.device}")
    from .. import _build

    dev = tokens.device
    C = rlens.shape[0]
    if tokens.dtype != torch.int32 or not tokens.is_contiguous():
        raise ValueError("resolve_stream: int32 contiguous tokens expected")
    if mtf0.dtype != torch.uint8 or mtf0.shape != (256, 256):
        raise ValueError("resolve_stream: mtf0 must be u8 [256, 256]")
    for a in (tok_off, encpos, new_block, out_base):
        if a.shape != (C,):
            raise ValueError("resolve_stream: one value per chunk expected")
    _build.check_devices("resolve_stream", dev, direct=(mtf0,),
                         copied=(tok_off, rlens, encpos, new_block, out_base))
    with torch.cuda.device(dev):
        i32 = [a.to(dev, torch.int32).contiguous()
               for a in (rlens, encpos, new_block)]
        i64 = [a.to(dev, torch.int64).contiguous()
               for a in (tok_off, out_base)]
        mtf0 = mtf0.contiguous().clone()          # 16-byte aligned copy
        out = torch.zeros(max(out_size, 1), dtype=torch.uint8, device=dev)
        ring = torch.zeros(256 * RING, dtype=torch.int32, device=dev)
        status = torch.empty((C, 4), dtype=torch.int32, device=dev)
        mtf_out = torch.empty((256, 256), dtype=torch.uint8, device=dev)
        err = _build.lib().zlt_resolve(
            tokens.data_ptr(), i64[0].data_ptr(), i32[0].data_ptr(),
            i32[1].data_ptr(), i32[2].data_ptr(), i64[1].data_ptr(),
            mtf0.data_ptr(), _mtf_next(dev).data_ptr(), C, out.data_ptr(),
            ring.data_ptr(), status.data_ptr(), mtf_out.data_ptr(),
            _build.stream_ptr(tokens))
    _build.check(err, "zlt_resolve")
    resolve_stream.launches += 1
    return out[:out_size], status, mtf_out


resolve_stream.launches = 0


class Resolver:
    """The ROLZ resolve state machine of the plain versions of K2 and K3
    (the kernels share ``csrc/rolz.cuh``): the output as a bytearray, the
    MTF table as a bytearray, the ring and word-MRU as lists.  Each step
    returns False, before writing, where the chunk is corrupt.  A chunk's
    matches and those whose source lies at most ``WINDOW`` bytes back (in
    the kernels' output window) are counted in ``matches`` and ``near``."""

    def __init__(self, out: bytearray, table: torch.Tensor, nxt: list):
        self.o = out
        self.mtf = bytearray(table.cpu().numpy().tobytes())
        self.nxt = nxt
        self.ring = [0] * (256 * RING)
        self.head = [0] * 256
        self.opos = 0

    def start_chunk(self, base: int, new_block: int, encpos: int) -> int:
        """Reset the word-MRU and the counts, and at a new block the ring,
        the heads and the position; returns the position in the block at
        chunk start."""
        if new_block:
            self.ring = [0] * (256 * RING)
            self.head = [0] * 256
            self.opos = 0
        self.mru = [0] * 512
        self.matches = self.near = 0
        self.base, self.encpos = base, encpos
        p = base + self.opos
        self.l1 = self.o[p - 1] if self.opos >= 1 else 0
        self.l2 = self.o[p - 2] if self.opos >= 2 else 0
        return self.opos

    def table(self) -> torch.Tensor:
        return torch.frombuffer(self.mtf, dtype=torch.uint8).reshape(256, 256)

    def head_byte(self, t: int) -> bool:
        """A block's raw head byte: the token's low 8 bits."""
        if self.opos + 1 > self.encpos:
            return False
        self.o[self.base + self.opos] = t & 255
        self.opos += 1
        self.l1, self.l2 = t & 255, self.l1
        return True

    def match(self, t: int, midx: int) -> bool:
        """A match of symbol t (>= 258) from ring index midx."""
        ctx, opos, o, mru = self.l1, self.opos, self.o, self.mru
        h = (self.head[ctx] + 1) & (RING - 1)
        self.head[ctx] = h
        src = self.ring[ctx * RING + ((h - midx) & (RING - 1))]
        self.ring[ctx * RING + h] = opos
        mlen = t - 258 + MATCH_MIN_LEN
        if midx == 0 or src == 0 or src >= opos or opos + mlen > self.encpos:
            return False
        self.matches += 1
        self.near += opos - src <= WINDOW
        p, s = self.base + opos, self.base + src
        if opos - src >= mlen:
            o[p:p + mlen] = o[s:s + mlen]
        else:                                    # overlapping: byte by byte
            for k in range(mlen):
                o[p + k] = o[s + k]
        self.opos = opos + mlen
        cu, l2, l1 = o[p + mlen - 3], o[p + mlen - 2], o[p + mlen - 1]
        self.l1, self.l2 = l1, l2
        wu = l2 << 8 | l1
        if mru[cu * 2] != wu:
            mru[cu * 2 + 1] = mru[cu * 2]
            mru[cu * 2] = wu
        return True

    def simple(self, t: int) -> bool:
        """A literal (t < 256: the sticky-MTF rank of its low 8 bits) or a
        word-MRU hit (256: newest, 257: second)."""
        ctx, opos, o, mru = self.l1, self.opos, self.o, self.mru
        if opos + (1 if t < 256 else 2) > self.encpos:
            return False
        h = (self.head[ctx] + 1) & (RING - 1)
        self.head[ctx] = h
        self.ring[ctx * RING + h] = opos
        p = self.base + opos
        if t < 256:
            r = ctx * 256 + (t & 255)
            j = ctx * 256 + self.nxt[t & 255]
            mtf = self.mtf
            lit = mtf[r]
            mtf[r] = mtf[j]
            mtf[j] = lit
            o[p] = lit
            l2 = self.l2
            mru[l2 * 2 + 1] = mru[l2 * 2]
            mru[l2 * 2] = ctx << 8 | lit
            self.opos = opos + 1
            self.l1, self.l2 = lit, ctx
        else:
            wv = mru[ctx * 2 + (t & 1)]
            b0, b1 = (wv >> 8) & 255, wv & 255
            o[p] = b0
            o[p + 1] = b1
            if t == 257:
                mru[ctx * 2 + 1] = mru[ctx * 2]
                mru[ctx * 2] = wv
            self.opos = opos + 2
            self.l1, self.l2 = b1, b0
        return True


def resolve_stream_plain(tokens, tok_off, rlens, encpos, new_block, out_base,
                         out_size: int, mtf0):
    """The plain version of K2: the same serial walk in Python."""
    C = len(rlens)
    o = bytearray(max(out_size, 1))
    r = Resolver(o, mtf0, mops.mtf_next("cpu").tolist())
    tk = tokens.cpu().tolist()
    offs, rl, ep, nb, bases = (a.cpu().tolist() if torch.is_tensor(a)
                               else [int(x) for x in a]
                               for a in (tok_off, rlens, encpos, new_block,
                                         out_base))
    status = torch.zeros((C, 4), dtype=torch.int32)
    stop = False
    for c in range(C):
        if stop:
            status[c] = torch.tensor([0, 0, 1, 0])
            continue
        opos0 = r.start_chunk(bases[c], nb[c], ep[c])
        rlen, off = rl[c], offs[c]
        tpos, bad = 0, False
        while tpos < rlen:
            t = tk[off + tpos]
            if r.opos <= 1:                      # raw head byte: one token
                ok, n = r.head_byte(t), 1
            elif t >= 258:                       # match; next token: index
                ok = tpos + 1 < rlen and r.match(t, tk[off + tpos + 1])
                n = 2
            else:
                ok, n = r.simple(t), 1
            if not ok:
                bad = True
                break
            tpos += n
        bad = bad or r.opos != ep[c]
        status[c] = torch.tensor([r.opos, tpos, int(bad), opos0])
        stop = bad
    return torch.frombuffer(o, dtype=torch.uint8)[:out_size], status, \
        r.table()
