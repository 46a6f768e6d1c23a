"""K4: the ROLZ tokenizer (block bytes -> raw-literal units) on the card.

Counterpart of ``libzling_tpu/ops/tokenize_kernel.py``: the kernel
``_tokenize_kernel`` (via ``_tokenize_call``) and its entry point
``tokenize_block``.  Semantics are ``libzling_tpu/spec.py::RolzEncoder``
(insert before search, check-byte + probe-byte prefilter, the chain walk
that stops on nil or a non-decreasing offset, lazy probes below length 128,
word-MRU hits 256/257, the per-chunk token budget), run as each block's
whole chunk sequence under a per-chunk level schedule.

Units are packed as in the JAX package -- ``sym | kind << 10 | x << 14``
with kind 0 raw head byte, 1 literal (sym = RAW byte, x = its order-1
context), 2 word-MRU hit, 3 match (x = match index) -- with ``upos`` the
unit's block position.  Unlike the JAX kernel's ``[max_chunks,
chunk_stride]`` padding, a block's units lie flat: a unit consumes at least
one byte, so block b's units fit in ``block_len[b]`` slots from
``unit_off[b]``, chunk after chunk.

Source note (``csrc/tokenize.cu``):
  * replaces ``libzling_tpu/ops/tokenize_kernel.py::_tokenize_kernel``;
  * bound on this card: the latency of dependent loads.  The bytes moved
    (the block in, units and ``upos`` out: ~93 MB at 32 MiB, ~28 us at
    3.35 TB/s) are nothing; the parse is serial within a block, and every
    unit reads a hash head, then walks chain nodes (offset, suffix link,
    candidate bytes) and the lazy probes' chains, each load depending on
    the one before, in ~10.5 MB of bucket state per block that does not
    stay in L2 beside the input (the cost probes of ``probes/`` on an H100:
    ~300 cycles an L2 hit, ~675 an HBM load, 920 for three dependent loads
    at K4's footprint);
  * design: one CTA of four warps per block, all blocks of a launch in
    parallel.  Warp 0 runs the parse converged, every lane holding the
    same walk (a load of one address by every lane is one broadcast load);
    its lane 0 alone stores to the bucket state, the word-MRU and the
    outputs, and a ``__syncwarp()`` separates every lane's loads of a word
    from lane 0's store to it, so the result does not depend on timing.
    Its other lanes take latency off the chain: a node's offset and suffix
    link load together, the next node's before the candidate's bytes;
    lanes 1 and 2 walk the lazy probes' chains (pos+1, pos+2) beside the
    main walk, and the whole warp tests their candidates at once after it;
    a candidate's common length is compared 32 bytes a step by
    ``__ballot_sync``.  Warps 1-3 run ahead of the walker: over a window
    of positions after its own (sized from the L1 budget and the chunk's
    depth, cut at the block's match limit) they read each position's hash
    head, chain nodes and candidates' first bytes, so that the walker's
    dependent loads find their lines in L1 (or, past the first three
    nodes, L2).  They store nothing to global memory; the walker never
    waits for them, and counts its token starts and those they had read
    first (``k4stat``).  The bucket state (hash heads
    u16 [256, 8192], suffix u16 [256, 4096], offset|check u32 [256, 4096])
    is allocated and initialised by the wrapper; ring heads, the word-MRU
    (reset per chunk), the lazy candidates (``MAX_LAZY`` a probe) and the
    run-ahead's shared words are in shared memory, at the smallest
    carveout; a chunk whose lazy depth exceeds ``MAX_LAZY`` ends its block
    with err set.  Search depth is a runtime value, so levels 5 and 6
    (depth 48 and 128) are exact.
"""

from __future__ import annotations

import numpy as np
import torch

from .entropy_kernel import host_to
from ..tables import (
    LEVEL_PARAMS,
    MATCH_MAX_LEN,
    MATCH_MIN_LEN,
    MATCH_MIN_LEN_ENABLE_LAZY,
    SENTINEL_LEN,
)

LEVEL_TABLE = np.asarray([LEVEL_PARAMS[l] for l in sorted(LEVEL_PARAMS)],
                         np.int32)
RING, HASH, NIL = 4096, 8192, 0xFFFF
MAX_LAZY = 16            # lazy candidates the kernel keeps per probe
assert LEVEL_TABLE[:, 1:].max() <= MAX_LAZY


def level_params(levels, device) -> torch.Tensor:
    """Per-chunk level ids [..., max_chunks] -> (depth, lazy1, lazy2) i32,
    put on ``device`` without blocking."""
    return host_to(LEVEL_TABLE[np.asarray(levels, np.int64)], device)


def tokenize(buf, block_off, block_len, unit_off, params, max_tokens: int,
             n_units: int):
    """Tokenize the blocks ``buf[block_off[b] : block_off[b]+block_len[b]]``.

    buf u8 (with SENTINEL_LEN zero bytes after the last block);
    block_off/unit_off i64 [B]; block_len i32 [B]; params i32
    [B, max_chunks, 3] (depth, lazy1, lazy2 per chunk).  Returns (units,
    upos i32 [n_units], chunk_stat i32 [B, max_chunks, 3] = (nunits, ntoks,
    encpos), block_stat i32 [B, 2] = (n_chunks, err), k4stat); err is set
    when a block is not fully tokenized within max_chunks chunks.  Lazy
    depths above ``MAX_LAZY`` raise for CPU ``params`` and set err on the
    card.  ``k4stat`` i64 [B, 2] = (token starts, token starts the
    run-ahead warps had read before the walker came to them): the kernel's
    own count, which depends on timing; None from the plain version, which
    has no run-ahead.

    CUDA tensors launch the kernel; CPU tensors run the plain version.
    """
    if buf.device.type == "cpu":
        return (*tokenize_plain(buf, block_off, block_len, unit_off, params,
                                max_tokens, n_units), None)
    if buf.device.type != "cuda":
        raise ValueError(f"tokenize: unsupported device {buf.device}")
    from .. import _build

    dev = buf.device
    B, max_chunks = params.shape[0], params.shape[1]
    if buf.dtype != torch.uint8 or not buf.is_contiguous():
        raise ValueError("tokenize: buf must be contiguous u8")
    if (params.device.type == "cpu" and params.numel()
            and int(params[..., 1:].max()) > MAX_LAZY):
        raise ValueError(f"tokenize: lazy depth above {MAX_LAZY}")
    _build.check_devices("tokenize", dev,
                         copied=(block_off, block_len, unit_off, params))
    with torch.cuda.device(dev):
        block_off = block_off.to(dev, torch.int64).contiguous()
        unit_off = unit_off.to(dev, torch.int64).contiguous()
        block_len = block_len.to(dev, torch.int32).contiguous()
        params = params.to(dev, torch.int32).contiguous()
        hash_ = torch.full((B, 256 * HASH), -1, dtype=torch.int16,
                           device=dev)
        suffix = torch.full((B, 256 * RING), -1, dtype=torch.int16,
                            device=dev)
        offset = torch.zeros((B, 256 * RING), dtype=torch.int32, device=dev)
        units = torch.zeros(n_units, dtype=torch.int32, device=dev)
        upos = torch.zeros(n_units, dtype=torch.int32, device=dev)
        chunk_stat = torch.zeros((B, max_chunks, 3), dtype=torch.int32,
                                 device=dev)
        block_stat = torch.zeros((B, 2), dtype=torch.int32, device=dev)
        k4stat = torch.zeros((B, 2), dtype=torch.int64, device=dev)
        err = _build.lib().zlt_tokenize(
            buf.data_ptr(), block_off.data_ptr(), block_len.data_ptr(),
            unit_off.data_ptr(), params.data_ptr(), B, max_chunks,
            max_tokens, hash_.data_ptr(), suffix.data_ptr(),
            offset.data_ptr(), units.data_ptr(), upos.data_ptr(),
            chunk_stat.data_ptr(), block_stat.data_ptr(), k4stat.data_ptr(),
            _build.stream_ptr(buf))
    _build.check(err, "zlt_tokenize")
    tokenize.launches += 1
    return units, upos, chunk_stat, block_stat, k4stat


tokenize.launches = 0


def tokenize_plain(buf, block_off, block_len, unit_off, params,
                   max_tokens: int, n_units: int):
    """The plain version of K4: the same serial walk in Python.

    Bucket state lives in torch tensors (accessed through numpy views);
    block bytes and parameters are read as Python values.
    """
    B, max_chunks = params.shape[0], params.shape[1]
    units_t = torch.zeros(n_units, dtype=torch.int32)
    upos_t = torch.zeros(n_units, dtype=torch.int32)
    chunk_stat = torch.zeros((B, max_chunks, 3), dtype=torch.int32)
    block_stat = torch.zeros((B, 2), dtype=torch.int32)
    hash_t = torch.empty(256 * HASH, dtype=torch.int32)
    sfx_t = torch.empty(256 * RING, dtype=torch.int32)
    ofs_t = torch.empty(256 * RING, dtype=torch.int64)
    head_t = torch.empty(256, dtype=torch.int32)
    mru_t = torch.empty(512, dtype=torch.int32)
    hsh, sfx, ofs, head, mru = (hash_t.numpy(), sfx_t.numpy(), ofs_t.numpy(),
                                head_t.numpy(), mru_t.numpy())
    uo, po = units_t.numpy(), upos_t.numpy()
    data = buf.cpu().numpy()
    prm = params.cpu().tolist()

    def hash4(p, pos):
        w = p[pos] | p[pos + 1] << 8 | p[pos + 2] << 16 | p[pos + 3] << 24
        return (w + p[pos + 2] * 137 + p[pos + 3] * 13337) & 0xFFFFFFFF

    def common_length(p, a, b):
        if p[a:a + 4] != p[b:b + 4]:
            return 0
        n = 4
        while n < MATCH_MAX_LEN and p[a + n] == p[b + n]:
            n += 1
        return n

    def match_lazy(p, pos, maxlen, depth):
        ctx = p[pos - 1]
        node = int(hsh[ctx * HASH + hash4(p, pos) % HASH])
        if node == NIL:
            return False
        ml = maxlen - 3
        want = p[pos + ml:pos + ml + 4]
        o = int(ofs[ctx * RING + node])
        for _ in range(depth):
            offset = o & 0xFFFFFF
            if p[offset + ml:offset + ml + 4] == want:
                return True
            node = int(sfx[ctx * RING + node])
            if node == NIL:
                break
            o = int(ofs[ctx * RING + node])
            if offset <= (o & 0xFFFFFF):
                break
        return False

    def match_and_update(p, pos, depth, lazy1, lazy2):
        h = hash4(p, pos)
        check, slot = (h >> 13) & 255, h % HASH
        ctx = p[pos - 1]
        node = int(hsh[ctx * HASH + slot])
        hd = (int(head[ctx]) + 1) & (RING - 1)
        head[ctx] = hd
        sfx[ctx * RING + hd] = node
        ofs[ctx * RING + hd] = pos | check << 24
        hsh[ctx * HASH + slot] = hd
        if node == NIL or node == hd:
            return None
        maxlen, maxnode = MATCH_MIN_LEN - 1, 0
        o = int(ofs[ctx * RING + node])
        for _ in range(depth):
            offset = o & 0xFFFFFF
            if o >> 24 == check and p[pos + maxlen] == p[offset + maxlen]:
                n = common_length(p, pos, offset)
                if n > maxlen:
                    maxnode, maxlen = node, n
                    if maxlen == MATCH_MAX_LEN:
                        break
            node = int(sfx[ctx * RING + node])
            if node == NIL:
                break
            o = int(ofs[ctx * RING + node])
            if offset <= (o & 0xFFFFFF):
                break
        if maxlen < MATCH_MIN_LEN:
            return None
        if maxlen < MATCH_MIN_LEN_ENABLE_LAZY:
            if lazy1 > 0 and match_lazy(p, pos + 1, maxlen, lazy1):
                return None
            if lazy2 > 0 and match_lazy(p, pos + 2, maxlen, lazy2):
                return None
        return maxlen, (hd - maxnode) & (RING - 1)

    for b in range(B):
        off, ilen, u = int(block_off[b]), int(block_len[b]), int(unit_off[b])
        p = data[off:off + ilen].tobytes() + bytes(SENTINEL_LEN)
        hsh[:] = NIL
        sfx[:] = NIL
        ofs[:] = 0
        head[:] = 0
        match_limit = ilen - MATCH_MAX_LEN - 16
        ipos = cidx = 0
        while ipos < ilen and cidx < max_chunks:
            depth, lazy1, lazy2 = prm[b][cidx]
            mru[:] = 0
            nu = nt = 0
            while ipos < ilen and (nt < max_tokens if ipos <= 1
                                   else nt + 1 < max_tokens):
                po[u] = ipos
                u += 1
                nu += 1
                if ipos <= 1:                        # raw head byte
                    uo[u - 1] = p[ipos]
                    nt += 1
                    ipos += 1
                    continue
                m = match_and_update(p, ipos, depth, lazy1, lazy2) \
                    if ipos < match_limit else None
                if m is not None:
                    mlen, midx = m
                    uo[u - 1] = (258 + mlen - MATCH_MIN_LEN) | 3 << 10 \
                        | midx << 14
                    nt += 2
                    ipos += mlen
                    c, w = p[ipos - 3], p[ipos - 2] << 8 | p[ipos - 1]
                    if mru[c * 2] != w:
                        mru[c * 2 + 1] = mru[c * 2]
                        mru[c * 2] = w
                    continue
                ctx = p[ipos - 1]
                nt += 1
                if ipos + 1 < ilen:
                    w = p[ipos] << 8 | p[ipos + 1]
                    if mru[ctx * 2] == w:
                        uo[u - 1] = 256 | 2 << 10
                        ipos += 2
                        continue
                    if mru[ctx * 2 + 1] == w:
                        uo[u - 1] = 257 | 2 << 10
                        ipos += 2
                        mru[ctx * 2 + 1] = mru[ctx * 2]
                        mru[ctx * 2] = w
                        continue
                uo[u - 1] = p[ipos] | 1 << 10 | ctx << 14
                ipos += 1
                c = p[ipos - 3]
                mru[c * 2 + 1] = mru[c * 2]
                mru[c * 2] = p[ipos - 2] << 8 | p[ipos - 1]
            chunk_stat[b, cidx] = torch.tensor([nu, nt, ipos])
            cidx += 1
        block_stat[b] = torch.tensor([cidx, int(ipos != ilen)])
    return units_t, upos_t, chunk_stat, block_stat


def tokenize_block(block, levels, max_tokens: int, max_chunks: int,
                   chunk_units: int, device="cuda"):
    """Tokenize one block (counterpart of the JAX ``tokenize_block``).

    block: the block's bytes; levels: [>= max_chunks] per-chunk level ids.
    Returns numpy (sym, idx, upos, kind [max_chunks, chunk_units], nunits,
    ntoks, encpos [max_chunks], n_chunks, err) in the JAX layout.
    """
    raw = np.frombuffer(bytes(block), np.uint8)
    ilen = len(raw)
    buf = torch.zeros(ilen + SENTINEL_LEN, dtype=torch.uint8)
    buf[:ilen] = torch.as_tensor(raw.copy())
    zero = torch.zeros(1, dtype=torch.int64)
    params = level_params(np.asarray(levels)[:max_chunks], "cpu")[None]
    units, upos, cstat, bstat, _ = tokenize(
        buf.to(device), zero, torch.tensor([ilen], dtype=torch.int32), zero,
        params, max_tokens, ilen)
    units, upos = units.cpu().numpy(), upos.cpu().numpy()
    cstat, bstat = cstat[0].cpu().numpy(), bstat[0].cpu().numpy()
    a = np.zeros((max_chunks, chunk_units), np.int32)
    b = np.zeros((max_chunks, chunk_units), np.int32)
    start = 0
    for c in range(int(bstat[0])):
        n = int(cstat[c, 0])
        a[c, :n] = units[start:start + n]
        b[c, :n] = upos[start:start + n]
        start += n
    sym, kind = a & 1023, (a >> 10) & 3
    idx = np.where(kind == 3, (a >> 14) & 4095, 0)
    return (sym, idx, b, kind, cstat[:, 0], cstat[:, 1], cstat[:, 2],
            int(bstat[0]), int(bstat[1]))
