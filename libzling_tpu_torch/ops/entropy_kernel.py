"""K1, the per-chunk Huffman entropy decode, and the decode tables it reads.

Counterpart of ``libzling_tpu/ops/entropy_kernel.py``: ``build_chunk_tables``
(with ``_canonical_tiers`` and ``_classify_windows``), ``pack_payload_words``
and the kernel ``_decode_chunk_kernel`` (via ``_decode_call``, entry
``decode_chunks``).  The tables are in the JAX package's layout, so the two
packages can be compared entry for entry; K1 (``decode_chunks``,
``csrc/entropy_decode.cu``) and the fused decode K3 (``decode_fused.py``)
read them through one reader (``csrc/huffman.cuh``).  On the card K1 cuts
each chunk into segments of ``SEG_BITS`` payload bits, walks every
segment from each of the 31 bit offsets its first unit can start at, joins
the walks by a scan from bit 0 and re-decodes each segment from its true
start; the plain version is the serial walk.

K1 lays the tokens flat: chunk ``c`` at ``tok_off[c]``, the exclusive
cumulative sum of the chunks' token counts, a match as two tokens (its
symbol, then its index) as in the JAX ``tokens[c, :rlen]``.  The JAX
kernel's ``[C, max_tokens + 2 * flush]`` padding, chunk pairs, payload
slabs, flush bursts and its ``nflushed`` status column are TPU layout and
are not ported.  ``tok_off`` is int64, so the token count of a stream has
no 2**31 bound; a chunk holds at most ``BLOCK_SIZE_ROLZ`` tokens.

All table arithmetic is in int64 (torch's ``>>`` on int32 is arithmetic,
and its uint32 supports few ops), then narrowed to int32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..tables import (
    HUFFMAN_CODES_1,
    HUFFMAN_MAX_LEN_1,
    HUFFMAN_MAX_LEN_2,
    MATCHIDX_BASE,
    MATCHIDX_BLEN,
)

LUT_BITS = 12                 # fast-path window width for alphabet 1
SLAB_WORDS = 4096             # trailing zero words after the last chunk
SEG_BITS = 2048               # payload bits of K1's segments (kSegBits)
M32 = 0xFFFFFFFF


def _bitrev(v: np.ndarray, bits: int) -> np.ndarray:
    v = v.astype(np.int64)
    r = np.zeros_like(v)
    for _ in range(bits):
        r = (r << 1) | (v & 1)
        v >>= 1
    return r


# constants of the table build: bit reversals of the LUT windows, the
# alphabet-2 extra-bit counts and bases
_CONSTS = {"bitrev12": _bitrev(np.arange(1 << 12), 12),
           "bitrev8": _bitrev(np.arange(1 << 8), 8),
           "blen": MATCHIDX_BLEN.astype(np.int64),
           "mbase": MATCHIDX_BASE.astype(np.int64)}


@functools.lru_cache(maxsize=None)
def _const(name: str, device: torch.device) -> torch.Tensor:
    """``_CONSTS[name]`` on ``device``, copied there once: a blocking copy
    in every call would wait for the work queued before it."""
    return torch.as_tensor(_CONSTS[name], device=device)


def _canonical_tiers(lengths: torch.Tensor, max_len: int):
    """lengths [C, n] -> (start, count, base [C, L+1], order [C, n]).

    start: first MSB-first code of each length tier; count: symbols per
    tier; base: the tier's offset into order; order: symbols sorted by
    (length, symbol), zero lengths last.
    """
    C, n = lengths.shape
    L = max_len
    tiers = torch.arange(L + 1, device=lengths.device)
    count = (lengths[..., None] == tiers).sum(dim=1)
    count[:, 0] = 0
    starts = [torch.zeros(C, dtype=torch.int64, device=lengths.device)]
    c = torch.zeros(C, dtype=torch.int64, device=lengths.device)
    for l in range(1, L + 1):
        starts.append(c)
        c = (c + count[:, l]) * 2
    start = torch.stack(starts, dim=1)
    base = torch.cumsum(count, dim=1) - count
    key = torch.where(lengths > 0, lengths, L + 1) * n \
        + torch.arange(n, device=lengths.device)
    order = torch.argsort(key, dim=1)
    return start, count, base, order


def _classify_windows(start, count, base, order, max_len: int,
                      lut_bits: int) -> torch.Tensor:
    """LUT [C, 2**lut_bits]: sym | len << 16, or -1 (miss or longer code).

    Window w (an LSB-first peek) decodes as the unique length l whose
    MSB-first tier range holds the top l bits of bitrev(w).
    """
    W = 1 << lut_bits
    dev = order.device
    v = _const(f"bitrev{lut_bits}", dev)
    lut = torch.full((start.shape[0], W), -1, dtype=torch.int64, device=dev)
    found = torch.zeros((start.shape[0], W), dtype=torch.bool, device=dev)
    for l in range(1, min(max_len, lut_bits) + 1):
        top = (v >> (lut_bits - l))[None, :]
        s = start[:, l:l + 1]
        hit = ~found & (top >= s) & (top < s + count[:, l:l + 1])
        pos = torch.clamp(base[:, l:l + 1] + top - s, 0, order.shape[1] - 1)
        sym = torch.gather(order, 1, pos)
        lut = torch.where(hit, sym | (l << 16), lut)
        found |= hit
    return lut


def build_chunk_tables(len1, len2, n_words, word_base, rlens):
    """Pack per-chunk decode tables on the device of ``len1``.

    len1 [C, 514], len2 [C, 32]: code lengths from the chunk headers;
    n_words, word_base, rlens [C]: payload words (with the legal 8-byte
    over-peek), first word of the chunk in the flat word array, tokens.

    Returns int32 (meta [C,8,128], order1 [C,8,128], lut1 [C,8,512],
    lut2 [C,8,128]) exactly as the JAX function does: meta row 0 holds
    (n_words, rlen, word_base), rows 1-3 the alphabet-1 tier start, count
    and base for lengths 1..15; lut1 is the 12-bit window LUT; lut2 packs
    len2 | matchidx_bits << 8 | matchidx_base << 16 for every 8-bit window.
    """
    dev = len1.device
    C = len1.shape[0]
    len1 = len1.to(torch.int64)
    len2 = len2.to(torch.int64)
    s1, c1, b1, o1 = _canonical_tiers(len1, HUFFMAN_MAX_LEN_1)
    lut1 = _classify_windows(s1, c1, b1, o1, HUFFMAN_MAX_LEN_1, LUT_BITS)

    s2, c2, b2, o2 = _canonical_tiers(len2, HUFFMAN_MAX_LEN_2)
    lut2sym = _classify_windows(s2, c2, b2, o2, HUFFMAN_MAX_LEN_2,
                                HUFFMAN_MAX_LEN_2)
    blen = _const("blen", dev)
    mbase = _const("mbase", dev)
    sym2 = torch.clamp(lut2sym & 0xFFFF, 0, 31)
    lut2 = torch.where(lut2sym >= 0,
                       (lut2sym >> 16) | (blen[sym2] << 8)
                       | (mbase[sym2] << 16), -1)

    meta = torch.zeros((C, 8, 128), dtype=torch.int64, device=dev)
    meta[:, 0, 0] = n_words.to(dev)
    meta[:, 0, 1] = rlens.to(dev)
    meta[:, 0, 2] = word_base.to(dev)
    meta[:, 1, 1:HUFFMAN_MAX_LEN_1 + 1] = s1[:, 1:]
    meta[:, 2, 1:HUFFMAN_MAX_LEN_1 + 1] = c1[:, 1:]
    meta[:, 3, 1:HUFFMAN_MAX_LEN_1 + 1] = b1[:, 1:]

    order1 = torch.zeros((C, 1024), dtype=torch.int64, device=dev)
    order1[:, :HUFFMAN_CODES_1] = o1
    lut2p = torch.full((C, 1024), -1, dtype=torch.int64, device=dev)
    lut2p[:, :256] = lut2
    i32 = torch.int32
    return (meta.to(i32), order1.reshape(C, 8, 128).to(i32),
            lut1.reshape(C, 8, 512).to(i32), lut2p.reshape(C, 8, 128).to(i32))


def pack_payload_words(payloads: list[bytes]):
    """Lay chunk payloads into one flat little-endian word array (host).

    Each chunk starts on a 512-byte boundary and is followed by at least
    512 zero bytes (the bit reader may peek past the last payload byte);
    ``SLAB_WORDS`` zero words close the array, as in the JAX layout.
    Returns (words i32 [W], word_base i32 [C], n_words i32 [C]) as numpy
    arrays.
    """
    C = len(payloads)
    word_base = np.zeros(C, np.int32)
    n_words = np.zeros(C, np.int32)
    flat = []
    base = 0
    for i, p in enumerate(payloads):
        nb = (len(p) + 511) // 512 * 512 + 512
        flat.append(np.frombuffer(p + bytes(nb - len(p)), np.uint8))
        word_base[i] = base
        n_words[i] = len(p) // 4 + 2  # payload words + legal 8-byte overpeek
        base += nb // 4
    flat.append(np.zeros(SLAB_WORDS * 4, np.uint8))
    words = np.concatenate(flat).view("<u4").astype(np.int32)
    return words, word_base, n_words


def host_to(a, device) -> torch.Tensor:
    """Host array ``a`` as a tensor on ``device``.  To a GPU it goes through
    pinned memory without blocking, so staging the next inputs does not
    wait for the work already queued on the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def stage_chunks(len1, len2, payloads, rlens, device):
    """K1's inputs on ``device`` for these chunks.

    len1/len2 [C,514]/[C,32] code lengths; payloads: per-chunk Huffman
    bitstream bytes; rlens [C] token counts.  Returns the argument tuple of
    ``decode_chunks``: (meta, order1, lut1, lut2, words, tok_off, n_tokens).
    """
    words, word_base, n_words = pack_payload_words(payloads)
    rl = np.asarray(rlens, np.int64)
    tok_off = np.cumsum(rl) - rl

    def i64(a):
        return host_to(np.asarray(a, np.int64), device)

    meta, order1, lut1, lut2 = build_chunk_tables(
        i64(len1), i64(len2), i64(n_words), i64(word_base), i64(rl))
    return (meta, order1, lut1, lut2, host_to(words, device), i64(tok_off),
            int(rl.sum()))


def decode_chunks(meta, order1, lut1, lut2, words, tok_off, n_tokens: int):
    """K1: decode every chunk's payload to tokens.

    Returns (tokens i32 [n_tokens], status i32 [C, 3]); a status row is
    (emitted, bit_pos, bad).  CUDA tensors launch the kernel (the chunks
    cut into segments of ``SEG_BITS`` bits, decoded in parallel and joined
    by a scan; its scratch, ~2 bytes a payload word, is allocated here);
    CPU tensors run the plain version.  The chunks lie in ``words`` in
    order and apart, as ``pack_payload_words`` lays them.
    """
    if meta.device.type == "cpu":
        return decode_chunks_plain(meta, order1, lut1, lut2, words, tok_off,
                                   n_tokens)
    if meta.device.type != "cuda":
        raise ValueError(f"decode_chunks: unsupported device {meta.device}")
    from .. import _build

    for a in (meta, order1, lut1, lut2, words):
        if a.dtype != torch.int32 or not a.is_contiguous():
            raise ValueError("decode_chunks: int32 contiguous tables expected")
    C = meta.shape[0]
    if tok_off.shape != (C,):
        raise ValueError("decode_chunks: one token offset per chunk expected")
    dev = meta.device
    _build.check_devices("decode_chunks", dev,
                         direct=(meta, order1, lut1, lut2, words),
                         copied=(tok_off,))
    with torch.cuda.device(dev):
        tok_off = tok_off.to(dev, torch.int64).contiguous()
        tokens = torch.zeros(max(n_tokens, 1), dtype=torch.int32,
                             device=dev)
        status = torch.zeros((C, 3), dtype=torch.int32, device=dev)
        if C:
            lib = _build.lib()
            scratch = torch.empty(
                lib.zlt_entropy_decode_scratch(C, words.numel()),
                dtype=torch.int32, device=dev)
            err = lib.zlt_entropy_decode(
                meta.data_ptr(), order1.data_ptr(), lut1.data_ptr(),
                lut2.data_ptr(), words.data_ptr(), words.numel(),
                tok_off.data_ptr(), C, scratch.data_ptr(),
                tokens.data_ptr(), status.data_ptr(),
                _build.stream_ptr(meta))
            _build.check(err, "zlt_entropy_decode")
            decode_chunks.launches += 1
    return tokens[:n_tokens], status


decode_chunks.launches = 0


def tier_lookup(lo: int, tier, order) -> int:
    """Alphabet-1 codes of 13..15 bits: the canonical tier compare.

    ``tier`` is (start, count, base) by code length (meta rows 1-3)."""
    v = lo & 0x7FFF
    v15 = int(f"{v:015b}"[::-1], 2)          # the MSB-first view
    for ln in range(13, 16):
        top = v15 >> (15 - ln)
        s, cnt, base = tier[0][ln], tier[1][ln], tier[2][ln]
        if s <= top < s + cnt:
            pos = min(max(base + top - s, 0), 1023)
            return order[pos] | (ln << 16)
    return -1


def decode_chunks_plain(meta, order1, lut1, lut2, words, tok_off,
                        n_tokens: int):
    """The plain version of K1: each chunk's walk in Python, with the JAX
    kernel's rules (an index only when ``emitted + 1 < rlen``; a missing
    code emits 0, consumes one bit and is bad; ``wpos > n_words`` checked
    once per two units)."""
    C = meta.shape[0]
    tokens = torch.zeros(n_tokens, dtype=torch.int32)
    status = torch.zeros((C, 3), dtype=torch.int32)
    out = tokens.numpy()
    wl = words.cpu().tolist()
    metal = meta[:, :4].cpu().tolist()
    offs = tok_off.cpu().tolist()
    for c in range(C):
        m = metal[c]
        n_words, rlen, wbase = m[0][:3]
        tier = (m[1], m[2], m[3])
        order = order1[c].reshape(-1).tolist()
        l1t = lut1[c].reshape(-1).tolist()
        l2t = lut2[c].reshape(-1).tolist()
        acc = (wl[wbase] & M32) | (wl[wbase + 1] & M32) << 32
        nbits, wpos, bad = 64, 2, False
        toks: list[int] = []
        while len(toks) < rlen and not bad:
            for _ in range(2):                   # two units, then the check
                if len(toks) >= rlen or bad:
                    break
                if nbits < 32:
                    acc |= (wl[wbase + wpos] & M32) << nbits
                    wpos += 1
                    nbits += 32
                e = l1t[acc & 0xFFF]
                if e < 0:
                    e = tier_lookup(acc & M32, tier, order)
                if e < 0:
                    bad, e = True, 0
                sym = e & 0xFFFF
                hl = max((e >> 16) & 31, 1)
                acc >>= hl
                nbits -= hl
                if sym >= 258 and len(toks) + 1 < rlen:
                    e2 = l2t[acc & 0xFF]
                    if e2 < 0:
                        bad, e2 = True, 0
                    hl2, blen = e2 & 0xFF, (e2 >> 8) & 0xFF
                    toks += (sym,
                             (e2 >> 16) + ((acc >> hl2) & ((1 << blen) - 1)))
                    acc >>= hl2 + blen
                    nbits -= hl2 + blen
                else:
                    toks.append(sym)
            bad = bad or wpos > n_words
        bit_pos = wpos * 32 - nbits
        out[offs[c]:offs[c] + len(toks)] = toks
        status[c] = torch.tensor(
            [len(toks), bit_pos, int(bad or bit_pos > n_words * 32)])
    return tokens, status


def tokens_from_jax(tokens, rlens) -> torch.Tensor:
    """The JAX kernel's ``[C, stride]`` token array in the port's flat
    layout (chunk c's first ``rlens[c]`` tokens at ``tok_off[c]``)."""
    t = np.asarray(tokens)
    flat = [t[c, :int(n)] for c, n in enumerate(rlens)]
    return torch.as_tensor(
        np.concatenate(flat).astype(np.int32) if flat else
        np.zeros(0, np.int32))
