"""Per-chunk Huffman decode tables, built on the device with torch ops.

Counterpart of ``libzling_tpu/ops/entropy_kernel.py``: ``build_chunk_tables``
(with ``_canonical_tiers`` and ``_classify_windows``) and
``pack_payload_words``.  The tables are in the JAX package's layout, so the
two packages can be compared entry for entry; the fused decode kernel
(``decode_fused.py``, K3) reads them.  The split-decode kernel K1 of that
module is not ported yet.

All arithmetic is in int64 (torch's ``>>`` on int32 is arithmetic, and its
uint32 supports few ops), then narrowed to int32.
"""

from __future__ import annotations

import numpy as np
import torch

from libzling_tpu.tables import (
    HUFFMAN_CODES_1,
    HUFFMAN_MAX_LEN_1,
    HUFFMAN_MAX_LEN_2,
    MATCHIDX_BASE,
    MATCHIDX_BLEN,
)

LUT_BITS = 12                 # fast-path window width for alphabet 1
SLAB_WORDS = 4096             # trailing zero words after the last chunk


def _bitrev(v: np.ndarray, bits: int) -> np.ndarray:
    v = v.astype(np.int64)
    r = np.zeros_like(v)
    for _ in range(bits):
        r = (r << 1) | (v & 1)
        v >>= 1
    return r


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
    v = torch.as_tensor(_bitrev(np.arange(W), lut_bits), device=dev)
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
    blen = torch.as_tensor(MATCHIDX_BLEN.astype(np.int64), device=dev)
    mbase = torch.as_tensor(MATCHIDX_BASE.astype(np.int64), device=dev)
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
