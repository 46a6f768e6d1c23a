"""Encode-side Huffman stage: histograms, canonical codes, bit packing.

Counterpart of ``libzling_tpu/ops/huffman.py``: ``unit_histograms``,
``canonical_codes``, ``pack_units``, ``exact_length_tables`` and
``payload_from_words``.  In the JAX package these are XLA stages, not
Pallas kernels, so here they are torch ops (bincount, cumsum, gathers,
``index_add_``), batched over every chunk of a group: a unit's ``chunk``
index selects its chunk's tables.

Bit arithmetic is in int64 and masked to 32 bits: the packed words get
disjoint bit ranges, so ``index_add_`` gives the same result as an OR, in
any order.

The exact code-length tables stay on the host: ``exact_length_tables``
calls ``zlt_length_tables`` (the reference heap tie-break) of the port's
own copy of the native engine (``native/engine.py``), the same C++ as the
JAX package's, so both packages break ties alike.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tables import (
    HUFFMAN_CODES_1,
    HUFFMAN_CODES_2,
    MATCHIDX_BASE,
    MATCHIDX_BLEN,
    MATCHIDX_CODE,
)

_M32 = 0xFFFFFFFF


def exact_length_tables(freqs: np.ndarray, max_codelen: int) -> np.ndarray:
    """freqs [C, n] -> code lengths [C, n] uint32, reference tie-breaking."""
    from ..native import engine

    return engine.length_tables(freqs, max_codelen)


def _table(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.int64), device=device)


def unit_histograms(sym, idx, chunk, n_chunks: int):
    """Per-chunk symbol frequencies of valid units.

    sym/idx/chunk: i64 [U] (idx is the match index of units with
    sym >= 258).  Returns (freq1 [n_chunks, 514], freq2 [n_chunks, 32]) i64.
    """
    freq1 = torch.bincount(chunk * HUFFMAN_CODES_1 + sym,
                           minlength=n_chunks * HUFFMAN_CODES_1)
    is_match = sym >= 258
    code2 = _table(MATCHIDX_CODE, sym.device)[idx[is_match]]
    freq2 = torch.bincount(chunk[is_match] * HUFFMAN_CODES_2 + code2,
                           minlength=n_chunks * HUFFMAN_CODES_2)
    return (freq1.reshape(n_chunks, HUFFMAN_CODES_1),
            freq2.reshape(n_chunks, HUFFMAN_CODES_2))


def _bitrev16(x: torch.Tensor) -> torch.Tensor:
    x = ((x & 0xFF00) >> 8) | ((x & 0x00FF) << 8)
    x = ((x & 0xF0F0) >> 4) | ((x & 0x0F0F) << 4)
    x = ((x & 0xCCCC) >> 2) | ((x & 0x3333) << 2)
    return ((x & 0xAAAA) >> 1) | ((x & 0x5555) << 1)


def canonical_codes(lengths: torch.Tensor, max_codelen: int) -> torch.Tensor:
    """lengths [..., n] -> LSB-first (bit-reversed) canonical codes, i64.

    Codes go shorter-first, then in symbol order
    (src/libzling_huffman.cpp:114-138), reversed and right-aligned.
    """
    lengths = lengths.to(torch.int64)
    tiers = torch.arange(max_codelen + 1, device=lengths.device)
    onehot = (lengths[..., None] == tiers).to(torch.int64)   # [..., n, L+1]
    count = onehot.sum(dim=-2)                                # [..., L+1]
    starts = [torch.zeros_like(count[..., 0])]
    c = torch.zeros_like(count[..., 0])
    for l in range(1, max_codelen + 1):
        starts.append(c)
        c = (c + count[..., l]) * 2
    start = torch.stack(starts, dim=-1)                       # [..., L+1]
    rank = torch.cumsum(onehot, dim=-2) - onehot
    rank_own = torch.gather(rank, -1, lengths[..., None])[..., 0]
    code = torch.gather(start, -1, lengths) + rank_own
    shift = torch.where(lengths > 0, 16 - lengths, 16)
    return torch.where(lengths > 0, _bitrev16(code) >> shift, 0)


def pack_units(sym, idx, chunk, len1, enc1, len2, enc2):
    """Bit-pack every chunk's units into LSB-first 32-bit words.

    sym/idx/chunk: i64 [U], units of each chunk contiguous and in order;
    len1/enc1 [C, 514], len2/enc2 [C, 32].  A unit is one alphabet-1 code
    plus, for a match, its index code and extra bits (<= 31 bits).  Each
    chunk's words start on a word boundary.  Returns (words i64 [W] holding
    32-bit values, bits i64 [C], word_off i64 [C]).
    """
    dev = sym.device
    C = len1.shape[0]
    len1, enc1 = len1.to(torch.int64), enc1.to(torch.int64)
    len2, enc2 = len2.to(torch.int64), enc2.to(torch.int64)
    code2 = _table(MATCHIDX_CODE, dev)
    # per chunk and index value: the whole match tail (index code, then
    # extra bits) and its bit count
    l2t = len2[:, code2]
    tail = enc2[:, code2] | ((torch.arange(4096, device=dev)
                              - _table(MATCHIDX_BASE, dev)[code2]) << l2t)
    tlen = l2t + _table(MATCHIDX_BLEN, dev)[code2]
    l1 = len1.reshape(-1)[chunk * HUFFMAN_CODES_1 + sym]
    c1 = enc1.reshape(-1)[chunk * HUFFMAN_CODES_1 + sym]
    is_match = sym >= 258
    ti = chunk * 4096 + idx
    bits = c1 | torch.where(is_match, tail.reshape(-1)[ti], 0) << l1
    nbits = l1 + torch.where(is_match, tlen.reshape(-1)[ti], 0)

    total = torch.zeros(C, dtype=torch.int64, device=dev) \
        .index_add_(0, chunk, nbits)
    nw = (total + 31) // 32
    word_off = torch.cumsum(nw, 0) - nw
    ends = torch.cumsum(nbits, 0)
    chunk_first = torch.cumsum(total, 0) - total      # bits before chunk
    offs = word_off[chunk] * 32 + (ends - nbits - chunk_first[chunk])
    word = offs >> 5
    shift = offs & 31
    lo = (bits << shift) & _M32
    hi = torch.where(shift > 0, bits >> (32 - shift), 0)
    words = torch.zeros(int(nw.sum()) + 1, dtype=torch.int64, device=dev)
    words.index_add_(0, word, lo).index_add_(0, word + 1, hi)
    return words[:-1], total, word_off


def payload_from_words(words: np.ndarray, total_bits: int,
                       len1: np.ndarray, len2: np.ndarray) -> bytes:
    """Host: a chunk's payload -- nibble-packed length tables, then the
    bitstream's first ceil(bits / 8) bytes (little-endian words)."""
    l1 = np.asarray(len1).astype(np.uint8)
    l2 = np.asarray(len2).astype(np.uint8)
    header = np.concatenate([l1[0::2] * 16 + l1[1::2],
                             l2[0::2] * 16 + l2[1::2]])
    nbytes = (int(total_bits) + 7) // 8
    body = np.asarray(words).astype("<u4").view(np.uint8)[:nbytes]
    return header.tobytes() + body.tobytes()
