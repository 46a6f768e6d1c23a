"""Container framing: parse and validate the zling stream structure.

The port's own copy of ``libzling_tpu/container.py``.

stream := input_block*;  input_block := (0x01 chunk)* 0x00;
chunk  := encpos:u32be rlen:u32be olen:u32be payload[olen]
(reference src/libzling.cpp:199-278,312-332).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .tables import (
    BLOCK_SIZE_HUFFMAN,
    BLOCK_SIZE_IN,
    BLOCK_SIZE_ROLZ,
    HUFFMAN_CODES_1,
    HUFFMAN_CODES_2,
)

HEADER = (HUFFMAN_CODES_1 + HUFFMAN_CODES_2) // 2   # 273 B of length tables


class Chunk(NamedTuple):
    block_id: int
    encpos: int      # bytes decoded within the block after this chunk
    rlen: int        # token count
    payload: bytes   # length-table header + Huffman bits


def parse(data: bytes) -> tuple[list[Chunk], list[int]]:
    """Parse a stream into chunks plus per-block decoded sizes.

    Raises ValueError on malformed framing (stricter than the reference:
    encpos must be non-decreasing within a block).
    """
    chunks: list[Chunk] = []
    block_sizes: list[int] = []
    pos, n, block_id, last_encpos = 0, len(data), 0, 0
    while pos < n:
        flag = data[pos]
        pos += 1
        if flag == 0:
            block_sizes.append(last_encpos)
            last_encpos = 0
            block_id += 1
            continue
        if flag != 1 or pos + 12 > n:
            raise ValueError("zling: corrupt stream (bad framing)")
        encpos = int.from_bytes(data[pos:pos + 4], "big")
        rlen = int.from_bytes(data[pos + 4:pos + 8], "big")
        olen = int.from_bytes(data[pos + 8:pos + 12], "big")
        pos += 12
        if (rlen > BLOCK_SIZE_ROLZ or olen > BLOCK_SIZE_HUFFMAN
                or encpos > BLOCK_SIZE_IN or encpos < last_encpos
                or olen < HEADER or pos + olen > n):
            raise ValueError("zling: corrupt stream (bad chunk header)")
        chunks.append(Chunk(block_id, encpos, rlen, data[pos:pos + olen]))
        last_encpos = encpos
        pos += olen
    if last_encpos != 0:
        raise ValueError("zling: truncated stream (missing stop flag)")
    return chunks, block_sizes


def unpack_length_tables(chunks: list[Chunk]):
    """Nibble-unpack each chunk's code-length tables.

    Returns (len1 [C, 514] u32, len2 [C, 32] u32, bodies: per-chunk Huffman
    bitstream bytes, rlens [C] i64).
    """
    C = len(chunks)
    len1 = np.zeros((C, HUFFMAN_CODES_1), np.uint32)
    len2 = np.zeros((C, HUFFMAN_CODES_2), np.uint32)
    bodies: list[bytes] = []
    rlens = np.zeros(C, np.int64)
    for c, ch in enumerate(chunks):
        nib = np.frombuffer(ch.payload[:HEADER], np.uint8)
        len1[c, 0::2] = nib[: HUFFMAN_CODES_1 // 2] >> 4
        len1[c, 1::2] = nib[: HUFFMAN_CODES_1 // 2] & 15
        len2[c, 0::2] = nib[HUFFMAN_CODES_1 // 2:] >> 4
        len2[c, 1::2] = nib[HUFFMAN_CODES_1 // 2:] & 15
        bodies.append(ch.payload[HEADER:])
        rlens[c] = ch.rlen
    return len1, len2, bodies, rlens
