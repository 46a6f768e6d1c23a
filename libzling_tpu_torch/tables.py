"""Constant tables of the zling bitstream format, as the port reads them.

The port's own copy of ``libzling_tpu/tables.py`` (the port imports nothing
of ``libzling_tpu``); ``tests/test_torch_independence.py`` holds every name
here equal to the JAX package's.

MATCHIDX_BLEN / MATCHIDX_CODE / MATCHIDX_BASE
    Golomb-style binning of the 4096 ROLZ match indices into 32
    entropy-coded symbols with 0..8 extra bits (reference:
    src/libzling.cpp:53-61).
MTF_INIT
    Initial symbol order of every order-1 MTF table, tuned on enwik8.
MTF_NEXT
    Sticky-MTF promotion map: the symbol at rank i swaps with rank
    MTF_NEXT[i] = floor(0.95*i) for i < 128 else floor(0.55*i).
"""

from __future__ import annotations

import numpy as np

BUCKET_ITEM_SIZE = 4096                # ring slots per context
BUCKET_ITEM_HASH = 8192                # hash-head slots per context


def _gen_matchidx_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    blen = [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7] + [8] * 1024
    code: list[int] = []
    base: list[int] = []
    while len(code) < BUCKET_ITEM_SIZE:
        b = blen[len(base)]
        code.extend([len(base)] * (1 << b))
        base.append(len(code) - (1 << b))
    n = len(base)
    return (np.asarray(blen[:n], dtype=np.uint32),
            np.asarray(code, dtype=np.uint32),
            np.asarray(base, dtype=np.uint32))


MATCHIDX_BLEN, MATCHIDX_CODE, MATCHIDX_BASE = _gen_matchidx_tables()
NUM_MATCHIDX_CODES = int(MATCHIDX_BASE.shape[0])  # 32

# enwik8-tuned initial rank->symbol order (most frequent context bytes first)
MTF_INIT = np.asarray([
     32, 101, 116,  97, 105, 111, 110, 114, 115, 108, 104, 100,  99, 117,  93,  91,
    109, 112, 103, 102,  10, 121,  98,  39, 119,  46,  44, 118,  59,  38, 124,  47,
     49, 107,  61,  48,  67,  65,  58,  45,  84,  83,  60,  62,  50, 113,  73,  57,
     42, 120,  41,  40,  66,  77,  80,  69,  68,  53,  51,  72,  70,  56,  52,  71,
     82,  54,  76,  55,  78,  87, 122, 125, 123,  79, 106,  85,  74,  75, 208,  95,
    195,  35,  86, 215,  90,  34,  89, 209, 128, 224, 184, 131,  92, 227,  37,  33,
    176, 169, 206, 226, 130,  63,  88,  81, 161, 153,  43, 129, 188, 179, 216, 164,
    181, 189, 148, 190, 173, 187, 186, 229, 225, 167, 217, 177, 178, 168, 149, 185,
    197, 144, 147, 196, 207, 194, 180, 156, 132, 170, 166, 136, 182, 191,   9, 230,
    141, 160, 175,  36, 152, 140, 165, 145,  94, 133, 163, 183, 171, 157, 137, 174,
    134, 135, 236, 151, 231, 155, 201, 158, 138, 143, 150, 162, 159, 139, 172, 154,
    126, 232, 235, 146, 233, 228, 202, 203, 142, 214, 237, 204, 219, 234, 213,  96,
    218, 199,  64, 210, 239, 198, 211, 205, 212, 240, 222, 220, 200,   0,   1,   2,
      3,   4,   5,   6,   7,   8,  11,  12,  13,  14,  15,  16,  17,  18,  19,  20,
     21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31, 127, 192, 193, 221, 223,
    238, 241, 242, 243, 244, 245, 246, 247, 248, 249, 250, 251, 252, 253, 254, 255,
], dtype=np.uint8)

MTF_NEXT = np.asarray(
    [int(i * 0.95) if i < 128 else int(i * 0.55) for i in range(256)],
    dtype=np.uint8)

# format constants (reference: src/libzling.cpp:63-72, src/libzling_lz.h)
MATCH_MIN_LEN = 4
MATCH_MAX_LEN = 259
MATCH_MIN_LEN_ENABLE_LAZY = 128

HUFFMAN_CODES_1 = 258 + (MATCH_MAX_LEN - MATCH_MIN_LEN + 1)  # 514 symbols
HUFFMAN_CODES_2 = NUM_MATCHIDX_CODES                          # 32 symbols
HUFFMAN_MAX_LEN_1 = 15
HUFFMAN_MAX_LEN_2 = 8

SENTINEL_LEN = MATCH_MAX_LEN + 16      # slack so word-wide loads stay in-bounds

BLOCK_SIZE_IN = 16777216               # input block granularity (16 MiB)
BLOCK_SIZE_ROLZ = 262144               # max tokens per chunk
BLOCK_SIZE_HUFFMAN = 393216            # max payload bytes per chunk

# per-level match-search parameters: (match_depth, lazy1_depth, lazy2_depth)
# (reference: src/libzling_lz.cpp:128-137; 5 and 6 are deeper extensions)
LEVEL_PARAMS = {
    0: (2, 1, 0),
    1: (4, 1, 0),
    2: (6, 2, 0),
    3: (8, 3, 1),
    4: (16, 4, 2),
    5: (48, 8, 4),
    6: (128, 16, 8),
}
