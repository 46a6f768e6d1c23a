"""The plain reference codec: what every stream and output of a run is
held to.

A serial C++ transcription of the format's executable specification
(``zling.cpp``), built by g++ into the benchmark's cache folder.  It shares
no code with the program (``libzling_tpu_torch``) and imports nothing of
it, of JAX or of the JAX package, and takes nothing the program made: the
benchmark hands it the generated input.

  ``encode`` / ``decode``    the canonical stream at a level, and its
                             inverse (the MTF state carries over blocks);
  ``encode_blocks_apart`` /  the control: the same with the MTF state and
  ``decode_blocks_apart``    the level reset at every 16 MiB block, the
                             step that would let blocks run apart -- it
                             breaks the canonical stream and the round trip;
  ``chunks``, ``token_counts``  the format's own quantities of a stream
                             (the work counts of ``stages/``).
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import NamedTuple

import numpy as np

from benchmark.harness import gxx

_SRC = pathlib.Path(__file__).with_name("zling.cpp")
BLOCK_BYTES = 16777216     # zling.cpp's kBlockIn
CHUNK_TOKENS = 262144      # zling.cpp's kBlockRolz
LEVELS = range(0, 7)


def _bind(dll: ctypes.CDLL) -> ctypes.CDLL:
    vp, u32, i64, sz = (ctypes.c_void_p, ctypes.c_uint32, ctypes.c_longlong,
                        ctypes.c_size_t)
    out = ctypes.POINTER(vp)
    dll.zr_encode.restype = i64
    dll.zr_encode.argtypes = [vp, sz, ctypes.c_int, sz, u32, out]
    dll.zr_decode.restype = i64
    dll.zr_decode.argtypes = [vp, sz, out]
    dll.zr_free.restype = None
    dll.zr_free.argtypes = [vp]
    dll.zr_chunk_tokens.restype = ctypes.c_int
    dll.zr_chunk_tokens.argtypes = [vp, u32, u32, vp]
    return dll


def _lib() -> ctypes.CDLL:
    return gxx.load(_SRC, "libzling_reference", _bind,
                    ["-O3", *gxx.FLAGS[1:]])


def _ptr(buf) -> int:
    return np.frombuffer(buf, np.uint8).ctypes.data if len(buf) else 0


def _take(dll: ctypes.CDLL, n: int, p: ctypes.c_void_p) -> bytes:
    try:
        return ctypes.string_at(p.value, n) if n > 0 else b""
    finally:
        dll.zr_free(p)


def encode(data: bytes, level: int, block_bytes: int = BLOCK_BYTES,
           chunk_tokens: int = CHUNK_TOKENS) -> bytes:
    """The canonical stream of ``data`` at ``level``.  A smaller geometry
    (``block_bytes``, ``chunk_tokens``) gives a stream the spec makes at
    that geometry; the cells use the canonical one.  Each call has its own
    state, so threads may encode at once."""
    if level not in LEVELS:
        raise ValueError(f"level {level} is not in 0..6")
    dll = _lib()
    p = ctypes.c_void_p()
    n = dll.zr_encode(_ptr(data), len(data), level, block_bytes, chunk_tokens,
                      ctypes.byref(p))
    if n < 0:
        raise RuntimeError(f"reference encode failed ({n})")
    return _take(dll, n, p)


def decode(stream: bytes) -> bytes:
    """The bytes of ``stream``; raises ValueError if it is corrupt."""
    dll = _lib()
    p = ctypes.c_void_p()
    n = dll.zr_decode(_ptr(stream), len(stream), ctypes.byref(p))
    if n < 0:
        dll.zr_free(p)
        raise ValueError("zling: corrupt stream")
    return _take(dll, n, p)


class Chunk(NamedTuple):
    block: int
    encpos: int        # bytes of the block decoded after this chunk
    rlen: int          # tokens
    start: int         # offset of the payload in the stream
    olen: int          # payload bytes


def chunks(stream: bytes) -> tuple[list[Chunk], list[int]]:
    """The chunk headers of ``stream`` and the offset just past each
    block's stop flag: ``input_block := (0x01 encpos:u32be rlen:u32be
    olen:u32be payload[olen])* 0x00``."""
    out: list[Chunk] = []
    ends: list[int] = []
    pos, block = 0, 0
    while pos < len(stream):
        flag = stream[pos]
        pos += 1
        if flag == 0:
            ends.append(pos)
            block += 1
            continue
        if flag != 1 or pos + 12 > len(stream):
            raise ValueError("zling: corrupt stream (bad framing)")
        encpos, rlen, olen = (int.from_bytes(stream[pos + 4 * k:pos + 4 * k + 4],
                                             "big") for k in range(3))
        out.append(Chunk(block, encpos, rlen, pos + 12, olen))
        pos += 12 + olen
    return out, ends


def literal_count(tokens: np.ndarray) -> int:
    """Literal tokens among one chunk's: values below 256 that are not the
    match index following a match length (a value >= 258).  An index may
    itself be >= 258, so in a run of such values every odd one from the
    run's start is a length and the one after it its index."""
    t = np.asarray(tokens)
    big = t >= 258
    idx = np.arange(t.size)
    run = idx - np.maximum.accumulate(np.where(big, -1, idx))  # run length
    is_index = np.zeros(t.size, bool)
    is_index[1:] = big[:-1] & (run[:-1] % 2 == 1)
    return int(np.count_nonzero((t < 256) & ~is_index))


def token_counts(stream: bytes) -> tuple[int, int]:
    """(tokens, literal tokens) of ``stream``: the chunk headers' token
    counts, and each chunk's tokens Huffman-decoded to count literals."""
    dll = _lib()
    heads, _ = chunks(stream)
    buf = np.frombuffer(stream, np.uint8)
    tok = np.empty(CHUNK_TOKENS + 2, np.uint16)
    literals = 0
    for c in heads:
        r = dll.zr_chunk_tokens(buf.ctypes.data + c.start, c.olen, c.rlen,
                                tok.ctypes.data)
        if r != 0:
            raise ValueError("zling: corrupt stream (chunk payload)")
        literals += literal_count(tok[:c.rlen])
    return sum(c.rlen for c in heads), literals


def encode_blocks_apart(data: bytes, level: int) -> bytes:
    """The control's encoder: every 16 MiB block a stream of its own (MTF
    state and level reset), the streams joined.  Valid framing, equal to
    ``encode`` on one block, not canonical from the second block on."""
    return b"".join(encode(data[i:i + BLOCK_BYTES], level)
                    for i in range(0, len(data), BLOCK_BYTES))


def decode_blocks_apart(stream: bytes) -> bytes:
    """The control's decoder: every block decoded with a fresh MTF state,
    so from the second block on the literals come out wrong."""
    _, ends = chunks(stream)
    return b"".join(decode(stream[a:b]) for a, b in zip([0, *ends], ends))
