"""ctypes binding for the port's copy of the native C++ engine (engine.cpp).

The shared library is compiled with ``g++`` on first use into
``build/native/libzlt_torch_<hash>.so``, keyed by a hash of the source and
flags, so the package needs no install step; the build writes a temp file
and renames it, so concurrent processes never load a half-written library.

The port takes these from it:

  * ``length_tables``: exact canonical Huffman code lengths with the
    reference's heap tie-break (``ops/huffman.py::exact_length_tables``);
  * ``encode`` / ``decode``: the canonical host codec, the reference that
    ``chip_smoke.py`` holds the card's streams to, and ``encode_into`` /
    ``decode_into``, the same into a caller's writable buffer;
  * ``encode_from``: whole blocks encoded from a carried MTF state and
    level through the engine's split-stage ABI (tokenize with raw
    literals, relabel, entropy-code a chunk) -- the lanes' host re-encode
    of a failed group (``parallel/mesh.py``, ``elastic``);
  * the rest of that ABI (entropy-decode a chunk, the resolver, the
    match-loop counters) and ``adaptive_drop``, the chunk validation
    ``encode_from`` and the block-parallel host pipeline
    (``pipeline.py``) share.

The match-loop counters are compiled out, as the reference builds them,
unless ``ZLT_COUNTERS=1`` is set when the library is first loaded (the
JAX package's switch); ``_lib(counters=True)`` loads the counting build
beside the other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_SRC = pathlib.Path(__file__).with_name("engine.cpp")
# engine.cpp's compiled-in geometry: kChunkTokens, kBlockIn, kChunkPayloadMax
CHUNK_TOKENS = 262144
BLOCK_BYTES = 16777216
_PAYLOAD_MAX = 393216
STATE_BYTES = 2 * 256 * 256    # MtfState: rank2sym, then sym2rank
_REPO = pathlib.Path(__file__).resolve().parent.parent.parent
FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
NOCNT = "-DZLT_NOCNT"          # the match-loop debug counters compiled out
_LOCK = threading.Lock()
_LIBS: dict[bool, ctypes.CDLL] = {}     # by ``counters``


def build(counters: bool = False) -> pathlib.Path:
    """Compile engine.cpp (if not already built) and return the library;
    with ``counters`` the match-loop counters are compiled in."""
    flags = FLAGS if counters else FLAGS + [NOCNT]
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    out_dir = _REPO / "build" / "native"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libzlt_torch_{tag}.so"
    if lib.exists():
        return lib
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    r = subprocess.run([os.environ.get("CXX", "g++"), *flags, str(_SRC),
                        "-o", str(tmp)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed on engine.cpp ({r.returncode}):\n"
                           f"{r.stderr}")
    tmp.replace(lib)
    return lib


def _lib(counters: bool | None = None) -> ctypes.CDLL:
    """The engine, loaded once a process for each build: ``counters``
    picks it (None: the one ``ZLT_COUNTERS`` names).  Each library holds
    its own canonical encoder and decoder handles (``handles``)."""
    if counters is None:
        counters = os.environ.get("ZLT_COUNTERS", "") == "1"
    with _LOCK:
        if counters not in _LIBS:
            dll = _bind(ctypes.CDLL(str(build(counters))))
            dll.handles = (dll.zlt_encoder_new(), dll.zlt_decoder_new())
            _LIBS[counters] = dll
        return _LIBS[counters]


def _bind(dll: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the signatures of the functions the port calls."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.zlt_encoder_new.restype = vp
    dll.zlt_decoder_new.restype = vp
    dll.zlt_encode_with.restype = i64
    dll.zlt_encode_with.argtypes = [
        vp, ctypes.c_char_p, ctypes.c_size_t, i32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]
    dll.zlt_decode_with.restype = i64
    dll.zlt_decode_with.argtypes = [
        vp, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]
    dll.zlt_encode_bound.restype = ctypes.c_size_t
    dll.zlt_encode_bound.argtypes = [ctypes.c_size_t]
    dll.zlt_decoded_size.restype = i64
    dll.zlt_decoded_size.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    dll.zlt_length_tables.restype = None
    dll.zlt_length_tables.argtypes = [vp, i32, i32, i32, vp]
    # the split-stage ABI (engine.cpp: "split-stage pipeline ABI")
    for name in ("zlt_tokenizer_new", "zlt_mtf_new", "zlt_resolver_new"):
        getattr(dll, name).restype = vp
        getattr(dll, name).argtypes = []
    for name in ("zlt_tokenizer_free", "zlt_mtf_free", "zlt_mtf_reset",
                 "zlt_resolver_free", "zlt_resolver_reset_stream",
                 "zlt_resolver_reset_block", "zlt_counters_reset"):
        getattr(dll, name).restype = None
        getattr(dll, name).argtypes = [vp]
    for name in ("zlt_mtf_load", "zlt_mtf_save", "zlt_resolver_mtf_load",
                 "zlt_resolver_mtf_save", "zlt_counters"):
        getattr(dll, name).restype = None
        getattr(dll, name).argtypes = [vp, vp]
    dll.zlt_tokenize_block_raw.restype = i32
    dll.zlt_tokenize_block_raw.argtypes = [
        vp, vp, i32, vp, i32, vp, i64, vp, vp]
    dll.zlt_relabel_block.restype = None
    dll.zlt_relabel_block.argtypes = [vp, vp, vp, vp, i32]
    dll.zlt_entropy_encode.restype = i32
    dll.zlt_entropy_encode.argtypes = [vp, i32, vp]
    dll.zlt_entropy_decode.restype = i32
    dll.zlt_entropy_decode.argtypes = [vp, i32, i32, vp]
    dll.zlt_resolve_chunk.restype = i32
    dll.zlt_resolve_chunk.argtypes = [vp, vp, i32, i32, vp, i32]
    return dll


def length_tables(freqs: np.ndarray, max_codelen: int) -> np.ndarray:
    """freqs [C, n] -> code lengths [C, n] uint32, reference tie-breaking."""
    dll = _lib()
    freqs = np.ascontiguousarray(freqs, dtype=np.uint32)
    c, n = freqs.shape
    out = np.zeros((c, n), dtype=np.uint32)
    dll.zlt_length_tables(freqs.ctypes.data, c, n, max_codelen,
                          out.ctypes.data)
    return out


def encode(data: bytes, level: int = 0) -> bytes:
    """The canonical stream of ``data`` at ``level``."""
    if not 0 <= level <= 6:
        raise ValueError("level must be 0..6")
    dll = _lib()
    cap = dll.zlt_encode_bound(len(data))
    out = (ctypes.c_uint8 * cap)()
    with _LOCK:
        n = dll.zlt_encode_with(dll.handles[0], data, len(data), level,
                                out, cap)
    if n < 0:
        raise RuntimeError(f"zlt_encode failed ({n})")
    return ctypes.string_at(out, n)


def decode(data: bytes) -> bytes:
    """Decode a stream on the host; raises ValueError if it is corrupt."""
    dll = _lib()
    size = dll.zlt_decoded_size(data, len(data))
    if size < 0:
        raise ValueError("zling: corrupt stream (bad framing)")
    out = (ctypes.c_uint8 * max(size, 1))()
    with _LOCK:
        n = dll.zlt_decode_with(dll.handles[1], data, len(data), out, size)
    if n == -1:
        raise ValueError("zling: corrupt stream")
    if n < 0:
        raise RuntimeError(f"zlt_decode failed ({n})")
    return ctypes.string_at(out, n)


def encode_into(data, out, level: int = 0) -> int:
    """Encode into a caller-provided writable buffer; returns bytes written
    (the JAX package's ``encode_into``).  A buffer too small raises
    RuntimeError."""
    dll = _lib()
    buf = (ctypes.c_uint8 * len(out)).from_buffer(out)
    with _LOCK:
        n = dll.zlt_encode_with(dll.handles[0], bytes(data), len(data),
                                level, buf, len(out))
    if n < 0:
        raise RuntimeError(f"zlt_encode failed ({n})")
    return n


def decode_into(data, out) -> int:
    """Decode into a caller-provided writable buffer; returns bytes written
    (the JAX package's ``decode_into``).  A corrupt stream raises
    ValueError, any other failure RuntimeError."""
    dll = _lib()
    buf = (ctypes.c_uint8 * len(out)).from_buffer(out)
    with _LOCK:
        n = dll.zlt_decode_with(dll.handles[1], bytes(data), len(data), buf,
                                len(out))
    if n == -1:
        raise ValueError("zling: corrupt stream")
    if n < 0:
        raise RuntimeError(f"zlt_decode failed ({n})")
    return n


def adaptive_drop(used, encpos, entry_level: int, level: int, olen
                  ) -> tuple[list[int], int, int, int]:
    """The adaptive level drop (src/libzling.cpp:261-266) checked over one
    block's chunks in order.  Chunk c was tokenized at level ``used[c]``
    and ends at block position ``encpos[c]``; ``olen(c)`` codes it and
    gives its payload's size.  A chunk must be coded at the requested
    ``level`` unless the chunk before it (for the first: ``entry_level``
    says) compressed its input to more than 95%; then at 0.

    Returns (the payload sizes of the chunks whose level was right, in
    order; the level the chunk after them must take; the first chunk
    whose level was wrong, or -1; how many of them dropped the level)."""
    lvl, prev_end, sizes, drops = entry_level, 0, [], 0
    for c in range(len(used)):
        if int(used[c]) != lvl:
            return sizes, lvl, c, drops
        n = olen(c)
        sizes.append(n)
        lvl = 0 if n / (int(encpos[c]) - prev_end + 1) > 0.95 else level
        drops += lvl == 0 and level != 0
        prev_end = int(encpos[c])
    return sizes, lvl, -1, drops


def chunk_header(encpos: int, rlen: int, olen: int) -> bytes:
    """A chunk's frame before its payload: the continue flag, then its
    block end position, token count and payload size (big-endian)."""
    return b"\x01" + encpos.to_bytes(4, "big") + rlen.to_bytes(4, "big") \
        + olen.to_bytes(4, "big")


def encode_from(data: bytes, level: int, state: bytes, entry_level: int,
                block_size: int = BLOCK_BYTES) -> tuple[bytes, bytes, int]:
    """Encode ``data`` as whole blocks of ``block_size`` bytes, starting
    from a carried MTF ``state`` (131,072 bytes, ``ops/mtf.py``
    ``state_to_bytes``) and the level ``entry_level`` its first chunk is
    coded at; returns (the blocks' stream bytes, the exit state, the exit
    level).

    The chunk cap is the engine's compiled-in ``CHUNK_TOKENS`` (the
    canonical 262,144), so the bytes are ``spec``'s at ``max_tokens =
    CHUNK_TOKENS`` from the same carry.  A serial form of the JAX
    ``pipeline.ParallelEncoder.encode_with_carry``: each block is
    tokenized under a per-chunk level schedule (the carried level, then
    the requested one), relabelled from a snapshot of the state and coded
    a chunk at a time while the adaptive drop (src/libzling.cpp:261-266)
    is checked; where the schedule was wrong the state is restored and the
    block tokenized again from the corrected chunk on.
    """
    if not 0 <= level <= 6 or not 0 <= entry_level <= 6:
        raise ValueError("level must be 0..6")
    if len(state) != STATE_BYTES:
        raise ValueError(f"an MTF state is {STATE_BYTES} bytes, "
                         f"not {len(state)}")
    if not 1 <= block_size <= BLOCK_BYTES:
        raise ValueError(f"block_size must be 1..{BLOCK_BYTES}")
    dll = _lib()
    src = np.frombuffer(data, np.uint8)
    # a chunk ends at the token cap and holds at least half as many bytes
    max_chunks = -(-block_size // (CHUNK_TOKENS // 2)) + 1
    tokens = np.empty(block_size + CHUNK_TOKENS + 16, np.uint16)
    payload = np.empty(_PAYLOAD_MAX + 512, np.uint8)
    rlens = np.zeros(max_chunks, np.int32)
    encpos = np.zeros(max_chunks, np.int32)
    snapshot = np.empty(STATE_BYTES, np.uint8)
    out = bytearray()
    current = entry_level
    tok = dll.zlt_tokenizer_new()
    mtf = dll.zlt_mtf_new()
    try:
        dll.zlt_mtf_load(mtf, state)
        for start in range(0, len(src), block_size):
            ilen = min(block_size, len(src) - start)
            block = np.zeros(ilen + 16, np.uint8)
            block[:ilen] = src[start:start + ilen]
            sched = np.full(max_chunks, level, np.int32)
            sched[0] = current
            dll.zlt_mtf_save(mtf, snapshot.ctypes.data)
            while True:
                n = dll.zlt_tokenize_block_raw(
                    tok, block.ctypes.data, ilen, sched.ctypes.data,
                    max_chunks, tokens.ctypes.data, tokens.size,
                    rlens.ctypes.data, encpos.ctypes.data)
                if n < 0:
                    raise RuntimeError("zlt_tokenize_block_raw overflow")
                dll.zlt_relabel_block(mtf, block.ctypes.data,
                                      tokens.ctypes.data, rlens.ctypes.data,
                                      n)
                starts = np.concatenate(([0], np.cumsum(rlens[:n])))
                chunks = []

                def olen(c):
                    rl = int(rlens[c])
                    size = dll.zlt_entropy_encode(
                        tokens.ctypes.data + 2 * int(starts[c]), rl,
                        payload.ctypes.data)
                    chunks.append(chunk_header(int(encpos[c]), rl, size)
                                  + payload[:size].tobytes())
                    return size

                # coded one chunk at a time: after a wrong level, no more
                _, lvl, fix, _ = adaptive_drop(sched[:n], encpos, current,
                                               level, olen)
                if fix < 0:
                    break
                # the chunks before ``fix`` stay; it and the rest run at
                # the level its predecessor left
                sched[fix:] = lvl
                dll.zlt_mtf_load(mtf, snapshot.ctypes.data)
            out += b"".join(chunks)
            out.append(0)
            current = lvl
        dll.zlt_mtf_save(mtf, snapshot.ctypes.data)
    finally:
        dll.zlt_mtf_free(mtf)
        dll.zlt_tokenizer_free(tok)
    return bytes(out), snapshot.tobytes(), current
