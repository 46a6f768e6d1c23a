"""ctypes binding for the port's copy of the native C++ engine (engine.cpp).

The shared library is compiled with ``g++`` on first use into
``build/native/libzlt_torch_<hash>.so``, keyed by a hash of the source and
flags, so the package needs no install step; the build writes a temp file
and renames it, so concurrent processes never load a half-written library.

The port takes two things from it:

  * ``length_tables``: exact canonical Huffman code lengths with the
    reference's heap tie-break (``ops/huffman.py::exact_length_tables``);
  * ``encode`` / ``decode``: the canonical host codec, the reference that
    ``chip_smoke.py`` holds the card's streams to.
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
_REPO = pathlib.Path(__file__).resolve().parent.parent.parent
# the match-loop debug counters compiled out, as the reference builds them
FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
         "-DZLT_NOCNT"]
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_ENC = None
_DEC = None


def build() -> pathlib.Path:
    """Compile engine.cpp (if not already built) and return the library."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    out_dir = _REPO / "build" / "native"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libzlt_torch_{tag}.so"
    if lib.exists():
        return lib
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    r = subprocess.run([os.environ.get("CXX", "g++"), *FLAGS, str(_SRC),
                        "-o", str(tmp)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed on engine.cpp ({r.returncode}):\n"
                           f"{r.stderr}")
    tmp.replace(lib)
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB, _ENC, _DEC
    with _LOCK:
        if _LIB is None:
            dll = ctypes.CDLL(str(build()))
            dll.zlt_encoder_new.restype = ctypes.c_void_p
            dll.zlt_decoder_new.restype = ctypes.c_void_p
            dll.zlt_encode_with.restype = ctypes.c_longlong
            dll.zlt_encode_with.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]
            dll.zlt_decode_with.restype = ctypes.c_longlong
            dll.zlt_decode_with.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]
            dll.zlt_encode_bound.restype = ctypes.c_size_t
            dll.zlt_encode_bound.argtypes = [ctypes.c_size_t]
            dll.zlt_decoded_size.restype = ctypes.c_longlong
            dll.zlt_decoded_size.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            dll.zlt_length_tables.restype = None
            dll.zlt_length_tables.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            _ENC = dll.zlt_encoder_new()
            _DEC = dll.zlt_decoder_new()
            _LIB = dll
    return _LIB


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
        n = dll.zlt_encode_with(_ENC, data, len(data), level, out, cap)
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
        n = dll.zlt_decode_with(_DEC, data, len(data), out, size)
    if n == -1:
        raise ValueError("zling: corrupt stream")
    if n < 0:
        raise RuntimeError(f"zlt_decode failed ({n})")
    return ctypes.string_at(out, n)
