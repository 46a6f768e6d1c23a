"""Build the benchmark's own C++ sources with g++ and load them by ctypes.

Each library lands in ``benchmark/.cache/build/`` (a fixed folder inside
the checkout), named by a hash of its source and flags, so only the first
run in a checkout compiles.  The build writes a temporary file and renames
it, so two processes never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

BENCH = pathlib.Path(__file__).resolve().parent.parent
CACHE = BENCH / ".cache"
FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: dict[pathlib.Path, ctypes.CDLL] = {}


def build(src: pathlib.Path, stem: str, flags=FLAGS) -> pathlib.Path:
    """Compile ``src`` (if not already built) and return the library."""
    tag = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    out_dir = CACHE / "build"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"{stem}_{tag.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    r = subprocess.run([os.environ.get("CXX", "g++"), *flags, str(src), "-o",
                        str(tmp)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed on {src.name} ({r.returncode}):\n"
                           f"{r.stderr}")
    tmp.replace(lib)
    return lib


def load(src: pathlib.Path, stem: str, bind, flags=FLAGS) -> ctypes.CDLL:
    """The library of ``src``, built and loaded once a process; ``bind``
    declares its signatures."""
    with _LOCK:
        if src not in _LIBS:
            _LIBS[src] = bind(ctypes.CDLL(str(build(src, stem, flags))))
        return _LIBS[src]
