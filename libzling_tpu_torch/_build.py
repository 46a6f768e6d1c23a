"""Build and load the hand-written Hopper kernels (csrc/*.cu).

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all of them at once, and the objects are linked into ONE shared library
with a plain C interface under ``build/kernels/``, at first use, keyed by a
hash of the sources and flags -- the same pattern as the JAX package's
native engine (``libzling_tpu/native/engine.py::_build``): the build writes
a temp file and renames it, so concurrent processes never load a
half-written library.  The library is loaded with ctypes; each entry point
takes device pointers and the CUDA stream as ``c_void_p`` and returns
``cudaGetLastError()`` after its launch, which ``check`` turns into an
exception.

A missing ``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_CSRC = pathlib.Path(__file__).with_name("csrc")
_REPO = pathlib.Path(__file__).resolve().parent.parent
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes (every pointer and the stream as c_void_p, so
# ctypes never truncates them to 32 bits)
_SIGNATURES = {
    # meta, order1, lut1, lut2, mtf0, mtfnext, words, out_base, n_chunks,
    # out, ring, status, stream
    "zlt_decode_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P],
    # meta, order1, lut1, lut2, words, tok_off, n_chunks, tokens, status,
    # stream
    "zlt_entropy_decode": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P],
    # tokens, tok_off, rlens, encpos, new_block, out_base, mtf0, mtfnext,
    # n_chunks, out, ring, status, mtf_out, stream
    "zlt_resolve": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    # buf, block_off, block_len, unit_off, params, n_blocks, max_chunks,
    # max_tokens, hash, suffix, offset, units, upos, chunk_stat,
    # block_stat, stream
    "zlt_tokenize": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                     _P, _P],
    # units, unit_off, unit_cnt, n_blocks, state_in, mtfnext, units_out,
    # state_out, stream
    "zlt_relabel": [_P, _P, _P, _I, _P, _P, _P, _P, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> pathlib.Path:
    """Compile csrc/*.cu (if not already built) and return the library."""
    srcs = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode() + p.read_bytes())
    out_dir = _REPO / "build" / "kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libzlt_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    tmp = out_dir / f"tmp{os.getpid()}"
    tmp.mkdir(exist_ok=True)
    try:
        objs = [tmp / (p.stem + ".o") for p in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                   str(p)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]   # waits for every one
        for p, src, log in zip(procs, srcs, logs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} ({p.returncode}):\n{log}")
        so = tmp / lib.name
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(so), *map(str, objs)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stderr}")
        so.replace(lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            dll = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(dll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = dll
    return _LIB


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(t) -> int:
    """The current CUDA stream of tensor ``t``'s device, as an integer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
