"""Build and load the hand-written Hopper kernels (csrc/*.cu).

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all of them at once, and the objects are linked into ONE shared library
with a plain C interface under ``build/kernels/``, at first use, keyed by a
hash of the sources and flags (``lib()``).  The cost probes
(``csrc/probes/*.cu``, ``probes/``) are a second library built the same way
(``probes_lib()``), keyed by their own sources and the shared headers
``csrc/*.cuh``, so that neither library rebuilds the other.  The pattern
is the JAX package's native engine's
(``libzling_tpu/native/engine.py::_build``): the build writes
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
_LIBS: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# entry point -> argtypes (every pointer and the stream as c_void_p, so
# ctypes never truncates them to 32 bits)
_SIGNATURES = {
    # meta, order1, lut1, lut2, mtf0, mtfnext, words, out_base, n_chunks,
    # out, ring, status, stream
    "zlt_decode_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P],
    # meta, order1, lut1, lut2, words, n_words, tok_off, n_chunks,
    # scratch, tokens, status, stream
    "zlt_entropy_decode": [_P, _P, _P, _P, _P, _L, _P, _I, _P, _P, _P, _P],
    # n_chunks, n_words -> int32 words of K1's scratch (no launch)
    "zlt_entropy_decode_scratch": [_I, _L],
    # tokens, tok_off, rlens, encpos, new_block, out_base, mtf0, mtfnext,
    # n_chunks, out, ring, status, mtf_out, stream
    "zlt_resolve": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    # buf, block_off, block_len, unit_off, params, n_blocks, max_chunks,
    # max_tokens, hash, suffix, offset, units, upos, chunk_stat,
    # block_stat, k4stat, stream
    "zlt_tokenize": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                     _P, _P, _P],
    # units, unit_off, unit_cnt, n_blocks, state_in, mtfnext, units_out,
    # state_out, stream
    "zlt_relabel": [_P, _P, _P, _I, _P, _P, _P, _P, _P],
}

# entry points that return something else than a CUDA error code
_RESTYPES = {"zlt_entropy_decode_scratch": _L}

# the cost probes (csrc/probes/*.cu); `out` is u64 [3]: word 0, word 1,
# cycles
_PROBE_SIGNATURES = {
    # config, n, depth, hash, chain, slot, block, stg, out, stream
    "zlp_unit": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    # n, rows, table, out, stream
    "zlp_serial3": [_I, _I, _P, _P, _P],
    # variant, n, init, g, out, stream
    "zlp_loop": [_I, _I, _P, _P, _P, _P],
    # n, init, obuf, out, stream
    "zlp_entropy": [_I, _P, _P, _P, _P],
    # n, init, hbm, out, stream
    "zlp_dma_whens": [_I, _P, _P, _P, _P],
    # ndma, nwords, toward_global, smem_init, hbm, out, stream
    "zlp_dma": [_I, _I, _I, _P, _P, _P, _P],
    # layers, n, init, ring, obytes, out, stream
    "zlp_match": [_I, _I, _P, _P, _P, _P, _P],
    # steps, nxt, smem_bytes, out, stream
    "zlp_resident": [_I, _P, _I, _P, _P],
    # device
    "zlp_smem_optin": [_I],
    # bytes, x, out, stream
    "zlp_smem_ceiling": [_I, _I, _P, _P],
    # kind, n, s, x, y, out, stream
    "zlp_dyn_shift": [_I, _I, _I, _P, _P, _P, _P],
    # kind, n, row, lane, x, y, out, stream
    "zlp_dyn_index": [_I, _I, _I, _I, _P, _P, _P, _P],
    # ballot, n, x, out, stream
    "zlp_warp_mix": [_I, _I, _P, _P, _P],
}
PROBE_FLAGS = ["-Xptxas", "-v"]   # ptxas's register, stack and spill report


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_hash(src_dir: pathlib.Path, headers=(), flags=()) -> str:
    """The key of a library: its flags, and the name and bytes of every
    ``*.cu*`` file of ``src_dir`` (not recursive) and of ``headers``."""
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *flags]).encode())
    for p in sorted(src_dir.glob("*.cu*")) + sorted(headers):
        h.update(p.name.encode() + p.read_bytes())
    return h.hexdigest()[:16]


def build(src_dir: pathlib.Path = _CSRC, stem: str = "libzlt_kernels",
          headers=(), flags=()) -> pathlib.Path:
    """Compile ``src_dir/*.cu`` (if not already built) into
    ``build/kernels/<stem>_<hash>.so`` and return it.  nvcc's output of
    each source is kept beside it as ``<stem>_<hash>.log``."""
    srcs = sorted(src_dir.glob("*.cu"))
    out_dir = _REPO / "build" / "kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"{stem}_{source_hash(src_dir, headers, flags)}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    tmp = out_dir / f"tmp{os.getpid()}_{stem}"
    tmp.mkdir(exist_ok=True)
    try:
        objs = [tmp / (p.stem + ".o") for p in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *flags, "-c", "-o",
                                   str(o), str(p)], stdout=subprocess.PIPE,
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
        lib.with_suffix(".log").write_text(
            "".join(f"== {src.name}\n{log}" for src, log in zip(srcs, logs)))
        so.replace(lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def _load(key: str, path_fn, signatures) -> ctypes.CDLL:
    with _LOCK:
        if key not in _LIBS:
            dll = ctypes.CDLL(str(path_fn()))
            for name, argtypes in signatures.items():
                fn = getattr(dll, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _LIBS[key] = dll
    return _LIBS[key]


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    return _load("kernels", build, _SIGNATURES)


def probe_build() -> pathlib.Path:
    """Build (if needed) the probe library: ``csrc/probes/*.cu``, keyed by
    those sources and the shared headers ``csrc/*.cuh``."""
    return build(_CSRC / "probes", "libzlt_probes",
                 headers=_CSRC.glob("*.cuh"), flags=PROBE_FLAGS)


def probes_lib() -> ctypes.CDLL:
    """The loaded cost-probe library (built on first call)."""
    return _load("probes", probe_build, _PROBE_SIGNATURES)


class DeviceLost(RuntimeError):
    """The device stopped answering (``LOST_CODES``): not a fault of the
    kernel that met it, and the only error the lanes' ``elastic`` recovery
    takes (``parallel/mesh.py::encode_groups``)."""


# cudaErrorDevicesUnavailable, cudaErrorNoDevice, cudaErrorECCUncorrectable,
# cudaErrorContextIsDestroyed: the device or its context is gone.  Every
# other code (an illegal address, a launch failure, a bad argument) is a
# fault of the code that launched.
LOST_CODES = frozenset({46, 100, 214, 709})


def device_lost(exc: BaseException) -> bool:
    """Whether ``exc`` says the device was lost: a ``DeviceLost``, or a
    torch ``AcceleratorError`` whose ``error_code`` is in ``LOST_CODES``."""
    return isinstance(exc, DeviceLost) or (
        isinstance(exc, RuntimeError)
        and getattr(exc, "error_code", None) in LOST_CODES)


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error: ``DeviceLost`` for a code
    of ``LOST_CODES``, else RuntimeError."""
    if err in LOST_CODES:
        raise DeviceLost(f"{name}: CUDA error {err} at launch (device lost)")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(t) -> int:
    """The current CUDA stream of tensor ``t``'s device, as an integer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check_devices(name: str, dev, direct=(), copied=()) -> None:
    """Raise ValueError unless a kernel's tensors lie on its device ``dev``.

    ``direct``: tensors whose pointers go to the kernel, which must be on
    ``dev`` itself; ``copied``: host metadata the wrapper moves to ``dev``,
    on ``dev`` or on the host.  A tensor on another GPU raises either way.
    The wrappers launch inside ``torch.cuda.device(dev)``: the C entry
    points set kernel attributes and launch on the runtime's current
    device, which must be the device of the tensors and of the stream.
    """
    for t in direct:
        if t.device != dev:
            raise ValueError(f"{name}: a tensor on {t.device}, the kernel "
                             f"runs on {dev}")
    for t in copied:
        if t.device.type != "cpu" and t.device != dev:
            raise ValueError(f"{name}: a tensor on {t.device}, the kernel "
                             f"runs on {dev}")
