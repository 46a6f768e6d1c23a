"""The corpus generator: a configuration's ``corpus`` section and a seed
give the input bytes, and nothing else does.

    "corpus": {"bytes": 100000000, "base": "markov3",
               "inserts": [{"kind": "random", "bytes": 1048576,
                            "per": 16777216}]}

``base`` fills all ``bytes``; each insert then overwrites, in every span
of ``per`` bytes, one run of ``bytes`` of its ``kind`` at an offset drawn
from the seed.  Kinds:

  ``markov3``  an order-3 byte Markov chain whose statistics come from the
               frozen seed text ``benchmark/corpus/seed_text.txt``, sampled
               by ``benchmark/corpus/markov_gen.cpp`` (xorshift64*): the
               repository's enwik8 stand-in, whose ratios sit near
               enwik8's published ones;
  ``random``   uniform bytes (incompressible).

The seed is taken modulo 2**64.  The same seed gives the same bytes.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from benchmark.harness import gxx

_DIR = gxx.BENCH / "corpus"
SEED_TEXT = _DIR / "seed_text.txt"
_SAMPLER = _DIR / "markov_gen.cpp"
KINDS = ("markov3", "random")


def _bind(dll: ctypes.CDLL) -> ctypes.CDLL:
    vp = ctypes.c_void_p
    dll.markov_sample.restype = None
    dll.markov_sample.argtypes = [vp, vp, vp, vp, ctypes.c_size_t,
                                  ctypes.c_uint64, ctypes.c_uint32, vp,
                                  ctypes.c_size_t]
    return dll


@functools.lru_cache(maxsize=1)
def _model():
    """The order-3 model of the seed text, flattened for the sampler:
    per context its slice of (symbol, inclusive cumulative count)."""
    data = np.frombuffer(SEED_TEXT.read_bytes(), np.uint8)
    ctx = ((data[:-3].astype(np.uint32) << 16)
           | (data[1:-2].astype(np.uint32) << 8) | data[2:-1])
    nxt = data[3:]
    order = np.lexsort((nxt, ctx))
    pair = (ctx[order].astype(np.uint64) << 8) | nxt[order]
    uniq, counts = np.unique(pair, return_counts=True)
    u_ctx = (uniq >> 8).astype(np.uint32)
    syms = (uniq & 0xFF).astype(np.uint8)
    ctx_off = np.zeros((1 << 24) + 1, np.uint32)
    np.add.at(ctx_off, u_ctx + 1, 1)
    ctx_off = np.cumsum(ctx_off, dtype=np.uint32)
    cum = np.cumsum(counts, dtype=np.uint64)
    first = np.r_[True, u_ctx[1:] != u_ctx[:-1]]
    base = np.maximum.accumulate(np.where(first, np.r_[0, cum[:-1]], 0))
    cum32 = (cum - base).astype(np.uint32)
    return data, ctx_off, syms, cum32, np.ascontiguousarray(nxt)


def markov3(n: int, seed: int) -> np.ndarray:
    """``n`` bytes of the order-3 chain from ``seed`` (mod 2**64)."""
    data, ctx_off, syms, cum32, fallback = _model()
    out = np.empty(n, np.uint8)
    head = min(n, 3)
    out[:head] = data[:head]
    if n > 3:
        c0 = int(data[0]) << 16 | int(data[1]) << 8 | int(data[2])
        dll = gxx.load(_SAMPLER, "libmarkov", _bind)
        dll.markov_sample(ctx_off.ctypes.data, syms.ctypes.data,
                          cum32.ctypes.data, fallback.ctypes.data,
                          fallback.size, seed % 2**64, c0,
                          out[3:].ctypes.data, n - 3)
    return out


def _fill(kind: str, n: int, seed: int, rng: np.random.Generator):
    if kind == "markov3":
        return markov3(n, seed)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8)
    raise ValueError(f"corpus kind {kind!r} is not one of {KINDS}")


def generate(spec: dict, seed: int) -> bytes:
    """The corpus of a configuration's ``corpus`` section at ``seed``."""
    n = int(spec["bytes"])
    rng = np.random.default_rng(seed % 2**64)
    out = _fill(spec.get("base", "markov3"), n, seed, rng)
    for k, ins in enumerate(spec.get("inserts", [])):
        size, per = int(ins["bytes"]), int(ins["per"])
        for lo in range(0, n, per):
            span = min(per, n - lo)
            if span < size:
                continue
            at = lo + int(rng.integers(0, span - size + 1))
            out[at:at + size] = _fill(ins["kind"], size, seed + 1 + k, rng)
    return out.tobytes()
