"""The port's K1 (its plain version, on the CPU) against the JAX package's
Pallas entropy-decode kernel in interpret mode (``decode_chunks``), on
chunks coded by the executable spec's chunk encoder: literals, matches, the
13..15-bit tier fallback, a tiny chunk, a truncated body and a match symbol
in last place.

Tolerance: exact equality -- tokens and statuses are integers.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from libzling_tpu import spec
from libzling_tpu.ops import entropy_kernel as jek
from libzling_tpu.tables import HUFFMAN_CODES_1, HUFFMAN_CODES_2
from libzling_tpu_torch.ops import entropy_kernel as tek

HDR = (HUFFMAN_CODES_1 + HUFFMAN_CODES_2) // 2
JAX_SMALL = dict(interpret=True, slab_words=256, flush_tokens=128,
                 max_tokens=8192)


def _lengths(payload: bytes):
    nib = np.frombuffer(payload[:HDR], np.uint8)
    l1 = np.zeros(HUFFMAN_CODES_1, np.int64)
    l2 = np.zeros(HUFFMAN_CODES_2, np.int64)
    l1[0::2], l1[1::2] = nib[:HUFFMAN_CODES_1 // 2] >> 4, \
        nib[:HUFFMAN_CODES_1 // 2] & 15
    l2[0::2], l2[1::2] = nib[HUFFMAN_CODES_1 // 2:] >> 4, \
        nib[HUFFMAN_CODES_1 // 2:] & 15
    return l1, l2


def _tokens(rng, n_units, match_frac, sym_pool):
    toks: list[int] = []
    while len(toks) < n_units:
        if rng.random() < match_frac:
            toks += [int(rng.integers(258, 514)), int(rng.integers(1, 4096))]
        else:
            toks.append(int(rng.choice(sym_pool)))
    return toks


def _chunks(cases):
    """(len1, len2, bodies) of each token list, coded by the spec."""
    payloads = [spec.huffman_encode_chunk(t) for t in cases]
    l1, l2 = zip(*(_lengths(p) for p in payloads))
    return np.stack(l1), np.stack(l2), [p[HDR:] for p in payloads]


def _both(len1, len2, bodies, rlens):
    """K1 through the JAX kernel and through the port's plain version."""
    jt, js = jek.decode_chunks(len1, len2, bodies, np.asarray(rlens),
                               **JAX_SMALL)
    js = np.asarray(js)[:, 0, :3]
    args = tek.stage_chunks(len1, len2, bodies, rlens, "cpu")
    tt, ts = tek.decode_chunks(*args)
    assert tt.dtype == torch.int32 and ts.shape == (len(rlens), 3)
    return tek.tokens_from_jax(jt, rlens), js, tt, ts.numpy(), args[5]


def _same_tokens(jt, tt, status, tok_off):
    """Tokens equal up to each chunk's emitted count (the JAX kernel leaves
    stale values past it on a corrupt chunk)."""
    for c, (n, o) in enumerate(zip(status[:, 0], tok_off.tolist())):
        assert torch.equal(tt[o:o + n], jt[o:o + n]), c


def _fib_skewed(rng):
    # Fibonacci-weighted symbol counts: a tree of depth exactly 15, so codes
    # pass LUT_BITS and take the tier fallback
    fib = [1, 1]
    while len(fib) < 16:
        fib.append(fib[-1] + fib[-2])
    skewed = np.concatenate([np.full(k, s, np.int64)
                             for s, k in enumerate(fib)])
    return skewed[rng.permutation(len(skewed))].tolist()


def test_decode_chunks_matches_jax():
    rng = np.random.default_rng(7)
    cases = [
        _tokens(rng, 400, 0.0, np.arange(256)),   # literals only
        _tokens(rng, 900, 0.4, np.arange(256)),   # mixed matches
        _fib_skewed(rng),                         # 13..15-bit codes
        [65, 66],                                 # tiny chunk
        _tokens(rng, 600, 0.3, np.arange(64)),    # crosses slabs
        [65, 66, 67, 300, 5],                     # cut after the symbol
    ]
    len1, len2, bodies = _chunks(cases)
    assert len1[2].max() > tek.LUT_BITS, "no code takes the tier fallback"
    # the last chunk claims 4 tokens: its match symbol comes last and is
    # emitted alone, without its index and without a bad flag
    rlens = [len(t) for t in cases[:-1]] + [4]
    jt, js, tt, ts, tok_off = _both(len1, len2, bodies, rlens)
    assert not ts[:, 2].any() and ts[:, 0].tolist() == rlens
    assert torch.equal(tt, jt)
    assert ts.tolist() == js.tolist()          # emitted, bit_pos, bad
    for c, (toks, n) in enumerate(zip(cases, rlens)):
        o = int(tok_off[c])
        assert tt[o:o + n].tolist() == toks[:n]


@pytest.mark.parametrize("cut", [4, 2])
def test_decode_chunks_truncated_matches_jax(cut):
    # more tokens claimed than the body holds: the reader stops at the
    # padded end with the same emitted count and bad flag as the JAX kernel
    rng = np.random.default_rng(11)
    toks = _tokens(rng, 500, 0.3, np.arange(256))
    len1, len2, bodies = _chunks([toks, [65, 66, 67]])
    bodies[0] = bodies[0][: len(bodies[0]) // cut]
    jt, js, tt, ts, tok_off = _both(len1, len2, bodies, [len(toks), 3])
    assert ts[0, 2] == 1 and ts[1, 2] == 0
    assert ts.tolist() == js.tolist()
    _same_tokens(jt, tt, ts, tok_off)


def test_decode_chunks_bit_flips_match_jax():
    # flipped payload bits: every status word and token equals the JAX
    # kernel's, corrupt chunks included
    rng = np.random.default_rng(19)
    cases = [_tokens(rng, 300, 0.3, np.arange(256)) for _ in range(4)]
    len1, len2, bodies = _chunks(cases)
    for c in range(4):
        b = bytearray(bodies[c])
        for _ in range(3):
            b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(8))
        bodies[c] = bytes(b)
    jt, js, tt, ts, tok_off = _both(len1, len2, bodies,
                                    [len(t) for t in cases])
    assert any(tt[o:o + len(t)].tolist() != t
               for o, t in zip(tok_off.tolist(), cases))
    assert ts.tolist() == js.tolist()
    _same_tokens(jt, tt, ts, tok_off)
