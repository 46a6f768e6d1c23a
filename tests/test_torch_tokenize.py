"""The port's tokenizer K4 (its plain version, on the CPU) against the JAX
package's Pallas tokenizer in interpret mode and against ``spec.py``.

Tolerance: exact equality -- units, positions and chunk stats are integers.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from libzling_tpu import spec
from libzling_tpu.ops import tokenize_kernel as jtk
from libzling_tpu.tables import SENTINEL_LEN
import libzling_tpu_torch as zt
from libzling_tpu_torch.ops import tokenize_kernel as ttk
from libzling_tpu_torch.utils import metrics


def _mixed(seed: int, size: int) -> bytes:
    rng = np.random.default_rng(seed)
    text = (b"the quick brown fox jumps over the lazy dog. " * 200)
    text = text[: size // 2]
    return text + bytes(rng.integers(0, 256, size - len(text), dtype=np.uint8))


@pytest.mark.parametrize("level,seed,size", [(0, 3, 3000), (2, 7, 5000)])
def test_tokenize_matches_jax_kernel(level, seed, size):
    data = _mixed(seed, size)
    max_tokens, max_chunks, chunk_units = 700, 12, 700
    levels = np.full(max_chunks, level, np.int32)
    levels[1] = 0  # mixed schedule mid-block
    want = jtk.tokenize_block(data, levels, max_tokens, max_chunks,
                              chunk_units, interpret=True)
    got = ttk.tokenize_block(data, levels, max_tokens, max_chunks,
                             chunk_units, device="cpu")
    (sym, idx, upos, kind, nunits, ntoks, encpos, n_chunks, err) = got
    assert (n_chunks, err) == (want[7], want[8]) == (n_chunks, 0)
    assert n_chunks > 2
    for a, b in zip((nunits, ntoks, encpos), want[4:7]):
        assert np.asarray(a).tolist() == np.asarray(b).tolist()
    for c in range(n_chunks):
        nu = int(nunits[c])
        for a, b in zip((sym, idx, upos, kind), want[:4]):
            assert a[c, :nu].tolist() == np.asarray(b)[c, :nu].tolist(), c


def _spec_chunks(data: bytes, levels, max_tokens: int, enc=None):
    """spec.RolzEncoder over one block, chunk by chunk."""
    enc = enc or spec.RolzEncoder()
    enc.reset()
    buf = bytearray(data) + bytearray(SENTINEL_LEN)
    out, pos, c = [], 0, 0
    while pos < len(data):
        tokens, pos = enc.encode_chunk(int(levels[c]), buf, len(data), pos,
                                       max_tokens)
        out.append((tokens, pos))
        c += 1
    return out


def _units_to_tokens(units, upos, buf, mtf):
    """Packed raw-literal units -> spec tokens (MTF applied in unit order)."""
    tokens = []
    for w, up in zip(units, upos):
        sym, kind = w & 1023, (w >> 10) & 3
        if kind == 3:
            tokens += [sym, (w >> 14) & 4095]
        elif kind == 1:
            assert (w >> 14) & 255 == buf[up - 1]
            tokens.append(mtf[buf[up - 1]].encode(buf[up]))
        else:
            tokens.append(sym)
    return tokens


def test_tokenize_extended_level_matches_spec():
    # e5 (depth 48, lazy 8/4): the depth is a runtime value, so the deep
    # chain walks are exact; checked against the executable spec
    data = (b"abcabcabd" * 120) + b"the quick brown fox " * 30
    max_tokens, max_chunks = 4000, 4
    sym, idx, upos, kind, nunits, ntoks, encpos, n_chunks, err = \
        ttk.tokenize_block(data, [5] * max_chunks, max_tokens, max_chunks,
                           max_tokens, device="cpu")
    assert err == 0 and n_chunks == 1
    ((tokens, pos),) = _spec_chunks(data, [5], max_tokens)
    assert int(encpos[0]) == pos and int(ntoks[0]) == len(tokens)
    nu = int(nunits[0])
    a = (sym[0, :nu] | kind[0, :nu] << 10
         | np.where(kind[0, :nu] == 3, idx[0, :nu], 0) << 14)
    buf = bytearray(data)
    lit_ctx = np.asarray([buf[p - 1] for p in upos[0, :nu]])
    a = np.where(kind[0, :nu] == 1, a | lit_ctx << 14, a)
    got = _units_to_tokens(a.tolist(), upos[0, :nu].tolist(), buf,
                           spec.RolzEncoder().mtf)
    assert got == tokens


def test_tokenize_flat_blocks_match_spec():
    # several blocks of one launch, flat layout, each block with its own
    # level schedule; the MTF chain runs across blocks as in the format
    rng = np.random.default_rng(11)
    blocks = [_mixed(1, 1800), bytes(rng.integers(0, 256, 700, np.uint8)),
              (b"zlQ" * 300) + b"the quick brown fox", b"x"]
    scheds = [[1, 0, 6, 6, 6], [4, 4, 4, 4, 4], [3, 2, 2, 2, 2],
              [0, 0, 0, 0, 0]]
    max_tokens = 500
    data = b"".join(blocks)
    offs = np.cumsum([0] + [len(b) for b in blocks])[:-1]
    buf = torch.zeros(len(data) + SENTINEL_LEN, dtype=torch.uint8)
    buf[:len(data)] = torch.as_tensor(np.frombuffer(data, np.uint8).copy())
    units, upos, cstat, bstat, _ = ttk.tokenize(
        buf, torch.as_tensor(offs), torch.tensor([len(b) for b in blocks]),
        torch.as_tensor(offs), ttk.level_params(scheds, "cpu"), max_tokens,
        len(data))
    mtf = spec.RolzEncoder().mtf
    enc = spec.RolzEncoder()
    for b, blk in enumerate(blocks):
        ref = _spec_chunks(blk, scheds[b], max_tokens, enc)
        assert bstat[b].tolist() == [len(ref), 0]
        u = int(offs[b])
        for c, (tokens, pos) in enumerate(ref):
            nu, nt, ep = cstat[b, c].tolist()
            assert (nt, ep) == (len(tokens), pos)
            got = _units_to_tokens(units[u:u + nu].tolist(),
                                   upos[u:u + nu].tolist(), bytearray(blk),
                                   mtf)
            assert got == tokens, (b, c)
            u += nu


def test_plain_tokenize_leaves_the_runahead_counters_alone():
    # the plain K4 has no run-ahead warps: it returns no counts, and an
    # encode on the CPU adds nothing to the counters the kernel's feed
    data = _mixed(5, 6000)
    buf = torch.zeros(len(data) + SENTINEL_LEN, dtype=torch.uint8)
    buf[:len(data)] = torch.as_tensor(np.frombuffer(data, np.uint8).copy())
    zero = torch.zeros(1, dtype=torch.int64)
    out = ttk.tokenize(buf, zero, torch.tensor([len(data)]), zero,
                       ttk.level_params([[4] * 12], "cpu"), 700, len(data))
    assert len(out) == 5 and out[4] is None
    keys = ("enc.k4_starts", "enc.k4_runahead_covered")
    before = metrics.registry.snapshot()["counters"]
    stream = zt.encode(data, 4, device="cpu", block_size=2048,
                       max_tokens=500)
    assert stream == spec.encode(data, 4, block_size=2048, max_tokens=500)
    after = metrics.registry.snapshot()["counters"]
    assert [after.get(k) for k in keys] == [before.get(k) for k in keys]
