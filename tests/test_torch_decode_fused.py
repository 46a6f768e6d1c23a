"""The port's fused decode K3 (its plain version, on the CPU) and its table
build against the JAX package: ``libzling_tpu.device.decode`` and the
Pallas fused kernel in interpret mode, on multi-chunk, multi-block streams
made with the executable spec's chunk primitives, and on crafted corrupt
streams, which both must reject.  Then streams aimed at K3's design
(``chip_smoke.resolve_cases`` and ``fused_cases``) against ``spec.decode``,
and the match counters against ``probes/stream_stats.py``'s walk.

Tolerance: exact equality -- bytes, tables and statuses are integers.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as smoke
from libzling_tpu import container, spec
from libzling_tpu import device as jdevice
from libzling_tpu.ops import decode_fused as jfk
from libzling_tpu.ops import entropy_kernel as jek
from libzling_tpu.tables import SENTINEL_LEN
from libzling_tpu_torch import device as tdevice
from libzling_tpu_torch import group_decode as tgd
from libzling_tpu_torch.ops import decode_fused as tfk
from libzling_tpu_torch.ops import entropy_kernel as tek
from libzling_tpu_torch.ops import mtf as tmtf
from libzling_tpu_torch.probes import stream_stats
from libzling_tpu_torch.utils import metrics


def _make_stream(pieces, level=1, max_tokens=300, enc=None) -> bytes:
    """Frame each piece as one input block, chunks capped at max_tokens."""
    enc = enc or spec.RolzEncoder()
    out = bytearray()
    for piece in pieces:
        buf = bytearray(piece) + bytearray(SENTINEL_LEN)
        enc.reset()
        pos = 0
        while pos < len(piece):
            tokens, pos = enc.encode_chunk(level, buf, len(piece), pos,
                                           max_tokens)
            payload = spec.huffman_encode_chunk(tokens)
            out.append(1)
            out.extend(pos.to_bytes(4, "big"))
            out.extend(len(tokens).to_bytes(4, "big"))
            out.extend(len(payload).to_bytes(4, "big"))
            out.extend(payload)
        out.append(0)
    return bytes(out)


def _pieces():
    rng = np.random.default_rng(5)
    return [
        (b"the quick brown fox jumps over the lazy dog. " * 60),
        b"ab" * 700 + b"X" * 300,                           # overlap copies
        bytes(rng.integers(0, 256, 1200, dtype=np.uint8)),  # literals
        (b"zlQ" * 500) + b"the quick brown fox",            # word-MRU heavy
    ]


def test_decode_matches_jax_multichunk_multiblock():
    pieces = _pieces()
    stream = _make_stream(pieces, level=1, max_tokens=300)
    data = b"".join(pieces)
    assert len(container.parse(stream)[0]) > len(pieces)
    assert jdevice.decode(stream, interpret=True) == data
    assert tdevice.decode(stream, device="cpu") == data


def test_decode_long_overlapping_matches():
    data = b"A" * 900 + b"B" + b"A" * 900
    stream = _make_stream([data], level=0, max_tokens=4000)
    assert jdevice.decode(stream, interpret=True) == data
    assert tdevice.decode(stream, device="cpu") == data


def _craft_raw_chunk(tokens, encpos):
    payload = spec.huffman_encode_chunk(tokens)
    out = bytearray([1])
    out.extend(encpos.to_bytes(4, "big"))
    out.extend(len(tokens).to_bytes(4, "big"))
    out.extend(len(payload).to_bytes(4, "big"))
    out.extend(payload)
    out.append(0)
    return bytes(out)


CORRUPT = {
    "matchidx_zero": ([65, 66, 258, 0], 6),
    "never_written_ring_slot": ([65, 66, 67, 258, 9], 7),
    "encpos_mismatch": ([65, 66, 67], 9),
}


@pytest.mark.parametrize("name", sorted(CORRUPT))
def test_decode_rejects_corrupt(name):
    stream = _craft_raw_chunk(*CORRUPT[name])
    with pytest.raises(ValueError):
        jdevice.decode(stream, interpret=True)
    with pytest.raises(ValueError):
        tdevice.decode(stream, device="cpu")


def test_decode_from_carried_mtf_table():
    # the fused kernel started from a mid-stream MTF table, handed over in
    # the JAX resolve/fused layout: a stream encoded after a prefix block
    # decodes only from the prefix's exit state
    enc = spec.RolzEncoder()
    _make_stream([b"warm up the mtf tables: " * 40 + bytes(range(256))],
                 enc=enc)
    table = np.asarray([enc.mtf[c].table for c in range(256)], np.int32)
    piece = _pieces()[0] + _pieces()[2][:500]
    stream = _make_stream([piece], level=2, enc=enc)
    chunks, (size,) = container.parse(stream)
    len1, len2, bodies, rlens = container.unpack_length_tables(chunks)
    C = len(chunks)
    encpos = np.asarray([ch.encpos for ch in chunks], np.int32)
    new_block = np.r_[1, np.zeros(C - 1)].astype(np.int32)
    mtf0 = np.zeros((1, tmtf.FUSED_WORDS), np.int32)
    mtf0[0, :65536] = table.reshape(-1)

    jargs = list(jfk.prepare_fused(len1, len2, bodies, rlens, encpos,
                                   new_block, np.zeros(C, np.int32)))
    jargs[5] = jnp.asarray(mtf0)
    out_words = ((size + 32767) // 32768 + 2) * 256 * 128
    packed, jstatus = jfk._fused_call(*jargs, interpret=True,
                                      out_words=out_words)
    jout = np.asarray(packed).view(np.uint8)[:size].tobytes()

    targs = list(tfk.prepare_fused(len1, len2, bodies, rlens, encpos,
                                   new_block, np.zeros(C), "cpu"))
    targs[4] = tmtf.table_from_fused(mtf0)
    tout, tstatus = tfk.fused_decode(*targs, out_size=size)
    assert jout == piece
    assert tout.numpy().tobytes() == piece
    assert tstatus[:, :3].tolist() == np.asarray(jstatus)[:, 0, :3].tolist()


def test_build_chunk_tables_matches_jax():
    stream = _make_stream(_pieces(), level=4, max_tokens=300)
    chunks, _ = container.parse(stream)
    len1, len2, _, rlens = container.unpack_length_tables(chunks)
    rng = np.random.default_rng(3)
    # add random (mostly over-subscribed) length tables: the classification
    # must agree on malformed headers too
    len1 = np.concatenate([len1, rng.integers(0, 16, (3, 514))])
    len2 = np.concatenate([len2, rng.integers(0, 9, (3, 32))])
    C = len(len1)
    n_words = rng.integers(2, 1000, C).astype(np.int32)
    word_base = (np.arange(C) * 1024).astype(np.int32)
    rl = rng.integers(0, 5000, C).astype(np.int32)
    want = jek.build_chunk_tables(
        jnp.asarray(len1.astype(np.int32)), jnp.asarray(len2.astype(np.int32)),
        jnp.asarray(n_words), jnp.asarray(word_base), jnp.asarray(rl))
    got = tek.build_chunk_tables(
        *(torch.as_tensor(np.asarray(x, np.int64))
          for x in (len1, len2, n_words, word_base, rl)))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    words, wb, nw = tek.pack_payload_words([b"abc", b"", bytes(600)])
    jw, jwb, jnw = jek.pack_payload_words([b"abc", b"", bytes(600)])
    for g, w in ((words, jw), (wb, jwb), (nw, jnw)):
        assert np.array_equal(g, w)


def test_decode_bit_flips_agree_with_jax():
    # corrupt payload bits: the port and the JAX decoder must both reject a
    # stream, or both return the same bytes
    rng = np.random.default_rng(17)
    pieces = [b"bit flips in the huffman payload. " * 12,
              bytes(rng.integers(0, 256, 200, dtype=np.uint8)) + b"ab" * 99]
    stream = _make_stream(pieces, level=1, max_tokens=200)
    chunks, _ = container.parse(stream)
    starts, pos = [], 0
    while pos < len(stream):          # payload spans: after 13-byte headers
        if stream[pos] == 0:
            pos += 1
            continue
        olen = int.from_bytes(stream[pos + 9:pos + 13], "big")
        starts.append((pos + 13, olen))
        pos += 13 + olen
    assert len(starts) == len(chunks) > 2
    outcomes = set()
    for k in range(8):
        base, olen = starts[k % len(starts)]
        bad = bytearray(stream)
        bad[base + int(rng.integers(0, olen))] ^= 1 << int(rng.integers(8))
        results = []
        for dec in (lambda s: jdevice.decode(s, interpret=True),
                    lambda s: tdevice.decode(s, device="cpu")):
            try:
                results.append(dec(bytes(bad)))
            except ValueError:
                results.append(ValueError)
        assert results[0] == results[1], k
        outcomes.add(results[0] is ValueError)
    assert True in outcomes


# ---- inputs aimed at K3's design (output window, entry ring, batches)

DESIGN_CASES = {**smoke.resolve_cases(), **smoke.fused_cases()}


@pytest.mark.parametrize("name", sorted(DESIGN_CASES))
def test_fused_design_cases_equal_spec(name):
    # K2's cases (matches W - 1, W and W + 1 bytes back, chunk and block
    # edges, overlapping copies, chunks about K2's token ring) and K3's
    # (chunks about a batch and the entry ring, long matches at batch ends)
    chunks, _ = DESIGN_CASES[name]
    stream = smoke.cases_stream(chunks)
    args, size, rlens = tdevice.decode_args(stream, "cpu")
    out, status = tfk.fused_decode(*args, out_size=size)
    assert out.numpy().tobytes() == spec.decode(stream)
    assert status[:, 0].tolist() == [e for _, _, e in chunks]
    assert status[:, 1].tolist() == rlens.tolist()
    assert not status[:, 2].any()


@pytest.mark.parametrize("name", sorted(DESIGN_CASES))
def test_fused_corrupt_design_cases_like_spec(name):
    # a match of index 0 in the middle chunk: spec rejects the stream, the
    # plain K3 marks that chunk and every later one bad
    chunks, _ = DESIGN_CASES[name]
    bad = smoke.cases_stream(smoke.corrupt_chunk(chunks))
    with pytest.raises(ValueError):
        spec.decode(bad)
    args, size, _ = tdevice.decode_args(bad, "cpu")
    _, status = tfk.fused_decode(*args, out_size=size)
    c = len(chunks) // 2
    assert status[:, 2].tolist() == [0] * c + [1] * (len(chunks) - c)


def _counts(fn):
    """fn()'s result and what it added to the decode match counters."""
    names = ("dec.matches", "dec.window_matches")
    before = metrics.registry.snapshot()["counters"]
    out = fn()
    after = metrics.registry.snapshot()["counters"]
    return out, tuple(after.get(k, 0) - before.get(k, 0) for k in names)


@pytest.mark.parametrize("level", [0, 4])
def test_match_counters_equal_the_stream_walk(level):
    # two blocks of 256 KiB with sources within and beyond the window: a
    # decode counts every match and those within the window, as the walk
    # of the stream's units finds them
    data, stream = smoke.far_match_stream(level)
    d = stream_stats.walk(tgd.parse(stream), data)["d"]
    out, got = _counts(lambda: tdevice.decode(stream, device="cpu"))
    assert out == data
    assert got == (len(d), int((d <= tfk.WINDOW).sum()))
    assert 0 < got[1] < got[0]
