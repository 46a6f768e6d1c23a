"""The port's K2 (its plain version, on the CPU) against the JAX package's
Pallas resolve kernel in interpret mode (``resolve_stream``), fed the same
tokens: multi-chunk multi-block streams from the initial and from a carried
MTF table, and crafted corrupt chunks.  Then the split path on chunks with
a match symbol as a block's head byte, where the split and the fused
decoders differ in both packages.  Last, token streams aimed at K2's
design (``chip_smoke.resolve_cases``) against spec's token decoder.

Tolerance: exact equality -- bytes, statuses and MTF tables are integers.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as smoke
from libzling_tpu import device as jdevice
from libzling_tpu import spec
from libzling_tpu.ops import resolve_kernel as jrk
from libzling_tpu.tables import SENTINEL_LEN
from libzling_tpu_torch import device as tdevice
from libzling_tpu_torch.ops import decode_fused as tfk
from libzling_tpu_torch.ops import mtf as tmtf
from libzling_tpu_torch.ops import resolve_kernel as trk

SLAB = 256
KPARAMS = dict(slab_words=256, flush_tokens=128, max_tokens=4096,
               slab_tokens=256)


def _chunks(pieces, level=1, max_tokens=300, enc=None):
    """Spec tokens of each piece as one block, chunks capped at max_tokens:
    (token lists, encpos, new_block, block of each chunk)."""
    enc = enc or spec.RolzEncoder()
    toks, encpos, new_block, block = [], [], [], []
    for b, piece in enumerate(pieces):
        buf = bytearray(piece) + bytearray(SENTINEL_LEN)
        enc.reset()
        pos = 0
        while pos < len(piece):
            t, end = enc.encode_chunk(level, buf, len(piece), pos, max_tokens)
            new_block.append(int(pos == 0))
            toks.append(t)
            encpos.append(end)
            block.append(b)
            pos = end
    return toks, encpos, new_block, block


def _resolve_both(toks, encpos, new_block, block, sizes, table=None):
    """K2 through the JAX kernel and through the port's plain version:
    ((bytes, status [C, 3], table), the same for the port)."""
    C = len(toks)
    rlens = [len(t) for t in toks]
    stride = -(-max(rlens) // 128) * 128 + SLAB
    flat = np.zeros((1, C * stride), np.int32)
    for c, t in enumerate(toks):
        flat[0, c * stride:c * stride + len(t)] = t
    burst = jrk.FLUSH_ROWS * 128
    rows = np.cumsum([0] + [((s + burst - 1) // burst + 1) * jrk.FLUSH_ROWS
                            for s in sizes])
    mtf0 = None if table is None else jnp.asarray(tmtf.table_to_fused(table))
    packed, jst, jmtf = jrk.resolve_stream(
        jnp.asarray(flat), np.asarray(rlens, np.int32),
        np.asarray(encpos, np.int32), np.asarray(new_block, np.int32),
        rows[np.asarray(block)].astype(np.int32), stride,
        int(rows[-1] + jrk.FLUSH_ROWS) * 128, interpret=True,
        slab_tokens=SLAB, mtf0=mtf0)
    raw = np.asarray(packed).view(np.uint8)
    jout = b"".join(raw[r * 128:r * 128 + s].tobytes()
                    for r, s in zip(rows, sizes))

    base = np.cumsum([0] + list(sizes))
    tok_off = np.cumsum(rlens) - rlens
    tout, tst, ttab = trk.resolve_stream(
        torch.as_tensor(np.concatenate(toks).astype(np.int32)),
        torch.as_tensor(tok_off), torch.as_tensor(rlens),
        torch.as_tensor(encpos), torch.as_tensor(new_block),
        torch.as_tensor(base[np.asarray(block)]), int(base[-1]),
        tmtf.initial_table("cpu") if table is None else table)
    assert tst.dtype == torch.int32 and ttab.dtype == torch.uint8
    return ((jout, np.asarray(jst)[:, 0, :3].tolist(),
             tmtf.table_from_fused(jmtf)),
            (tout.numpy().tobytes(), tst[:, :3].tolist(), ttab))


def _pieces():
    rng = np.random.default_rng(5)
    return [
        (b"the quick brown fox jumps over the lazy dog. " * 40),
        b"ab" * 500 + b"X" * 300,                           # overlap copies
        bytes(rng.integers(0, 256, 900, dtype=np.uint8)),   # literals
        (b"zlQ" * 400) + b"the quick brown fox",            # word-MRU heavy
    ]


def test_resolve_matches_jax_multichunk_multiblock():
    pieces = _pieces()
    toks, encpos, new_block, block = _chunks(pieces)
    assert len(toks) > len(pieces)
    (jout, jst, jtab), (tout, tst, ttab) = _resolve_both(
        toks, encpos, new_block, block, [len(p) for p in pieces])
    assert jout == tout == b"".join(pieces)
    assert tst == jst
    assert torch.equal(ttab, jtab)
    assert not torch.equal(ttab, tmtf.initial_table("cpu"))


def test_resolve_from_carried_mtf_table():
    # a second run of K2 from the exit table of a first one: the blocks
    # decode only from that state, in both packages
    enc = spec.RolzEncoder()
    warm = [b"warm up the mtf tables: " * 30 + bytes(range(256))]
    _chunks(warm, enc=enc)
    table = torch.as_tensor(np.asarray([enc.mtf[c].table for c in range(256)],
                                       np.uint8))
    pieces = _pieces()[2:]
    toks, encpos, new_block, block = _chunks(pieces, level=2, enc=enc)
    (jout, jst, jtab), (tout, tst, ttab) = _resolve_both(
        toks, encpos, new_block, block, [len(p) for p in pieces], table)
    assert jout == tout == b"".join(pieces)
    assert tst == jst
    assert torch.equal(ttab, jtab)


CORRUPT = {
    "matchidx_zero": ([65, 66, 258, 0], 6),
    "never_written_ring_slot": ([65, 66, 67, 258, 9], 7),
    "encpos_mismatch": ([65, 66, 67], 9),
}


@pytest.mark.parametrize("name", sorted(CORRUPT))
def test_resolve_rejects_corrupt_like_jax(name):
    toks, encpos = CORRUPT[name]
    (_, jst, _), (_, tst, _) = _resolve_both([toks], [encpos], [1], [0],
                                             [encpos])
    assert jst[0][2] == tst[0][2] == 1


def _craft_raw_chunk(tokens, encpos):
    payload = spec.huffman_encode_chunk(tokens)
    return (b"\x01" + encpos.to_bytes(4, "big")
            + len(tokens).to_bytes(4, "big")
            + len(payload).to_bytes(4, "big") + payload + b"\x00")


# a match symbol as one of a block's two raw head bytes: the split decoders
# take its index as the next token and agree with spec.decode; the fused
# decoders never read the index bits
HEAD_MATCH = smoke.HEAD_MATCH


@pytest.mark.parametrize("name", sorted(HEAD_MATCH))
def test_head_byte_match_split_follows_jax_split(name):
    toks, encpos, split, fused = HEAD_MATCH[name]
    stream = _craft_raw_chunk(toks, encpos)
    assert spec.decode(stream) == split
    assert jdevice.decode(stream, interpret=True, fused=False,
                          **KPARAMS) == split
    assert tdevice.decode(stream, device="cpu", fused=False) == split
    assert jdevice.decode(stream, interpret=True) == fused
    assert tdevice.decode(stream, device="cpu") == fused


# ---- inputs aimed at K2's design (output window, token ring)

RESOLVE_CASES = smoke.resolve_cases()


def _spec_resolve(chunks, sizes):
    """spec's token decoder over (block, tokens, encpos) chunks: the bytes,
    every block's rings reset at its start, the MTF state carried."""
    dec, parts = spec.RolzDecoder(), []
    for b, size in enumerate(sizes):
        dec.reset()
        buf, pos = bytearray(size), 0
        for _, toks, encpos in (c for c in chunks if c[0] == b):
            pos = dec.decode_chunk(toks, buf, encpos, pos)
        parts.append(bytes(buf))
    return b"".join(parts)


@pytest.mark.parametrize("name", sorted(RESOLVE_CASES))
def test_resolve_design_cases_equal_spec(name):
    # matches W - 1, W and W + 1 bytes back (W: K2's output window), chunk
    # and block edges, overlapping copies, chunks about the token ring's
    # length; pad tokens between chunks are never read
    chunks, sizes = RESOLVE_CASES[name]
    args = smoke.resolve_args(chunks, sizes)
    out, status, table = trk.resolve_stream(*args, tmtf.initial_table("cpu"))
    assert out.numpy().tobytes() == _spec_resolve(chunks, sizes)
    assert status[:, 0].tolist() == [e for _, _, e in chunks]
    assert status[:, 1].tolist() == args[2].tolist()
    assert not status[:, 2].any()
    assert not torch.equal(table, tmtf.initial_table("cpu"))


def test_window_and_token_ring_match_the_kernel_source():
    # K2's window and token ring (resolve.cu), K3's window, pieces, entry
    # ring and status row (decode_fused.cu)
    csrc = pathlib.Path(trk.__file__).parent.parent / "csrc"
    log = trk.WINDOW.bit_length() - 1
    assert trk.WINDOW == 1 << log
    for name, ring in (("resolve.cu", trk.TOKEN_RING),
                       ("decode_fused.cu", tfk.ENTRY_RING)):
        src = (csrc / name).read_text()
        assert f"using Res = ResolverT<{log}>;" in src
        piece = int(re.search(r"constexpr int kPiece = (\d+);", src)[1])
        pieces = int(re.search(r"constexpr int kPieces = (\d+);", src)[1])
        assert piece * pieces == ring
    assert piece == tfk.PIECE
    assert f"constexpr int kStatus = {tfk.STATUS};" in src


@pytest.mark.parametrize("name", sorted(RESOLVE_CASES))
def test_resolve_corrupt_design_cases_like_spec(name):
    # a match of index 0 in the middle chunk: spec rejects the stream, the
    # plain K2 marks that chunk and every later one bad
    chunks, sizes = RESOLVE_CASES[name]
    bad = smoke.corrupt_chunk(chunks)
    with pytest.raises(ValueError):
        _spec_resolve(bad, sizes)
    c = len(chunks) // 2
    _, status, _ = trk.resolve_stream(*smoke.resolve_args(bad, sizes),
                                      tmtf.initial_table("cpu"))
    assert status[:, 2].tolist() == [0] * c + [1] * (len(chunks) - c)
