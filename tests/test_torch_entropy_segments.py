"""K1's segment design, modelled on the host: each chunk cut into segments
of S payload bits, a transfer row per segment (one walk from each of the 31
entry offsets), a scan composing the rows from bit 0, and a write pass in
which each segment re-decodes from its true entry -- the three phases of
``libzling_tpu_torch/csrc/entropy_decode.cu``, run here at small S so that a
chunk spans many segments.

The model lives in this file only; no path of the port runs it.  It is held
to the port's plain K1 (``decode_chunks_plain``, the serial walk) and to the
JAX package's Pallas kernel in interpret mode, tokens and status rows, on
valid chunks (13..15-bit codes included), a near-fixed-length table, one-
symbol tables, chunks of 1-3 tokens, a match symbol in last place, and
truncations and bit flips in the first, a middle and the last segment and
exactly at a segment edge; at the card's S on ``chip_smoke.k1_cases``.

Tolerance: exact equality -- tokens and statuses are integers.
"""

from __future__ import annotations

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import chip_smoke as smoke
from libzling_tpu.ops import entropy_kernel as jek
from libzling_tpu_torch.ops import entropy_kernel as tek
from tests.test_torch_entropy_decode import (JAX_SMALL, _chunks, _fib_skewed,
                                             _tokens)

M32 = 0xFFFFFFFF
ENTRIES = 31                  # a unit consumes at most 15 + 8 + 8 bits


def segments(n_words: int, S: int) -> int:
    """Segments of a chunk of ``n_words`` words: every segment but the last
    ends before bit 32 * n_words - 31, the first at which the reader's
    ``wpos > n_words`` can hold, so only the last can stop on it."""
    return max(1, -(-(32 * n_words - 31) // S))


class Reader:
    """The serial kernel's bit reader of one chunk, started at any bit."""

    def __init__(self, wl, wbase, tables, p: int):
        self.wl, self.wb = wl, wbase
        self.l1t, self.l2t, self.tier, self.order = tables
        k, r = p >> 5, p & 31
        w = wl[wbase + k] & M32
        if r == 0 and p > 0:        # the state the walk has at bit p
            self.acc, self.nbits, self.wpos = w, 32, k + 1
        else:
            self.acc = (w | (wl[wbase + k + 1] & M32) << 32) >> r
            self.nbits, self.wpos = 64 - r, k + 2

    @property
    def pos(self) -> int:
        return self.wpos * 32 - self.nbits

    def unit(self, index_ok: bool):
        """One unit: (bad, symbol, index or None), the serial rules."""
        if self.nbits < 32:
            self.acc |= (self.wl[self.wb + self.wpos] & M32) << self.nbits
            self.wpos += 1
            self.nbits += 32
        e = self.l1t[self.acc & 0xFFF]
        if e < 0:
            e = tek.tier_lookup(self.acc & M32, self.tier, self.order)
        bad = e < 0
        e = 0 if bad else e
        sym, hl = e & 0xFFFF, max((e >> 16) & 31, 1)
        self.acc >>= hl
        self.nbits -= hl
        if sym < 258 or not index_ok:
            return bad, sym, None
        e2 = self.l2t[self.acc & 0xFF]
        if e2 < 0:
            bad, e2 = True, 0
        hl2, blen = e2 & 0xFF, (e2 >> 8) & 0xFF
        idx = (e2 >> 16) + ((self.acc >> hl2) & ((1 << blen) - 1))
        self.acc >>= hl2 + blen
        self.nbits -= hl2 + blen
        return bad, sym, idx


def model_decode(meta, order1, lut1, lut2, words, tok_off, n_tokens, S):
    """K1 by segments of S bits; returns (tokens, status) as K1 does."""
    C = meta.shape[0]
    tokens = np.zeros(n_tokens, np.int32)
    status = np.zeros((C, 3), np.int32)
    wl = words.tolist()
    for c in range(C):
        n_words, rlen, wbase = meta[c, 0, :3].tolist()
        tier = tuple(meta[c, r].tolist() for r in (1, 2, 3))
        tables = (lut1[c].reshape(-1).tolist(), lut2[c].reshape(-1).tolist(),
                  tier, order1[c].reshape(-1).tolist())
        nseg = segments(n_words, S)
        memo = {}

        def step(p):
            # a unit as the transfer walk reads it (always with its index):
            # a function of its bit position alone, so lanes that meet
            # share it
            if p not in memo:
                rd = Reader(wl, wbase, tables, p)
                bad, _, idx = rd.unit(True)
                memo[p] = (bad, rd.pos, 1 if idx is None else 2)
            return memo[p]

        # phase 1: segment j's row, per entry e: the exit offset past the
        # segment's end, the unit parity and the tokens -- or dead (None)
        # at a missing code; the last segment needs no row
        rows = []
        for j in range(nseg - 1):
            row = []
            for e in range(ENTRIES):
                p, par, ntok, end = j * S + e, 0, 0, (j + 1) * S
                bad = False
                while p < end:
                    bad, p, n = step(p)
                    if bad:
                        break
                    par, ntok = par ^ 1, ntok + n
                row.append(None if bad else (p - end, par, ntok))
            rows.append(row)

        # phase 2: compose the rows from entry 0 of segment 0; the stop is
        # the first segment whose true walk dies or reaches rlen, else the
        # last segment
        T, e, par, entries = 0, 0, 0, []
        for j in range(nseg - 1):
            entries.append((T, e, par))
            r = rows[j][e]
            if r is None or T + r[2] >= rlen:
                break
            T, e, par = T + r[2], r[0], par ^ r[1]
        else:
            entries.append((T, e, par))
        stop = len(entries) - 1

        # phase 3: each segment up to the stop re-decodes from its entry
        # under the serial rules; the stop segment runs to the walk's end
        # and writes the status row
        out = tokens[int(tok_off[c]):]
        for j, (emitted, e, par) in enumerate(entries):
            rd = Reader(wl, wbase, tables, j * S + e)
            end = (j + 1) * S if j < stop else 1 << 62
            bad = False
            while emitted < rlen and not bad and rd.pos < end:
                bad, sym, idx = rd.unit(emitted + 1 < rlen)
                out[emitted] = sym
                emitted += 1
                if idx is not None:
                    out[emitted] = idx
                    emitted += 1
                par ^= 1
                if par == 0 or emitted >= rlen or bad:
                    bad = bad or rd.wpos > n_words
            if j < stop:
                # the premise of the design: before the stop segment the
                # serial rules never differ from the transfer walk's
                assert not bad and emitted < rlen, (c, j)
                assert (emitted, rd.pos - end, par) == entries[j + 1], (c, j)
            else:
                status[c] = (emitted, rd.pos,
                             int(bad or rd.pos > n_words * 32))
    return torch.as_tensor(tokens), torch.as_tensor(status)


def _flip(body: bytes, bit: int) -> bytes:
    b = bytearray(body)
    b[bit >> 3] ^= 1 << (bit & 7)
    return bytes(b)


def _near_fixed(rng, k):
    # every literal k times: codes of 8 bits, near the smoke's random bytes
    # (255 codes of 8 bits, 1 of 9, 2 of 10)
    return rng.permutation(np.repeat(np.arange(256), k)).tolist()


def _valid(rng):
    return [
        _tokens(rng, 700, 0.0, np.arange(256)),   # literals only
        _tokens(rng, 900, 0.4, np.arange(256)),   # mixed matches
        _fib_skewed(rng),                         # 13..15-bit codes
        _tokens(rng, 600, 0.3, np.arange(64)),
    ]


def _case(name):
    """name -> (token lists, rlens or None for every token)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "valid":
        cases = _valid(rng)
        return cases, None
    if name == "near-fixed-length":
        cases = [_near_fixed(rng, 6), _near_fixed(rng, 3) + [300, 9]]
        return cases, None
    if name == "one-symbol tables":
        cases = [[65] * 700,                         # alphabet 1: one code
                 [65, 300, 5] * 150 + [66, 67],      # alphabet 2: one code
                 [300, 5] * 200]                     # both
        return cases, None
    if name == "1-3 tokens, match last":
        cases = [[65], [65, 66], [65, 300, 5], [300, 5, 66],
                 _tokens(rng, 400, 0.3, np.arange(256)) + [301, 7]]
        # a match symbol at rlen - 1 is emitted alone (no index read)
        return cases, [1, 2, 2, 1, len(cases[-1]) - 1]
    raise KeyError(name)


CASES = ["valid", "near-fixed-length", "one-symbol tables",
         "1-3 tokens, match last"]


def _staged(cases, rlens):
    len1, len2, bodies = _chunks(cases)
    return len1, len2, bodies, rlens or [len(t) for t in cases]


@functools.lru_cache(maxsize=None)
def _jax(len1, len2, bodies, rlens):
    jt, js = jek.decode_chunks(np.frombuffer(len1, np.int64).reshape(-1, 514),
                               np.frombuffer(len2, np.int64).reshape(-1, 32),
                               list(bodies), np.asarray(rlens), **JAX_SMALL)
    return tek.tokens_from_jax(jt, rlens), np.asarray(js)[:, 0, :3]


def _check(len1, len2, bodies, rlens, S):
    """The model at S == the plain version (whole arrays) == the JAX kernel
    (status rows, and tokens up to each chunk's emitted count, on a bad
    chunk but its last unit's: the JAX kernel leaves stale values past its
    last flush there)."""
    args = tek.stage_chunks(len1, len2, bodies, rlens, "cpu")
    want_t, want_s = tek.decode_chunks_plain(*args)
    got_t, got_s = model_decode(*args, S)
    assert torch.equal(got_s, want_s)
    assert torch.equal(got_t, want_t)
    jt, js = _jax(np.asarray(len1, np.int64).tobytes(),
                  np.asarray(len2, np.int64).tobytes(), tuple(bodies),
                  tuple(rlens))
    assert want_s.tolist() == js.tolist()
    for c, ((n, _, bad), o) in enumerate(zip(want_s.tolist(),
                                             args[5].tolist())):
        n -= 2 * bad
        assert torch.equal(want_t[o:o + n], jt[o:o + n]), c
    return want_s.numpy(), args


@pytest.mark.parametrize("S", [64, 96])
@pytest.mark.parametrize("name", CASES)
def test_segments_equal_plain_and_jax(name, S):
    cases, rlens = _case(name)
    st, args = _check(*_staged(cases, rlens), S)
    # a chunk spans many segments, and every chunk decodes clean
    n_words = args[0][:, 0, 0]
    assert max(segments(int(n), S) for n in n_words) >= 8
    assert not st[:, 2].any()
    assert st[:, 0].tolist() == (rlens or [len(t) for t in cases])


def _corrupt(kind, S):
    """Six copies of one chunk, cut or flipped in the first, a middle and
    the last segment and at a segment edge, one place each; the last cut
    chunk also claims more tokens than it had.  Returns K1's host inputs
    and the chunk's tokens."""
    rng = np.random.default_rng(5)
    base = _tokens(rng, 900, 0.3, np.arange(256))
    len1, len2, bodies = _chunks([base] * 6)
    nbits = 8 * len(bodies[0])
    mid = nbits // 2 // S * S
    places = [7, mid + S // 3, nbits - 12, mid, mid - 1, nbits // S * S - 8]
    assert mid > 2 * S
    rlens = [len(base)] * 6
    if kind == "bit flips":
        bodies = [_flip(b, p) for b, p in zip(bodies, places)]
    else:
        # cut at the byte holding each place: the walk runs into the zero
        # pad, past the body, up to the overrun test
        bodies = [b[:p // 8] for b, p in zip(bodies, places)]
        rlens[-1] += 40
    return (len1, len2, bodies, rlens), base


@pytest.mark.parametrize("S", [64, 96])
@pytest.mark.parametrize("kind", ["bit flips", "truncations"])
def test_segments_equal_plain_and_jax_when_corrupt(kind, S):
    args, base = _corrupt(kind, S)
    st, staged = _check(*args, S)
    # every chunk decodes to something else than the chunk it was
    tokens = tek.decode_chunks_plain(*staged)[0]
    for (n, _, bad), o in zip(st.tolist(), staged[5].tolist()):
        assert bad or tokens[o:o + n].tolist() != base[:n] or n < len(base)


def test_rlen_past_the_body_stops_on_the_overrun_test():
    # a chunk that claims more tokens than its body holds walks the zero
    # pad until `wpos > n_words` (after a unit pair or the last unit),
    # for each parity of the unit count at the body's end
    rng = np.random.default_rng(3)
    cases = [_tokens(rng, 301 + k, 0.2, np.arange(256)) for k in range(4)]
    len1, len2, bodies = _chunks(cases)
    rlens = [len(t) + 500 for t in cases]
    for S in (64, 96):
        st, _ = _check(len1, len2, bodies, rlens, S)
        assert st[:, 2].all()


def test_k1_cases_at_the_card_segment_size():
    # chip_smoke's K1 cases at the kernel's own S: the model equals the
    # plain version on every one; each case but the many small chunks
    # spans several segments
    for name, (len1, len2, bodies, rlens) in smoke.k1_cases().items():
        args = tek.stage_chunks(len1, len2, bodies, rlens, "cpu")
        want = tek.decode_chunks_plain(*args)
        got = model_decode(*args, tek.SEG_BITS)
        assert torch.equal(got[1], want[1]), name
        assert torch.equal(got[0], want[0]), name
        n_words = args[0][:, 0, 0].tolist()
        many = max(segments(n, tek.SEG_BITS) for n in n_words) >= 4
        assert many or len(rlens) > 256, name


def test_segment_size_matches_the_kernel_source():
    src = (pathlib.Path(tek.__file__).parent.parent / "csrc"
           / "entropy_decode.cu").read_text()
    m = re.search(r"constexpr int kSegBits = (\d+);", src)
    assert m and int(m.group(1)) == tek.SEG_BITS
    m = re.search(r"constexpr int kEntries = (\d+);", src)
    assert m and int(m.group(1)) == ENTRIES
