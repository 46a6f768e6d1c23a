"""The port's encode-side Huffman stage (torch ops, on the CPU) against
``libzling_tpu.ops.huffman``: histograms, exact length tables, canonical
codes and bit packing, batched over chunks on the port's side.

Tolerance: exact equality -- frequencies, codes and payload bytes.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from libzling_tpu import spec
from libzling_tpu.ops import huffman as jh
from libzling_tpu.tables import HUFFMAN_MAX_LEN_1, HUFFMAN_MAX_LEN_2
from libzling_tpu_torch.ops import huffman as th


def _token_stream(rng, n_units):
    """A structurally valid token stream with a realistic symbol mix."""
    tokens = []
    for _ in range(n_units):
        r = rng.random()
        if r < 0.55:
            tokens.append(rng.randrange(0, 40) if rng.random() < 0.8
                          else rng.randrange(256))
        elif r < 0.62:
            tokens.append(256 + rng.randrange(2))
        else:
            tokens.append(258 + min(int(rng.expovariate(0.05)), 255))
            tokens.append(rng.randrange(1, 4096))
    return tokens


def _units(tokens):
    sym, idx, i = [], [], 0
    while i < len(tokens):
        sym.append(tokens[i])
        idx.append(tokens[i + 1] if tokens[i] >= 258 else 0)
        i += 2 if tokens[i] >= 258 else 1
    return np.asarray(sym, np.int64), np.asarray(idx, np.int64)


def test_huffman_stage_matches_jax():
    rng = random.Random(3)
    chunks = [_units(_token_stream(rng, n)) for n in (3000, 1, 1700, 40)]
    sym = torch.as_tensor(np.concatenate([s for s, _ in chunks]))
    idx = torch.as_tensor(np.concatenate([i for _, i in chunks]))
    chunk = torch.repeat_interleave(
        torch.arange(len(chunks)), torch.tensor([len(s) for s, _ in chunks]))

    f1, f2 = th.unit_histograms(sym, idx, chunk, len(chunks))
    len1 = th.exact_length_tables(f1.numpy(), HUFFMAN_MAX_LEN_1)
    len2 = th.exact_length_tables(f2.numpy(), HUFFMAN_MAX_LEN_2)
    enc1 = th.canonical_codes(torch.as_tensor(len1), HUFFMAN_MAX_LEN_1)
    enc2 = th.canonical_codes(torch.as_tensor(len2), HUFFMAN_MAX_LEN_2)
    words, bits, word_off = th.pack_units(
        sym, idx, chunk, torch.as_tensor(len1.astype(np.int64)), enc1,
        torch.as_tensor(len2.astype(np.int64)), enc2)
    words = words.numpy()
    for c, (s, i) in enumerate(chunks):
        valid = np.ones(len(s), bool)
        jf1, jf2 = jh.unit_histograms(s.astype(np.int32), i.astype(np.int32),
                                      valid)
        assert f1[c].tolist() == np.asarray(jf1).tolist()
        assert f2[c].tolist() == np.asarray(jf2).tolist()
        jl1 = jh.exact_length_tables(np.asarray(jf1)[None], HUFFMAN_MAX_LEN_1)
        jl2 = jh.exact_length_tables(np.asarray(jf2)[None], HUFFMAN_MAX_LEN_2)
        assert np.array_equal(len1[c], jl1[0])
        assert np.array_equal(len2[c], jl2[0])
        je1 = np.asarray(jh.canonical_codes(jl1[0], HUFFMAN_MAX_LEN_1))
        je2 = np.asarray(jh.canonical_codes(jl2[0], HUFFMAN_MAX_LEN_2))
        assert enc1[c].tolist() == je1.tolist()
        assert enc2[c].tolist() == je2.tolist()
        jw, jbits = jh.pack_units(s.astype(np.int32), i.astype(np.int32),
                                  valid, jl1[0], je1, jl2[0], je2,
                                  len(s) + 4)
        assert int(bits[c]) == int(jbits)
        nw = (int(jbits) + 31) // 32
        o = int(word_off[c])
        assert words[o:o + nw].tolist() == np.asarray(jw)[:nw].tolist()
        payload = th.payload_from_words(words[o:o + nw], int(bits[c]),
                                        len1[c], len2[c])
        assert payload == jh.payload_from_words(np.asarray(jw), int(jbits),
                                                jl1[0], jl2[0])
        tokens = []
        for a, b in zip(s.tolist(), i.tolist()):
            tokens += [a, b] if a >= 258 else [a]
        assert payload == spec.huffman_encode_chunk(tokens)


def test_canonical_codes_degenerate_tables():
    # empty, single-symbol and full-depth length tables, both alphabets
    for n, maxlen in ((514, HUFFMAN_MAX_LEN_1), (32, HUFFMAN_MAX_LEN_2)):
        tables = np.zeros((4, n), np.int64)
        tables[1, 7] = 1
        tables[2, :2] = 1
        tables[3, :] = np.minimum(np.arange(n) % maxlen + 1, maxlen)
        got = th.canonical_codes(torch.as_tensor(tables), maxlen)
        want = np.asarray(jh.canonical_codes(tables.astype(np.int32), maxlen))
        assert got.tolist() == want.tolist()
