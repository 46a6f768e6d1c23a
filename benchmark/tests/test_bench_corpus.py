"""The corpus generator: a function of the seed and the benchmark's files."""

import hashlib
import json
import pathlib

import numpy as np

from benchmark.harness import corpus, layout

REPO = pathlib.Path(__file__).resolve().parents[2]


def test_same_seed_same_bytes_other_seed_other_bytes():
    spec = {"bytes": 300_000, "base": "markov3"}
    a = corpus.generate(spec, 2**31 + 17)
    assert a == corpus.generate(spec, 2**31 + 17)
    b = corpus.generate(spec, 2**31 + 18)
    assert len(a) == len(b) == 300_000 and a != b
    # seeds past 64 bits wrap, they do not fail
    assert corpus.generate(spec, 2**64 + 5) == corpus.generate(spec, 5)


def test_markov_text_is_text_like():
    data = np.frombuffer(corpus.generate({"bytes": 200_000}, 7), np.uint8)
    # the seed text's statistics: mostly printable ASCII (it holds some
    # UTF-8), many spaces
    assert np.mean((data >= 32) & (data < 127) | (data == 10)) > 0.9
    assert np.mean(data == 32) > 0.08


def test_inserts_one_run_per_span_at_seeded_offsets():
    base = {"bytes": 40_000, "base": "markov3"}
    spec = {**base, "inserts": [{"kind": "random", "bytes": 1000,
                                 "per": 10_000}]}
    text = np.frombuffer(corpus.generate(base, 3), np.uint8)
    data = np.frombuffer(corpus.generate(spec, 3), np.uint8)
    starts = []
    for lo in range(0, 40_000, 10_000):
        diff = np.flatnonzero(data[lo:lo + 10_000] != text[lo:lo + 10_000])
        assert 950 <= diff.size and diff[-1] - diff[0] < 1000
        starts.append(diff[0])
    assert len(set(starts)) > 1                      # offsets differ
    other = np.frombuffer(corpus.generate(spec, 4), np.uint8)
    assert not np.array_equal(data, other)


def test_seed_text_frozen():
    """The seed text is the benchmark's own copy: its bytes never change
    (the configurations' ratios were recorded on it)."""
    h = hashlib.sha256(corpus.SEED_TEXT.read_bytes()).hexdigest()
    assert h == ("69790b2258b104c82304ff2de6cc7278c95f18b28697380d83695dd735"
                 "c26334")


def test_configs_name_their_corpus():
    bench = layout.Benchmark()
    for c in bench.manifest["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["corpus"]["bytes"] == 10**8
        assert cfg["corpus"]["base"] in corpus.KINDS
