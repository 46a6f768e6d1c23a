"""The plain reference: the JAX package's streams, its format quantities,
and the control that breaks the configurations' guarantees.  The spec
(``libzling_tpu.spec``) is the witness the reference is a transcription
of; the JAX package's pipeline, built on a native engine the program
shares, is a second one at the canonical geometry.

The tests may import the JAX package (on the CPU); the benchmark never
does (``test_bench_imports.py``).
"""

import os
import pathlib

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np     # noqa: E402
import pytest          # noqa: E402

from libzling_tpu import pipeline, spec   # noqa: E402

from benchmark.harness import corpus      # noqa: E402
from benchmark.reference import codec     # noqa: E402

TWO_BLOCKS = codec.BLOCK_BYTES + 400_000
REPO = pathlib.Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def small():
    return corpus.generate({"bytes": 48_000}, 2**33 + 1)


@pytest.fixture(scope="module")
def two_blocks():
    return corpus.generate({"bytes": TWO_BLOCKS}, 2**33 + 2)


@pytest.mark.parametrize("level", [0, 4])
def test_equals_spec_on_a_small_input(small, level):
    s = codec.encode(small, level)
    assert s == spec.encode(small, level)
    assert codec.decode(s) == small


@pytest.fixture(scope="module")
def with_noise():
    """Text with an incompressible run, so chunks drop to level 0."""
    text = corpus.generate({"bytes": 120_000}, 2**33 + 3)
    noise = np.random.default_rng(5).integers(0, 256, 50_000, np.uint8)
    return text[:30_000] + noise.tobytes() + text[30_000:]


@pytest.mark.parametrize("level", [0, 2, 4, 6])
def test_equals_spec_over_blocks_and_chunks(with_noise, level):
    """At a small geometry: several blocks (the MTF state carried), several
    chunks a block, and level drops, each against the spec."""
    s = codec.encode(with_noise, level, 40_000, 3_000)
    assert s == spec.encode(with_noise, level, block_size=40_000,
                            max_tokens=3_000)
    heads, ends = codec.chunks(s)
    assert len(ends) == 5 and len(heads) > 2 * len(ends)
    assert codec.decode(s) == with_noise


def test_shares_no_code_with_the_program():
    """The reference is its own transcription of the spec, not a copy of
    the program's native engine: few of its longer lines appear there."""
    ours = [ln.strip() for ln in
            (REPO / "benchmark/reference/zling.cpp").read_text().splitlines()
            if len(ln.strip()) >= 30]
    engine = {ln.strip() for ln in
              (REPO / "libzling_tpu_torch/native/engine.cpp").read_text()
              .splitlines()}
    shared = [ln for ln in ours if ln in engine]
    assert len(shared) < 0.1 * len(ours), shared


@pytest.mark.parametrize("level", [0, 4])
def test_equals_pipeline_over_two_blocks(two_blocks, level):
    s = codec.encode(two_blocks, level)
    assert s == pipeline.encode(two_blocks, level)
    assert codec.decode(s) == two_blocks


def test_token_counts_equal_a_serial_walk(small):
    s = codec.encode(small, 4)
    tokens = literals = 0
    heads, _ = codec.chunks(s)
    for c in heads:
        toks = spec.huffman_decode_chunk(s[c.start:c.start + c.olen], c.rlen)
        i = 0
        while i < len(toks):
            literals += toks[i] < 256
            i += 2 if toks[i] >= 258 else 1
        tokens += len(toks)
    assert codec.token_counts(s) == (tokens, literals)
    assert 0 < literals < tokens


def test_literal_count_reads_indices_past_258():
    # length 300, index 600 (>= 258), literal 5, length 258, index 4, word
    t = np.array([300, 600, 5, 258, 4, 256, 7], np.uint16)
    assert codec.literal_count(t) == 2
    # a run of values >= 258: length, index, length, index
    assert codec.literal_count(np.array([260, 270, 261, 3, 9], np.uint16)) == 1


@pytest.mark.parametrize("level", [0, 4])
def test_control_breaks_the_guarantees_past_the_first_block(two_blocks,
                                                            level):
    canon = codec.encode(two_blocks, level)
    apart = codec.encode_blocks_apart(two_blocks, level)
    first = codec.chunks(canon)[1][0]
    assert apart[:first] == canon[:first]        # block 0 alike
    assert apart != canon
    assert codec.decode_blocks_apart(apart) == two_blocks
    # the canonical stream's second block, decoded from a fresh MTF state,
    # comes out wrong or is found corrupt
    try:
        out = codec.decode_blocks_apart(canon)
    except ValueError:
        out = None
    assert out != two_blocks


def test_corrupt_stream_raises(small):
    s = bytearray(codec.encode(small, 0))
    s[0] = 7
    with pytest.raises(ValueError):
        codec.decode(bytes(s))
