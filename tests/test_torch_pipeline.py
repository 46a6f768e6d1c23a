"""The port's block-parallel host pipeline (``libzling_tpu_torch.pipeline``)
against the JAX package's (``libzling_tpu.pipeline``): streams at e0-e6 on
the small cases and mixed blobs, across a 16 MiB block edge, through
schedule mispredicts (with equal ``enc.schedule_mispredicts`` and
``enc.level_drops`` deltas) and through a carry split at a block edge
(equal carries); the match-loop counters of the counting engine build;
every corrupt-stream class with the JAX messages and no buffer lost;
four threads at once; and the bound on the blocks (encoder) and chunks
(decoder) in flight, which makes the JAX pipeline's deadlock (ROADMAP,
Queue 3) impossible: block 0's tokenize job, and chunk 0's entropy job,
waits for every other job submitted, under a time limit.

Tolerance: exact equality -- streams, MTF states, levels and counters are
bytes and integers.
"""

from __future__ import annotations

import functools
import hashlib
import json
import pathlib
import random
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from libzling_tpu import pipeline as jpipeline
from libzling_tpu import spec
from libzling_tpu.native import engine as jengine
from libzling_tpu.utils import metrics as jmetrics
from libzling_tpu_torch import pipeline
from libzling_tpu_torch.native import engine
from libzling_tpu_torch.tables import BLOCK_SIZE_IN
from libzling_tpu_torch.utils import metrics

from .test_spec_vs_reference import CASES, _mixed_blob

LEVELS = range(7)
TIMEOUT_S = 60
REPO = pathlib.Path(__file__).resolve().parent.parent


@functools.lru_cache(maxsize=None)
def _alternating() -> bytes:
    # the JAX test_adaptive_level_mispredict's input: compressible and
    # random 300 KB spans in turn, so the level drops and recovers
    rng = random.Random(13)
    parts = []
    for i in range(6):
        if i % 2:
            parts.append(bytes(rng.randrange(256) for _ in range(300000)))
        else:
            parts.append(_mixed_blob(300000, seed=i))
    return b"".join(parts)


@functools.lru_cache(maxsize=None)
def _long_noise() -> bytes:
    # 700 KB of random bytes between text: a chunk of random bytes alone
    # drops the level, so the chunk after it was predicted wrongly
    noise = np.random.default_rng(2).integers(0, 256, 700000, np.uint8)
    return _mixed_blob(200000, seed=1) + noise.tobytes() \
        + _mixed_blob(200000, seed=2)


@functools.lru_cache(maxsize=None)
def _past_block_edge() -> bytes:
    # 4 KiB past the first 16 MiB block; block 0 ends in 300 KB of random
    # bytes, so at a level above 0 the level it leaves is 0
    text = _mixed_blob(1 << 20, seed=8) * 16
    noise = np.random.default_rng(3).integers(0, 256, 300000, np.uint8)
    return text[:BLOCK_SIZE_IN - len(noise)] + noise.tobytes() \
        + text[:4096]


def _deltas(fn):
    """fn()'s result and the change it made to each registry's level
    drop and mispredict counters (port, JAX)."""
    names = ("enc.level_drops", "enc.schedule_mispredicts")
    before = [{k: r.snapshot()["counters"].get(k, 0) for k in names}
              for r in (metrics.registry, jmetrics.registry)]
    out = fn()
    after = [{k: r.snapshot()["counters"].get(k, 0) for k in names}
             for r in (metrics.registry, jmetrics.registry)]
    return out, [{k: a[k] - b[k] for k in names}
                 for a, b in zip(after, before)]


@pytest.mark.parametrize("level", LEVELS)
def test_encode_equals_the_jax_pipeline(level):
    for data in CASES + [_mixed_blob(150000, seed=level + 30)]:
        got = pipeline.encode(data, level)
        assert got == jpipeline.encode(data, level), (level, data[:20])
        assert pipeline.decode(got) == data
    with pytest.raises(ValueError, match="level must be 0..6"):
        pipeline.encode(b"abc", 7)


def test_past_a_block_edge():
    data = _past_block_edge()
    got = pipeline.encode(data, 0)
    assert got == jpipeline.encode(data, 0) == engine.encode(data, 0)
    assert pipeline.decode(got) == data


@pytest.mark.parametrize("name,level,drops,mispredicts", [
    ("alternating", 0, 0, 0), ("alternating", 3, 1, 0),
    ("long noise", 0, 0, 0), ("long noise", 3, 2, 1)])
def test_mispredicts_equal_the_jax_pipeline(name, level, drops,
                                            mispredicts):
    # e0 cannot drop.  At e3 the alternating spans drop the level in the
    # last chunk only; the long noise drops it mid-block, the chunk after
    # is tokenized again, and its drop is counted again on that pass, as
    # the JAX package counts it
    data = {"alternating": _alternating, "long noise": _long_noise}[name]()
    enc, jenc = pipeline.ParallelEncoder(), jpipeline.ParallelEncoder()
    try:
        got, (mine, _) = _deltas(lambda: enc.encode(data, level))
        want, (_, theirs) = _deltas(lambda: jenc.encode(data, level))
    finally:
        enc.close()
    assert got == want
    assert mine == theirs == {"enc.level_drops": drops,
                              "enc.schedule_mispredicts": mispredicts}
    assert pipeline.decode(got) == data


def test_carry_split_at_a_block_edge():
    # e1: block 0 leaves level 0 (its random tail), so the carried level
    # matters; both halves and both carries equal the JAX package's
    data, level = _past_block_edge(), 1
    enc, jenc = pipeline.ParallelEncoder(), jpipeline.ParallelEncoder()
    dec = pipeline.ParallelDecoder()
    try:
        first, carry = enc.encode_with_carry(data[:BLOCK_SIZE_IN], level,
                                             None)
        assert (first, carry) == jenc.encode_with_carry(
            data[:BLOCK_SIZE_IN], level, None)
        assert carry[1] == 0
        rest, carry2 = enc.encode_with_carry(data[BLOCK_SIZE_IN:], level,
                                             carry)
        assert (rest, carry2) == jenc.encode_with_carry(
            data[BLOCK_SIZE_IN:], level, carry)
        assert first + rest == enc.encode(data, level)
        # the decode carry's table (its first half; the decoder keeps no
        # inverse) is the encoder's.  The JAX decoder is not run on these
        # many-chunk blocks: it can deadlock on more than 4 chunks a call
        a, state = dec.decode_with_carry(first, None)
        assert state[:65536] == carry[0][:65536]
        b, state2 = dec.decode_with_carry(rest, state)
        assert state2[:65536] == carry2[0][:65536]
        assert a + b == data
        # an empty call keeps the carry it was given
        assert enc.encode_with_carry(b"", level, carry2) == (b"", carry2)
        assert dec.decode_with_carry(b"", state2) == (b"", state2)
    finally:
        enc.close()
        dec.close()


def test_counters_equal_the_jax_pipeline(monkeypatch):
    # both engines built with the match-loop counters (ZLT_COUNTERS=1, the
    # JAX package's switch), loaded afresh for this test
    monkeypatch.setenv("ZLT_COUNTERS", "1")
    monkeypatch.setattr(engine, "_LIBS", {})
    for name in ("_LIB", "_ENC_HANDLE", "_DEC_HANDLE"):
        monkeypatch.setattr(jengine, name, None)
    data = _long_noise()
    enc, jenc = pipeline.ParallelEncoder(), jpipeline.ParallelEncoder()
    try:
        assert enc.encode(data, 3) == jenc.encode(data, 3)
        got = enc.counters()
        assert got == jenc.counters()
        assert list(got) == list(pipeline.COUNTER_NAMES)
        assert got["chain_steps"] > 0 and got["lazy_skips"] > 0
    finally:
        enc.close()


def _corrupt() -> dict:
    stream = jpipeline.encode(_mixed_blob(30000, seed=5), 2)
    big = bytearray(stream)
    big[9:13] = (1 << 30).to_bytes(4, "big")          # olen of chunk 0
    out = {"bad framing": b"\x02" + stream[1:],
           "missing stop flag": stream[:-1],
           "bad chunk header": bytes(big)}
    # a flipped payload byte: the first that fails the entropy decode, the
    # first that passes it and fails the resolve
    dec = jpipeline.ParallelDecoder()
    for pos in range(20, len(stream) - 1):
        bad = bytearray(stream)
        bad[pos] ^= 0x10
        try:
            dec.decode(bytes(bad))
        except ValueError as e:
            kind = str(e)
            if "(entropy)" in kind and "entropy" not in out:
                out["entropy"] = bytes(bad)
            elif "(resolve)" in kind and "resolve" not in out:
                out["resolve"] = bytes(bad)
        if "entropy" in out and "resolve" in out:
            break
    return out


@pytest.mark.parametrize("name", ["bad framing", "missing stop flag",
                                  "bad chunk header", "entropy", "resolve"])
def test_corrupt_streams_raise_the_jax_messages(name):
    bad = _corrupt()[name]
    with pytest.raises(ValueError) as want:
        jpipeline.ParallelDecoder().decode(bad)
    dec = pipeline.ParallelDecoder()
    try:
        with pytest.raises(ValueError) as got:
            dec.decode(bad)
        assert str(got.value) == str(want.value)
        # every token buffer is back, and the next call decodes
        assert len(dec.tok_free) == dec.workers + 2
        good = _mixed_blob(20000, seed=6)
        assert dec.decode(pipeline.encode(good, 1)) == good
    finally:
        dec.close()


def test_four_threads_at_once():
    blobs = [_mixed_blob(60000, seed=40 + i) for i in range(4)]
    want = [jpipeline.encode(b, i) for i, b in enumerate(blobs)]
    got, errors = {}, []

    def run(i):
        try:
            for _ in range(3):
                s = pipeline.encode(blobs[i], i)
                got[i] = (s, pipeline.decode(s))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert [got[i] for i in range(4)] == list(zip(want, blobs))


def test_decoder_bounds_its_chunks_in_flight(tmp_path):
    # at small geometry a stream of many chunks (decode needs no geometry);
    # chunk 0's entropy job waits until every other job submitted so far
    # has finished (tests/_torch_pipeline_worker.py, a process with a time
    # limit).  A decoder that hands buffers out inside the jobs and
    # submits every chunk at once would deadlock here: the later chunks
    # hold every buffer while the resolve waits for chunk 0
    rng = np.random.default_rng(8)
    data = b"bounded in flight " * 200 + bytes(rng.integers(0, 256, 6000,
                                                             np.uint8))
    stream = spec.encode(data, 2, block_size=3000, max_tokens=700)
    (tmp_path / "s").write_bytes(stream)
    try:
        r = subprocess.run(
            [sys.executable, str(REPO / "tests" / "_torch_pipeline_worker.py"),
             str(tmp_path / "s")], capture_output=True, text=True,
            timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the decode did not end within {TIMEOUT_S} s: deadlock")
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.splitlines()[-1])
    assert got["sha256"] == hashlib.sha256(data).hexdigest()
    assert not got["timed_out"] and got["submitted"] >= 8
    # chunk 0 waited for the other chunks in flight: workers + 1
    assert got["waited_for"] == got["workers"] + 1


def test_encoder_bounds_its_blocks_in_flight():
    # six 16 MiB blocks and 4 KiB (64 KiB of random bytes over and over:
    # quick to tokenize); block 0's tokenize job waits until the
    # submissions have stopped for 50 ms and every other job submitted
    # has finished.  An
    # encoder whose jobs took their buffers from a shared queue, all
    # blocks submitted at once, would deadlock here: blocks 1-4 hold every
    # buffer, block 5 waits for one, and the serial pass for block 0.  The
    # pool's threads are daemons: a deadlock fails the join, not the exit
    unit = np.random.default_rng(12).integers(0, 256, 1 << 16, np.uint8)
    data = (unit.tobytes() * (6 * 256 + 1))[:6 * BLOCK_SIZE_IN + 4096]
    base = np.frombuffer(data, np.uint8).ctypes.data
    enc = pipeline.ParallelEncoder()
    submitted, seen = [], {"timed out": False}
    plain_submit, plain_job = enc.pool.submit, enc._tokenize_block

    def submit(prio, fn, *args):
        fut = plain_submit(prio, fn, *args)
        if fn is job:
            submitted.append(fut)
        return fut

    def job(view, ilen, levels, tokens):
        if view.ctypes.data == base:
            deadline = time.monotonic() + TIMEOUT_S - 10
            n, since = -1, time.monotonic()
            while True:
                if len(submitted) != n:
                    n, since = len(submitted), time.monotonic()
                elif time.monotonic() - since > 0.05 and \
                        all(f.done() for f in submitted[1:n]):
                    break
                if time.monotonic() > deadline:
                    seen["timed out"] = True
                    break
                time.sleep(0.001)
            seen["waited for"] = n - 1
        return plain_job(view, ilen, levels, tokens)

    enc.pool.submit, enc._tokenize_block = submit, job
    result = {}
    t = threading.Thread(target=lambda: result.update(
        out=enc.encode(data, 0)), daemon=True)
    t.start()
    t.join(TIMEOUT_S)
    assert not t.is_alive(), "the encode did not end: deadlock"
    try:
        assert result["out"] == engine.encode(data, 0)
        assert not seen["timed out"] and len(submitted) == 7
        assert seen["waited for"] == enc.workers + 1
        assert len(enc.tok.free) == enc.workers + 2
    finally:
        enc.close()
