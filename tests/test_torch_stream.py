"""The port's streamed encode and decode (``utils/io.py``), their group
loops (``parallel.mesh.encode_groups``, ``parallel.decode_mesh.
decode_spans``) and checkpoints (``utils/checkpoint.py``), on the CPU
(every kernel's plain version, one ``"cpu"`` lane or two):

- ``stream_encode`` over 1-3 groups of 1-2 blocks a device against
  ``spec.encode`` at the same small geometry;
- ``stream_decode`` against the input and ``libzling_tpu.utils.io.
  stream_decode``, with the ``on_block`` pairs;
- at the canonical geometry, the bytes, ``on_block`` pairs and exit carries
  against ``libzling_tpu.pipeline``'s carry API and ``libzling_tpu.utils.
  io.stream_encode``;
- the look-ahead's read bound, short groups, corrupt streams (the JAX
  package's messages), and resumed checkpoints (the JAX package's file);
- the host pipeline's route (``route="pipeline"``) against the JAX
  package's ``utils/io`` functions over a 64 MiB group edge, with its read
  bound, and resumable jobs stopped by the JAX package and resumed by the
  port, and the reverse.

Tolerance: exact equality -- streams, states and outputs are bytes.
"""

from __future__ import annotations

import functools
import io
import json

import numpy as np
import pytest
import torch

import libzling_tpu_torch as zt
from libzling_tpu import pipeline, spec
from libzling_tpu.utils import checkpoint as jcheckpoint
from libzling_tpu.utils import io as jio
from libzling_tpu_torch import api
from libzling_tpu_torch.ops import mtf as mops
from libzling_tpu_torch.parallel.decode_mesh import decode_spans
from libzling_tpu_torch.parallel.mesh import Lanes, encode_groups, make_mesh
from libzling_tpu_torch.utils import checkpoint
from libzling_tpu_torch.utils.io import (
    PIPELINE_GROUP,
    ByteSource,
    CodecHooks,
    FileSink,
    FileSource,
    _per_block_sizes,
    stream_decode,
    stream_encode,
)

GEOM = dict(block_size=3000, max_tokens=700)


def _data() -> bytes:
    # text, random bytes, then text: the level drops and recovers across
    # group edges (as tests/test_torch_mesh.py)
    rng = np.random.default_rng(9)
    return ((b"the quick brown fox jumps over the lazy dog. " * 120)
            + bytes(rng.integers(0, 256, 6000, dtype=np.uint8))
            + (b"abcdefgh" * 600))


@functools.lru_cache(maxsize=None)
def _spec(level: int, n: int) -> bytes:
    return spec.encode(_data()[:n], level, **GEOM)


def _blob(n: int = 100_000, seed: int = 4) -> bytes:
    """~100 KB of words with random bytes spliced in near its end."""
    rng = np.random.default_rng(seed)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon", b"\n"]
    text = b" ".join(words[i] for i in rng.integers(0, len(words), n // 5))
    return text[:n - 9000] + bytes(rng.integers(0, 256, 6000, np.uint8)) \
        + text[:3000]


def _encode(data: bytes, level: int, devices=("cpu",), **kw):
    out, events = io.BytesIO(), []
    hooks = CodecHooks(on_block=lambda i, o: events.append((i, o)))
    n = stream_encode(FileSource(io.BytesIO(data)), FileSink(out), level,
                      devices and list(devices), hooks, **kw)
    return out.getvalue(), events, n


def _decode(stream: bytes, devices=("cpu",), **kw):
    out, events = io.BytesIO(), []
    hooks = CodecHooks(on_block=lambda i, o: events.append((i, o)))
    n = stream_decode(FileSource(io.BytesIO(stream)), FileSink(out),
                      devices and list(devices), hooks, **kw)
    return out.getvalue(), events, n


@pytest.mark.parametrize("bpd", [1, 2])
@pytest.mark.parametrize("groups", [1, 2, 3])
@pytest.mark.parametrize("level", [0, 4, 6])
def test_stream_encode_equals_spec(level, groups, bpd):
    size = bpd * GEOM["block_size"]
    n = min(groups * size - 1000, len(_data()))   # the last ends mid-block
    got, events, (n_in, n_out) = _encode(_data()[:n], level,
                                         blocks_per_device=bpd, **GEOM)
    assert got == _spec(level, n)
    assert (n_in, n_out) == (n, len(got))
    assert len(events) == -(-n // GEOM["block_size"])
    assert events[-1] == (n, len(got))


def test_stream_encode_over_two_lanes():
    # two device entries: a group is 2 x 2 blocks, the state crosses the
    # entry edge inside each group
    n = len(_data())
    got, _, _ = _encode(_data(), 2, ("cpu", "cpu"), blocks_per_device=2,
                        **GEOM)
    assert got == _spec(2, n)


@pytest.mark.parametrize("gb", [1, 2, 4])
def test_stream_decode_equals_input_and_jax(gb):
    # one chunk a block: the JAX package's ParallelDecoder can deadlock on
    # a call of more chunks than its 4 token buffers, when a later chunk's
    # worker wins every freed buffer
    stream = spec.encode(_data(), 4, block_size=GEOM["block_size"])
    got, events, (n_in, n_out) = _decode(stream, group_blocks=gb)
    jout, jevents = io.BytesIO(), []
    jio.stream_decode(FileSource(io.BytesIO(stream)), jio.FileSink(jout),
                      hooks=jio.CodecHooks(on_block=lambda i, o:
                                           jevents.append((i, o))))
    assert got == jout.getvalue() == _data()
    assert events == jevents and len(events) == 6
    assert (n_in, n_out) == (len(stream), len(_data()))


@pytest.mark.parametrize("level", [0, 4])
def test_canonical_geometry_equals_the_pipeline_carry_api(level):
    blob = _blob()
    got, events, _ = _encode(blob, level)
    jout, jevents = io.BytesIO(), []
    jio.stream_encode(FileSource(io.BytesIO(blob)), jio.FileSink(jout),
                      level, hooks=jio.CodecHooks(
                          on_block=lambda i, o: jevents.append((i, o))))
    want, (wstate, wlevel) = pipeline.ParallelEncoder().encode_with_carry(
        blob, level, None)
    assert got == jout.getvalue() == want
    assert events == jevents == [(len(blob), len(want))]

    lanes = Lanes(make_mesh(["cpu"]))
    ((out, (state, lvl)),) = encode_groups([blob], level, lanes,
                                           1 << 24, 1 << 18, 8)
    assert out == want
    assert mops.state_to_bytes(state) == wstate and lvl == wlevel
    # the blob ends in text after noise: e4 leaves at the level asked
    assert lvl == level

    ((back, table),) = decode_spans([want], lanes)
    jback, jtable = pipeline.ParallelDecoder().decode_with_carry(want, None)
    assert back == jback == blob
    assert mops.table_to_bytes(table)[:65536] == jtable[:65536]


def test_carry_continues_a_stream():
    # a stream cut after its first group and continued from that group's
    # carry is the one-shot stream; the decode side likewise
    data, size = _data(), 2 * GEOM["block_size"]
    lanes = Lanes(make_mesh(["cpu"]))
    pieces = [data[i:i + size] for i in range(0, len(data), size)]
    first = list(encode_groups(pieces[:1], 4, lanes, **GEOM,
                               blocks_per_device=2))
    rest = list(encode_groups(pieces[1:], 4, lanes, **GEOM,
                              blocks_per_device=2, carry=first[0][1]))
    stream = b"".join(out for out, _ in first + rest)
    assert stream == _spec(4, len(data))
    spans = [stream[:len(first[0][0])], stream[len(first[0][0]):]]
    (a, t), = decode_spans(spans[:1], lanes)
    (b, _), = decode_spans(spans[1:], lanes, t)
    assert a + b == data


class _Recorder(ByteSource):
    """A source over bytes that records how much has been read."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def at_end(self) -> bool:
        return self.pos >= len(self.data)


def test_lookahead_reads_at_most_one_group_ahead():
    data, size = _data(), GEOM["block_size"]
    src, read_at_write = _Recorder(data), []

    class Sink(FileSink):
        def write(self, b: bytes) -> int:
            read_at_write.append(src.pos)
            return super().write(b)

    out = io.BytesIO()
    stream_encode(src, Sink(out), 0, ["cpu"], blocks_per_device=1, **GEOM)
    assert out.getvalue() == _spec(0, len(data))
    # when group g is written, groups 0..g+1 have been read and no more
    assert read_at_write == [min((g + 2) * size, len(data))
                             for g in range(len(read_at_write))]


def test_group_sizes_are_checked():
    lanes, size = Lanes(make_mesh(["cpu"])), GEOM["block_size"]
    data = _data()
    short = [data[:size - 1], data[size - 1:2 * size - 1]]
    with pytest.raises(ValueError, match="before the last"):
        list(encode_groups(short, 0, lanes, **GEOM, blocks_per_device=1))
    with pytest.raises(ValueError, match="at most"):
        list(encode_groups([data[:size + 1]], 0, lanes, **GEOM,
                           blocks_per_device=1))
    with pytest.raises(ValueError):
        list(encode_groups([data[:size]], 7, lanes, **GEOM,
                           blocks_per_device=1))
    assert list(encode_groups([], 0, lanes, **GEOM,
                              blocks_per_device=1)) == []
    assert _encode(b"", 0)[0] == b"" and _decode(b"")[0] == b""


def _corrupt() -> dict:
    stream = _spec(2, len(_data()))
    # block 0's stream bytes: the JAX package's stream_decode is fed no
    # span to decode, so its ParallelDecoder cannot deadlock (above)
    b0 = _per_block_sizes(stream)[0][1]
    big = bytearray(stream)
    big[9:13] = (1 << 30).to_bytes(4, "big")        # olen of chunk 0
    return {
        "truncated mid-chunk": stream[:b0 - 50],
        "no stop flag": stream[:b0 - 1],
        "flag byte": b"\x02" + stream[1:],
        "chunk header": bytes(big),
    }


@pytest.mark.parametrize("name", sorted(_corrupt()))
def test_corrupt_streams_raise_as_the_jax_package(name):
    bad = _corrupt()[name]
    with pytest.raises(ValueError) as want:
        jio.stream_decode(FileSource(io.BytesIO(bad)),
                          jio.FileSink(io.BytesIO()))
    with pytest.raises(ValueError) as got:
        _decode(bad, group_blocks=1)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cut", [1, 7])
def test_truncated_after_whole_blocks(cut):
    # blocks decode before the truncation shows; then the JAX message
    with pytest.raises(ValueError,
                       match=r"^zling: truncated stream \(missing stop"):
        _decode(_spec(2, len(_data()))[:-cut], group_blocks=2)


def _crash_after_first(monkeypatch, seen: list, module=checkpoint):
    orig = module._write_ckpt

    def crashing(path, kind, in_off, out_off, carry):
        orig(path, kind, in_off, out_off, carry)
        seen.append((path, kind, in_off, out_off, carry))
        if len(seen) == 1:
            raise KeyboardInterrupt

    monkeypatch.setattr(module, "_write_ckpt", crashing)
    return orig


def test_checkpoint_resumes_to_the_one_shot_stream(tmp_path, monkeypatch):
    data = _data()
    src, dst, back = (tmp_path / n for n in ("in.bin", "out.zlg", "back"))
    src.write_bytes(data)
    ckpt = tmp_path / "ck"
    geom = dict(GEOM, blocks_per_device=2)
    for kind, run in (
            ("encode", lambda: checkpoint.encode_file_resumable(
                str(src), str(dst), 4, str(ckpt), ["cpu"], **geom)),
            ("decode", lambda: checkpoint.decode_file_resumable(
                str(dst), str(back), str(ckpt), ["cpu"], group_blocks=1))):
        seen = []
        orig = _crash_after_first(monkeypatch, seen)
        with pytest.raises(KeyboardInterrupt):
            run()
        monkeypatch.setattr(checkpoint, "_write_ckpt", orig)
        assert ckpt.exists()
        # the file is the JAX package's, key for key and value for value
        want = tmp_path / "jax.ck"
        jcheckpoint._write_ckpt(want, *seen[0][1:])
        assert json.loads(ckpt.read_text()) == json.loads(want.read_text())
        assert len(json.loads(ckpt.read_text())) == (5 if kind == "encode"
                                                     else 4)
        run()
        assert not ckpt.exists()
    assert dst.read_bytes() == _spec(4, len(data))
    assert back.read_bytes() == data


def test_checkpoint_carry_bytes():
    # the encode carry is K5's state as the native MtfState; the decode
    # carry is K2's table, then its inverse
    state = mops.initial_state("cpu")
    assert mops.state_to_bytes(state) == pipeline.ParallelEncoder() \
        .mtf_state_bytes(reset=True)
    assert mops.table_to_bytes(state[0]) == mops.state_to_bytes(state)
    assert torch.equal(mops.state_from_bytes(mops.state_to_bytes(state)),
                       state)
    with pytest.raises(ValueError):
        mops.state_from_bytes(b"\0" * 10)


def test_file_helpers_stream(tmp_path, monkeypatch):
    blob = _blob(30_000)
    src, dst, back = (tmp_path / n for n in ("in", "out", "back"))
    src.write_bytes(blob)
    assert zt.encode_file(str(src), str(dst), 2, device="cpu") == (
        len(blob), dst.stat().st_size)
    assert dst.read_bytes() == zt.encode(blob, 2, device="cpu")
    zt.decode_file(str(dst), str(back), device="cpu")
    assert back.read_bytes() == blob
    if not torch.cuda.is_available():
        # no GPU: an error before any target is opened, never the CPU
        with pytest.raises(RuntimeError):
            zt.encode_file(str(src), str(tmp_path / "never"))
        assert not (tmp_path / "never").exists()
    monkeypatch.delenv("LIBZLING_TPU_TORCH_BACKEND", raising=False)
    assert api.effective_backend(None) == "cuda"
    assert api.streams_by_default("cpu") and \
        not api.streams_by_default("native")
    monkeypatch.setenv("LIBZLING_TPU_TORCH_BACKEND", "native")
    assert api.effective_backend(None) == "native"
    assert api.effective_backend("cpu") == "cpu"
    with pytest.raises(ValueError):
        api.effective_backend("tpu")


@functools.lru_cache(maxsize=None)
def _past_a_group() -> bytes:
    # 1 MiB past the pipeline route's first 64 MiB group: 64 KiB of random
    # bytes over and over, so each 16 MiB block is one chunk (the JAX
    # decoder, fed spans of at most 4 blocks, then never holds more chunks
    # than its 4 token buffers) and the MTF state crosses every edge
    unit = np.random.default_rng(5).integers(0, 256, 1 << 16, np.uint8)
    return (unit.tobytes() * 1040)[:PIPELINE_GROUP + (1 << 20)]


@functools.lru_cache(maxsize=None)
def _past_a_group_stream() -> bytes:
    return pipeline.ParallelEncoder().encode(_past_a_group(), 0)


def test_pipeline_route_equals_the_jax_stream_functions():
    data = _past_a_group()
    src, read_at_write = _Recorder(data), []

    class Sink(FileSink):
        def write(self, b: bytes) -> int:
            read_at_write.append(src.pos)
            return super().write(b)

    out, events = io.BytesIO(), []
    n = stream_encode(src, Sink(out), 0, hooks=CodecHooks(
        on_block=lambda i, o: events.append((i, o))), route="pipeline")
    jout, jevents = io.BytesIO(), []
    jio.stream_encode(FileSource(io.BytesIO(data)), jio.FileSink(jout), 0,
                      hooks=jio.CodecHooks(on_block=lambda i, o:
                                           jevents.append((i, o))))
    assert out.getvalue() == jout.getvalue() == _past_a_group_stream()
    assert events == jevents and len(events) == 5
    assert n == (len(data), len(out.getvalue()))
    # a group is read, encoded and written before the next is read
    assert read_at_write == [PIPELINE_GROUP, len(data)]

    got, events, n = _decode(out.getvalue(), None, route="pipeline")
    back, jevents = io.BytesIO(), []
    jio.stream_decode(FileSource(io.BytesIO(out.getvalue())),
                      jio.FileSink(back), hooks=jio.CodecHooks(
                          on_block=lambda i, o: jevents.append((i, o))))
    assert got == back.getvalue() == data
    assert events == jevents and len(events) == 5


def test_the_routes_are_checked():
    for kw in (dict(route="mesh"), dict(route="pipeline", block_size=4096),
               dict(route="pipeline", max_tokens=700)):
        with pytest.raises(ValueError, match="route"):
            _encode(b"abc", 0, None, **kw)
    with pytest.raises(ValueError, match="route"):
        _decode(b"", ["cpu"], route="pipeline")
    assert _encode(b"", 0, None, route="pipeline")[0] == b""
    assert _decode(b"", None, route="pipeline")[0] == b""


@pytest.mark.parametrize("first", ["jax", "port"])
def test_resumable_job_crosses_the_packages(tmp_path, monkeypatch, first):
    # stopped after its first checkpoint by one package (64 MiB of input,
    # 4 blocks of the stream), resumed by the other, both directions
    data, stream = _past_a_group(), _past_a_group_stream()
    src, dst, back = (tmp_path / n for n in ("in", "out", "back"))
    src.write_bytes(data)
    ckpt = str(tmp_path / "ck")
    jobs = {
        "jax": (jcheckpoint, lambda: jcheckpoint.encode_file_resumable(
            str(src), str(dst), 0, ckpt),
                lambda: jcheckpoint.decode_file_resumable(
                    str(dst), str(back), ckpt)),
        "port": (checkpoint, lambda: checkpoint.encode_file_resumable(
            str(src), str(dst), 0, ckpt, route="pipeline"),
                 lambda: checkpoint.decode_file_resumable(
                     str(dst), str(back), ckpt, route="pipeline")),
    }
    then = "port" if first == "jax" else "jax"
    for k in (1, 2):                        # encode, then decode
        seen = []
        module = jobs[first][0]
        orig = _crash_after_first(monkeypatch, seen, module)
        with pytest.raises(KeyboardInterrupt):
            jobs[first][k]()
        monkeypatch.setattr(module, "_write_ckpt", orig)
        assert seen[0][2] == (PIPELINE_GROUP if k == 1 else 4)
        jobs[then][k]()
    assert dst.read_bytes() == stream
    assert back.read_bytes() == data
