"""Stream I/O, progress hooks, and the streamed encode and decode.

Counterpart of ``libzling_tpu/utils/io.py``, the reference's L1 layer
(src/libzling_utils.h:48-87): ``ByteSource``/``ByteSink`` mirror
Inputter/Outputter, ``CodecHooks`` mirrors ActionHandler (on_init /
on_block / on_done).  ``stream_encode`` and ``stream_decode`` run the
lanes (``parallel/``) a group of blocks at a time, so memory is O(group)
whatever the stream's size:

  encode: groups of ``len(devices) * blocks_per_device`` blocks go through
          ``mesh.encode_groups``, which carries the MTF state (on the
          device) and the level from group to group; group g+1 is read and
          launched before g's bytes are written, so at most two groups of
          input are held;
  decode: spans of at most ``group_blocks`` whole blocks (bounded by
          DECODED size) go through ``decode_mesh.decode_spans``, K1 then
          K2, which carries the MTF table on the device.

``devices`` go through ``mesh.make_mesh``: every visible GPU by default,
``["cpu"]`` for the plain versions.  ``route="pipeline"`` runs the same
loops through the block-parallel host pipeline (``pipeline.py``) instead,
as the JAX package's ``utils/io.py`` does: 64 MiB input groups through
``ParallelEncoder.encode_with_carry``, the same spans through
``ParallelDecoder.decode_with_carry``, the MTF state and level carried on
the host.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import BinaryIO, Callable

from .. import pipeline
from ..group_encode import GROUP_BLOCKS
from ..parallel.decode_mesh import decode_spans
from ..parallel.mesh import Lanes, encode_groups, make_mesh
from ..tables import BLOCK_SIZE_HUFFMAN, BLOCK_SIZE_IN, BLOCK_SIZE_ROLZ

DECODE_GROUP_BLOCKS = 4    # decode: max decoded blocks a span
_DEC_READ = 8 << 20        # decode: compressed read granularity
PIPELINE_GROUP = 4 * BLOCK_SIZE_IN   # the pipeline route's input groups


def check_route(route: str, devices=None, block_size: int = BLOCK_SIZE_IN,
                max_tokens: int = BLOCK_SIZE_ROLZ) -> None:
    """Raise ValueError unless ``route`` is ``"lanes"`` or ``"pipeline"``;
    the pipeline runs on the host at the canonical geometry, so it takes
    no ``devices`` and no other ``block_size`` or ``max_tokens``."""
    if route not in ("lanes", "pipeline"):
        raise ValueError(f"route {route!r}: 'lanes' or 'pipeline'")
    if route == "pipeline" and (
            devices is not None
            or (block_size, max_tokens) != (BLOCK_SIZE_IN, BLOCK_SIZE_ROLZ)):
        raise ValueError("the pipeline route runs on the host at the "
                         "canonical geometry: no devices, block_size or "
                         "max_tokens")


class ByteSource:
    """Abstract byte source (Inputter analog)."""

    def read(self, n: int) -> bytes:
        raise NotImplementedError

    def at_end(self) -> bool:
        raise NotImplementedError


class ByteSink:
    """Abstract byte sink (Outputter analog)."""

    def write(self, data: bytes) -> int:
        raise NotImplementedError


class FileSource(ByteSource):
    def __init__(self, f: BinaryIO):
        self._f = f
        self._peek: bytes = b""
        self.total_read = 0

    def read(self, n: int) -> bytes:
        out = self._peek[:n]
        self._peek = self._peek[n:]
        if len(out) < n:
            out += self._f.read(n - len(out))
        self.total_read += len(out)
        return out

    def at_end(self) -> bool:
        if self._peek:
            return False
        self._peek = self._f.read(1)
        return not self._peek


class FileSink(ByteSink):
    def __init__(self, f: BinaryIO):
        self._f = f
        self.total_written = 0

    def write(self, data: bytes) -> int:
        self._f.write(data)
        self.total_written += len(data)
        return len(data)


@dataclass
class CodecHooks:
    """Observability seam (ActionHandler analog, src/libzling_utils.h:64-87).

    on_block fires once per 16 MB input block, as the reference does
    (src/libzling.cpp:282,418), with (bytes_in_so_far, bytes_out_so_far).
    """

    on_init: Callable[[], None] | None = None
    on_block: Callable[[int, int], None] | None = None
    on_done: Callable[[int, int, float], None] | None = None


def _per_block_sizes(span: bytes) -> list[tuple[int, int]]:
    """(decoded_bytes, stream_bytes) of every complete input_block in span."""
    out = []
    pos, block_start, last_encpos = 0, 0, 0
    n = len(span)
    while pos < n:
        flag = span[pos]
        pos += 1
        if flag == 0:
            out.append((last_encpos, pos - block_start))
            block_start = pos
            last_encpos = 0
            continue
        last_encpos = int.from_bytes(span[pos:pos + 4], "big")
        olen = int.from_bytes(span[pos + 8:pos + 12], "big")
        pos += 12 + olen
    return out


def read_groups(src: ByteSource, size: int):
    """``src`` in pieces of ``size`` bytes (the last may be shorter), each
    read only when the consumer asks for it."""
    while not src.at_end():
        group = src.read(size)
        # a source may return less than asked before its end
        while len(group) < size and not src.at_end():
            group += src.read(size - len(group))
        if not group:
            break
        yield group


def stream_encode(src: ByteSource, dst: ByteSink, level: int = 0,
                  devices=None, hooks: CodecHooks | None = None, *,
                  block_size: int = BLOCK_SIZE_IN,
                  max_tokens: int = BLOCK_SIZE_ROLZ,
                  blocks_per_device: int = GROUP_BLOCKS,
                  route: str = "lanes") -> tuple[int, int]:
    """Group-bounded streaming encode through the lanes over ``devices``
    (or, ``route="pipeline"``, the host pipeline); the stream is canonical
    at the given geometry.  Returns (bytes_in, bytes_out)."""
    check_route(route, devices, block_size, max_tokens)
    if route == "lanes":
        lanes = Lanes(make_mesh(devices))
        size = lanes.count * blocks_per_device * block_size
    else:
        size = PIPELINE_GROUP
    t0 = time.time()
    if hooks and hooks.on_init:
        hooks.on_init()
    sizes = collections.deque()

    def groups():
        for group in read_groups(src, size):
            sizes.append(len(group))
            yield group

    if route == "lanes":
        parts = encode_groups(groups(), level, lanes, block_size,
                              max_tokens, blocks_per_device)
    else:
        parts = pipeline.encode_groups(groups(), level)
    n_in = n_out = 0
    for part, _carry in parts:
        dst.write(part)
        if hooks and hooks.on_block:
            # per-block granularity, as the reference ActionHandler
            bi, bo = n_in, n_out
            for dec_bytes, strm_bytes in _per_block_sizes(part):
                bi += dec_bytes
                bo += strm_bytes
                hooks.on_block(bi, bo)
        n_in += sizes.popleft()
        n_out += len(part)
    if hooks and hooks.on_done:
        hooks.on_done(n_in, n_out, time.time() - t0)
    return n_in, n_out


def _take_block_spans(buf: bytearray, at_end: bool,
                      max_blocks: int | None = None) -> bytes:
    """Pop complete input_block spans (through their stop flags) off buf.

    ``max_blocks`` caps how many complete blocks are taken per call: the
    decode direction must bound memory by DECODED size (a 64 MB compressed
    read of a highly-compressible stream can hold gigabytes of output), so
    the streaming loop pops small groups of blocks at a time.
    """
    pos = 0
    last_complete = 0
    n = len(buf)
    blocks = 0
    while pos < n:
        flag = buf[pos]
        pos += 1
        if flag == 0:
            last_complete = pos
            blocks += 1
            if max_blocks is not None and blocks >= max_blocks:
                break
            continue
        if flag != 1:
            raise ValueError("zling: corrupt stream (bad framing)")
        if pos + 12 > n:
            break
        olen = int.from_bytes(buf[pos + 8:pos + 12], "big")
        if olen > BLOCK_SIZE_HUFFMAN:
            raise ValueError("zling: corrupt stream (bad chunk header)")
        if pos + 12 + olen > n:
            break
        pos += 12 + olen
    if at_end and last_complete != n and pos >= n:
        raise ValueError("zling: truncated stream (missing stop flag)")
    out = bytes(buf[:last_complete])
    del buf[:last_complete]
    return out


def stream_decode(src: ByteSource, dst: ByteSink, devices=None,
                  hooks: CodecHooks | None = None, *,
                  group_blocks: int = DECODE_GROUP_BLOCKS,
                  route: str = "lanes") -> tuple[int, int]:
    """Group-bounded streaming decode through the lanes over ``devices``
    (or, ``route="pipeline"``, the host pipeline); raises ValueError on a
    corrupt or truncated stream.  Returns (bytes_in, bytes_out)."""
    if group_blocks < 1:
        raise ValueError("group_blocks must be >= 1")
    check_route(route, devices)
    lanes = Lanes(make_mesh(devices)) if route == "lanes" else None
    t0 = time.time()
    if hooks and hooks.on_init:
        hooks.on_init()
    n_in = 0
    taken = collections.deque()

    def spans():
        nonlocal n_in
        pending = bytearray()
        done = False
        while not done:
            chunk = src.read(_DEC_READ)
            n_in += len(chunk)
            pending.extend(chunk)
            done = src.at_end()
            while True:
                # at most group_blocks DECODED blocks a span, so memory
                # stays O(group) whatever the compression ratio
                span = _take_block_spans(pending, done, group_blocks)
                if not span:
                    break
                taken.append(span)
                yield span
        if pending:
            raise ValueError("zling: truncated stream (missing stop flag)")

    n_consumed = n_out = 0     # compressed bytes decoded, bytes written
    parts = decode_spans(spans(), lanes) if lanes else \
        pipeline.decode_spans(spans())
    for part, _table in parts:
        span = taken.popleft()
        dst.write(part)
        if hooks and hooks.on_block:
            bi, bo = n_consumed, n_out
            for dec_bytes, strm_bytes in _per_block_sizes(span):
                bi += strm_bytes
                bo += dec_bytes
                hooks.on_block(bi, bo)
        n_consumed += len(span)
        n_out += len(part)
    if hooks and hooks.on_done:
        hooks.on_done(n_in, n_out, time.time() - t0)
    return n_in, n_out
