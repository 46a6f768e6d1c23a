"""Command-line interface, mirroring the reference demo (demo/zling.cpp).

Counterpart of ``libzling_tpu/cli.py``:

    python -m libzling_tpu_torch e[0-6] [source [target]]   compress (e0)
    python -m libzling_tpu_torch d      [source [target]]   decompress

Defaults to stdin/stdout like the reference (demo/zling.cpp:176-192).
Like the reference demo's main loop (demo/zling.cpp:117-151), the default
path STREAMS: input goes through the lanes a group of blocks at a time
(``utils.io.stream_encode``/``stream_decode``) at O(group) memory, with
per-16 MB-block progress on stderr (DemoActionHandler analog), so a file
larger than RAM round-trips.  ``--backend`` picks ``cuda`` (the default,
or LIBZLING_TPU_TORCH_BACKEND: the lanes on every visible GPU), ``cpu``
(the lanes on the CPU, every kernel's plain version), ``pipeline`` (the
block-parallel host pipeline, streaming 64 MiB groups as the JAX
package's default does) or ``native`` (the port's native engine, one-shot
over the whole buffer).  ``cuda`` with no GPU is an error, never the CPU
or the host pipeline.  ``--checksum`` prints the adler32 of the
uncompressed payload, computed incrementally.
"""

from __future__ import annotations

import sys
import time
import zlib

from . import api
from .native import engine
from .parallel.mesh import make_mesh
from .utils.io import (
    CodecHooks,
    FileSink,
    FileSource,
    stream_decode,
    stream_encode,
)

_USAGE = """\
usage: python -m libzling_tpu_torch <command> [source [target]] [--backend B] [--checksum]
 commands:
  e, e0..e6   compress (level 0..4 match the reference; e5/e6 are deeper
              searches producing smaller, still reference-decodable streams)
  d           decompress
 backends: cuda (default: streaming through the lanes on every visible
           GPU), cpu (streaming, the kernels' plain versions), pipeline
           (streaming, the block-parallel host pipeline), native (the host
           engine; buffers the whole input)
"""


class _Adler32Source(FileSource):
    """FileSource that accumulates adler32 over everything read."""

    def __init__(self, f):
        super().__init__(f)
        self.adler = zlib.adler32(b"")

    def read(self, n: int) -> bytes:
        out = super().read(n)
        self.adler = zlib.adler32(out, self.adler)
        return out


class _Adler32Sink(FileSink):
    """FileSink that accumulates adler32 over everything written."""

    def __init__(self, f):
        super().__init__(f)
        self.adler = zlib.adler32(b"")

    def write(self, data: bytes) -> int:
        self.adler = zlib.adler32(data, self.adler)
        return super().write(data)


def _progress_hooks(verb: str) -> CodecHooks:
    """Per-block progress + final summary on stderr, like the reference
    demo's DemoActionHandler (demo/zling.cpp:74-113)."""

    def on_block(n_in: int, n_out: int) -> None:
        sys.stderr.write(f"\r{n_in} => {n_out}")
        sys.stderr.flush()

    def on_done(n_in: int, n_out: int, dt: float) -> None:
        mb = n_in / 1e6
        sys.stderr.write(
            f"\r{verb}: {n_in} => {n_out} bytes, "
            f"time={dt:.3f} sec, speed={mb / max(dt, 1e-9):.3f} MB/sec\n")

    return CodecHooks(on_block=on_block, on_done=on_done)


def _run_oneshot(cmd: str, src, dst, checksum: bool) -> None:
    """Whole-buffer path of the ``native`` backend."""
    data = src.read()
    t0 = time.time()
    if cmd == "d":
        out = engine.decode(data)
        verb = "decode"
    else:
        level = int(cmd[1]) if len(cmd) == 2 else 0
        out = engine.encode(data, level)
        verb = "encode"
    dt = time.time() - t0
    dst.write(out)
    mb = len(data) / 1e6
    sys.stderr.write(
        f"{verb}: {len(data)} => {len(out)} bytes, "
        f"time={dt:.3f} sec, speed={mb / max(dt, 1e-9):.3f} MB/sec\n")
    if checksum:
        # both directions hash the UNCOMPRESSED payload so an encode's
        # checksum can be compared with the matching decode's
        plain = data if verb == "encode" else out
        sys.stderr.write(f"adler32: {zlib.adler32(plain):#010x}\n")


def _run_streaming(cmd: str, src, dst, devices, checksum: bool,
                   route: str) -> None:
    """The lanes over ``devices`` (or the host pipeline, ``route``), a
    group of blocks at a time."""
    if cmd == "d":
        plain = _Adler32Sink(dst)
        stream_decode(FileSource(src), plain, devices,
                      _progress_hooks("decode"), route=route)
    else:
        level = int(cmd[1]) if len(cmd) == 2 else 0
        plain = _Adler32Source(src)
        stream_encode(plain, FileSink(dst), level, devices,
                      _progress_hooks("encode"), route=route)
    if checksum:
        sys.stderr.write(f"adler32: {plain.adler:#010x}\n")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    backend = None
    checksum = False
    if "--backend" in argv:
        i = argv.index("--backend")
        if i + 1 >= len(argv):
            sys.stderr.write(_USAGE)
            return 1
        backend = argv[i + 1]
        del argv[i:i + 2]
    if "--checksum" in argv:
        checksum = True
        argv.remove("--checksum")
    if not argv or argv[0] in ("-h", "--help"):
        sys.stderr.write(_USAGE)
        return 0 if argv else 1

    # validate the command and the backend BEFORE opening (and truncating)
    # any target file
    cmd = argv[0]
    is_enc = cmd == "e" or (len(cmd) == 2 and cmd[0] == "e"
                            and cmd[1] in "0123456")
    if not (is_enc or cmd == "d"):
        sys.stderr.write(_USAGE)
        return 1
    try:
        backend = api.effective_backend(backend)
        devices = None
        if backend == "cpu":
            devices = ["cpu"]
        elif backend == "cuda":
            devices = make_mesh()
    except (ValueError, RuntimeError) as e:
        sys.stderr.write(f"error: {e}\n")
        return 1
    src = open(argv[1], "rb") if len(argv) > 1 else sys.stdin.buffer
    dst = open(argv[2], "wb") if len(argv) > 2 else sys.stdout.buffer

    try:
        if api.streams_by_default(backend):
            _run_streaming(cmd, src, dst, devices, checksum,
                           "pipeline" if backend == "pipeline" else "lanes")
        else:
            _run_oneshot(cmd, src, dst, checksum)
        return 0
    except ValueError as e:
        sys.stderr.write(f"error: {e}\n")
        return 1
    finally:
        if src is not sys.stdin.buffer:
            src.close()
        if dst is not sys.stdout.buffer:
            dst.close()


if __name__ == "__main__":
    raise SystemExit(main())
