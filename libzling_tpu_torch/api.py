"""Public API of the PyTorch/CUDA port.

Counterpart of ``libzling_tpu/api.py`` for its on-device backend: the
two-function surface of the reference (src/libzling.h:44-45) plus file
helpers that stream (``utils/io.py``).  ``device`` defaults to ``"cuda"``
and raises when no GPU is present; tests pass ``device="cpu"`` to run
every kernel's plain version.

``encode(data, level, device="cuda")`` runs the lanes on every visible
card (``device.encode_devices``; ``"cuda:N"`` names one card);
``decode`` runs on one card, K3 being one serial walk a stream; the file
helpers run on the one ``device`` they are given.
"""

from __future__ import annotations

import os

from .device import decode, encode
from .parallel.mesh import make_mesh
from .utils.io import FileSink, FileSource, stream_decode, stream_encode

__all__ = ["encode", "decode", "encode_file", "decode_file"]

# the CLI's backends: the lanes on every visible GPU, the lanes on the CPU
# (every kernel's plain version), the port's native engine (one-shot), and
# the block-parallel host pipeline over that engine (``pipeline.py``)
BACKENDS = ("cuda", "cpu", "native", "pipeline")
# backends with a group carry stream at O(group) memory (utils/io.py)
_STREAMING = ("cuda", "cpu", "pipeline")


def effective_backend(backend: str | None) -> str:
    """The backend a caller gets: ``backend``, or for None (the default)
    the LIBZLING_TPU_TORCH_BACKEND override, else ``"cuda"``."""
    if backend is None:
        backend = os.environ.get("LIBZLING_TPU_TORCH_BACKEND", "") or "cuda"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} unavailable; have "
                         f"{sorted(BACKENDS)}")
    return backend


def streams_by_default(backend: str | None) -> bool:
    """True when this backend streams through the lanes a group at a time
    (O(group) memory) rather than buffering the whole input."""
    return effective_backend(backend) in _STREAMING


def encode_file(src: str, dst: str, level: int = 0,
                device="cuda") -> tuple[int, int]:
    """Compress file ``src`` to ``dst`` through the lanes on ``device``, a
    group of blocks at a time (O(group) memory, like the reference demo's
    16 MB-block loop, demo/zling.cpp:117-151); returns (bytes_in,
    bytes_out)."""
    devices = make_mesh([device])
    with open(src, "rb") as fin, open(dst, "wb") as fout:
        return stream_encode(FileSource(fin), FileSink(fout), level, devices)


def decode_file(src: str, dst: str, device="cuda") -> tuple[int, int]:
    """Decompress file ``src`` to ``dst`` through the lanes on ``device``,
    a few blocks at a time; returns (bytes_in, bytes_out)."""
    devices = make_mesh([device])
    with open(src, "rb") as fin, open(dst, "wb") as fout:
        return stream_decode(FileSource(fin), FileSink(fout), devices)
