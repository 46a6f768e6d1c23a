"""Public API of the PyTorch/CUDA port.

Counterpart of ``libzling_tpu/api.py`` for its on-device backend: the
two-function surface of the reference (src/libzling.h:44-45) plus whole-
file helpers.  ``device`` defaults to ``"cuda"`` and raises when no GPU is
present; tests pass ``device="cpu"`` to run every kernel's plain version.
"""

from __future__ import annotations

from .device import decode, encode

__all__ = ["encode", "decode", "encode_file", "decode_file"]


def encode_file(src: str, dst: str, level: int = 0,
                device="cuda") -> tuple[int, int]:
    """Compress file ``src`` to ``dst``; returns (bytes_in, bytes_out).

    The device path reads the whole file into memory (it cannot stream).
    """
    with open(src, "rb") as fin:
        data = fin.read()
    out = encode(data, level, device)
    with open(dst, "wb") as fout:
        fout.write(out)
    return len(data), len(out)


def decode_file(src: str, dst: str, device="cuda") -> tuple[int, int]:
    """Decompress file ``src`` to ``dst``; returns (bytes_in, bytes_out)."""
    with open(src, "rb") as fin:
        data = fin.read()
    out = decode(data, device)
    with open(dst, "wb") as fout:
        fout.write(out)
    return len(data), len(out)
