"""The port's main path: encode and decode on one device.

Counterpart of ``libzling_tpu/device.py`` (``encode``, ``decode``).

  encode: ``group_encode.encode_groups`` -- K4 tokenize, K5 relabel, torch
      Huffman stages, host length tables and framing -- at the canonical
      16 MiB / 262,144-token geometry by default;
  decode: host parse (``container.parse``, ``unpack_length_tables``), then
      the fused kernel K3 writes every block's bytes at its offset in one
      u8 tensor; the per-chunk status turns into ``ValueError`` on a
      corrupt stream.
"""

from __future__ import annotations

import numpy as np
import torch

from libzling_tpu import container
from libzling_tpu.tables import BLOCK_SIZE_IN, BLOCK_SIZE_ROLZ
from .group_encode import encode_groups
from .ops import decode_fused as fk


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("libzling_tpu_torch: no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"libzling_tpu_torch: unsupported device {dev}")
    return dev


def encode(data: bytes, level: int = 0, device="cuda",
           block_size: int = BLOCK_SIZE_IN,
           max_tokens: int = BLOCK_SIZE_ROLZ) -> bytes:
    """Encode on ``device``; byte-identical to ``spec.encode`` at the same
    geometry (the canonical stream by default)."""
    return encode_groups(bytes(data), level, resolve_device(device),
                         block_size=block_size, max_tokens=max_tokens)


def decode_args(data: bytes, device):
    """Parse a non-empty stream on the host and stage K3's inputs.

    Returns (the argument tuple of ``fused_decode`` without ``out_size``,
    the decoded size, the per-chunk token counts), or None for a stream
    without chunks.
    """
    chunks, block_sizes = container.parse(data)
    if not chunks:
        return None
    len1, len2, bodies, rlens = container.unpack_length_tables(chunks)
    block_base = np.cumsum([0] + block_sizes[:-1])
    block_id = np.asarray([ch.block_id for ch in chunks])
    new_block = np.r_[1, block_id[1:] != block_id[:-1]].astype(np.int32)
    args = fk.prepare_fused(len1, len2, bodies, rlens,
                            [ch.encpos for ch in chunks], new_block,
                            block_base[block_id], device)
    return args, int(sum(block_sizes)), rlens


def decode(data: bytes, device="cuda") -> bytes:
    """Decode a zling stream on ``device``; raises ValueError if corrupt."""
    dev = resolve_device(device)
    data = bytes(data)
    staged = decode_args(data, dev) if data else None
    if staged is None:
        return b""
    args, size, rlens = staged
    out, status = fk.fused_decode(*args, out_size=size)
    st = status.cpu().numpy()
    if st[:, 2].any() or (st[:, 1] != rlens).any():
        raise ValueError("zling: corrupt stream")
    return out.cpu().numpy().tobytes()
