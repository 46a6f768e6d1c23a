"""Split decode on one device, a group of blocks at a time.

Counterpart of the one-device subset of
``libzling_tpu/parallel/decode_mesh.py::mesh_decode``, and of the split
layout of ``libzling_tpu/device.py::decode(fused=False)``, which is the
case of one group holding every block.  Per group of ``group_blocks``
whole blocks:

  [host]   pack only the group's payload words; put them and the group's
           code lengths on the device without blocking;
  [device] torch table build, then K1 decodes every chunk of the group to
           tokens (one CTA per chunk);
  [device] K2 resolves the group's tokens to bytes, starting from the
           previous group's exit MTF table, which stays on the device.

The host does not wait for the device inside the loop: statuses and bytes
are fetched and checked once at the end, group by group, as the JAX
function does.  Not ported, because they serve jit-shape stability or
belong to the lanes over several GPUs: the padding to ``Cp`` chunks and
uniform word and row counts, ``shard_map``, the cross-device gather and the
multi-process replication.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from . import container
from .ops import entropy_kernel as ek
from .ops import mtf as mops
from .ops import resolve_kernel as rk


class Stream(NamedTuple):
    """A stream's host parse: per-chunk fields and per-block sizes."""

    len1: np.ndarray          # [C, 514] code lengths
    len2: np.ndarray          # [C, 32]
    bodies: list              # per-chunk Huffman payload bytes
    rlens: np.ndarray         # [C] tokens
    encpos: np.ndarray        # [C] block bytes decoded at the chunk's end
    block_id: np.ndarray      # [C]
    new_block: np.ndarray     # [C] 1 where a chunk starts its block
    block_base: np.ndarray    # [B + 1] byte offset of each block, then size

    def chunks_of(self, b0: int, b1: int) -> tuple[int, int]:
        """The chunk range [c0, c1) of blocks [b0, b1)."""
        c0, c1 = np.searchsorted(self.block_id, [b0, b1])
        return int(c0), int(c1)

    def stage_split(self, c0: int, c1: int, device):
        """K1's and K2's inputs for one call over chunks [c0, c1), whose
        output starts at the first byte of chunk c0's block.

        Returns (the argument tuple of ``decode_chunks``, the arguments of
        ``resolve_stream`` after ``tokens`` and before ``mtf0``).
        """
        k1 = ek.stage_chunks(self.len1[c0:c1], self.len2[c0:c1],
                             self.bodies[c0:c1], self.rlens[c0:c1], device)
        first = self.block_base[self.block_id[c0]]
        base = self.block_base[self.block_id[c0:c1]] - first
        k2 = (k1[5],) + tuple(
            ek.host_to(np.asarray(a, dt), device)
            for a, dt in ((self.rlens[c0:c1], np.int32),
                          (self.encpos[c0:c1], np.int32),
                          (self.new_block[c0:c1], np.int32),
                          (base, np.int64)))
        size = int(self.block_base[self.block_id[c1 - 1] + 1] - first)
        return k1, k2 + (size,)


def parse(data: bytes) -> Stream | None:
    """Parse a stream on the host; None when it holds no chunk."""
    chunks, block_sizes = container.parse(data)
    if not chunks:
        return None
    len1, len2, bodies, rlens = container.unpack_length_tables(chunks)
    block_id = np.asarray([ch.block_id for ch in chunks], np.int64)
    new_block = np.r_[1, block_id[1:] != block_id[:-1]].astype(np.int32)
    return Stream(len1, len2, bodies, np.asarray(rlens, np.int64),
                  np.asarray([ch.encpos for ch in chunks], np.int64),
                  block_id, new_block,
                  np.cumsum([0] + list(block_sizes)).astype(np.int64))


def decode_groups(data: bytes, device="cuda", group_blocks: int | None = 1,
                  stage_probe: dict | None = None) -> bytes:
    """Decode a zling stream on ``device``, ``group_blocks`` blocks at a time
    (None: every block in one group); raises ValueError if it is corrupt.

    stage_probe: optional dict that receives the wall times ``entropy_s``
    (staging, table build and K1) and ``resolve_s`` (K2), summed over the
    groups, with the device synchronised after each stage -- a measurement
    mode that serialises the host and the device.
    """
    from .device import resolve_device

    dev = resolve_device(device)
    if group_blocks is not None and group_blocks < 1:
        raise ValueError("group_blocks must be >= 1")
    data = bytes(data)
    s = parse(data) if data else None
    if s is None:
        return b""
    pending = launch_groups(s, dev, group_blocks, mops.initial_table(dev),
                            stage_probe)
    parts = []
    for estatus, rstatus, out, rlens in pending:
        est = estatus.cpu().numpy()
        if est[:, 2].any() or (est[:, 0] != rlens).any():
            raise ValueError("zling: corrupt stream (huffman)")
        if rstatus.cpu().numpy()[:, 2].any():
            raise ValueError("zling: corrupt stream (resolve)")
        parts.append(out.cpu().numpy().tobytes())
    return b"".join(parts)


def launch_groups(s: Stream, dev: torch.device, group_blocks: int | None,
                  mtf0: torch.Tensor, stage_probe: dict | None = None):
    """Stage and launch K1 and K2 for every group of ``s``, the MTF table
    carried from one group's K2 to the next on the device.  Without
    ``stage_probe`` the host never waits for the device here.  Returns per
    group (K1 status, K2 status, bytes, token counts), not yet fetched."""
    n_blocks = len(s.block_base) - 1
    step = group_blocks or n_blocks
    mtf = mtf0

    def mark(key: str, t0: float) -> float:
        if stage_probe is None:
            return t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        stage_probe[key] = stage_probe.get(key, 0.0) + now - t0
        return now

    pending = []
    for b0 in range(0, n_blocks, step):
        c0, c1 = s.chunks_of(b0, min(b0 + step, n_blocks))
        if c0 == c1:
            continue                      # no chunks: empty blocks only
        t0 = time.perf_counter()
        k1, k2 = s.stage_split(c0, c1, dev)
        tokens, estatus = ek.decode_chunks(*k1)
        t0 = mark("entropy_s", t0)
        out, rstatus, mtf = rk.resolve_stream(tokens, *k2, mtf)
        mark("resolve_s", t0)
        pending.append((estatus, rstatus, out, s.rlens[c0:c1]))
    return pending
