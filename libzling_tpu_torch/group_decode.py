"""Split decode, a group of blocks at a time: the stream's host parse.

Counterpart of the host side of
``libzling_tpu/parallel/decode_mesh.py::mesh_decode`` and of the split
layout of ``libzling_tpu/device.py::decode(fused=False)``, which is the
case of one group holding every block.  ``parse`` reads a stream's chunk
fields on the host; ``Stream.stage_split`` and ``Stream.resolve_args``
stage K1's and K2's inputs for a chunk range on a device without
blocking.  The group loop itself is ``parallel/decode_mesh.py``'s:
``decode_groups`` is its one-device case --

  [host]   pack only the group's payload words; put them and the group's
           code lengths on the device without blocking;
  [device] torch table build, then K1 decodes every chunk of the group to
           tokens;
  [device] K2 resolves the group's tokens to bytes, starting from the
           previous group's exit MTF table, which stays on the device;

and the host fetches and checks statuses and bytes once at the end.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import container
from .ops import entropy_kernel as ek
from .utils import metrics


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
        return (ek.stage_chunks(self.len1[c0:c1], self.len2[c0:c1],
                                self.bodies[c0:c1], self.rlens[c0:c1],
                                device),
                self.resolve_args(c0, c1, device))

    def resolve_args(self, c0: int, c1: int, device):
        """The arguments of ``resolve_stream`` after ``tokens`` and before
        ``mtf0`` for chunks [c0, c1), whose tokens lie flat in chunk order
        (however many K1 calls decoded them)."""
        rl = self.rlens[c0:c1]
        first = self.block_base[self.block_id[c0]]
        base = self.block_base[self.block_id[c0:c1]] - first
        size = int(self.block_base[self.block_id[c1 - 1] + 1] - first)
        return tuple(
            ek.host_to(np.asarray(a, dt), device)
            for a, dt in ((np.cumsum(rl) - rl, np.int64),
                          (rl, np.int32),
                          (self.encpos[c0:c1], np.int32),
                          (self.new_block[c0:c1], np.int32),
                          (base, np.int64))) + (size,)


def parse(data: bytes) -> Stream | None:
    """Parse a stream on the host; None when it holds no chunk."""
    with metrics.stage("dec.parse"):
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


def decode_groups(data: bytes, device="cuda", group_blocks: int | None = 1
                  ) -> bytes:
    """Decode a zling stream on ``device``, ``group_blocks`` blocks at a time
    (None: every block in one group); raises ValueError if it is corrupt.

    The one-device case of ``parallel/decode_mesh.py::mesh_decode``.
    """
    from .parallel.decode_mesh import mesh_decode

    return mesh_decode(data, [device], group_blocks)
