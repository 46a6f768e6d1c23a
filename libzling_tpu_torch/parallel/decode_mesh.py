"""Decode over several devices: the entropy decode sharded by chunk, the
serial resolve on one.

Counterpart of ``libzling_tpu/parallel/decode_mesh.py::mesh_decode``.
Every chunk carries its own Huffman tables, so the entropy decode is
parallel over chunks; the resolve is serial over the stream (its contexts
are decoded bytes, the MTF table crosses blocks).  Per group of
``group_blocks`` whole blocks:

  [each device] the group's chunks split in contiguous runs, one a device
                (decode_mesh.py:124-125); each device stages its run's
                payload words and tables without blocking and K1 decodes
                them to tokens;
  [device 0]    the runs' tokens go ``.to(devices[0])`` in chunk order,
                and K2 resolves the group from the previous group's exit
                MTF table, which stays on the device.

The host does not wait for the devices inside the loop: statuses and bytes
are fetched and checked once at the end, and a corrupt stream raises
``ValueError`` (decode_mesh.py:241-262).  ``decode_spans`` runs the same
launches a span of whole blocks at a time as spans arrive (from a file,
``utils/io.py``), each span's exit MTF table carried to the next.  Not
ported, because they are TPU layout: the chunk-pair padding and the
uniform ``Cp`` / ``W`` geometry.
``distributed.distributed_decode`` runs this loop with one device a
process, the tokens all-gathered and K2 replicated on every process.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import torch

from .. import group_decode as gd
from ..ops import entropy_kernel as ek
from ..ops import mtf as mops
from ..ops import resolve_kernel as rk
from ..utils import metrics
from .mesh import Lanes, make_mesh


def mesh_decode(data: bytes, devices=None, group_blocks: int | None = 1,
                stage_probe: dict | None = None) -> bytes:
    """Decode a zling stream with its entropy decode sharded over
    ``devices`` (``mesh.make_mesh``), ``group_blocks`` blocks a group
    (None: one group); raises ValueError if it is corrupt.

    stage_probe: optional dict that receives the wall times ``entropy_s``
    (staging, table build and K1 on every device), ``gather_s`` (the
    tokens to device 0) and ``resolve_s`` (K2), summed over the groups,
    with every device synchronised after each stage -- a measurement mode
    that serialises the host and the devices.  The same stages are the
    spans ``zling.dec.entropy``, ``dec.gather`` and ``dec.resolve``
    (``utils/metrics.stage``), then ``dec.collect``, whether probed or not.
    """
    return decode_lanes(data, Lanes(make_mesh(devices)), group_blocks,
                        stage_probe)


def decode_lanes(data: bytes, lanes: Lanes, group_blocks: int | None,
                 stage_probe: dict | None = None) -> bytes:
    """``mesh_decode`` over ``lanes``' entries."""
    if group_blocks is not None and group_blocks < 1:
        raise ValueError("group_blocks must be >= 1")
    data = bytes(data)
    s = gd.parse(data) if data else None
    if s is None:
        return b""
    return collect(launch_lanes(s, lanes, group_blocks,
                                mops.initial_table(lanes.resolve_device),
                                stage_probe)[0])


def decode_spans(spans: Iterable[bytes], lanes: Lanes,
                 table: torch.Tensor | None = None
                 ) -> Iterator[tuple[bytes, torch.Tensor]]:
    """Decode a stream that arrives a span of whole blocks at a time (the
    split path K1 -> K2, which returns its exit table).

    Yields, for each span, its bytes and its exit MTF table (u8 [256,
    256], still on ``lanes.resolve_device``).  ``table`` None is the
    stream start; a table given from outside continues the stream it came
    from.  Span s+1 is parsed and launched before span s's bytes are
    fetched, so at most two spans are in flight.  Raises ValueError on a
    corrupt span.
    """
    dev = lanes.resolve_device
    table = mops.initial_table(dev) if table is None else table.to(dev)
    prev = None
    for span in spans:
        s = gd.parse(bytes(span))
        pending = []
        if s is not None:
            pending, table = launch_lanes(s, lanes, None, table)
        if prev is not None:
            yield collect(prev[0]), prev[1]
        prev = pending, table
    if prev is not None:
        yield collect(prev[0]), prev[1]


def launch_lanes(s: gd.Stream, lanes: Lanes, group_blocks: int | None,
                 mtf0: torch.Tensor, stage_probe: dict | None = None):
    """Stage and launch K1 on every entry's run and K2 on the resolve
    device for every group of ``s``, the MTF table carried from one
    group's K2 to the next.  Without ``stage_probe`` the host never waits
    for a device here.  Returns per group (K1 status, K2 status, bytes,
    token counts), not yet fetched, and the exit MTF table."""
    n_blocks = len(s.block_base) - 1
    step = group_blocks or n_blocks
    D = lanes.count
    cuda = {d for d in lanes.devices if d is not None and d.type == "cuda"}

    def span(name: str, key: str):
        return metrics.stage(name, stage_probe, key, cuda)

    mtf = mtf0
    pending = []
    for b0 in range(0, n_blocks, step):
        c0, c1 = s.chunks_of(b0, min(b0 + step, n_blocks))
        if c0 == c1:
            continue                      # no chunks: empty blocks only
        cd = -(-(c1 - c0) // D)
        runs = [(min(c0 + i * cd, c1), min(c0 + (i + 1) * cd, c1))
                for i in range(D)]
        with span("dec.entropy", "entropy_s"):
            k1out = {}
            for i in lanes.entries:
                a, b = runs[i]
                if a < b:
                    k1out[i] = ek.decode_chunks(*ek.stage_chunks(
                        s.len1[a:b], s.len2[a:b], s.bodies[a:b],
                        s.rlens[a:b], lanes.devices[i]))
        with span("dec.gather", "gather_s"):
            tokens, estatus = lanes.gather_tokens(k1out, runs, s.rlens)
        with span("dec.resolve", "resolve_s"):
            out, rstatus, mtf = rk.resolve_stream(
                tokens, *s.resolve_args(c0, c1, lanes.resolve_device), mtf)
        pending.append((estatus, rstatus, out, s.rlens[c0:c1]))
    return pending, mtf


def collect(pending) -> bytes:
    """Fetch and check every group's statuses and bytes, in order."""
    with metrics.stage("dec.collect"):
        parts = []
        for estatus, rstatus, out, rlens in pending:
            est = estatus.cpu().numpy()
            if est[:, 2].any() or (est[:, 0] != rlens).any():
                raise ValueError("zling: corrupt stream (huffman)")
            if rstatus.cpu().numpy()[:, 2].any():
                raise ValueError("zling: corrupt stream (resolve)")
            parts.append(out.cpu().numpy().tobytes())
        return b"".join(parts)
