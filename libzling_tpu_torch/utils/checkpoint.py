"""Group-granular checkpoint/resume for long file codec jobs.

Counterpart of ``libzling_tpu/utils/checkpoint.py``.  The zling format is
resumable at block boundaries given the carried MTF state (SURVEY.md
section 5: the container frames blocks with continue/stop flags; the one
piece of cross-block state is the 128 KB MTF table set).  A checkpoint
records (input offset, output offset, carry) after each group the lanes
finish, so a killed job resumes from the last completed group instead of
restarting.

Checkpoint file: one JSON object, the JAX package's layout -- ``kind``,
``in_off`` (encode: input bytes; decode: whole blocks), ``out_off``,
``carry_mtf`` (base64 of 131,072 bytes, the native engine's ``MtfState``:
rank2sym, then sym2rank) and, for encode, ``level_state``.  The encode
carry is K5's u8 [2, 256, 256] state; the decode carry is K2's table, then
its inverse.  The state goes to the host only when a checkpoint is
written.  ``route="pipeline"`` runs the job on the host pipeline
(``pipeline.py``) instead, in the JAX package's steps (64 MiB of input,
4 blocks of a stream); its carry is the engine's ``MtfState`` itself.  A
job stopped on one route resumes on the other, or in the JAX package.
"""

from __future__ import annotations

import base64
import json
import os
import pathlib

from .. import pipeline
from ..group_encode import GROUP_BLOCKS
from ..ops import mtf as mops
from ..parallel.decode_mesh import decode_spans
from ..parallel.mesh import Lanes, encode_groups, make_mesh
from ..tables import BLOCK_SIZE_IN, BLOCK_SIZE_ROLZ
from .io import (DECODE_GROUP_BLOCKS, PIPELINE_GROUP, FileSource,
                 check_route, read_groups)


def _write_ckpt(path: pathlib.Path, kind: str, in_off: int, out_off: int,
                carry) -> None:
    if kind == "encode":
        blob = {"carry_mtf": base64.b64encode(carry[0]).decode(),
                "level_state": carry[1]}
    else:
        blob = {"carry_mtf": base64.b64encode(carry).decode()}
    tmp = path.with_suffix(".tmp")
    with open(tmp, "w") as f:
        f.write(json.dumps({"kind": kind, "in_off": in_off,
                            "out_off": out_off, **blob}))
        f.flush()
        os.fsync(f.fileno())
    tmp.replace(path)


def _read_ckpt(path: pathlib.Path, kind: str):
    st = json.loads(path.read_text())
    if st.get("kind") != kind:
        raise ValueError(f"checkpoint kind mismatch: {st.get('kind')} != "
                         f"{kind}")
    mtf = base64.b64decode(st["carry_mtf"])
    carry = (mtf, st["level_state"]) if kind == "encode" else mtf
    return st["in_off"], st["out_off"], carry


def encode_file_resumable(src: str, dst: str, level: int = 0,
                          checkpoint: str | None = None, devices=None, *,
                          block_size: int = BLOCK_SIZE_IN,
                          max_tokens: int = BLOCK_SIZE_ROLZ,
                          blocks_per_device: int = GROUP_BLOCKS,
                          route: str = "lanes") -> tuple[int, int]:
    """Compress src -> dst through the lanes over ``devices``
    (``mesh.make_mesh``; or, ``route="pipeline"``, the host pipeline),
    checkpointing after every group; resumes if the checkpoint exists.
    Returns (bytes_in, bytes_out)."""
    check_route(route, devices, block_size, max_tokens)
    lanes = Lanes(make_mesh(devices)) if route == "lanes" else None
    step = lanes.count * blocks_per_device * block_size if lanes \
        else PIPELINE_GROUP
    ckpt = pathlib.Path(checkpoint or dst + ".ckpt")
    in_off, out_off, carry = 0, 0, None
    size = os.path.getsize(src)
    if ckpt.exists():
        in_off, out_off, carry = _read_ckpt(ckpt, "encode")
        if in_off % block_size and in_off != size:
            raise ValueError("checkpoint offset is not on a block boundary")
        if lanes:
            carry = mops.state_from_bytes(carry[0], lanes.devices[0]), \
                carry[1]
    with open(src, "rb") as f, open(dst, "r+b" if in_off else "wb") as g:
        f.seek(in_off)
        g.seek(out_off)
        g.truncate()
        groups = read_groups(FileSource(f), step)
        for part, (state, lvl) in (
                encode_groups(groups, level, lanes, block_size, max_tokens,
                              blocks_per_device, carry) if lanes
                else pipeline.encode_groups(groups, level, carry)):
            g.write(part)
            # the checkpoint must never claim data the OS hasn't persisted:
            # a crash between them would resume past a zero-filled hole
            g.flush()
            os.fsync(g.fileno())
            in_off += min(step, size - in_off)
            out_off += len(part)
            _write_ckpt(ckpt, "encode", in_off, out_off,
                        (mops.state_to_bytes(state) if lanes else state,
                         lvl))
    ckpt.unlink(missing_ok=True)
    return in_off, out_off


def decode_file_resumable(src: str, dst: str,
                          checkpoint: str | None = None, devices=None, *,
                          group_blocks: int = DECODE_GROUP_BLOCKS,
                          route: str = "lanes") -> tuple[int, int]:
    """Decompress src -> dst through the lanes over ``devices`` (or,
    ``route="pipeline"``, the host pipeline) with a checkpoint after every
    ``group_blocks`` blocks.

    Scans the container framing to split the stream into whole-block spans
    (cheap header walk, no entropy work), then decodes spans with carried
    MTF state.  Returns (bytes_in, bytes_out)."""
    check_route(route, devices)
    lanes = Lanes(make_mesh(devices)) if route == "lanes" else None
    data = pathlib.Path(src).read_bytes()
    # split into block spans at stop flags
    spans = []
    pos = 0
    start = 0
    n = len(data)
    while pos < n:
        flag = data[pos]
        pos += 1
        if flag == 0:
            spans.append((start, pos))
            start = pos
            continue
        if flag != 1 or pos + 12 > n:
            raise ValueError("zling: corrupt stream (bad framing)")
        olen = int.from_bytes(data[pos + 8:pos + 12], "big")
        pos += 12 + olen
        if pos > n:
            raise ValueError("zling: corrupt stream (truncated)")
    if start != n:
        raise ValueError("zling: truncated stream (missing stop flag)")

    ckpt = pathlib.Path(checkpoint or dst + ".ckpt")
    span_idx, out_off, carry = 0, 0, None
    if ckpt.exists():
        span_idx, out_off, carry = _read_ckpt(ckpt, "decode")
        if lanes:
            carry = mops.state_from_bytes(carry, lanes.resolve_device)[0]
    batches = [spans[i:i + group_blocks]
               for i in range(span_idx, len(spans), group_blocks)]
    blobs = (data[b[0][0]:b[-1][1]] for b in batches)
    with open(dst, "r+b" if span_idx else "wb") as g:
        g.seek(out_off)
        g.truncate()
        for batch, (part, carry) in zip(batches, (
                decode_spans(blobs, lanes, carry) if lanes
                else pipeline.decode_spans(blobs, carry))):
            g.write(part)
            g.flush()
            os.fsync(g.fileno())
            span_idx += len(batch)
            out_off += len(part)
            _write_ckpt(ckpt, "decode", span_idx, out_off,
                        mops.table_to_bytes(carry) if lanes else carry)
    ckpt.unlink(missing_ok=True)
    return n, out_off
