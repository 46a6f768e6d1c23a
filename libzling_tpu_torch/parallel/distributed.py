"""Several processes, one device each: the lanes over ``torch.distributed``.

Counterpart of ``libzling_tpu/parallel/distributed.py``.  Every process
calls the same function with the same arguments and gets the same result:

  * ``init_distributed()`` -- once a process (explicit arguments, or the
    ``env://`` variables MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK);
  * ``distributed_encode`` -- ``mesh.encode_lanes`` with one entry a
    process: rank r tokenizes the r-th run of each group (K4), the MTF
    state goes rank r-1 -> r by ``send``/``recv`` around each K5, and the
    group's exit state is broadcast from the last rank; the chunk metadata
    and then the realized words are all-gathered, so that every rank
    validates the same schedule, re-runs the same groups and frames the
    identical stream (distributed.py:60-78);
  * ``distributed_decode`` -- ``decode_mesh.decode_lanes`` with one entry a
    process: K1 on each rank's run of a group's chunks, the tokens
    all-gathered, and K2 replicated on every rank (decode_mesh.py:95-103),
    each returning the same bytes.

Collectives carry device tensors under ``nccl`` and host tensors under
``gloo``; the backend is the caller's (``init_distributed``), and a
combination that cannot work raises (``nccl`` with a CPU device; NCCL
itself refuses two ranks on one GPU, where ``gloo`` serves).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..group_encode import View
from ..ops import mtf as mops
from ..tables import BLOCK_SIZE_IN, BLOCK_SIZE_ROLZ, LEVEL_PARAMS
from .decode_mesh import decode_lanes
from .mesh import Lanes, encode_lanes, make_mesh

_STATE = (2, 256, 256)        # the encoder's MTF state, u8 (r2s, s2r)


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None, backend: str | None = None,
                     timeout: datetime.timedelta = datetime.timedelta(
                         seconds=300)) -> bool:
    """Initialize the default process group (idempotent).

    Returns True if a group of several processes is active; False, doing
    nothing, when none is configured (no ``init_method`` and no
    MASTER_ADDR / MASTER_PORT) or the world has one process.  ``backend``
    is ``"nccl"`` (the default) or ``"gloo"``.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            return False
        init_method = "env://"
    world_size = int(world_size if world_size is not None
                     else env.get("WORLD_SIZE", "1"))
    rank = int(rank if rank is not None else env.get("RANK", "0"))
    if world_size <= 1:
        return False
    dist.init_process_group(backend or "nccl", init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout)
    return True


class RankLanes(Lanes):
    """One entry a process: this rank's device, its side stream, and the
    collectives that move the MTF state and the host views."""

    def __init__(self, device=None):
        if not dist.is_initialized():
            raise RuntimeError("libzling_tpu_torch: call init_distributed "
                               "first")
        self.rank, self.count = dist.get_rank(), dist.get_world_size()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("libzling_tpu_torch: no CUDA device is "
                                   "available")
            device = self.rank % torch.cuda.device_count()
        (dev,) = make_mesh([device])
        backend = dist.get_backend()
        if backend == "nccl":
            if dev.type != "cuda":
                raise ValueError("nccl carries device tensors: a CUDA "
                                 "device is needed")
            torch.cuda.set_device(dev)
            self.comm = dev
        elif backend == "gloo":
            self.comm = torch.device("cpu")
        else:
            raise ValueError(f"libzling_tpu_torch: unsupported backend "
                             f"{backend}")
        self.devices = [dev if i == self.rank else None
                        for i in range(self.count)]
        self.entries = [self.rank]
        self.streams = [torch.cuda.Stream(dev)
                        if i == self.rank and dev.type == "cuda" else None
                        for i in range(self.count)]

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    def initial_state(self) -> torch.Tensor:
        return mops.initial_state(self.device)

    def hand(self, state, src, dst: int):
        """Send the state from rank ``src`` to rank ``dst``; the ranks that
        hold no state for this step return None."""
        if src is None or src == dst:
            return state
        if self.rank == src:
            with self.on(src):
                dist.send(state.to(self.comm), dst)
            return None
        if self.rank == dst:
            buf = torch.empty(_STATE, dtype=torch.uint8, device=self.comm)
            with self.on(dst):
                dist.recv(buf, src)
                return buf.to(self.device)
        return None

    def group_exit(self, state, last: int):
        """Broadcast the exit state from rank ``last``: every rank holds
        the next group's carried state."""
        with self.on(self.rank):
            buf = state.to(self.comm) if self.rank == last else \
                torch.empty(_STATE, dtype=torch.uint8, device=self.comm)
            dist.broadcast(buf, last)
            return buf.to(self.device), None

    def _all_gather(self, arrays: list) -> list:
        """Every rank's list of 1-D arrays (as int64; the same count on
        every rank), in rank order."""
        W, comm = self.count, self.comm
        sizes = torch.tensor([a.size for a in arrays], dtype=torch.int64,
                             device=comm)
        every = [torch.empty_like(sizes) for _ in range(W)]
        dist.all_gather(every, sizes)
        every = [s.cpu().tolist() for s in every]
        flat = torch.zeros(max(1, max(sum(s) for s in every)),
                           dtype=torch.int64, device=comm)
        mine = np.concatenate([np.asarray(a, np.int64).ravel()
                               for a in arrays])
        flat[:mine.size] = torch.from_numpy(mine)
        bufs = [torch.empty_like(flat) for _ in range(W)]
        dist.all_gather(bufs, flat)
        out = []
        for s, b in zip(every, bufs):
            b = b.cpu().numpy()
            ends = np.cumsum(s)
            out.append([b[e - n:e] for e, n in zip(ends, s)])
        return out

    def gather(self, views: dict, n: int) -> list:
        """All-gather the runs' host views; a rank without a run in this
        group, and a view without its words, send empty arrays."""
        z = np.zeros(0, np.int64)
        v = views.get(self.rank, View(z, z, z, z, z, z, z, None))
        got = self._all_gather(list(v[:7]) + [
            z if v.words is None else v.words])
        return [View(*g[:5], g[5].reshape(len(g[1]), -1),
                     g[6].reshape(len(g[1]), -1), g[7]) for g in got[:n]]

    @property
    def resolve_device(self) -> torch.device:
        return self.device

    def gather_tokens(self, k1out: dict, runs, rlens):
        """All-gather every rank's K1 tokens and status rows of a group;
        each rank's share is known to all from the stream's header."""
        sizes = [int(np.sum(rlens[a:b])) for a, b in runs]
        nch = [b - a for a, b in runs]
        tok = torch.zeros(max(1, max(sizes)), dtype=torch.int32,
                          device=self.comm)
        st = torch.zeros((max(1, max(nch)), 3), dtype=torch.int32,
                         device=self.comm)
        if self.rank in k1out:
            t, s = k1out[self.rank]
            tok[:sizes[self.rank]] = t.to(self.comm)
            st[:nch[self.rank]] = s.to(self.comm)
        toks = [torch.empty_like(tok) for _ in range(self.count)]
        sts = [torch.empty_like(st) for _ in range(self.count)]
        dist.all_gather(toks, tok)
        dist.all_gather(sts, st)
        return (torch.cat([t[:n] for t, n in zip(toks, sizes)])
                .to(self.device),
                torch.cat([s[:n] for s, n in zip(sts, nch)]).to(self.device))


def distributed_encode(data: bytes, level: int,
                       block_size: int = BLOCK_SIZE_IN,
                       max_tokens: int = BLOCK_SIZE_ROLZ, device=None,
                       blocks_per_device: int = 1) -> bytes:
    """Canonical encode with each group's blocks spread over the ranks,
    ``blocks_per_device`` consecutive blocks a rank, on this rank's
    ``device`` (default: GPU rank mod the GPUs visible).  Every rank gets
    the same stream, byte-identical to ``spec.encode`` at equal
    geometry."""
    if level not in LEVEL_PARAMS:
        raise ValueError("level must be 0..6")
    lanes = RankLanes(device)
    return encode_lanes(bytes(data), level, lanes, block_size, max_tokens,
                        blocks_per_device)


def distributed_decode(data: bytes, group_blocks: int | None = 1,
                       device=None) -> bytes:
    """Decode with each group's chunks spread over the ranks and K2
    replicated; every rank gets the same bytes (raises ValueError on every
    rank if the stream is corrupt)."""
    return decode_lanes(data, RankLanes(device), group_blocks)
