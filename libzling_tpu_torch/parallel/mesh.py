"""Block-parallel encode over several devices -- canonical streams.

Counterpart of ``libzling_tpu/parallel/mesh.py::mesh_encode``.  ROLZ
bucket state resets at every block, so tokenization shards cleanly over
devices; ``mesh_encode(data, level, devices)`` is byte-identical to
``spec.encode(data, level)`` at equal geometry (multi-chunk blocks, the
adaptive level drop, the MTF and level carried across blocks).

Per group of ``len(devices) * blocks_per_device`` blocks, device d taking
the d-th run of ``blocks_per_device`` consecutive blocks
(``group_encode.Part``):

  [each device] K4 tokenizes its run under an optimistic per-chunk level
                schedule; every device's K4 is launched before any wait;
  [chain]       the MTF carry (the counterpart of the ppermute ring,
                mesh.py:170-175, 200-215): device 0 relabels with K5 from
                the carried state, the state goes ``.to()`` device 1, ...,
                device D-1, whose exit state is the group's carry;
  [each device] per-chunk histograms, then exact length tables on the
                host, then canonical codes and packing;
  [host]        serial schedule validation in block order over every run;
                on a fix the group runs again from its carried state
                (counted as ``enc.schedule_mispredicts``); the host fetches
                only the realized words, then frames.

1-deep look-ahead (mesh.py:438-477): group g+1's K4 and its K5 chain are
queued from g's device-resident exit state before g's host stages run,
predicting that g leaves the requested level.  A mispredict or a fix in g
queues g+1 again (``enc.pipeline_redispatch``).  Each device entry queues
its K4 and K5 on a side stream of its own (``Lanes``), and an event
orders its host stages on the device's current stream after them, so
that g's histograms and fetches do not wait for g+1's K4.  Entries that
name one card run side by side there: D copies of one card measure the
lanes' overhead, not their scaling.

Not ported: the ``tokenizer="xla"`` twin (its role on the CPU is K4's
plain version, exact at every level), ``elastic`` (a host re-encode of a
failed group), the chunk-axis bucketing and the stage probe, which serve
XLA's shapes and the TPU's host link.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import group_encode as ge
from ..ops import mtf as mops
from ..tables import BLOCK_SIZE_IN, BLOCK_SIZE_ROLZ, LEVEL_PARAMS
from ..utils import metrics


def make_mesh(devices=None) -> list[torch.device]:
    """The device entries of a lane: every visible GPU by default.  Entries
    may repeat a device; CPU entries run every kernel's plain version."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("libzling_tpu_torch: no CUDA device is "
                               "available")
        devices = range(torch.cuda.device_count())
    out = []
    for d in devices:
        dev = torch.device("cuda", d) if isinstance(d, int) \
            else torch.device(d)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("libzling_tpu_torch: no CUDA device is "
                                   "available")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type != "cpu":
            raise ValueError(f"libzling_tpu_torch: unsupported device {dev}")
        out.append(dev)
    if not out:
        raise ValueError("libzling_tpu_torch: a lane needs a device")
    if len({d.type for d in out}) > 1:
        raise ValueError("libzling_tpu_torch: a lane mixes CPU and CUDA "
                         "devices")
    return out


class Lanes:
    """The device entries of one process, each with a side stream on a
    CUDA device.  ``entries`` are the indices this process runs (all of
    them here; ``distributed.RankLanes`` runs one and moves the MTF state
    and the host views between processes)."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.count = len(self.devices)
        self.entries = range(self.count)
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]

    def on(self, i: int):
        """The context in which entry i queues its device work."""
        s = self.streams[i]
        return torch.cuda.stream(s) if s is not None \
            else contextlib.nullcontext()

    def initial_state(self) -> torch.Tensor:
        """The encoder's stream-start MTF state, where entry 0 reads it."""
        return mops.initial_state(self.devices[0])

    def hand(self, state, src, dst: int):
        """The MTF state produced by entry ``src`` (None: present where
        ``dst`` reads it), made ready for entry ``dst``: its stream waits
        for ``src``'s, and the state moves to its device."""
        if src is None or src == dst:
            return state
        s_src, s_dst = self.streams[src], self.streams[dst]
        if s_dst is None:
            return state
        s_dst.wait_stream(s_src)
        if self.devices[src] == self.devices[dst]:
            state.record_stream(s_dst)
            return state
        # a copy between devices runs on the source's current stream
        # after the destination's, which then waits for it
        with torch.cuda.stream(s_src), torch.cuda.stream(s_dst):
            return state.to(self.devices[dst], non_blocking=True)

    def group_exit(self, state, last: int):
        """The group's exit state and the entry it lies on."""
        return state, last

    def gather(self, views: dict, n: int) -> list:
        """Every run's host view in block order (``views``: this process's
        runs by entry; ``n``: the group's runs)."""
        return [views[i] for i in range(n)]

    @property
    def resolve_device(self) -> torch.device:
        """Where decode's serial resolve (K2) runs."""
        return self.devices[0]

    def gather_tokens(self, k1out: dict, runs, rlens):
        """A decode group's tokens on ``resolve_device``, flat in chunk
        order, and every chunk's K1 status row there.  ``k1out``: entry ->
        (tokens, status) of this process's non-empty runs; ``runs``: each
        entry's chunk range; ``rlens``: the stream's token counts."""
        dev = self.resolve_device
        got = [k1out[i] for i in sorted(k1out)]
        return (torch.cat([t.to(dev) for t, _ in got]),
                torch.cat([st.to(dev) for _, st in got]))


def mesh_encode(data: bytes, level: int, devices=None,
                block_size: int = BLOCK_SIZE_IN,
                max_tokens: int = BLOCK_SIZE_ROLZ,
                blocks_per_device: int = 1) -> bytes:
    """Encode with blocks sharded over ``devices`` (``make_mesh``);
    byte-identical to ``spec.encode(data, level, block_size=block_size,
    max_tokens=max_tokens)``."""
    if level not in LEVEL_PARAMS:
        raise ValueError("level must be 0..6")
    if not data:
        return b""
    return encode_lanes(bytes(data), level, Lanes(make_mesh(devices)),
                        block_size, max_tokens, blocks_per_device)


def encode_lanes(data: bytes, level: int, lanes: Lanes, block_size: int,
                 max_tokens: int, blocks_per_device: int) -> bytes:
    """The group loop of ``mesh_encode`` over ``lanes``' entries."""
    if blocks_per_device < 1:
        raise ValueError("blocks_per_device must be >= 1")
    if not data:
        return b""
    bpd = blocks_per_device
    max_chunks = ge.max_chunks_of(block_size, max_tokens)
    nblocks = (len(data) + block_size - 1) // block_size
    G = lanes.count * bpd

    def launch(cur: dict) -> None:
        """Queue every local run's K4, then the K5 chain over the runs."""
        for i, p in cur["parts"].items():
            with lanes.on(i):
                p.tokenize(cur["sched"][i * bpd:i * bpd + len(p.blocks)])
        state, src = cur["state_in"], cur["src_in"]
        for i in range(cur["n"]):
            state = lanes.hand(state, src, i)
            src = i
            if i in cur["parts"]:
                with lanes.on(i):
                    state = cur["parts"][i].relabel(state)
        cur["state_out"], cur["src_out"] = lanes.group_exit(state, src)

    def dispatch(g0: int, entry: int, state_in, src_in) -> dict:
        blocks = range(g0, min(g0 + G, nblocks))
        runs = [blocks[k:k + bpd] for k in range(0, len(blocks), bpd)]
        sched = np.full((len(blocks), max_chunks), level, np.int32)
        sched[0, 0] = entry
        parts = {}
        for i in lanes.entries:
            if i < len(runs):
                with lanes.on(i):
                    parts[i] = ge.Part(data, runs[i], block_size, max_tokens,
                                       lanes.devices[i])
        cur = dict(sched=sched, entry=entry, state_in=state_in,
                   src_in=src_in, parts=parts, n=len(runs))
        launch(cur)
        return cur

    def finish(cur: dict):
        """Validate (re-running the group on a fix) and frame; returns
        (bytes, exit level, whether the first pass held)."""
        passes = 0
        while True:
            passes += 1
            views = lanes.gather({i: p.finish()
                                  for i, p in cur["parts"].items()},
                                 cur["n"])
            expected, any_fix = ge.validate(views, cur["sched"],
                                            cur["entry"], level)
            if not any_fix:
                break
            launch(cur)
        if passes > 1:
            metrics.registry.count("enc.schedule_mispredicts", passes - 1)
        views = lanes.gather({i: p.view_with_words()
                              for i, p in cur["parts"].items()}, cur["n"])
        return ge.frame(views), expected, passes == 1

    out = bytearray()
    pend = dispatch(0, level, lanes.initial_state(), None)
    for g0 in range(0, nblocks, G):
        cur, nxt = pend, g0 + G
        # the look-ahead: g+1 from g's exit state, before g's host stages
        pend = dispatch(nxt, level, cur["state_out"], cur["src_out"]) \
            if nxt < nblocks else None
        out_g, expected, clean = finish(cur)
        out.extend(out_g)
        if pend is not None and (not clean or expected != level):
            metrics.registry.count("enc.pipeline_redispatch")
            pend = dispatch(nxt, expected, cur["state_out"], cur["src_out"])
    return bytes(out)
