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
                device D-1, whose exit state is the group's carry, handed
                to device 0 by the next group's chain (``Lanes.hand``);
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

The group loop is ``encode_groups``: groups arrive one at a time (from a
file, ``utils/io.py``), and each yields its bytes with its exit carry
(the device-resident MTF state and the level), from which a stream can
also start.  ``encode_lanes`` is its one-shot case over a whole buffer.

``elastic`` (mesh.py:332-372, 440-477): a group whose device was lost
(``_build.device_lost``; every other error, a fault of the port's own
kernels among them, propagates) is encoded again on the host from its
entry carry -- a pinned host copy of its entry state, taken when it was
dispatched, and its entry level -- by the native engine
(``native.engine.encode_from``) at the canonical chunk cap, else by
``Part`` on the CPU; it is counted as ``enc.group_failover``, the stream
does not change, and the next group starts from the host's state back on
the device, where it must finish: a second failure in a row propagates.

Each stage is a span (``utils/metrics.stage``, ``zling.enc.*``) on the
profiler's timeline, which waits for nothing.  Counterpart of the JAX
``ZLT_STAGE_PROBE`` (mesh.py:66-88), the stage probe: the ``zling.*``
spans, tabled by ``benchmark/span_table.py``.

Not ported: the ``tokenizer="xla"`` twin (its role on the CPU is K4's
plain version, exact at every level) and the chunk-axis bucketing, which
serve XLA's shapes.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Iterator

import numpy as np
import torch

from .. import _build
from .. import group_encode as ge
from ..native import engine
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
        for ``src``'s, and the state moves to its device.  A hand between
        two cards is the span ``zling.enc.hand`` (the wait and the copy)
        and counts ``enc.card_hands``; a hand on one card opens neither."""
        if src is None or src == dst:
            return state
        s_src, s_dst = self.streams[src], self.streams[dst]
        if s_dst is None:
            return state
        if self.devices[src] == self.devices[dst]:
            s_dst.wait_stream(s_src)
            state.record_stream(s_dst)
            return state
        # a copy between cards runs on the source's current stream after
        # the destination's, which then waits for it
        metrics.registry.count("enc.card_hands")
        with metrics.stage("enc.hand"):
            s_dst.wait_stream(s_src)
            with torch.cuda.stream(s_src), torch.cuda.stream(s_dst):
                return state.to(self.devices[dst], non_blocking=True)

    def group_exit(self, state, last: int):
        """The group's exit state and the entry it lies on."""
        return state, last

    def any_failed(self, failed: bool) -> bool:
        """Whether this group failed in any process: here, in this one."""
        return failed

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
                blocks_per_device: int = 1, elastic: bool = False) -> bytes:
    """Encode with blocks sharded over ``devices`` (``make_mesh``);
    byte-identical to ``spec.encode(data, level, block_size=block_size,
    max_tokens=max_tokens)``.  ``elastic``: a group whose device path
    fails is encoded again on the host (``encode_groups``)."""
    if level not in LEVEL_PARAMS:
        raise ValueError("level must be 0..6")
    if not data:
        return b""
    return encode_lanes(bytes(data), level, Lanes(make_mesh(devices)),
                        block_size, max_tokens, blocks_per_device, elastic)


def encode_lanes(data: bytes, level: int, lanes: Lanes, block_size: int,
                 max_tokens: int, blocks_per_device: int,
                 elastic: bool = False) -> bytes:
    """The group loop of ``mesh_encode`` over ``lanes``' entries: the
    one-shot case of ``encode_groups``, ``data`` cut into groups of
    ``lanes.count * blocks_per_device`` blocks."""
    def groups():
        step = lanes.count * blocks_per_device * block_size
        view = memoryview(data)
        for i in range(0, len(data), step):
            yield view[i:i + step]

    return b"".join(out for out, _ in encode_groups(
        groups(), level, lanes, block_size, max_tokens, blocks_per_device,
        elastic=elastic))


def host_encode_group(data: bytes, level: int, state: bytes, entry: int,
                      block_size: int, max_tokens: int
                      ) -> tuple[bytes, bytes, int]:
    """The elastic lane's host re-encode of one group (the counterpart of
    ``libzling_tpu/parallel/mesh.py::_host_encode_group``): ``data``'s
    blocks from the carried MTF ``state`` (``ops/mtf.py::state_to_bytes``)
    and ``entry`` level; returns (the group's bytes, the exit state as
    bytes, the exit level).  Two routes give the same bytes: at
    ``max_tokens == BLOCK_SIZE_ROLZ``, the chunk cap compiled into the
    native engine (every call at the canonical geometry),
    ``native.engine.encode_from``; at any other cap, the group runs
    through ``group_encode.Part`` on the CPU (every kernel's plain
    version, exact at every geometry) from the same carry."""
    if max_tokens == BLOCK_SIZE_ROLZ:
        return engine.encode_from(bytes(data), level, state, entry,
                                  block_size)
    cpu = Lanes([torch.device("cpu")])
    (out, (st, lvl)), = encode_groups(
        [data], level, cpu, block_size, max_tokens,
        -(-len(data) // block_size), (mops.state_from_bytes(state), entry))
    return out, mops.state_to_bytes(st), lvl


class _GroupFailed(Exception):
    """A group's device path failed; ``encode_groups``' ``guard`` holds
    the error with the group."""


def encode_groups(groups: Iterable[bytes], level: int, lanes: Lanes,
                  block_size: int, max_tokens: int, blocks_per_device: int,
                  carry: tuple[torch.Tensor, int] | None = None,
                  elastic: bool = False
                  ) -> Iterator[tuple[bytes, tuple[torch.Tensor, int]]]:
    """Encode a stream that arrives a group of blocks at a time.

    Every group but the last must hold exactly ``lanes.count *
    blocks_per_device`` whole blocks (a shorter one would end a block
    early: a valid stream, but not the canonical one), else ValueError.
    Yields, for each group, its framed bytes and its exit carry ``(state,
    level)``: the u8 [2, 256, 256] K5 state, still on the device, and the
    level the next chunk starts at.  ``carry`` None is the stream start;
    a carry given from outside continues the stream it came from.  Group
    g+1 is taken from ``groups`` (and launched, the look-ahead) before g's
    bytes are yielded, so at most two groups of input are held, and a
    finished group's device buffers are released before it is yielded.

    ``elastic``: a group whose device was lost (``_build.device_lost``: a
    ``DeviceLost``, or a CUDA error code that says the device or its
    context is gone) while the group was dispatched (its ``Part``s, K4's
    and K5's launches, the hands) or finished (``Part.finish``, the
    gathers, validation, framing) is encoded again on the host from its
    entry carry (``host_encode_group``), counted once as
    ``enc.group_failover``, and the stream does not change.  Any other
    error -- a build, a launch or a kernel fault of the port's own, an
    illegal address -- propagates as without ``elastic``.  The group after
    a failover must finish on the device: if it fails too, its error
    propagates, and the stream is never carried on by the host.  The
    entry state is copied to pinned host memory when the group is
    dispatched, on the stream of the K5 that made it, and the copy is
    waited for once the group before it has finished on the device, so
    the recovery reads host memory only; a group whose copy did not
    complete cannot be recovered and raises.  A look-ahead's error stays
    with it until it is consumed.  After a failover the group's exit state
    is the host's (a CPU tensor, moved to the first entry's device when
    the next group is dispatched), and the look-ahead chained from the
    failed group's device state is dispatched again from it
    (``enc.pipeline_redispatch``).  Over ``distributed.RankLanes`` every
    process learns, after each step of its own and before the next
    collective, whether any process's group failed (``Lanes.any_failed``),
    so that all re-encode the same groups and frame the same stream; a
    K5 that fails still hands its input state on, so that the chain's
    send/recv pair up.  Limit: a process that fails inside a collective
    (the K5 chain's send/recv, a gather, the exit broadcast) leaves the
    others in it until the process group's timeout; only failures caught
    before the process's next collective are recovered.  Without
    ``elastic`` an exception propagates and no copy is queued.

    Every stage is a span (``metrics.stage``): ``zling.enc.dispatch``
    (within it ``enc.launch``, one K4 + K5 pass, with ``enc.hand`` for
    each hand of the MTF state between two cards, and ``enc.stage``, the
    runs' buffers), ``enc.launch`` alone for a re-run after a fix,
    ``enc.failover``, and the stages below as ``zling.enc.<stage>``
    (``Part.finish`` adds ``enc.wait``, ``Part.tokenize`` /
    ``Part.relabel`` ``enc.tokenize`` / ``enc.relabel``).  No span stays
    open across the ``yield``.

    Each group framed counts ``enc.groups`` (one a ``zling.enc.frame``
    span).
    """
    if level not in LEVEL_PARAMS:
        raise ValueError("level must be 0..6")
    if blocks_per_device < 1:
        raise ValueError("blocks_per_device must be >= 1")
    bpd = blocks_per_device
    max_chunks = ge.max_chunks_of(block_size, max_tokens)
    G = lanes.count * bpd
    size = G * block_size

    def guard(cur: dict, step):
        """Run ``step``, this process's part of group ``cur``.  With
        ``elastic`` a lost device's error is kept with the group, and the
        processes agree whether any one's group failed; returns
        ``step()``, or None once the group failed."""
        if not elastic:
            return step()
        out = None
        if cur["exc"] is None:
            try:
                out = step()
            except Exception as e:
                if not _build.device_lost(e):
                    raise
                cur["exc"] = e
        if lanes.any_failed(cur["exc"] is not None) and cur["exc"] is None:
            cur["exc"] = _build.DeviceLost("the group failed in another "
                                           "process")
        return out

    def checked(cur: dict, step):
        """``guard``, then raise ``_GroupFailed`` if the group failed."""
        out = guard(cur, step)
        if cur["exc"] is not None:
            raise _GroupFailed
        return out

    def snapshot(cur: dict) -> None:
        """Queue a copy of the group's entry state into pinned host memory,
        without waiting, on the stream of the K5 that made it (``src_in``;
        the first entry's stream, after the current one, for a state that
        arrived there); ``settle`` waits for it."""
        state, src = cur["state_in"], cur["src_in"]
        if state.device.type != "cuda":
            cur["snap"] = state.clone()
            return
        s = lanes.streams[lanes.entries[0] if src is None else src]
        if src is None:
            s.wait_stream(torch.cuda.current_stream(state.device))
        host = torch.empty(state.shape, dtype=state.dtype, pin_memory=True)
        with torch.cuda.stream(s):
            host.copy_(state, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        state.record_stream(s)
        cur["copy"] = (host, done)

    def settle(cur: dict) -> None:
        """Wait for the group's host copy of its entry state, once the
        group before it has finished on the device.  A device lost before
        the copy ended raises here: the group could not be recovered."""
        if "copy" in cur:
            host, done = cur.pop("copy")
            done.synchronize()
            cur["snap"] = host

    def launch(cur: dict, setup=None) -> None:
        """Queue every local run's K4 (after ``setup``), then the K5 chain
        over the runs.  A K5 that fails hands its input state on, so that
        the chain's collectives pair up, and raises at the chain's end."""
        def tokenize():
            if setup is not None:
                setup()
            for i, p in cur["parts"].items():
                with lanes.on(i):
                    p.tokenize(cur["sched"][i * bpd:i * bpd + len(p.blocks)])

        def chain():
            state, src, err = cur["state_in"], cur["src_in"], None
            for i in range(cur["n"]):
                state = lanes.hand(state, src, i)
                src = i
                if i in cur["parts"] and err is None:
                    try:
                        with lanes.on(i):
                            state = cur["parts"][i].relabel(state)
                    except Exception as e:
                        err = e
            cur["state_out"], cur["src_out"] = lanes.group_exit(state, src)
            if err is not None:
                raise err

        with metrics.stage("enc.launch"):
            guard(cur, tokenize)
            guard(cur, chain)

    def dispatch(data, entry: int, state_in, src_in) -> dict:
        """Launch one group, its blocks numbered from 0 over ``data``,
        from ``state_in`` (on entry ``src_in``'s device; None: on the
        first entry's, or on the CPU)."""
        blocks = range(-(-len(data) // block_size))
        runs = [blocks[k:k + bpd] for k in range(0, len(blocks), bpd)]
        sched = np.full((len(blocks), max_chunks), level, np.int32)
        sched[0, 0] = entry
        cur = dict(data=data, sched=sched, entry=entry, state_in=state_in,
                   src_in=src_in, parts={}, n=len(runs), exc=None)

        def setup():
            if elastic:
                snapshot(cur)
            with metrics.stage("enc.stage"):
                if src_in is None:
                    cur["state_in"] = state_in.to(
                        lanes.devices[lanes.entries[0]])
                for i in lanes.entries:
                    if i < len(runs):
                        with lanes.on(i):
                            cur["parts"][i] = ge.Part(
                                data, runs[i], block_size, max_tokens,
                                lanes.devices[i])

        with metrics.stage("enc.dispatch"):
            launch(cur, setup)
        return cur

    def finish(cur: dict):
        """Validate (re-running the group on a fix) and frame; returns
        (bytes, exit level, whether the first pass held)."""
        passes = 0
        while True:
            passes += 1
            done = checked(cur, lambda: {
                i: p.finish()
                for i, p in cur["parts"].items()})
            with metrics.stage("enc.gather_pack_meta"):
                views = lanes.gather(done, cur["n"])
            with metrics.stage("enc.validate"):
                expected, any_fix = checked(cur, lambda: ge.validate(
                    views, cur["sched"], cur["entry"], level))
            if not any_fix:
                break
            launch(cur)
        if passes > 1:
            metrics.registry.count("enc.schedule_mispredicts", passes - 1)
        with metrics.stage("enc.gather_words"):
            views = lanes.gather(checked(cur, lambda: {
                i: p.view_with_words() for i, p in cur["parts"].items()}),
                cur["n"])
        with metrics.stage("enc.frame"):
            out = checked(cur, lambda: ge.frame(views))
        metrics.registry.count("enc.groups")
        return out, expected, passes == 1

    def take(it):
        """The next non-empty group, or None at the end."""
        for data in it:
            if len(data) > size:
                raise ValueError(f"a group holds at most {size} bytes")
            if len(data):
                return data
        return None

    it = iter(groups)
    data = take(it)
    if data is None:
        return
    state, entry = (lanes.initial_state(), level) if carry is None \
        else carry
    pend = dispatch(data, entry, state, None)
    if elastic:
        settle(pend)
    recovered = False                 # the group before went to the host
    while pend is not None:
        cur = pend
        data = take(it)
        if data is not None and len(cur["data"]) != size:
            raise ValueError(f"a group before the last must hold {size} "
                             f"bytes, not {len(cur['data'])}")
        # the look-ahead: g+1 from g's exit state, before g's host stages
        pend = dispatch(data, level, cur["state_out"], cur["src_out"]) \
            if data is not None and "state_out" in cur else None
        try:
            if cur["exc"] is not None:
                raise _GroupFailed
            out, expected, clean = finish(cur)
            state_out, src_out = cur["state_out"], cur["src_out"]
            recovered = False
        except _GroupFailed:
            if recovered or "snap" not in cur:
                raise cur["exc"] from None
            metrics.registry.count("enc.group_failover")
            with metrics.stage("enc.failover"):
                out, host, expected = host_encode_group(
                    cur["data"], level, mops.state_to_bytes(cur["snap"]),
                    cur["entry"], block_size, max_tokens)
            state_out, src_out, clean = mops.state_from_bytes(host), None, \
                False
            recovered = True
        if data is not None and (pend is None or not clean
                                 or expected != level):
            if pend is not None:
                metrics.registry.count("enc.pipeline_redispatch")
            pend = None               # its buffers go before the new ones
            pend = dispatch(data, expected, state_out, src_out)
        if elastic and pend is not None:
            settle(pend)
        del cur
        yield out, (state_out, expected)
