"""Block-parallel host pipeline over the native engine's split-stage ABI.

Counterpart of ``libzling_tpu/pipeline.py`` (the JAX package's default
backend).  The format's one large-grain parallel axis is the 16 MiB block:
ROLZ bucket state resets every block, so blocks tokenize independently as
long as literals are emitted raw, because the MTF tables are the one piece
of state that crosses blocks.  So the codec runs in three phases on the
host's cores:

  encode:  [parallel] tokenize blocks (raw literals)
           [serial]   the MTF relabel carry pass (one table step a literal)
           [parallel] entropy-code each chunk
  decode:  [parallel] entropy-decode each chunk
           [serial]   ROLZ resolve and inverse MTF

The adaptive level drop (src/libzling.cpp:261-266) ties chunk k+1's level
to chunk k's coded size.  Blocks are tokenized ahead under a predicted
schedule (every chunk at the requested level); the serial phase checks the
prediction (``native.engine.adaptive_drop``) and tokenizes a block again
from the first wrong chunk on.  Streams equal the reference encoder's.

This is a host backend, used only where a caller names it: the CLI's
``--backend pipeline``, ``utils.io``'s and ``utils.checkpoint``'s
``route="pipeline"``.  Nothing falls back to it.
"""

from __future__ import annotations

import collections
import concurrent.futures
import itertools
import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from .native import engine as native
from .tables import (BLOCK_SIZE_HUFFMAN, BLOCK_SIZE_IN, BLOCK_SIZE_ROLZ,
                     SENTINEL_LEN)
from .utils import metrics

_MAX_CHUNKS = 192           # chunks a block, at most: >= 16 MiB / 131,072
# at worst one token a byte, plus a chunk of slack
_MAX_BLOCK_TOKENS = BLOCK_SIZE_IN + BLOCK_SIZE_ROLZ + 16


class _PrioPool:
    """A fixed pool of threads draining a priority queue (lower = sooner).

    All parallel work (tokenizing blocks, entropy-coding chunks) runs on
    these threads, so the machine is never oversubscribed; the main thread
    does the serial relabel and the framing.  Entropy jobs come first: the
    main thread waits on them next, on tokenize results a block later.
    """

    def __init__(self, nthreads: int, name: str):
        self.q: queue.PriorityQueue = queue.PriorityQueue()
        self._seq = itertools.count()
        self.threads = [
            threading.Thread(target=self._run, daemon=True, name=f"{name}-{i}")
            for i in range(nthreads)
        ]
        for t in self.threads:
            t.start()

    def submit(self, prio: int, fn, *args) -> Future:
        fut: Future = Future()
        self.q.put((prio, next(self._seq), fn, args, fut))
        return fut

    @staticmethod
    def _exec(item):
        _prio, _seq, fn, args, fut = item
        if not fut.set_running_or_notify_cancel():
            return
        try:
            fut.set_result(fn(*args))
        except BaseException as exc:  # noqa: BLE001 - relayed via the future
            fut.set_exception(exc)

    def _run(self):
        while True:
            item = self.q.get()
            if item[2] is None:
                return
            self._exec(item)

    def result_helping(self, fut: Future, max_help_prio: int):
        """Wait for ``fut``, running queued short jobs (priority at most
        ``max_help_prio``) on the calling thread meanwhile.

        The workers are not preempted: a queued entropy job can wait behind
        two running block tokenizations of hundreds of ms.  The blocked
        main thread takes such jobs, so the workers stay on tokenizing.
        """
        while not fut.done():
            try:
                item = self.q.get_nowait()
            except queue.Empty:
                break
            if item[0] > max_help_prio:
                self.q.put(item)  # a long job: leave it to a worker
                break
            self._exec(item)
        return fut.result()

    def shutdown(self):
        for _ in self.threads:
            self.q.put((1 << 30, next(self._seq), None, (), None))


class _TokenizerPool:
    """A native tokenizer a thread, and the token buffers.

    Buffers are reused, not mapped afresh (fresh pages fault slowly on
    virtual hosts, so warm 34 MB buffers matter).  Only the calling thread
    takes and gives back buffers: a block's buffer goes with its tokenize
    job and comes back once the block is coded.
    """

    def __init__(self, dll, nbuffers: int):
        self.dll = dll
        self.local = threading.local()
        self.handles: list[int] = []  # every thread's tokenizer, for counters
        self.free = [np.empty(_MAX_BLOCK_TOKENS, np.uint16)
                     for _ in range(nbuffers)]

    def handle(self):
        h = getattr(self.local, "h", None)
        if h is None:
            h = self.dll.zlt_tokenizer_new()
            self.local.h = h
            self.handles.append(h)
        return h


class _InFlight:
    """Jobs in flight, each handed a buffer of ``free`` when submitted.

    The next item is submitted only while a buffer is free, so no job ever
    waits for a buffer, and the oldest job -- the one the calling thread
    waits for -- always runs.  (The JAX pipeline lets each job take a
    buffer from a shared queue, every job submitted at once: later jobs
    can then hold every buffer while the oldest waits for one, and the
    calling thread for it.)  Used by the calling thread alone.
    """

    def __init__(self, free: list, submit, items):
        self.free, self.submit = free, submit
        self.todo = iter(items)
        self.jobs: collections.deque = collections.deque()

    def oldest(self):
        """Submit the next items while a buffer is free; return the oldest
        job's (future, buffer)."""
        while self.free:
            item = next(self.todo, None)
            if item is None:
                break
            buf = self.free.pop()
            self.jobs.append((self.submit(item, buf), buf))
        return self.jobs[0]

    def drain(self) -> None:
        """Take every buffer back once its job has ended -- a lost buffer
        would narrow every later call."""
        for fut, _buf in self.jobs:
            fut.cancel()
        concurrent.futures.wait([fut for fut, _ in self.jobs])
        self.free.extend(buf for _, buf in self.jobs)
        self.jobs.clear()


_PRIO_ENTROPY = 0
_PRIO_TOKENIZE = 1
COUNTER_NAMES = ("bucket_updates", "chain_steps", "match_succ", "match_fail",
                 "lazy_skips", "word_hits", "literals", "match_bytes")


class ParallelEncoder:
    """Blocks tokenized on a pool of ``workers`` threads, at most
    ``workers + 2`` in flight (``_InFlight``); the relabel and the framing
    on the calling thread; chunks entropy-coded on the pool."""

    def __init__(self, workers: int = 2):
        self.dll = native._lib()
        self.workers = workers
        self.pool = _PrioPool(workers, name="zlt-enc")
        self.tok = _TokenizerPool(self.dll, nbuffers=workers + 2)
        self.mtf = self.dll.zlt_mtf_new()
        self._out = None
        # entropy scratch buffers, recycled, grown on demand
        self.ent_free: queue.Queue = queue.Queue()

    def close(self) -> None:
        """Stop the threads and free the native state."""
        self.pool.shutdown()
        for t in self.pool.threads:
            t.join()
        for h in self.tok.handles:
            self.dll.zlt_tokenizer_free(h)
        self.tok.handles.clear()
        self.dll.zlt_mtf_free(self.mtf)
        self.mtf = None

    def _take_scratch(self):
        try:
            return self.ent_free.get_nowait()
        except queue.Empty:
            return np.empty(BLOCK_SIZE_HUFFMAN + 64, np.uint8)

    def _entropy_chunk(self, tokens, tpos: int, rlen: int, scratch) -> int:
        return self.dll.zlt_entropy_encode(
            tokens.ctypes.data + 2 * tpos, rlen, scratch.ctypes.data)

    def _tokenize_block(self, block_view, ilen, levels, tokens):
        rlens = np.zeros(_MAX_CHUNKS, np.int32)
        encpos = np.zeros(_MAX_CHUNKS, np.int32)
        lv = np.ascontiguousarray(levels, np.int32)
        n = self.dll.zlt_tokenize_block_raw(
            self.tok.handle(), block_view.ctypes.data, ilen, lv.ctypes.data,
            _MAX_CHUNKS, tokens.ctypes.data, _MAX_BLOCK_TOKENS,
            rlens.ctypes.data, encpos.ctypes.data)
        if n < 0:
            raise RuntimeError("tokenize overflow")
        return tokens, rlens[:n], encpos[:n], lv

    def encode(self, data: bytes, level: int) -> bytes:
        out, _carry = self.encode_with_carry(data, level, carry=None)
        return out

    def encode_with_carry(self, data: bytes, level: int,
                          carry: tuple[bytes, int] | None
                          ) -> tuple[bytes, tuple[bytes, int]]:
        """Encode whole 16 MiB blocks with explicit state across calls.

        ``carry`` is (the 131,072-byte MTF state, the level the next chunk
        is coded at) from the call before, or None at a stream's start.
        The data of every call but the last must be a multiple of
        BLOCK_SIZE_IN: a shorter piece ends its block early, which gives a
        valid stream but not the one-shot bytes.
        """
        if not 0 <= level <= 6:
            raise ValueError("level must be 0..6")
        if not data:
            state = carry if carry is not None else (
                self.mtf_state_bytes(reset=True), level)
            return b"", state
        buf = np.frombuffer(data, np.uint8)
        nblocks = (len(data) + BLOCK_SIZE_IN - 1) // BLOCK_SIZE_IN
        views = [buf[b * BLOCK_SIZE_IN: min((b + 1) * BLOCK_SIZE_IN,
                                            len(data))]
                 for b in range(nblocks)]
        # the predicted schedule: every chunk at the requested level
        predicted = np.full(_MAX_CHUNKS, level, np.int32)
        # no retry: a block's tokens are a pure function of its bytes and
        # schedule, so its one failure ("tokenize overflow") would recur
        ahead = _InFlight(
            self.tok.free, lambda v, buf: self.pool.submit(
                _PRIO_TOKENIZE, self._tokenize_block, v, len(v), predicted,
                buf), views)

        if carry is None:
            self.dll.zlt_mtf_reset(self.mtf)
            current_level = level
        else:
            self.load_mtf_state(carry[0])
            current_level = carry[1]
        snapshot = np.empty(native.STATE_BYTES, np.uint8)
        cap = self.dll.zlt_encode_bound(len(data))
        if self._out is None or self._out.size < cap:
            self._out = np.empty(cap, np.uint8)
        out = self._out
        opos = 0

        tokens = None
        try:
            for view in views:
                fut, buf = ahead.oldest()
                _, rlens, encpos, used_levels = self.pool.result_helping(
                    fut, _PRIO_ENTROPY)
                ahead.jobs.popleft()
                tokens = buf
                self.dll.zlt_mtf_save(self.mtf, snapshot.ctypes.data)
                while True:
                    # the serial carry pass: raw literals -> MTF ranks
                    rl_arr = np.ascontiguousarray(rlens, np.int32)
                    self.dll.zlt_relabel_block(
                        self.mtf, view.ctypes.data, tokens.ctypes.data,
                        rl_arr.ctypes.data, len(rl_arr))
                    # relabelled chunks are independent: entropy-code them
                    # all on the pool; checking the schedule needs only
                    # each chunk's payload size
                    jobs = []
                    tpos = 0
                    for c in range(len(rl_arr)):
                        scratch = self._take_scratch()
                        fut = self.pool.submit(
                            _PRIO_ENTROPY, self._entropy_chunk,
                            tokens, tpos, int(rl_arr[c]), scratch)
                        jobs.append((fut, scratch))
                        tpos += int(rl_arr[c])
                    try:
                        sizes, lvl, fix, drops = native.adaptive_drop(
                            used_levels[:len(jobs)], encpos, current_level,
                            level,
                            lambda c: self.pool.result_helping(
                                jobs[c][0], _PRIO_ENTROPY))
                    finally:
                        # the rest still read the token buffer
                        for fut, _scratch in jobs:
                            concurrent.futures.wait([fut])
                    if drops:
                        metrics.registry.count("enc.level_drops", drops)
                    if fix < 0:
                        for c, olen in enumerate(sizes):
                            hdr = native.chunk_header(
                                int(encpos[c]), int(rl_arr[c]), olen)
                            out[opos:opos + 13] = np.frombuffer(hdr,
                                                                np.uint8)
                            out[opos + 13:opos + 13 + olen] = \
                                jobs[c][1][:olen]
                            opos += 13 + olen
                    for _fut, scratch in jobs:
                        self.ent_free.put(scratch)
                    if fix < 0:
                        current_level = lvl
                        break
                    metrics.registry.count("enc.schedule_mispredicts")
                    # the checked prefix stays; the chunk that was wrong
                    # and the rest take the level its predecessor left
                    sched = np.full(_MAX_CHUNKS, level, np.int32)
                    sched[:fix] = used_levels[:fix]
                    sched[fix:] = lvl
                    self.dll.zlt_mtf_load(self.mtf, snapshot.ctypes.data)
                    # again, on this thread, into the block's own buffer
                    _, rlens, encpos, used_levels = self._tokenize_block(
                        view, len(view), sched, tokens)
                out[opos] = 0
                opos += 1
                metrics.registry.count("enc.blocks")
                metrics.registry.count("enc.chunks", len(rl_arr))
                self.tok.free.append(tokens)
                tokens = None
        finally:
            if tokens is not None:
                self.tok.free.append(tokens)
            ahead.drain()
        return out[:opos].tobytes(), (self.mtf_state_bytes(), current_level)

    def counters(self) -> dict[str, int]:
        """The match-loop counters of every tokenizer thread, summed (the
        reference's debug counters, src/libzling_lz.cpp:226-287; zero
        unless the engine was built with them, ``ZLT_COUNTERS=1``)."""
        buf = np.zeros(8, np.uint64)
        total = np.zeros(8, np.uint64)
        for h in self.tok.handles:
            self.dll.zlt_counters(h, buf.ctypes.data)
            total += buf
        return dict(zip(COUNTER_NAMES, (int(v) for v in total)))

    def mtf_state_bytes(self, reset: bool = False) -> bytes:
        if reset:
            self.dll.zlt_mtf_reset(self.mtf)
        buf = np.empty(native.STATE_BYTES, np.uint8)
        self.dll.zlt_mtf_save(self.mtf, buf.ctypes.data)
        return buf.tobytes()

    def load_mtf_state(self, state: bytes) -> None:
        buf = np.frombuffer(state, np.uint8)
        self.dll.zlt_mtf_load(self.mtf, buf.ctypes.data)


class ParallelDecoder:
    """Entropy decode on a pool of ``workers`` threads, the resolve on the
    calling thread in chunk order; at most ``workers + 2`` chunks in
    flight (``_InFlight``): chunk k + 4 is submitted once chunk k is
    resolved and its token buffer is back."""

    def __init__(self, workers: int = 2):
        self.dll = native._lib()
        self.workers = workers
        self.pool = ThreadPoolExecutor(workers, thread_name_prefix="zlt-ent")
        self.resolver = self.dll.zlt_resolver_new()
        self._out = None
        self._in = None
        # used by the calling thread alone
        self.tok_free = [np.empty(BLOCK_SIZE_ROLZ + 16, np.uint16)
                         for _ in range(workers + 2)]

    def close(self) -> None:
        """Stop the threads and free the native state."""
        self.pool.shutdown(wait=True)
        self.dll.zlt_resolver_free(self.resolver)
        self.resolver = None

    def _entropy_chunk(self, in_arr, off, olen, rlen, tokens):
        rc = self.dll.zlt_entropy_decode(
            in_arr.ctypes.data + off, olen, rlen, tokens.ctypes.data)
        if rc != 0:
            raise ValueError("zling: corrupt stream (entropy)")
        return tokens

    def decode(self, data: bytes) -> bytes:
        out, _carry = self.decode_with_carry(data, carry=None)
        return out

    def decode_with_carry(self, data: bytes, carry: bytes | None
                          ) -> tuple[bytes, bytes]:
        """Decode whole blocks with explicit MTF state for resume.

        ``carry`` is the 131,072-byte decode-side MTF state from the call
        before (None at a stream's start); ``data`` holds whole blocks.
        """
        if not data:
            if carry is None:
                self.dll.zlt_resolver_reset_stream(self.resolver)
            else:
                self._load_mtf(carry)
            return b"", self._save_mtf()
        # one copy of the stream with 8 zero bytes after it: the bit
        # reader reads a word at a time, up to 8 bytes past a payload
        n = len(data)
        if self._in is None or self._in.size < n + 8:
            self._in = np.empty(n + 8, np.uint8)
        in_arr = self._in
        in_arr[:n] = np.frombuffer(data, np.uint8)
        in_arr[n:n + 8] = 0
        chunks = []  # (block_id, encpos, rlen, payload_offset, olen)
        pos = 0
        block_id = 0
        block_sizes = []
        last_encpos = 0
        while pos < n:
            flag = data[pos]
            pos += 1
            if flag == 0:
                block_sizes.append(last_encpos)
                last_encpos = 0
                block_id += 1
                continue
            if flag != 1 or pos + 12 > n:
                raise ValueError("zling: corrupt stream (bad framing)")
            encpos = int.from_bytes(data[pos:pos + 4], "big")
            rlen = int.from_bytes(data[pos + 4:pos + 8], "big")
            olen = int.from_bytes(data[pos + 8:pos + 12], "big")
            pos += 12
            # encpos may not fall within a block: the block's output is
            # sized by its last chunk, which an earlier one must not pass
            if (rlen > BLOCK_SIZE_ROLZ or olen > BLOCK_SIZE_HUFFMAN
                    or encpos > BLOCK_SIZE_IN or encpos < last_encpos
                    or pos + olen > n):
                raise ValueError("zling: corrupt stream (bad chunk header)")
            chunks.append((block_id, encpos, rlen, pos, olen))
            last_encpos = encpos
            pos += olen
        if last_encpos != 0:
            raise ValueError("zling: truncated stream (missing stop flag)")
        metrics.registry.count("dec.blocks", len(block_sizes))
        metrics.registry.count("dec.chunks", len(chunks))

        total = sum(block_sizes)
        if self._out is None or self._out.size < total + SENTINEL_LEN:
            self._out = np.empty(total + SENTINEL_LEN, np.uint8)
        out = self._out
        block_base = np.cumsum([0] + block_sizes[:-1]) if block_sizes else []

        if carry is None:
            self.dll.zlt_resolver_reset_stream(self.resolver)
        else:
            self._load_mtf(carry)
        ahead = _InFlight(self.tok_free, lambda c, buf: self.pool.submit(
            self._entropy_chunk, in_arr, c[3], c[4], c[2], buf), chunks)
        cur_block = -1
        opos = 0
        try:
            for bid, encpos, rlen, _off, _ol in chunks:
                fut, tokens = ahead.oldest()
                fut.result()
                ahead.jobs.popleft()
                if bid != cur_block:
                    self.dll.zlt_resolver_reset_block(self.resolver)
                    cur_block = bid
                    opos = 0
                base = int(block_base[bid])
                opos = self.dll.zlt_resolve_chunk(
                    self.resolver, tokens.ctypes.data, rlen, encpos,
                    out.ctypes.data + base, opos)
                self.tok_free.append(tokens)
                if opos < 0:
                    raise ValueError("zling: corrupt stream (resolve)")
        finally:
            ahead.drain()
        return out[:total].tobytes(), self._save_mtf()

    def _save_mtf(self) -> bytes:
        buf = np.empty(native.STATE_BYTES, np.uint8)
        self.dll.zlt_resolver_mtf_save(self.resolver, buf.ctypes.data)
        return buf.tobytes()

    def _load_mtf(self, state: bytes) -> None:
        buf = np.frombuffer(state, np.uint8)
        self.dll.zlt_resolver_mtf_load(self.resolver, buf.ctypes.data)


def encode_groups(groups, level: int, carry: tuple[bytes, int] | None = None):
    """``ParallelEncoder.encode_with_carry`` over ``groups`` in turn (each
    but the last a multiple of BLOCK_SIZE_IN), from ``carry``: yields
    (the group's stream bytes, the carry after it) a group, as
    ``parallel.mesh.encode_groups`` does for the lanes."""
    enc = ParallelEncoder()
    try:
        for group in groups:
            part, carry = enc.encode_with_carry(group, level, carry)
            yield part, carry
    finally:
        enc.close()


def decode_spans(spans, carry: bytes | None = None):
    """``ParallelDecoder.decode_with_carry`` over ``spans`` (whole blocks
    each) in turn, from ``carry``: yields (the span's bytes, the MTF state
    after it) a span, as ``parallel.decode_mesh.decode_spans`` does."""
    dec = ParallelDecoder()
    try:
        for span in spans:
            part, carry = dec.decode_with_carry(span, carry)
            yield part, carry
    finally:
        dec.close()


_ENC: ParallelEncoder | None = None
_DEC: ParallelDecoder | None = None
# the singletons hold state (the MTF handles, the scratch buffers), so
# whole calls are serialized; each call's own threads are not affected
_ENC_LOCK = threading.Lock()
_DEC_LOCK = threading.Lock()


def encode(data: bytes, level: int = 0) -> bytes:
    global _ENC
    with _ENC_LOCK:
        if _ENC is None:
            _ENC = ParallelEncoder()
        return _ENC.encode(bytes(data), level)


def decode(data: bytes) -> bytes:
    global _DEC
    with _DEC_LOCK:
        if _DEC is None:
            _DEC = ParallelDecoder()
        return _DEC.decode(bytes(data))


def counters() -> dict[str, int]:
    """The module-level encoder's match-loop counters and the host
    metrics registry's (level drops, schedule mispredicts)."""
    out: dict[str, int] = {}
    with _ENC_LOCK:
        if _ENC is not None:
            out.update(_ENC.counters())
    out.update(metrics.registry.snapshot()["counters"])
    return out
