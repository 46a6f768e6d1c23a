"""Canonical encode, one device's run of a group's blocks at a time.

Counterpart of the per-device steps of ``libzling_tpu/parallel/mesh.py``
(``parallel_encode_step``, ``parallel_hist_step``, ``parallel_pack_step``)
and of the validation and framing of its ``_finish_group_device``.  The
lanes (``parallel/mesh.py``, ``parallel/distributed.py``) cut each group
of blocks into runs, one ``Part`` a device, and drive its stages:

  [device] ``tokenize``: K4 tokenizes every block of the run in one launch
           (one CTA per block) under the run's rows of the group's
           optimistic per-chunk level schedule;
  [device] ``relabel``: K5 relabels the run's literals from the MTF state
           handed in (the previous run's exit state) and returns its own;
  [device] ``finish``: per-chunk histograms (torch ops), then
  [host]   exact length tables (native engine, reference tie-break), then
  [device] canonical codes + bit packing (torch ops); the host gets a
           ``View`` of the chunk metadata and bit counts, and ``words``
           fetches the packed words once the schedule holds;
  [host]   ``validate`` the group's schedule against the realized chunk
           ratios (the adaptive level drop, src/libzling.cpp:261-266), in
           block order over every run; ``frame`` the container bytes.

Nothing before ``finish`` waits for the device: the inputs go through
pinned memory without blocking, K5 takes its unit counts from K4's
statistics on the device, and ``relabel`` records an event that the
device's current stream waits for before ``finish``'s stages, so that the
tokenize and relabel of a later group can be queued on a side stream
(``parallel/mesh.py::Lanes``) while this one is finished.

The streamed routes (``utils/io.py``, ``utils/checkpoint.py``) and
``device.encode`` on the host put up to ``GROUP_BLOCKS`` = 8 blocks in
each device's run.  At canonical geometry that is 128 MiB of input and
~84 MB of bucket state on a card, and the blocks of a run tokenize in
parallel; only the current group's bytes (and the next one's) are on the
devices.  ``device.encode`` on cards sizes each run from the input
(``device.one_shot_run_blocks``), so that a call is one group where the
cards hold it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .container import HEADER
from .tables import (
    HUFFMAN_MAX_LEN_1,
    HUFFMAN_MAX_LEN_2,
    MTF_NEXT,
    SENTINEL_LEN,
)
from .ops import huffman as hops
from .ops import relabel_kernel as rlk
from .ops import tokenize_kernel as tkk
from .ops.entropy_kernel import host_to
from .utils import metrics

GROUP_BLOCKS = 8


def _payload_bytes(bits: int) -> int:
    """Payload size for a bit count (whole 4-byte groups, then whole
    bytes, src/libzling.cpp:248-257)."""
    return (bits // 32) * 4 + (bits % 32 + 7) // 8


def max_chunks_of(block_size: int, max_tokens: int) -> int:
    """Chunk slots a block may need: a chunk holds >= max_tokens / 2 units
    (a unit is at most two tokens), plus one for the block's tail."""
    return max(1, -(-block_size // max(1, max_tokens // 2))) + 1


class View(NamedTuple):
    """The host's view of one run after a pass: per block its chunk count;
    per chunk its tokens, end position, payload bits, first packed word
    and code lengths; the packed words once fetched (else None)."""

    nchunks: np.ndarray       # [B]
    ntoks: np.ndarray         # [C]
    encpos: np.ndarray        # [C]
    bits: np.ndarray          # [C]
    word_off: np.ndarray      # [C]
    len1: np.ndarray          # [C, 514]
    len2: np.ndarray          # [C, 32]
    words: np.ndarray | None  # [W] 32-bit values


class Part:
    """One device's run of consecutive blocks of a group: its buffers on
    the device, and the results of its last pass."""

    def __init__(self, data: bytes, blocks, block_size: int,
                 max_tokens: int, device: torch.device):
        start = blocks[0] * block_size
        n = min(blocks[-1] * block_size + block_size, len(data)) - start
        buf = np.zeros(n + SENTINEL_LEN, np.uint8)
        buf[:n] = np.frombuffer(data, np.uint8, n, start)
        self.blocks = blocks
        self.device = device
        self.max_tokens = max_tokens
        self.n_units = n
        # a block's units lie flat from its own offset in the run's slice
        self.offs = [b * block_size - start for b in blocks]
        self.buf = host_to(buf, device)
        self.block_off = host_to(np.asarray(self.offs, np.int64), device)
        self.block_len = host_to(np.asarray(
            [min(block_size, n - o) for o in self.offs], np.int32), device)
        self.nxt = host_to(MTF_NEXT.astype(np.int32), device)

    def tokenize(self, rows: np.ndarray) -> None:
        """Launch K4 under the per-chunk level rows [blocks, max_chunks]."""
        with metrics.stage("enc.tokenize"):
            self.units, _upos, self.cstat, self.bstat = tkk.tokenize(
                self.buf, self.block_off, self.block_len, self.block_off,
                tkk.level_params(rows, self.device), self.max_tokens,
                self.n_units)
        self._view = None

    def relabel(self, state: torch.Tensor) -> torch.Tensor:
        """Launch K5 from ``state`` (on this device); returns the exit
        state.  Marks the point ``finish`` waits for."""
        with metrics.stage("enc.relabel"):
            self.relabeled, state_out = rlk.relabel(
                self.units, self.block_off, self.cstat[:, :, 0].sum(1),
                state, self.nxt)
            self.ready = None
            if self.device.type == "cuda":
                self.ready = torch.cuda.Event()
                self.ready.record()
        return state_out

    def finish(self) -> View:
        """Histograms, exact length tables and packing of the last pass;
        returns the host view without the words (computed once a pass).
        Its stages are ``metrics.stage`` spans: ``enc.gather_freqs`` (the
        statistics and histograms, fetched; within it ``enc.wait``, the
        host waiting for K4 and K5), ``enc.length_tables``,
        ``enc.pack_step`` (codes and packing) and ``enc.gather_pack_meta``
        (the bit counts and word offsets, fetched)."""
        if self._view is not None:
            return self._view
        dev = self.device
        with metrics.stage("enc.gather_freqs"):
            if self.ready is not None:
                torch.cuda.current_stream(dev).wait_event(self.ready)
            with metrics.stage("enc.wait"):
                cstat, bstat = self.cstat.cpu().numpy(), \
                    self.bstat.cpu().numpy()
            if bstat[:, 1].any():
                raise RuntimeError("tokenize: a block did not fit max_chunks")
            nchunks = bstat[:, 0].astype(np.int64)
            rows = [cstat[d, :nc] for d, nc in enumerate(nchunks)]
            nunits = np.concatenate([r[:, 0] for r in rows]).astype(np.int64)
            cnt = cstat[:, :, 0].sum(1)

            # the run's valid units in (block, chunk) order: each block's
            # chunks lie back to back from its offset
            a = torch.cat([self.relabeled[o:o + n]
                           for o, n in zip(self.offs, cnt.tolist())])
            a = a.to(torch.int64)
            C = len(nunits)
            chunk = torch.repeat_interleave(
                torch.arange(C, device=dev),
                torch.as_tensor(nunits, device=dev))
            sym = a & 1023
            idx = torch.where(((a >> 10) & 3) == 3, (a >> 14) & 4095, 0)
            freq1, freq2 = hops.unit_histograms(sym, idx, chunk, C)
            freq1, freq2 = freq1.cpu().numpy(), freq2.cpu().numpy()
        with metrics.stage("enc.length_tables"):
            len1 = hops.exact_length_tables(freq1, HUFFMAN_MAX_LEN_1)
            len2 = hops.exact_length_tables(freq2, HUFFMAN_MAX_LEN_2)
        with metrics.stage("enc.pack_step"):
            l1 = torch.as_tensor(len1.astype(np.int64), device=dev)
            l2 = torch.as_tensor(len2.astype(np.int64), device=dev)
            self.words, bits, word_off = hops.pack_units(
                sym, idx, chunk, l1,
                hops.canonical_codes(l1, HUFFMAN_MAX_LEN_1),
                l2, hops.canonical_codes(l2, HUFFMAN_MAX_LEN_2))
        with metrics.stage("enc.gather_pack_meta"):
            self._view = View(
                nchunks,
                np.concatenate([r[:, 1] for r in rows]).astype(np.int64),
                np.concatenate([r[:, 2] for r in rows]).astype(np.int64),
                bits.cpu().numpy(), word_off.cpu().numpy(), len1, len2,
                None)
        return self._view

    def view_with_words(self) -> View:
        """``finish``'s view with the packed words fetched."""
        return self.finish()._replace(words=self.words.cpu().numpy())


def validate(views, sched: np.ndarray, entry: int, level: int):
    """Serial schedule validation over a group's runs in block order
    (mesh.py:534-556): returns (exit level, whether ``sched`` [blocks,
    max_chunks] was corrected and the group must run again, the chunks
    whose coded size dropped the level after them to 0: the host
    pipeline's ``enc.level_drops``, ``native.engine.adaptive_drop``)."""
    expected = entry
    any_fix = False
    drops = 0
    row = 0
    for v in views:
        c = 0
        for nc in v.nchunks:
            prev_end = 0
            for k in range(nc):
                if int(sched[row, k]) != expected:
                    sched[row, k] = expected
                    any_fix = True
                ep = int(v.encpos[c])
                olen = HEADER + _payload_bytes(int(v.bits[c]))
                expected = 0 if olen / (ep - prev_end + 1) > 0.95 else level
                drops += expected == 0 and level != 0
                prev_end = ep
                c += 1
            sched[row, nc:] = expected
            row += 1
    return expected, any_fix, drops


def frame(views) -> bytes:
    """A group's container bytes: (0x01 chunk)* 0x00 per block."""
    out = bytearray()
    for v in views:
        c = 0
        for nc in v.nchunks:
            for _ in range(nc):
                o = int(v.word_off[c])
                nw = (int(v.bits[c]) + 31) // 32
                payload = hops.payload_from_words(
                    v.words[o:o + nw], int(v.bits[c]), v.len1[c], v.len2[c])
                out.append(1)
                out.extend(int(v.encpos[c]).to_bytes(4, "big"))
                out.extend(int(v.ntoks[c]).to_bytes(4, "big"))
                out.extend(len(payload).to_bytes(4, "big"))
                out.extend(payload)
                c += 1
            out.append(0)
    return bytes(out)
