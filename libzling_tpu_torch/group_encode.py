"""Canonical encode on one device, a group of blocks at a time.

Counterpart of the one-device subset of ``libzling_tpu/parallel/mesh.py``:
``mesh_encode`` and ``_finish_group_device`` (without ``elastic`` and
without the stage probe).  ``encode_groups(data, level, ...)`` is
byte-identical to ``spec.encode(data, level, block_size=..., max_tokens=...)``.

Per group of up to ``GROUP_BLOCKS`` blocks:

  [device] K4 tokenizes every block of the group in one launch (one CTA
           per block) under an optimistic per-chunk level schedule;
  [device] K5 relabels the literals of the whole group in one launch,
           from the MTF state carried in from the previous group;
  [device] per-chunk histograms (torch ops);
  [host]   exact length tables (native engine, reference tie-break);
  [device] canonical codes + bit packing (torch ops);
  [host]   validate the schedule against the realized chunk ratios (the
           adaptive level drop, src/libzling.cpp:261-266) and re-run the
           group from the same carried state on a mispredict; frame.

A group covers up to ``GROUP_BLOCKS`` = 8 blocks: at canonical geometry
that is 128 MiB of input and ~84 MB of bucket state on the card, and the
blocks of a group tokenize in parallel.  Only the current group's bytes
are on the device, so device memory is bounded by the group, not the
input.
"""

from __future__ import annotations

import numpy as np
import torch

from .container import HEADER
from .tables import (
    BLOCK_SIZE_IN,
    BLOCK_SIZE_ROLZ,
    HUFFMAN_MAX_LEN_1,
    HUFFMAN_MAX_LEN_2,
    LEVEL_PARAMS,
    SENTINEL_LEN,
)
from .ops import huffman as hops
from .ops import mtf as mops
from .ops import relabel_kernel as rlk
from .ops import tokenize_kernel as tkk

GROUP_BLOCKS = 8


def _payload_bytes(bits: int) -> int:
    """Payload size for a bit count (whole 4-byte groups, then whole
    bytes, src/libzling.cpp:248-257)."""
    return (bits // 32) * 4 + (bits % 32 + 7) // 8


def encode_groups(data: bytes, level: int, device,
                  block_size: int = BLOCK_SIZE_IN,
                  max_tokens: int = BLOCK_SIZE_ROLZ) -> bytes:
    """Encode ``data`` on ``device``; the canonical stream at this geometry."""
    if level not in LEVEL_PARAMS:
        raise ValueError("level must be 0..6")
    if not data:
        return b""
    max_chunks = max(1, -(-block_size // max(1, max_tokens // 2))) + 1
    nblocks = (len(data) + block_size - 1) // block_size
    state = mops.initial_state(device)
    nxt = mops.mtf_next(device)
    out = bytearray()
    current_level = level
    for g0 in range(0, nblocks, GROUP_BLOCKS):
        blocks = range(g0, min(g0 + GROUP_BLOCKS, nblocks))
        g = _Group(data, blocks, block_size, max_tokens, device)
        sched = np.full((len(blocks), max_chunks), level, np.int32)
        sched[0, 0] = entry = current_level
        while True:
            g.run(sched, state, nxt)
            current_level, any_fix = g.validate(sched, entry, level)
            if not any_fix:
                break
        out.extend(g.frame())
        state = g.state_out
    return bytes(out)


class _Group:
    """One group's device buffers and the host view of its last pass."""

    def __init__(self, data, blocks, block_size, max_tokens, device):
        start = blocks[0] * block_size
        end = min(blocks[-1] * block_size + block_size, len(data))
        buf = torch.zeros(end - start + SENTINEL_LEN, dtype=torch.uint8)
        buf[:end - start] = torch.frombuffer(bytearray(data[start:end]),
                                             dtype=torch.uint8)
        self.buf = buf.to(device)
        self.max_tokens = max_tokens
        self.device = device
        # block offsets within the group's slice; a block's units lie flat
        # from its own offset, so the two coincide
        offs = [b * block_size - start for b in blocks]
        self.block_off = torch.tensor(offs, dtype=torch.int64)
        self.block_len = torch.tensor(
            [min(block_size, end - start - o) for o in offs],
            dtype=torch.int32)
        self.n_units = end - start

    def run(self, sched, state, nxt):
        """Tokenize + relabel + histograms + tables + pack under ``sched``."""
        dev = self.device
        units, _upos, cstat, bstat = tkk.tokenize(
            self.buf, self.block_off, self.block_len, self.block_off,
            tkk.level_params(sched, dev), self.max_tokens, self.n_units)
        cstat, bstat = cstat.cpu().numpy(), bstat.cpu().numpy()
        if bstat[:, 1].any():
            raise RuntimeError("tokenize: a block did not fit max_chunks")
        self.nchunks = bstat[:, 0].astype(np.int64)
        self.nunits = [cstat[d, :nc, 0] for d, nc in enumerate(self.nchunks)]
        self.ntoks = [cstat[d, :nc, 1] for d, nc in enumerate(self.nchunks)]
        self.encpos = [cstat[d, :nc, 2] for d, nc in enumerate(self.nchunks)]
        cnt = cstat[:, :, 0].sum(1)
        units, self.state_out = rlk.relabel(
            units, self.block_off, torch.as_tensor(cnt), state, nxt)

        # the group's valid units in (block, chunk) order: each block's
        # chunks lie back to back from its offset
        a = torch.cat([units[o:o + n] for o, n in
                       zip(self.block_off.tolist(), cnt.tolist())])
        a = a.to(torch.int64)
        counts = torch.as_tensor(np.concatenate(self.nunits), device=dev)
        C = counts.shape[0]
        chunk = torch.repeat_interleave(torch.arange(C, device=dev),
                                        counts.to(torch.int64))
        sym = a & 1023
        idx = torch.where(((a >> 10) & 3) == 3, (a >> 14) & 4095, 0)

        freq1, freq2 = hops.unit_histograms(sym, idx, chunk, C)
        self.len1 = hops.exact_length_tables(freq1.cpu().numpy(),
                                             HUFFMAN_MAX_LEN_1)
        self.len2 = hops.exact_length_tables(freq2.cpu().numpy(),
                                             HUFFMAN_MAX_LEN_2)
        len1 = torch.as_tensor(self.len1.astype(np.int64), device=dev)
        len2 = torch.as_tensor(self.len2.astype(np.int64), device=dev)
        words, bits, word_off = hops.pack_units(
            sym, idx, chunk, len1, hops.canonical_codes(len1,
                                                        HUFFMAN_MAX_LEN_1),
            len2, hops.canonical_codes(len2, HUFFMAN_MAX_LEN_2))
        self.words = words.cpu().numpy()
        self.bits = bits.cpu().numpy()
        self.word_off = word_off.cpu().numpy()

    def validate(self, sched, current_level: int, level: int):
        """Serial schedule validation (mesh.py:534-556): returns (exit level,
        whether ``sched`` was corrected and the group must run again)."""
        expected = current_level
        any_fix = False
        c = 0
        for d, nc in enumerate(self.nchunks):
            prev_end = 0
            for k in range(nc):
                if int(sched[d, k]) != expected:
                    sched[d, k] = expected
                    any_fix = True
                ep = int(self.encpos[d][k])
                olen = HEADER + _payload_bytes(int(self.bits[c]))
                expected = 0 if olen / (ep - prev_end + 1) > 0.95 else level
                prev_end = ep
                c += 1
            sched[d, nc:] = expected
        return expected, any_fix

    def frame(self) -> bytes:
        """The group's container bytes: (0x01 chunk)* 0x00 per block."""
        out = bytearray()
        c = 0
        for d, nc in enumerate(self.nchunks):
            for k in range(nc):
                o = int(self.word_off[c])
                nw = (int(self.bits[c]) + 31) // 32
                payload = hops.payload_from_words(
                    self.words[o:o + nw], int(self.bits[c]), self.len1[c],
                    self.len2[c])
                out.append(1)
                out.extend(int(self.encpos[d][k]).to_bytes(4, "big"))
                out.extend(int(self.ntoks[d][k]).to_bytes(4, "big"))
                out.extend(len(payload).to_bytes(4, "big"))
                out.extend(payload)
                c += 1
            out.append(0)
        return bytes(out)
