"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line with its seconds; any failure exits non-zero):

  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. the build: every kernel of ``libzling_tpu_torch/csrc``, one nvcc per
     source, all at once;
  3. kernel == plain: K4 tokenize, K5 relabel, K3 fused decode, K1 entropy
     decode and K2 resolve on CUDA tensors against their plain PyTorch
     versions on the same inputs (exact equality), at small geometry --
     several blocks and chunks, levels 0, 4 and 6, text mixed with random
     bytes, K5 and K2 each started a second time from the first call's
     exit MTF state, and K1 + K2 on a crafted chunk whose first head byte
     is a match symbol -- then inputs aimed at K4's and K3's designs
     (``design_cases``: a run of one byte, e6 on repetitive text, matches of
     259, copies overlapping by 1..20 bytes, 40-token chunks) through K4,
     K3, K1 and K2, K3 on ``crafted_streams`` (a head-byte match symbol,
     a match without its index, corrupt tokens thousands of tokens into a
     chunk) and on ``far_match_stream`` (sources within and beyond its
     window: the match counts of its status rows), and the ``HEAD_MATCH``
     table through the fused and the split path, with each one's time
     beside the plain one's; then inputs aimed at K2's, K3's and K5's
     designs: K2 and K3 on ``resolve_cases`` (matches W - 1, W and W + 1
     bytes back, W their output window; chunk and block edges; overlapping
     copies; chunks about K2's token ring's length) and K3 on
     ``fused_cases`` (chunks about a batch and its entry ring, 259-byte
     matches at batch ends), each also with a corrupt chunk, and K5 on
     ``relabel_cases`` (a context across a tile edge, a tile of literals
     only, one without any, short ranges with gaps), K2 and K5 each from
     the initial and from a carried MTF state; then
     K1 on ``k1_cases`` (chunks over many of its segments, near-fixed-
     length codes, one-symbol tables, 1-3 tokens, a match symbol last;
     one chunk cut and flipped in its first, a middle and its last segment
     and at a segment edge), tokens and every status row;
  4. the main path at full size: a 32 MiB corpus (1 MiB of random bytes
     spliced into the middle, so the adaptive level drop fires) encoded at
     e0 through ``libzling_tpu_torch.encode`` must equal the port's own
     native engine's canonical stream, and decode back through the fused
     path (K3), the split path (``decode(fused=False)``: K1 -> K2) and the
     group path (``decode_groups``, one block a group, the MTF table
     carried across the group edge), the fused path with the matches K3
     counted and the share it read in its output window (``dec.matches``,
     ``dec.window_matches``); the same at e4 on 20 MiB (one full
     16 MiB block and a partial one).  Every count is set to 0 just before
     each path and read just after it; each kernel of the path must have
     launched.  Then each kernel again on the inputs the e0 run gave it
     (both 16 MiB blocks, 262,144-token chunks, the e0 stream) against its
     plain version (exact equality; K4's plain version on the block with
     more units, the walk that sets K4's time), timed, with the bytes it
     must move;
     K4, K3 and K2 also alone at the e4 shapes (timed, K3 with its match
     counts); K1 also at the e4 shapes
     (against its plain version) and on the e0 stream's near-fixed-length
     chunks and as many text chunks, each set alone (timed), with the
     device time of each of its four launches (torch.profiler);
  5. corrupt streams (match index 0, encpos mismatch, a match without its
     index, corrupt tokens mid-chunk) must raise ValueError through the
     fused, split and group paths on the card;
  6. the cost probes (``libzling_tpu_torch.probes``): build their library,
     hold every probe kernel to its plain version at 65,536 steps (both
     words, and the arrays the shift and index probes return), from zero
     state (the timed runs' state) and from seeded state; then, with every
     probe count at 0, the three probe modules' own measurements at their
     full loop counts (``measure_all``), one line each with ns and cycles
     a step and the SM clock they imply; every probe must have launched,
     and only the shared-memory launch one byte past the card's opt-in
     limit may be refused (and must be);
  7. the lanes (``libzling_tpu_torch.parallel``) over two device entries --
     two GPUs where the machine has them, else its one card twice, which
     measures the lanes' overhead, not their scaling: ``mesh_encode`` (one
     block a device) of a 48 MiB corpus at e0 (three blocks: the MTF chain
     crosses a device edge and a group edge, and the look-ahead runs) and
     of the 20 MiB e4 input, each stream equal to the native engine's and
     to ``encode``'s, K4 and K5 launched at least twice each, with the
     ``enc.*`` counters; ``mesh_decode`` (one block a group) of both back
     to the input, K1 at least twice a group and K2 once, then the
     phase-5 corrupt streams (ValueError);
     then ``distributed_encode`` and ``distributed_decode`` of the 32 MiB
     e0 input in two worker processes (``--lanes-worker``, gloo, one rank
     a GPU or both on the card, the kernels built by this process first,
     a time limit on both): both ranks' streams equal the engine's and
     both decodes the input.  One ``[lanes ...]`` line each, with its
     times, MB/s and launches beside the card's name and power limit;
  8. the CLI and the streamed file layer (``check_stream``): ``python -m
     libzling_tpu_torch e0 --checksum`` of the 32 MiB corpus (the
     engine's stream, zlib's adler32) and ``d`` back, ``e4`` through
     stdin/stdout on 4 MiB; ``stream_encode`` one block a group over the
     48 MiB corpus (3 groups: group edges and the look-ahead) and over its
     heavier 2-group window (blocks 1-2), each the engine's stream, the
     3-group device memory peak at most 1.1x the window's (O(group));
     ``stream_decode`` one block a span back;
     the resumable encode and decode stopped after their first checkpoint
     and resumed; the CLI's ``d`` on corrupt input (exit 1, ``error:``;
     beside ``e4``, three processes side by side).  One ``[stream ...]``
     line each, with its seconds and MB/s beside the
     card's name and power limit;
  9. the lanes' elastic recovery (``check_elastic``): ``mesh_encode(...,
     elastic=True)`` over the card, one block a group, on the 48 MiB e0
     corpus with a lost device (``DeviceLost``) injected once from
     outside the package (``PartFaults``) into group 1's ``Part.finish``
     and then into group 2's dispatch (the last group), each stream the
     engine's, one ``enc.group_failover``, the look-ahead dispatched again
     after the first, K4 and K5 launched on the card for the other groups,
     the host re-encode of the failed 16 MiB block timed; then 64 KiB at
     the small geometry and e4 (the CPU lane's route) against the CPU
     lane's stream (for the recovered group the same code, ``Part`` on the
     CPU: this run checks the carry and the card's groups) and decoded
     back to the input by the card's fused and split paths; then the same
     fault without ``elastic``, and a fault of the port's own
     (RuntimeError) with it, which must raise and count nothing.  One
     ``[elastic ...]`` line each;
  10. the fuzz: ``python -m libzling_tpu_torch.fuzz --device cuda``
     (``FUZZ_ARGS``) in a subprocess with a time limit -- a timeout, a
     non-zero exit or a dump under ``build/fuzz/smoke`` fails the smoke
     and names the last case; one ``[fuzz]`` line with its rounds, levels,
     paths, corrupt cases raised / returned and seconds;
  11. the block-parallel host pipeline (``check_pipeline``):
     ``pipeline.encode`` of phase 4's inputs equal to phase 4's streams and
     ``pipeline.decode`` back; the CLI's ``e0 --backend pipeline`` of the
     32 MiB file piped into ``d --backend pipeline`` (the engine's stream,
     the input, zlib's adler32); the resumable pair across routes over the
     48 MiB corpus, one block a group (the lanes' encode on the card
     stopped after group 0 and resumed on the pipeline, the pipeline's
     decode stopped and resumed on the lanes).  One ``[pipeline ...]``
     line each with host seconds and MB/s, the host's CPU count and the
     pipeline's workers, beside phase 4's card times;
  12. K4's schedule sweep (``check_sweep``, ``probes/sweep_tokenize.py``):
     each row's K4 output on the first 256 KiB of the 2 MiB corpus slice
     equal to its plain version, then the timed rows over the 2 MiB (one
     ``[sweep ...]`` line each: units, ms, ns a unit, the change from the
     row before) and the engine's match-loop counters at e0;
  13. the benchmark harness (``check_bench``): ``python -m
     libzling_tpu_torch.bench`` (``BENCH_ARGS``) in a subprocess with a
     time limit -- exit 0, a last JSON line with every section and
     nothing skipped; one ``[bench]`` line with its headline, host table,
     each path's MB/s and K1-K5's event times with their spreads.

A ``[per unit]`` line gives K4 (e0, e4), K3 and K2 per unit (K1 and K2 per
token -- K1 also at e4 and per chunk kind --, K5 per literal of its
busiest context) in ns and in SM cycles at the clock the long probes read.  The
second-to-last line is a JSON object with each kernel's launches in the
main path, its largest error over both comparisons, its time and its plain
version's at the main path's e0 shapes, and its bound (the bytes it must
move over 3.35 TB/s) -- and for each probe row its launches in phase 6,
its largest error, its bound, and per variant its time and cycles a step
at the full loop count and its plain version's time at ``plain_n`` steps;
the last line is ``{"ok": true, "device": {...}}``.  Launches in the
kernels line sum the in-process drives of phases 4, 7, 8, 9, 11 and 12
(and the lane workers').
The script needs one CUDA device and imports no JAX.
"""

from __future__ import annotations

import functools
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SMALL = dict(block_size=4096, max_tokens=700)
MiB = 1 << 20
HBM_BYTES_PER_S = 3.35e12      # one H100 SXM's device memory, data sheet


def phase(name: str, t0: float, detail: str = "") -> float:
    now = time.perf_counter()
    print(f"[{name}] {now - t0:.3f} s {detail}".rstrip(), flush=True)
    return now


def cuda_ms(fn, reps: int = 3, warm: bool = True) -> float:
    """Mean device time of ``fn()`` in ms (CUDA events, after a warm-up)."""
    if warm:
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(pairs) -> int:
    """Largest |kernel - plain| over paired integer tensors (0 = equal)."""
    err = 0
    for got, want in pairs:
        got, want = got.cpu(), want.cpu()
        assert got.shape == want.shape, (got.shape, want.shape)
        d = (got.to(torch.int64) - want.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def on(args, dev):
    """The tensors of an argument tuple moved to ``dev``."""
    return [a.to(dev) if torch.is_tensor(a) else a for a in args]


def check_split(dev, s, parts, row):
    """K1 then K2 over each chunk range of ``parts`` (CUDA tensors against
    the plain versions, exact equality), K2 chained: each call starts from
    the previous call's exit MTF table.  Returns the plain output bytes."""
    from libzling_tpu_torch.ops import entropy_kernel as ek
    from libzling_tpu_torch.ops import mtf as mops
    from libzling_tpu_torch.ops import resolve_kernel as rk

    table = mops.initial_table("cpu")
    out = b""
    for k, (c0, c1) in enumerate(parts):
        # every call after the first starts from a non-initial table
        assert k == 0 or not torch.equal(table, mops.initial_table("cpu"))
        k1, k2 = s.stage_split(c0, c1, "cpu")
        k1d, k2d = on(k1, dev), on(k2, dev)
        got = ek.decode_chunks(*k1d)
        t = time.perf_counter()
        want = ek.decode_chunks_plain(*k1)
        plain = (time.perf_counter() - t) * 1e3
        assert not want[1][:, 2].any()
        row("entropy_decode", max_abs_err(zip(got, want)),
            cuda_ms(lambda: ek.decode_chunks(*k1d)), plain)

        tokens, tokd, tabd = want[0], want[0].to(dev), table.to(dev)
        got = rk.resolve_stream(tokd, *k2d, tabd)
        t = time.perf_counter()
        want = rk.resolve_stream_plain(tokens, *k2, table)
        plain = (time.perf_counter() - t) * 1e3
        assert not want[1][:, 2].any()
        row("resolve", max_abs_err(zip(got, want)),
            cuda_ms(lambda: rk.resolve_stream(tokd, *k2d, tabd)), plain)
        table = want[2]
        out += want[0].numpy().tobytes()
    return out


def small_data(seed: int = 7) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon", b"zeta",
             b"theta", b"kappa", b"lambda", b"\n"]
    text = b" ".join(words[i] for i in rng.integers(0, len(words), 4000))
    noise = bytes(rng.integers(0, 256, 3000, dtype=np.uint8))
    return text[:9000] + noise + text[9000:19000]


def design_cases() -> dict:
    """Inputs aimed at K4's and K3's designs: name -> (bytes, levels,
    geometry).  A run of one byte (the lazy probe's head is the entry the
    insert just wrote; copies overlapping by one byte), e6 on repetitive
    text (depth 128, lazy 16 and 8), matches of length 259, copies
    overlapping by 1..20 bytes, and chunks of 40 tokens (the token cap lands
    inside the lazy lanes' look-ahead at pos+1 and pos+2)."""
    rng = np.random.default_rng(4)
    text = small_data()
    periods = b"".join(
        bytes(rng.integers(0, 256, p, dtype=np.uint8)) * (300 // p)
        + bytes(rng.integers(0, 256, 5, dtype=np.uint8)) for p in range(1, 21))
    block = bytes(rng.integers(0, 256, 600, dtype=np.uint8))
    return {
        "one-byte run": (b"a" * 6000 + text[:4000] + bytes(3000), (0, 4),
                         SMALL),
        "e6 repetitive text": (
            b"the quick brown fox jumps over the lazy dog. " * 300, (6,),
            SMALL),
        "matches of 259": (block * 16, (0, 6), SMALL),
        "overlapping copies": (periods, (0, 4), SMALL),
        "token cap in the look-ahead": (text[:12000], (0, 4),
                                        dict(block_size=4096, max_tokens=40)),
    }


def crafted_streams() -> dict:
    """One-chunk streams for K3's producer checks: name -> stream.  A match
    symbol as a block's first head byte (no index bits read), a last match
    without room for its index, and corrupt tokens (index 0, an unwritten
    ring slot) thousands of tokens into a chunk, which the producer has
    decoded past when the resolver meets them."""
    lits = [65 + i % 23 for i in range(3000)]
    return {
        "head-byte match symbol": chunk_stream([258, 5, 65, 66], 4),
        "match without its index": chunk_stream([65, 66, 67, 258, 1], 5, 4),
        "index 0 mid-chunk": chunk_stream(lits + [258, 0] + lits, 6004),
        "unwritten slot mid-chunk": chunk_stream(lits + [300, 4000] + lits,
                                                 6050),
    }


class TokenWriter:
    """Writes a stream's tokens by running the plain resolver on them, so
    that each match can be aimed at a chosen source distance.  ``chunks``
    collects (block, tokens, encpos)."""

    def __init__(self, size: int, seed: int):
        from libzling_tpu_torch.ops import mtf as mops
        from libzling_tpu_torch.ops import resolve_kernel as rk

        self.rng = np.random.default_rng(seed)
        self.out = bytearray(size)
        self.r = rk.Resolver(self.out, mops.initial_table("cpu"),
                             mops.mtf_next("cpu").tolist())
        self.chunks, self.base, self.block, self.toks = [], 0, -1, None
        self.units = 0      # units of the open chunk: K3's entries

    def chunk(self, new_block: bool = False):
        """Close the open chunk and open the next (a new block's two raw
        head bytes included)."""
        if self.toks:
            self.chunks.append((self.block, self.toks, self.r.opos))
        if new_block:
            self.base += self.r.opos if self.block >= 0 else 0
            self.block += 1
        self.r.start_chunk(self.base, int(new_block), 1 << 30)
        self.toks, self.units = [], 0
        if new_block:
            for b in self.rng.integers(0, 256, 2):
                self.toks.append(int(b))
                self.units += 1
                assert self.r.head_byte(int(b))

    def literals(self, n: int):
        """n literals of random bytes (each its byte's rank in its context)."""
        for b in self.rng.integers(0, 256, n).tolist():
            self.literal(b)

    def literal(self, b: int):
        ctx = self.r.l1
        rank = self.r.mtf.index(b, ctx * 256, ctx * 256 + 256) - ctx * 256
        self.toks.append(rank)
        self.units += 1
        assert self.r.simple(rank)

    def match(self, d: int, mlen: int):
        """A literal, then a match of mlen bytes from d back: the literal
        repeats the byte before the source, so that the match's context
        ring holds the source (a token start)."""
        from libzling_tpu_torch.ops.resolve_kernel import RING

        r, q = self.r, self.r.opos
        self.literal(self.out[self.base + q - d])
        ctx, src = r.l1, q + 1 - d
        row = r.ring[ctx * RING:(ctx + 1) * RING]
        midx = ((r.head[ctx] + 1) - row.index(src)) & (RING - 1)
        self.toks += [258 + mlen - 4, midx]
        self.units += 1
        assert r.match(258 + mlen - 4, midx)

    def cases(self):
        """Close the stream: (chunks, block sizes)."""
        self.chunk()
        sizes = [0] * (self.block + 1)
        for b, _, encpos in self.chunks:
            sizes[b] = encpos
        return self.chunks, sizes


def resolve_cases() -> dict:
    """Token streams aimed at K2's design: name -> (chunks, block sizes),
    chunks as (block, tokens, encpos).  Matches whose source lies W - 1, W
    and W + 1 bytes back (W: K2's output window) and further, in one chunk
    longer than the token ring; the same with chunk edges inside the block
    (the window carries over); copies that overlap themselves inside the
    window; a block edge (the window is not reset); chunks of about the
    token ring's length."""
    from libzling_tpu_torch.ops.resolve_kernel import TOKEN_RING, WINDOW

    def window_edges(split: bool):
        w = TokenWriter(WINDOW + 8000, seed=31)
        w.chunk(new_block=True)
        w.literals(WINDOW + 2000)
        for k, (d, mlen) in enumerate((
                (WINDOW - 1, 20), (WINDOW, 259), (WINDOW + 1, 5),
                (WINDOW + 1500, 33), (WINDOW, 4), (40, 70))):
            if split and k < 2:
                w.chunk()
            w.literals(min(d, 50))
            w.match(d, mlen)
        return w.cases()

    def overlaps():
        w = TokenWriter(20000, seed=32)
        w.chunk(new_block=True)
        w.literals(2000)
        for d, mlen in [(d, 3 * d + 10) for d in range(1, 21)] + [
                (3, 259), (17, 259)]:
            w.literals(d)
            w.match(d, mlen)
        return w.cases()

    def block_edge():
        w = TokenWriter(40000, seed=33)
        for _ in range(3):
            w.chunk(new_block=True)
            w.literals(5000)
            for d in (7, 300, 4999):
                w.match(d, 24)
        return w.cases()

    def ring_sized():
        w = TokenWriter(40000, seed=34)
        w.chunk(new_block=True)
        for n in (TOKEN_RING - 1, TOKEN_RING, TOKEN_RING + 1, 1, 5000):
            if n > 8:
                w.literals(n - 3 - len(w.toks))
                w.match(9, 12)
            else:
                w.literals(n - len(w.toks))
            assert len(w.toks) == n
            w.chunk()
        return w.cases()

    return {
        "window edges, one chunk": window_edges(False),
        "window edges, chunk edges in the block": window_edges(True),
        "overlapping copies in the window": overlaps(),
        "block edges": block_edge(),
        "chunks about the token ring's length": ring_sized(),
    }


def fused_cases() -> dict:
    """Token streams aimed at K3's entry ring and batches: name -> (chunks,
    block sizes), as ``resolve_cases``.  Chunks of a batch of units less
    one, of one and of one more (the chunk's end entry is then the last
    entry of the batch's piece, the first of the next, its second), of one
    unit, of two batches, and about the entry ring's length; then 259-byte
    matches at the last step of a batch and at the first of the next, their
    sources just behind them and W - 1, W, W + 1 and W + 300 bytes back (W:
    K3's output window), so that their bytes cross a flush of the window."""
    from libzling_tpu_torch.ops.decode_fused import ENTRY_RING, PIECE, WINDOW

    def sized():
        w = TokenWriter(60000, seed=35)
        w.chunk(new_block=True)
        for n in (PIECE - 1, PIECE, PIECE + 1, 1, 2 * PIECE, ENTRY_RING - 1,
                  ENTRY_RING, ENTRY_RING + 1):
            if n > 8:
                w.literals(n - 2 - w.units)
                w.match(9, 12)
            else:
                w.literals(n - w.units)
            assert w.units == n
            w.chunk()
        return w.cases()

    def batch_ends():
        w = TokenWriter(WINDOW + 9000, seed=36)
        w.chunk(new_block=True)
        w.literals(WINDOW + 2000)
        start = 0
        for k, d in enumerate((40, 100, WINDOW - 1, WINDOW, WINDOW + 1,
                               WINDOW + 300, 40, None)):
            # the match at a batch's last step (k even) or its first (odd);
            # the last one's source is the start of the match before it
            at = (w.units // PIECE + 2) * PIECE - 1 + k % 2
            w.literals(at - 1 - w.units)
            w.match(d or w.r.opos + 1 - start, 259)
            assert w.units == at + 1
            start = w.r.opos - 259
        return w.cases()

    return {
        "chunks about a batch and the entry ring": sized(),
        "long matches at batch ends": batch_ends(),
    }


def far_match_stream(level: int) -> tuple[bytes, bytes]:
    """(data, stream): ~0.5 MB of text around a segment of 150,000 random
    letters written three times, coded at ``level`` by the port's native
    engine in blocks of 256 KiB.  Matches in the first block's second copy
    of the segment take their sources 210,000 bytes back, beyond K3's
    output window; the text's take theirs within it."""
    from libzling_tpu_torch.native import engine
    from libzling_tpu_torch.ops import mtf as mops

    rng = np.random.default_rng(12)
    seg = rng.integers(97, 123, 150000, dtype=np.uint8).tobytes()
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"epsilon "]
    text = b"".join(words[i] for i in rng.integers(0, len(words), 20000))
    data = seg + text[:60000] + seg[:40000] + text + seg
    state = mops.state_to_bytes(mops.initial_state("cpu"))
    return data, engine.encode_from(data, level, state, level, 1 << 18)[0]


# A match symbol as one of a block's two raw head bytes: (tokens, encpos,
# the split decoders' bytes, the fused decoders' bytes).  The split
# decoders take its index as the next token and agree with spec.decode; the
# fused decoders never read the index bits.
HEAD_MATCH = {
    "first_byte": ([258, 5, 65, 66], 4, b"\x02\x056L", b"\x02ALL"),
    "second_byte": ([65, 258, 7, 66, 67], 5, b"A\x02rL7", b"A\x02LL7"),
}


def resolve_args(chunks, sizes, pad: int = 1):
    """K2's inputs for ``chunks`` (``resolve_cases``), ``pad`` unused tokens
    before each chunk's tokens (so the chunks start at every alignment):
    (tokens, tok_off, rlens, encpos, new_block, out_base, out_size)."""
    base = np.cumsum([0] + list(sizes))
    toks, offs = [], []
    for _, t, _ in chunks:
        toks += [999999] * pad
        offs.append(len(toks))
        toks += t
    blocks = [b for b, _, _ in chunks]
    new_block = [int(k == 0 or b != blocks[k - 1])
                 for k, b in enumerate(blocks)]
    as_t = torch.as_tensor
    return (as_t(np.asarray(toks, np.int32)), as_t(np.asarray(offs, np.int64)),
            as_t(np.asarray([len(t) for _, t, _ in chunks], np.int32)),
            as_t(np.asarray([e for _, _, e in chunks], np.int32)),
            as_t(np.asarray(new_block, np.int32)),
            as_t(base[blocks].astype(np.int64)), int(base[-1]))


def corrupt_chunk(chunks):
    """``chunks`` with two literal tokens near the middle of its middle
    chunk replaced by a match of index 0: that chunk is bad, and the rest
    are not decoded."""
    c = len(chunks) // 2
    b, toks, encpos = chunks[c]
    k = 0
    while k < len(toks) // 2 or max(toks[k:k + 2]) >= 256:
        k += 2 if toks[k] >= 258 else 1
    bad = (b, toks[:k] + [258, 0] + toks[k + 2:], encpos)
    return chunks[:c] + [bad] + chunks[c + 1:]


def relabel_cases() -> dict:
    """Units aimed at K5's tiles: name -> (units i32 [U], unit_off i64,
    unit_cnt i32).  Units are random (literal, MRU hit, match, head byte)
    words around the cases: a context whose literals straddle a tile
    edge, a tile of literals only, a tile without any, ranges shorter than
    a tile (and an empty one) with gaps between them, one context holding
    every literal."""
    from libzling_tpu_torch.ops.relabel_kernel import TILE

    rng = np.random.default_rng(41)

    def words(n, kinds=(0, 1, 1, 1, 2, 3), ctxs=None):
        kind = rng.choice(kinds, n)
        ctx = rng.integers(0, 256, n) if ctxs is None else np.full(n, ctxs)
        lit = rng.integers(0, 256, n) | (1 << 10) | (ctx << 14)
        match = rng.integers(258, 514, n) | (3 << 10) \
            | (rng.integers(1, 4096, n) << 14)
        other = rng.integers(0, 258, n) | (kind << 10)
        return np.where(kind == 1, lit, np.where(kind == 3, match, other)) \
            .astype(np.int32)

    def one_range(u):
        return (torch.as_tensor(u), torch.tensor([0], dtype=torch.int64),
                torch.tensor([len(u)], dtype=torch.int32))

    straddle = words(2 * TILE + 100)
    straddle[TILE - 40:TILE + 40] = words(80, (1,), 7)
    only = np.concatenate([words(TILE, (1,)), words(500)])
    none = np.concatenate([words(TILE), words(TILE, (0, 2, 3)), words(77)])
    lens = [100, TILE + 3, 1, 0, 2 * TILE]
    offs = np.cumsum([5] + [n + 9 for n in lens])[:-1]
    return {
        "a context across a tile edge": one_range(straddle),
        "a tile of literals only": one_range(only),
        "a tile without literals": one_range(none),
        "ranges shorter than a tile, gaps between": (
            torch.as_tensor(words(int(offs[-1] + lens[-1] + 9))),
            torch.as_tensor(offs.astype(np.int64)),
            torch.as_tensor(np.asarray(lens, np.int32))),
        "one context holds every literal": one_range(
            words(TILE + 1000, ctxs=200)),
    }


def k1_chunk(tokens, rlen: int | None = None):
    """(len1, len2, body, rlen) of one chunk holding ``tokens``, coded by
    the port's Huffman stage; its header declares ``rlen`` tokens."""
    from libzling_tpu_torch import group_decode as gd

    s = gd.parse(chunk_stream(tokens, len(tokens), rlen))
    return s.len1[0], s.len2[0], s.bodies[0], int(s.rlens[0])


K1_CASES = ("valid over many segments", "near-fixed-length codes",
            "one-symbol tables", "1-3 tokens, a match symbol last", "cut",
            "bit flips", "300 small chunks")


@functools.lru_cache(maxsize=None)
def k1_cases() -> dict:
    """Chunks aimed at K1's segments (``SEG_BITS`` bits each): name ->
    (len1 [C, 514], len2 [C, 32], bodies, rlens), each case one K1 call.
    Valid chunks over many segments (13..15-bit codes among them), near-
    fixed-length codes (the smoke's random bytes: every literal about as
    often), one-symbol alphabet-1 and alphabet-2 tables, chunks of 1-3
    tokens and a match symbol in last place (emitted alone), one chunk cut
    and flipped in its first, a middle and its last segment and exactly at
    a segment edge, and claiming more tokens than its body holds, and 300
    small chunks."""
    from libzling_tpu_torch.ops.entropy_kernel import SEG_BITS

    rng = np.random.default_rng(43)

    def units(n, match_frac, n_syms=256):
        toks = []
        for m, s, i in zip(rng.random(n) < match_frac,
                           rng.integers(0, n_syms, n).tolist(),
                           rng.integers(1, 4096, n).tolist()):
            toks += [258 + s % 256, i] if m else [s]
        return toks

    fib = [1, 1]
    while len(fib) < 16:
        fib.append(fib[-1] + fib[-2])
    # Fibonacci counts: a code tree 15 deep (13..15-bit codes take the
    # canonical tiers, not the 12-bit LUT)
    skewed = [s for s, k in enumerate(fib) for _ in range(4 * k)]

    def near_fixed(k):
        return rng.permutation(np.repeat(np.arange(256), k)).tolist()

    def case(chunks):
        len1, len2, bodies, rlens = zip(*chunks)
        return np.stack(len1), np.stack(len2), list(bodies), list(rlens)

    def flip(body, bit):
        b = bytearray(body)
        b[bit >> 3] ^= 1 << (bit & 7)
        return bytes(b)

    base = units(6000, 0.35)
    l1, l2, body, n = k1_chunk(base)
    nbits = 8 * len(body)
    mid = nbits // 2 // SEG_BITS * SEG_BITS
    assert mid >= 3 * SEG_BITS
    places = [7, mid + SEG_BITS // 3, nbits - 12, mid, mid - 1]
    last = units(5000, 0.3) + [301, 7]
    # one alphabet-2 code: a flipped index bit meets a missing code
    a1, a2, one, m = k1_chunk([65, 300, 5, 66, 301, 5] * 1000)
    small = [k1_chunk(units(k, 0.3)) for k in (1, 7, 40, 300)]
    cases = {
        "valid over many segments": case([
            k1_chunk(units(6000, 0.4)), k1_chunk(units(5000, 0.0, 64)),
            k1_chunk(rng.permutation(skewed).tolist())]),
        "near-fixed-length codes": case([
            k1_chunk(near_fixed(24)),
            k1_chunk(near_fixed(12) + [300, 9, 301, 700])]),
        "one-symbol tables": case([
            k1_chunk([65] * 20000), k1_chunk([65, 300, 5] * 2000 + [66]),
            k1_chunk([300, 5] * 3000)]),
        "1-3 tokens, a match symbol last": case([
            k1_chunk([65]), k1_chunk([65, 66]), k1_chunk([65, 300, 5], 2),
            k1_chunk([300, 5, 66], 1), k1_chunk(last, len(last) - 1)]),
        "cut": case([(l1, l2, body, n)] + [
            (l1, l2, body[:p // 8], n) for p in places]
            + [(l1, l2, body, n + 40)]),
        "bit flips": case([(l1, l2, flip(body, p), n) for p in places]
                          + [(l1, l2, flip(flip(body, mid + 1), 9), n)]
                          + [(a1, a2, flip(one, p), m) for p in (
                              9, 8 * len(one) // 2, 8 * len(one) - 3)]),
        # more chunks than the plan's tile of 256
        "300 small chunks": case(small * 75),
    }
    assert tuple(cases) == K1_CASES
    return cases


def tokenize_args(data: bytes, level: int, geom: dict, mixed: bool = False):
    """K4's inputs for ``data`` cut in blocks of ``geom``: (buf, the rest
    of ``tokenize``'s arguments); ``mixed`` puts level 0 in every block's
    second chunk."""
    from libzling_tpu_torch.ops import tokenize_kernel as tkk
    from libzling_tpu_torch.tables import SENTINEL_LEN

    bs, mt = geom["block_size"], geom["max_tokens"]
    nb = -(-len(data) // bs)
    max_chunks = -(-bs // (mt // 2)) + 2
    buf = torch.zeros(len(data) + SENTINEL_LEN, dtype=torch.uint8)
    buf[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    offs = torch.arange(nb, dtype=torch.int64) * bs
    lens = torch.clamp(len(data) - offs, max=bs).to(torch.int32)
    sched = np.full((nb, max_chunks), level)
    if mixed:
        sched[:, 1] = 0
    return buf, (offs, lens, offs, tkk.level_params(sched, "cpu"), mt,
                 len(data))


def check_designs(dev, z, row):
    """Phase 3b: K4, K3, K1 and K2 against their plain versions on
    ``design_cases`` and K3 on ``crafted_streams`` and ``far_match_stream``
    (bytes and statuses, corrupt or not); the ``HEAD_MATCH`` table through
    the fused and the split path."""
    from libzling_tpu_torch import device as zdev
    from libzling_tpu_torch import group_decode as gd
    from libzling_tpu_torch.ops import decode_fused as fk
    from libzling_tpu_torch.ops import tokenize_kernel as tkk

    def timed(name, kernel, plain):
        got = kernel()
        t = time.perf_counter()
        want = plain()
        row(name, max_abs_err(zip(got, want)), cuda_ms(kernel, 1),
            (time.perf_counter() - t) * 1e3)
        return want

    for data, levels, geom in design_cases().values():
        for level in levels:
            buf, args = tokenize_args(data, level, geom)
            bufd = buf.to(dev)
            want = timed("tokenize", lambda: tkk.tokenize(bufd, *args),
                         lambda: tkk.tokenize_plain(buf, *args))
            assert int(want[3][:, 1].max()) == 0
            stream = z.encode(data, level, device=dev, **geom)
            assert z.decode(stream, device=dev) == data
            dargs, size, _ = zdev.decode_args(stream, "cpu")
            dargs_d = on(dargs, dev)
            timed("decode_fused",
                  lambda: fk.fused_decode(*dargs_d, out_size=size),
                  lambda: fk.fused_decode_plain(*dargs, out_size=size))
            st = gd.parse(stream)
            assert check_split(dev, st, [(0, len(st.rlens))], row) == data
    far = [far_match_stream(level)[1] for level in (0, 4)]
    for stream in [*crafted_streams().values(), *far]:
        dargs, size, _ = zdev.decode_args(stream, "cpu")
        dargs_d = on(dargs, dev)
        timed("decode_fused", lambda: fk.fused_decode(*dargs_d, out_size=size),
              lambda: fk.fused_decode_plain(*dargs, out_size=size))
    for toks, encpos, split, fused in HEAD_MATCH.values():
        stream = chunk_stream(toks, encpos)
        assert z.decode(stream, device=dev) == fused
        assert z.decode(stream, device=dev, fused=False) == split


def check_edges(dev, row):
    """Phase 3c: K2 on ``resolve_cases`` (each also with a corrupt chunk)
    and K5 on ``relabel_cases`` against their plain versions, each from the
    initial MTF state and again from the first call's exit state; K3 on
    ``resolve_cases`` and ``fused_cases``, each also with a corrupt
    chunk."""
    from libzling_tpu_torch import device as zdev
    from libzling_tpu_torch.ops import decode_fused as fk
    from libzling_tpu_torch.ops import mtf as mops
    from libzling_tpu_torch.ops import relabel_kernel as rlk
    from libzling_tpu_torch.ops import resolve_kernel as rk

    def twice(name, kernel, plain, state):
        """The plain version's first result."""
        for k in range(2):
            got = kernel(state.to(dev))
            t = time.perf_counter()
            want = plain(state)
            ms = (time.perf_counter() - t) * 1e3
            row(name, max_abs_err(zip(got, want)),
                cuda_ms(lambda: kernel(state.to(dev)), 1), ms)
            first = want if k == 0 else first
            state = want[-1]
        return first

    for chunks, sizes in resolve_cases().values():
        for cs in (chunks, corrupt_chunk(chunks)):
            args = resolve_args(cs, sizes)
            argsd = on(args, dev)
            first = twice("resolve",
                          lambda tab: rk.resolve_stream(*argsd, tab),
                          lambda tab: rk.resolve_stream_plain(*args, tab),
                          mops.initial_table("cpu"))
            # the tokens were written for the initial table
            assert bool(first[1][:, 2].any()) == (cs is not chunks)
    for chunks, sizes in [*resolve_cases().values(),
                          *fused_cases().values()]:
        for cs in (chunks, corrupt_chunk(chunks)):
            dargs, size, _ = zdev.decode_args(cases_stream(cs), "cpu")
            dargs_d = on(dargs, dev)
            got = fk.fused_decode(*dargs_d, out_size=size)
            t = time.perf_counter()
            want = fk.fused_decode_plain(*dargs, out_size=size)
            ms = (time.perf_counter() - t) * 1e3
            row("decode_fused", max_abs_err(zip(got, want)),
                cuda_ms(lambda: fk.fused_decode(*dargs_d, out_size=size), 1),
                ms)
            assert bool(want[1][:, 2].any()) == (cs is not chunks)
    nxt = mops.mtf_next("cpu")
    for rargs in relabel_cases().values():
        rargs_d = on(rargs, dev)
        twice("relabel", lambda st: rlk.relabel(*rargs_d, st, nxt.to(dev)),
              lambda st: rlk.relabel_plain(*rargs, st, nxt),
              mops.initial_state("cpu"))


def check_k1(dev, row):
    """Phase 3d: K1 on ``k1_cases`` against its plain version (tokens and
    every status row, valid and corrupt chunks)."""
    from libzling_tpu_torch.ops import entropy_kernel as ek

    for name, case in k1_cases().items():
        args = ek.stage_chunks(*case, "cpu")
        args_d = on(args, dev)
        got = ek.decode_chunks(*args_d)
        t = time.perf_counter()
        want = ek.decode_chunks_plain(*args)
        plain = (time.perf_counter() - t) * 1e3
        row("entropy_decode", max_abs_err(zip(got, want)),
            cuda_ms(lambda: ek.decode_chunks(*args_d), 1), plain)
        assert bool(want[1][:, 2].any()) == (name in ("cut", "bit flips")), \
            name


def check_kernels(dev, z):
    """Phase 3: each kernel against its plain version; returns their rows."""
    from libzling_tpu_torch import device as zdev
    from libzling_tpu_torch import group_decode as gd
    from libzling_tpu_torch.ops import decode_fused as fk
    from libzling_tpu_torch.ops import mtf as mops
    from libzling_tpu_torch.ops import relabel_kernel as rlk
    from libzling_tpu_torch.ops import tokenize_kernel as tkk

    data = small_data()
    rows = {}

    def row(name, err, ms, plain_ms):
        r = rows.setdefault(name, dict(max_abs_err=0, ms=0.0, plain_ms=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms

    state = mops.initial_state("cpu")
    nxt = mops.mtf_next("cpu")
    for level in (0, 4, 6):
        # a mixed schedule in each block
        buf, args = tokenize_args(data, level, SMALL, mixed=True)
        bufd, offs, nb = buf.to(dev), args[0], len(args[0])
        got = tkk.tokenize(bufd, *args)
        t = time.perf_counter()
        want = tkk.tokenize_plain(buf, *args)
        plain = (time.perf_counter() - t) * 1e3
        assert int(want[3][:, 1].max()) == 0 and int(want[3][:, 0].max()) > 1
        row("tokenize", max_abs_err(zip(got, want)),
            cuda_ms(lambda: tkk.tokenize(bufd, *args)), plain)

        # K5 over the block's units, chained: the second call starts from
        # the first call's exit state (a non-initial MTF state)
        units, cnt = want[0], want[2][:, :, 0].sum(1)
        for k in range(2):
            rargs = (units, offs, cnt, state, nxt)
            rargs_d = [a.to(dev) for a in rargs]
            g = rlk.relabel(*rargs_d)
            t = time.perf_counter()
            w = rlk.relabel_plain(*rargs)
            plain = (time.perf_counter() - t) * 1e3
            row("relabel", max_abs_err(zip(g, w)),
                cuda_ms(lambda: rlk.relabel(*rargs_d)), plain)
            state = w[1]
        assert not torch.equal(state, mops.initial_state("cpu"))

        # K3 on this level's stream
        stream = z.encode(data, level, device=dev, **SMALL)
        dargs, _, rlens = zdev.decode_args(stream, "cpu")
        assert len(rlens) > nb
        dargs_d = [a.to(dev) for a in dargs]
        g = fk.fused_decode(*dargs_d, out_size=len(data))
        t = time.perf_counter()
        w = fk.fused_decode_plain(*dargs, out_size=len(data))
        plain = (time.perf_counter() - t) * 1e3
        assert w[0].numpy().tobytes() == data and not w[1][:, 2].any()
        row("decode_fused", max_abs_err(zip(g, w)),
            cuda_ms(lambda: fk.fused_decode(*dargs_d, out_size=len(data))),
            plain)

        # K1 + K2 on the same stream, its blocks in two calls
        st = gd.parse(stream)
        B = len(st.block_base) - 1
        parts = (st.chunks_of(0, B // 2), st.chunks_of(B // 2, B))
        assert B >= 2 and parts[0][1] > parts[0][0] + 1
        assert check_split(dev, st, parts, row) == data

    # a match symbol as the first head byte: the split path reads its index
    # as the second head byte (the JAX split decoder and spec.decode agree)
    st = gd.parse(chunk_stream([258, 5, 65, 66], 4))
    assert check_split(dev, st, [(0, 1)], row) == b"\x02\x056L"
    check_designs(dev, z, row)
    check_edges(dev, row)
    check_k1(dev, row)
    for r in rows.values():
        assert r["max_abs_err"] == 0, rows
    return rows


def k1_phases(args) -> dict:
    """Device time of each of K1's four launches on ``args`` (CUDA
    tensors), in us, a mean over three calls (torch.profiler)."""
    import re

    from torch.profiler import ProfilerActivity, profile
    from libzling_tpu_torch.ops import entropy_kernel as ek

    ek.decode_chunks(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ek.decode_chunks(*args)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"(plan|transfer|scan|write)_kernel", e.key)
        if m:
            out[m.group(1)] = e.device_time_total / 3
    return out


def check_full_size(data: bytes, stream: bytes, stream4: bytes, dev):
    """Phase 4b: each kernel on the inputs the main path gives it at 32 MiB
    e0 (two 16 MiB blocks in one group, 262,144-token chunks, the initial
    MTF state, the e0 stream; K1 and K2 as ``decode(fused=False)`` calls
    them, over every chunk of the stream) against its plain version on CPU
    copies of the same inputs (exact equality).  One launch each, timed
    with CUDA events; the plain version's host time beside it.  Returns the
    rows and the unit and token counts walked.  K1 also on the e0
    stream's near-fixed-length chunks (its random bytes) and on as many
    text chunks, each set in one call, and on the e4 stream (``stream4``)
    against its plain version."""
    from libzling_tpu_torch.tables import (BLOCK_SIZE_IN, BLOCK_SIZE_ROLZ,
                                           SENTINEL_LEN)
    from libzling_tpu_torch import device as zdev
    from libzling_tpu_torch import group_decode as gd
    from libzling_tpu_torch.ops import decode_fused as fk
    from libzling_tpu_torch.ops import entropy_kernel as ek
    from libzling_tpu_torch.ops import mtf as mops
    from libzling_tpu_torch.ops import resolve_kernel as rk
    from libzling_tpu_torch.ops import relabel_kernel as rlk
    from libzling_tpu_torch.ops import tokenize_kernel as tkk

    rows = {}

    def check(name, kernel, plain, moved):
        """One timed launch of ``kernel`` against ``plain``; ``moved(got)``
        is the bytes the function must move (inputs read once, outputs
        written once), for its bound."""
        got = []
        ms = cuda_ms(lambda: got.append(kernel()), 1, False)
        t = time.perf_counter()
        want = plain()
        plain_ms = (time.perf_counter() - t) * 1e3
        rows[name] = dict(max_abs_err=max_abs_err(zip(got[0], want)), ms=ms,
                          plain_ms=plain_ms, bytes=moved(want))
        return want

    buf = torch.zeros(len(data) + SENTINEL_LEN, dtype=torch.uint8)
    buf[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    bufd = buf.to(dev)
    nb = -(-len(data) // BLOCK_SIZE_IN)
    offs = torch.arange(nb, dtype=torch.int64) * BLOCK_SIZE_IN
    lens = torch.clamp(len(data) - offs, max=BLOCK_SIZE_IN).to(torch.int32)
    # the schedule group_encode launches at e0: level 0 in every chunk slot
    max_chunks = -(-BLOCK_SIZE_IN // (BLOCK_SIZE_ROLZ // 2)) + 1
    params = tkk.level_params(np.zeros((nb, max_chunks), np.int64), "cpu")
    args = (offs, lens, offs, params, BLOCK_SIZE_ROLZ, len(data))
    # K4 once over both blocks, as the main path launches it; its plain
    # version on the block with more units alone (the walk that sets K4's
    # time): the other block's units are held to the engine through the
    # e0 stream (phase 4) and to the plain version at small geometry
    got = []
    ms = cuda_ms(lambda: got.append(tkk.tokenize(bufd, *args)), 1, False)
    units, upos, cstat, bstat = (t.cpu() for t in got[0])
    assert not bstat[:, 1].any()
    cnt = cstat[:, :, 0].sum(1)
    b = int(cnt.argmax())
    t = time.perf_counter()
    want = tkk.tokenize_plain(buf, offs[b:b + 1], lens[b:b + 1],
                              torch.zeros(1, dtype=torch.int64),
                              params[b:b + 1], BLOCK_SIZE_ROLZ, int(lens[b]))
    plain_ms = (time.perf_counter() - t) * 1e3
    o, n = int(offs[b]), int(cnt[b])
    # K4 reads the block bytes and writes each unit and its position once
    rows["tokenize"] = dict(
        max_abs_err=max_abs_err(zip(
            (units[o:o + n], upos[o:o + n], cstat[b:b + 1], bstat[b:b + 1]),
            (want[0][:n], want[1][:n], want[2], want[3]))),
        ms=ms, plain_ms=plain_ms, plain_block=b,
        bytes=nbytes(buf, *args, cstat, bstat) + 8 * int(cnt.sum()),
        # K4's blocks run side by side: its time is its longest block's walk
        units=int(cnt.sum()), walker_units=int(cnt.max()))
    # K4 alone at the e4 main path's shapes: 20 MiB, the schedule
    # group_encode launches first at e4 (level 4 in every chunk slot)
    n4 = 20 * MiB
    args4 = (offs, torch.clamp(n4 - offs, max=BLOCK_SIZE_IN).to(torch.int32),
             offs, tkk.level_params(np.full((nb, max_chunks), 4), "cpu"),
             BLOCK_SIZE_ROLZ, n4)
    buf4 = torch.zeros(n4 + SENTINEL_LEN, dtype=torch.uint8, device=dev)
    buf4[:n4] = bufd[:n4]
    got = []
    ms = cuda_ms(lambda: got.append(tkk.tokenize(buf4, *args4)), 1, False)
    assert not got[0][3][:, 1].any()
    rows["tokenize"]["e4"] = dict(
        ms=ms, units=int(got[0][2][:, :, 0].sum()),
        walker_units=int(got[0][2][:, :, 0].sum(1).max()), bytes=n4)

    rargs = (units, offs, cnt, mops.initial_state("cpu"),
             mops.mtf_next("cpu"))
    rargs_d = [a.to(dev) for a in rargs]
    n_units = int(cnt.sum())
    check("relabel", lambda: rlk.relabel(*rargs_d),
          lambda: rlk.relabel_plain(*rargs),
          lambda w: nbytes(*rargs[1:], w[1]) + 8 * n_units)
    # K5 walks the contexts side by side: its time is its busiest context's
    # chain of literals
    valid = torch.cat([units[o:o + n] for o, n in zip(offs.tolist(),
                                                      cnt.tolist())])
    lits = (valid >> 14)[(valid >> 10) & 3 == 1] & 255
    rows["relabel"].update(literals=int(lits.numel()),
                           busiest=int(torch.bincount(lits).max()))

    dargs, size, rlens = zdev.decode_args(stream, "cpu")
    dargs_d = [a.to(dev) for a in dargs]
    out, status = check(
        "decode_fused", lambda: fk.fused_decode(*dargs_d, out_size=size),
        lambda: fk.fused_decode_plain(*dargs, out_size=size),
        lambda w: nbytes(*dargs, *w))
    assert out.numpy().tobytes() == data and not status[:, 2].any()
    rows["decode_fused"].update(matches=int(status[:, 4].sum()),
                                window_matches=int(status[:, 5].sum()))

    st = gd.parse(stream)
    k1, k2 = st.stage_split(0, len(st.rlens), "cpu")
    k1d, k2d = on(k1, dev), on(k2, dev)
    tokens, estatus = check("entropy_decode", lambda: ek.decode_chunks(*k1d),
                            lambda: ek.decode_chunks_plain(*k1),
                            lambda w: nbytes(*k1, *w))
    assert not estatus[:, 2].any()
    assert estatus[:, 0].tolist() == st.rlens.tolist()
    # K1 by chunk kind: near-fixed-length (every used alphabet-1 code within
    # 2 bits of the others: the random bytes) against text
    used = [st.len1[c][st.len1[c] > 0] for c in range(len(st.rlens))]
    fixed = [c for c, u in enumerate(used)
             if u.size >= 256 and u.max() - u.min() <= 2]
    text = [c for c in range(len(st.rlens)) if c not in fixed][:len(fixed)]
    assert fixed
    offs = k1[5].tolist()
    kinds = {}
    for kind, cs in (("near-fixed-length", fixed), ("text", text)):
        args = ek.stage_chunks(st.len1[cs], st.len2[cs],
                               [st.bodies[c] for c in cs], st.rlens[cs], "cpu")
        args_d = on(args, dev)
        got = ek.decode_chunks(*args_d)
        want = torch.cat([tokens[offs[c]:offs[c] + int(st.rlens[c])]
                          for c in cs])
        assert torch.equal(got[0].cpu(), want), kind
        assert torch.equal(got[1].cpu(), estatus[cs]), kind
        kinds[kind] = dict(chunks=cs, tokens=int(st.rlens[cs].sum()),
                           ms=cuda_ms(lambda: ek.decode_chunks(*args_d)),
                           phases_us=k1_phases(args_d))
    rows["entropy_decode"]["kinds"] = kinds
    rows["entropy_decode"]["phases_us"] = k1_phases(k1d)
    # K1 at the e4 main path's shapes
    st4 = gd.parse(stream4)
    k14, _ = st4.stage_split(0, len(st4.rlens), "cpu")
    k14_d = on(k14, dev)
    got = []
    ms = cuda_ms(lambda: got.append(ek.decode_chunks(*k14_d)), 1, False)
    want = ek.decode_chunks_plain(*k14)
    assert not want[1][:, 2].any()
    err = max_abs_err(zip(got[0], want))
    rows["entropy_decode"]["e4"] = dict(
        ms=ms, max_abs_err=err, chunks=len(st4.rlens),
        tokens=int(st4.rlens.sum()), bytes=nbytes(*k14, *want),
        phases_us=k1_phases(k14_d))
    rows["entropy_decode"]["max_abs_err"] = max(
        rows["entropy_decode"]["max_abs_err"], err)
    table = mops.initial_table("cpu")
    tokd, tabd = tokens.to(dev), table.to(dev)
    out, status, _ = check(
        "resolve", lambda: rk.resolve_stream(tokd, *k2d, tabd),
        lambda: rk.resolve_stream_plain(tokens, *k2, table),
        lambda w: nbytes(tokens, *k2, table, *w))
    assert out.numpy().tobytes() == data and not status[:, 2].any()
    # K3 and K2 at the e4 main path's shapes, each launch's bytes held to
    # the input (the plain versions are held to them at e0)
    x4 = data[:20 * MiB]
    dargs4, size4, _ = zdev.decode_args(stream4, dev)
    got = []
    ms = cuda_ms(lambda: got.append(fk.fused_decode(*dargs4, out_size=size4)),
                 1, False)
    assert got[0][0].cpu().numpy().tobytes() == x4
    status4 = got[0][1].cpu()
    assert not status4[:, 2].any()
    rows["decode_fused"]["e4"] = dict(
        ms=ms, tokens=int(status4[:, 1].sum()),
        matches=int(status4[:, 4].sum()),
        window_matches=int(status4[:, 5].sum()))
    tok4 = ek.decode_chunks(*k14_d)[0]
    _, k24 = st4.stage_split(0, len(st4.rlens), dev)
    got = []
    ms = cuda_ms(lambda: got.append(rk.resolve_stream(tok4, *k24, tabd)),
                 1, False)
    assert got[0][0].cpu().numpy().tobytes() == x4
    rows["resolve"]["e4"] = dict(ms=ms)
    for r in rows.values():
        assert r["max_abs_err"] == 0, rows
    return rows, dict(units=n_units, tokens=int(rlens.sum()),
                      chunks=len(st.rlens))


def nbytes(*ts) -> int:
    """Bytes of the tensors among ``ts``."""
    return sum(t.numel() * t.element_size() for t in ts if torch.is_tensor(t))


def chunk_stream(tokens, encpos: int, rlen: int | None = None) -> bytes:
    """One block of one chunk holding ``tokens`` (crafted test streams),
    entropy-coded with the port's own Huffman stage; its header declares
    ``rlen`` tokens (default: all of them)."""
    return chunk_bytes(tokens, encpos, rlen) + b"\x00"


def cases_stream(chunks) -> bytes:
    """The stream of (block, tokens, encpos) chunks (``resolve_cases``,
    ``fused_cases``), each chunk coded as ``chunk_stream`` codes one."""
    out = bytearray()
    for k, (b, toks, encpos) in enumerate(chunks):
        out += chunk_bytes(toks, encpos)
        if k + 1 == len(chunks) or chunks[k + 1][0] != b:
            out += b"\x00"
    return bytes(out)


def chunk_bytes(tokens, encpos: int, rlen: int | None = None) -> bytes:
    """A chunk's frame and its payload, ``tokens`` coded with the port's
    own Huffman stage; its header declares ``rlen`` tokens (default: all
    of them)."""
    from libzling_tpu_torch.tables import HUFFMAN_MAX_LEN_1, HUFFMAN_MAX_LEN_2
    from libzling_tpu_torch.ops import huffman as hops

    sym, idx, i = [], [], 0
    while i < len(tokens):
        sym.append(tokens[i])
        idx.append(tokens[i + 1] if tokens[i] >= 258 else 0)
        i += 2 if tokens[i] >= 258 else 1
    sym, idx = torch.tensor(sym), torch.tensor(idx)
    chunk = torch.zeros_like(sym)
    f1, f2 = hops.unit_histograms(sym, idx, chunk, 1)
    l1 = hops.exact_length_tables(f1.numpy(), HUFFMAN_MAX_LEN_1)
    l2 = hops.exact_length_tables(f2.numpy(), HUFFMAN_MAX_LEN_2)
    t1, t2 = torch.as_tensor(l1.astype(np.int64)), torch.as_tensor(
        l2.astype(np.int64))
    words, bits, _ = hops.pack_units(
        sym, idx, chunk, t1, hops.canonical_codes(t1, HUFFMAN_MAX_LEN_1),
        t2, hops.canonical_codes(t2, HUFFMAN_MAX_LEN_2))
    payload = hops.payload_from_words(words.numpy(), int(bits[0]), l1[0],
                                      l2[0])
    return (b"\x01" + encpos.to_bytes(4, "big")
            + (len(tokens) if rlen is None else rlen).to_bytes(4, "big")
            + len(payload).to_bytes(4, "big") + payload)


PROBE_N = 65536      # steps of the kernel == plain checks of phase 6


def probe_modules() -> dict:
    """The probe modules by name; each has ``ROWS`` (probe row -> wrapper,
    the TPU probe lines it replaces), ``SOURCE`` and ``measure_all``."""
    import importlib

    return {m: importlib.import_module(f"libzling_tpu_torch.probes.{m}")
            for m in ("tokenize_cost", "scalar_cost", "limits")}


def probe_err(got, want) -> int:
    """Largest difference over a probe's two words (and its array)."""
    if isinstance(got, tuple):
        return max(probe_err(got[0], want[0]),
                   max_abs_err([(got[1], want[1])]))
    return max(abs(got.word0 - want.word0), abs(got.word1 - want.word1))


def check_probes(dev):
    """Phase 6a: every probe kernel against its plain version at PROBE_N
    steps (exact equality), from zero state and from seeded state.
    Returns {row: dict(max_abs_err, plain=[per variant])}."""
    from libzling_tpu_torch.probes import limits as pl
    from libzling_tpu_torch.probes import scalar_cost as ps
    from libzling_tpu_torch.probes import tokenize_cost as pt

    rows = {}

    def compare(card, host):
        for (row, name, steps, kcall), (_, _, _, pcall) in zip(card, host):
            got = kcall()
            t = time.perf_counter()
            want = pcall()
            plain_ms = (time.perf_counter() - t) * 1e3
            r = rows.setdefault(row, dict(max_abs_err=0, plain={}))
            r["max_abs_err"] = max(r["max_abs_err"], probe_err(got, want))
            r["plain"].setdefault(name, dict(plain_ms=plain_ms,
                                             plain_n=steps))

    n = PROBE_N
    compare(ps.cases(n, dev), ps.cases(n, "cpu"))
    compare(ps.cases(n, dev, seed=1), ps.cases(n, "cpu", seed=1))
    compare(pt.cases(n, dev), pt.cases(n, "cpu"))
    compare(pt.cases(n, dev, seed=29), pt.cases(n, "cpu", seed=29))
    compare(pl.cases(n, dev), pl.cases(n, "cpu"))
    optin = pl.smem_optin(dev)
    compare([("PL2", f"smem {b} B", 1, lambda b=b: pl.smem_ceiling(b, dev))
             for b in pl.smem_sizes(optin)[:-1]],
            [("PL2", "", 1, lambda b=b: pl.smem_ceiling(b, "cpu"))
             for b in pl.smem_sizes(optin)[:-1]])
    try:
        pl.smem_ceiling(optin + 1, dev)
    except RuntimeError:
        pass
    else:
        raise AssertionError(f"a launch with {optin + 1} B of shared "
                             "memory was not refused")
    for row, r in rows.items():
        assert r["max_abs_err"] == 0, (row, r)
    return rows


def drive_probes(dev):
    """Phase 6b: the probe modules' own measurements at their full loop
    counts, every count at 0 just before and read just after.  Returns
    (rows by module, launches by probe row)."""
    mods = probe_modules()
    wrappers = {row: fn for mod in mods.values()
                for row, (fn, _) in mod.ROWS.items()}
    for f in wrappers.values():
        f.launches = 0
    torch.cuda.synchronize()
    out = {m: mod.measure_all(dev) for m, mod in mods.items()}
    torch.cuda.synchronize()
    launches = {row: f.launches for row, f in wrappers.items()}
    assert all(launches.values()), launches
    refused = [r for r in out["limits"] if not r["ok"]]
    assert len(refused) == 1 and refused[0] is out["limits"][-1], refused
    return out, launches


def probe_rows(checked, measured, launches):
    """The kernels-line rows of the probes."""
    variants = {}
    for rows in measured.values():
        for r in rows:
            if r.get("ok", True):
                variants.setdefault(r["row"], []).append(r)
    out = []
    for mod in probe_modules().values():
        for row, (_, replaces) in mod.ROWS.items():
            plain = checked[row]["plain"]
            vs = [dict(name=r["name"], ms=r["ms"], n=r["n"],
                       ns_per_iter=r["ns_per_iter"],
                       cycles_per_iter=r["cycles_per_iter"], ghz=r["ghz"],
                       **plain.get(r["name"], {}))
                  for r in variants[row]]
            # a probe step loads at least one 4-byte word; each launch
            # writes its three 8-byte words
            moved = sum(4 * v["n"] + 24 for v in vs)
            d = dict(name=row, route="cuda", source=mod.SOURCE,
                     replaces=replaces[0], launches=launches[row],
                     max_abs_err=checked[row]["max_abs_err"],
                     ms=sum(v["ms"] for v in vs),
                     plain_ms=sum(p["plain_ms"] for p in plain.values()),
                     bound_ms=moved / HBM_BYTES_PER_S * 1e3,
                     bound_by="bytes", library_ms=None, variants=vs)
            if replaces[1:]:
                d["also_replaces"] = ", ".join(replaces[1:])
            out.append(d)
    return out


def corpus(size: int) -> bytes:
    """``size`` bytes of ``tools/make_corpus`` text with 1 MiB of seeded
    random bytes spliced into its middle, so the adaptive level drop
    fires."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_corpus import make_corpus

    data = bytearray(make_corpus(size))
    rng = np.random.default_rng(20261016)
    mid = len(data) // 2 - MiB // 2
    data[mid:mid + MiB] = rng.integers(0, 256, MiB, dtype=np.uint8).tobytes()
    return bytes(data)


LANE_WORKER_S = 300    # the 2-process lane's workers, at most
LANES_DIR = os.path.join(REPO, "build", "lanes")


def lane_devices() -> list:
    """Phase 7's two device entries: two GPUs where the machine has them,
    else its one card twice."""
    return [torch.device("cuda", 0),
            torch.device("cuda", 1 if torch.cuda.device_count() > 1 else 0)]


def check_lanes(drive, launches: dict, engine, x32: bytes, s32: bytes,
                x20: bytes, s20: bytes, x48: bytes, s48: bytes,
                corrupt: dict, card: str) -> dict:
    """Phase 7: the lanes.  ``mesh_encode`` over two device entries (one
    block a device) on a 48 MiB e0 corpus (three blocks: the MTF chain
    crosses a device edge and a group edge, and the look-ahead runs) and
    on the 20 MiB e4 input, each stream equal to the native engine's and
    to ``encode``'s; ``mesh_decode`` (one block a group) back to the input,
    and the corrupt streams rejected; then
    ``distributed_encode`` and ``distributed_decode`` in two gloo worker
    processes on the card(s), on the 32 MiB e0 input, whose launches are
    added to ``launches`` (``drive`` adds the others').  Returns each
    lane's launches by kernel (the workers' summed)."""
    import libzling_tpu_torch as z
    from libzling_tpu_torch import parallel
    from libzling_tpu_torch.utils import metrics

    devs = lane_devices()
    assert z.encode(x48, 0) == s48, "e0 48 MiB: encode != engine"
    split = ("entropy_decode", "resolve")
    lanes = {}

    def line(name, x, sec, **kw):
        d = dict(card=card, devices=[str(d) for d in devs], bytes=len(x),
                 s=sec, MBps=len(x) / sec / 1e6, **kw)
        print(f"[lanes {name}] " + json.dumps(d), flush=True)
        lanes[name] = kw.get("launches", {})

    for tag, x, level, want in (("e0 48 MiB", x48, 0, s48),
                                ("e4 20 MiB", x20, 4, s20)):
        metrics.registry.reset()
        stream, sec, n = drive(lambda: parallel.mesh_encode(x, level, devs),
                               ("tokenize", "relabel"))
        assert stream == want, f"mesh_encode {tag} != engine / encode"
        assert n["tokenize"] >= 2 and n["relabel"] >= 2, n
        counters = metrics.registry.snapshot()["counters"]
        line(f"mesh_encode {tag}", x, sec, launches=n, counters={
            k: counters.get(k, 0) for k in ("enc.schedule_mispredicts",
                                            "enc.pipeline_redispatch")})
        blocks = -(-len(x) // (16 * MiB))
        back, sec, n = drive(lambda: parallel.mesh_decode(stream, devs), split)
        assert back == x, f"mesh_decode {tag} round trip differs"
        assert n["entropy_decode"] >= 2 * blocks and \
            n["resolve"] == blocks, n
        line(f"mesh_decode {tag}", x, sec, launches=n)
    for name, bad in corrupt.items():
        try:
            parallel.mesh_decode(bad, devs)
        except ValueError:
            continue
        raise AssertionError(f"corrupt stream {name} accepted (mesh)")

    # two processes, one rank each, gloo: the kernels are built already
    os.makedirs(LANES_DIR, exist_ok=True)
    with open(os.path.join(LANES_DIR, "data"), "wb") as f:
        f.write(x32)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        init = f"tcp://127.0.0.1:{sk.getsockname()[1]}"
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--lanes-worker", init,
         str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = []
    deadline = time.monotonic() + LANE_WORKER_S
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        raise AssertionError("a lane worker did not end within "
                             f"{LANE_WORKER_S} s:\n" + "\n".join(logs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    sec = time.perf_counter() - t
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"lane worker {r} failed:\n{log}"
        with open(os.path.join(LANES_DIR, f"rank{r}.stream"), "rb") as f:
            assert f.read() == s32, f"rank {r}: stream != engine"
        with open(os.path.join(LANES_DIR, f"rank{r}.out"), "rb") as f:
            assert f.read() == x32, f"rank {r}: decode differs"
        got = json.loads([ln for ln in log.splitlines()
                          if ln.startswith("{")][-1])
        for path in ("encode", "decode"):
            got[path]["MBps"] = len(x32) / got[path]["s"] / 1e6
        print(f"[lanes distributed rank {r}] " + json.dumps(
            dict(card=card, **got)), flush=True)
        for path in ("encode", "decode"):
            counts = lanes.setdefault(f"distributed {path}", {})
            for k, v in got[path]["launches"].items():
                counts[k] = counts.get(k, 0) + v
                launches[k] += v
    print("[lanes distributed] " + json.dumps(dict(
        card=card, ranks=2, backend="gloo", bytes=len(x32), wall_s=sec,
        same_stream_on_both_ranks=True)), flush=True)
    return lanes


STREAM_DIR = os.path.join(REPO, "build", "stream")
CLI_S = 300            # one CLI process of phase 8, at most


class _Interrupt(Exception):
    """Phase 8's stand-in for a job killed after its first checkpoint."""


def stopped_and_resumed(first, then, ckpt: str, name: str) -> None:
    """Run ``first`` (a resumable job) until its first checkpoint is
    written, as a job killed there, then ``then`` from that checkpoint;
    the checkpoint must exist between them and be gone after."""
    from libzling_tpu_torch.utils import checkpoint

    orig = checkpoint._write_ckpt

    def stop_once(*a):
        orig(*a)
        checkpoint._write_ckpt = orig
        raise _Interrupt

    checkpoint._write_ckpt = stop_once
    try:
        first()
        raise AssertionError(f"resumable {name} was not stopped")
    except _Interrupt:
        pass
    finally:
        checkpoint._write_ckpt = orig
    assert os.path.exists(ckpt), f"{name}: no checkpoint"
    then()
    assert not os.path.exists(ckpt), f"{name}: checkpoint kept"


def cli(*args, stdin: bytes | None = None):
    """``python -m libzling_tpu_torch`` with ``args``; returns (the
    completed process, its seconds)."""
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "libzling_tpu_torch", *args],
                       input=stdin, capture_output=True, cwd=REPO,
                       timeout=CLI_S)
    return r, time.perf_counter() - t


def adler_line(stderr: bytes) -> str:
    return [ln for ln in stderr.decode().splitlines()
            if ln.startswith("adler32:")][-1]


def check_stream(drive, engine, x32: bytes, s32: bytes, x48: bytes,
                 s48: bytes, card: str) -> dict:
    """Phase 8: the CLI and the streamed file layer on the card.

    ``python -m libzling_tpu_torch e0 --checksum`` of the 32 MiB corpus
    (its stream the engine's, its adler32 zlib's) and ``d`` back; ``e4``
    through stdin/stdout on 4 MiB of it; ``stream_encode`` with one block
    a group over the 48 MiB corpus (three groups: group edges and the
    look-ahead) and over its heavier window of two groups (blocks 1-2),
    each equal to the engine's stream, with the device memory peak of
    each (the 3-group peak at most 1.1x the window's: memory is
    O(group)), then ``stream_decode`` one block a span back;
    ``encode_file_resumable`` / ``decode_file_resumable`` stopped after
    their first checkpoint and resumed; the CLI's ``d`` on a truncated
    stream and on a bad flag byte (exit 1, ``error:``, no traceback), these
    two and the ``e4`` through stdin/stdout side by side.
    One ``[stream ...]`` line each, with its seconds and MB/s beside the
    card's name and power limit.  Returns each in-process drive's
    launches."""
    import io as _io
    import zlib

    from libzling_tpu_torch.utils import checkpoint
    from libzling_tpu_torch.utils import io as zio

    os.makedirs(STREAM_DIR, exist_ok=True)
    f = {k: os.path.join(STREAM_DIR, k)
         for k in ("x32", "s32", "back", "ckpt", "rs32", "rback")}
    for path in f.values():
        if os.path.exists(path):
            os.remove(path)
    with open(f["x32"], "wb") as fh:
        fh.write(x32)
    out = {}

    def line(name, n, sec, **kw):
        print(f"[stream {name}] " + json.dumps(dict(
            card=card, bytes=n, s=sec, MBps=n / sec / 1e6, **kw)),
            flush=True)
        if "launches" in kw:
            out[name] = kw["launches"]

    # 1. the CLI, file to file, e0 and back
    want_adler = f"adler32: {zlib.adler32(x32):#010x}"
    r, sec = cli("e0", f["x32"], f["s32"], "--checksum")
    assert r.returncode == 0, r.stderr.decode()[-4000:]
    with open(f["s32"], "rb") as fh:
        assert fh.read() == s32, "CLI e0 32 MiB != engine"
    assert adler_line(r.stderr) == want_adler, r.stderr.decode()[-400:]
    line("cli e0 32 MiB", len(x32), sec, process=True)
    r, sec = cli("d", f["s32"], f["back"], "--checksum")
    assert r.returncode == 0, r.stderr.decode()[-4000:]
    with open(f["back"], "rb") as fh:
        assert fh.read() == x32, "CLI d 32 MiB round trip differs"
    assert adler_line(r.stderr) == want_adler
    line("cli d 32 MiB", len(x32), sec, process=True)

    # 3, 4. the streamed encode, one block a group.  A stream's peak is
    # that of its heaviest window of two groups: a group's finish beside
    # the next group's look-ahead, and the finish's buffers grow with the
    # units a block holds (with its content: block 1 holds the random
    # MiB).  So the 3-group peak is held to its heavier window, blocks 1-2
    # (854.8 MB against blocks 0-1's 739.5 MB on an H100 80GB HBM3), run
    # as a stream of its own; a peak that grew with the stream's length
    # would exceed it
    x12 = x48[16 * MiB:]
    peaks = {}
    for tag, x, want in (("blocks 1-2", x12, engine.encode(x12, 0)),
                         ("blocks 0-2", x48, s48)):
        sink = _io.BytesIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, sec, n = drive(lambda: zio.stream_encode(
            zio.FileSource(_io.BytesIO(x)), zio.FileSink(sink), 0,
            blocks_per_device=1), ("tokenize", "relabel"))
        peaks[tag] = torch.cuda.max_memory_allocated()
        assert sink.getvalue() == want, f"stream_encode {tag} != engine"
        line(f"stream_encode e0 48 MiB corpus, {tag}", len(x), sec,
             launches=n, peak_bytes=peaks[tag])
    ratio = peaks["blocks 0-2"] / peaks["blocks 1-2"]
    print("[stream memory] " + json.dumps(dict(
        card=card, peak_bytes=peaks, ratio_to_heavier_window=ratio)),
        flush=True)
    assert ratio <= 1.1, f"device memory grows with the stream: {ratio}"
    sink = _io.BytesIO()
    _, sec, n = drive(lambda: zio.stream_decode(
        zio.FileSource(_io.BytesIO(s48)), zio.FileSink(sink),
        group_blocks=1), ("entropy_decode", "resolve"))
    assert sink.getvalue() == x48, "stream_decode 48 MiB differs"
    line("stream_decode e0 48 MiB, 1 block a span", len(x48), sec,
         launches=n)

    # 5. resume after the first checkpoint, both directions
    for name, run, want, path, n_bytes in (
            ("encode", lambda: checkpoint.encode_file_resumable(
                f["x32"], f["rs32"], 0, f["ckpt"], blocks_per_device=1),
             s32, f["rs32"], len(x32)),
            ("decode", lambda: checkpoint.decode_file_resumable(
                f["rs32"], f["rback"], f["ckpt"], group_blocks=1),
             x32, f["rback"], len(x32))):
        t = time.perf_counter()
        stopped_and_resumed(run, run, f["ckpt"], name)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        with open(path, "rb") as fh:
            assert fh.read() == want, f"resumed {name} differs"
        line(f"resumable {name} e0 32 MiB, stopped and resumed", n_bytes,
             sec)

    # 2, 6. the CLI through stdin / stdout, e4 on 4 MiB, and on corrupt
    # input: the three processes side by side
    x4 = x32[:4 * MiB]
    s4 = engine.encode(x4, 4)
    t = time.perf_counter()
    procs = {name: (args, stdin, subprocess.Popen(
        [sys.executable, "-m", "libzling_tpu_torch", *args],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, cwd=REPO))
        for name, args, stdin in (
            ("e4 4 MiB stdin/stdout", ["e4"], x4),
            ("d truncated", ["d"], s4[:-5]),
            ("d bad flag byte", ["d"], b"\x02" + s4[1:]))}
    try:
        for name, (args, stdin, p) in procs.items():
            got, err = p.communicate(stdin, timeout=CLI_S)
            err = err.decode()
            sec = time.perf_counter() - t
            if args == ["e4"]:
                assert p.returncode == 0, err[-4000:]
                assert got == s4, "CLI e4 4 MiB (stdin/stdout) != engine"
                line(f"cli {name}", len(x4), sec, process=True,
                     side_by_side=True)
                continue
            assert p.returncode == 1 and "error:" in err \
                and "Traceback" not in err, f"CLI {name}: {err[-2000:]}"
            print(f"[stream cli {name}] " + json.dumps(dict(
                card=card, rc=p.returncode, s=sec, side_by_side=True,
                error=err.strip().splitlines()[-1])), flush=True)
    finally:
        for _, _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


class PartFaults:
    """Fault injection from outside the package: wraps
    ``group_encode.Part`` so that each group named in ``faults`` fails
    once -- at its dispatch (``Part.__init__``), its K5 (``Part.relabel``)
    or its finish (``Part.finish``) -- and records the groups whose K4 and
    K5 were queued on ``device``.  A group is named by its index in
    ``data``, cut into groups of ``size`` bytes (their first 64 bytes must
    differ).  The fault raised is ``error`` (default ``DeviceLost``, a
    lost device, the one error ``elastic`` recovers; RuntimeError stands
    for a fault of the port's own kernels)."""

    def __init__(self, data: bytes, size: int, faults: dict,
                 device: torch.device, error=None):
        from libzling_tpu_torch import _build
        from libzling_tpu_torch import group_encode as ge

        self.ge, self.orig = ge, {k: getattr(ge.Part, k) for k in (
            "__init__", "finish", "tokenize", "relabel")}
        self.heads = {data[o:o + 64]: o // size
                      for o in range(0, len(data), size)}
        assert len(self.heads) == -(-len(data) // size), "groups alike"
        self.faults, self.fired = dict(faults), 0
        self.device, self.k4, self.k5 = device, [], []
        self.error = error or _build.DeviceLost

    def __enter__(self):
        f, orig = self, self.orig

        def init(part, data, *a, **k):
            part._group = f.heads.get(bytes(data[:64]))
            f.fire(part._group, "dispatch")
            orig["__init__"](part, data, *a, **k)

        def finish(part):
            f.fire(part._group, "finish")
            return orig["finish"](part)

        def tokenize(part, rows):
            if part.device == f.device:
                f.k4.append(part._group)
            return orig["tokenize"](part, rows)

        def relabel(part, state):
            f.fire(part._group, "relabel")
            if part.device == f.device:
                f.k5.append(part._group)
            return orig["relabel"](part, state)

        for k, fn in (("__init__", init), ("finish", finish),
                      ("tokenize", tokenize), ("relabel", relabel)):
            setattr(self.ge.Part, k, fn)
        return self

    def fire(self, group, where: str) -> None:
        if self.faults.get(group) == where:
            del self.faults[group]
            self.fired += 1
            raise self.error(f"injected fault: group {group} {where}")

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.ge.Part, k, fn)


def check_elastic(drive, x48: bytes, s48: bytes, xs: bytes, card: str,
                  dev: torch.device, block: int = 16 * MiB) -> dict:
    """Phase 9: ``mesh_encode(..., elastic=True)`` on the card, one entry,
    one block a group, with a lost device injected once.  The 48 MiB e0
    corpus with group 1's ``Part.finish`` failing (its look-ahead, group
    2, is dispatched again from the host's carry) and with group 2's
    dispatch failing (the last group): each stream the engine's, one
    ``enc.group_failover``, K4 and K5 queued on the card for groups 0 and
    2, and the host re-encode of the failed 16 MiB block timed; then
    ``xs`` at the small geometry (``SMALL``, level 4, so the CPU lane's
    ``Part`` route recovers) against the CPU lane's stream -- for the
    recovered group that is the code under test, so the stream is also
    decoded back to ``xs`` by the card's fused and split paths; then the same
    fault without ``elastic``, and a fault of the port's own with it,
    each of which must raise and count nothing.  One ``[elastic ...]``
    line each beside the card's name and power limit.
    Returns each drive's launches."""
    import libzling_tpu_torch as z
    from libzling_tpu_torch import parallel
    from libzling_tpu_torch.parallel import mesh as pmesh
    from libzling_tpu_torch.utils import metrics

    host = pmesh.host_encode_group
    timed = []

    def timed_host(data, *a):
        t = time.perf_counter()
        out = host(data, *a)
        timed.append((len(data), time.perf_counter() - t))
        return out

    small = dict(SMALL)
    big = dict(block_size=block)
    runs = (
        ("e0 48 MiB, group 1 finish", x48, 0, block, big, 1, "finish", s48),
        ("e0 48 MiB, group 2 dispatch (the last)", x48, 0, block, big, 2,
         "dispatch", s48),
        ("e4 64 KiB small geometry, group 1 finish", xs, 4,
         small["block_size"], small, 1, "finish",
         z.encode(xs, 4, device="cpu", **small)))
    out = {}
    pmesh.host_encode_group = timed_host
    try:
        for name, x, level, size, geom, group, where, want in runs:
            metrics.registry.reset()
            timed.clear()
            with PartFaults(x, size, {group: where}, dev) as f:
                stream, sec, n = drive(lambda: parallel.mesh_encode(
                    x, level, [dev], elastic=True, **geom),
                    ("tokenize", "relabel"))
            counters = metrics.registry.snapshot()["counters"]
            assert stream == want, f"elastic {name}: stream differs"
            decoded = []
            if geom is small:
                for path, fused in (("fused", True), ("split", False)):
                    assert z.decode(stream, fused=fused) == x, \
                        f"elastic {name}: {path} decode differs"
                    decoded.append(path)
            assert f.fired == 1 and counters.get("enc.group_failover") == 1, \
                (name, counters)
            last = -(-len(x) // size) - 1
            after = [g for g in range(last + 1) if g != group]
            assert set(after) <= set(f.k4) and set(after) <= set(f.k5), \
                (name, f.k4, f.k5)
            if where == "finish" and group < last:
                assert counters.get("enc.pipeline_redispatch", 0) >= 1
            (host_bytes, host_s), = timed
            row = dict(card=card, bytes=len(x), s=sec,
                       MBps=len(x) / sec / 1e6, host_bytes=host_bytes,
                       host_s=host_s, host_MBps=host_bytes / host_s / 1e6,
                       launches=n, k4_groups=f.k4, counters=counters,
                       decoded_on_the_card=decoded)
            print(f"[elastic {name}] " + json.dumps(row), flush=True)
            out[name] = n
    finally:
        pmesh.host_encode_group = host
    # without elastic a lost device propagates; with it, a fault of the
    # port's own (RuntimeError: a launch or kernel fault) propagates too
    for name, error, elastic in (("elastic off, group 1 finish", None,
                                  False),
                                 ("elastic on, kernel fault in group 1 "
                                  "finish", RuntimeError, True)):
        metrics.registry.reset()
        with PartFaults(xs, small["block_size"], {1: "finish"}, dev, error):
            try:
                parallel.mesh_encode(xs, 4, [dev], elastic=elastic, **small)
                raise AssertionError(f"{name}: the fault did not raise")
            except RuntimeError as e:
                assert "injected fault" in str(e), e
        assert metrics.registry.snapshot()["counters"].get(
            "enc.group_failover", 0) == 0
        print(f"[{name}] " + json.dumps(dict(
            card=card, raised=True, group_failover=0)), flush=True)
    return out


FUZZ_DIR = os.path.join(REPO, "build", "fuzz", "smoke")
FUZZ_S = 300           # phase 10's fuzz process, at most
FUZZ_ARGS = ["--rounds", "20", "--max-size", "262144", "--seed", "0"]


def check_fuzz(card: str) -> dict:
    """Phase 10: ``python -m libzling_tpu_torch.fuzz --device cuda`` in a
    subprocess with a time limit (``FUZZ_ARGS``; dumps under
    ``build/fuzz/smoke``).  A timeout, a non-zero exit or a dump fails;
    the last case line names the case.  Returns its summary."""
    import shutil

    shutil.rmtree(FUZZ_DIR, ignore_errors=True)
    t = time.perf_counter()
    try:
        r = subprocess.run(
            [sys.executable, "-m", "libzling_tpu_torch.fuzz", "--device",
             "cuda", *FUZZ_ARGS, "--dump-dir", FUZZ_DIR],
            capture_output=True, text=True, cwd=REPO, timeout=FUZZ_S)
    except subprocess.TimeoutExpired as e:
        cases = [ln for ln in (e.stdout or b"").decode().splitlines()
                 if ln.startswith("[case]")]
        raise AssertionError(f"the fuzz did not end within {FUZZ_S} s; "
                             f"last case: {cases[-1:]}")
    sec = time.perf_counter() - t
    lines = r.stdout.splitlines()
    cases = [ln for ln in lines if ln.startswith("[case]")]
    assert r.returncode == 0 and not os.path.exists(FUZZ_DIR), (
        f"fuzz rc {r.returncode}, last case {cases[-1:]}:\n"
        + r.stderr[-4000:])
    got = json.loads(lines[-1])
    print("[fuzz] " + json.dumps(dict(
        card=card, args=FUZZ_ARGS, rounds=got["rounds"], cases=got["cases"],
        levels=got["levels"], styles=got["styles"], paths=got["paths"],
        corrupt=got["corrupt"], fuzz_s=got["seconds"], wall_s=sec)),
        flush=True)
    return got


PIPE_DIR = os.path.join(REPO, "build", "pipeline")
PIPE_CLI_S = 300       # phase 11's CLI pair, at most


def check_pipeline(drive, x32: bytes, s32: bytes, x20: bytes, s20: bytes,
                   x48: bytes, s48: bytes, main_times: dict,
                   card: str) -> dict:
    """Phase 11: the block-parallel host pipeline (``pipeline.py``).

    ``pipeline.encode`` of phase 4's 32 MiB e0 and 20 MiB e4 inputs must
    give phase 4's streams (the card's, the engine's) and
    ``pipeline.decode`` the inputs back; ``python -m libzling_tpu_torch
    e0 --backend pipeline --checksum`` of the 32 MiB file piped into ``d
    --backend pipeline --checksum`` (two processes side by side): the
    engine's stream, the input, zlib's adler32 on both sides; a resumable
    job over the 48 MiB corpus, one block a group, crossing routes: the
    lanes' encode on the card stopped after its first group and resumed
    on the pipeline, then the pipeline's decode stopped after its first
    block and resumed on the lanes.  One ``[pipeline ...]`` line each:
    host seconds and MB/s, measured on the host of the machine with the
    card, with its CPU count and the pipeline's workers, beside phase 4's
    card times for the same input.  Returns the lanes' launches."""
    import zlib

    from libzling_tpu_torch import pipeline
    from libzling_tpu_torch.utils import checkpoint
    from libzling_tpu_torch.utils import metrics

    def line(name, n, sec, **kw):
        print(f"[pipeline {name}] " + json.dumps(dict(
            card=card, host_measured="on the host of the machine with the "
            "card", cpus=os.cpu_count(), workers=pipeline._ENC.workers,
            bytes=n, s=sec, MBps=n / sec / 1e6, **kw)), flush=True)

    for level, x, want in ((0, x32, s32), (4, x20, s20)):
        metrics.registry.reset()
        t = time.perf_counter()
        stream = pipeline.encode(x, level)
        sec = time.perf_counter() - t
        assert stream == want, f"pipeline e{level}: stream != engine / card"
        card_s = main_times[level]
        line(f"encode e{level}", len(x), sec,
             card_encode_s=card_s["encode"]["s"],
             counters=pipeline.counters())
        t = time.perf_counter()
        back = pipeline.decode(stream)
        sec = time.perf_counter() - t
        assert back == x, f"pipeline e{level}: decode differs"
        line(f"decode e{level}", len(x), sec, card_decode_s={
            k: card_s[k]["s"] for k in ("fused", "split", "groups")})

    os.makedirs(PIPE_DIR, exist_ok=True)
    f = {k: os.path.join(PIPE_DIR, k)
         for k in ("x32", "s32", "back", "e.err", "d.err", "x48", "rs48",
                   "rback48", "ckpt")}
    for path in f.values():
        if os.path.exists(path):
            os.remove(path)
    with open(f["x32"], "wb") as fh:
        fh.write(x32)
    with open(f["x48"], "wb") as fh:
        fh.write(x48)

    # the CLI: e0 piped into d, both on the pipeline
    pm = f"{sys.executable} -m libzling_tpu_torch"
    t = time.perf_counter()
    r = subprocess.run(
        ["bash", "-c", "set -o pipefail; "
         f"{pm} e0 {f['x32']} --backend pipeline --checksum 2>{f['e.err']}"
         f" | tee {f['s32']} | {pm} d --backend pipeline --checksum "
         f">{f['back']} 2>{f['d.err']}"],
        cwd=REPO, timeout=PIPE_CLI_S, capture_output=True)
    sec = time.perf_counter() - t
    errs = {k: open(f[k], "rb").read() for k in ("e.err", "d.err")}
    assert r.returncode == 0, (r.returncode, errs)
    with open(f["s32"], "rb") as fh:
        assert fh.read() == s32, "CLI e0 --backend pipeline != engine"
    with open(f["back"], "rb") as fh:
        assert fh.read() == x32, "CLI d --backend pipeline differs"
    want_adler = f"adler32: {zlib.adler32(x32):#010x}"
    assert adler_line(errs["e.err"]) == adler_line(errs["d.err"]) \
        == want_adler, errs
    line("cli e0 | d 32 MiB", len(x32), sec, process=True,
         adler32=want_adler.split()[1])

    # a resumable job across routes, one block a group
    def encode_across():
        stopped_and_resumed(
            lambda: checkpoint.encode_file_resumable(
                f["x48"], f["rs48"], 0, f["ckpt"], blocks_per_device=1),
            lambda: checkpoint.encode_file_resumable(
                f["x48"], f["rs48"], 0, f["ckpt"], route="pipeline"),
            f["ckpt"], "encode, lanes then pipeline")

    def decode_across():
        stopped_and_resumed(
            lambda: checkpoint.decode_file_resumable(
                f["rs48"], f["rback48"], f["ckpt"], group_blocks=1,
                route="pipeline"),
            lambda: checkpoint.decode_file_resumable(
                f["rs48"], f["rback48"], f["ckpt"], group_blocks=1),
            f["ckpt"], "decode, pipeline then lanes")

    out = {}
    for name, run, want, path, kernels in (
            ("encode: lanes (card), then pipeline", encode_across, s48,
             f["rs48"], ("tokenize", "relabel")),
            ("decode: pipeline, then lanes (card)", decode_across, x48,
             f["rback48"], ("entropy_decode", "resolve"))):
        _, sec, n = drive(run, kernels)
        with open(path, "rb") as fh:
            assert fh.read() == want, f"resumed {name} differs"
        line(f"resumable {name}, e0 48 MiB, stopped after group 0",
             len(x48), sec, launches=n)
        out[name] = n
    return out


SWEEP_REPS = 2         # phase 12's timed launches a row, after a warm one


def check_sweep(drive, dev, card: str) -> dict:
    """Phase 12: K4's schedule sweep (``probes/sweep_tokenize.py``).  Each
    row's K4 output on the slice's first 256 KiB against its plain version
    (exact equality: d1, d2 and d3 are schedules no level reaches), then
    the timed sweep over the 2 MiB corpus slice (best of ``SWEEP_REPS``
    launches a row), counted, one ``[sweep ...]`` line a row, and the engine's match-loop counters over the same
    slice at e0.  Returns the launches and the largest error."""
    from libzling_tpu_torch.ops import tokenize_kernel as tkk
    from libzling_tpu_torch.probes import sweep_tokenize as sw

    data = sw.corpus_slice(2 * MiB)
    head = data[:256 << 10]
    errs = {}
    for name, sched in sw.ROWS:
        got = tkk.tokenize(*sw.k4_args(head, sched, dev))
        want = tkk.tokenize_plain(*sw.k4_args(head, sched, "cpu"))
        errs[name] = max_abs_err(zip(got, want))
    print("[sweep kernel==plain, 256 KiB] " + json.dumps(errs), flush=True)
    assert not any(errs.values()), errs
    rows, sec, n = drive(lambda: sw.sweep(data, dev, SWEEP_REPS),
                         ("tokenize",))
    for r in rows:
        print(f"[sweep {r['row']}] " + json.dumps(dict(card=card, **r)),
              flush=True)
    counts = sw.engine_counters(data)
    nu = rows[2]["units"]
    print("[sweep e0 engine counters] " + json.dumps(dict(
        bytes=len(data), units=nu, counts=counts,
        per_unit={k: v / nu for k, v in counts.items()})), flush=True)
    return dict(launches=n, max_abs_err=max(errs.values()), s=sec)


BENCH_S = 240          # phase 13's harness process, at most
# --host-mb 17: the host input holds a whole 16 MiB block, so the harness
# gates e6 < e5
BENCH_ARGS = ["--host-mb", "17", "--device-mb", "16", "--literal-mb", "2",
              "--repeats", "2"]


def check_bench(card: str) -> dict:
    """Phase 13: ``python -m libzling_tpu_torch.bench`` (``BENCH_ARGS``)
    in a subprocess with a time limit.  A timeout or a non-zero exit
    fails; its last line must hold every section and skip none.  One
    ``[bench]`` line: the headline and host table, each card path's MB/s
    and K1-K5's CUDA-event ms ({n, min, median}), beside the card's name
    and power limit.  Returns a summary."""
    from libzling_tpu_torch import bench

    t = time.perf_counter()
    try:
        r = subprocess.run(
            [sys.executable, "-m", "libzling_tpu_torch.bench", *BENCH_ARGS],
            capture_output=True, text=True, cwd=REPO, timeout=BENCH_S)
    except subprocess.TimeoutExpired as e:
        err = (e.stderr or b"").decode()[-2000:]
        raise AssertionError(f"the bench did not end within {BENCH_S} s:\n"
                             f"{err}")
    sec = time.perf_counter() - t
    assert r.returncode == 0, (r.returncode, r.stderr[-4000:])
    got = json.loads(r.stdout.splitlines()[-1])
    d = got["detail"]
    c = d["cuda"]
    assert not d["skipped"] and set(bench.SECTIONS) <= set(c), \
        (d["skipped"], sorted(c))
    assert d["machine"]["card"] == card and "native" in d["counters"], d
    dec, api = c["decode"], c["encode_api"]
    row = dict(
        card=card, s=sec, args=BENCH_ARGS, headline=got["value"],
        corpus=d["corpus"]["sha256"][:16],
        host={k: dict(enc=v["enc_mbps"], dec=v["dec_mbps"],
                      bytes=v["bytes"]) for k, v in d["levels"].items()},
        counters_on_enc=d["counters_on_enc_mbps_e0"],
        decode_mbps={p: dec[p]["mbps"] for p in ("fused", "split",
                                                 "groups")},
        literal_k3_mbps=dec["literal"]["mbps"], encode_mbps=api["mbps"],
        kernel_ms=dict(
            tokenize_2MiB=c["tokenize"]["kernel_ms"],
            tokenize=api["kernel_ms"]["tokenize"],
            relabel=api["kernel_ms"]["relabel"],
            decode_fused=dec["fused"]["kernel_ms"]["decode_fused"],
            entropy_decode=dec["split"]["kernel_ms"]["entropy_decode"],
            resolve=dec["split"]["kernel_ms"]["resolve"]))
    print("[bench] " + json.dumps(row), flush=True)
    return dict(s=sec, headline=got["value"])


def lanes_worker(init: str, rank: str) -> int:
    """One rank of phase 7's 2-process lane (``--lanes-worker``): encode and
    decode the 32 MiB input with ``distributed_encode`` and
    ``distributed_decode`` on GPU rank mod the GPUs, gloo between the
    ranks; writes its stream and output under ``build/lanes`` and prints
    its times and launch counts as the last line."""
    import datetime

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from libzling_tpu_torch import parallel
    from libzling_tpu_torch.ops import entropy_kernel as ek
    from libzling_tpu_torch.ops import relabel_kernel as rlk
    from libzling_tpu_torch.ops import resolve_kernel as rk
    from libzling_tpu_torch.ops import tokenize_kernel as tkk

    r = int(rank)
    assert parallel.init_distributed(init, 2, r, backend="gloo",
                                     timeout=datetime.timedelta(seconds=120))
    dev = torch.device("cuda", r % torch.cuda.device_count())
    with open(os.path.join(LANES_DIR, "data"), "rb") as f:
        x = f.read()
    kernels = {"tokenize": tkk.tokenize, "relabel": rlk.relabel,
               "entropy_decode": ek.decode_chunks,
               "resolve": rk.resolve_stream}
    res = {}
    for path, fn, want in (
            ("encode", lambda: parallel.distributed_encode(x, 0, device=dev),
             ("tokenize", "relabel")),
            ("decode", lambda: parallel.distributed_decode(res["encode"],
                                                          device=dev),
             ("entropy_decode", "resolve"))):
        for f in kernels.values():
            f.launches = 0
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        res[path] = fn()
        torch.cuda.synchronize(dev)
        res[path + "_stat"] = dict(
            s=time.perf_counter() - t,
            launches={k: kernels[k].launches for k in want})
        assert all(res[path + "_stat"]["launches"].values()), res
    for name, key in (("stream", "encode"), ("out", "decode")):
        with open(os.path.join(LANES_DIR, f"rank{r}.{name}"), "wb") as f:
            f.write(res[key])
    import torch.distributed as dist

    dist.destroy_process_group()
    print(json.dumps(dict(rank=r, device=str(dev), bytes=len(x),
                          stream=len(res["encode"]),
                          encode=res["encode_stat"],
                          decode=res["decode_stat"])), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    t0 = phase("card", t0, f"torch {torch.__version__} cuda "
               f"{torch.version.cuda} device {kind!r} "
               f"count {torch.cuda.device_count()}")

    import libzling_tpu_torch as z
    from libzling_tpu_torch import _build
    from libzling_tpu_torch.ops import decode_fused as fk
    from libzling_tpu_torch.ops import entropy_kernel as ek
    from libzling_tpu_torch.ops import relabel_kernel as rlk
    from libzling_tpu_torch.ops import resolve_kernel as rk
    from libzling_tpu_torch.ops import tokenize_kernel as tkk

    _build.lib()
    t0 = phase("build", t0, f"nvcc {' '.join(_build.NVCC_FLAGS)}")

    rows = check_kernels(dev, z)
    t0 = phase("kernel==plain", t0, json.dumps(rows))

    # ---- 4. the main path at full size
    from libzling_tpu_torch.native import engine
    from libzling_tpu_torch.utils import metrics

    data = corpus(32 * MiB)
    t0 = phase("corpus", t0, f"{len(data)} bytes")

    kernels = {"tokenize": tkk.tokenize, "relabel": rlk.relabel,
               "decode_fused": fk.fused_decode,
               "entropy_decode": ek.decode_chunks,
               "resolve": rk.resolve_stream}
    launches = dict.fromkeys(kernels, 0)

    def drive(fn, want):
        """Run one path with every count at 0; each kernel of ``want`` must
        launch.  Returns (its result, seconds, the counts of ``want``)."""
        for f in kernels.values():
            f.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        counts = {k: kernels[k].launches for k in want}
        assert all(counts.values()), counts
        for k, n in counts.items():
            launches[k] += n
        return out, sec, counts

    split = ("entropy_decode", "resolve")
    streams, main_times = {}, {}
    for level, size in ((0, 32 * MiB), (4, 20 * MiB)):
        x = data[:size]
        stream, enc_s, enc_n = drive(lambda: z.encode(x, level),
                                     ("tokenize", "relabel"))
        assert stream == engine.encode(x, level), f"e{level} stream differs"
        streams[level] = stream
        paths = {
            "fused": (lambda: z.decode(stream), ("decode_fused",)),
            "split": (lambda: z.decode(stream, fused=False), split),
            "groups": (lambda: z.decode_groups(stream, group_blocks=1),
                       split),
        }
        times = dict(encode=dict(s=enc_s, MBps=len(x) / enc_s / 1e6,
                                 launches=enc_n))
        for name, (fn, want) in paths.items():
            before = metrics.registry.snapshot()["counters"]
            back, sec, n = drive(fn, want)
            assert back == x, f"e{level} {name} round trip differs"
            times[name] = dict(s=sec, MBps=len(x) / sec / 1e6, launches=n)
            if name == "fused":   # K3's matches; those it read in its window
                after = metrics.registry.snapshot()["counters"]
                m, w = (after.get(k, 0) - before.get(k, 0)
                        for k in ("dec.matches", "dec.window_matches"))
                times[name].update(matches=m, window_matches=w,
                                   window_share=w / m)
        main_times[level] = times
        t0 = phase(f"main e{level}", t0, json.dumps(dict(
            bytes=len(x), stream=len(stream), ratio=len(stream) / len(x),
            blocks=-(-len(x) // (16 * MiB)), canonical=True, round_trip=True,
            **times)))
    full, walked = check_full_size(data, streams[0], streams[4], dev)
    t0 = phase("kernel==plain at e0 full size", t0,
               json.dumps(dict(full, **walked)))

    # ---- 5. corrupt streams through the CUDA paths
    decoders = (z.decode, lambda d: z.decode(d, fused=False),
                lambda d: z.decode_groups(d, group_blocks=1))
    corrupt = {name: s for name, s in crafted_streams().items()
               if name != "head-byte match symbol"}
    corrupt["matchidx_zero"] = chunk_stream([65, 66, 258, 0], 6)
    corrupt["encpos_mismatch"] = chunk_stream([65, 66, 67], 9)
    for name, bad in corrupt.items():
        for path, dec in zip(("fused", "split", "groups"), decoders):
            try:
                dec(bad)
            except ValueError:
                continue
            raise AssertionError(f"corrupt stream {name} accepted ({path})")
    t0 = phase("corrupt", t0, "rejected by the fused, split and group "
               "paths: " + ", ".join(corrupt))

    # ---- 6. the cost probes
    t = time.perf_counter()
    _build.probes_lib()
    t0 = phase("probes: build", t0, f"{time.perf_counter() - t:.1f} s")
    checked = check_probes(dev)
    t0 = phase("probes: kernel==plain", t0, json.dumps(
        {row: r["max_abs_err"] for row, r in checked.items()}))
    measured, probe_launches = drive_probes(dev)
    for m, rows_m in measured.items():
        print(f"[probes {m}] " + json.dumps([
            dict(row=r["row"], name=r["name"], ok=r["ok"],
                 error=r["error"]) if not r.get("ok", True) else
            dict(row=r["row"], name=r["name"], n=r["n"],
                 ns=round(r["ns_per_iter"], 3),
                 cyc=round(r["cycles_per_iter"], 2), ghz=round(r["ghz"], 4))
            for r in rows_m]), flush=True)
    t0 = phase("probes: measured", t0, json.dumps(probe_launches))

    # ---- 7. the lanes over two device entries and two processes
    x48 = corpus(48 * MiB)
    s48 = engine.encode(x48, 0)
    lanes = check_lanes(drive, launches, engine, data, streams[0],
                        data[:20 * MiB], streams[4], x48, s48, corrupt, card)
    t0 = phase("lanes", t0, json.dumps(lanes))

    # ---- 8. the CLI and the streamed file layer
    streamed = check_stream(drive, engine, data, streams[0], x48, s48, card)
    t0 = phase("stream", t0, json.dumps(streamed))

    # ---- 9. the lanes' elastic recovery
    # 64 KiB for the small geometry: text, 8 KiB of the corpus's random
    # bytes, text
    xs = x48[:40960] + x48[24 * MiB:24 * MiB + 8192] + x48[40960:57344]
    recovered = check_elastic(drive, x48, s48, xs, card, dev)
    t0 = phase("elastic", t0, json.dumps(recovered))

    # ---- 10. the fuzz, in a process of its own
    fuzzed = check_fuzz(card)
    t0 = phase("fuzz", t0, json.dumps(dict(
        rounds=fuzzed["rounds"], cases=fuzzed["cases"])))

    # ---- 11. the block-parallel host pipeline
    piped = check_pipeline(drive, data, streams[0], data[:20 * MiB],
                           streams[4], x48, s48, main_times, card)
    t0 = phase("pipeline", t0, json.dumps(piped))

    # ---- 12. K4's schedule sweep
    swept = check_sweep(drive, dev, card)
    t0 = phase("sweep", t0, json.dumps(swept))

    # ---- 13. the benchmark harness, in a process of its own
    benched = check_bench(card)
    t0 = phase("bench", t0, json.dumps(benched))

    assert "jax" not in sys.modules
    csrc = "libzling_tpu_torch/csrc/"
    info = {
        "tokenize": ("tokenize.cu",
                     "libzling_tpu/ops/tokenize_kernel.py:71"),
        "relabel": ("relabel.cu", "libzling_tpu/ops/relabel_kernel.py:69"),
        "decode_fused": ("decode_fused.cu",
                         "libzling_tpu/ops/decode_fused.py:43"),
        "entropy_decode": ("entropy_decode.cu",
                           "libzling_tpu/ops/entropy_kernel.py:190"),
        "resolve": ("resolve.cu", "libzling_tpu/ops/resolve_kernel.py:63"),
    }
    # per unit, in ns and in SM cycles: the clock the long probes read
    # (clock64() cycles over event time, median of the probes of >= 1 ms);
    # K4 per unit of its longest block, whose walk sets its time
    ghz = float(np.median([r["ghz"] for rows_m in measured.values()
                           for r in rows_m if r.get("ok", True)
                           and r["ms"] >= 1.0]))
    k4, k4e4 = full["tokenize"], full["tokenize"]["e4"]
    k1 = full["entropy_decode"]
    per_unit = {
        "sm_ghz": ghz,
        "tokenize e0": k4["ms"] * 1e6 / k4["walker_units"],
        "tokenize e4": k4e4["ms"] * 1e6 / k4e4["walker_units"],
        "decode_fused e0": full["decode_fused"]["ms"] * 1e6 / walked["units"],
        "entropy_decode e0 (a token)": k1["ms"] * 1e6 / walked["tokens"],
        "entropy_decode e4 (a token)": k1["e4"]["ms"] * 1e6
        / k1["e4"]["tokens"],
        **{f"entropy_decode e0, {kind} chunks alone (a token)":
           r["ms"] * 1e6 / r["tokens"] for kind, r in k1["kinds"].items()},
        "resolve e0 (a token)": full["resolve"]["ms"] * 1e6 / walked["tokens"],
        "relabel e0 (a literal of the busiest context)":
            full["relabel"]["ms"] * 1e6 / full["relabel"]["busiest"],
    }
    print("[per unit] " + json.dumps({
        k: v if k == "sm_ghz" else dict(ns=v, cycles=v * ghz)
        for k, v in per_unit.items()}), flush=True)

    # times at the main path's shapes; the error over both comparisons; the
    # bound: the bytes each function must move over 3.35 TB/s (no single
    # PyTorch call computes any of these functions: library_ms is null)
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=csrc + info[k][0],
             replaces=info[k][1], launches=launches[k],
             max_abs_err=max(rows[k]["max_abs_err"],
                             full[k]["max_abs_err"],
                             swept["max_abs_err"] if k == "tokenize" else 0),
             ms=full[k]["ms"], plain_ms=full[k]["plain_ms"],
             bound_ms=full[k]["bytes"] / HBM_BYTES_PER_S * 1e3,
             bound_by="bytes", library_ms=None)
        for k in kernels] + probe_rows(checked, measured, probe_launches)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--lanes-worker"]:
        sys.exit(lanes_worker(*sys.argv[2:4]))
    sys.exit(main())
