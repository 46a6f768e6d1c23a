"""K4's cost a unit by search schedule: the counterpart of
``tools/sweep_tokenize.py``.

    python -m libzling_tpu_torch.probes.sweep_tokenize [--mb 2] [--random]
        [--device cpu]

Runs the port's K4 (``ops/tokenize_kernel.py::tokenize``,
``csrc/tokenize.cu``) on one block -- the first ``--mb`` MiB of
``tools/make_corpus``'s corpus at its default seed, or seeded random bytes
(``--random``: chains stay shallow and checks rarely hit, which leaves the
literal, insert and bookkeeping cost) -- under seven uniform (depth,
lazy1, lazy2) schedules, the JAX tool's rows: d1 (1,0,0), d2 (2,0,0), e0
(2,1,0), d3 (3,1,0), e1 (4,1,0), e2 (6,2,0), e4 (16,4,2).  The schedule is
a runtime argument of the kernel, so one build serves every row.  Each row
prints its units, the best of ``REPS`` launches after a warm one (CUDA
events around the wrapper call), ns a unit and the change from the row
before: d1 -> d2 prices a chain step, d2 -> e0 a lazy probe of depth 1,
e0 -> d3 a further chain step.

The JAX tool's last line reads its kernel's own counters (TPU cache
levels); the port's K4 has none.  In their place the engine's match-loop
counters (``pipeline.COUNTER_NAMES``, the engine built with them) over the
same slice at e0 give chain steps and lazy probes that found a longer
match, a unit.

On ``--device cpu`` K4 runs its plain version and the rows give units and
no time.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..native import engine
from ..ops import tokenize_kernel as tkk
from ..pipeline import COUNTER_NAMES
from ..tables import BLOCK_SIZE_ROLZ, SENTINEL_LEN

MiB = 1 << 20
ROWS = (("d1 (base + step0)", (1, 0, 0)), ("d2 (+ step1)", (2, 0, 0)),
        ("e0 (+ lazy1 d1)", (2, 1, 0)), ("d3 (+ loop step)", (3, 1, 0)),
        ("e1 (d4)", (4, 1, 0)), ("e2", (6, 2, 0)), ("e4", (16, 4, 2)))
REPS = 3
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def corpus_slice(nbytes: int, random: bool = False) -> bytes:
    """The sweep's block: ``nbytes`` of the corpus, or of seeded random
    bytes."""
    if random:
        return np.random.default_rng(0).integers(
            0, 256, nbytes, dtype=np.uint8).tobytes()
    sys.path.insert(0, os.path.join(_REPO, "tools"))
    from make_corpus import make_corpus

    return make_corpus(nbytes)


def k4_args(data: bytes, schedule, device) -> tuple:
    """K4's arguments for ``data`` as one block, every chunk under
    ``schedule`` (depth, lazy1, lazy2), at the canonical chunk cap."""
    ilen = len(data)
    buf = torch.zeros(ilen + SENTINEL_LEN, dtype=torch.uint8)
    buf[:ilen] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    # a chunk ends at the token cap and holds at least half as many bytes
    max_chunks = -(-ilen // (BLOCK_SIZE_ROLZ // 2)) + 1
    params = torch.tensor(schedule, dtype=torch.int32).expand(
        1, max_chunks, 3).contiguous()
    zero = torch.zeros(1, dtype=torch.int64)
    return (buf.to(device), zero, torch.tensor([ilen], dtype=torch.int32),
            zero, params, BLOCK_SIZE_ROLZ, ilen)


def units(out) -> int:
    """The units K4 emitted, from its chunk stats; raises if the block was
    not fully tokenized."""
    _units, _upos, chunk_stat, block_stat, _ = out
    if int(block_stat[0, 1]):
        raise RuntimeError("K4 did not tokenize the whole block")
    return int(chunk_stat[0, :, 0].sum())


def sweep(data: bytes, device="cuda", reps: int = REPS) -> list[dict]:
    """One row of ``ROWS`` each: its units and, on a GPU, the best time of
    ``reps`` launches after a warm one, ns a unit and the change from the
    row before."""
    dev = torch.device(device)
    rows, prev = [], None
    for name, schedule in ROWS:
        args = k4_args(data, schedule, dev)
        row = dict(row=name, schedule=schedule,
                   units=units(tkk.tokenize(*args)))
        if dev.type == "cuda":
            best = float("inf")
            for _ in range(reps):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                tkk.tokenize(*args)
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end))
            ns = best * 1e6 / row["units"]
            row.update(ms=best, ns_per_unit=ns,
                       delta_ns=None if prev is None else ns - prev)
            prev = ns
        rows.append(row)
    return rows


def engine_counters(data: bytes, level: int = 0) -> dict[str, int]:
    """The engine's match-loop counters over ``data`` as one block, every
    chunk at ``level``, from the build that counts."""
    dll = engine._lib(counters=True)
    ilen = len(data)
    block = np.zeros(ilen + SENTINEL_LEN, np.uint8)
    block[:ilen] = np.frombuffer(data, np.uint8)
    max_chunks = -(-ilen // (BLOCK_SIZE_ROLZ // 2)) + 1
    levels = np.full(max_chunks, level, np.int32)
    tokens = np.empty(ilen + BLOCK_SIZE_ROLZ + 16, np.uint16)
    rlens = np.zeros(max_chunks, np.int32)
    encpos = np.zeros(max_chunks, np.int32)
    counts = np.zeros(8, np.uint64)
    tok = dll.zlt_tokenizer_new()
    try:
        n = dll.zlt_tokenize_block_raw(
            tok, block.ctypes.data, ilen, levels.ctypes.data, max_chunks,
            tokens.ctypes.data, tokens.size, rlens.ctypes.data,
            encpos.ctypes.data)
        if n < 0:
            raise RuntimeError("zlt_tokenize_block_raw overflow")
        dll.zlt_counters(tok, counts.ctypes.data)
    finally:
        dll.zlt_tokenizer_free(tok)
    return dict(zip(COUNTER_NAMES, (int(v) for v in counts)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m libzling_tpu_torch.probes.sweep_tokenize",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=float, default=2.0)
    ap.add_argument("--random", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if torch.device(a.device).type == "cuda" and \
            not torch.cuda.is_available():
        print("sweep_tokenize: no CUDA device (pass --device cpu for the "
              "plain K4)", file=sys.stderr)
        return 1
    data = corpus_slice(int(a.mb * MiB), a.random)
    print(f"slice: {len(data)} bytes ({'random' if a.random else 'corpus'})",
          flush=True)
    rows = sweep(data, a.device)
    for r in rows:
        timed = "" if "ms" not in r else (
            f"  {r['ms'] / 1e3:6.3f}s  {r['ns_per_unit']:7.1f} ns/unit"
            + ("" if r["delta_ns"] is None
               else f"  (delta {r['delta_ns']:+.1f} ns/unit)"))
        print(f"{r['row']:22s}: {r['units']:8d} units{timed}", flush=True)
    counts = engine_counters(data)
    nu = rows[2]["units"]                    # the e0 row's
    print("e0 engine counters: " + json.dumps(dict(
        counts, per_unit={k: v / nu for k, v in counts.items()})),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
