"""What K2, K3 and K5 walk: counts of a stream's units, the host's view of
the kernels' loads.

    python -m libzling_tpu_torch.probes.stream_stats [--levels 0 4]

Not a counterpart of a TPU probe, and no device metric: counts from the
stream alone, on the CPU.  The input is ``chip_smoke.py``'s corpus (32 MiB
of ``tools/make_corpus`` with 1 MiB of seeded random bytes in its middle;
the first 20 MiB at levels above 0, as ``chip_smoke.py`` runs e4), encoded
by the port's native engine (the canonical stream the card's encode
equals).  The tokens come back through K1's plain version, and a walk of
each chunk's tokens gives its units: a block's raw head bytes, literals,
word-MRU hits and matches (symbol, then index).  Each unit's position
follows from the lengths; its context is the byte before it; each unit but
a head byte inserts its position into its context's ring, so a match of
index m takes its source from the m-th insert before its own in its
context, in its block.  Printed, per level, as one JSON object a line:

  * the unit mix (literal, match, word-MRU shares of the units);
  * the match index's quantiles and its share under 128 and 256 (what a
    shared cache of each context's newest ring slots could hold);
  * the source distance d = opos - src: quantiles and the share within
    32, 64 and 128 KiB (K2's and K3's output window);
  * the busiest context's share of the literals, and of the ring reads the
    8 busiest contexts make (K5 walks each context's literals as one
    chain; its time is the busiest chain's);
  * the sum over K5's tiles (``TILE`` units of a block) of each tile's
    busiest context's literals: the steps K5's walk takes one after
    another.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .. import _build
from .. import group_decode as gd
from ..native import engine
from ..ops import entropy_kernel as ek
from ..ops.relabel_kernel import TILE
from ..tables import MATCH_MIN_LEN

KiB, MiB = 1 << 10, 1 << 20


def corpus() -> bytes:
    """``chip_smoke.py``'s 32 MiB corpus: the Markov corpus with 1 MiB of
    seeded random bytes in its middle."""
    sys.path.insert(0, str(_build._REPO / "tools"))
    from make_corpus import make_corpus

    data = bytearray(make_corpus(32 * MiB))
    rng = np.random.default_rng(20261016)
    mid = len(data) // 2 - MiB // 2
    data[mid:mid + MiB] = rng.integers(0, 256, MiB, dtype=np.uint8).tobytes()
    return bytes(data)


def units_of(tokens, rlens, new_block, encpos):
    """Walk each chunk's tokens: per unit (kind, length, match index, block)
    with kind 0 head byte, 1 literal, 2 word-MRU hit, 3 match."""
    kind, length, midx, block = [], [], [], []
    off, b, opos = 0, -1, 0
    for rlen, nb, end in zip(rlens.tolist(), new_block.tolist(),
                             encpos.tolist()):
        t = tokens[off:off + rlen].tolist()
        if nb:
            b, opos = b + 1, 0
        i = 0
        while i < rlen:
            v = t[i]
            if opos < 2:
                kind.append(0), length.append(1), midx.append(0)
                opos += 1
                i += 1
            elif v >= 258:
                n = v - 258 + MATCH_MIN_LEN
                kind.append(3), length.append(n), midx.append(t[i + 1])
                opos += n
                i += 2
            else:
                kind.append(1 if v < 256 else 2)
                length.append(1 if v < 256 else 2)
                midx.append(0)
                opos += length[-1]
                i += 1
            block.append(b)
        assert opos == end
        off += rlen
    return (np.asarray(kind), np.asarray(length, np.int64),
            np.asarray(midx, np.int64), np.asarray(block))


def sources(pos, ctx, kind, midx, block):
    """Each match's source position: the midx-th ring insert before its own
    in its context and block."""
    ins = np.flatnonzero(kind != 0)
    key = block[ins] * 256 + ctx[ins]
    order = ins[np.argsort(key, kind="stable")]
    skey = block[order] * 256 + ctx[order]
    first = np.r_[0, np.flatnonzero(skey[1:] != skey[:-1]) + 1]
    start = np.repeat(first, np.diff(np.r_[first, len(order)]))
    rank = np.empty(len(kind), np.int64)
    rank[order] = np.arange(len(order)) - start
    gstart = np.empty(len(kind), np.int64)
    gstart[order] = start
    m = np.flatnonzero(kind == 3)
    assert (rank[m] >= midx[m]).all()
    return m, pos[order[gstart[m] + rank[m] - midx[m]]]


def walk(s, data: bytes) -> dict:
    """The parsed stream ``s`` (``group_decode.parse``) of ``data`` unit by
    unit: ``units_of``'s kind, length, match index and block, each unit's
    position in its block and context, each block's first unit and unit
    count, and the matches' units (``m``) and source distances d = opos -
    src (``d``), in stream order."""
    k1, _ = s.stage_split(0, len(s.rlens), "cpu")
    tokens = ek.decode_chunks(*k1)[0].numpy()
    kind, length, midx, block = units_of(tokens, s.rlens, s.new_block,
                                         s.encpos)
    # position in the block; context: the byte before it
    first = np.r_[0, np.flatnonzero(block[1:] != block[:-1]) + 1]
    count = np.diff(np.r_[first, len(kind)])
    end = np.cumsum(length)
    pos = end - length - np.repeat(end[first] - length[first], count)
    buf = np.frombuffer(data, np.uint8)
    at = s.block_base[block] + pos
    ctx = np.where(pos > 0, buf[np.maximum(at - 1, 0)], 0).astype(np.int64)
    m, src = sources(pos, ctx, kind, midx, block)
    d = pos[m] - src
    assert (src > 0).all() and (d > 0).all()
    assert (buf[s.block_base[block[m]] + src] == buf[at[m]]).all()
    return dict(kind=kind, length=length, midx=midx, block=block, pos=pos,
                ctx=ctx, first=first, count=count, m=m, d=d)


def stats(data: bytes, level: int) -> dict:
    s = gd.parse(engine.encode(data, level))
    w = walk(s, data)
    kind, midx, ctx, m, d = (w[k] for k in ("kind", "midx", "ctx", "m", "d"))
    first, count = w["first"], w["count"]
    n = int((kind != 0).sum())
    lit = kind == 1
    lit_ctx = np.bincount(ctx[lit], minlength=256)
    reads = np.sort(np.bincount(ctx[m], minlength=256))[::-1]
    # K5: per tile of TILE units of a block, its busiest context's literals
    in_block = np.arange(len(kind)) - np.repeat(first, count)
    tile = np.repeat(np.cumsum(np.r_[0, -(-count // TILE)])[:-1], count) \
        + in_block // TILE
    per = np.zeros((tile[-1] + 1, 256), np.int64)
    np.add.at(per, (tile[lit], ctx[lit]), 1)
    q = [0.1, 0.25, 0.5, 0.75, 0.9]
    return dict(
        level=level, bytes=len(data), tokens=int(s.rlens.sum()),
        chunks=len(s.rlens), units=n,
        mix=dict(literal=float(lit.sum() / n), match=float(len(m) / n),
                 mru=float((kind == 2).sum() / n)),
        midx=dict(quantiles=dict(zip(map(str, q),
                                     np.quantile(midx[m], q).tolist())),
                  under_128=float((midx[m] < 128).mean()),
                  under_256=float((midx[m] < 256).mean())),
        distance=dict(quantiles=dict(zip(map(str, q),
                                         np.quantile(d, q).tolist())),
                      within_32KiB=float((d <= 32 * KiB).mean()),
                      within_64KiB=float((d <= 64 * KiB).mean()),
                      within_128KiB=float((d <= 128 * KiB).mean())),
        literals=int(lit.sum()), busiest_literals=int(lit_ctx.max()),
        busiest_share=float(lit_ctx.max() / lit.sum()),
        top8_ring_read_share=float(reads[:8].sum() / len(m)),
        tiles=int(per.shape[0]), tile_busiest_sum=int(per.max(1).sum()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--levels", type=int, nargs="+", default=[0, 4])
    args = ap.parse_args(argv)
    data = corpus()
    for level in args.levels:
        x = data if level == 0 else data[:20 << 20]
        print(json.dumps(stats(x, level)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
