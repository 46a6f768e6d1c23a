"""The port's own spans in a traced window: the device's idle time put down
to the stage the host was in.

The program marks its stages as ``torch.profiler.record_function`` ranges
named ``zling.*`` (``libzling_tpu_torch/utils/metrics.py::stage``): each
API call a top span (``zling.encode``, ``zling.decode``), its stages
nested in it on the one calling thread.  They land in the Chrome trace as
host events on the same timeline as the device's operations.  This module
reads them from a ``reading.Reading`` through its public fields alone
(``trace.host``, ``lo`` / ``hi``, ``cards``, ``gaps()``, ``calls``), so a
trace with no port span (a program from before them) reads as nothing,
never as an error.  Idle time is each card's, averaged over ``cards``:
the host's spans are one timeline that every card's gaps are cut by.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

PREFIX = "zling."


def port_spans(reading) -> list:
    """The ``zling.*`` host spans that start in the window, clipped to it."""
    lo, hi = reading.lo, reading.hi
    return [e._replace(end=min(e.end, hi)) for e in reading.trace.host
            if e.name.startswith(PREFIX) and lo <= e.start < hi]


def count(reading, name: str) -> int:
    """The spans named ``name`` that start in the window."""
    return sum(1 for e in reading.trace.host if e.name == name
               and reading.lo <= e.start < reading.hi)


def idle_under(reading, top: str) -> dict[str, float]:
    """Seconds of device idle time inside ``top`` spans, by the innermost
    span covering each instant: the ``zling.*`` span (or ``top`` span) that
    started latest, of two that started together the one that ends first.
    An idle interval of ``reading.gaps(card)`` is cut exactly at every span
    edge; idle time outside every ``top`` span is left out; a card's mean
    over ``reading.cards``."""
    spans = [e for e in port_spans(reading) if e.name != top]
    spans += [e._replace(start=max(e.start, reading.lo),
                         end=min(e.end, reading.hi))
              for e in reading.trace.host
              if e.name == top and e.end > reading.lo and e.start < reading.hi]
    if not spans:
        return {}
    starts = np.array([e.start for e in spans])
    ends = np.array([e.end for e in spans])
    is_top = np.array([e.name == top for e in spans])
    # the timeline cut at every span edge: within a piece the set of
    # covering spans does not change, so its innermost span is exact
    edges = np.unique(np.concatenate([starts, ends]))
    mids = (edges[:-1] + edges[1:]) / 2
    cover = ((starts[None, :] <= mids[:, None])
             & (ends[None, :] > mids[:, None]))
    under_top = (cover & is_top[None, :]).any(axis=1)
    # latest start first, then earliest end
    rank = np.lexsort((-ends, starts))
    order = np.empty(len(spans), np.int64)
    order[rank] = np.arange(len(spans))
    inner = np.where(cover, order[None, :], -1).argmax(axis=1)

    out: dict[str, float] = defaultdict(float)
    n = len(reading.cards)
    for card in reading.cards:
        for a, b in reading.gaps(card):
            i = max(int(np.searchsorted(edges, a, side="right")) - 1, 0)
            while i < len(mids) and edges[i] < b:
                lo, hi = max(a, edges[i]), min(b, edges[i + 1])
                if hi > lo and under_top[i]:
                    out[spans[inner[i]].name] += (hi - lo) / n
                i += 1
    return dict(out)


def host_idle_ms(reading, top: str) -> float | None:
    """1000 x the device's idle seconds inside ``top`` spans (a card's
    mean) over the calls the window completed; None where the window holds
    no port span or completed no call."""
    if not port_spans(reading) or reading.calls == 0:
        return None
    return float(1000.0 * sum(idle_under(reading, top).values())
                 / reading.calls)
