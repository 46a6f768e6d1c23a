"""Read a traced window: the profiler's Chrome trace, reduced to what the
per-layer metrics read.

The window is the benchmark's own span ``benchmark.window`` (each call in
it a ``benchmark.call``).  Each device operation (kernel, copy, set)
keeps its card: the ``args.device`` the profiler writes on it, else its
``pid``, else card 0.  A card's busy time is the union of the intervals
of its operations inside the window.  Every figure of device time (the
busy and idle time, the idle gaps, the device time by operation) is taken
card by card and averaged over the cards that the trace shows working in
the window (``Reading.cards``); on one card it is that card's.  A kernel
belongs to the stage whose ``stages/<stage>/*.txt`` lists its name
(``kernel_name``), else to ``other``.  A stage's roofline share is the
least time its work (``layout.Stage.bytes_moved``, in the format's own
quantities) takes at one card's memory bandwidth (``benchmark/peaks.json``)
over the device time of its kernels, summed over the cards: the same
work, whatever number of cards does it.
"""

from __future__ import annotations

import json
import pathlib
from collections import defaultdict
from typing import NamedTuple

import numpy as np

WINDOW = "benchmark.window"
CALL = "benchmark.call"
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "user_annotation", "cuda_runtime",
                       "cuda_driver"})
OTHER = "other"
PEAKS = pathlib.Path(__file__).resolve().parent.parent / "peaks.json"
_ANON = "(anonymous namespace)"


class Event(NamedTuple):
    name: str
    cat: str
    start: float       # seconds
    end: float
    card: int = 0      # a device operation's card (``card_of``)


def card_of(e: dict) -> int:
    """The card a device event of the Chrome trace ran on: Kineto's
    ``args.device``, else the event's ``pid``, else 0."""
    for v in ((e.get("args") or {}).get("device"), e.get("pid")):
        if isinstance(v, int):
            return v
    return 0


def kernel_name(raw: str) -> str:
    """A kernel's name as the stage files list it: the qualified function
    name without return type, template arguments and parameters, e.g.
    ``void (anonymous namespace)::tokenize_kernel<2>(unsigned char
    const*, ...)`` -> ``(anonymous namespace)::tokenize_kernel``."""
    s = raw.strip()
    if s.startswith("void "):
        s = s[5:]
    s = s.replace(_ANON, "\0")
    cut = s.find("(")
    if cut >= 0:
        s = s[:cut]
    s = s.rstrip()
    if s.endswith(">"):
        depth = 0
        for i in range(len(s) - 1, -1, -1):
            depth += {">": 1, "<": -1}.get(s[i], 0)
            if depth == 0:
                s = s[:i]
                break
    return s.replace("\0", _ANON).strip()


class Trace:
    """The events of a Chrome trace (``torch.profiler``'s export)."""

    def __init__(self, chrome: dict):
        self.device: list[Event] = []
        self.host: list[Event] = []
        for e in chrome.get("traceEvents", []):
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ev = Event(e.get("name", ""), e.get("cat", ""), e["ts"] * 1e-6,
                       (e["ts"] + e["dur"]) * 1e-6)
            if ev.cat in DEVICE_CATS:
                self.device.append(ev._replace(card=card_of(e)))
            elif ev.cat in HOST_CATS:
                self.host.append(ev)

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            return cls(json.load(f))

    def span(self, name: str) -> Event:
        hits = [e for e in self.host if e.name == name]
        if len(hits) != 1:
            raise RuntimeError(f"the trace holds {len(hits)} {name!r} spans, "
                               "not one")
        return hits[0]


def union(intervals) -> list[tuple[float, float]]:
    """Disjoint, sorted cover of ``intervals``."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def peak_bandwidth(kind: str) -> float | None:
    """The card's memory bandwidth (bytes/s) from ``peaks.json``, or None
    for a card the table lacks."""
    with open(PEAKS) as f:
        row = json.load(f).get(kind)
    return None if row is None else float(row["hbm_bytes_per_s"])


class Reading:
    """What a traced window gives the per-layer readers
    (``metrics/<metric>.py``: ``read(reading) -> float | None``).

    ``quantities``: the format's own quantities of one call (a mapping
    that may compute a costly one when first read); ``calls``: the calls
    the window completed; ``hbm_bytes_per_s``: one card's peak, or None.
    ``cards``: the cards with a device operation in the window (card 0
    where none has one); ``card_busy_s``: each one's busy seconds;
    ``busy_s``: their mean.
    """

    def __init__(self, trace: Trace, stages: dict, op: str, quantities,
                 calls: int, hbm_bytes_per_s: float | None):
        w = trace.span(WINDOW)
        self.lo, self.hi = w.start, w.end
        self.window_s = w.end - w.start
        self.trace, self.stages, self.op = trace, stages, op
        self.quantities, self.calls = quantities, calls
        self.hbm_bytes_per_s = hbm_bytes_per_s
        self.device = [e._replace(start=max(e.start, self.lo),
                                  end=min(e.end, self.hi))
                       for e in trace.device
                       if e.end > self.lo and e.start < self.hi]
        self.cards = tuple(sorted({e.card for e in self.device})) or (0,)
        self.busy = {c: union((e.start, e.end) for e in self.device
                              if e.card == c) for c in self.cards}
        self.card_busy_s = {c: sum(b - a for a, b in busy)
                            for c, busy in self.busy.items()}
        self.busy_s = sum(self.card_busy_s.values()) / len(self.cards)
        self._of = {}
        host = [e for e in trace.host if e.name != WINDOW]
        self._host = (host, np.array([e.start for e in host]),
                      np.array([e.end for e in host]))

    def stage_of(self, raw: str) -> str:
        if raw not in self._of:
            name = kernel_name(raw)
            self._of[raw] = next((s for s, st in self.stages.items()
                                  if name in st.kernels), OTHER)
        return self._of[raw]

    def idle_pct(self) -> float:
        """100 x the share of the window in which no device operation ran
        on a card, averaged over the cards."""
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def stage_seconds(self, stage: str) -> float:
        return sum(e.end - e.start for e in self.device
                   if e.cat == "kernel" and self.stage_of(e.name) == stage)

    def stage_bytes(self, stage: str) -> int | None:
        """The stage's bytes over the window's calls, or None where this
        cell's operation does no work of the stage."""
        st = self.stages[stage]
        if self.op not in st.ops:
            return None
        return st.bytes_moved(self.quantities) * self.calls

    def roofline_pct(self, stage: str) -> float | None:
        """100 x the least time of the stage's work at one card's memory
        bandwidth over its kernels' device time on every card.  None where
        the cell does none of its work or the card is not in
        ``peaks.json``; a stage that did work but shows no kernel raises."""
        nbytes = self.stage_bytes(stage)
        if nbytes is None or self.calls == 0:
            return None
        t = self.stage_seconds(stage)
        if t <= 0:
            raise RuntimeError(
                f"stage {stage!r} did work but the trace holds none of its "
                f"kernels {sorted(self.stages[stage].kernels)}; kernels seen: "
                f"{sorted({kernel_name(e.name) for e in self.device})[:20]}")
        if self.hbm_bytes_per_s is None:
            return None
        return 100.0 * (nbytes / self.hbm_bytes_per_s) / t

    def gaps(self, card: int | None = None) -> list[tuple[float, float]]:
        """The window's idle intervals on ``card``; without one, those of
        every card of ``cards``, card after card."""
        if card is None:
            return [g for c in self.cards for g in self.gaps(c)]
        out, t = [], self.lo
        for a, b in self.busy.get(card, ()):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.hi > t:
            out.append((t, self.hi))
        return out

    def host_activity(self, t: float) -> str:
        """The innermost host event running at ``t`` (the latest to start
        of those that cover it), or what the benchmark's own span says."""
        host, starts, ends = self._host
        hit = np.flatnonzero((starts <= t) & (ends >= t))
        if hit.size == 0:
            return "host: between calls"
        e = host[hit[np.argmax(starts[hit])]]
        return "host code outside torch ops" if e.name == CALL else e.name

    def breakdown(self, top: int = 10, named_gaps: int = 200) -> dict:
        """``device_ops``: device seconds by ``<stage>/<kernel>`` (copies
        and sets by their own names); ``idle_gaps``: seconds of each card's
        ``named_gaps`` longest idle gaps, summed by what the host was doing
        in each; both a card's mean over ``cards``, the ``top`` largest."""
        ops: dict[str, float] = defaultdict(float)
        for e in self.device:
            key = (f"{self.stage_of(e.name)}/{kernel_name(e.name)}"
                   if e.cat == "kernel" else e.name)
            ops[key] += e.end - e.start
        idle: dict[str, float] = defaultdict(float)
        for c in self.cards:
            for a, b in sorted(self.gaps(c),
                               key=lambda g: g[0] - g[1])[:named_gaps]:
                idle[self.host_activity((a + b) / 2)] += b - a

        def best(d):
            n = len(self.cards)
            return [[k, v / n] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(ops), "idle_gaps": best(idle)}
