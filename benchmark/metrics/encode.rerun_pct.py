"""The share of K4's and K5's device time spent re-running a group after a
schedule fix (the adaptive level drop): 100 x the device time of the
``tokenize`` and ``relabel`` kernels that start inside a
``zling.enc.rerun`` span's reach, over the device time of all of them in
the window, a card's mean over the cards that ran them.  A span's reach
runs from its start to the end of the next ``zling.enc.frame`` span:
the re-run's kernels are queued inside the span, run after it on the
device, and have ended before the group is framed.  The attribution is
exact where no look-ahead runs, as on the one-shot route of every encode
cell (a call is one group); with a look-ahead the next group's first
pass may start inside a reach and count as a re-run.  0.0 where the
window frames groups but re-runs none.  None without the port's spans or
frames, and where a ``zling.enc.launch`` lies outside every
``zling.enc.dispatch`` and every ``zling.enc.rerun``: a re-run that a
program from before the span did not mark.  Moves ``encode_MBps``."""

from benchmark.harness import spans

RERUN, FRAME = "zling.enc.rerun", "zling.enc.frame"
DISPATCH, LAUNCH = "zling.enc.dispatch", "zling.enc.launch"
STAGES = ("tokenize", "relabel")


def _reaches(host, hi: float) -> list[tuple[float, float]]:
    frames = [(e.start, e.end) for e in host if e.name == FRAME]
    return [(e.start, next((b for a, b in frames if a >= e.start), hi))
            for e in host if e.name == RERUN]


def _unmarked(host) -> bool:
    """Whether a launch lies outside every dispatch and every rerun."""
    outer = [(e.start, e.end) for e in host if e.name in (DISPATCH, RERUN)]
    return any(not any(a <= e.start and e.end <= b for a, b in outer)
               for e in host if e.name == LAUNCH)


def read(reading):
    host = sorted(spans.port_spans(reading), key=lambda e: e.start)
    if not any(e.name == FRAME for e in host) or _unmarked(host):
        return None
    reaches = _reaches(host, reading.hi)
    shares = []
    for card in reading.cards:
        total = rerun = 0.0
        for e in reading.device:
            if (e.card != card or e.cat != "kernel"
                    or reading.stage_of(e.name) not in STAGES):
                continue
            total += e.end - e.start
            if any(a <= e.start < b for a, b in reaches):
                rerun += e.end - e.start
        if total > 0:
            shares.append(rerun / total)
    if not shares:
        return None
    return 100.0 * sum(shares) / len(shares)
