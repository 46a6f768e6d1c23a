"""The cards' wait in the K5 MTF chain a call: on each card, the idle time
between the end of each ``tokenize`` kernel (K4) and the start of the
``relabel`` kernel (K5) that follows it there -- the wait for the MTF
state from the card before it in the chain -- from the card's idle gaps
(``reading.gaps(card)``); 1000 x its seconds, a card's mean over the
cards that worked, over the calls the window completed.  None where the
window holds no ``zling.enc.hand`` span (a lane on one card, or a program
from before the span) or completed no call.  Moves ``encode_MBps``."""

from benchmark.harness import spans

K4, K5 = "tokenize", "relabel"


def _idle(gaps, a: float, b: float) -> float:
    """Seconds of ``gaps`` (sorted, disjoint) inside ``[a, b]``."""
    return sum(max(0.0, min(hi, b) - max(lo, a)) for lo, hi in gaps)


def read(reading):
    if reading.calls == 0 or spans.count(reading, "zling.enc.hand") == 0:
        return None
    wait = 0.0
    for card in reading.cards:
        kernels = sorted(
            (e.start, e.end, st) for e in reading.device
            if e.card == card and e.cat == "kernel"
            and (st := reading.stage_of(e.name)) in (K4, K5))
        gaps = reading.gaps(card)
        for (_, end, st), (start, _, nxt) in zip(kernels, kernels[1:]):
            if st == K4 and nxt == K5:
                wait += _idle(gaps, end, start)
    return 1000.0 * wait / len(reading.cards) / reading.calls
