"""K4 + K5 passes a group: the ``zling.enc.launch`` spans (a group's first
dispatch, a look-ahead dispatched again, a re-run after a schedule fix)
over the ``zling.enc.frame`` spans (one a group encoded), in the window.
1.0 wastes no pass.  None on a trace without the port's spans.  Moves
``encode_MBps``."""

from benchmark.harness import spans


def read(reading):
    frames = spans.count(reading, "zling.enc.frame")
    if frames == 0:
        return None
    return spans.count(reading, "zling.enc.launch") / frames
