"""The device's idle time a call under the port's encode spans: 1000 x the
seconds in which no device operation ran on a card (a card's mean over
the cards that worked) inside ``zling.encode`` spans
(the lanes' group loop and the per-device stages on the host,
``harness/spans.py``), over the calls the window completed.  None on a
trace without the port's spans.  Moves ``encode_MBps``."""

from benchmark.harness import spans


def read(reading):
    return spans.host_idle_ms(reading, "zling.encode")
