"""K5's share of its roofline: 100 x the least time of the ``relabel`` stage's work
(``stages/relabel/stage.json``, in the format's own quantities) at the
card's memory bandwidth, over the device time of the stage's kernels in
the traced window.  Moves ``encode_MBps``."""


def read(reading):
    return reading.roofline_pct("relabel")
