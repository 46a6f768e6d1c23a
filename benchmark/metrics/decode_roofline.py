"""The decode kernels' share of their roofline (K3, or K1 + K2): 100 x the least time of the ``decode`` stage's work
(``stages/decode/stage.json``, in the format's own quantities) at the
card's memory bandwidth, over the device time of the stage's kernels in
the traced window.  Moves ``decode_MBps``."""


def read(reading):
    return reading.roofline_pct("decode")
