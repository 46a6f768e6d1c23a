"""The device's idle share over decode calls: 100 x the share of the traced window in which no device
operation (kernel, copy, set) ran on a card, from the profiler's CUDA
intervals (their union, card by card) over the window's wall time,
averaged over the cards that worked in the window.  Moves
``decode_MBps``."""


def read(reading):
    return reading.idle_pct()
