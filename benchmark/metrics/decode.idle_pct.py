"""The device's idle share over decode calls: 100 x the share of the traced window in which no device
operation (kernel, copy, set) ran, from the profiler's CUDA intervals
(their union) over the window's wall time.  Moves ``decode_MBps``."""


def read(reading):
    return reading.idle_pct()
