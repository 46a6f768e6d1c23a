"""Named counters and timers, and a device trace around a region.

Counterpart of ``libzling_tpu/utils/metrics.py``: a process-wide registry
of named counters and timers, cheap enough to leave on (the reference's
compile-gated debug counters, src/libzling_debug.h:38-49).  The lanes
count ``enc.schedule_mispredicts`` (extra validation passes of a group)
and ``enc.pipeline_redispatch`` (look-ahead groups launched again) under
the JAX package's names.  Device profiling is ``torch.profiler``
(``trace``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: dict[str, int] = defaultdict(int)
        self.timers: dict[str, float] = defaultdict(float)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            with self._lock:
                self.timers[name] += time.perf_counter() - t0

    def snapshot(self) -> dict:
        with self._lock:
            return {"counters": dict(self.counters), "timers": dict(self.timers)}

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.timers.clear()

    def report(self) -> str:
        snap = self.snapshot()
        lines = [f"  {k}: {v}" for k, v in sorted(snap["counters"].items())]
        lines += [f"  {k}: {v:.4f}s" for k, v in sorted(snap["timers"].items())]
        return "\n".join(lines) if lines else "  (empty)"


registry = Metrics()


@contextlib.contextmanager
def trace(name: str, out_path: str | None = None):
    """``torch.profiler`` over a region (host ops, and CUDA kernels where a
    GPU is present), the region labelled ``name``.  Yields the profiler,
    whose ``key_averages()`` sums time by kernel; with ``out_path`` the
    Chrome trace is written there when the region ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(name):
            yield prof
    if out_path is not None:
        prof.export_chrome_trace(out_path)
