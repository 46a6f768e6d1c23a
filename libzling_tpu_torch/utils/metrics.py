"""Named counters, the port's stage spans, and a device trace around a
region.

Counterpart of ``libzling_tpu/utils/metrics.py``: a process-wide registry
of named counters, cheap enough to leave on (the reference's
compile-gated debug counters, src/libzling_debug.h:38-49).  The lanes
count ``enc.schedule_mispredicts`` (extra validation passes of a group),
``enc.pipeline_redispatch`` (look-ahead groups launched again) and
``enc.group_failover`` (groups encoded again on the host, ``elastic``)
under the JAX package's names, ``enc.card_hands`` (hands of the MTF
state from one card to another, ``Lanes.hand``) and ``enc.groups`` (groups
framed by ``parallel/mesh.py::encode_groups``); the host pipeline adds
``enc.level_drops``, ``enc.blocks``, ``enc.chunks``, ``dec.blocks`` and
``dec.chunks``.

``stage`` marks one stage of the encode or decode path as a
``torch.profiler.record_function`` range named ``zling.<name>``: on the
profiler's timeline, beside the CUDA kernels and copies the stage queued,
and free of any wait for the device.  ``benchmark/span_table.py`` tables
the device's idle time by span.

``trace`` is how an operator captures a Chrome trace of any API call, the
port's spans and its kernels on one clock.
"""

from __future__ import annotations

import contextlib
import threading
from collections import defaultdict

import torch


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: dict[str, int] = defaultdict(int)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def snapshot(self) -> dict:
        with self._lock:
            return {"counters": dict(self.counters)}

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()


registry = Metrics()


def stage(name: str):
    """The stage ``name`` as the profiler range ``zling.<name>``: no wait
    for a device and no fetch from one."""
    return torch.profiler.record_function("zling." + name)


@contextlib.contextmanager
def trace(name: str, out_path: str | None = None):
    """``torch.profiler`` over a region (host ops and the port's spans, and
    CUDA kernels and copies where a GPU is present), the region labelled
    ``name``.  Yields the profiler, whose ``key_averages()`` sums time by
    op and span; with ``out_path`` the Chrome trace is written there when
    the region ends (``benchmark/harness/spans.py`` reads the device's
    idle time in it by span)::

        with metrics.trace("call", "trace.json"):
            api.encode(data, 4)
    """
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(name):
            yield prof
    if out_path is not None:
        prof.export_chrome_trace(out_path)
