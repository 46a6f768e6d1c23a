"""The device's idle time in a cell, put down to the port's stages.

    python3 benchmark/span_table.py --workload <cell> --seeds 1 2 3
        [--seconds 51] [--traces DIR]

Each seed is one ``run.py --trace 1`` run (``harness/runner.py``) whose
window is captured through ``libzling_tpu_torch.utils.metrics.trace``, the
port's way to trace an API call, its Chrome trace kept under ``--traces``
(default ``benchmark/.cache/span_table``).
Prints a JSON line a run: the result line's per-layer metrics and
``traced_MBps``; each port span's count and its ms a call (wall time, its
children's included); the device's idle ms a call by the innermost port span
under the call's top span (``harness/spans.py``); the share of the idle
time inside ``benchmark.call`` spans that lies under a port span below
the top one; and each card's 200 longest idle gaps summed by what the
host was doing (``Reading.host_activity``) and the innermost port span
around it, which names the stage that sat in a ``cudaMalloc``.  Idle time
is a card's mean over the cards that worked in the window.
"""

import argparse
import contextlib
import json
import pathlib
import shutil
import sys
from collections import defaultdict

ROOT = pathlib.Path(__file__).resolve().parent.parent


class Kept:
    """The profiler, its Chrome trace also copied to ``keep`` when the
    runner exports it (a trace is written once)."""

    def __init__(self, prof, keep: pathlib.Path):
        self.prof, self.keep = prof, keep

    def export_chrome_trace(self, path: str) -> None:
        self.prof.export_chrome_trace(path)
        shutil.copyfile(path, self.keep)


def innermost(port, t: float) -> str:
    """The port span that covers ``t`` and started latest, or "-"."""
    hit = [e for e in port if e.start <= t < e.end]
    return max(hit, key=lambda e: (e.start, -e.end)).name if hit else "-"


def table(rd, op: str, calls: int) -> dict:
    from benchmark.harness import reading, spans

    top = "zling." + op
    by_span = spans.idle_under(rd, top)
    in_calls = spans.idle_under(rd, reading.CALL)
    below = sum(v for k, v in in_calls.items() if k not in (reading.CALL, top))
    port = spans.port_spans(rd)
    gaps: dict = defaultdict(float)
    for card in rd.cards:
        for a, b in sorted(rd.gaps(card), key=lambda g: g[0] - g[1])[:200]:
            t = (a + b) / 2
            gaps[f"{rd.host_activity(t)} @ {innermost(port, t)}"] += (
                (b - a) / len(rd.cards))
    held: dict = defaultdict(float)
    for e in port:
        held[e.name] += e.end - e.start
    per_call = max(calls, 1)
    return {
        "idle_ms_a_call": {k: 1000 * v / per_call for k, v in
                           sorted(by_span.items(), key=lambda kv: -kv[1])},
        "idle_in_calls_s": sum(in_calls.values()),
        "below_top_pct": 100 * below / max(sum(in_calls.values()), 1e-12),
        "gaps_by_activity": dict(sorted(gaps.items(),
                                        key=lambda kv: -kv[1])[:12]),
        "spans": {n: spans.count(rd, n) for n in sorted({e.name
                                                          for e in port})},
        "span_ms_a_call": {n: 1000 * t / per_call
                           for n, t in sorted(held.items())},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--traces", default=str(ROOT / "benchmark" / ".cache"
                                            / "span_table"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import layout, reading, runner
    from libzling_tpu_torch.utils import metrics

    out = pathlib.Path(args.traces)
    out.mkdir(parents=True, exist_ok=True)
    bench = layout.Benchmark(ROOT)
    op = bench.traffic(bench.cell(args.workload)["traffic"])["op"]
    for seed in args.seeds:
        path = out / f"{args.workload}.{seed}.json"

        class Traced(runner.Port):
            @contextlib.contextmanager
            def profile(self):
                with metrics.trace("benchmark.capture") as prof:
                    yield Kept(prof, path)

        res = runner.run(args.workload, seed, args.seconds, True,
                         system=Traced, bench=bench)
        r = res["result"]
        calls = r["attempted"] - r["failed"]
        rd = reading.Reading(reading.Trace.load(path), bench.stages(), op,
                             {}, calls, None)
        line = {"cell": args.workload, "seed": seed, "correct": r["correct"],
                "calls": calls, "traced_MBps": res["info"]["traced_MBps"],
                "card": res["info"]["card"],
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                **table(rd, op, calls)}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
