"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>
    python3 benchmark/run.py --list

Runs from the root of a checkout.  Without a CUDA device (or with fewer
than the cell asks for) it exits 2 and prints no result.  Every visible
card is watched: the result's ``device.count`` is the cards on which the
program held memory during the window, and a run that leaves one of the
cell's ``chips`` cards unused is not ``correct`` (``devices_unused``).
With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiler trace of the
same window card by card and averaged over the cards that worked.  The
last line of stdout is the result; the last lines of stderr are the
numbers the check compared, each beside its limit.  Once the window has
closed, a process that holds ``jax``, ``jaxlib``, ``flax`` or
``libzling_tpu`` (whole top-level names) exits 3 and prints no result.
"""

import time

T0 = time.perf_counter()     # set-up counts from here

import argparse   # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import pathlib    # noqa: E402
import sys        # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / ".cache"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "libzling_tpu"})


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the run may not hold."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--list", action="store_true",
                    help="print the cells, stages and metrics found")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    # the program builds its CUDA kernels under build/ in the checkout; a
    # torch extension or a Triton kernel would cache here, never in $HOME
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    from benchmark.harness import layout, runner

    bench = layout.Benchmark(ROOT)
    if args.list:
        print(json.dumps(bench.listing(), indent=1))
        return 0
    if not args.workload:
        ap.error("--workload is required")
    chips = int(bench.cell(args.workload).get("chips", 1))
    try:
        out = runner.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), t0=T0, bench=bench,
                         system=lambda: runner.Port("cuda", chips))
    except runner.NoDevice as e:
        print(f"run.py: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"run.py: the process holds {bad}", file=sys.stderr)
        return 3
    runner.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
