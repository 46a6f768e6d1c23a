"""Run a cell's control: the reference with its MTF state and level reset at
every 16 MiB block, put in the program's place (``runner.Control``), at
the cell's own size.  Its numbers set the upper readings of the cell's
limits; the benchmark's own runs never run it.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
        [--seconds 10]

Prints, per seed, one JSON line: the compared numbers and ``correct``,
which must come out false.  Needs no card.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import runner

    for seed in (int(s) for s in args.seeds.split(",")):
        out = runner.run(args.workload, seed, args.seconds, False,
                         system=runner.Control)
        res = out["result"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
