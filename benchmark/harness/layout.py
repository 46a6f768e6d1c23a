"""The manifest (the root ``BENCHMARK.json``) and the files it names.

Everything that belongs to one configuration, traffic mix, stage or
per-layer metric is a file of its own, found by name:

  ``configs/<config>.json``   the file the manifest's ``configs`` entry
                              names (the deployment: level, geometry,
                              corpus, the guarantees it states);
  ``traffic/<traffic>.json``  the operation and its loop;
  ``stages/<stage>/stage.json`` a stage's work, in the format's own
                              quantities (``QUANTITIES``), with the
                              operations it serves; every other file of
                              the folder (``*.txt``) lists kernel names of
                              the stage, one a line;
  ``metrics/<metric>.py``     a per-layer metric's reader, ``read(reading)``
                              (``harness/reading.py``).

A cell is its ``workloads`` entry: a configuration and a traffic mix.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import NamedTuple

from benchmark.harness import gxx

BENCH = gxx.BENCH
ROOT = BENCH.parent

# the quantities a stage's work is counted in: each is read from the
# input and the reference's stream, never from the program
QUANTITIES = {
    "raw_bytes": "bytes of the uncompressed data",
    "stream_bytes": "bytes of the compressed stream",
    "tokens": "tokens, the chunk headers' counts summed",
    "literals": "literal tokens among them",
}


class Stage(NamedTuple):
    name: str
    ops: tuple[str, ...]           # the operations whose calls do its work
    read: dict[str, float]         # quantity -> bytes read per unit
    write: dict[str, float]        # quantity -> bytes written per unit
    kernels: frozenset[str]        # kernel names (harness/reading.py)

    def bytes_moved(self, q: dict[str, int]) -> int:
        """The stage's bytes for one call of quantities ``q``: each byte
        read counted once and each byte written once."""
        return int(sum(q[k] * f for part in (self.read, self.write)
                       for k, f in part.items()))


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Benchmark:
    """The manifest of a checkout and the files it names."""

    def __init__(self, root: pathlib.Path = ROOT):
        self.root = root
        self.bench = root / "benchmark"
        self.manifest = _json(root / "BENCHMARK.json")

    def cells(self) -> dict[str, dict]:
        return {w["name"]: w for w in self.manifest["workloads"]}

    def cell(self, name: str) -> dict:
        cells = self.cells()
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; have "
                             f"{sorted(cells)}")
        return cells[name]

    def config(self, name: str) -> dict:
        entry = {c["name"]: c for c in self.manifest["configs"]}[name]
        return _json(self.root / entry["file"])

    def traffic(self, name: str) -> dict:
        return _json(self.bench / "traffic" / f"{name}.json")

    def stages(self) -> dict[str, Stage]:
        out = {}
        for d in sorted(p for p in (self.bench / "stages").iterdir()
                        if (p / "stage.json").is_file()):
            s = _json(d / "stage.json")
            names = set()
            for f in sorted(d.glob("*.txt")):
                names.update(line.strip() for line in f.read_text().split("\n")
                             if line.strip() and not line.startswith("#"))
            for q in (*s["read"], *s["write"]):
                if q not in QUANTITIES:
                    raise ValueError(f"stage {d.name}: unknown quantity {q!r}")
            out[d.name] = Stage(d.name, tuple(s["ops"]), s["read"], s["write"],
                                frozenset(names))
        return out

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics a cell reports: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.manifest["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in e2e
                                 else [])]

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.manifest["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.bench / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def listing(self) -> dict:
        """What the harness finds: every cell with its files, every stage
        and every metric with its reader."""
        return {
            "cells": {n: {"config": w["config"], "traffic": w["traffic"]}
                      for n, w in self.cells().items()},
            "configs": [c["name"] for c in self.manifest["configs"]],
            "traffic": sorted(p.stem for p in
                              (self.bench / "traffic").glob("*.json")),
            "stages": {n: sorted(s.kernels) for n, s in self.stages().items()},
            "metrics": {m["name"]: (self.bench / "metrics" /
                                    f"{m['name']}.py").is_file()
                        for m in self.manifest["per_layer"]},
        }
