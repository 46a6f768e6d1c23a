"""Round-trip and corrupt-stream fuzz of the port on one device.

Counterpart of ``tools/fuzz.py`` (which needs JAX):

    python -m libzling_tpu_torch.fuzz [--rounds N] [--max-size B]
        [--seed S] [--device cuda|cpu] [--dump-dir DIR]

Each round draws a blob of up to ``--max-size`` bytes in one of four
styles (random bytes, words, one repeated byte, copies of itself with
random runs) and a level 0-6, and on ``--device`` (``cuda`` by default,
an error without a GPU; ``cpu`` runs every kernel's plain version):

  1. ``encode`` at the canonical geometry must give the native engine's
     stream;
  2. the stream decodes back through each path of ``decode_paths``:
     fused (K3), split (K1 -> K2), ``decode_groups`` one block a group,
     and ``mesh_decode`` over two entries of the device;
  3. a blob of at most ``SMALL_MAX`` bytes is also encoded at the small
     geometry (``SMALL``: blocks, chunks and the adaptive drop within one
     blob) on the device and on the CPU lane, which must agree, and
     decoded back through every path;
  4. each stream is corrupted once by a bit flip and once by truncation:
     every path must raise ValueError or return bytes (any other
     exception fails); split, groups and mesh must have the same outcome;
     on a GPU each path's outcome must equal its CPU lane's (kernel ==
     plain).  Fused is held to no other path: it may differ from split on
     a head-byte match symbol.

Before each case one line names it (round, seed, level, size, path),
flushed, so that a run that hangs names its case.  A failed case is
dumped under ``DIR/<digest>/`` (``input``, ``stream``, ``corrupt``,
``error``; DIR defaults to ``build/fuzz``).  The last line is a JSON
summary; the exit code is 1 if any case failed, else 0.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import random
import sys
import time

import torch

from .api import decode
from .device import encode, resolve_device
from .group_decode import decode_groups
from .native import engine
from .parallel.decode_mesh import mesh_decode

REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(block_size=4096, max_tokens=700)
SMALL_MAX = 32768      # bytes: blobs this short also run at SMALL
STYLES = ("random", "words", "run", "copies")


def blob(rng: random.Random, n: int) -> tuple[str, bytes]:
    """``n`` bytes in a style drawn from ``rng`` (tools/fuzz.py:_blob's
    four styles and weights); returns (the style, the bytes)."""
    style = rng.random()
    if style < 0.25:
        return "random", bytes(rng.randrange(256) for _ in range(n))
    if style < 0.5:
        words = [b"the ", b"of ", b"zling", b"\n", b"compress ", b"a"]
        out = bytearray()
        while len(out) < n:
            out += rng.choice(words)
        return "words", bytes(out[:n])
    if style < 0.7:
        return "run", bytes([rng.randrange(8)]) * n
    out = bytearray()
    while len(out) < n:
        if out and rng.random() < 0.5:
            s = rng.randrange(len(out))
            out += out[s:s + rng.randrange(1, 512)]
        else:
            out += bytes(rng.randrange(256)
                         for _ in range(rng.randrange(1, 64)))
    return "copies", bytes(out[:n])


def decode_paths(device: torch.device) -> dict:
    """The decode paths on ``device``, by name."""
    return {
        "fused": lambda s: decode(s, device),
        "split": lambda s: decode(s, device, fused=False),
        "groups": lambda s: decode_groups(s, device, group_blocks=1),
        "mesh": lambda s: mesh_decode(s, [device, device], group_blocks=1),
    }


def outcome(fn, stream: bytes) -> tuple:
    """``fn(stream)``'s outcome: ("ValueError",) or ("bytes", length,
    digest); any other exception propagates."""
    try:
        out = fn(stream)
    except ValueError:
        return ("ValueError",)
    return ("bytes", len(out), hashlib.sha256(out).hexdigest()[:16])


def corruptions(rng: random.Random, stream: bytes) -> dict:
    """One random bit flip and one truncation of a non-empty stream."""
    bad = bytearray(stream)
    i = rng.randrange(len(bad))
    bad[i] ^= 1 << rng.randrange(8)
    return {"flip": bytes(bad),
            "truncate": stream[:rng.randrange(len(stream))]}


class Run:
    """One fuzz run: its cases, failures and counts."""

    def __init__(self, device: torch.device, seed: int, dump_dir):
        self.device = device
        self.cpu = torch.device("cpu")
        self.seed = seed
        self.dump_dir = pathlib.Path(dump_dir)
        self.paths = decode_paths(device)
        self.cpu_paths = self.paths if device.type == "cpu" \
            else decode_paths(self.cpu)
        self.failures = 0
        self.cases = 0
        self.levels, self.styles = set(), set()
        self.corrupt = {p: {"raised": 0, "returned": 0} for p in self.paths}

    def case(self, r: int, level: int, data: bytes, path: str, fn,
             **artifacts: bytes):
        """Run one case, named on a line of its own first; a failure is
        counted and dumped.  Returns ``fn()``, or None if it failed."""
        print(f"[case] round={r} seed={self.seed} level={level} "
              f"size={len(data)} path={path}", flush=True)
        self.cases += 1
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 -- every failure is reported
            self.failures += 1
            tag = hashlib.md5(data).hexdigest()[:12]
            d = self.dump_dir / tag
            d.mkdir(parents=True, exist_ok=True)
            (d / "input").write_bytes(data)
            for name, blob_ in artifacts.items():
                (d / name).write_bytes(blob_)
            with open(d / "error", "a") as f:
                f.write(f"round {r} seed {self.seed} level {level} "
                        f"path {path}: {type(e).__name__}: {e}\n")
            print(f"[fail] round={r} path={path} {type(e).__name__}: {e} "
                  f"-> {d}", file=sys.stderr, flush=True)
            return None

    def round_trip(self, r, level, data, stream, geom: str) -> None:
        """Every path must decode ``stream`` back to ``data``."""
        for name, fn in self.paths.items():
            def check(fn=fn, name=name):
                if fn(stream) != data:
                    raise AssertionError(f"{name} decode differs")
            self.case(r, level, data, f"{geom} decode {name}", check,
                      stream=stream)

    def corrupted(self, r, level, data, stream, geom, rng) -> None:
        """Each path on a bit flip and a truncation of ``stream``."""
        for kind, bad in corruptions(rng, stream).items():
            def check(bad=bad):
                got = {p: outcome(fn, bad) for p, fn in self.paths.items()}
                for p, o in got.items():
                    self.corrupt[p]["raised" if o[0] == "ValueError"
                                    else "returned"] += 1
                if len({got["split"], got["groups"], got["mesh"]}) != 1:
                    raise AssertionError(f"split, groups and mesh differ: "
                                         f"{got}")
                if self.cpu_paths is not self.paths:
                    plain = {p: outcome(fn, bad)
                             for p, fn in self.cpu_paths.items()}
                    if plain != got:
                        raise AssertionError(f"{self.device} {got} != "
                                             f"cpu {plain}")
            self.case(r, level, data, f"{geom} corrupt {kind}", check,
                      stream=stream, corrupt=bad)

    def round(self, r: int, rng: random.Random, max_size: int) -> None:
        n = rng.randrange(0, max_size)
        style, data = blob(rng, n)
        level = rng.randrange(7)
        self.levels.add(level)
        self.styles.add(style)
        streams = {}

        def canonical():
            s = encode(data, level, self.device)
            if s != engine.encode(data, level):
                raise AssertionError("stream != native engine's")
            return s

        streams["canonical"] = self.case(r, level, data, "canonical encode",
                                         canonical)
        if n <= SMALL_MAX:
            def small():
                s = encode(data, level, self.device, **SMALL)
                if self.device.type != "cpu" and \
                        s != encode(data, level, self.cpu, **SMALL):
                    raise AssertionError("small stream != the CPU lane's")
                return s

            streams["small"] = self.case(r, level, data, "small encode",
                                         small)
        for geom, stream in streams.items():
            if stream is None:
                continue
            self.round_trip(r, level, data, stream, geom)
            if stream:
                self.corrupted(r, level, data, stream, geom, rng)

    def summary(self, rounds: int, seconds: float) -> dict:
        return dict(device=str(self.device), seed=self.seed, rounds=rounds,
                    cases=self.cases, failures=self.failures,
                    levels=sorted(self.levels), styles=sorted(self.styles),
                    paths=sorted(self.paths), corrupt=self.corrupt,
                    seconds=seconds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m libzling_tpu_torch.fuzz")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--max-size", type=int, default=262144)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--dump-dir", default=str(REPO / "build" / "fuzz"))
    args = ap.parse_args(argv)
    if args.max_size < 1:
        ap.error("--max-size must be >= 1")
    run = Run(resolve_device(args.device), args.seed, args.dump_dir)
    rng = random.Random(args.seed)
    t = time.perf_counter()
    for r in range(args.rounds):
        run.round(r, rng, args.max_size)
    print(json.dumps(run.summary(args.rounds, time.perf_counter() - t)),
          flush=True)
    return 1 if run.failures else 0


if __name__ == "__main__":
    sys.exit(main())
