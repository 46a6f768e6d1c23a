"""One run of one cell: set-up, the measured window, the check, the line.

In order: load the cell's files; make the input from the seed (a thread,
while the system under test starts; a decode cell's input stream is the
reference's, made on the same thread); warm up on one whole call of the
cell's own operation on the cell's own input, so every shape and buffer
the window uses is built; then the window, a closed loop of one caller:
whole calls back to back until ``seconds`` have passed, every output
kept.  Once the window has closed, the cards' peaks read and the
program's state freed, the reference works out an encode cell's canonical
stream, and every output is compared, byte for byte, with the reference
(encode: its canonical stream; decode: the input).  ``correct`` also
needs every card the cell gives (its ``chips``) used in the window
(``devices_unused``, limit 0): a card counts as used when the program's
allocator held memory on it during the window (``Port.device_info``).

``setup_s`` runs from the process's start to the window, less the time
the set-up waited for the reference's stream (decode cells), which is
reported apart (``reference_wait_s``).

The system under test is ``Port`` (``libzling_tpu_torch.api`` on a
device), or the control ``Control`` (the reference with its MTF state and
level reset at every block) in its place.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

from benchmark.harness import corpus, layout, reading
from benchmark.reference import codec

OPS = ("encode", "decode")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class NoDevice(RuntimeError):
    """The machine lacks the CUDA devices the cell asks for."""


class Port:
    """The program under test: ``libzling_tpu_torch.api`` on ``device``.
    On CUDA the cell's ``chips`` devices must be visible.  Every visible
    card is watched: ``reset_peak`` (before the window) synchronises each
    and resets its peak, and ``device_info`` (after it) counts the cards
    on which the program's allocator held memory during the window, so a
    buffer kept from the set-up counts and a card touched only in the
    warm-up does not.  The entry is looked up at every call, so a test may
    replace it."""

    def __init__(self, device: str = "cuda", chips: int = 1):
        t = time.perf_counter()
        import torch

        self.seconds = {"torch_import_s": time.perf_counter() - t}
        self.torch, self.device = torch, device
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n < chips:
                raise NoDevice(f"the cell needs {chips} CUDA device(s); "
                               f"{n} found")
            t = time.perf_counter()
            torch.cuda.init()
            torch.zeros(1, device=device)
            self.seconds["cuda_init_s"] = time.perf_counter() - t
        t = time.perf_counter()
        from libzling_tpu_torch import api

        self.seconds["port_import_s"] = time.perf_counter() - t
        self.api = api

    def encode(self, data: bytes, level: int) -> bytes:
        return self.api.encode(data, level, device=self.device)

    def decode(self, stream: bytes) -> bytes:
        return self.api.decode(stream, device=self.device)

    def reset_peak(self) -> None:
        if self.cuda:
            t = self.torch.cuda
            for i in range(t.device_count()):
                t.synchronize(i)
                t.reset_peak_memory_stats(i)

    def device_info(self) -> dict:
        """``count``: the cards used in the window; ``kind``: their name
        (one name, or this raises); ``memory_peak_bytes``: the fullest
        card's peak; ``devices``: each used card's index and peak."""
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0}
        t = self.torch.cuda
        peaks = [int(t.max_memory_allocated(i))
                 for i in range(t.device_count())]
        used = [i for i, p in enumerate(peaks) if p > 0]
        kinds = {t.get_device_name(i) for i in used or [0]}
        if len(kinds) != 1:
            raise RuntimeError(f"the cards used differ: {sorted(kinds)}")
        return {"platform": "gpu", "kind": kinds.pop(), "count": len(used),
                "memory_peak_bytes": max(peaks, default=0),
                "devices": [{"index": i, "memory_peak_bytes": peaks[i]}
                            for i in used]}

    def release(self) -> None:
        if self.cuda:
            self.torch.cuda.empty_cache()

    def profile(self):
        prof = self.torch.profiler
        acts = [prof.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(prof.ProfilerActivity.CUDA)
        return prof.profile(activities=acts)

    def span(self, name: str):
        return self.torch.profiler.record_function(name)


class Control:
    """The control: the reference in the program's place with the MTF
    state and level reset at every 16 MiB block (``codec.*_blocks_apart``),
    which breaks the configuration's guarantees from the second block on."""

    seconds: dict = {}

    def encode(self, data: bytes, level: int) -> bytes:
        return codec.encode_blocks_apart(data, level)

    def decode(self, stream: bytes) -> bytes:
        return codec.decode_blocks_apart(stream)

    def reset_peak(self) -> None:
        pass

    def device_info(self) -> dict:
        return {"platform": "cpu", "kind": "reference (control)", "count": 1,
                "memory_peak_bytes": 0}

    def release(self) -> None:
        pass

    def span(self, name: str):
        return contextlib.nullcontext()


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"


class Inputs(threading.Thread):
    """Makes the input off the main thread, and for a decode cell the
    reference's stream of it, which is that cell's input."""

    def __init__(self, spec: dict, seed: int, level: int, op: str):
        super().__init__(daemon=True)
        self.spec, self.seed, self.level, self.op = spec, seed, level, op
        self.data = self.stream = self.error = None
        self.seconds = {}
        self.data_ready = threading.Event()
        self.data_at = self.stream_at = None    # perf_counter when made

    def run(self) -> None:
        try:
            t = time.perf_counter()
            self.data = corpus.generate(self.spec, self.seed)
            self.data_at = time.perf_counter()
            self.seconds["data_s"] = self.data_at - t
            self.data_ready.set()
            if self.op == "decode":
                self.stream = codec.encode(self.data, self.level)
                self.stream_at = time.perf_counter()
                self.seconds["reference_s"] = self.stream_at - self.data_at
        except BaseException as e:       # re-raised on the main thread
            self.error = e
        finally:
            self.data_ready.set()

    def wait_data(self) -> bytes:
        self.data_ready.wait()
        if self.error is not None:
            self.join()
            raise self.error
        return self.data

    def wait(self) -> None:
        self.join()
        if self.error is not None:
            raise self.error


class Quantities(dict):
    """The format's own quantities of one call, ``literals`` worked out
    from the reference's stream when first read."""

    def __init__(self, data: bytes, stream: bytes):
        heads, _ = codec.chunks(stream)
        super().__init__(raw_bytes=len(data), stream_bytes=len(stream),
                         tokens=sum(c.rlen for c in heads))
        self.stream = stream

    def __missing__(self, key):
        if key != "literals":
            raise KeyError(key)
        self["tokens"], self["literals"] = codec.token_counts(self.stream)
        return self["literals"]


def differing(out, want: bytes) -> int:
    """Bytes of ``out`` that differ from ``want``: positions of the common
    length that differ, plus the difference in length."""
    if out is None:
        return len(want)
    n = min(len(out), len(want))
    a = np.frombuffer(out, np.uint8, n)
    b = np.frombuffer(want, np.uint8, n)
    return int(np.count_nonzero(a != b)) + abs(len(out) - len(want))


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        system=Port, t0: float | None = None, bench=None,
        corpus_override: dict | None = None) -> dict:
    """One run of ``cell_name``; returns the result line's object (its
    ``checks`` last), with ``info`` (lines for before it) and
    ``check_lines`` (the compared numbers and their limits) beside it."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = bench or layout.Benchmark()
    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    op, level = traffic["op"], int(cfg["level"])
    if op not in OPS:
        raise ValueError(f"traffic {cell['traffic']}: op {op!r} not in {OPS}")
    if (cfg["block_size"], cfg["chunk_tokens"]) != (codec.BLOCK_BYTES,
                                                    codec.CHUNK_TOKENS):
        raise ValueError("the reference codes only the canonical geometry")
    spec = {**cfg["corpus"], **(corpus_override or {})}

    inputs = Inputs(spec, seed, level, op)
    inputs.start()
    sut = system()
    system_at = time.perf_counter()
    data = inputs.wait_data()
    reference_wait_s = 0.0
    if op == "encode":
        call_in = data
    else:
        # the input stream is the reference's: the set-up does not count
        # the time it waited for it past the system and the data
        inputs.wait()
        call_in = inputs.stream
        reference_wait_s = max(0.0, inputs.stream_at
                               - max(system_at, inputs.data_at))

    def call():
        if op == "encode":
            return sut.encode(call_in, level)
        return sut.decode(call_in)

    t = time.perf_counter()
    try:
        call()
    except Exception:     # the window's calls will raise too, and count
        log("the warm-up call raised:\n" + traceback.format_exc())
    warm_s = time.perf_counter() - t
    inputs.wait()
    setup_s = time.perf_counter() - t0 - reference_wait_s
    info = {"cell": cell_name, "seed": seed, "op": op, "level": level,
            "raw_bytes": len(data),
            "corpus_sha256": hashlib.sha256(data).hexdigest(),
            "setup": {**inputs.seconds, "system_s": system_at - t0,
                      **sut.seconds, "warmup_s": warm_s,
                      "reference_wait_s": reference_wait_s}}
    log(f"[setup] {setup_s:.3f} s {info['setup']}")

    # the window: a closed loop of one caller
    outputs, call_s, failed = [], [], 0
    sut.reset_peak()
    profiler = sut.profile() if trace else contextlib.nullcontext()
    with profiler as prof:
        with sut.span(reading.WINDOW):
            start = time.perf_counter()
            while time.perf_counter() - start < seconds:
                t = time.perf_counter()
                out = None
                with sut.span(reading.CALL):
                    try:
                        out = call()
                    except Exception:        # counted as failed, reported
                        failed += 1
                        log(traceback.format_exc())
                outputs.append(out)
                call_s.append(time.perf_counter() - t)
            window_s = time.perf_counter() - start
    device = sut.device_info()
    sut.release()
    log(f"[window] {len(outputs)} calls in {window_s:.3f} s: "
        f"{[round(s, 4) for s in call_s]}")

    # the check: every output of the window against the reference, which
    # works out an encode cell's stream only now
    if op == "encode":
        t = time.perf_counter()
        stream = codec.encode(data, level)
        info["reference_s"] = time.perf_counter() - t
        want = stream
    else:
        stream, want = call_in, data
    info.update(stream_bytes=len(stream),
                ratio_pct=100.0 * len(stream) / max(1, len(data)))
    diff = sum(differing(o, want) for o in outputs)
    unused = max(0, int(cell.get("chips", 1)) - device["count"])
    checks = {"bytes_differing": {"value": diff, "limit": 0},
              "calls_failed": {"value": failed, "limit": 0},
              "devices_unused": {"value": unused, "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    done = len(outputs) - failed
    info.update(calls=len(outputs), call_s=call_s, card=card()
                if device["platform"] == "gpu" else "none")

    metrics = {}
    if not trace:
        values = {"setup_s": setup_s,
                  f"{op}_MBps": len(data) * done / 1e6 / window_s}
        for m in bench.end_to_end(cell_name):
            if m["name"] not in values:
                raise RuntimeError(f"no value for end-to-end metric "
                                   f"{m['name']!r} in an {op} cell")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        with tempfile.TemporaryDirectory() as d:
            path = f"{d}/trace.json"
            prof.export_chrome_trace(path)
            tr = reading.Trace.load(path)
        q = Quantities(data, stream)
        rd = reading.Reading(tr, bench.stages(), op, q, done,
                             reading.peak_bandwidth(device["kind"]))
        for m in bench.per_layer(cell_name):
            v = bench.reader(m["name"])(rd)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device.update(busy_s=rd.busy_s, window_s=rd.window_s)
        for d in device.get("devices", []):
            d["busy_s"] = rd.card_busy_s.get(d["index"], 0.0)
        info["quantities"] = dict(q)
        info["traced_MBps"] = len(data) * done / 1e6 / window_s
        breakdown = rd.breakdown()
    result = {"correct": correct, "attempted": len(outputs), "failed": failed,
              "metrics": metrics, "device": device}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return {"result": result, "info": info,
            "check_lines": [f"check {k} {c['value']} limit {c['limit']}"
                            for k, c in checks.items()]}


def emit(out: dict) -> None:
    """Print a run: the info line, the result line last on stdout, and the
    compared numbers beside their limits last on stderr."""
    print("info " + json.dumps(out["info"]), flush=True)
    print(json.dumps(out["result"]), flush=True)
    for line in out["check_lines"]:
        log(line)
