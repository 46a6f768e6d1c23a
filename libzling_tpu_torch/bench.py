"""The benchmark harness: the counterpart of the repo-level ``bench.py`` and
of the device tools it runs (``tools/bench_device_encode.py``,
``bench_device_decode.py``, ``bench_device_api.py``, ``bench_device.py``,
``run_canonical_mesh.py --probe`` and ``bench_mesh_decode.py``).

    python -m libzling_tpu_torch.bench [--device cuda|cpu] [--host-mb 100]
        [--device-mb 32] [--literal-mb 8] [--repeats 3] [--levels 0-6]

The corpus is ``tools/make_corpus``'s (its default seed), of the larger of
``--host-mb`` (MB of 10**6 bytes, as bench.py's ``SIZE``) and
``--device-mb`` (MiB, as its device tools' ``--mb``); its size and
sha256 are recorded, since its seed text differs between machines.  Every
time is a list of ``--repeats`` calls after a first one, reported as
``{n, min, median}``; a rate comes from the min.  Sections, in bench.py's
order:

  ``levels``     the host pipeline (``pipeline.py``) encode and decode of
                 the ``--host-mb`` prefix at each of ``--levels``;
  ``reference``  the reference binary (``build/oracle/zling_ref``, built
                 by ``tools/build_reference.sh`` where its sources are) at
                 the same levels up to e4, else ``available: false``;
  ``<device>.tokenize``    K4 on the first 2 MiB at e0, one canonical
                 block, against its plain version (bench_device_encode);
  ``<device>.decode``      the native engine's e0 stream of the
                 ``--device-mb`` prefix through ``decode`` (fused: K3),
                 ``decode(fused=False)`` (split: K1 -> K2) and
                 ``decode_groups`` (one block a group), each kernel alone,
                 and K3 on the e0 stream of ``--literal-mb`` seeded random
                 bytes (bench_device_decode, bench.py:323-340);
  ``<device>.encode_api``  ``encode`` at e0 held to the engine's stream,
                 then timed, and K4 and K5 alone at its shapes
                 (bench_device_api);
  ``<device>.entropy``     K1 over every chunk of that stream, its tokens
                 held to the engine's (bench_device);
  ``<device>.lanes``       ``mesh_encode`` over the one device, plain and
                 with ``stage_probe``, the serial fractions and the scaling
                 model of bench.py:266-299; ``mesh_decode`` plain and with
                 its ``stage_probe`` (run_canonical_mesh --probe,
                 bench_mesh_decode);
  ``counters``   a ``ZLT_COUNTERS=1`` process's e0 host encode rate and the
                 engine's match-loop counters; the metrics registry.

``<device>`` is ``cuda`` (CUDA-event times of the kernels, a card's name
and power limit from ``nvidia-smi``) or ``cpu`` (every kernel's plain
version, host-clock times: no device metric).  ``--device cuda`` raises
without a GPU.

One JSON line -- ``{"metric", "value", "unit", "vs_baseline", "detail"}``,
the headline the host pipeline's e0 encode MB/s -- is printed after the
host table, after each device section and at the end, so a killed run
leaves its last complete line.

Gates (each exits non-zero with its message; none is caught): every
round trip; the host sizes equal to the reference's, and e5 smaller than
the reference's e4, where the reference ran; e6 smaller than e5 on a host
input of at least one 16 MiB block (bench.py gates it at 100 MB; on a
few MB of this corpus e6's deeper chains code a little larger than e5's);
every stream of the device equal to the native engine's; K4's units equal
to its plain version's.  ``ZLT_DEVICE_BUDGET_S`` (default 1800) bounds the
device sections together: a section starts only while budget is left,
and one it does not reach is listed under ``skipped`` with the seconds
left; the run then exits 3.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from . import api, container
from . import device as zdev
from . import group_decode as gd
from . import pipeline
from .group_encode import max_chunks_of
from .native import engine
from .ops import decode_fused as fk
from .ops import entropy_kernel as ek
from .ops import mtf as mops
from .ops import relabel_kernel as rlk
from .ops import resolve_kernel as rk
from .ops import tokenize_kernel as tkk
from .parallel import decode_mesh, mesh
from .tables import BLOCK_SIZE_IN, BLOCK_SIZE_ROLZ, SENTINEL_LEN
from .utils import metrics

REPO = pathlib.Path(__file__).resolve().parent.parent
METRIC = "encode_throughput_e0_100MB_markov"
MB, MiB = 10 ** 6, 1 << 20
TOKENIZE_BYTES = 2 * MiB       # bench_device_encode.py's slice
LITERAL_SEED = 0               # bench_device_decode.py --random
COUNTERS_S = 600               # the counters process, at most


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def gate(ok: bool, msg: str) -> None:
    """Exit non-zero with ``msg`` unless ``ok``."""
    if not ok:
        raise SystemExit(f"bench: gate failed: {msg}")


def spread(times) -> dict:
    return {"n": len(times), "min": min(times),
            "median": statistics.median(times)}


def emit(results: dict) -> None:
    """Print the one-line JSON (bench.py:67-83)."""
    e0 = results["levels"].get("e0")
    value = e0["enc_mbps"] if e0 else None
    base = results["reference"].get("e0", {}).get("enc_mbps")
    print(json.dumps({
        "metric": METRIC, "value": value, "unit": "MB/s",
        "vs_baseline": value / base if value and base else None,
        "detail": results}), flush=True)


def parse_levels(text: str) -> list[int]:
    """``0-6``, ``0,4,6`` or ``2``."""
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += range(int(a), int(b or a) + 1)
    if not out or not set(out) <= set(range(7)):
        raise ValueError(f"levels must lie in 0..6: {text!r}")
    return sorted(set(out))


def machine(dev: torch.device) -> dict:
    """The device, the card's name and power limit, the host's CPUs."""
    out = {"device": str(dev), "cpus": os.cpu_count(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "card": None}
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True)
        out.update(card=smi.stdout.strip().splitlines()[dev.index],
                   device_name=torch.cuda.get_device_name(dev),
                   device_count=torch.cuda.device_count())
    return out


# ---- the host sections -------------------------------------------------

def reference(data: bytes, levels, n: int) -> dict:
    """The reference binary at ``levels``, timed on the same bytes
    (bench.py:43-63).  Absent sources give ``available: false``; a build
    or a run that fails raises."""
    script = REPO / "tools" / "build_reference.sh"
    default = re.search(r"REF=\$\{REF:-([^}]+)\}", script.read_text())
    src = pathlib.Path(os.environ.get("REF") or default.group(1))
    binary = REPO / "build" / "oracle" / "zling_ref"
    if not binary.exists():
        if not (src / "src" / "libzling.cpp").exists():
            return {"available": False,
                    "why": f"no {binary.relative_to(REPO)} and no reference "
                           f"sources at {src} (tools/build_reference.sh)"}
        log("building the reference binary...")
        subprocess.run(["sh", str(script)], check=True, capture_output=True)
    work = REPO / "build" / "bench"
    work.mkdir(parents=True, exist_ok=True)
    src_file, enc, dec = work / "ref.in", work / "ref.z", work / "ref.out"
    src_file.write_bytes(data)
    out: dict = {"available": True, "binary": str(binary.relative_to(REPO))}
    for level in levels:
        log(f"reference e{level}...")
        t_enc, t_dec = [], []
        for _ in range(n):
            for args, times in (([f"e{level}", src_file, enc], t_enc),
                                (["d", enc, dec], t_dec)):
                t = time.perf_counter()
                subprocess.run([str(binary), *map(str, args)], check=True,
                               capture_output=True)
                times.append(time.perf_counter() - t)
        gate(dec.read_bytes() == data, f"round trip: reference e{level}")
        out[f"e{level}"] = dict(
            enc_s=spread(t_enc), dec_s=spread(t_dec),
            enc_mbps=len(data) / min(t_enc) / MB,
            dec_mbps=len(data) / min(t_dec) / MB,
            bytes=enc.stat().st_size)
    for f in (src_file, enc, dec):
        f.unlink()
    return out


def host_table(data: bytes, levels, n: int, ref: dict) -> dict:
    """``pipeline`` encode and decode at each level: a warm-up, then ``n``
    timed calls each (bench.py:96-130)."""
    rows: dict = {}
    for level in levels:
        log(f"pipeline e{level}...")
        stream = pipeline.encode(data, level)
        gate(pipeline.decode(stream) == data, f"round trip: pipeline "
             f"e{level}")
        t_enc, t_dec = [], []
        for _ in range(n):
            t = time.perf_counter()
            again = pipeline.encode(data, level)
            t_enc.append(time.perf_counter() - t)
            gate(again == stream, f"pipeline e{level}: two streams")
            t = time.perf_counter()
            back = pipeline.decode(stream)
            t_dec.append(time.perf_counter() - t)
            gate(back == data, f"round trip: pipeline e{level}")
        r = ref.get(f"e{level}")
        if r:
            gate(len(stream) == r["bytes"], f"e{level}: {len(stream)} bytes, "
                 f"the reference's {r['bytes']}")
        if level == 5 and "e4" in ref:
            gate(len(stream) < ref["e4"]["bytes"],
                 "e5 must out-compress the reference's e4")
        if level == 6 and "e5" in rows and len(data) >= BLOCK_SIZE_IN:
            gate(len(stream) < rows["e5"]["bytes"], "e6 must out-compress "
                 "e5")
        rows[f"e{level}"] = dict(
            enc_s=spread(t_enc), dec_s=spread(t_dec),
            enc_mbps=len(data) / min(t_enc) / MB,
            dec_mbps=len(data) / min(t_dec) / MB,
            bytes=len(stream), ratio_pct=len(stream) / len(data) * 100)
        log(f"  e{level}: enc {rows[f'e{level}']['enc_mbps']:.1f} MB/s, dec "
            f"{rows[f'e{level}']['dec_mbps']:.1f} MB/s, "
            f"{rows[f'e{level}']['ratio_pct']:.3f}%")
    return rows


def counters(corpus: pathlib.Path, nbytes: int, n: int) -> dict:
    """The e0 host encode with the engine's match-loop counters compiled in
    (``ZLT_COUNTERS=1``), in a process of its own, and its counters
    (bench.py:342-392)."""
    code = f"""
import json, time
from libzling_tpu_torch import pipeline
data = open({str(corpus)!r}, "rb").read()[:{nbytes}]
pipeline.encode(data, 0)
times = []
for _ in range({n}):
    t = time.perf_counter()
    pipeline.encode(data, 0)
    times.append(time.perf_counter() - t)
print(json.dumps({{"s": times, "counters": pipeline.counters()}}))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, ZLT_COUNTERS="1"),
                       capture_output=True, text=True, check=True,
                       timeout=COUNTERS_S)
    got = json.loads(r.stdout.splitlines()[-1])
    return dict(counters_on_enc_s=spread(got["s"]),
                counters_on_enc_mbps_e0=nbytes / min(got["s"]) / MB,
                native=got["counters"])


# ---- the device sections -----------------------------------------------

class Run:
    """What the device sections share: the device, its clock, the repeats,
    the ``--device-mb`` prefix and its engine stream, and their results."""

    def __init__(self, dev: torch.device, n: int, x: bytes, literal: bytes):
        self.dev, self.n, self.x, self.literal = dev, n, x, literal
        self.out: dict = {"clock": "cuda events" if dev.type == "cuda"
                          else "host perf_counter (plain versions)"}
        self._stream = None

    @property
    def stream(self) -> bytes:
        """The native engine's e0 stream of ``x``, made once."""
        if self._stream is None:
            self._stream = engine.encode(self.x, 0)
        return self._stream

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def ms(self, fn):
        """``fn()`` and its time in ms: CUDA events around it on a card,
        the host clock on the CPU."""
        if self.dev.type != "cuda":
            t = time.perf_counter()
            out = fn()
            return out, (time.perf_counter() - t) * 1e3
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    def wall(self, fn):
        """``fn()`` and its wall seconds, the device idle before and
        after."""
        self.sync()
        t = time.perf_counter()
        out = fn()
        self.sync()
        return out, time.perf_counter() - t

    def kernel_ms(self, fn, check):
        """``n`` launches of ``fn``, each timed (``ms``) and its output
        gated by ``check``; the spread of their ms, and the last output."""
        times = []
        for _ in range(self.n):
            out, ms = self.ms(fn)
            check(out)
            times.append(ms)
        return spread(times), out

    def e2e(self, name: str, fn, want: bytes) -> dict:
        """A first call, then ``n`` timed calls of a path; each must give
        ``want``."""
        first, sec = self.wall(fn)
        gate(first == want, f"{name}: differs")
        times = []
        for _ in range(self.n):
            got, s = self.wall(fn)
            gate(got == want, f"{name}: differs")
            times.append(s)
        return dict(first_call_s=sec, e2e_s=spread(times),
                    mbps=len(self.x) / min(times) / MB)


def same_as_first(what: str):
    """A check that every output equals the first one checked."""
    first = []

    def check(out):
        out = [t.cpu() for t in out]
        if not first:
            first.append(out)
        gate(all(torch.equal(a, b) for a, b in zip(out, first[0])),
             f"{what}: two launches on one input differ")
    return check


def k4_args(x: bytes, dev):
    """K4's arguments for ``x`` as ``group_encode.Part`` launches it at
    the canonical geometry: every 16 MiB block in one launch, level 0 in
    every chunk slot."""
    buf = torch.zeros(len(x) + SENTINEL_LEN, dtype=torch.uint8)
    buf[:len(x)] = torch.frombuffer(bytearray(x), dtype=torch.uint8)
    nb = -(-len(x) // BLOCK_SIZE_IN)
    offs = torch.arange(nb, dtype=torch.int64) * BLOCK_SIZE_IN
    lens = torch.clamp(len(x) - offs, max=BLOCK_SIZE_IN).to(torch.int32)
    params = tkk.level_params(
        np.zeros((nb, max_chunks_of(BLOCK_SIZE_IN, BLOCK_SIZE_ROLZ)),
                 np.int64), "cpu")
    return [a.to(dev) for a in (buf, offs, lens, offs, params)] + [
        BLOCK_SIZE_ROLZ, len(x)]


def s_tokenize(run: Run) -> dict:
    """K4 on the first 2 MiB at e0 (tools/bench_device_encode.py)."""
    x = run.x[:TOKENIZE_BYTES]
    args = k4_args(x, run.dev)

    def k4():  # K4's outputs less its run-ahead counts (they vary)
        return tkk.tokenize(*args)[:4]

    got, first = run.wall(k4)
    want = tkk.tokenize_plain(*k4_args(x, "cpu"))
    gate(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
         "K4's units differ from its plain version's")
    check = same_as_first("K4")
    check(got)
    times, _ = run.kernel_ms(k4, check)
    units = int(got[2][:, :, 0].sum())
    return dict(bytes=len(x), units=units, first_call_s=first,
                units_equal_plain=True, kernel_ms=times,
                ns_per_unit=times["min"] * 1e6 / units,
                mbps=len(x) / times["min"] / 1e3)


def s_decode(run: Run) -> dict:
    """The fused, split and group paths on the engine's e0 stream, each
    kernel alone, and K3 on an all-literal stream
    (tools/bench_device_decode.py, both modes)."""
    x, dev, stream = run.x, run.dev, run.stream
    out = dict(bytes=len(x), stream_bytes=len(stream))
    out["fused"] = run.e2e("round trip: decode (fused)",
                           lambda: api.decode(stream, dev), x)
    out["split"] = run.e2e("round trip: decode (split)",
                           lambda: api.decode(stream, dev, fused=False), x)
    out["groups"] = run.e2e("round trip: decode_groups",
                            lambda: gd.decode_groups(stream, dev,
                                                     group_blocks=1), x)

    def fused_ms(data: bytes, s: bytes) -> dict:
        args, size, _ = zdev.decode_args(s, dev)

        def check(o):
            gate(o[1][:, 2].sum() == 0
                 and o[0].cpu().numpy().tobytes() == data,
                 "round trip: K3 alone")
        return run.kernel_ms(lambda: fk.fused_decode(*args, out_size=size),
                             check)[0]

    st = gd.parse(stream)
    tokens = int(st.rlens.sum())
    out["tokens"] = tokens
    k3 = fused_ms(x, stream)
    out["fused"].update(kernel_ms={"decode_fused": k3},
                        ns_per_token=k3["min"] * 1e6 / tokens)
    k1, k2 = st.stage_split(0, len(st.rlens), dev)
    t_k1, (tok, status) = run.kernel_ms(lambda: ek.decode_chunks(*k1),
                                        same_as_first("K1"))
    gate(status[:, 2].sum() == 0, "K1 flagged a valid chunk")
    table = mops.initial_table(dev)

    def check_k2(o):
        gate(o[1][:, 2].sum() == 0 and o[0].cpu().numpy().tobytes() == x,
             "round trip: K2 alone")
    t_k2, _ = run.kernel_ms(lambda: rk.resolve_stream(tok, *k2, table),
                            check_k2)
    out["split"].update(kernel_ms={"entropy_decode": t_k1, "resolve": t_k2},
                        ns_per_token=(t_k1["min"] + t_k2["min"]) * 1e6
                        / tokens)
    lit = engine.encode(run.literal, 0)
    lt = int(gd.parse(lit).rlens.sum())
    k3 = fused_ms(run.literal, lit)
    out["literal"] = dict(bytes=len(run.literal), stream_bytes=len(lit),
                          seed=LITERAL_SEED, tokens=lt,
                          kernel_ms={"decode_fused": k3},
                          mbps=len(run.literal) / k3["min"] / 1e3,
                          ns_per_token=k3["min"] * 1e6 / lt)
    return out


def s_encode_api(run: Run) -> dict:
    """``encode`` at e0, its stream held to the engine's before it is
    timed, then K4 and K5 alone at its shapes
    (tools/bench_device_api.py)."""
    x, dev = run.x, run.dev
    out = run.e2e("encode: the device's stream vs the engine's",
                  lambda: api.encode(x, 0, device=dev), run.stream)
    args = k4_args(x, dev)
    t_k4, (units, _, cstat, _) = run.kernel_ms(
        lambda: tkk.tokenize(*args)[:4], same_as_first("K4"))
    rargs = (units, args[1], cstat[:, :, 0].sum(1), mops.initial_state(dev),
             mops.mtf_next(dev))
    t_k5, _ = run.kernel_ms(lambda: rlk.relabel(*rargs), same_as_first("K5"))
    out.update(bytes=len(x), stream_bytes=len(run.stream),
               blocks=len(args[1]), units=int(cstat[:, :, 0].sum()),
               kernel_ms={"tokenize": t_k4, "relabel": t_k5})
    return out


def s_entropy(run: Run) -> dict:
    """K1 over every chunk of the e0 stream, its tokens held to the
    native engine's (tools/bench_device.py)."""
    st = gd.parse(run.stream)
    k1, _ = st.stage_split(0, len(st.rlens), run.dev)
    times, (tokens, _) = run.kernel_ms(lambda: ek.decode_chunks(*k1),
                                       same_as_first("K1"))
    tokens = tokens.cpu().numpy()
    dll = engine._lib()
    buf = np.empty(BLOCK_SIZE_ROLZ + 16, np.uint16)
    at = 0
    chunks, _ = container.parse(run.stream)
    for c, ch in enumerate(chunks):
        arr = np.zeros(len(ch.payload) + 8, np.uint8)
        arr[:len(ch.payload)] = np.frombuffer(ch.payload, np.uint8)
        rc = dll.zlt_entropy_decode(arr.ctypes.data, len(ch.payload),
                                    ch.rlen, buf.ctypes.data)
        gate(rc == 0 and np.array_equal(buf[:ch.rlen],
                                        tokens[at:at + ch.rlen]),
             f"K1's tokens of chunk {c} differ from the engine's")
        at += ch.rlen
    return dict(chunks=len(chunks), tokens=at, tokens_equal_engine=True,
                kernel_ms=times, mtoks=at / times["min"] / 1e3,
                mbps=len(run.x) / times["min"] / 1e3)


def s_lanes(run: Run) -> dict:
    """``mesh_encode`` and ``mesh_decode`` over the one device, plain and
    probed, and the scaling model of bench.py:266-299 with this run's K5
    time a block (run_canonical_mesh.py --probe, bench_mesh_decode.py)."""
    x, dev, want = run.x, run.dev, run.stream
    got, enc_s = run.wall(lambda: mesh.mesh_encode(x, 0, [dev]))
    gate(got == want, "mesh_encode: the device's stream vs the engine's")
    stages: dict = {}
    got, probe_s = run.wall(lambda: mesh.mesh_encode(x, 0, [dev],
                                                     stage_probe=stages))
    gate(got == want, "mesh_encode (probed): the stream vs the engine's")
    n_blocks = -(-len(x) // BLOCK_SIZE_IN)
    d_blk = (stages["encode_step"] + stages["pack_step"]) / n_blocks
    h_cpu = (stages["length_tables"] + stages["validate"]
             + stages["frame"]) / n_blocks
    h_io = (stages["gather_freqs"] + stages["gather_pack_meta"]
            + stages["gather_words"]) / n_blocks
    # K5 is the group's serial carry: its time a block, from this run
    t_c = run.out["encode_api"]["kernel_ms"]["relabel"]["median"] / 1e3 \
        / run.out["encode_api"]["blocks"]
    tot = sum(stages.values())

    def eff(d: int, h: float) -> float:
        return min(1.0, max(d_blk, t_c + h) / max(d_blk, d * t_c, d * h))

    back, dec_s = run.wall(lambda: decode_mesh.mesh_decode(want, [dev]))
    gate(back == x, "round trip: mesh_decode")
    dstages: dict = {}
    back, dprobe_s = run.wall(lambda: decode_mesh.mesh_decode(
        want, [dev], stage_probe=dstages))
    gate(back == x, "round trip: mesh_decode (probed)")
    ent, res = dstages["entropy_s"], dstages["resolve_s"]
    return dict(
        bytes=len(x), blocks=n_blocks, encode_s=enc_s,
        encode_mbps=len(x) / enc_s / MB, encode_probe_s=probe_s,
        encode_stage_seconds=stages,
        encode_serial_fraction=(h_cpu + h_io) * n_blocks / tot,
        encode_serial_fraction_compute=h_cpu * n_blocks / tot,
        relabel_s_per_block=t_c,
        projected_scaling_8chip_this_host=eff(8, h_cpu + h_io),
        decode_s=dec_s, decode_mbps=len(x) / dec_s / MB,
        decode_probe_s=dprobe_s, decode_stage_seconds=dstages,
        decode_resolve_bound_mbps=len(x) / res / MB,
        decode_projected_mbps={d: len(x) / max(res, ent / d) / MB
                               for d in (1, 2, 4, 8)})


SECTIONS = {"tokenize": s_tokenize, "decode": s_decode,
            "encode_api": s_encode_api, "entropy": s_entropy,
            "lanes": s_lanes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m libzling_tpu_torch.bench",
        description="The codec's benchmark harness (one JSON line).")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--host-mb", type=float, default=100.0,
                    help="MB (10**6 bytes) for the host table")
    ap.add_argument("--device-mb", type=float, default=32.0,
                    help="MiB for the device sections")
    ap.add_argument("--literal-mb", type=float, default=8.0,
                    help="MiB of seeded random bytes for K3's literal path")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--levels", type=parse_levels, default="0-6")
    args = ap.parse_args(argv)
    if args.repeats < 1:
        ap.error("--repeats must be >= 1")
    dev = zdev.resolve_device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    host_n, dev_n = int(args.host_mb * MB), int(args.device_mb * MiB)
    lit_n = int(args.literal_mb * MiB)
    if min(host_n, dev_n, lit_n) < 1:
        ap.error("every size must hold at least one byte")

    sys.path.insert(0, str(REPO / "tools"))
    from make_corpus import cached_corpus

    log("generating/loading the corpus...")
    path = cached_corpus(max(host_n, dev_n))
    corpus = path.read_bytes()
    results: dict = {
        "corpus": dict(file=str(path.relative_to(REPO)), bytes=len(corpus),
                       sha256=hashlib.sha256(corpus).hexdigest(),
                       host_bytes=host_n, device_bytes=dev_n,
                       literal_bytes=lit_n, literal_seed=LITERAL_SEED),
        "machine": machine(dev), "repeats": args.repeats,
        "levels": {}, "reference": {}}
    host = corpus[:host_n]
    results["reference"] = reference(
        host, [l for l in args.levels if l <= 4], args.repeats)
    results["levels"] = host_table(host, args.levels, args.repeats,
                                   results["reference"])
    emit(results)

    deadline = time.monotonic() + float(
        os.environ.get("ZLT_DEVICE_BUDGET_S", "1800"))
    literal = np.random.default_rng(LITERAL_SEED).integers(
        0, 256, lit_n, dtype=np.uint8).tobytes()
    run = Run(dev, args.repeats, corpus[:dev_n], literal)
    results[dev.type] = run.out
    skipped = results["skipped"] = {}
    for name, section in SECTIONS.items():
        left = deadline - time.monotonic()
        if left <= 0:
            skipped[f"{dev.type}.{name}"] = left
            continue
        if dev.type == "cuda" and "build_s" not in run.out:
            from . import _build

            t = time.perf_counter()
            _build.lib()
            run.out["build_s"] = time.perf_counter() - t
        log(f"{dev.type}.{name}...")
        run.out[name] = section(run)
        emit(results)

    log("host e0 with the engine's counters compiled in...")
    got = counters(path, host_n, args.repeats)
    results["counters_on_enc_mbps_e0"] = got.pop("counters_on_enc_mbps_e0")
    results["counters_on_enc_s"] = got.pop("counters_on_enc_s")
    results["counters"] = dict(native=got["native"],
                               registry=metrics.registry.snapshot()
                               ["counters"])
    emit(results)
    if skipped:
        log(f"bench: the device budget did not reach {sorted(skipped)}")
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
