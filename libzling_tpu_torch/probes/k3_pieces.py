"""What each piece of K3's and K2's redesigns gives, at the main-path
shapes (e0; K2 also e4).

    python -m libzling_tpu_torch.probes.k3_pieces --prepare   # git checkout
    python -m libzling_tpu_torch.probes.k3_pieces             # on the card

Not a counterpart of a TPU probe.  K3 (``csrc/decode_fused.cu``) was
redesigned in two pieces: a producer warp that runs the Huffman reader
ahead of the resolver, and a reordered match step in ``csrc/rolz.cuh``
(the next context taken from the registers that loaded the copy's source,
the next match's ring slot loaded as soon as that context is known, the
copy's stores after it), which K2 (``csrc/resolve.cu``) shares.  K2 was
then redesigned around a producer warp staging its tokens into shared
memory by bulk copies and a window of the block's latest output in shared
memory, which bulk copies move to the output.
``--prepare`` writes one source set a variant under ``build/k3_pieces/``,
from the sources of the commits before the redesigns (``--before`` for
K3's, ``K2_BEFORE`` for K2's) and of this checkout:

  before          the one-thread fused decoder and the old match step
  producer        the producer warp and the old match step
  match           the one-thread fused decoder and the reordered match step
  K2 before       the resolve kernel and the old match step
  K2 one thread   the one-thread resolve kernel and the reordered match
                  step, tokens read from global memory
  K2 one thread, L1 hint   the same, asking for the least shared memory
                  (the L1 preference this checkout's K2 asks for)

The run (it needs no git) builds each set into its own library, one nvcc
each, all at once; encodes the 32 MiB e0 corpus of ``chip_smoke.py`` on the
card, and its first 20 MiB at e4; and times every variant and this
checkout's own K3 ("both", e0) and K2 ("K2 after": the producer and the
window; e0 and e4) on those streams, one launch a reading between CUDA
events, in the order a b c d d c b a.  Every variant must give the input's
bytes and the checkout's per-chunk statuses.  The last line is a JSON
object of the readings.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

from .. import _build

BEFORE = "8ed2dd3"         # the last commit before K3's redesign
K2_BEFORE = "63dc0dc"      # the last commit before K2's producer and window
OUT = _build._REPO / "build" / "k3_pieces"
MiB = 1 << 20

# the old match step under the new call (the next token is ignored), and
# the new one under the old call (the next token is unknown)
_IGNORE_NEXT = [("bool head_byte(int t) {", "bool head_byte(int t, int, int) {"),
                ("bool match(int t, int midx) {",
                 "bool match(int t, int midx, int, int) {"),
                ("bool simple(int t) {", "bool simple(int t, int, int) {")]
_NO_NEXT = [("bool head_byte(int t, int nt, int nmidx) {",
             "bool head_byte(int t, int nt = -1, int nmidx = 0) {"),
            ("bool match(int t, int midx, int nt, int nmidx) {",
             "bool match(int t, int midx, int nt = -1, int nmidx = 0) {"),
            ("bool simple(int t, int nt, int nmidx) {",
             "bool simple(int t, int nt = -1, int nmidx = 0) {")]

# the one-thread resolve kernel launched with the L1 preference K2 asks for
_MAX_L1 = [("cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);",
            "cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);\n"
            "  cudaFuncSetAttribute(resolve_kernel,\n"
            "      cudaFuncAttributePreferredSharedMemoryCarveout,\n"
            "      cudaSharedmemCarveoutMaxL1);")]

# variant -> (kernel source, its revision, rolz.cuh's revision, rolz.cuh's
# edits, the kernel source's edits); None is this checkout
VARIANTS = {
    "before": ("decode_fused.cu", BEFORE, BEFORE, [], []),
    "producer": ("decode_fused.cu", None, BEFORE, _IGNORE_NEXT, []),
    "match": ("decode_fused.cu", BEFORE, None, _NO_NEXT, []),
    "K2 before": ("resolve.cu", BEFORE, BEFORE, [], []),
    "K2 one thread": ("resolve.cu", K2_BEFORE, K2_BEFORE, [], []),
    "K2 one thread, L1 hint": ("resolve.cu", K2_BEFORE, K2_BEFORE, [],
                               _MAX_L1),
}


def _source(name: str, rev: str | None) -> str:
    if rev is None:
        return (_build._CSRC / name).read_text()
    return subprocess.run(
        ["git", "show", f"{rev}:libzling_tpu_torch/csrc/{name}"],
        cwd=_build._REPO, capture_output=True, text=True, check=True).stdout


def _edit(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"k3_pieces: {old!r} is not in the source once")
        src = src.replace(old, new)
    return src


def _dir(name: str) -> pathlib.Path:
    return OUT / name.replace(" ", "_")


def prepare(before: str) -> None:
    """Write each variant's sources: this checkout's headers, then the
    variant's kernel source and ``rolz.cuh``."""
    def rev(r):
        return before if r == BEFORE else r

    for name, (kernel, krev, rrev, edits, kedits) in VARIANTS.items():
        d = _dir(name)
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for h in _build._CSRC.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        (d / kernel).write_text(_edit(_source(kernel, rev(krev)), kedits))
        (d / "rolz.cuh").write_text(
            _edit(_source("rolz.cuh", rev(rrev)), edits))
        print(f"{name}: {d}", flush=True)


def build() -> dict:
    """Each prepared variant as a loaded library, nvcc'd all at once."""
    nvcc = _build._nvcc()
    procs = {}
    for name, (kernel, *_) in VARIANTS.items():
        d = _dir(name)
        if not (d / kernel).exists():
            raise RuntimeError(f"k3_pieces: {d} is missing; run --prepare")
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(d / "k.so"),
             str(d / kernel)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        dll = ctypes.CDLL(str(_dir(name) / "k.so"))
        entry = ("zlt_resolve" if VARIANTS[name][0] == "resolve.cu"
                 else "zlt_decode_fused")
        getattr(dll, entry).argtypes = _build._SIGNATURES[entry]
        getattr(dll, entry).restype = ctypes.c_int
        libs[name] = dll
    return libs


@contextlib.contextmanager
def kernels_from(dll):
    """The wrappers launch from ``dll`` instead of the kernel library."""
    _build.lib()
    saved = _build._LIBS["kernels"]
    _build._LIBS["kernels"] = dll
    try:
        yield
    finally:
        _build._LIBS["kernels"] = saved


def corpus() -> bytes:
    """``chip_smoke.py``'s 32 MiB corpus: the Markov corpus with 1 MiB of
    seeded random bytes in its middle."""
    sys.path.insert(0, str(_build._REPO / "tools"))
    from make_corpus import make_corpus

    data = bytearray(make_corpus(32 * MiB))
    rng = np.random.default_rng(20261016)
    mid = len(data) // 2 - MiB // 2
    data[mid:mid + MiB] = rng.integers(0, 256, MiB, dtype=np.uint8).tobytes()
    return bytes(data)


def on_dev(args, dev):
    """The tensors of an argument tuple moved to ``dev``."""
    return [a.to(dev) if torch.is_tensor(a) else a for a in args]


def run() -> dict:
    import libzling_tpu_torch as z
    from libzling_tpu_torch import device as zdev
    from libzling_tpu_torch import group_decode as gd
    from libzling_tpu_torch.ops import decode_fused as fk
    from libzling_tpu_torch.ops import entropy_kernel as ek
    from libzling_tpu_torch.ops import mtf as mops
    from libzling_tpu_torch.ops import resolve_kernel as rk

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = build()
    data = corpus()
    table = mops.initial_table(dev)

    def resolve_call(stream):
        """K2 over every chunk of ``stream``, from K1's tokens on the card."""
        st = gd.parse(stream)
        k1, k2 = (on_dev(a, dev)
                  for a in st.stage_split(0, len(st.rlens), "cpu"))
        tokens = ek.decode_chunks(*k1)[0]
        return lambda: rk.resolve_stream(tokens, *k2, table)

    stream = z.encode(data, 0)
    dargs, size, _ = zdev.decode_args(stream, dev)
    e4 = data[:20 * MiB]   # chip_smoke.py's e4 input
    k2_names = ["K2 before", "K2 one thread", "K2 one thread, L1 hint",
                "K2 after"]
    # kernel -> (call, variants, the bytes it gives); the first variant is
    # the base of vs_before
    kernels = {
        "K3": (lambda: fk.fused_decode(*dargs, out_size=size),
               ["before", "producer", "match", "both"], data),
        "K2": (resolve_call(stream), k2_names, data),
        "K2 e4": (resolve_call(z.encode(e4, 4)), k2_names, e4),
    }
    summary = {}
    for kname, (call, names, want_bytes) in kernels.items():
        want = call()
        assert want[0].cpu().numpy().tobytes() == want_bytes
        want_status = want[1].cpu()
        readings = {}
        for name in names + names[::-1]:
            dll = libs.get(name)
            ctx = kernels_from(dll) if dll else contextlib.nullcontext()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            with ctx:
                start.record()
                got = call()
                end.record()
            torch.cuda.synchronize()
            assert got[0].cpu().numpy().tobytes() == want_bytes, name
            assert torch.equal(got[1].cpu(), want_status), name
            ms = start.elapsed_time(end)
            readings.setdefault(name, []).append(ms)
            print(f"{kname} {name:10s} {ms:10.1f} ms  exact", flush=True)
        base = np.mean(readings[names[0]])
        summary[kname] = {
            name: dict(ms=ms, mean_ms=float(np.mean(ms)),
                       vs_before=float(np.mean(ms) / base))
            for name, ms in readings.items()}
    return dict(card=card, bytes=len(data), variants=summary)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prepare", action="store_true",
                    help="write the variants' sources (needs git)")
    ap.add_argument("--before", default=BEFORE,
                    help="the commit before the redesign")
    args = ap.parse_args(argv)
    if args.prepare:
        prepare(args.before)
        return 0
    if not torch.cuda.is_available():
        print("k3_pieces: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
