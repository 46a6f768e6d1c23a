"""Cost probes on the card: the counterparts of the TPU probes in ``tools/``.

    python -m libzling_tpu_torch.probes.tokenize_cost [N]   # K4's unit body
    python -m libzling_tpu_torch.probes.scalar_cost [--match]  # K1, K2 steps
    python -m libzling_tpu_torch.probes.limits              # L2, shared mem

Each probe is a CUDA kernel (``csrc/probes/*.cu``, built into its own
library by ``_build.probes_lib()``) that computes what its TPU probe
computes -- the same initial state, loop arithmetic and result word --
with the data where the port's real kernel keeps it.  It is one CTA in
which thread 0 walks the loop, as K1, K2 and K4 walk their chains, and it
returns word 0 (the TPU probe's result), word 1 (a checksum of the values
the loop loads) and the ``clock64()`` cycles of the loop.  Beside each
wrapper is a plain version in Python with int32 wrap-around; a wrapper
given CPU tensors runs it, given CUDA tensors it launches the kernel or
raises.  ``measure`` times a probe both ways: the best of 3 warm launches
with CUDA events around the launch alone (ns per iteration) and the
kernel's own cycle count (cycles per iteration); the SM clock is their
ratio.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

MASK = 0xFFFFFFFF


def i32(x: int) -> int:
    """``x`` wrapped to a signed 32-bit integer."""
    x &= MASK
    return x - (1 << 32) if x & 0x80000000 else x


def srl(x: int, s: int) -> int:
    """Logical right shift of a 32-bit word; XLA's rule for the amount."""
    return (x & MASK) >> s if 0 <= s < 32 else 0


def shl(x: int, s: int) -> int:
    """Left shift of a 32-bit word (an unsigned result); XLA's rule."""
    return (x << s) & MASK if 0 <= s < 32 else 0


@dataclass
class Result:
    """A probe's two words (word 0 as the TPU's int32, word 1 as u32); on
    the card, the loop's cycles; from a plain version, the final contents
    of the arrays the TPU probe keeps in scratch (name -> list of ints),
    which the tests hold to the TPU probe's."""
    word0: int
    word1: int
    cycles: int | None = None
    state: dict | None = field(default=None, compare=False, repr=False)


def on_card(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (run
    the plain version); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def out_words(device) -> torch.Tensor:
    """The u64 [3] output of a probe kernel (word 0, word 1, cycles)."""
    return torch.zeros(3, dtype=torch.int64, device=device)


# set by ``measure``: the start and end events to record around the next
# launch, so that its window holds the kernel and none of the wrapper's
# set-up copies or its read-back
_WINDOW: list = []


def launch(fn_name: str, *args, ref: torch.Tensor) -> None:
    """Call probe entry point ``fn_name`` on ``ref``'s stream; raise if the
    launch was refused.  Tensors among ``args`` pass as device pointers."""
    from .. import _build

    lib = _build.probes_lib()
    cargs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    stream = torch.cuda.current_stream(ref.device)
    if _WINDOW:
        _WINDOW[0].record(stream)
    err = getattr(lib, fn_name)(*cargs, stream.cuda_stream)
    if _WINDOW:
        _WINDOW[1].record(stream)
    _build.check(err, fn_name)


def read(out: torch.Tensor) -> Result:
    """The words a probe kernel wrote (synchronises)."""
    w0, w1, cyc = out.cpu().tolist()
    return Result(i32(w0), w1 & MASK, cyc)


REPS = 3


def measure(call, n: int) -> dict:
    """Time ``call()`` (one probe launch returning its Result, or a tuple
    that starts with it): one warm-up, then the best of ``REPS`` launches,
    each between two CUDA events recorded just before and just after the
    launch itself.  Returns the result, ms, ns and cycles per iteration
    (``n`` iterations) and the SM clock they imply, in GHz."""
    def run() -> Result:
        r = call()
        return r[0] if isinstance(r, tuple) else r

    res = run()
    best, best_cyc = math.inf, None
    for _ in range(REPS):
        _WINDOW[:] = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        try:
            r = run()
            start, end = _WINDOW
        finally:
            _WINDOW.clear()
        end.synchronize()
        ms = start.elapsed_time(end)
        if ms < best:
            best, best_cyc = ms, r.cycles
        res = r
    ns = best * 1e6 / max(n, 1)
    cyc = best_cyc / max(n, 1)
    return dict(result=res, ms=best, n=n, ns_per_iter=ns,
                cycles_per_iter=cyc, ghz=cyc / ns if ns else float("nan"))


def report(title: str, rows: list[dict], unit: str = "iter") -> None:
    """Print one line a variant: ns and cycles per ``unit``, the implied
    SM clock, the delta in cycles against the previous row, the words."""
    print(f"{title}", flush=True)
    prev = None
    for r in rows:
        delta = "" if prev is None else \
            f"  delta {r['cycles_per_iter'] - prev:+8.1f} cyc"
        res = r["result"]
        print(f"  {r['name']:28s} {r['ns_per_iter']:10.2f} ns/{unit} "
              f"{r['cycles_per_iter']:9.1f} cyc  {r['ghz']:.3f} GHz  "
              f"[r={res.word0}, ck={res.word1}]{delta}", flush=True)
        prev = r["cycles_per_iter"]
