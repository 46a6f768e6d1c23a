"""The card's limits that shape K1, K2 and K4.

Counterpart of ``tools/probe_limits.py``:

    python -m libzling_tpu_torch.probes.limits

The TPU probes only compile, and a lowering that fails is their "FAIL".
These launch (kernels in ``csrc/probes/limits.cu``): a refused launch is
the card's "FAIL", read from ``cudaGetLastError()``.  Each is beside its
plain version:

  PL1 ``resident``      (``probe_vmem`` :30) does per-lane state stay on
      chip?  Here that is the 50 MB L2: a dependent chase of 2**20 steps
      over a random single cycle at 16 KB .. 256 MB, with no dynamic
      shared memory and with K3's 231,192 bytes (which shrink L1);
  PL2 ``smem_ceiling``  (``probe_smem`` :50) the dynamic shared-memory
      ceiling: 48 .. 227 KB launch, the opt-in limit + 1 byte is refused;
  PL3/PL4 ``dyn_shift`` (``probe_dyn_roll`` :70, ``probe_dyn_roll2d`` :88)
      rotations by a run-time shift: a 128-byte row held by one warp
      (shuffles and a funnel shift), and an (8, 128) i32 array along lanes;
  PL5/PL6 ``dyn_index`` (``probe_onehot_read`` :106, ``probe_onehot_write``
      :129) a byte read at a run-time row and lane and the lane written
      there, in a (64, 128) u8 shared array; and the same in a 32-entry
      per-thread array, which nvcc puts in local memory;
  PL7 ``warp_mix``      (``probe_scalar_while_vector_mix`` :151) a scalar
      loop reading one byte of a row a step, alone and with one warp-wide
      ``__ballot_sync`` compare of 32 bytes a step.

Loops run ``n`` steps so that the cycle counter gives the cost of one.  A
CPU tensor runs the plain version, a CUDA one the kernel.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from ..device import resolve_device
from . import (MASK, Result, i32, launch, measure, on_card, out_words, read)

SOURCE = "libzling_tpu_torch/csrc/probes/limits.cu"

STEPS = 1 << 20
KB, MB = 1024, 1 << 20
RESIDENT_BYTES = (16 * KB, 192 * KB, 4 * MB, 10 * MB + MB // 2, 21 * MB,
                  42 * MB, 84 * MB, 256 * MB)
K3_SMEM = 231_192     # csrc/decode_fused.cu: kSmem
SMEM_KB = (48, 64, 128, 192, 227)
X = 0x5A17C0DE


@functools.lru_cache(maxsize=None)
def random_cycle(nwords: int, seed: int) -> np.ndarray:
    """u32 next-indices forming ONE cycle through all ``nwords`` slots in a
    random order (the distribution of Sattolo's algorithm), from a numpy
    seed.  Cached: the card check, its plain side and the timing share
    one array (read only)."""
    order = np.random.default_rng(seed).permutation(nwords).astype(np.uint32)
    nxt = np.empty(nwords, np.uint32)
    nxt[order] = np.roll(order, -1)
    return nxt


# ---- PL1 -------------------------------------------------------------------

def resident(steps: int, nxt: torch.Tensor, smem_bytes: int = 0) -> Result:
    """``steps`` dependent loads x = nxt[x] from x = 0 (``nxt`` i32 holding
    u32 indices), launched with ``smem_bytes`` of dynamic shared memory."""
    if not on_card(nxt, "resident"):
        return resident_plain(steps, nxt)
    if nxt.dtype != torch.int32:
        raise ValueError("resident: nxt must be i32")
    out = out_words(nxt.device)
    launch("zlp_resident", steps, nxt.contiguous(), smem_bytes, out, ref=out)
    resident.launches += 1
    return read(out)


resident.launches = 0


def resident_plain(steps: int, nxt: torch.Tensor) -> Result:
    t = nxt.cpu().numpy().view(np.uint32)
    x = ck = 0
    for _ in range(steps):
        x = int(t[x])
        ck += x
    return Result(i32(x), ck & MASK)


# ---- PL2 -------------------------------------------------------------------

def smem_ceiling(nbytes: int, device="cuda") -> Result:
    """Launch with ``nbytes`` of dynamic shared memory: fill word k with
    k ^ X, write X to word 0; word 0 is the last word, word 1 the sum of
    all.  Raises if the launch is refused."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return smem_ceiling_plain(nbytes)
    out = out_words(dev)
    launch("zlp_smem_ceiling", nbytes, X, out, ref=out)
    smem_ceiling.launches += 1
    return read(out)


smem_ceiling.launches = 0


def smem_ceiling_plain(nbytes: int) -> Result:
    s = np.arange(nbytes // 4, dtype=np.int64) ^ X
    s[0] = X
    return Result(i32(int(s[-1])), int(s.sum()) & MASK)


def smem_optin(device="cuda") -> int:
    """The card's opt-in shared-memory limit per block, in bytes."""
    from .. import _build

    dev = resolve_device(device)
    return _build.probes_lib().zlp_smem_optin(dev.index or 0)


# ---- PL3 / PL4 -------------------------------------------------------------

def _weighted(words: np.ndarray) -> int:
    """Word 1 of the shift probes: sum of (index + 1) * value, mod 2**32."""
    w = words.astype(np.uint64)
    return int((w * np.arange(1, len(w) + 1, dtype=np.uint64)).sum()) & MASK


def dyn_shift(x: torch.Tensor, s: int, n: int = 1):
    """Rotate ``x`` (u8 [128], or i32 [8, 128] along its lanes) by ``s``
    toward higher indices, ``n`` times.  Returns (Result, the rotated x);
    word 0 is its first 32-bit word."""
    if not on_card(x, "dyn_shift"):
        return dyn_shift_plain(x, s, n)
    kind = _shift_kind(x)
    y = torch.empty_like(x)
    out = out_words(x.device)
    launch("zlp_dyn_shift", kind, n, s, x.contiguous(), y, out, ref=out)
    dyn_shift.launches += 1
    return read(out), y


dyn_shift.launches = 0


def _shift_kind(x: torch.Tensor) -> int:
    if x.dtype == torch.uint8 and x.shape == (128,):
        return 0
    if x.dtype == torch.int32 and x.shape == (8, 128):
        return 1
    raise ValueError("dyn_shift: x must be u8 [128] or i32 [8, 128]")


def dyn_shift_plain(x: torch.Tensor, s: int, n: int = 1):
    _shift_kind(x)
    y = np.roll(x.cpu().numpy(), (n * s) % 128, axis=-1)
    words = y.view(np.uint32).reshape(-1)
    return Result(i32(int(words[0])), _weighted(words)), torch.as_tensor(y)


# ---- PL5 / PL6 -------------------------------------------------------------

def dyn_index(x: torch.Tensor, row: int, lane: int, n: int = 1):
    """``n`` chained steps of v = a[r][l]; a[r][l] = l; l = (l + v + 1) &
    127; r = (r + v) & 63 from (row, lane), over ``x``: u8 [64, 128] (in
    shared memory) or i32 [32] (a per-thread array; index l & 31, no row).
    Returns (Result, the array after): word 0 the last v, word 1 their
    sum."""
    if not on_card(x, "dyn_index"):
        return dyn_index_plain(x, row, lane, n)
    kind = _index_kind(x)
    y = torch.empty_like(x)
    out = out_words(x.device)
    launch("zlp_dyn_index", kind, n, row, lane, x.contiguous(), y, out,
           ref=out)
    dyn_index.launches += 1
    return read(out), y


dyn_index.launches = 0


def _index_kind(x: torch.Tensor) -> int:
    if x.dtype == torch.uint8 and x.shape == (64, 128):
        return 0
    if x.dtype == torch.int32 and x.shape == (32,):
        return 1
    raise ValueError("dyn_index: x must be u8 [64, 128] or i32 [32]")


def dyn_index_plain(x: torch.Tensor, row: int, lane: int, n: int = 1):
    kind = _index_kind(x)
    a = x.cpu().reshape(-1).tolist()
    r, l, v, ck = row & 63, lane & 127, 0, 0
    for _ in range(n):
        k = r * 128 + l if kind == 0 else l & 31
        v = a[k] & MASK
        a[k] = l
        ck += v
        l = (l + v + 1) & 127
        r = (r + v) & 63
    return Result(i32(v), ck & MASK), \
        torch.tensor(a, dtype=x.dtype).reshape(x.shape)


# ---- PL7 -------------------------------------------------------------------

def warp_mix(x: torch.Tensor, n: int = 1000, ballot: bool = False) -> Result:
    """``n`` steps of acc += x[i & 63][i & 127] over u8 [64, 128]; with
    ``ballot`` each step also compares 32 bytes of rows i and i + 1 across
    the warp (word 1: the sum of the first differing lanes, 32 if none)."""
    if not on_card(x, "warp_mix"):
        return warp_mix_plain(x, n, ballot)
    if x.dtype != torch.uint8 or x.shape != (64, 128):
        raise ValueError("warp_mix: x must be u8 [64, 128]")
    out = out_words(x.device)
    launch("zlp_warp_mix", int(ballot), n, x.contiguous(), out, ref=out)
    warp_mix.launches += 1
    return read(out)


warp_mix.launches = 0


def warp_mix_plain(x: torch.Tensor, n: int = 1000,
                   ballot: bool = False) -> Result:
    a = x.cpu().numpy().astype(np.int64)
    i = np.arange(n)
    acc = int(a[i & 63, i & 127].sum())
    if not ballot:
        return Result(i32(acc), acc & MASK)
    c = (i[:, None] + np.arange(32)) & 127
    diff = a[(i & 63)[:, None], c] != a[((i + 1) & 63)[:, None], c]
    first = np.where(diff.any(1), diff.argmax(1), 32)
    return Result(i32(acc), int(first.sum()) & MASK)


# ---- the command line ------------------------------------------------------

def seeded_bytes(shape, seed: int, device, high: int = 256) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, high, shape, dtype=np.uint8)) \
        .to(device)


def cases(n: int, device, sizes=RESIDENT_BYTES):
    """Every launch of this module but PL2's, at ``n`` steps, as (row,
    name, steps, call); seeded inputs (the TPU probes have none).  The
    shift and index calls return (Result, array)."""
    out = []
    for nbytes in sizes:
        nxt = torch.as_tensor(random_cycle(nbytes // 4, 11).view(np.int32)) \
            .to(device)
        for smem in (0, K3_SMEM):
            out.append(("PL1", f"resident {nbytes / MB:g} MB smem {smem}", n,
                        lambda nxt=nxt, smem=smem: resident(n, nxt, smem)))
    row = seeded_bytes(128, 3, device)
    words = seeded_bytes((8, 128 * 4), 4, device).view(torch.int32)
    out += [("PL3/PL4", "dyn shift u8 row", n,
             lambda: dyn_shift(row, 37, n)),
            ("PL3/PL4", "dyn shift i32 (8,128)", n,
             lambda: dyn_shift(words, 77, n))]
    arr = seeded_bytes((64, 128), 5, device, high=8)
    t32 = seeded_bytes(128, 6, device).view(torch.int32)
    out += [("PL5/PL6", "dyn index shared u8", n,
             lambda: dyn_index(arr, 9, 100, n)),
            ("PL5/PL6", "dyn index per-thread i32[32]", n,
             lambda: dyn_index(t32, 0, 13, n))]
    mix = seeded_bytes((64, 128), 7, device, high=4)
    out += [("PL7", "warp mix: one lane", n,
             lambda: warp_mix(mix, n, False)),
            ("PL7", "warp mix: + ballot of 32", n,
             lambda: warp_mix(mix, n, True))]
    return out


def smem_sizes(optin: int) -> list[int]:
    """PL2's sizes in bytes: 48 .. 227 KB (capped at the opt-in limit) and
    one byte past the limit, which must be refused."""
    return [min(kb * KB, optin) for kb in SMEM_KB] + [optin + 1]


# probe row -> (wrapper, the TPU probes it replaces)
ROWS = {
    "PL1": (resident, ("tools/probe_limits.py:30",)),
    "PL2": (smem_ceiling, ("tools/probe_limits.py:50",)),
    "PL3/PL4": (dyn_shift, ("tools/probe_limits.py:70",
                            "tools/probe_limits.py:88")),
    "PL5/PL6": (dyn_index, ("tools/probe_limits.py:106",
                            "tools/probe_limits.py:129")),
    "PL7": (warp_mix, ("tools/probe_limits.py:151",)),
}


def measure_all(device="cuda"):
    """Time every probe on the card at STEPS steps; one row each.  PL2's
    rows carry ``ok`` (launched) and, past the limit, the refusal."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("limits: timing needs a CUDA device")
    rows = [dict(measure(call, steps), row=row, name=name, ok=True)
            for row, name, steps, call in cases(STEPS, dev)]
    for nbytes in smem_sizes(smem_optin(dev)):
        name = f"smem {nbytes} B"
        try:
            rows.append(dict(measure(lambda b=nbytes: smem_ceiling(b, dev), 1),
                             row="PL2", name=name, ok=True))
        except RuntimeError as e:
            rows.append(dict(row="PL2", name=name, ok=False, error=str(e)))
    return rows


def main(argv=None) -> int:
    rows = measure_all("cuda")
    print(f"{torch.cuda.get_device_name(0)}; opt-in shared memory "
          f"{smem_optin()} B", flush=True)
    for r in rows:
        if not r["ok"]:
            print(f"  {r['name']:34s} FAIL: {r['error']}", flush=True)
            continue
        res = r["result"]
        print(f"  {r['name']:34s} OK  {r['ns_per_iter']:10.2f} ns/step "
              f"{r['cycles_per_iter']:9.1f} cyc  {r['ghz']:.3f} GHz  "
              f"[r={res.word0}, ck={res.word1}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
