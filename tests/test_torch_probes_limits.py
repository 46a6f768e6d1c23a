"""The card's limit probes (their plain versions, on the CPU), the probe
library's build key, and the probes' behaviour without a GPU.

``tools/probe_limits.py`` only compiles, and on the CPU every one of its
probes returns "FAIL: Only interpret mode is supported", so the plain
versions are held to closed forms instead: the rotation by a run-time
shift, the byte read and write at a run-time row and lane, the 1000-step
sum, the shared-memory fill, and the single cycle of the chase.

Tolerance: exact equality -- every result is an integer.
"""

from __future__ import annotations

import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from libzling_tpu_torch import _build
from libzling_tpu_torch.probes import MASK, i32
from libzling_tpu_torch.probes import limits as pl
from libzling_tpu_torch.probes import scalar_cost as sc
from libzling_tpu_torch.probes import tokenize_cost as tc


@pytest.mark.parametrize("s", [0, 1, 37, 64, 127])
def test_shift_is_a_rotation(s):
    row = pl.seeded_bytes(128, 3, "cpu")
    res, y = pl.dyn_shift(row, s)
    x = row.tolist()
    assert y.tolist() == [x[(k - s) % 128] for k in range(128)]
    assert res.word0 == i32(int.from_bytes(bytes(y[:4].tolist()), "little"))
    words = pl.seeded_bytes((8, 512), 4, "cpu").view(torch.int32)
    _, y = pl.dyn_shift(words, s, n=3)
    w = words.tolist()
    assert y.tolist() == [[r[(k - 3 * s) % 128] for k in range(128)]
                          for r in w]


def test_index_reads_the_byte_and_writes_the_lane():
    x = pl.seeded_bytes((64, 128), 5, "cpu")
    res, y = pl.dyn_index(x, 9, 100)
    assert res.word0 == res.word1 == int(x[9, 100])
    want = x.clone()
    want[9, 100] = 100
    assert torch.equal(y, want)
    t = torch.arange(32, dtype=torch.int32) * 7 - 50
    res, y = pl.dyn_index(t, 0, 45)
    assert res.word0 == int(t[45 & 31])
    assert y.tolist() == [45 if k == 45 & 31 else int(t[k])
                          for k in range(32)]


def test_warp_mix_sums_1000_steps():
    x = pl.seeded_bytes((64, 128), 7, "cpu")
    acc = sum(int(x[i & 63, i & 127]) for i in range(1000))
    assert pl.warp_mix(x).word0 == acc
    res = pl.warp_mix(x, ballot=True)
    assert res.word0 == acc
    first = 0
    for i in range(1000):
        diff = [int(x[i & 63, (i + k) & 127]) != int(x[(i + 1) & 63,
                                                     (i + k) & 127])
                for k in range(32)]
        first += diff.index(True) if any(diff) else 32
    assert res.word1 == first


@pytest.mark.parametrize("kb", [48, 227])
def test_smem_fill(kb):
    n, x = kb * 256, pl.X
    res = pl.smem_ceiling(kb * 1024, "cpu")
    assert res.word0 == i32((n - 1) ^ x)
    assert res.word1 == (x + sum(k ^ x for k in range(1, n))) & MASK


def test_chase_is_one_cycle():
    nxt = pl.random_cycle(4096, 11)
    x, seen = 0, set()
    for _ in range(4096):
        seen.add(x)
        x = int(nxt[x])
    assert x == 0 and len(seen) == 4096
    t = torch.as_tensor(nxt.view(np.int32))
    res = pl.resident(5000, t)
    x = 0
    for _ in range(5000):
        x = int(nxt[x])
    assert res.word0 == x


def test_probe_library_key(tmp_path):
    # the probes' hash covers csrc/probes/*.cu* and the shared headers; the
    # codec library's hash ignores csrc/probes/ and keeps its old formula
    src = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, src)

    def probes_key():
        return _build.source_hash(src / "probes", src.glob("*.cuh"),
                                  _build.PROBE_FLAGS)

    codec, probes = _build.source_hash(src), probes_key()
    assert codec == _build.source_hash(_build._CSRC)
    assert codec != probes
    (src / "probes" / "extra.cu").write_text("// another probe\n")
    assert _build.source_hash(src) == codec
    assert probes_key() != probes
    probes = probes_key()
    (src / "common.cuh").write_text((src / "common.cuh").read_text() + "\n")
    assert probes_key() != probes


@pytest.mark.parametrize("mod", [tc, sc, pl], ids=["tokenize", "scalar",
                                                    "limits"])
def test_cuda_probes_raise_without_a_gpu(mod, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")

    def no_plain(*a, **k):
        raise AssertionError("a CUDA probe ran its plain version")

    for name in dir(mod):
        if name.endswith("_plain"):
            monkeypatch.setattr(mod, name, no_plain)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


@pytest.mark.parametrize("mod", [tc, sc, pl], ids=["tokenize", "scalar",
                                                    "limits"])
def test_rows_name_every_probe(mod):
    # the kernels line of chip_smoke.py is built from ROWS: every row the
    # module's cases() label, and only those (PL2 is launched apart), with
    # a wrapper that counts its launches and the TPU probe's file:line
    small = dict(sizes=(16 * 1024,)) if mod is pl else {}
    rows = {r for r, *_ in mod.cases(1, "cpu", **small)}
    assert rows | ({"PL2"} if mod is pl else set()) == set(mod.ROWS)
    for fn, replaces in mod.ROWS.values():
        assert fn.launches >= 0 and replaces
        assert all(r.startswith("tools/probe_") for r in replaces)


def test_probes_import_no_jax():
    code = ("import sys; import libzling_tpu_torch.probes.tokenize_cost, "
            "libzling_tpu_torch.probes.scalar_cost, "
            "libzling_tpu_torch.probes.limits; "
            "assert not [m for m in sys.modules if m.split('.')[0] == 'jax']")
    subprocess.run([sys.executable, "-c", code], check=True)
