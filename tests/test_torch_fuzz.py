"""The port's fuzz harness (``libzling_tpu_torch/fuzz.py``) on the CPU:
a few rounds at a fixed seed pass and draw every level and blob style; a
planted fault (one decode path returning wrong bytes) exits 1 and leaves
its dump; its blobs are ``tools/fuzz.py``'s for the same seed.

Tolerance: exact equality -- blobs and streams are bytes; the run's exit
code is 0 or 1.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import random

import pytest
import torch

from libzling_tpu_torch import fuzz

REPO = pathlib.Path(__file__).resolve().parent.parent

# 12 rounds of at most 4 KiB from seed 1 draw all seven levels and all
# four styles (asserted below)
ARGS = ["--device", "cpu", "--rounds", "12", "--max-size", "4096",
        "--seed", "1"]


def _summary(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cpu_run_passes(tmp_path, capsys):
    dump = tmp_path / "build" / "fuzz"
    assert fuzz.main(ARGS + ["--dump-dir", str(dump)]) == 0
    got = _summary(capsys)
    assert got["failures"] == 0 and not dump.exists()
    assert got["levels"] == list(range(7))
    assert got["styles"] == sorted(fuzz.STYLES)
    assert got["paths"] == ["fused", "groups", "mesh", "split"]
    # every round: two encodes, two streams' round trips and corruptions
    corrupt = got["corrupt"]["split"]
    assert corrupt["raised"] > 0 and corrupt["returned"] > 0
    assert sum(corrupt.values()) == sum(got["corrupt"]["fused"].values())


def test_planted_fault_exits_1_and_dumps(tmp_path, capsys, monkeypatch):
    paths = fuzz.decode_paths

    def planted(device):
        out = paths(device)
        split = out["split"]
        out["split"] = lambda s: split(s) + b"!"
        return out

    monkeypatch.setattr(fuzz, "decode_paths", planted)
    dump = tmp_path / "build" / "fuzz"
    assert fuzz.main(ARGS[:3] + ["2", "--max-size", "2048", "--seed", "1",
                                 "--dump-dir", str(dump)]) == 1
    got = _summary(capsys)
    assert got["failures"] > 0
    dirs = sorted(dump.iterdir())
    assert dirs
    for d in dirs:
        assert {"input", "stream", "error"} <= {p.name for p in d.iterdir()}
        assert "split" in (d / "error").read_text()


def test_blobs_equal_the_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "_jax_fuzz_tool", REPO / "tools" / "fuzz.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    styles = set()
    for seed in range(12):
        a, b = random.Random(seed), random.Random(seed)
        n = a.randrange(3000)
        assert n == b.randrange(3000)
        style, data = fuzz.blob(a, n)
        styles.add(style)
        assert data == tool._blob(b, n)
        assert a.random() == b.random()       # the same draws consumed
    assert styles == set(fuzz.STYLES)


def test_cuda_is_the_default_and_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the card test runs the default")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fuzz.main(["--rounds", "1", "--dump-dir", str(tmp_path)])
