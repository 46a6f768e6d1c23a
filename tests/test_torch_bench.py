"""The benchmark harness (``libzling_tpu_torch/bench.py``) on the CPU, at a
quarter of a MB: it exits 0 with every section and key in its last line,
its host table's streams are the JAX pipeline's size at every level, a
changed engine stream fails a gate, and a spent device budget skips every
device section and exits 3.

Tolerance: exact equality -- sizes are byte counts, and the harness's own
gates compare streams and outputs byte for byte.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from libzling_tpu import pipeline as jpipeline
from libzling_tpu_torch import bench
from libzling_tpu_torch.native import engine

REPO = pathlib.Path(__file__).resolve().parent.parent
ARGS = ["--device", "cpu", "--host-mb", "0.25", "--device-mb", "0.25",
        "--literal-mb", "0.0625", "--repeats", "1"]
SPREAD = {"n", "min", "median"}


@pytest.fixture(scope="module")
def lines() -> list:
    r = subprocess.run([sys.executable, "-m", "libzling_tpu_torch.bench",
                        *ARGS], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return [json.loads(line) for line in r.stdout.splitlines()]


def test_the_harness_prints_after_the_host_table_each_section_and_the_end(
        lines):
    assert len(lines) == 2 + len(bench.SECTIONS)
    for got in lines:
        assert set(got) == {"metric", "value", "unit", "vs_baseline",
                            "detail"}
        assert got["metric"] == "encode_throughput_e0_100MB_markov"
        assert got["unit"] == "MB/s" and got["vs_baseline"] is None
    first, last = lines[0]["detail"], lines[-1]["detail"]
    assert "cpu" not in first and "counters" not in first
    assert set(last["cpu"]) >= set(bench.SECTIONS)
    assert lines[-1]["value"] == last["levels"]["e0"]["enc_mbps"] > 0


def test_the_last_line_holds_every_section_and_key(lines):
    d = lines[-1]["detail"]
    x = (REPO / d["corpus"]["file"]).read_bytes()
    assert d["corpus"]["bytes"] == len(x) == 262144
    assert d["corpus"]["sha256"] == hashlib.sha256(x).hexdigest()
    assert d["corpus"]["host_bytes"] == 250000
    assert d["machine"]["card"] is None and d["machine"]["cpus"] >= 1
    assert d["reference"]["available"] is False and d["reference"]["why"]
    assert set(d["levels"]) == {f"e{lv}" for lv in range(7)}
    for row in d["levels"].values():
        assert set(row["enc_s"]) == set(row["dec_s"]) == SPREAD
        assert row["enc_mbps"] > 0 and row["dec_mbps"] > 0
        assert row["ratio_pct"] == row["bytes"] / 250000 * 100
    c = d["cpu"]
    assert c["clock"].startswith("host")
    tok = c["tokenize"]
    assert tok["units_equal_plain"] and set(tok["kernel_ms"]) == SPREAD
    assert tok["first_call_s"] > 0 and tok["ns_per_unit"] > 0
    dec = c["decode"]
    for path in ("fused", "split", "groups"):
        assert set(dec[path]["e2e_s"]) == SPREAD and dec[path]["mbps"] > 0
    assert set(dec["fused"]["kernel_ms"]) == {"decode_fused"}
    assert set(dec["split"]["kernel_ms"]) == {"entropy_decode", "resolve"}
    assert set(dec["literal"]["kernel_ms"]["decode_fused"]) == SPREAD
    assert dec["literal"]["bytes"] == 65536
    api = c["encode_api"]
    assert set(api["kernel_ms"]) == {"tokenize", "relabel"}
    assert api["stream_bytes"] == dec["stream_bytes"] and api["mbps"] > 0
    assert c["entropy"]["tokens_equal_engine"] and c["entropy"]["mtoks"] > 0
    assert d["counters_on_enc_mbps_e0"] > 0
    assert d["counters"]["native"]["bucket_updates"] > 0
    assert "registry" in d["counters"] and d["skipped"] == {}


@pytest.mark.parametrize("level", range(7))
def test_the_host_table_sizes_equal_the_jax_pipeline(lines, level):
    d = lines[-1]["detail"]
    x = (REPO / d["corpus"]["file"]).read_bytes()[:d["corpus"]["host_bytes"]]
    assert d["levels"][f"e{level}"]["bytes"] == len(
        jpipeline.encode(x, level))


def test_a_changed_engine_stream_fails_a_gate(monkeypatch):
    real = engine.encode

    def changed(data, level=0):
        data = bytes(data)
        return real(data[:-1] + bytes([data[-1] ^ 1]), level)

    monkeypatch.setattr(engine, "encode", changed)
    with pytest.raises(SystemExit) as e:
        bench.main(ARGS + ["--levels", "0"])
    assert str(e.value.code).startswith("bench: gate failed: "), e.value.code


def test_a_spent_budget_skips_every_device_section_and_exits_3(
        monkeypatch, capsys):
    monkeypatch.setenv("ZLT_DEVICE_BUDGET_S", "0")
    assert bench.main(ARGS + ["--levels", "0"]) == 3
    d = json.loads(capsys.readouterr().out.splitlines()[-1])["detail"]
    assert set(d["skipped"]) == {f"cpu.{s}" for s in bench.SECTIONS}
    assert all(left <= 0 for left in d["skipped"].values())
    assert set(d["cpu"]) == {"clock"} and "native" in d["counters"]


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda would run the bench")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--device", "cuda"])


@pytest.mark.parametrize("text,want", [("0-6", list(range(7))),
                                       ("0,4,6", [0, 4, 6]), ("5", [5]),
                                       ("2-3,0", [0, 2, 3])])
def test_levels_parse(text, want):
    assert bench.parse_levels(text) == want


@pytest.mark.parametrize("text", ["7", "0-7", "-1"])
def test_levels_out_of_range_raise(text):
    with pytest.raises(ValueError):
        bench.parse_levels(text)
