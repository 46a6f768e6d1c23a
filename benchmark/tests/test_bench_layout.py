"""The manifest keeps to the benchmark's contract, and every addition is new
files and new entries: a configuration, a traffic mix, a stage and a
per-layer metric added in a copy are found by name with no existing file
of ``benchmark/`` edited."""

import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import layout

REPO = pathlib.Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keeps_to_the_contract():
    m = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(m) == KEYS["top"]
    assert m["paths"] == ["benchmark"] and 1 <= m["run_seconds"] <= 51
    assert m["command"] == ["python3", "benchmark/run.py"]
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in m[part]]
        assert len(names) == len(set(names))
        for e in m[part]:
            assert set(e) <= KEYS[part] and NAME.match(e["name"]), e
    cells = {w["name"]: w for w in m["workloads"]}
    configs = {c["name"]: c for c in m["configs"]}
    for c in configs.values():
        assert line(c["source"]) and line(c["why"]) and c["reduced"] == []
        assert (REPO / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in cells.values())
    pairs = set()
    for w in cells.values():
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert line(w["why"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for e in e2e.values():
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] == "host_clock"
    bench = layout.Benchmark()
    for cell in cells:
        reported = {e["name"] for e in bench.end_to_end(cell)}
        assert "setup_s" in reported and len(reported) >= 2
        assert bench.per_layer(cell)
    for p in m["per_layer"]:
        assert UNIT.match(p["unit"]) and line(p["layer"])
        assert p["moves"] in e2e
        for cell in p["workloads"]:
            assert p["moves"] in {e["name"] for e in bench.end_to_end(cell)}
        assert (REPO / "benchmark" / "metrics" / f"{p['name']}.py").is_file()
    assert len(json.dumps(m)) < 64 * 1024


@pytest.fixture
def copy(tmp_path):
    """BENCHMARK.json and benchmark/ alone, as a checkout of them."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    return tmp_path


def listing(root: pathlib.Path) -> dict:
    r = subprocess.run([sys.executable, "benchmark/run.py", "--list"],
                       cwd=root, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout)


def test_an_addition_is_new_files_and_entries(copy):
    before = {p: p.read_bytes() for p in (copy / "benchmark").rglob("*")
              if p.is_file()}
    b = copy / "benchmark"
    cfg = json.loads((b / "configs" / "enwik8-e4.json").read_text())
    cfg["name"] = "mixed-e4"
    cfg["corpus"]["inserts"] = [{"kind": "random", "bytes": 1048576,
                                 "per": 16777216}]
    (b / "configs" / "mixed-e4.json").write_text(json.dumps(cfg))
    (b / "traffic" / "decode-split.json").write_text(json.dumps(
        {"op": "decode", "loop": "the split path's cell"}))
    (b / "stages" / "huffman").mkdir()
    (b / "stages" / "huffman" / "stage.json").write_text(json.dumps(
        {"ops": ["encode"], "read": {"tokens": 2},
         "write": {"stream_bytes": 1}}))
    (b / "stages" / "huffman" / "torch.txt").write_text(
        "at::native::histogram_kernel\n")
    (b / "stages" / "decode" / "k3_renamed.txt").write_text(
        "(anonymous namespace)::decode_fused_kernel_v2\n")
    (b / "metrics" / "huffman_roofline.py").write_text(
        "def read(reading):\n    return reading.roofline_pct('huffman')\n")
    m = json.loads((copy / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "mixed-e4", "source": "https://example.org",
                         "file": "benchmark/configs/mixed-e4.json",
                         "reduced": [], "why": "archives"})
    m["workloads"].append({"name": "mixed-e4.decode-split",
                           "config": "mixed-e4", "traffic": "decode-split",
                           "chips": 1, "why": "split decode"})
    m["end_to_end"][1]["workloads"].append("mixed-e4.decode-split")
    m["per_layer"].append({"name": "huffman_roofline", "unit": "%",
                           "better": "higher", "source": "device_trace",
                           "layer": "Huffman stages", "moves": "encode_MBps",
                           "workloads": ["enwik8-e0.encode"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(m))

    got = listing(copy)
    assert got["cells"]["mixed-e4.decode-split"] == {
        "config": "mixed-e4", "traffic": "decode-split"}
    assert "decode-split" in got["traffic"]
    assert got["stages"]["huffman"] == ["at::native::histogram_kernel"]
    assert ("(anonymous namespace)::decode_fused_kernel_v2"
            in got["stages"]["decode"])
    assert got["metrics"]["huffman_roofline"] is True
    for p, data in before.items():        # nothing that was there changed
        assert p.read_bytes() == data, p
    bench = layout.Benchmark(copy)
    assert bench.config("mixed-e4")["corpus"]["inserts"]
    assert [x["name"] for x in bench.per_layer("enwik8-e0.encode")][-1] == (
        "huffman_roofline")


def test_the_files_alone_run_no_cell(copy):
    """Without the program beside it a run fails and prints no result."""
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "enwik8-e0.decode", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=copy, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
