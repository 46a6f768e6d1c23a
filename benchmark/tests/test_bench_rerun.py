"""``encode.rerun_pct`` on canned traces, and the mixed-e4 cell that
reports it as ``run.py --list`` finds them."""

import json

import pytest

from benchmark.harness import layout, reading
from benchmark.tests.test_bench_layout import REPO, listing
from benchmark.tests.test_bench_reading import BW, K4, K5, TORCH, Q, chrome
from benchmark.tests.test_bench_reading import ev

MS = 1000.0          # trace units (us) in a millisecond
CELL = "mixed-e4.encode"

# one call of two equal passes on a card: K4 0-400 and K5 400-420, the
# host's wait, a re-run whose K4 runs 480-880 and K5 880-900, then a torch
# op and the frame
PASSES = [(K4, "kernel", 0, 400), (K5, "kernel", 400, 20),
          (K4, "kernel", 480, 400), (K5, "kernel", 880, 20),
          (TORCH, "kernel", 905, 10)]
RERUN = [("zling.encode", 0, 990), ("zling.enc.dispatch", 0, 5),
         ("zling.enc.launch", 1, 5), ("zling.enc.rerun", 470, 475),
         ("zling.enc.launch", 471, 475), ("zling.enc.frame", 910, 950)]
CLEAN = [("zling.encode", 0, 990), ("zling.enc.dispatch", 0, 5),
         ("zling.enc.launch", 1, 5), ("zling.enc.frame", 910, 950)]


def traced(port, device=PASSES, cards=(0,)):
    """A Reading of ``device`` events (name, cat, start ms, ms) repeated
    on each of ``cards`` and ``port`` spans (name, start ms, end ms)."""
    c = chrome([(n, cat, s * MS, d * MS, card) for card in cards
                for n, cat, s, d in device])
    c["traceEvents"] += [ev(n, "user_annotation", a * MS, (b - a) * MS)
                         for n, a, b in port]
    return reading.Reading(reading.Trace(c), layout.Benchmark().stages(),
                           "encode", Q, 1, BW)


def read(r):
    return layout.Benchmark().reader("encode.rerun_pct")(r)


@pytest.mark.parametrize("cards", [(0,), (0, 1)])
def test_two_equal_passes_read_half(cards):
    r = traced(RERUN, cards=cards)
    assert r.cards == cards
    assert read(r) == pytest.approx(50.0)


def test_frames_without_a_rerun_read_zero():
    assert read(traced(CLEAN, device=PASSES[:2] + PASSES[4:])) == 0.0


def test_a_kernel_after_the_frame_is_no_rerun():
    # the next call's first pass starts after the frame that ends the reach
    later = [(K4, "kernel", 960, 20)]
    assert read(traced(RERUN, device=PASSES + later)) == pytest.approx(
        100.0 * 420 / 860)


@pytest.mark.parametrize("case", ["no port span", "no frame", "unmarked"])
def test_no_port_spans_no_frame_or_an_unmarked_rerun_read_nothing(case):
    """A program from before the ``zling.enc.rerun`` span re-runs a group
    as a launch outside any dispatch, and reads nothing, not 0."""
    port = {"no port span": [], "no frame": RERUN[:1],
            "unmarked": [s for s in RERUN if s[0] != "zling.enc.rerun"]}
    assert read(traced(port[case])) is None


def test_the_mixed_cell_and_its_configuration_are_listed():
    got = listing(REPO)
    assert got["cells"][CELL] == {"config": "mixed-e4", "traffic": "encode"}
    assert got["metrics"]["encode.rerun_pct"] is True
    bench = layout.Benchmark()
    assert bench.cell(CELL)["chips"] == 1
    entry, = [c for c in bench.manifest["configs"] if c["name"] == "mixed-e4"]
    cfg = json.loads((REPO / entry["file"]).read_text())
    assert entry["reduced"] == cfg["reduced"] == ["cards"]
    assert cfg["cards"] == 1 and cfg["level"] == 4
    assert cfg["corpus"] == {"bytes": 211938580, "base": "markov3",
                             "inserts": [{"kind": "random",
                                          "bytes": 1048576,
                                          "per": 16777216}]}
    assert {m["name"] for m in bench.end_to_end(CELL)} == {"encode_MBps",
                                                          "setup_s"}
    assert {m["name"] for m in bench.per_layer(CELL)} == {
        "encode.idle_pct", "tokenize_roofline", "relabel_roofline",
        "encode.host_idle_ms", "encode.k4_passes", "encode.rerun_pct"}
    for cell in bench.cells():
        if cell != CELL:
            assert "encode.rerun_pct" not in {
                m["name"] for m in bench.per_layer(cell)}
