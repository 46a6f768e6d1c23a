"""``encode.chain_wait_ms`` on canned two-card traces, and the four-card
cell that reports it as ``run.py --list`` finds them."""

import pytest

from benchmark.harness import layout, reading
from benchmark.tests.test_bench_layout import REPO, listing
from benchmark.tests.test_bench_reading import BW, K4, K5, TORCH, Q, chrome
from benchmark.tests.test_bench_reading import ev

MS = 1000.0          # trace units (us) in a millisecond
CELL = "enwik9-e4.encode.lanes4"

# card 0: K4 0-400, K5 at once, K4 420-800, a torch kernel 820-850, K5
# 950-970: it waits 20 + 100 ms after the second K4; card 1: K4 0-380, K5
# 430-450 (waits 50 ms), K4 450-820, K5 980-1000 (waits 160 ms)
TWO_CARDS = [(K4, "kernel", 0, 400, 0), (K5, "kernel", 400, 20, 0),
             (K4, "kernel", 420, 380, 0), (TORCH, "kernel", 820, 30, 0),
             (K5, "kernel", 950, 20, 0),
             (K4, "kernel", 0, 380, 1), (K5, "kernel", 430, 20, 1),
             (K4, "kernel", 450, 370, 1), (K5, "kernel", 980, 20, 1)]
HANDS = [("zling.encode", 0, 1000), ("zling.enc.hand", 380, 385),
         ("zling.enc.hand", 800, 805)]


def traced(port, calls=1, device=TWO_CARDS, done=None):
    """A Reading of ``device`` events (name, cat, start ms, ms, card) and
    ``port`` spans (name, start ms, end ms) in ``calls`` calls, of which
    ``done`` (all by default) completed."""
    c = chrome([(n, cat, s * MS, d * MS, card)
                for n, cat, s, d, card in device], calls=calls)
    c["traceEvents"] += [ev(n, "user_annotation", a * MS, (b - a) * MS)
                         for n, a, b in port]
    return reading.Reading(reading.Trace(c), layout.Benchmark().stages(),
                           "encode", Q, calls if done is None else done, BW)


def read(r):
    return layout.Benchmark().reader("encode.chain_wait_ms")(r)


@pytest.mark.parametrize("calls", [1, 2])
def test_chain_wait_reads_the_idle_time_before_each_relabel(calls):
    # card 0 waits 120 ms, card 1 210 ms: 165 ms a card
    r = traced(HANDS, calls)
    assert r.cards == (0, 1)
    assert read(r) == pytest.approx(165.0 / calls)


@pytest.mark.parametrize("case", ["no hand span", "one card", "no call"])
def test_chain_wait_reads_nothing_without_hands_or_calls(case):
    """A lane on one card hands nothing between cards, so the trace holds
    no ``zling.enc.hand`` span, nor does a program from before it."""
    if case == "no hand span":
        r = traced(HANDS[:1])
    elif case == "one card":
        r = traced(HANDS[:1], device=[d for d in TWO_CARDS if d[4] == 0])
    else:
        r = traced(HANDS, done=0)
    assert read(r) is None


def test_the_four_card_cell_and_its_metric_are_listed():
    got = listing(REPO)
    assert got["cells"][CELL] == {"config": "enwik9-e4", "traffic": "encode"}
    assert got["metrics"]["encode.chain_wait_ms"] is True
    bench = layout.Benchmark()
    assert bench.cell(CELL)["chips"] == 4
    cfg = bench.config("enwik9-e4")
    assert cfg["level"] == 4 and cfg["corpus"]["bytes"] == 10**9
    assert {m["name"] for m in bench.end_to_end(CELL)} == {"encode_MBps",
                                                          "setup_s"}
    assert {m["name"] for m in bench.per_layer(CELL)} == {
        "encode.idle_pct", "tokenize_roofline", "relabel_roofline",
        "encode.host_idle_ms", "encode.k4_passes", "encode.chain_wait_ms"}
    for cell in ("enwik8-e0.encode", "enwik8-e4.encode"):
        assert "encode.chain_wait_ms" not in {
            m["name"] for m in bench.per_layer(cell)}
