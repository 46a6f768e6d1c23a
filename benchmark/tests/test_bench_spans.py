"""The port's spans on canned profiler traces: the device's idle time put
down to the innermost span, and the readers that read them."""

import pytest

from benchmark.harness import layout, reading, spans
from benchmark.tests.test_bench_reading import BW, K3, K4, K5, Q, chrome, ev

MS = 1000.0          # trace units (us) in a millisecond


def traced(device, port, calls=1, window=(0.0, 1000 * MS), op="encode"):
    """A Reading of ``device`` events and ``port`` spans (name, start ms,
    end ms) as the profiler writes ``record_function`` ranges."""
    c = chrome([(n, cat, s * MS, d * MS) for n, cat, s, d in device],
               window=window, calls=calls)
    c["traceEvents"] += [ev(n, "user_annotation", a * MS, (b - a) * MS)
                         for n, a, b in port]
    return reading.Reading(reading.Trace(c), layout.Benchmark().stages(), op,
                           Q, calls, BW)


# device busy 0-100 and 400-940 ms and 990-1000 ms: idle 100-400 and
# 940-990 ms; the call's top span ends at 950 ms
ENCODE = [(K4, "kernel", 0, 100), (K5, "kernel", 400, 540),
          (K4, "kernel", 990, 10)]
NESTED = [("zling.encode", 50, 950),
          ("zling.enc.gather_freqs", 150, 350),
          ("zling.enc.wait", 200, 300)]


def test_a_gap_is_split_exactly_among_nested_spans():
    r = traced(ENCODE, NESTED)
    got = spans.idle_under(r, "zling.encode")
    assert set(got) == {"zling.encode", "zling.enc.gather_freqs",
                        "zling.enc.wait"}
    # 100-150 and 350-400 ms under the top span alone, 150-200 and
    # 300-350 under gather_freqs, 200-300 under wait, 940-950 under the top
    assert got["zling.encode"] == pytest.approx(0.110)
    assert got["zling.enc.gather_freqs"] == pytest.approx(0.100)
    assert got["zling.enc.wait"] == pytest.approx(0.100)


def test_idle_outside_the_top_spans_is_not_attributed():
    r = traced(ENCODE, NESTED)
    got = spans.idle_under(r, "zling.encode")
    idle = sum(b - a for a, b in r.gaps())
    assert idle == pytest.approx(0.350)
    # 950-990 ms lies outside zling.encode, inside the benchmark's call
    assert sum(got.values()) == pytest.approx(idle - 0.040)
    assert spans.idle_under(r, "zling.decode") == {}
    # under the benchmark's call, what lies outside the port's spans reads
    # as the call itself
    call = spans.idle_under(r, reading.CALL)
    assert call[reading.CALL] == pytest.approx(0.040)
    assert call["zling.encode"] == pytest.approx(0.110)
    assert call["zling.enc.wait"] == pytest.approx(0.100)


def test_spans_that_start_together_and_spans_outside_the_window():
    # the later of two spans that start together is the one that ends
    # first; a span begun before the window (the warm-up) is not counted
    port = [("zling.encode", 50, 950), ("zling.enc.frame", 100, 400),
            ("zling.enc.validate", 100, 200),
            ("zling.enc.launch", -300, -100)]
    r = traced(ENCODE, port, window=(0.0, 1000 * MS))
    got = spans.idle_under(r, "zling.encode")
    assert got["zling.enc.validate"] == pytest.approx(0.100)
    assert got["zling.enc.frame"] == pytest.approx(0.200)
    assert spans.count(r, "zling.enc.launch") == 0
    assert spans.count(r, "zling.enc.frame") == 1


def test_host_idle_ms_reads_a_call():
    r = traced(ENCODE + [(K4, "kernel", 1000, 0)],
               NESTED + [("zling.encode", 960, 980)], calls=2)
    bench = layout.Benchmark()
    # 0.310 s under the first call's spans, 20 ms under the second's
    assert bench.reader("encode.host_idle_ms")(r) == pytest.approx(
        1000 * 0.330 / 2)
    assert bench.reader("decode.host_idle_ms")(r) == 0.0


def test_k4_passes_counts_a_rerun():
    # two groups framed; the first ran twice (a schedule fix), so three
    # launches in the window; a warm-up launch before it does not count
    port = [("zling.encode", 0, 990),
            ("zling.enc.launch", 10, 20), ("zling.enc.launch", 30, 40),
            ("zling.enc.frame", 300, 310), ("zling.enc.launch", 320, 330),
            ("zling.enc.frame", 600, 610), ("zling.enc.launch", -50, -40)]
    r = traced(ENCODE, port)
    assert layout.Benchmark().reader("encode.k4_passes")(r) == 1.5
    clean = [e for e in port if e[1] != 30]
    r = traced(ENCODE, clean)
    assert layout.Benchmark().reader("encode.k4_passes")(r) == 1.0


@pytest.mark.parametrize("metric", ["encode.host_idle_ms",
                                    "decode.host_idle_ms",
                                    "encode.k4_passes"])
def test_readers_read_nothing_without_port_spans(metric):
    """A program from before the spans: the trace holds the benchmark's
    spans and the kernels alone, and the reader returns None."""
    dev = ENCODE if metric.startswith("encode") else [(K3, "kernel", 0, 900)]
    op = metric.split(".")[0]
    r = traced(dev, [], op=op)
    assert layout.Benchmark().reader(metric)(r) is None
    assert spans.idle_under(r, "zling." + op) == {}


def test_the_manifest_lists_the_span_metrics_for_their_cells():
    bench = layout.Benchmark()
    for cell in ("enwik8-e0.encode", "enwik8-e4.encode"):
        names = {m["name"] for m in bench.per_layer(cell)}
        assert {"encode.host_idle_ms", "encode.k4_passes"} <= names
        assert "decode.host_idle_ms" not in names
    for cell in ("enwik8-e0.decode", "enwik8-e4.decode"):
        names = {m["name"] for m in bench.per_layer(cell)}
        assert "decode.host_idle_ms" in names
        assert not names & {"encode.host_idle_ms", "encode.k4_passes"}
