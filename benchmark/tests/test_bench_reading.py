"""The per-layer readers on canned profiler traces."""

import json

import pytest

from benchmark.harness import layout, reading

BW = 3.35e12
K3 = "void (anonymous namespace)::decode_fused_kernel(int const*, int const*)"
K4 = ("void (anonymous namespace)::tokenize_kernel(unsigned char const*, "
      "long const*, int)")
K5 = "(anonymous namespace)::relabel_kernel(int const*, long const*)"
K1 = ["void (anonymous namespace)::plan_kernel(int const*, int, int, int)",
      "void (anonymous namespace)::transfer_kernel(int const*)",
      "void (anonymous namespace)::scan_kernel(int const*)",
      "void (anonymous namespace)::write_kernel(int const*)"]
K2 = "void (anonymous namespace)::resolve_kernel(int const*, long const*)"
TORCH = ("void at::native::vectorized_elementwise_kernel<4, "
         "at::native::FillFunctor<int>, std::array<char*, 1ul> >(int, "
         "at::native::FillFunctor<int>, std::array<char*, 1ul>)")


def ev(name, cat, ts, dur, card=None):
    """An event; ``card`` given, in ``args.device`` as the profiler writes
    it on a device operation."""
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 0, "tid": 0}
    if card is not None:
        e["args"] = {"device": card, "stream": 7}
    return e


def chrome(device, host=(), window=(0.0, 1_000_000.0), calls=1, card=None):
    """A trace: ``device`` (name, cat, start us, dur us[, card]; the card
    else ``card``), the window span and its calls, and ``host`` events."""
    lo, hi = window
    evs = [ev(reading.WINDOW, "user_annotation", lo, hi - lo)]
    step = (hi - lo) / calls
    evs += [ev(reading.CALL, "user_annotation", lo + k * step, step)
            for k in range(calls)]
    evs += [ev(*d[:4], card=d[4] if len(d) > 4 else card) for d in device]
    evs += [ev(n, "cpu_op", s, d) for n, s, d in host]
    # events the reader ignores: a flow event, a device-side annotation
    evs += [{"ph": "f", "name": "ac2g", "cat": "ac2g", "ts": 5},
            ev(reading.CALL, "gpu_user_annotation", lo, hi - lo)]
    return {"traceEvents": evs}


@pytest.fixture(scope="module")
def stages():
    return layout.Benchmark().stages()


Q = {"raw_bytes": 10**8, "stream_bytes": 3 * 10**7, "tokens": 34_000_000,
     "literals": 9_000_000}


def test_kernel_names():
    assert reading.kernel_name(K4) == "(anonymous namespace)::tokenize_kernel"
    assert reading.kernel_name(K5) == "(anonymous namespace)::relabel_kernel"
    assert (reading.kernel_name(TORCH)
            == "at::native::vectorized_elementwise_kernel")
    assert reading.kernel_name(
        "void ns::k<(anonymous namespace)::T, 2>(int)") == "ns::k"
    assert reading.kernel_name("Memcpy DtoH (Device -> Pinned)") == (
        "Memcpy DtoH")


def encode_window(stages, card=None):
    # two calls of 500 ms: K4 400 ms, K5 20 ms, a torch op 10 ms, a copy
    # 5 ms each; the copy overlaps the torch op by 5 ms
    device = []
    for base in (0, 500_000):
        device += [(K4, "kernel", base + 10_000, 400_000),
                   (K5, "kernel", base + 410_000, 20_000),
                   (TORCH, "kernel", base + 440_000, 10_000),
                   ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy",
                    base + 445_000, 10_000)]
    host = [("aten::copy_", 455_000, 40_000)]
    return reading.Reading(reading.Trace(chrome(device, host, calls=2,
                                                card=card)),
                           stages, "encode", Q, 2, BW)


def test_encode_window(stages):
    r = encode_window(stages)
    assert r.cards == (0,)
    check_encode_window(r)


@pytest.mark.parametrize("card", [0, 3])
def test_a_card_named_in_the_trace_reads_as_before(stages, card):
    """The same one-card trace with ``args.device`` on its device events
    reads to the same numbers, whichever card it names."""
    r = encode_window(stages, card)
    assert r.cards == (card,)
    check_encode_window(r)
    plain = encode_window(stages)
    assert (r.busy_s, r.idle_pct(), r.breakdown()) == (
        plain.busy_s, plain.idle_pct(), plain.breakdown())
    assert r.gaps() == r.gaps(card) == plain.gaps(0)


def check_encode_window(r):
    assert r.window_s == pytest.approx(1.0)
    assert r.busy_s == pytest.approx(2 * 0.435)
    assert r.idle_pct() == pytest.approx(13.0)
    want = 100 * (2 * (10**8 + 2 * 34_000_000) / BW) / 0.8
    assert r.roofline_pct("tokenize") == pytest.approx(want)
    want = 100 * (2 * (2 * 34_000_000 + 2 * 9_000_000) / BW) / 0.04
    assert r.roofline_pct("relabel") == pytest.approx(want)
    assert r.roofline_pct("decode") is None     # no decode work in encode
    b = r.breakdown()
    assert b["device_ops"][0] == ["tokenize/(anonymous namespace)::"
                                  "tokenize_kernel", pytest.approx(0.8)]
    names = dict(b["device_ops"])
    assert names["other/at::native::vectorized_elementwise_kernel"] == (
        pytest.approx(0.02))
    gaps = dict(b["idle_gaps"])
    # 455-510 ms: from the first call's copy to the second call's K4
    assert gaps["aten::copy_"] == pytest.approx(0.055)
    assert sum(gaps.values()) == pytest.approx(1 - 2 * 0.435)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_fused_and_split_decode_read_the_same_work(stages):
    """The decode stage counts the stream read and the output written,
    whichever kernels did it: equal device time, equal share."""
    fused = [(K3, "kernel", 0, 900_000)]
    split = [(k, "kernel", 20 * i, 20) for i, k in enumerate(K1)]
    split += [(K2, "kernel", 100, 900_000 - 80)]
    got = []
    for dev in (fused, split):
        r = reading.Reading(reading.Trace(chrome(dev)), stages, "decode", Q,
                            1, BW)
        assert r.stage_bytes("decode") == 13 * 10**7
        got.append(r.roofline_pct("decode"))
        assert r.roofline_pct("tokenize") is None
    assert got[0] == pytest.approx(got[1])
    assert got[0] == pytest.approx(100 * (13 * 10**7 / BW) / 0.9)


def test_a_stage_that_worked_but_shows_no_kernel_fails(stages):
    r = reading.Reading(reading.Trace(chrome([(TORCH, "kernel", 0, 10)])),
                        stages, "encode", Q, 1, BW)
    with pytest.raises(RuntimeError, match="tokenize"):
        r.roofline_pct("tokenize")


def test_no_peak_for_an_unknown_card(stages):
    assert reading.peak_bandwidth("NVIDIA H100 80GB HBM3") == BW
    assert reading.peak_bandwidth("some other card") is None
    r = reading.Reading(reading.Trace(chrome([(K3, "kernel", 0, 10)])),
                        stages, "decode", Q, 1, None)
    assert r.roofline_pct("decode") is None


def test_events_outside_the_window_are_clipped(stages):
    dev = [(K3, "kernel", -500_000, 1_000_000),     # half inside
           (K3, "kernel", 2_000_000, 10)]           # after the window
    r = reading.Reading(reading.Trace(chrome(dev)), stages, "decode", Q, 1,
                        BW)
    assert r.busy_s == pytest.approx(0.5)
    assert r.stage_seconds("decode") == pytest.approx(0.5)


# the readers of the port's spans (``harness/spans.py``): a number on a
# trace that holds the spans, None on one without them
SPAN_READERS = {"encode.host_idle_ms", "decode.host_idle_ms",
                "encode.k4_passes"}


def test_each_metric_reader_reads_its_cells(stages):
    """Every per-layer metric of the manifest has a reader that gives a
    number on a canned trace of each cell it lists, a share in (0, 100];
    on the same trace without the port's spans a span reader gives None
    and every other reader the same number."""
    bench = layout.Benchmark()
    dev = {"encode": [(K4, "kernel", 0, 400_000), (K5, "kernel", 400_000,
                                                   20_000)],
           "decode": [(K3, "kernel", 0, 900_000)]}
    # one call's spans (name, start us, dur us), as the port opens them;
    # the device idles from 420 ms (encode) or 900 ms (decode) to 990 ms
    port = {"encode": [("zling.encode", 0, 990_000),
                       ("zling.enc.launch", 1_000, 1_000),
                       ("zling.enc.frame", 500_000, 100_000)],
            "decode": [("zling.decode", 0, 990_000),
                       ("zling.dec.fetch", 900_000, 50_000)]}
    for m in bench.manifest["per_layer"]:
        for cell in m["workloads"]:
            op = bench.traffic(bench.cell(cell)["traffic"])["op"]
            c = chrome(dev[op])
            bare = reading.Reading(reading.Trace(c), stages, op, Q, 1, BW)
            c["traceEvents"] += [ev(n, "user_annotation", s, d)
                                 for n, s, d in port[op]]
            r = reading.Reading(reading.Trace(c), stages, op, Q, 1, BW)
            v, v_bare = (bench.reader(m["name"])(x) for x in (r, bare))
            assert v is not None and v > 0, (m["name"], cell, v)
            if m["unit"] == "%":
                assert v <= 100, (m["name"], cell, v)
            if m["name"] in SPAN_READERS:
                assert v_bare is None, (m["name"], cell, v_bare)
            else:
                assert v_bare == v, (m["name"], cell, v_bare, v)
    json.dumps(bench.listing())
