"""The port's stage spans (``utils/metrics.stage``) on the CPU, read back
from the Chrome trace that ``utils/metrics.trace`` writes: every encode
and decode stage appears, nested in its call's top span; the group loop's
K4 + K5 passes agree with its counters; no span stays open across the
group loop's ``yield``; and the spans change no byte.

Tolerance: exact -- span names, counts and nesting are read from one
thread's timeline; streams and outputs are bytes.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from chip_smoke import PartFaults, chunk_stream
from libzling_tpu import spec
from libzling_tpu_torch import api
from libzling_tpu_torch.parallel import mesh, mesh_encode
from libzling_tpu_torch.utils import metrics

GEOM = dict(block_size=3000, max_tokens=700)
ENCODE_SPANS = {"zling.enc." + s for s in (
    "dispatch", "stage", "launch", "tokenize", "relabel", "gather_freqs",
    "wait", "length_tables", "pack_step", "gather_pack_meta", "validate",
    "gather_words", "frame")}
FUSED_SPANS = {"zling.dec." + s for s in (
    "parse", "stage", "k3", "status", "fetch")}
SPLIT_SPANS = {"zling.dec." + s for s in (
    "parse", "entropy", "gather", "resolve", "collect")}
# the spans of the eight stages the JAX package's stage probe times (its
# encode_step: a group's dispatch and every K4 + K5 pass)
PROBE_SPANS = {"zling.enc." + s for s in (
    "dispatch", "launch", "gather_freqs", "length_tables", "pack_step",
    "gather_pack_meta", "validate", "gather_words", "frame")}


def _text(n: int = 9000) -> bytes:
    rng = np.random.default_rng(5)
    words = [b"alpha", b"beta", b"gamma", b"delta"]
    return b" ".join(words[i] for i in rng.integers(0, 4, n // 5))[:n]


def _ends_in_noise() -> bytes:
    # tests/test_torch_mesh.py's: the first group of 2 x 3000 bytes ends
    # in random bytes, so its schedule is fixed once and the look-ahead,
    # which predicted the requested level, is dispatched again
    rng = np.random.default_rng(5)
    words = [b"alpha", b"beta", b"gamma", b"delta"]
    text = b" ".join(words[i] for i in rng.integers(0, 4, 3000))
    return text[:5000] + bytes(rng.integers(0, 256, 1000, np.uint8)) \
        + text[5000:9000]


def traced(fn, tmp_path, name="region"):
    """``fn()`` under ``metrics.trace``; returns its result and the port's
    spans (name, start, end) of the Chrome trace, in start order."""
    path = str(tmp_path / "trace.json")
    with metrics.trace(name, path):
        out = fn()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"].startswith(("zling.", "caller."))),
                   key=lambda s: s[1])
    return out, spans


def names(spans, prefix="zling.") -> list[str]:
    return [n for n, _, _ in spans if n.startswith(prefix)]


def inside(span, outer) -> bool:
    return outer[1] <= span[1] and span[2] <= outer[2]


def assert_nested(spans, top: str, prefix: str) -> None:
    tops = [s for s in spans if s[0] == top]
    assert tops
    for s in spans:
        if s[0].startswith(prefix):
            assert any(inside(s, t) for t in tops), s


@pytest.mark.parametrize("name", ["ends in noise", "text"])
def test_encode_spans_nest_under_the_call(name, tmp_path):
    # one group of up to 8 blocks on one device; "ends in noise" fixes its
    # schedule and runs K4 + K5 again
    data = _ends_in_noise() if name == "ends in noise" else _text()
    metrics.registry.reset()
    got, spans = traced(lambda: api.encode(data, 2, device="cpu", **GEOM),
                        tmp_path)
    assert got == spec.encode(data, 2, **GEOM)
    assert set(names(spans)) == ENCODE_SPANS | {"zling.encode"}
    assert names(spans).count("zling.encode") == 1
    reruns = metrics.registry.snapshot()["counters"].get(
        "enc.schedule_mispredicts", 0)
    assert (reruns > 0) == (name == "ends in noise")
    if not reruns:
        # a clean group opens its stages once: at most about 20 spans
        assert len(names(spans)) <= 20
    assert_nested(spans, "zling.encode", "zling.enc.")
    # the stages within a stage
    for inner, outer in (("zling.enc.wait", "zling.enc.gather_freqs"),
                         ("zling.enc.stage", "zling.enc.dispatch"),
                         ("zling.enc.tokenize", "zling.enc.launch"),
                         ("zling.enc.relabel", "zling.enc.launch")):
        outers = [s for s in spans if s[0] == outer]
        for s in spans:
            if s[0] == inner:
                assert any(inside(s, o) for o in outers), (inner, outer)


@pytest.mark.parametrize("name,redispatch", [("ends in noise", 1),
                                             ("text", 0)])
def test_k4_passes_are_frames_plus_the_counted_reruns(name, redispatch,
                                                      tmp_path):
    data = _ends_in_noise() if name == "ends in noise" \
        else _ends_in_noise()[:5000] * 2
    metrics.registry.reset()
    got, spans = traced(lambda: mesh_encode(data, 2, ["cpu", "cpu"],
                                            **GEOM), tmp_path)
    assert got == spec.encode(data, 2, **GEOM)
    counters = metrics.registry.snapshot()["counters"]
    assert counters.get("enc.pipeline_redispatch", 0) == redispatch
    n = names(spans)
    assert n.count("zling.enc.frame") == 2                # two groups
    assert n.count("zling.enc.launch") == n.count("zling.enc.frame") + \
        counters.get("enc.schedule_mispredicts", 0) + \
        counters.get("enc.pipeline_redispatch", 0)


@pytest.mark.parametrize("name,D", [("ends in noise", 2), ("text", 1),
                                    ("text", 3)])
def test_the_lanes_spans_hold_every_probed_stage(name, D, tmp_path):
    # mesh_encode over D CPU lanes keeps the bytes and opens a span for
    # every stage; "ends in noise": a mispredict re-runs the first group,
    # a launch outside any dispatch
    data = _ends_in_noise() if name == "ends in noise" else _text()
    metrics.registry.reset()
    got, spans = traced(lambda: mesh_encode(data, 2, ["cpu"] * D, **GEOM),
                        tmp_path)
    assert got == spec.encode(data, 2, **GEOM)
    assert PROBE_SPANS <= set(names(spans))
    dispatches = [s for s in spans if s[0] == "zling.enc.dispatch"]
    reruns = [s for s in spans if s[0] == "zling.enc.launch"
              and not any(inside(s, d) for d in dispatches)]
    mispredicts = metrics.registry.snapshot()["counters"].get(
        "enc.schedule_mispredicts", 0)
    assert len(reruns) == mispredicts
    assert (mispredicts > 0) == (name == "ends in noise")


def test_a_failover_is_a_span(tmp_path):
    # two-block groups with distinct heads; group 1's finish loses its
    # device and the group is encoded again on the host
    block = 1024
    text = _text(5 * 2 * block)
    data = b"".join(b"<group %02d> " % g + text[g * 2 * block + 11:
                                                 (g + 1) * 2 * block]
                    for g in range(3))
    faults = PartFaults(data, 2 * block, {1: "finish"}, torch.device("cpu"))
    with faults:
        got, spans = traced(lambda: mesh_encode(
            data, 4, ["cpu"] * 2, block_size=block, max_tokens=400,
            elastic=True), tmp_path)
    assert got == spec.encode(data, 4, block_size=block, max_tokens=400)
    assert faults.faults == {}
    assert names(spans).count("zling.enc.failover") == 1
    # at this chunk cap the host re-encodes the group through ``Part`` on
    # the CPU: its own pass and frame lie inside the failover span
    failover, = [s for s in spans if s[0] == "zling.enc.failover"]
    frames = [s for s in spans if s[0] == "zling.enc.frame"]
    assert len(frames) == 3
    assert sum(inside(f, failover) for f in frames) == 1


def test_no_span_stays_open_across_the_group_loops_yield(tmp_path):
    # the streamed route: the caller's own work between two groups lies
    # outside every span the group loop opened
    data = _text(4 * 3000)
    lanes = mesh.Lanes([torch.device("cpu")])

    def stream():
        out = []
        groups = (data[i:i + 6000] for i in range(0, len(data), 6000))
        for part, _ in mesh.encode_groups(groups, 2, lanes, 3000, 700, 2):
            with torch.profiler.record_function("caller.between"):
                out.append(part)
        return b"".join(out)

    got, spans = traced(stream, tmp_path)
    assert got == spec.encode(data, 2, **GEOM)
    between = [s for s in spans if s[0] == "caller.between"]
    assert len(between) == 2
    for b in between:
        assert not any(inside(b, s) for s in spans
                       if s[0].startswith("zling."))


@pytest.mark.parametrize("fused", [True, False])
def test_decode_spans_nest_under_the_call(fused, tmp_path):
    data = _ends_in_noise()
    stream = spec.encode(data, 4, **GEOM)
    got, spans = traced(lambda: api.decode(stream, device="cpu",
                                           fused=fused), tmp_path)
    assert got == data
    want = FUSED_SPANS if fused else SPLIT_SPANS
    assert set(names(spans)) == want | {"zling.decode"}
    assert names(spans).count("zling.decode") == 1
    assert_nested(spans, "zling.decode", "zling.dec.")
    if fused:
        # one fused call opens at most 7 spans
        assert len(names(spans)) <= 7
        assert [n for n in names(spans)] == [
            "zling.decode", "zling.dec.parse", "zling.dec.stage",
            "zling.dec.k3", "zling.dec.status", "zling.dec.fetch"]


def test_a_corrupt_stream_still_closes_its_spans(tmp_path):
    # a match whose index is 0: K3 marks the chunk bad, the status check
    # raises
    stream = chunk_stream([65, 66, 258, 0], 6)

    def run():
        with pytest.raises(ValueError):
            api.decode(stream, device="cpu")

    _, spans = traced(run, tmp_path)
    assert names(spans) == ["zling.decode", "zling.dec.parse",
                            "zling.dec.stage", "zling.dec.k3",
                            "zling.dec.status"]
    assert_nested(spans, "zling.decode", "zling.dec.")
