"""The cards a run used, and a trace read card by card.

A run counts the cards on which the program's allocator held memory
during the window (``runner.Port.device_info``) and is not ``correct``
when that leaves one of its cell's ``chips`` unused (``devices_unused``).
On the CPU a fake ``torch.cuda`` of four cards stands in for the machine,
and canned four-card traces for the profiler's; the test marked ``cuda``
puts torch work on the machine's real cards.
"""

import json
import pathlib
import subprocess
import sys
import types

import pytest

from benchmark.harness import layout, reading, runner, spans
from benchmark.reference import codec
from benchmark.tests.test_bench_reading import BW, K4, K5, Q, chrome, ev

REPO = pathlib.Path(__file__).resolve().parents[2]
H100 = "NVIDIA H100 80GB HBM3"
CELL = "enwik8-e0.encode"
SMALL = {"bytes": 40_000}


class FakeCuda:
    """``torch.cuda`` as the harness reads it: each card's allocated bytes
    and their peak since the last reset."""

    def __init__(self, n: int, names=None):
        self.names = names or [H100] * n
        self.held, self.peak, self.synced = [0] * n, [0] * n, []

    def device_count(self):
        return len(self.held)

    def synchronize(self, i):
        self.synced.append(i)

    def reset_peak_memory_stats(self, i):
        self.peak[i] = self.held[i]

    def max_memory_allocated(self, i):
        return self.peak[i]

    def get_device_name(self, i):
        return self.names[i]

    def empty_cache(self):
        pass

    def alloc(self, i, nbytes):
        self.held[i] += nbytes
        self.peak[i] = max(self.peak[i], self.held[i])


class Cards(runner.Port):
    """The port on the CPU, watched through a fake ``torch.cuda``: each
    call holds ``use[i]`` bytes on card ``i`` while it runs; the first
    call (the warm-up) also runs ``warm``."""

    def __init__(self, fake: FakeCuda, use: dict, warm=None):
        import torch
        from libzling_tpu_torch import api

        self.torch = types.SimpleNamespace(cuda=fake, profiler=torch.profiler)
        self.device, self.cuda = "cpu", True
        self.seconds, self.api = {}, api
        self.fake, self.use, self.warm = fake, use, warm

    def encode(self, data, level):
        if self.warm is not None:
            self.warm, warm = None, self.warm
            warm(self.fake)
        for i, n in self.use.items():
            self.fake.alloc(i, n)
        try:
            return super().encode(data, level)
        finally:
            for i, n in self.use.items():
                self.fake.alloc(i, -n)


class Chips(layout.Benchmark):
    """The manifest with its cells asking for ``chips`` cards."""

    def __init__(self, chips: int, per_layer=None):
        super().__init__()
        self.chips, self.only = chips, per_layer

    def cell(self, name):
        return {**super().cell(name), "chips": self.chips}

    def per_layer(self, cell):
        return [m for m in super().per_layer(cell)
                if self.only is None or m["name"] in self.only]


PEAKS = [3_000_000_000, 5_000_000_000, 2_000_000_000, 4_000_000_000]


@pytest.mark.parametrize("used", [4, 1, 0])
def test_a_run_short_of_cards_is_not_correct(used):
    fake = FakeCuda(4)
    use = dict(enumerate(PEAKS[:used]))
    out = runner.run(CELL, 2**40 + 7, 0.2, False, bench=Chips(4),
                     system=lambda: Cards(fake, use),
                     corpus_override=SMALL)
    res = out["result"]
    assert fake.synced == [0, 1, 2, 3]
    assert res["checks"]["bytes_differing"]["value"] == 0
    assert res["device"]["count"] == used
    assert res["device"]["memory_peak_bytes"] == max(PEAKS[:used],
                                                     default=0)
    assert res["device"]["devices"] == [
        {"index": i, "memory_peak_bytes": p} for i, p in use.items()]
    assert res["checks"]["devices_unused"] == {"value": 4 - used, "limit": 0}
    assert res["correct"] is (used == 4)
    assert out["check_lines"][-1] == (f"check devices_unused {4 - used} "
                                      "limit 0")


def test_a_buffer_held_counts_and_a_warm_up_alone_does_not():
    """Card 2 keeps a buffer made in the warm-up, card 3 frees its own
    before the window: 2 counts, 3 does not."""
    fake = FakeCuda(4)

    def warm(f):
        f.alloc(2, 1_000)
        f.alloc(3, 9 * 10**9)
        f.alloc(3, -9 * 10**9)

    out = runner.run(CELL, 2**40 + 8, 0.2, False, bench=Chips(3),
                     system=lambda: Cards(fake, {0: 7, 1: 5}, warm),
                     corpus_override=SMALL)
    res = out["result"]
    assert [d["index"] for d in res["device"]["devices"]] == [0, 1, 2]
    assert res["device"]["memory_peak_bytes"] == 1_000
    assert res["correct"] and res["checks"]["devices_unused"]["value"] == 0


def test_cards_of_two_kinds_raise():
    fake = FakeCuda(2, [H100, "NVIDIA A100-SXM4-80GB"])
    port = Cards(fake, {})
    fake.alloc(0, 1)
    assert port.device_info()["kind"] == H100
    fake.alloc(1, 1)
    with pytest.raises(RuntimeError, match="differ"):
        port.device_info()


def test_one_card_reads_as_before():
    """One card: the keys and values the result had before cards were
    counted, with the card's entry beside them."""
    fake = FakeCuda(1)
    port = Cards(fake, {})
    fake.alloc(0, 123)
    port.reset_peak()
    fake.alloc(0, 1_000)
    assert fake.synced == [0]
    assert port.device_info() == {
        "platform": "gpu", "kind": H100, "count": 1,
        "memory_peak_bytes": 1_123,
        "devices": [{"index": 0, "memory_peak_bytes": 1_123}]}


MS = 1000.0          # trace units (us) in a millisecond

# a window of 1 s on four cards; busy 420, 600, 210 and 800 ms
FOUR = [(K4, "kernel", 0, 400 * MS, 0),
        (K5, "kernel", 400 * MS, 20 * MS, 0),
        (K4, "kernel", 0, 600 * MS, 1),
        (K4, "kernel", 100 * MS, 200 * MS, 2),
        (K5, "kernel", 300 * MS, 10 * MS, 2),
        (K4, "kernel", 0, 800 * MS, 3)]
PORT = [("zling.encode", 0, 950), ("zling.enc.wait", 300, 700)]


def four_cards(stages):
    c = chrome(FOUR)
    c["traceEvents"] += [ev(n, "user_annotation", a * MS, (b - a) * MS)
                         for n, a, b in PORT]
    return reading.Reading(reading.Trace(c), stages, "encode", Q, 1, BW)


@pytest.fixture(scope="module")
def stages():
    return layout.Benchmark().stages()


def test_four_cards_busy_and_idle_are_per_card_means(stages):
    r = four_cards(stages)
    assert r.cards == (0, 1, 2, 3)
    assert r.card_busy_s == pytest.approx({0: 0.42, 1: 0.6, 2: 0.21,
                                           3: 0.8})
    assert r.busy_s == pytest.approx(0.5075)
    # the union over the cards would read 20% idle
    assert r.idle_pct() == pytest.approx(49.25)
    bench = layout.Benchmark()
    assert bench.reader("encode.idle_pct")(r) == pytest.approx(49.25)


def test_four_cards_gaps_card_by_card(stages):
    r = four_cards(stages)
    want = {0: [(0.42, 1.0)], 1: [(0.6, 1.0)], 2: [(0.0, 0.1), (0.31, 1.0)],
            3: [(0.8, 1.0)]}
    for card, gaps in want.items():
        got = r.gaps(card)
        assert len(got) == len(gaps)
        for g, w in zip(got, gaps):
            assert g == pytest.approx(w)
    assert r.gaps() == [g for c in range(4) for g in r.gaps(c)]
    b = r.breakdown()
    assert sum(dict(b["idle_gaps"]).values()) == pytest.approx(1 - 0.5075)
    assert dict(b["device_ops"])[
        "tokenize/(anonymous namespace)::tokenize_kernel"] == (
        pytest.approx(2.0 / 4))


def test_four_cards_host_idle_ms_is_a_cards_mean(stages):
    """Under ``zling.encode`` (to 950 ms) the cards idle 530, 350, 740
    and 150 ms; of that, 280, 100, 390 and 0 ms under ``enc.wait``."""
    r = four_cards(stages)
    got = spans.idle_under(r, "zling.encode")
    assert got["zling.enc.wait"] == pytest.approx(0.77 / 4)
    assert got["zling.encode"] == pytest.approx(1.0 / 4)
    assert layout.Benchmark().reader("encode.host_idle_ms")(r) == (
        pytest.approx(1000 * 1.77 / 4))


def test_four_cards_roofline_sums_the_device_time(stages):
    """The same work over the kernels' time on every card: K4 2.0 s,
    K5 30 ms."""
    r = four_cards(stages)
    assert r.stage_seconds("tokenize") == pytest.approx(2.0)
    assert r.roofline_pct("tokenize") == pytest.approx(
        100 * ((10**8 + 2 * 34_000_000) / BW) / 2.0)
    assert r.roofline_pct("relabel") == pytest.approx(
        100 * ((2 * 34_000_000 + 2 * 9_000_000) / BW) / 0.03)


def test_the_card_is_read_from_args_then_pid():
    assert reading.card_of({"args": {"device": 2}, "pid": 0}) == 2
    assert reading.card_of({"pid": 3}) == 3
    assert reading.card_of({"args": {}, "pid": "GPU"}) == 0
    assert reading.card_of({}) == 0


class TorchCards(runner.Port):
    """A throwaway program, not the port: each call multiplies matrices
    on the first ``cards`` CUDA devices and returns the reference's
    stream, so only the cards it used decide ``correct``."""

    def __init__(self, chips: int, cards: int):
        super().__init__("cuda", chips)
        self.cards = cards

    def encode(self, data, level):
        torch = self.torch
        for i in range(self.cards):
            x = torch.randn(2048, 2048, device=f"cuda:{i}")
            for _ in range(8):
                x = torch.tanh(x @ x)
            torch.cuda.synchronize(i)
        return codec.encode(data, level)


RUN_CARDS = """
import json, sys
from benchmark.harness import runner
from benchmark.tests.test_bench_cards import CELL, SMALL, Chips, TorchCards
n, short, trace = map(int, sys.argv[1:])
out = runner.run(CELL, 2**40 + 9, 1.0, bool(trace),
                 bench=Chips(n, per_layer={"encode.idle_pct"}),
                 system=lambda: TorchCards(n, n - short),
                 corpus_override=SMALL)
print(json.dumps(out["result"]))
"""


def run_cards(n: int, short: int, trace: bool) -> dict:
    """The result line of one run of ``TorchCards`` on ``n - short`` of
    ``n`` cards, in a process of its own as the benchmark runs: a card
    that an earlier run in the same process worked on still holds
    cuBLAS's workspace, and a buffer held counts."""
    r = subprocess.run([sys.executable, "-c", RUN_CARDS, str(n), str(short),
                        str(int(trace))], cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("short, trace", [(0, False), (0, True), (1, False)])
def test_cards_on_this_machine(short, trace):
    """All the machine's cards used, then one left out, which fails
    ``devices_unused``; traced, each card's own busy time."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"needs 2 CUDA devices; {n} found")
    res = run_cards(n, short, trace)
    dev = res["device"]
    assert res["checks"]["bytes_differing"]["value"] == 0
    assert dev["count"] == n - short
    assert [d["index"] for d in dev["devices"]] == list(range(n - short))
    assert dev["memory_peak_bytes"] == max(d["memory_peak_bytes"]
                                           for d in dev["devices"])
    assert res["checks"]["devices_unused"]["value"] == short
    assert res["correct"] is (short == 0)
    if trace:
        assert all(d["busy_s"] > 0 for d in dev["devices"])
        assert dev["busy_s"] == pytest.approx(
            sum(d["busy_s"] for d in dev["devices"]) / n)
        assert 0 < res["metrics"]["encode.idle_pct"]["value"] < 100
