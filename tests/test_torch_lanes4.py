"""``encode``'s lane over every visible card, and the four-card group shape,
on the CPU.

Routing: ``device.encode`` on ``"cuda"`` runs the lanes on every visible
card, on ``"cuda:N"`` (or a ``torch.device`` with an index) on that card
alone, on ``"cpu"`` on the host; one visible card gives the one-card lane.
The cards are stood in for by patching ``torch.cuda``'s ``is_available``
and ``device_count``, and the lane's device list is captured where
``device.encode`` hands it to ``mesh_encode``.

Run size: ``device.encode`` on cards spreads the input's blocks evenly
over them in one group, up to ``run_cap`` a card (``one_shot_run_blocks``;
the card's properties are stood in for too), on the host ``GROUP_BLOCKS``.

Group shape: 60 blocks over 4 entries, the last block short, at a small
geometry, against ``spec.encode``: at 8 blocks an entry (the streamed
routes' size) two groups of 32 + 28 blocks, the second's runs 8, 8, 8 and
4; at the one-shot size one group, runs of 15.  CPU entries are no cards,
so no hand opens ``zling.enc.hand`` or counts ``enc.card_hands``.

Tolerance: exact equality -- streams are bytes.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from libzling_tpu import spec
from libzling_tpu_torch import device as tdevice
from libzling_tpu_torch import group_encode as ge
from libzling_tpu_torch.group_encode import GROUP_BLOCKS
from libzling_tpu_torch.parallel import mesh_encode
from libzling_tpu_torch.utils import metrics


# an H100 80GB HBM3 as torch reports it
H100 = SimpleNamespace(multi_processor_count=132, total_memory=85_017_493_504)


@pytest.mark.parametrize("device,visible,want", [
    ("cuda", 4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    ("cuda:2", 4, ["cuda:2"]),
    (torch.device("cuda", 3), 4, ["cuda:3"]),
    ("cuda", 1, ["cuda:0"]),
    ("cpu", 4, ["cpu"]),
])
def test_encode_routes_over_the_visible_cards(monkeypatch, device, visible,
                                              want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: H100)
    seen = []

    def lane(data, level, devices, **kw):
        seen.append((list(devices), kw["blocks_per_device"]))
        return b"stream"

    monkeypatch.setattr(tdevice, "mesh_encode", lane)
    # 60 blocks: one group of 15 a card over four cards; on one card runs
    # of the H100's cap, 16; GROUP_BLOCKS a group on the host
    data = bytes(BLOCKS * GEOM["block_size"] - 78)
    assert tdevice.encode(data, 4, device=device,
                          block_size=GEOM["block_size"]) == b"stream"
    size = {4: 15, 1: 16}[len(want)] if want != ["cpu"] else GROUP_BLOCKS
    assert seen == [([torch.device(d) for d in want], size)]


@pytest.mark.parametrize("blocks,cards,cap,size,groups", [
    (6, 1, 16, 6, 1),       # an enwik8 cell: one group, as before
    (60, 4, 16, 15, 1),     # the enwik9 cell over four H100s
    (60, 1, 60, 60, 1),     # the same input on one card, a cap that holds it
    (60, 1, 16, 16, 4),     # ... on one H100, whose cap binds: four groups
    (60, 4, 8, 8, 2),
    (6, 4, 16, 2, 1),       # a small input spreads over three cards
    (1, 4, 16, 1, 1),
    (0, 4, 16, 1, 0),
])
def test_one_shot_run_blocks(blocks, cards, cap, size, groups):
    assert tdevice.one_shot_run_blocks(blocks, cards, cap) == size
    # encode_lanes' groups of cards x size blocks
    assert -(-blocks // (cards * size)) == groups


@pytest.mark.parametrize("sms,memory,cap", [
    (132, H100.total_memory, 16),          # the H100: memory binds
    (8, H100.total_memory, 8),             # few SMs: one CTA each
    (132, 160 << 30, 33),                  # twice the memory
    (132, 1 << 20, 1),                     # never below one block
])
def test_run_cap_reads_the_card(monkeypatch, sms, memory, cap):
    card = SimpleNamespace(multi_processor_count=sms, total_memory=memory)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: card)
    assert tdevice.run_cap([torch.device("cuda", 0)] * 2) == cap
    # the smaller of two cards sets it
    cards = {0: H100, 1: card}
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: cards[d.index])
    assert tdevice.run_cap([torch.device("cuda", i) for i in (0, 1)]) \
        == min(cap, 16)


GEOM = dict(block_size=128, max_tokens=80)
BLOCKS = 60


@functools.lru_cache(maxsize=None)
def _data() -> bytes:
    # 59 whole blocks and a short one
    rng = np.random.default_rng(7)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"lanes", b"cards"]
    text = b" ".join(words[i] for i in rng.integers(0, 6, 2000))
    return text[:(BLOCKS - 1) * GEOM["block_size"] + 50]


@functools.lru_cache(maxsize=None)
def _spec(level: int) -> bytes:
    return spec.encode(_data(), level, **GEOM)


# e0 takes the look-ahead as queued; at e4 the first group leaves level 0
# (its last chunk does not compress at this chunk size), so the
# look-ahead is dispatched again with its runs
@pytest.mark.parametrize("level,redispatch", [(0, 0), (4, 1)])
def test_four_entries_sixty_blocks_equal_spec(monkeypatch, level,
                                              redispatch):
    runs = []
    part = ge.Part.__init__

    def counted(self, data, blocks, *args, **kw):
        runs.append(len(blocks))
        part(self, data, blocks, *args, **kw)

    monkeypatch.setattr(ge.Part, "__init__", counted)
    metrics.registry.reset()
    with metrics.trace("call") as prof:
        got = mesh_encode(_data(), level, ["cpu"] * 4,
                          blocks_per_device=GROUP_BLOCKS, **GEOM)
    assert got == _spec(level)
    counters = metrics.registry.snapshot()["counters"]
    assert counters.get("enc.pipeline_redispatch", 0) == redispatch
    assert counters["enc.groups"] == 2
    assert runs == [8] * 4 + [8, 8, 8, 4] * (1 + redispatch)
    assert "enc.card_hands" not in counters
    spans = {e.key for e in prof.key_averages()}
    assert "zling.enc.launch" in spans and "zling.enc.hand" not in spans


@pytest.mark.parametrize("level", [0, 4])
def test_four_entries_sixty_blocks_one_shot(monkeypatch, level):
    # the one-shot size for 60 blocks on four cards: one group, runs of 15
    runs = []
    part = ge.Part.__init__

    def counted(self, data, blocks, *args, **kw):
        runs.append(len(blocks))
        part(self, data, blocks, *args, **kw)

    monkeypatch.setattr(ge.Part, "__init__", counted)
    metrics.registry.reset()
    size = tdevice.one_shot_run_blocks(BLOCKS, 4, 16)
    got = mesh_encode(_data(), level, ["cpu"] * 4, blocks_per_device=size,
                      **GEOM)
    assert got == _spec(level)
    counters = metrics.registry.snapshot()["counters"]
    assert runs == [15] * 4
    assert counters["enc.groups"] == 1
    assert counters.get("enc.pipeline_redispatch", 0) == 0
