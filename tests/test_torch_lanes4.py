"""``encode``'s lane over every visible card, and the four-card group shape,
on the CPU.

Routing: ``device.encode`` on ``"cuda"`` runs the lanes on every visible
card, on ``"cuda:N"`` (or a ``torch.device`` with an index) on that card
alone, on ``"cpu"`` on the host; one visible card gives the one-card lane.
The cards are stood in for by patching ``torch.cuda``'s ``is_available``
and ``device_count``, and the lane's device list is captured where
``device.encode`` hands it to ``mesh_encode``.

Group shape: 60 blocks over 4 entries at 8 blocks an entry, the last
block short -- two groups of 32 + 28 blocks, the second's runs 8, 8, 8
and 4 -- at a small geometry, against ``spec.encode``.  CPU entries are
no cards, so no hand opens ``zling.enc.hand`` or counts
``enc.card_hands``.

Tolerance: exact equality -- streams are bytes.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from libzling_tpu import spec
from libzling_tpu_torch import device as tdevice
from libzling_tpu_torch import group_encode as ge
from libzling_tpu_torch.group_encode import GROUP_BLOCKS
from libzling_tpu_torch.parallel import mesh_encode
from libzling_tpu_torch.utils import metrics


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
    seen = []

    def lane(data, level, devices, **kw):
        seen.append((list(devices), kw["blocks_per_device"]))
        return b"stream"

    monkeypatch.setattr(tdevice, "mesh_encode", lane)
    assert tdevice.encode(b"abc", 4, device=device) == b"stream"
    assert seen == [([torch.device(d) for d in want], GROUP_BLOCKS)]


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
    assert runs == [8] * 4 + [8, 8, 8, 4] * (1 + redispatch)
    assert "enc.card_hands" not in counters
    spans = {e.key for e in prof.key_averages()}
    assert "zling.enc.launch" in spans and "zling.enc.hand" not in spans
