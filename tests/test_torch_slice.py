"""The port's whole round trip on the CPU (every kernel's plain version):
``libzling_tpu_torch.encode`` against ``spec.encode`` at small geometry and
against ``libzling_tpu.device.encode`` (the Pallas lane in interpret mode)
at the canonical geometry; ``decode`` back to the input.

Tolerance: exact equality -- streams and outputs are bytes.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch

import libzling_tpu_torch as zt
from libzling_tpu import device as jdevice
from libzling_tpu import spec
from libzling_tpu.tables import LEVEL_PARAMS
from libzling_tpu_torch.group_encode import GROUP_BLOCKS
from libzling_tpu_torch.parallel import mesh_encode
from libzling_tpu_torch.utils import metrics


def _text_and_random(seed: int = 7) -> bytes:
    # text blocks with random bytes between them, so the adaptive level drop
    # fires mid-stream and the carried level crosses block boundaries
    rng = np.random.default_rng(seed)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon", b"zeta",
             b"theta", b"kappa", b"lambda"]
    text = b" ".join(words[i] for i in rng.integers(0, len(words), 900))
    noise = bytes(rng.integers(0, 256, 1500, dtype=np.uint8))
    return text[:2500] + noise + text[2500:5000]


@pytest.mark.parametrize("level", [0, 1, 4, 6])
def test_encode_matches_spec_small_geometry(level):
    data = _text_and_random()
    stats = spec.EncodeStats()
    want = spec.encode(data, level, stats=stats, block_size=1024,
                       max_tokens=400)
    assert stats.level_drops > 0 and stats.blocks > 4
    got = zt.encode(data, level, device="cpu", block_size=1024,
                    max_tokens=400)
    assert got == want
    assert zt.decode(got, device="cpu") == data


def _across_group_edge(block_size: int, seed: int = 11) -> bytes:
    # ten blocks of text with random bytes just before the edge of the first
    # group: the last chunk of that group drops to level 0, so the next group
    # starts from a carried level and a carried MTF state
    rng = np.random.default_rng(seed)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon", b"zeta",
             b"theta", b"kappa", b"lambda"]
    text = b" ".join(words[i] for i in rng.integers(0, len(words), 3000))
    cut = GROUP_BLOCKS * block_size - 3 * block_size // 8
    noise = bytes(rng.integers(0, 256, block_size // 2, dtype=np.uint8))
    return (text[:cut] + noise + text[cut:])[:10 * block_size]


@pytest.mark.parametrize("level", [0, 4])
def test_encode_matches_spec_across_groups(level):
    data = _across_group_edge(1024)
    stats = spec.EncodeStats()
    want = spec.encode(data, level, stats=stats, block_size=1024,
                       max_tokens=400)
    assert stats.level_drops > 0 and stats.blocks > GROUP_BLOCKS
    # the lanes at GROUP_BLOCKS a group, as the streamed routes run them
    metrics.registry.reset()
    got = mesh_encode(data, level, ["cpu"], block_size=1024, max_tokens=400,
                      blocks_per_device=GROUP_BLOCKS)
    assert metrics.registry.snapshot()["counters"]["enc.groups"] == 2
    assert got == want
    assert zt.encode(data, level, device="cpu", block_size=1024,
                     max_tokens=400) == want
    assert zt.decode(got, device="cpu") == data


def test_encode_matches_jax_device_canonical_geometry():
    rng = np.random.default_rng(5)
    data = (b"tpu encode lane through the public api " * 40)[:1000] \
        + bytes(rng.integers(0, 256, 500, dtype=np.uint8))
    stream = zt.encode(data, 0, device="cpu")
    assert stream == jdevice.encode(data, 0)
    assert zt.decode(stream, device="cpu") == data


@pytest.mark.parametrize("n", [0, 1, 2])
def test_tiny_inputs_round_trip(n):
    data = b"xy"[:n]
    stream = zt.encode(data, 0, device="cpu")
    assert stream == spec.encode(data, 0)
    assert zt.decode(stream, device="cpu") == data


def test_rejects_bad_level_and_missing_device():
    with pytest.raises(ValueError):
        zt.encode(b"abc", max(LEVEL_PARAMS) + 1, device="cpu")
    with pytest.raises(ValueError):
        zt.encode(b"abc", -1, device="cpu")
    if not torch.cuda.is_available():
        # the default device is CUDA: no GPU means an error, not the CPU
        with pytest.raises(RuntimeError):
            zt.encode(b"abc")
        with pytest.raises(RuntimeError):
            zt.decode(spec.encode(b"abc", 0))


def test_file_round_trip(tmp_path):
    data = _text_and_random(3)[:3000]
    src, mid, dst = (tmp_path / n for n in ("in", "mid.zlg", "out"))
    src.write_bytes(data)
    assert zt.encode_file(str(src), str(mid), 2, device="cpu") == \
        (len(data), mid.stat().st_size)
    assert mid.read_bytes() == spec.encode(data, 2)
    zt.decode_file(str(mid), str(dst), device="cpu")
    assert dst.read_bytes() == data


def test_import_leaves_jax_out():
    code = ("import sys, libzling_tpu_torch, libzling_tpu_torch.device; "
            "from libzling_tpu_torch.ops import huffman; "
            "print('jax' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, check=True, timeout=300)
    assert r.stdout.strip() == "False"
