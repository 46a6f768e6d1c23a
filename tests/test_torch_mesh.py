"""The port's lanes over several devices, on the CPU (every kernel's plain
version; a device entry is ``"cpu"``): ``mesh_encode`` against
``spec.encode`` (also with its ``stage_probe``), the port's one-device ``encode`` and, on a 2-device CPU
mesh, ``libzling_tpu.parallel.mesh.mesh_encode``; ``mesh_decode`` back to
the data and against ``libzling_tpu.parallel.decode_mesh.mesh_decode``;
the look-ahead's re-dispatch; corrupt streams; the device checks.

Tolerance: exact equality -- streams and outputs are bytes; a corrupt
stream must raise ValueError.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

import libzling_tpu_torch as zt
from chip_smoke import chunk_stream
from libzling_tpu import spec
from libzling_tpu.parallel import decode_mesh as jdecode_mesh
from libzling_tpu.parallel import mesh as jmesh
from libzling_tpu_torch import _build
from libzling_tpu_torch.parallel import make_mesh, mesh_decode, mesh_encode
from libzling_tpu_torch.utils import metrics

GEOM = dict(block_size=3000, max_tokens=700)
# K1's and K2's slab parameters of the JAX decode at this geometry
JAX_DECODE = dict(max_tokens=1024, flush_tokens=512, slab_words=512,
                  slab_tokens=512)


def _data() -> bytes:
    # text, random bytes, then text: the level drops and recovers across a
    # group edge (tests/test_parallel.py::test_mesh_encode_equals_spec_bytes)
    rng = np.random.default_rng(9)
    return ((b"the quick brown fox jumps over the lazy dog. " * 120)
            + bytes(rng.integers(0, 256, 6000, dtype=np.uint8))
            + (b"abcdefgh" * 600))


@functools.lru_cache(maxsize=None)
def _spec(level: int) -> bytes:
    return spec.encode(_data(), level, **GEOM)


@functools.lru_cache(maxsize=None)
def _port(level: int) -> bytes:
    return zt.encode(_data(), level, device="cpu", **GEOM)


@pytest.mark.parametrize("bpd", [1, 2])
@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("level", [0, 2, 4, 6])
def test_mesh_encode_equals_spec_and_encode(level, D, bpd):
    got = mesh_encode(_data(), level, ["cpu"] * D, blocks_per_device=bpd,
                      **GEOM)
    assert got == _spec(level)
    assert got == _port(level)


def test_mesh_encode_equals_jax_mesh_encode():
    mesh = jmesh.make_mesh(np.asarray(jax.devices()[:2]))
    want = jmesh.mesh_encode(_data(), 2, mesh=mesh, **GEOM)
    assert mesh_encode(_data(), 2, ["cpu", "cpu"], **GEOM) == want


def _ends_in_noise() -> bytes:
    # the first group of 2 x 3000 bytes ends in random bytes, so it exits
    # at level 0 where the look-ahead predicted the requested level
    rng = np.random.default_rng(5)
    words = [b"alpha", b"beta", b"gamma", b"delta"]
    text = b" ".join(words[i] for i in rng.integers(0, 4, 3000))
    return text[:5000] + bytes(rng.integers(0, 256, 1000, np.uint8)) \
        + text[5000:9000]


@pytest.mark.parametrize("name,redispatch", [("ends in noise", 1),
                                             ("text", 0)])
def test_lookahead_redispatch_keeps_the_bytes(name, redispatch):
    data = _ends_in_noise() if name == "ends in noise" \
        else _ends_in_noise()[:5000] * 2
    metrics.registry.reset()
    got = mesh_encode(data, 2, ["cpu", "cpu"], **GEOM)
    counters = metrics.registry.snapshot()["counters"]
    assert got == spec.encode(data, 2, **GEOM)
    assert counters.get("enc.pipeline_redispatch", 0) == redispatch
    # the drop inside the first group makes its schedule mispredict once
    assert counters.get("enc.schedule_mispredicts", 0) == redispatch


ENCODE_STAGES = {"encode_step", "gather_freqs", "length_tables",
                 "pack_step", "gather_pack_meta", "validate",
                 "gather_words", "frame"}


@pytest.mark.parametrize("name,D", [("ends in noise", 2), ("text", 1),
                                    ("text", 3)])
def test_stage_probe_keeps_the_bytes_and_names_the_stages(name, D):
    # "ends in noise": a mispredict re-runs a group and re-dispatches the
    # look-ahead, both timed as encode_step
    data = _ends_in_noise() if name == "ends in noise" else _data()
    want = mesh_encode(data, 2, ["cpu"] * D, **GEOM)
    probe: dict = {}
    got = mesh_encode(data, 2, ["cpu"] * D, stage_probe=probe, **GEOM)
    assert got == want == spec.encode(data, 2, **GEOM)
    assert set(probe) == ENCODE_STAGES
    assert all(v >= 0 for v in probe.values()), probe


@pytest.mark.parametrize("gb", [1, 2])
@pytest.mark.parametrize("D", [1, 2, 3])
def test_mesh_decode_round_trip(D, gb):
    assert mesh_decode(_spec(2), ["cpu"] * D, group_blocks=gb) == _data()


def test_mesh_decode_equals_jax_mesh_decode():
    mesh = jmesh.make_mesh(np.asarray(jax.devices()[:2]))
    stream = _spec(1)
    want = jdecode_mesh.mesh_decode(stream, mesh=mesh, group_blocks=1,
                                    **JAX_DECODE)
    probe = {}
    assert mesh_decode(stream, ["cpu", "cpu"], group_blocks=1,
                       stage_probe=probe) == want == _data()
    assert set(probe) == {"entropy_s", "gather_s", "resolve_s"}


# phase 5's corrupt streams of chip_smoke.py, a truncation and a bad flag
CORRUPT = {
    "match index 0": lambda: chunk_stream([65, 66, 258, 0], 6),
    "encpos mismatch": lambda: chunk_stream([65, 66, 67], 9),
    "truncated": lambda: _spec(2)[:-7],
    "flag byte": lambda: b"\x02" + _spec(2)[1:],
}


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("name", sorted(CORRUPT))
def test_mesh_decode_rejects_corrupt_streams(name, D):
    with pytest.raises(ValueError):
        mesh_decode(CORRUPT[name](), ["cpu"] * D, group_blocks=1)


def test_empty_input():
    assert mesh_encode(b"", 0, ["cpu", "cpu"]) == b""
    assert mesh_decode(b"", ["cpu", "cpu"]) == b""
    assert mesh_decode(spec.encode(b"", 0), ["cpu", "cpu"]) == b""


def test_device_lists_and_checks():
    assert make_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        make_mesh([])
    with pytest.raises(ValueError):
        mesh_encode(b"abc", 7, ["cpu"])
    with pytest.raises(ValueError):
        mesh_encode(b"abc", 0, ["cpu"], blocks_per_device=0)
    with pytest.raises(ValueError):
        mesh_decode(_spec(2), ["cpu"], group_blocks=0)
    if not torch.cuda.is_available():
        # the default is every GPU: none means an error, not the CPU
        with pytest.raises(RuntimeError):
            make_mesh()
        with pytest.raises(RuntimeError):
            make_mesh(["cpu", "cuda"])
    # a kernel's tensors must lie on its device: the pointers it reads on
    # that device itself, host metadata on the host or there
    dev = torch.device("cuda", 0)
    host, meta = torch.zeros(1), torch.zeros(1, device="meta")
    _build.check_devices("k", dev, copied=(host,))
    with pytest.raises(ValueError):
        _build.check_devices("k", dev, direct=(host,))
    with pytest.raises(ValueError):
        _build.check_devices("k", dev, copied=(meta,))


def test_metrics_registry_and_trace():
    m = metrics.Metrics()
    m.count("enc.pipeline_redispatch")
    m.count("enc.pipeline_redispatch", 2)
    assert m.snapshot() == {"counters": {"enc.pipeline_redispatch": 3}}
    m.reset()
    assert m.snapshot() == {"counters": {}}
    # a span without a probe times nothing; with one it adds its seconds
    # under its key (the last dotted part of its name by default)
    probe: dict = {}
    with metrics.trace("lane") as prof:
        with metrics.stage("enc.frame"):
            torch.ones(8).sum()
        for _ in range(2):
            with metrics.stage("enc.validate", probe):
                torch.ones(8).sum()
        with metrics.stage("dec.entropy", probe, "entropy_s", sync=()):
            pass
    assert set(probe) == {"validate", "entropy_s"}
    assert all(v >= 0 for v in probe.values())
    keys = {e.key: e.count for e in prof.key_averages()}
    assert keys["lane"] == 1 and keys["zling.enc.frame"] == 1
    assert keys["zling.enc.validate"] == 2
    assert keys["zling.dec.entropy"] == 1
    # a stage that raises closes its span and adds nothing to the probe
    with pytest.raises(ValueError):
        with metrics.stage("enc.frame", probe, "frame"):
            raise ValueError
    assert "frame" not in probe
