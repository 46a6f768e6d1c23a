"""The port's split decode as a whole, on the CPU (the plain versions of K1
and K2): ``device.decode(fused=False)`` against
``libzling_tpu.device.decode(fused=False)`` and ``decode_groups`` against
``parallel/decode_mesh.py::mesh_decode`` on a one-device mesh, both JAX
paths in interpret mode, on multi-chunk multi-block streams, a stream
that starts with an empty block and streams with flipped payload bits.

Tolerance: exact equality of the bytes, or both sides raise ValueError.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

import libzling_tpu_torch as zt
from libzling_tpu import container, spec
from libzling_tpu import device as jdevice
from libzling_tpu.parallel import decode_mesh
from libzling_tpu.parallel import mesh as pmesh

KPARAMS = dict(slab_words=256, flush_tokens=128, max_tokens=4096,
               slab_tokens=256)
MESH_SMALL = dict(max_tokens=512, flush_tokens=512, slab_words=512,
                  slab_tokens=512)


def _data() -> bytes:
    rng = np.random.default_rng(41)
    return (b"split decode on one device " * 120
            + bytes(rng.integers(0, 256, 1200, dtype=np.uint8))) * 2


def _stream() -> bytes:
    # five 2048-byte blocks of several chunks each, so the MTF table
    # crosses block and group edges
    stream = spec.encode(_data(), level=1, block_size=2048, max_tokens=500)
    chunks, sizes = container.parse(stream)
    assert len(sizes) == 5 and len(chunks) > len(sizes)
    return stream


def _mesh():
    return pmesh.make_mesh(np.asarray(jax.devices()[:1]))


def _outcome(fn, stream):
    try:
        return fn(stream)
    except ValueError:
        return ValueError


def test_split_decode_matches_jax_split():
    stream = _stream()
    want = jdevice.decode(stream, interpret=True, fused=False, **KPARAMS)
    assert want == _data()
    assert zt.decode(stream, device="cpu", fused=False) == want


@pytest.mark.parametrize("gb", [1, 3])
def test_decode_groups_matches_mesh_decode(gb):
    stream = _stream()
    want = decode_mesh.mesh_decode(stream, mesh=_mesh(), group_blocks=gb,
                                   **MESH_SMALL)
    assert want == _data()
    assert zt.decode_groups(stream, "cpu", group_blocks=gb) == want


def test_leading_empty_block():
    # an empty block (a lone 0x00 flag) first: the groups skip it without
    # shifting block ids or output offsets
    crafted = b"\x00" + _stream()
    want = spec.decode(crafted)
    assert decode_mesh.mesh_decode(crafted, mesh=_mesh(), group_blocks=1,
                                   **MESH_SMALL) == want
    assert zt.decode_groups(crafted, "cpu", group_blocks=1) == want
    assert zt.decode(crafted, device="cpu", fused=False) == want


def test_bit_flips_agree_with_jax_split():
    # flipped payload bits: the port's split path, its group path and the
    # JAX split path all raise, or all return the same bytes
    rng = np.random.default_rng(17)
    stream = spec.encode(_data()[:3000], level=1, block_size=1024,
                         max_tokens=300)
    spans, pos = [], 0
    while pos < len(stream):          # payload spans: after 13-byte headers
        if stream[pos] == 0:
            pos += 1
            continue
        olen = int.from_bytes(stream[pos + 9:pos + 13], "big")
        spans.append((pos + 13, olen))
        pos += 13 + olen
    outcomes = set()
    for k in range(6):
        base, olen = spans[k % len(spans)]
        bad = bytearray(stream)
        bad[base + int(rng.integers(0, olen))] ^= 1 << int(rng.integers(8))
        bad = bytes(bad)
        want = _outcome(lambda s: jdevice.decode(
            s, interpret=True, fused=False, **KPARAMS), bad)
        assert _outcome(lambda s: zt.decode(s, device="cpu", fused=False),
                        bad) == want, k
        assert _outcome(lambda s: zt.decode_groups(s, "cpu", group_blocks=2),
                        bad) == want, k
        outcomes.add(want is ValueError)
    assert True in outcomes
