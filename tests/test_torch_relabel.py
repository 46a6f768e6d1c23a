"""The port's MTF relabel K5 (its plain version, on the CPU) against the JAX
package's Pallas relabel kernel in interpret mode and its NumPy oracle
``encode_relabel_reference``, including the state carried into a second
block through the state-conversion functions.

Tolerance: exact equality -- units and MTF states are integers.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
import torch

from libzling_tpu.ops import mtf as jmtf
from libzling_tpu.ops import relabel_kernel as jrk
from libzling_tpu_torch.ops import mtf as tmtf
from libzling_tpu_torch.ops import relabel_kernel as trk


def _pack_units(rng, max_chunks, chunk_units, nunits):
    """Random packed unit words in the tokenizer's convention."""
    chunk_stride = ((chunk_units + 511) // 512 + 1) * 512
    a = np.zeros((max_chunks, chunk_stride), np.int32)
    lits = []  # (ctx, raw) in stream order
    for c in range(max_chunks):
        for u in range(nunits[c]):
            kind = rng.choice([0, 1, 1, 1, 2, 3])
            if kind == 1:
                ctx = int(rng.integers(0, 256))
                raw = int(rng.integers(0, 256))
                a[c, u] = raw | (1 << 10) | (ctx << 14)
                lits.append((ctx, raw))
            elif kind == 3:
                a[c, u] = int(rng.integers(258, 514)) | (3 << 10) \
                    | (int(rng.integers(1, 4096)) << 14)
            else:
                a[c, u] = int(rng.integers(0, 256)) | (kind << 10)
    return a.reshape(1, -1), chunk_stride, lits


def _valid(a, nunits, max_chunks, chunk_stride):
    a = np.asarray(a).reshape(max_chunks, chunk_stride)
    return [a[c, :nunits[c]].tolist() for c in range(max_chunks)]


def test_relabel_matches_jax_kernel_and_reference():
    rng = np.random.default_rng(5)
    max_chunks, chunk_units = 3, 700
    nunits = np.asarray([700, 0, 311], np.int32)
    a, stride, lits = _pack_units(rng, max_chunks, chunk_units, nunits)

    r2s, s2r = jmtf.initial_state()
    ja, jr2s, js2r = jrk.relabel_block(
        jnp.asarray(a), jnp.asarray(nunits), r2s, s2r, chunk_stride=stride,
        max_chunks=max_chunks, interpret=True)
    ranks, rr2s, rs2r = jmtf.encode_relabel_reference(
        np.asarray(r2s), np.asarray(s2r), [c for c, _ in lits],
        [b for _, b in lits])

    st = tmtf.initial_state("cpu")
    assert torch.equal(st, tmtf.state_from_jax(r2s, s2r))
    ta, tr2s, ts2r = trk.relabel_block(
        torch.as_tensor(a), nunits, st[0], st[1], chunk_stride=stride,
        max_chunks=max_chunks)
    assert _valid(ta, nunits, max_chunks, stride) == \
        _valid(ja, nunits, max_chunks, stride)
    got = [w & 1023 for ch in _valid(ta, nunits, max_chunks, stride)
           for w in ch if (w >> 10) & 3 == 1]
    assert got == ranks.tolist()
    out_r2s, out_s2r = tmtf.state_to_jax(torch.stack([tr2s, ts2r]))
    for x in (np.asarray(jr2s), rr2s):
        assert np.array_equal(out_r2s, x)
    for x in (np.asarray(js2r), rs2r):
        assert np.array_equal(out_s2r, x)

    # carried state: a second block starts both packages from the JAX
    # exit state, handed over in the relabel kernel's packed layout
    nunits_b = np.asarray([120, 64, 0], np.int32)
    b, _, lits_b = _pack_units(rng, max_chunks, chunk_units, nunits_b)
    packed = np.array(jrk.pack_state(jr2s, js2r))
    st_b = trk.unpack_state(torch.as_tensor(packed))
    jb, jr2s_b, js2r_b = jrk.relabel_block(
        jnp.asarray(b), jnp.asarray(nunits_b), jr2s, js2r,
        chunk_stride=stride, max_chunks=max_chunks, interpret=True)
    tb, tr2s_b, ts2r_b = trk.relabel_block(
        torch.as_tensor(b), nunits_b, st_b[0], st_b[1], chunk_stride=stride,
        max_chunks=max_chunks)
    assert _valid(tb, nunits_b, max_chunks, stride) == \
        _valid(jb, nunits_b, max_chunks, stride)
    ranks_b, _, _ = jmtf.encode_relabel_reference(
        rr2s, rs2r, [c for c, _ in lits_b], [x for _, x in lits_b])
    got_b = [w & 1023 for ch in _valid(tb, nunits_b, max_chunks, stride)
             for w in ch if (w >> 10) & 3 == 1]
    assert got_b == ranks_b.tolist()
    exit_packed = trk.pack_state(torch.stack([tr2s_b, ts2r_b])).numpy()
    assert np.array_equal(exit_packed,
                          np.asarray(jrk.pack_state(jr2s_b, js2r_b)))


def test_state_layouts_match_jax():
    rng = np.random.default_rng(1)
    r2s = rng.integers(0, 256, (256, 256), dtype=np.int32)
    s2r = rng.integers(0, 256, (256, 256), dtype=np.int32)
    st = tmtf.state_from_jax(r2s, s2r)
    packed = trk.pack_state(st)
    assert np.array_equal(packed.numpy(),
                          np.asarray(jrk.pack_state(jnp.asarray(r2s),
                                                    jnp.asarray(s2r))))
    assert torch.equal(trk.unpack_state(packed), st)
    a, b = tmtf.state_to_jax(st)
    assert np.array_equal(a, r2s) and np.array_equal(b, s2r)
    # the decoder's table in the resolve/fused kernels' layout
    from libzling_tpu.ops import resolve_kernel as jres

    mtf0 = jres.initial_mtf_state()
    table = tmtf.table_from_fused(mtf0)
    assert torch.equal(table, tmtf.initial_table("cpu"))
    assert np.array_equal(tmtf.table_to_fused(table), mtf0)
