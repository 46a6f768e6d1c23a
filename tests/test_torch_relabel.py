"""The port's MTF relabel K5 (its plain version, on the CPU) against the JAX
package's Pallas relabel kernel in interpret mode and its NumPy oracle
``encode_relabel_reference``, including the state carried into a second
block through the state-conversion functions.  Then K5's premise: a walk
that takes each context's literals alone, in stream order (K5's threads
walk the 256 contexts side by side), equals the serial walk and the JAX
kernel, on general inputs and on inputs aimed at K5's tiles.

Tolerance: exact equality -- units and MTF states are integers.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import chip_smoke as smoke
from libzling_tpu.ops import mtf as jmtf
from libzling_tpu.ops import relabel_kernel as jrk
from libzling_tpu_torch.ops import mtf as tmtf
from libzling_tpu_torch.ops import relabel_kernel as trk
from libzling_tpu_torch.ops import tokenize_kernel as ttk


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


# ---- K5's premise: the walk is 256 independent chains, one per context

def _relabel_grouped(units, unit_off, unit_cnt, state, mtfnext):
    """The relabel walked context by context: a stable sort of the ranges'
    literal units by context, then each context's literals in stream order
    -- the order K5's threads walk them in."""
    out = units.numpy().copy()
    r2s, s2r = state[0].numpy().copy(), state[1].numpy().copy()
    nxt = mtfnext.numpy()
    idx = np.concatenate([np.zeros(0, np.int64)] + [
        np.arange(o, o + n) for o, n in zip(unit_off.tolist(),
                                            unit_cnt.tolist())])
    lit = idx[(out[idx] >> 10) & 3 == 1]
    order = np.argsort((out[lit] >> 14) & 255, kind="stable")
    lit = lit[order]
    ctx = (out[lit] >> 14) & 255
    starts = np.flatnonzero(np.r_[True, ctx[1:] != ctx[:-1]])
    for k0, k1 in zip(starts, np.r_[starts[1:], len(lit)]):
        r, s = r2s[ctx[k0]], s2r[ctx[k0]]
        for k in lit[k0:k1]:
            sym = out[k] & 255
            i = int(s[sym])
            j = int(nxt[i])
            other = int(r[j])
            r[i], r[j], s[sym], s[other] = other, sym, j, i
            out[k] = (out[k] & ~1023) | i
    return torch.as_tensor(out), torch.as_tensor(np.stack([r2s, s2r]))


def _relabel_jax(units, unit_off, unit_cnt, state):
    """The JAX package's relabel kernel (interpret mode) over the ranges,
    each range one chunk slot of its layout: (the ranges' units, state)."""
    offs, cnts = unit_off.tolist(), unit_cnt.tolist()
    stride = ((max(cnts) + 511) // 512 + 1) * 512
    a = np.zeros((len(cnts), stride), np.int32)
    for c, (o, n) in enumerate(zip(offs, cnts)):
        a[c, :n] = units.numpy()[o:o + n]
    r2s, s2r = tmtf.state_to_jax(state)
    ja, jr2s, js2r = jrk.relabel_block(
        jnp.asarray(a.reshape(1, -1)), jnp.asarray(np.asarray(cnts, np.int32)),
        jnp.asarray(r2s), jnp.asarray(s2r), chunk_stride=stride,
        max_chunks=len(cnts), interpret=True)
    ja = np.asarray(ja).reshape(len(cnts), stride)
    return ([ja[c, :n].tolist() for c, n in enumerate(cnts)],
            tmtf.state_from_jax(jr2s, js2r))


def _ranges(units, unit_off, unit_cnt):
    return [units[o:o + n].tolist()
            for o, n in zip(unit_off.tolist(), unit_cnt.tolist())]


def _premise_cases():
    """name -> (units, unit_off, unit_cnt, state): several blocks with
    gaps between their ranges; a non-initial state carried in; a real
    tokenization of text mixed with random bytes; one context holding every
    literal."""
    rng = np.random.default_rng(17)
    a, stride, _ = _pack_units(rng, 4, 600, np.asarray([600, 0, 257, 511]))
    a = torch.as_tensor(a.reshape(-1))
    offs = torch.arange(4, dtype=torch.int64) * stride
    cnts = torch.tensor([600, 0, 257, 511], dtype=torch.int32)
    init = tmtf.initial_state("cpu")
    carried = trk.relabel_plain(a, offs, cnts, init, tmtf.mtf_next("cpu"))[1]

    buf, args = smoke.tokenize_args(smoke.small_data()[:6000], 0, smoke.SMALL)
    units, _, cstat, _ = ttk.tokenize_plain(buf, *args)
    text = (units, args[0], cstat[:, :, 0].sum(1).to(torch.int32))
    one = a.clone()
    is_lit = (one >> 10) & 3 == 1
    one[is_lit] = (one[is_lit] & ~(255 << 14)) | (93 << 14)
    return {
        "blocks with gaps between": (a, offs, cnts, init),
        "a carried state": (a, offs, cnts, carried),
        "text mixed with random bytes": (*text, carried),
        "one context holds every literal": (one, offs, cnts, init),
    }


@pytest.mark.parametrize("name", sorted(_premise_cases()))
def test_grouped_walk_equals_serial_walk_and_jax(name):
    units, offs, cnts, state = _premise_cases()[name]
    nxt = tmtf.mtf_next("cpu")
    plain = trk.relabel_plain(units, offs, cnts, state, nxt)
    grouped = _relabel_grouped(units, offs, cnts, state, nxt)
    assert torch.equal(grouped[0], plain[0])
    assert torch.equal(grouped[1], plain[1])
    assert not torch.equal(plain[1], state)
    jranges, jstate = _relabel_jax(units, offs, cnts, state)
    assert _ranges(plain[0], offs, cnts) == jranges
    assert torch.equal(plain[1], jstate)
    # units outside the ranges are copied through
    inside = torch.zeros(len(units), dtype=torch.bool)
    for o, n in zip(offs.tolist(), cnts.tolist()):
        inside[o:o + n] = True
    assert torch.equal(plain[0][~inside], units[~inside])


@pytest.mark.parametrize("name", sorted(smoke.relabel_cases()))
def test_relabel_tile_cases_equal_grouped_and_jax(name):
    # inputs aimed at K5's tiles (``TILE`` units): a context across a tile
    # edge, a tile of literals only, one without any, short ranges with
    # gaps; from the initial and from a carried state
    units, offs, cnts = smoke.relabel_cases()[name]
    nxt = tmtf.mtf_next("cpu")
    state = tmtf.initial_state("cpu")
    for _ in range(2):
        plain = trk.relabel_plain(units, offs, cnts, state, nxt)
        grouped = _relabel_grouped(units, offs, cnts, state, nxt)
        assert torch.equal(grouped[0], plain[0])
        assert torch.equal(grouped[1], plain[1])
        jranges, jstate = _relabel_jax(units, offs, cnts, state)
        assert _ranges(plain[0], offs, cnts) == jranges
        assert torch.equal(plain[1], jstate)
        state = plain[1]


def test_tile_matches_the_kernel_source():
    src = (pathlib.Path(trk.__file__).parent.parent / "csrc" / "relabel.cu")
    assert f"constexpr int kTile = {trk.TILE};" in src.read_text()
