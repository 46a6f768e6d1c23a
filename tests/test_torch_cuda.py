"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: the kernels have no CPU mode, so these tests skip where
there is no GPU (the plain versions are tested against the JAX package in
the other ``test_torch_*`` files).  Run them on a machine with an H100:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(``--noconftest``: the suite's conftest imports JAX, which the port does
not need.)

Tolerance: exact equality -- every output is integers or bytes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as smoke
import libzling_tpu_torch as zt
from libzling_tpu import spec
from libzling_tpu.tables import SENTINEL_LEN
from libzling_tpu_torch import device as tdevice
from libzling_tpu_torch import group_decode as tgd
from libzling_tpu_torch.group_encode import GROUP_BLOCKS
from libzling_tpu_torch.ops import decode_fused as tfk
from libzling_tpu_torch.parallel import decode_mesh, mesh
from libzling_tpu_torch.ops import entropy_kernel as tek
from libzling_tpu_torch.ops import mtf as tmtf
from libzling_tpu_torch.ops import relabel_kernel as trk
from libzling_tpu_torch.ops import resolve_kernel as tresk
from libzling_tpu_torch.ops import tokenize_kernel as ttk
from libzling_tpu_torch.probes import limits as plim
from libzling_tpu_torch.probes import scalar_cost as pscal
from libzling_tpu_torch.probes import tokenize_cost as ptok

pytestmark = pytest.mark.cuda

GEOM = dict(block_size=2048, max_tokens=500)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _data(seed: int = 9) -> bytes:
    rng = np.random.default_rng(seed)
    text = (b"kernels on the card, plain versions on the host. " * 90)
    return text[:3000] + bytes(rng.integers(0, 256, 1200, np.uint8)) \
        + text[3000:]


def _tokenize_args(data: bytes, level: int):
    bs = GEOM["block_size"]
    nb = -(-len(data) // bs)
    buf = torch.zeros(len(data) + SENTINEL_LEN, dtype=torch.uint8)
    buf[:len(data)] = torch.as_tensor(np.frombuffer(data, np.uint8).copy())
    offs = torch.arange(nb, dtype=torch.int64) * bs
    lens = torch.clamp(len(data) - offs, max=bs).to(torch.int32)
    sched = np.full((nb, 12), level)
    sched[:, 1] = 0
    return buf, (offs, lens, offs, ttk.level_params(sched, "cpu"),
                 GEOM["max_tokens"], len(data))


@pytest.mark.parametrize("level", range(7))
def test_tokenize_and_relabel_kernels_equal_plain(cuda, level):
    buf, args = _tokenize_args(_data(), level)
    want = ttk.tokenize_plain(buf, *args)
    got = ttk.tokenize(buf.to(cuda), *args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    state = tmtf.initial_state("cpu")
    for _ in range(2):  # the second walk starts from a non-initial state
        rargs = (want[0], args[0], want[2][:, :, 0].sum(1), state,
                 tmtf.mtf_next("cpu"))
        w = trk.relabel_plain(*rargs)
        g = trk.relabel(*(a.to(cuda) for a in rargs))
        assert torch.equal(g[0].cpu(), w[0]) and torch.equal(g[1].cpu(), w[1])
        state = w[1]


@pytest.mark.parametrize("level", [0, 6])
def test_round_trip_on_card(cuda, level):
    data = _data(level)
    stream = zt.encode(data, level, device=cuda, **GEOM)
    assert stream == spec.encode(data, level, **GEOM)
    args, size, _ = tdevice.decode_args(stream, "cpu")
    want = tfk.fused_decode_plain(*args, out_size=size)
    got = tfk.fused_decode(*(a.to(cuda) for a in args), out_size=size)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert zt.decode(stream, device=cuda) == data


@pytest.mark.parametrize("level", [0, 4])
def test_round_trip_across_groups_on_card(cuda, level):
    # ten 1024-byte blocks, random bytes just before the first group's edge:
    # the next group starts from a carried level drop and MTF state
    rng = np.random.default_rng(11)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon", b"zeta",
             b"theta", b"kappa", b"lambda"]
    text = b" ".join(words[i] for i in rng.integers(0, len(words), 3000))
    cut = GROUP_BLOCKS * 1024 - 384
    noise = bytes(rng.integers(0, 256, 512, dtype=np.uint8))
    data = (text[:cut] + noise + text[cut:])[:10 * 1024]
    stats = spec.EncodeStats()
    want = spec.encode(data, level, stats=stats, block_size=1024,
                       max_tokens=400)
    assert stats.level_drops > 0 and stats.blocks > GROUP_BLOCKS
    # the lanes at GROUP_BLOCKS a group on one card, as the streamed
    # routes run them; the one-shot route makes these ten blocks one group
    stream = mesh.mesh_encode(data, level, [cuda], block_size=1024,
                              max_tokens=400, blocks_per_device=GROUP_BLOCKS)
    assert stream == want
    assert zt.encode(data, level, device=cuda, block_size=1024,
                     max_tokens=400) == want
    assert zt.decode(stream, device=cuda) == data


def test_corrupt_stream_rejected_on_card(cuda):
    payload = spec.huffman_encode_chunk([65, 66, 258, 0])
    stream = (b"\x01" + (6).to_bytes(4, "big") + (4).to_bytes(4, "big")
              + len(payload).to_bytes(4, "big") + payload + b"\x00")
    with pytest.raises(ValueError):
        zt.decode(stream, device=cuda)


def test_decode_kernel_equals_plain_on_bit_flips(cuda):
    # corrupt payloads: the kernel must stay in bounds and agree with the
    # plain version on every status word and output byte
    rng = np.random.default_rng(23)
    data = _data(3)
    stream = zt.encode(data, 2, device="cpu", **GEOM)
    for _ in range(24):
        bad = bytearray(stream)
        k = int(rng.integers(13, len(bad) - 1))
        bad[k] ^= 1 << int(rng.integers(8))
        try:
            staged = tdevice.decode_args(bytes(bad), "cpu")
        except ValueError:            # the framing itself broke
            continue
        if staged is None:
            continue
        args, size, _ = staged
        want = tfk.fused_decode_plain(*args, out_size=size)
        got = tfk.fused_decode(*(a.to(cuda) for a in args), out_size=size)
        torch.cuda.synchronize()
        assert torch.equal(got[1].cpu(), want[1])
        assert torch.equal(got[0].cpu(), want[0])


def _on(args, dev):
    return [a.to(dev) if torch.is_tensor(a) else a for a in args]


def _split_equal(cuda, s, c0, c1, mtf0):
    """K1 then K2 over chunks [c0, c1): kernel == plain on every token,
    status word, byte and MTF entry; returns the plain exit table."""
    k1, k2 = s.stage_split(c0, c1, "cpu")
    want = tek.decode_chunks(*k1)
    got = tek.decode_chunks(*_on(k1, cuda))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    tokens = want[0]
    want = tresk.resolve_stream(tokens, *k2, mtf0)
    got = tresk.resolve_stream(tokens.to(cuda), *_on(k2, cuda), mtf0.to(cuda))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    return want[2]


@pytest.mark.parametrize("level", [0, 4, 6])
def test_split_kernels_equal_plain(cuda, level):
    # K2 in two calls, the second from the first's exit MTF table
    data = _data(level)
    stream = zt.encode(data, level, device=cuda, **GEOM)
    s = tgd.parse(stream)
    B = len(s.block_base) - 1
    assert B >= 2
    table = tmtf.initial_table("cpu")
    for b0, b1 in ((0, B // 2), (B // 2, B)):
        table = _split_equal(cuda, s, *s.chunks_of(b0, b1), table)
    assert not torch.equal(table, tmtf.initial_table("cpu"))
    assert zt.decode(stream, device=cuda, fused=False) == data


def test_split_kernels_equal_plain_on_bit_flips(cuda):
    # corrupt payloads through K1 and K2: in bounds, and equal to the plain
    # versions on every status word and byte
    rng = np.random.default_rng(29)
    stream = zt.encode(_data(5), 2, device="cpu", **GEOM)
    for _ in range(24):
        bad = bytearray(stream)
        k = int(rng.integers(13, len(bad) - 1))
        bad[k] ^= 1 << int(rng.integers(8))
        try:
            s = tgd.parse(bytes(bad))
        except ValueError:            # the framing itself broke
            continue
        if s is not None:
            _split_equal(cuda, s, 0, len(s.rlens), tmtf.initial_table("cpu"))


def test_decode_groups_round_trip_on_card(cuda):
    data = _data(7) * 2
    stream = spec.encode(data, 1, block_size=1024, max_tokens=300)
    assert len(tgd.parse(stream).block_base) > 4
    assert zt.decode_groups(stream, device=cuda, group_blocks=1) == data
    assert zt.decode_groups(stream, device=cuda, group_blocks=3) == data


def test_group_loop_does_not_wait_for_the_card(cuda):
    # staging and launching every group enqueues work without a blocking
    # copy or a synchronisation (the per-device constants are warm)
    data = _data(8) * 2
    stream = spec.encode(data, 1, block_size=1024, max_tokens=300)
    assert zt.decode_groups(stream, device=cuda) == data
    s = tgd.parse(stream)
    mtf0 = tmtf.initial_table(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending, _ = decode_mesh.launch_lanes(
            s, mesh.Lanes(mesh.make_mesh([cuda])), 1, mtf0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(pending) == len(s.block_base) - 1
    assert b"".join(p[2].cpu().numpy().tobytes() for p in pending) == data


@pytest.mark.parametrize("name", sorted(smoke.design_cases()))
def test_design_cases_equal_plain(cuda, name):
    # inputs aimed at K4's warp walker and K3's producer / resolver: K4, K3
    # and K1 + K2 equal their plain versions; the stream equals spec's
    data, levels, geom = smoke.design_cases()[name]
    for level in levels:
        buf, args = smoke.tokenize_args(data, level, geom)
        want = ttk.tokenize_plain(buf, *args)
        got = ttk.tokenize(buf.to(cuda), *args)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        stream = zt.encode(data, level, device=cuda, **geom)
        assert stream == spec.encode(data, level, **geom)
        dargs, size, _ = tdevice.decode_args(stream, "cpu")
        want = tfk.fused_decode_plain(*dargs, out_size=size)
        got = tfk.fused_decode(*_on(dargs, cuda), out_size=size)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        s = tgd.parse(stream)
        _split_equal(cuda, s, 0, len(s.rlens), tmtf.initial_table("cpu"))
        assert zt.decode(stream, device=cuda) == data


def _runahead_cases() -> dict:
    """Inputs aimed at K4's run-ahead warps: name -> (bytes, levels,
    geometry).  Seeded random bytes (shallow chains, rare check-byte hits),
    blocks shorter than the run-ahead window (300 bytes: token starts at
    positions 2-24 alone; the last, 200 bytes, none), and blocks whose
    match limit falls inside a 32-position group, and so inside the window
    at the block's end (1,000 bytes: limit 725)."""
    rng = np.random.default_rng(17)
    return {
        "seeded random bytes": (
            rng.integers(0, 256, 6000, dtype=np.uint8).tobytes(), (0, 4, 6),
            GEOM),
        "blocks shorter than the window": (
            _data(3)[:2000], (0, 4, 6), dict(block_size=300, max_tokens=500)),
        "match limit inside the window": (
            _data(5), (0, 4, 6), dict(block_size=1000, max_tokens=500)),
    }


@pytest.mark.parametrize("name", [
    "one-byte run", "e6 repetitive text", "seeded random bytes",
    "blocks shorter than the window", "match limit inside the window"])
def test_tokenize_mixed_schedule_equal_plain(cuda, name):
    # the warp walker with the level (and so the lazy lanes' work and the
    # run-ahead's window and depth) changing between chunks of a block
    data, levels, geom = {**smoke.design_cases(), **_runahead_cases()}[name]
    for level in levels:
        buf, args = smoke.tokenize_args(data, level, geom, mixed=True)
        want = ttk.tokenize_plain(buf, *args)
        got = ttk.tokenize(buf.to(cuda), *args)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def test_tokenize_lazy_depth_above_max(cuda):
    # host params are refused; params already on the card end the block
    # (err) at the chunk instead of overrunning the candidates' room
    buf, args = _tokenize_args(_data(), 4)
    deep = args[3].clone()
    deep[..., 1] = ttk.MAX_LAZY + 1
    bad = (*args[:3], deep, *args[4:])
    with pytest.raises(ValueError):
        ttk.tokenize(buf.to(cuda), *bad)
    _, _, _, bstat = ttk.tokenize(buf.to(cuda), *_on(bad, cuda))
    assert bstat.tolist() == [[0, 1]] * len(bstat)


@pytest.mark.parametrize("name", [
    "head-byte match symbol", "match without its index", "index 0 mid-chunk",
    "unwritten slot mid-chunk"])
def test_fused_decode_crafted_chunks_equal_plain(cuda, name):
    # K3's producer reads as the fused decoder does, and a corrupt token the
    # producer has decoded past stops the chunk where the plain version does
    args, size, _ = tdevice.decode_args(smoke.crafted_streams()[name], "cpu")
    want = tfk.fused_decode_plain(*args, out_size=size)
    got = tfk.fused_decode(*_on(args, cuda), out_size=size)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])


def _probe_pairs(name, dev, n):
    """(card cases, CPU cases) of a probe module: zero state and seeded
    state."""
    if name == "scalar_cost":
        return [(pscal.cases(n, dev), pscal.cases(n, "cpu")),
                (pscal.cases(n, dev, seed=2), pscal.cases(n, "cpu", seed=2))]
    if name == "tokenize_cost":
        return [(ptok.cases(n, dev), ptok.cases(n, "cpu")),
                (ptok.cases(n, dev, seed=29), ptok.cases(n, "cpu", seed=29))]
    sizes = (16 * 1024, 256 * 1024)
    return [(plim.cases(n, dev, sizes), plim.cases(n, "cpu", sizes))]


@pytest.mark.parametrize("name", ["scalar_cost", "tokenize_cost", "limits"])
def test_probe_kernels_equal_plain(cuda, name):
    # both words (and the rotated / indexed arrays) of every probe kernel
    for card, host in _probe_pairs(name, cuda, 8192):
        for (row, variant, _, kcall), (_, _, _, pcall) in zip(card, host):
            got, want = kcall(), pcall()
            if isinstance(got, tuple):
                assert torch.equal(got[1].cpu(), want[1]), variant
                got, want = got[0], want[0]
            assert (got.word0, got.word1) == (want.word0, want.word1), \
                (row, variant)
            assert got.cycles > 0


def test_probe_shared_memory_ceiling(cuda):
    optin = plim.smem_optin(cuda)
    for nbytes in plim.smem_sizes(optin)[:-1]:
        got = plim.smem_ceiling(nbytes, cuda)
        want = plim.smem_ceiling(nbytes, "cpu")
        assert (got.word0, got.word1) == (want.word0, want.word1)
    with pytest.raises(RuntimeError):
        plim.smem_ceiling(optin + 1, cuda)


RESOLVE_CASES = smoke.resolve_cases()


@pytest.mark.parametrize("name", sorted(RESOLVE_CASES))
def test_resolve_design_cases_equal_plain(cuda, name):
    # K2's output window and token ring: matches W - 1, W and W + 1 bytes
    # back, chunk and block edges, overlapping copies, chunks about the
    # ring's length; then the same with a corrupt chunk (the producer is
    # ahead of the resolver when it stops); each from the initial and from
    # a carried MTF table (the tokens were written for the initial one, so
    # from the carried one the stream may be corrupt anywhere)
    chunks, sizes = RESOLVE_CASES[name]
    for cs in (chunks, smoke.corrupt_chunk(chunks)):
        args = smoke.resolve_args(cs, sizes)
        table = tmtf.initial_table("cpu")
        for k in range(2):
            want = tresk.resolve_stream_plain(*args, table)
            got = tresk.resolve_stream(*_on(args, cuda), table.to(cuda))
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)
            if k == 0:
                assert bool(want[1][:, 2].any()) == (cs is not chunks)
            table = want[2]


@pytest.mark.parametrize("name", sorted(smoke.relabel_cases()))
def test_relabel_tile_cases_equal_plain(cuda, name):
    # K5's tiles: a context across a tile edge, a tile of literals only,
    # one without any, short ranges with gaps; from the initial and from a
    # carried state
    units, offs, cnts = smoke.relabel_cases()[name]
    state = tmtf.initial_state("cpu")
    for _ in range(2):
        rargs = (units, offs, cnts, state, tmtf.mtf_next("cpu"))
        want = trk.relabel_plain(*rargs)
        got = trk.relabel(*(a.to(cuda) for a in rargs))
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        state = want[1]


@pytest.mark.parametrize("name", [
    "match without its index", "index 0 mid-chunk",
    "unwritten slot mid-chunk"])
def test_split_crafted_chunks_equal_plain(cuda, name):
    # K1 + K2 on corrupt chunks thousands of tokens long: K2's producer has
    # staged past the fault when the resolver meets it
    s = tgd.parse(smoke.crafted_streams()[name])
    _split_equal(cuda, s, 0, len(s.rlens), tmtf.initial_table("cpu"))


@pytest.mark.parametrize("name", smoke.K1_CASES)
def test_k1_cases_equal_plain(cuda, name):
    # K1's segments: chunks over many segments, near-fixed-length codes,
    # one-symbol tables, 1-3 tokens, a match symbol last, a chunk cut and
    # flipped in its first, a middle and its last segment and at a segment
    # edge, 300 chunks: tokens and every status row
    args = tek.stage_chunks(*smoke.k1_cases()[name], "cpu")
    want = tek.decode_chunks_plain(*args)
    got = tek.decode_chunks(*_on(args, cuda))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_k1_overlapping_chunks_are_bad(cuda):
    # chunks laid over each other hold more segments than the scratch K1
    # sizes from the words' length: every chunk is bad, nothing is written
    l1, l2, body, n = smoke.k1_chunk(list(range(200)) * 40)
    args = tek.stage_chunks(np.stack([l1] * 3), np.stack([l2] * 3),
                            [body] * 3, [n] * 3, "cpu")
    meta = args[0].clone()
    meta[:, 0, 0] = args[4].numel() - 4      # n_words: every word
    meta[:, 0, 2] = 0                         # word_base: all at word 0
    tokens, status = tek.decode_chunks(meta.to(cuda), *_on(args[1:], cuda))
    torch.cuda.synchronize()
    assert status.cpu().tolist() == [[0, 0, 1]] * 3
    assert not tokens.cpu().any()


# ---- the lanes over several device entries, and the launch device

def _two_gpus():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def _lane_data() -> bytes:
    # three groups of 2 x 2048 bytes, random bytes ending the first: the
    # look-ahead is queued, then re-dispatched from a carried level drop
    rng = np.random.default_rng(31)
    text = _data(31)
    return text[:3600] + bytes(rng.integers(0, 256, 500, np.uint8)) \
        + text[3600:] + text[:4000]


@pytest.mark.parametrize("level,redispatch", [(0, 0), (4, 1)])
def test_lanes_over_one_card_twice(cuda, level, redispatch):
    from libzling_tpu_torch.parallel import mesh_decode, mesh_encode
    from libzling_tpu_torch.utils import metrics

    data = _lane_data()
    devs = [torch.device("cuda", 0)] * 2
    metrics.registry.reset()
    ttk.tokenize.launches = trk.relabel.launches = 0
    stream = mesh_encode(data, level, devs, **GEOM)
    assert stream == spec.encode(data, level, **GEOM)
    # five blocks: three groups, one K4 and one K5 a run at least (e0
    # never drops below its level, e4 does once at the first group's end)
    assert ttk.tokenize.launches >= 5 and trk.relabel.launches >= 5
    assert metrics.registry.snapshot()["counters"].get(
        "enc.pipeline_redispatch", 0) == redispatch
    tek.decode_chunks.launches = tresk.resolve_stream.launches = 0
    assert mesh_decode(stream, devs, group_blocks=1) == data
    # a block a group: K1 on each entry that holds a chunk, K2 once
    s = tgd.parse(stream)
    nch = np.bincount(s.block_id)
    assert tek.decode_chunks.launches == int(np.minimum(nch, 2).sum())
    assert tresk.resolve_stream.launches == len(nch)


def test_kernel_rejects_a_tensor_on_another_device(cuda):
    units = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        trk.relabel(units, torch.zeros(1, dtype=torch.int64),
                    torch.ones(1, dtype=torch.int32),
                    tmtf.initial_state("cpu"), tmtf.mtf_next("cpu"))


def test_kernels_on_the_second_gpu():
    # each kernel on cuda:1 while the current device is 0: the launch must
    # land on the device of its tensors
    _, dev1 = _two_gpus()
    torch.cuda.set_device(0)
    buf, args = _tokenize_args(_data(), 4)
    want = ttk.tokenize_plain(buf, *args)
    got = ttk.tokenize(buf.to(dev1), *args)
    for g, w in zip(got, want):
        assert g.device == dev1 and torch.equal(g.cpu(), w)
    rargs = (want[0], args[0], want[2][:, :, 0].sum(1),
             tmtf.initial_state("cpu"), tmtf.mtf_next("cpu"))
    rwant = trk.relabel_plain(*rargs)
    rgot = trk.relabel(*_on(rargs, dev1))
    for g, w in zip(rgot, rwant):
        assert torch.equal(g.cpu(), w)
    stream = spec.encode(_data(), 2, **GEOM)
    fargs, size, _ = tdevice.decode_args(stream, "cpu")
    fwant = tfk.fused_decode_plain(*fargs, out_size=size)
    fgot = tfk.fused_decode(*_on(fargs, dev1), out_size=size)
    for g, w in zip(fgot, fwant):
        assert torch.equal(g.cpu(), w)
    s = tgd.parse(stream)
    _split_equal(dev1, s, 0, len(s.rlens), tmtf.initial_table("cpu"))
    assert torch.cuda.current_device() == 0


def test_lanes_over_two_gpus():
    from libzling_tpu_torch.parallel import mesh_decode, mesh_encode

    devs = list(_two_gpus())
    data = _lane_data()
    for bpd in (1, 2):
        stream = mesh_encode(data, 4, devs, blocks_per_device=bpd, **GEOM)
        assert stream == spec.encode(data, 4, **GEOM)
        assert mesh_decode(stream, devs, group_blocks=2) == data


@pytest.mark.parametrize("route", ["lanes", "one_shot"])
def test_encode_over_every_visible_card(tmp_path, route):
    # every visible card at the canonical geometry, held to the native
    # engine's canonical stream (the tier-1 tests hold it to spec.encode),
    # which a thread makes meanwhile.  "lanes": mesh_encode at
    # GROUP_BLOCKS a card, two groups, the second's last block short;
    # "one_shot": api.encode on "cuda", the same input in one group, one
    # K4 launch a card
    import json
    import threading

    from libzling_tpu_torch.native import engine
    from libzling_tpu_torch.probes import sweep_tokenize as sw
    from libzling_tpu_torch.tables import BLOCK_SIZE_IN
    from libzling_tpu_torch.utils import metrics

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two CUDA GPUs")
    nblocks = (n + 1) * GROUP_BLOCKS + 2
    base = np.frombuffer(sw.corpus_slice(BLOCK_SIZE_IN), np.uint8)
    data = np.concatenate([np.roll(base, 4099 * k) for k in range(nblocks)])
    data = data[:(nblocks - 1) * BLOCK_SIZE_IN + 12345].tobytes()
    want = {}
    ref = threading.Thread(target=lambda: want.update(
        stream=engine.encode(data, 4)))
    ref.start()
    metrics.registry.reset()
    path = tmp_path / "trace.json"
    with metrics.trace("call", str(path)):
        if route == "lanes":
            got = mesh.mesh_encode(data, 4, mesh.make_mesh(),
                                   blocks_per_device=GROUP_BLOCKS)
        else:
            got = zt.encode(data, 4, device="cuda")
    ref.join(timeout=600)
    assert not ref.is_alive() and got == want["stream"]
    counters = metrics.registry.snapshot()["counters"]
    assert counters.get("enc.pipeline_redispatch", 0) == 0
    assert counters.get("enc.schedule_mispredicts", 0) == 0
    # the first group's chain hands n - 1 times; a second group's from
    # card n - 1 to card 0 and from 0 to 1
    groups, hands = (2, n + 1) if route == "lanes" else (1, n - 1)
    assert counters["enc.groups"] == groups
    assert counters["enc.card_hands"] == hands
    events = json.loads(path.read_text())["traceEvents"]
    assert sum(1 for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == "zling.enc.hand") == hands
    k4 = [e["args"]["device"] for e in events if e.get("cat") == "kernel"
          and "tokenize_kernel" in e.get("name", "")]
    # one K4 launch a card and group; the second group runs on cards 0, 1
    assert sorted(k4) == sorted([*range(n), *([0, 1] * (groups - 1))])


def test_stream_on_card_equals_the_engine(cuda):
    # the canonical geometry, one block a group: a 17 MiB corpus is two
    # groups, with the look-ahead and a group edge
    import io

    from libzling_tpu_torch.native import engine
    from libzling_tpu_torch.utils import io as tio

    data = smoke.corpus(17 << 20)
    sink = io.BytesIO()
    ttk.tokenize.launches = trk.relabel.launches = 0
    tio.stream_encode(tio.FileSource(io.BytesIO(data)), tio.FileSink(sink),
                      0, [cuda], blocks_per_device=1)
    stream = sink.getvalue()
    assert stream == engine.encode(data, 0)
    assert ttk.tokenize.launches >= 2 and trk.relabel.launches >= 2
    back = io.BytesIO()
    tek.decode_chunks.launches = tresk.resolve_stream.launches = 0
    tio.stream_decode(tio.FileSource(io.BytesIO(stream)), tio.FileSink(back),
                      [cuda], group_blocks=1)
    assert back.getvalue() == data
    assert tresk.resolve_stream.launches == 2


@pytest.mark.parametrize("kind", ["encode", "decode"])
def test_resume_on_card_equals_the_one_shot_stream(cuda, tmp_path, kind):
    from libzling_tpu_torch.utils import checkpoint

    data = _lane_data()
    src, dst, back, ck = (tmp_path / n for n in ("in", "out", "back", "ck"))
    src.write_bytes(data)
    want = spec.encode(data, 4, **GEOM)
    runs = {
        "encode": lambda: checkpoint.encode_file_resumable(
            str(src), str(dst), 4, str(ck), [cuda], blocks_per_device=1,
            **GEOM),
        "decode": lambda: checkpoint.decode_file_resumable(
            str(dst), str(back), str(ck), [cuda], group_blocks=1),
    }
    if kind == "decode":
        dst.write_bytes(want)
    orig = checkpoint._write_ckpt

    def stop_once(*a):
        orig(*a)
        checkpoint._write_ckpt = orig
        raise KeyboardInterrupt

    checkpoint._write_ckpt = stop_once
    try:
        with pytest.raises(KeyboardInterrupt):
            runs[kind]()
    finally:
        checkpoint._write_ckpt = orig
    assert ck.exists()
    runs[kind]()
    assert not ck.exists()
    if kind == "encode":
        assert dst.read_bytes() == want
    else:
        assert back.read_bytes() == data


# ---- the lanes' elastic recovery and the fuzz, on the card

@pytest.mark.parametrize("route", ["cpu lane", "native"])
@pytest.mark.parametrize("group,where", [(1, "finish"), (0, "dispatch")])
def test_elastic_recovery_on_card(cuda, route, group, where):
    # one fault in a group of two entries of the card: the stream is
    # spec's, one failover, and K4 ran on the card for the last group
    from libzling_tpu_torch.parallel import mesh_encode
    from libzling_tpu_torch.tables import BLOCK_SIZE_ROLZ
    from libzling_tpu_torch.utils import metrics

    data = _lane_data()
    geom = dict(GEOM, max_tokens=GEOM["max_tokens"] if route == "cpu lane"
                else BLOCK_SIZE_ROLZ)
    devs = [torch.device("cuda", 0)] * 2
    metrics.registry.reset()
    with smoke.PartFaults(data, 2 * geom["block_size"], {group: where},
                          devs[0]) as f:
        got = mesh_encode(data, 4, devs, elastic=True, **geom)
    assert got == spec.encode(data, 4, **geom)
    assert f.fired == 1
    assert metrics.registry.snapshot()["counters"].get(
        "enc.group_failover") == 1
    assert 2 in f.k4 and 2 in f.k5


def test_fuzz_on_card(cuda, tmp_path):
    from libzling_tpu_torch import fuzz

    dump = tmp_path / "fuzz"
    assert fuzz.main(["--device", "cuda", "--rounds", "5", "--max-size",
                      "65536", "--seed", "3", "--dump-dir", str(dump)]) == 0
    assert not dump.exists()
