"""K5: sticky-MTF relabel of a tokenized stream's literal units, on the card.

Counterpart of ``libzling_tpu/ops/relabel_kernel.py``: the kernel
``_relabel_kernel`` (via ``_relabel_call``), its entry point
``relabel_block``, and ``pack_state``/``unpack_state``.  Literal units
(kind 1) get their sym field replaced by the raw byte's rank in its
context's permutation, and rank i then swaps with rank ``MTF_NEXT[i]``
(``spec.py::MtfEncoder``); every other unit is copied through.

Source note (``csrc/relabel.cu``):
  * replaces ``libzling_tpu/ops/relabel_kernel.py::_relabel_kernel``;
  * bound on this card: the latency of the longest MTF chain.  A literal
    reads and swaps only its own context's row of the state, so the walk
    is 256 independent chains, one per context, each in stream order
    (across blocks too), and the time is that of the busiest context's
    chain of dependent shared-memory loads;
  * design: one CTA of 256 threads, thread c walking context c.  r2s and
    s2r (u8 [256, 256] each, 128 KB) live in dynamic shared memory (above
    the 48 KB default, so the wrapper raises the limit).  The units of the
    ranges come through shared memory in tiles of ``TILE`` units, the next
    staged by a bulk copy (TMA, completed on an mbarrier) while this one is
    worked on; each tile's literals are partitioned stably by context
    (per-warp counts with ``__match_any_sync``, an exclusive scan, ranks in
    lane order), each thread walks its context's list and the tile is
    stored with the ranks, coalesced.  The exit state is written back for
    the next group.
"""

from __future__ import annotations

import torch

from . import mtf as mops

TILE = 4096            # csrc/relabel.cu: kTile units a tile


def relabel(units, unit_off, unit_cnt, state, mtfnext):
    """Relabel ``units[unit_off[b] : unit_off[b]+unit_cnt[b]]``, b in order.

    units i32 [U]; unit_off i64 [B]; unit_cnt i32 [B]; state u8
    [2, 256, 256] (r2s, s2r); mtfnext i32 [256].  Returns (units' i32 [U],
    state' u8 [2, 256, 256]); units outside the ranges are copied.

    CUDA tensors launch the kernel; CPU tensors run the plain version.
    """
    if units.device.type == "cpu":
        return relabel_plain(units, unit_off, unit_cnt, state, mtfnext)
    if units.device.type != "cuda":
        raise ValueError(f"relabel: unsupported device {units.device}")
    from .. import _build

    dev = units.device
    if units.dtype != torch.int32 or not units.is_contiguous():
        raise ValueError("relabel: units must be contiguous i32")
    if state.dtype != torch.uint8 or state.shape != (2, 256, 256):
        raise ValueError("relabel: state must be u8 [2, 256, 256]")
    _build.check_devices("relabel", dev, direct=(state,),
                         copied=(unit_off, unit_cnt, mtfnext))
    with torch.cuda.device(dev):
        unit_off = unit_off.to(dev, torch.int64).contiguous()
        unit_cnt = unit_cnt.to(dev, torch.int32).contiguous()
        state = state.contiguous().clone()        # 16-byte aligned copy
        mtfnext = mtfnext.to(dev, torch.int32).contiguous()
        out = units.clone()
        state_out = torch.empty_like(state)
        err = _build.lib().zlt_relabel(
            units.data_ptr(), unit_off.data_ptr(), unit_cnt.data_ptr(),
            unit_off.shape[0], state.data_ptr(), mtfnext.data_ptr(),
            out.data_ptr(), state_out.data_ptr(), _build.stream_ptr(units))
    _build.check(err, "zlt_relabel")
    relabel.launches += 1
    return out, state_out


relabel.launches = 0


def relabel_plain(units, unit_off, unit_cnt, state, mtfnext):
    """The plain version of K5: the same serial walk in Python."""
    out_t = units.cpu().clone()
    st_t = state.cpu().clone()
    out = out_t.numpy()
    r2s, s2r = st_t[0].numpy(), st_t[1].numpy()
    nxt = mtfnext.cpu().tolist()
    for off, n in zip(unit_off.tolist(), unit_cnt.tolist()):
        for k, w in enumerate(out[off:off + n].tolist()):
            if (w >> 10) & 3 != 1:
                continue
            sym, ctx = w & 255, (w >> 14) & 255
            i = int(s2r[ctx, sym])
            j = nxt[i]
            other = int(r2s[ctx, j])
            r2s[ctx, i] = other
            r2s[ctx, j] = sym
            s2r[ctx, sym] = j
            s2r[ctx, other] = i
            out[off + k] = (w & ~1023) | i
    return out_t, st_t


def pack_state(state: torch.Tensor) -> torch.Tensor:
    """u8 [2, 256, 256] -> the JAX kernel's packed [1, 32768] i32 words
    (four entries per word, little-endian)."""
    return state.contiguous().view(torch.int32).reshape(1, -1)


def unpack_state(words: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_state``."""
    return words.contiguous().reshape(-1).view(torch.uint8) \
        .reshape(2, 256, 256)


def relabel_block(a_flat, nunits, r2s, s2r, *, chunk_stride: int,
                  max_chunks: int):
    """Relabel packed units in the JAX kernel's ``[1, max_chunks *
    chunk_stride]`` layout (counterpart of the JAX ``relabel_block``).

    r2s/s2r: u8 [256, 256] on a_flat's device.  Returns (a_flat', r2s',
    s2r').
    """
    dev = a_flat.device
    off = torch.arange(max_chunks, dtype=torch.int64) * chunk_stride
    out, st = relabel(a_flat.reshape(-1).contiguous(), off,
                      torch.as_tensor(nunits).to(torch.int32)[:max_chunks],
                      torch.stack([r2s, s2r]), mops.mtf_next(dev))
    return out.reshape(1, -1), st[0], st[1]
