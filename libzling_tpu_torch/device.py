"""The port's main path: encode over every visible card, decode on one.

Counterpart of ``libzling_tpu/device.py`` (``encode``, ``decode``).

  encode: ``parallel/mesh.py::mesh_encode`` over the lane's cards
      (``encode_devices``: every visible card for ``"cuda"``, the one card
      named by ``"cuda:N"``, the host for ``"cpu"``; ``group_encode.Part``'s
      stages: K4 tokenize, K5 relabel, torch Huffman stages, host length
      tables and framing), the MTF state handed card to card; on cards
      the input is spread evenly over them in one group where it fits
      (``one_shot_run_blocks``), on the host ``GROUP_BLOCKS`` blocks a
      group -- at the canonical 16 MiB / 262,144-token geometry by
      default;
  decode: on one card (``"cuda"`` is the current one): host parse
      (``container.parse``, ``unpack_length_tables``), then either the
      fused kernel K3 (the default), which writes every block's
      bytes at its offset in one u8 tensor, or (``fused=False``) the split
      pair: K1 decodes every chunk to tokens, one CTA per chunk, and K2
      resolves them (``group_decode.py`` with one group); the per-chunk
      statuses turn into ``ValueError`` on a corrupt stream, and K3's add
      its matches and those it read in its output window to the counters
      ``dec.matches`` and ``dec.window_matches``.  K3 is one serial walk a
      stream, so decode does not spread over cards.

Each call is the span ``zling.encode`` or ``zling.decode``
(``utils/metrics.stage``), its stages' spans nested in it.
"""

from __future__ import annotations

import torch

from .tables import BLOCK_SIZE_IN, BLOCK_SIZE_ROLZ
from . import group_decode
from .group_encode import GROUP_BLOCKS
from .ops import decode_fused as fk
from .parallel.mesh import make_mesh, mesh_encode
from .utils import metrics


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("libzling_tpu_torch: no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"libzling_tpu_torch: unsupported device {dev}")
    return dev


def encode_devices(device) -> list[torch.device]:
    """The lane ``encode`` runs on for ``device``: every visible card for
    a CUDA device without an index (``make_mesh``), else ``device`` alone
    (``"cuda:N"``, ``"cpu"``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return make_mesh()
    return [dev]


# Device memory a block of a run takes at the canonical geometry, at the
# peak of an encode with the look-ahead group resident beside it: K4's and
# K5's buffers and the Huffman stages' int64 temporaries, which grow with
# the units, so incompressible input (a unit a byte) takes the most.  The
# largest measured, on an NVIDIA H100 80GB HBM3: a peak of 20,322,513,920 B
# over 8 blocks a run, for 16 blocks of random bytes at e4 (two groups and
# a level drop); text at e4 / e0, 15 a run: 708 / 739 MB a block.
RUN_BLOCK_BYTES = 2_540_314_240


def run_cap(devices) -> int:
    """The most blocks a card's run may hold on the cards ``devices``: one
    K4 CTA a block on each of the smallest card's SMs, so that no CTA
    waits for another, and a run with the look-ahead beside it
    (``RUN_BLOCK_BYTES`` a block) in half its memory: 16 on an 80 GB
    H100."""
    caps = []
    for d in set(devices):
        p = torch.cuda.get_device_properties(d)
        caps.append(min(p.multi_processor_count,
                        p.total_memory // (2 * RUN_BLOCK_BYTES)))
    return max(1, min(caps))


def one_shot_run_blocks(n_blocks: int, n_cards: int, cap: int) -> int:
    """Blocks a card's run holds when a call encodes ``n_blocks`` blocks
    over ``n_cards`` cards: all of them in one group, spread evenly, up to
    ``cap`` a card; above ``cap`` x ``n_cards`` blocks the call runs in
    groups of ``cap`` a card."""
    return max(1, min(-(-n_blocks // n_cards), cap))


def encode(data: bytes, level: int = 0, device="cuda",
           block_size: int = BLOCK_SIZE_IN,
           max_tokens: int = BLOCK_SIZE_ROLZ) -> bytes:
    """Encode over ``encode_devices(device)``; byte-identical to
    ``spec.encode`` at the same geometry (the canonical stream by default)
    on any number of cards and at any run size.  On cards each run holds
    ``one_shot_run_blocks`` blocks, so that a call of up to ``run_cap``
    blocks a card is one group, one K4 launch a card; on the host
    ``GROUP_BLOCKS``."""
    with metrics.stage("encode"):
        devices = encode_devices(device)
        bpd = GROUP_BLOCKS
        if devices[0].type == "cuda":
            bpd = one_shot_run_blocks(-(-len(data) // block_size),
                                      len(devices), run_cap(devices))
        return mesh_encode(data, level, devices, block_size=block_size,
                           max_tokens=max_tokens, blocks_per_device=bpd)


def decode_args(data: bytes, device):
    """Parse a non-empty stream on the host and stage K3's inputs.

    Returns (the argument tuple of ``fused_decode`` without ``out_size``,
    the decoded size, the per-chunk token counts), or None for a stream
    without chunks.
    """
    s = group_decode.parse(data)
    if s is None:
        return None
    args = fk.prepare_fused(s.len1, s.len2, s.bodies, s.rlens, s.encpos,
                            s.new_block, s.block_base[s.block_id], device)
    return args, int(s.block_base[-1]), s.rlens


def decode(data: bytes, device="cuda", fused: bool = True) -> bytes:
    """Decode a zling stream on ``device`` (``"cuda"``: the current card,
    one card in any case); raises ValueError if corrupt.

    ``fused=False`` runs the split pair K1 -> K2 instead of K3; the two
    differ only on corrupt input, as the JAX package's two layouts do.
    """
    with metrics.stage("decode"):
        dev = resolve_device(device)
        data = bytes(data)
        if not fused:
            return group_decode.decode_groups(data, dev, group_blocks=None)
        staged = decode_args(data, dev) if data else None
        if staged is None:
            return b""
        args, size, rlens = staged
        out, status = fk.fused_decode(*args, out_size=size)
        with metrics.stage("dec.status"):
            st = status.cpu().numpy()
            metrics.registry.count("dec.matches", int(st[:, 4].sum()))
            metrics.registry.count("dec.window_matches", int(st[:, 5].sum()))
            if st[:, 2].any() or (st[:, 1] != rlens).any():
                raise ValueError("zling: corrupt stream")
        with metrics.stage("dec.fetch"):
            return out.cpu().numpy().tobytes()
