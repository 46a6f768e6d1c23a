"""The port's main path: encode over every visible card, decode on one.

Counterpart of ``libzling_tpu/device.py`` (``encode``, ``decode``).

  encode: ``parallel/mesh.py::mesh_encode`` over the lane's cards
      (``encode_devices``: every visible card for ``"cuda"``, the one card
      named by ``"cuda:N"``, the host for ``"cpu"``), ``GROUP_BLOCKS``
      blocks a card and group (``group_encode.Part``'s stages: K4
      tokenize, K5 relabel, torch Huffman stages, host length tables and
      framing), the MTF state handed card to card -- at the canonical 16
      MiB / 262,144-token geometry by default;
  decode: on one card (``"cuda"`` is the current one): host parse
      (``container.parse``, ``unpack_length_tables``), then either the
      fused kernel K3 (the default), which writes every block's
      bytes at its offset in one u8 tensor, or (``fused=False``) the split
      pair: K1 decodes every chunk to tokens, one CTA per chunk, and K2
      resolves them (``group_decode.py`` with one group); the per-chunk
      statuses turn into ``ValueError`` on a corrupt stream.  K3 is one
      serial walk a stream, so decode does not spread over cards.

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


def encode(data: bytes, level: int = 0, device="cuda",
           block_size: int = BLOCK_SIZE_IN,
           max_tokens: int = BLOCK_SIZE_ROLZ) -> bytes:
    """Encode over ``encode_devices(device)``, ``GROUP_BLOCKS`` blocks a
    card and group; byte-identical to ``spec.encode`` at the same geometry
    (the canonical stream by default) on any number of cards."""
    with metrics.stage("encode"):
        return mesh_encode(data, level, encode_devices(device),
                           block_size=block_size, max_tokens=max_tokens,
                           blocks_per_device=GROUP_BLOCKS)


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
            if st[:, 2].any() or (st[:, 1] != rlens).any():
                raise ValueError("zling: corrupt stream")
        with metrics.stage("dec.fetch"):
            return out.cpu().numpy().tobytes()
