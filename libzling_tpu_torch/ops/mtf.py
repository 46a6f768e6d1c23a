"""Sticky-MTF state: the one chain of the format that crosses blocks.

Counterpart of ``libzling_tpu/ops/mtf.py`` (``initial_state``) and of the
state layouts of ``libzling_tpu/ops/relabel_kernel.py`` (``pack_state``)
and ``libzling_tpu/ops/resolve_kernel.py`` (``initial_mtf_state``).

The port keeps the state as bytes:

  encode (K5): ``state`` u8 [2, 256, 256] -- plane 0 is rank->symbol
      (r2s), plane 1 symbol->rank (s2r), one row per order-1 context;
  decode (K3): ``table`` u8 [256, 256] -- rank->symbol per context.

The conversion functions below turn the JAX package's states (given as
numpy) into these layouts and back, so tests can start both packages from
the same mid-stream state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tables import MTF_INIT, MTF_NEXT

# the resolve/fused kernels keep 256 contexts + 1 dummy row, one i32 a byte
FUSED_WORDS = 257 * 256


def mtf_next(device) -> torch.Tensor:
    """MTF_NEXT as i32 [256]: rank i swaps with rank MTF_NEXT[i]."""
    return torch.as_tensor(MTF_NEXT.astype(np.int32), device=device)


def initial_state(device) -> torch.Tensor:
    """The encoder's stream-start state, u8 [2, 256, 256] (r2s, s2r)."""
    r2s = np.tile(MTF_INIT[None, :], (256, 1))
    s2r = np.zeros((256, 256), np.uint8)
    s2r[np.arange(256)[:, None], r2s] = np.arange(256, dtype=np.uint8)[None]
    return torch.as_tensor(np.stack([r2s, s2r]), device=device)


def initial_table(device) -> torch.Tensor:
    """The decoder's stream-start table, u8 [256, 256] (rank->symbol)."""
    return initial_state(device)[0].contiguous()


def state_from_jax(r2s, s2r, device="cpu") -> torch.Tensor:
    """JAX ``(r2s, s2r)`` i32 [256, 256] each -> port state u8 [2,256,256]."""
    return torch.as_tensor(
        np.stack([np.asarray(r2s), np.asarray(s2r)]).astype(np.uint8),
        device=device)


def state_to_jax(state: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """Port state -> JAX ``(r2s, s2r)`` as i32 numpy arrays."""
    st = state.cpu().numpy().astype(np.int32)
    return st[0], st[1]


def table_from_fused(mtf_words, device="cpu") -> torch.Tensor:
    """JAX resolve/fused state ``[1, 257*256]`` i32 -> u8 [256, 256]."""
    w = np.asarray(mtf_words).reshape(-1)[: 256 * 256]
    return torch.as_tensor(w.astype(np.uint8).reshape(256, 256),
                           device=device)


def table_to_fused(table: torch.Tensor) -> np.ndarray:
    """u8 [256, 256] -> the JAX resolve/fused layout ``[1, 257*256]`` i32."""
    out = np.zeros((1, FUSED_WORDS), np.int32)
    out[0, : 256 * 256] = table.cpu().numpy().reshape(-1)
    return out
