"""First-delivery bookkeeping (counterpart of the reference's
``models/_delivery.py``).

first_tick records are int16 [W, 32, N]: bit j of word w = message
w*32+j; -1 = never delivered; ticks saturate at 32766.
"""

from __future__ import annotations

import torch

from ..ops.graph import WORD_BITS


def update_first_tick(first_tick: torch.Tensor | None,
                      delivered_now: torch.Tensor,
                      tick: int) -> torch.Tensor | None:
    """Record ``tick`` for bits of delivered_now ([W, N] words) that are
    newly delivered.  No-op when tracking is off (None)."""
    if first_tick is None:
        return None
    shifts = torch.arange(WORD_BITS, dtype=torch.int32,
                          device=delivered_now.device)
    bits = ((delivered_now[:, None, :] >> shifts[None, :, None]) & 1) != 0
    newly = bits & (first_tick < 0)
    tick16 = first_tick.new_full((), min(tick, 32766))
    return torch.where(newly, tick16, first_tick)


def first_tick_to_matrix(first_tick: torch.Tensor, m: int) -> torch.Tensor:
    """first_tick [W, 32, N] as [N, M] (strips word padding)."""
    w, b, n = first_tick.shape
    return first_tick.reshape(w * b, n)[:m].T


def reach_counts_from_first_tick(first_tick: torch.Tensor,
                                 m: int) -> torch.Tensor:
    """Per-message delivered-peer counts: int32 [M]."""
    w, b, _ = first_tick.shape
    counts = (first_tick >= 0).sum(2, dtype=torch.int32)
    return counts.reshape(w * b)[:m]
