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


# -- degradation and recovery under faults -----------------------------------

def delivery_fraction_curve(counts: torch.Tensor,
                            want) -> torch.Tensor:
    """f32 [T, M] cumulative delivered fraction per tick from a run's
    per-tick counts [T, M] (``gossip_run_curve``); ``want`` is each
    message's full-delivery peer count ([M] or a scalar).  Under churn the
    curve plateaus below 1.0, and how far below is the degradation."""
    cum = torch.cumsum(counts.to(torch.float32), dim=0)
    want = torch.as_tensor(want, dtype=torch.float32, device=counts.device)
    return cum / torch.clamp(want, min=1.0)


def recovery_ticks(counts: torch.Tensor, heal_tick: int, want,
                   frac: float = 0.99) -> torch.Tensor:
    """int32 [M]: ticks from ``heal_tick`` (a partition window's end, as a
    row index of ``counts``) until each message's cumulative delivery
    reaches ``frac`` of ``want``; -1 if never within the run, 0 for a
    message already above the threshold at heal."""
    t = counts.shape[0]
    reach = delivery_fraction_curve(counts, want) >= frac       # [T, M]
    rows = torch.arange(t, device=counts.device)[:, None]
    after = reach & (rows >= heal_tick)
    ever = after.any(0)
    first = torch.argmax(after.to(torch.int32), dim=0)
    return torch.where(ever, first - heal_tick, -1).to(torch.int32)
