"""Event-driven time: per-edge delay lines and jitter, in PyTorch.

The port's copy of ``go_libp2p_pubsub_tpu/models/delays.py`` (its
materialized form, the one the GossipSub step runs).  Without delays one
tick is one heartbeat and one network hop; with them every transfer takes
an integer number of ticks:

- ``DelayConfig`` (host side): a per-hop **base** delay in ticks, an
  integer **jitter** bound (the extra delay of each directed edge-tick is
  drawn uniformly from ``[0, jitter]`` by the lane hash at its own
  ``seed``) and the **k_slots** depth of the circular delay line;
  ``base + jitter <= k_slots`` is checked when it is made, naming the
  field.
- ``compile_delays`` makes ``DelayParams``: ``base``, ``jitter`` and
  ``seed`` as 0-d int32 tensors (the knobs ``delay_base`` /
  ``delay_jitter`` replace the first two on built params, no step is
  rebuilt), ``k_slots`` a plain int (it sizes the delay-line state).
- The GossipSub state carries K-slot circular lines: payload words enqueue
  at slot ``(t + d - 1) mod K`` of the receiving edge's row, the tick's
  arrivals dequeue from slot ``t mod K`` (cleared after the read); control
  transfers ride packed [N] rows the same way (GRAFT, PRUNE, retraction,
  broken-promise advert), so the GRAFT/PRUNE handshake takes as many ticks
  as its hops and a rejection travels back as a delayed retraction.

``d = 1`` is the one-hop timing: content sent at tick ``t`` is part of the
receiver's acquisition at ``t``, so ``DelayConfig(1, 0, 1)`` steps
bit-identically to the step without delays.

A replica stack (``models/_batch.py``) stacks ``base``, ``jitter`` and
``seed`` to ``[B]`` tensors (``k_slots`` stays one host int: stacks that
differ in it raise a ``ValueError`` naming ``delays.k_slots``); the draws
are then ``[B, C, N]``, each replica's at its own seed and knobs, and a
line ``[B, K, ...]`` has its slot axis second (``enqueue_dequeue``'s
``axis``).

Nothing here reads a tensor on the host: ``base``, ``jitter`` and the seed
stay on the device, and the tick is the step's host int.  The source-history
rings of floodsub and randomsub (``arrive_now``'s replayed draws) are not
ported yet (those routers are not).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import graph

__all__ = [
    "DELAY_PHASE",
    "DelayConfig",
    "DelayParams",
    "compile_delays",
    "edge_delays",
    "arrive_now",
    "slot_select_words",
    "pack_edges",
    "slot_words",
    "line_dequeue",
    "enqueue_dequeue",
]

#: lane_uniform phase of the per-edge-tick delay draws (the reference's),
#: apart from the simulator's phases and the fault stream's, salted by the
#: config's own seed
DELAY_PHASE = 11


@dataclass(frozen=True)
class DelayConfig:
    """Validated per-edge delay spec (host side).

    base: minimum ticks per hop, >= 1 (1 = the one-hop timing); the
        ``delay_base`` knob.
    jitter: most extra ticks per directed edge-tick, drawn uniformly from
        [0, jitter] each tick; the ``delay_jitter`` knob.
    k_slots: depth of the circular delay line; holds the longest delay
        (base + jitter <= k_slots).  Sizes the state: not a knob.
    seed: the delay stream's own lane-hash salt, apart from the
        simulator's seed.
    """

    base: int = 1
    jitter: int = 0
    k_slots: int = 1
    seed: int = 0

    def __post_init__(self):
        if int(self.base) < 1:
            raise ValueError(
                f"DelayConfig: base={self.base} must be >= 1 (1 = the "
                "one-tick-one-hop contract)")
        if int(self.jitter) < 0:
            raise ValueError(
                f"DelayConfig: jitter={self.jitter} must be >= 0")
        if int(self.k_slots) < 1:
            raise ValueError(
                f"DelayConfig: k_slots={self.k_slots} must be >= 1")
        if int(self.base) + int(self.jitter) > int(self.k_slots):
            raise ValueError(
                f"DelayConfig: k_slots={self.k_slots} cannot hold the "
                f"worst-case delay base+jitter="
                f"{int(self.base) + int(self.jitter)} — the K-slot "
                "circular line wraps; raise k_slots")

    def validate_point(self, base=None, jitter=None) -> None:
        """The same checks on a knob point (host ints), naming the bad
        field; k_slots stays the built value."""
        b = int(self.base if base is None else base)
        j = int(self.jitter if jitter is None else jitter)
        if b < 1:
            raise ValueError(
                f"delay_base={b} must be >= 1 (delay knobs)")
        if j < 0:
            raise ValueError(
                f"delay_jitter={j} must be >= 0 (delay knobs)")
        if b + j > int(self.k_slots):
            raise ValueError(
                f"delay knobs: base+jitter={b + j} exceeds the "
                f"compiled k_slots={self.k_slots} — the delay-line "
                "depth is shape-bearing; rebuild with a deeper "
                "DelayConfig to sweep this point")


@dataclass(frozen=True)
class DelayParams:
    """The compiled form: ``base``, ``jitter`` and ``seed`` (the u32 salt
    held as int32) are 0-d int32 tensors on the sim's device (a replica
    stack's ``[B]``); ``k_slots`` is a host int."""

    base: torch.Tensor      # int32 [] ([B])
    jitter: torch.Tensor    # int32 [] ([B])
    seed: torch.Tensor      # int32 [] ([B]) (u32 bits)
    k_slots: int = 1


def compile_delays(dcfg: DelayConfig, device) -> DelayParams:
    def i32(v):
        return torch.tensor(graph.i32(int(v)), dtype=torch.int32,
                            device=device)

    return DelayParams(base=i32(dcfg.base), jitter=i32(dcfg.jitter),
                       seed=i32(dcfg.seed), k_slots=int(dcfg.k_slots))


def _per_replica(v: torch.Tensor, nd: int) -> torch.Tensor:
    """A delay leaf against an ``nd``-axis draw: a 0-d tensor as it is, a
    replica stack's [B] with ``nd`` unit axes after it."""
    return v.view(-1, *([1] * nd)) if v.dim() == 1 else v


def _lane_seed(tick: int, seed: torch.Tensor) -> torch.Tensor:
    """``lane_seed(tick, DELAY_PHASE, seed)`` with the salt a device
    tensor: an int32 tensor of the mixed u32 seed (0-d, or a stack's
    [B])."""
    salt = seed.to(torch.int64) & graph.MASK32
    x = (((tick * 0x9E3779B9) & graph.MASK32)
         ^ ((salt + DELAY_PHASE * 0x85EBCA6B) & graph.MASK32))
    return graph.fmix32(graph.to_i32(x))


def _uniform(shape: tuple[int, int], seed: torch.Tensor,
             stride: int | None) -> torch.Tensor:
    """``graph.lane_uniform_from_seed`` with a device seed, its lanes
    ``r * stride + c`` in int32 where no lane passes 2^31 (the u32 lanes'
    bits, without the int64 passes), else as it draws them; a stack's [B]
    seeds give [B, rows, cols], each replica drawn at its own."""
    rows, cols = shape
    stride = cols if stride is None else stride
    if (rows - 1) * stride + cols > graph.MASK32 >> 1:
        return graph.lane_uniform_from_seed(shape, seed, stride, seed.device)
    dev = seed.device
    lane = (torch.arange(rows, dtype=torch.int32, device=dev)[:, None] * stride
            + torch.arange(cols, dtype=torch.int32, device=dev))
    h = graph.fmix32(lane ^ _per_replica(seed, 2))
    return graph.shr(h, 8).to(torch.float32) * (1.0 / (1 << 24))


def edge_delays(dp: DelayParams, shape: tuple[int, int], tick: int,
                stride: int | None = None) -> torch.Tensor:
    """int32 ``shape``: the delay in ticks (in [1, k_slots]) of each
    directed edge-lane for transfers sent at ``tick``.  Row = the
    receiver's candidate bit for the sender, drawn at the receiver's lane
    (``stride``: the lane stream's row stride).  Stateless: a past tick's
    draws can be made again.  A replica stack's params give ``[B,
    *shape]``, each replica at its own seed, base and jitter."""
    u = _uniform(shape, _lane_seed(tick, dp.seed), stride)
    jitter = _per_replica(dp.jitter, 2)
    extra = torch.minimum(
        (u * (jitter + 1).to(torch.float32)).to(torch.int32), jitter)
    return (_per_replica(dp.base, 2) + extra).clamp(1, dp.k_slots)


def arrive_now(dp: DelayParams, shape, send_tick: int, lag: int,
               stride: int | None = None) -> torch.Tensor:
    """bool ``shape``: the transfers sent at ``send_tick`` over each
    directed edge arrive exactly ``lag`` ticks later (delay == lag + 1)."""
    return edge_delays(dp, shape, send_tick, stride=stride) == (lag + 1)


def slot_select_words(d_edge: torch.Tensor, tick: int,
                      k_slots: int) -> list:
    """The packed slot-selection words of the line: K int32 [N] words,
    bit j of ``out[s]`` set iff the edge-j transfer sent this tick lands
    in slot ``s`` = ``(tick + d - 1) mod K``.  They partition the edge
    bits across the slots."""
    return list(slot_words((tick + d_edge - 1) % k_slots, k_slots))


def pack_edges(bools: torch.Tensor) -> torch.Tensor:
    """bool [..., C, N] -> int32 [..., N] words, row c -> bit c
    (``graph.pack_rows``' bits, summed in int32: the bits are disjoint, so
    no sum carries)."""
    c = bools.shape[-2]
    bit = torch.ones((c, 1), dtype=torch.int32, device=bools.device) << (
        torch.arange(c, dtype=torch.int32, device=bools.device)[:, None])
    return torch.where(bools, bit, 0).sum(-2, dtype=torch.int32)


def line_dequeue(line: torch.Tensor, tick: int):
    """(arrivals, cleared line): slot ``tick mod K`` of a [K, ...] line,
    and a copy of the line with that slot zeroed (the input unchanged)."""
    cur = tick % line.shape[0]
    cleared = line.clone()
    cleared[cur] = 0
    return line[cur].clone(), cleared


def slot_words(slot: torch.Tensor, k_slots: int) -> torch.Tensor:
    """int32 [..., K, N]: ``slot_select_words`` from the edges' slots
    (int32 [..., C, N]) in one scatter: the bits are disjoint, so their sum
    is their union."""
    *lead, c, n = slot.shape
    bit = torch.ones((c, 1), dtype=torch.int32, device=slot.device) << (
        torch.arange(c, dtype=torch.int32, device=slot.device)[:, None])
    return torch.zeros((*lead, k_slots, n), dtype=torch.int32,
                       device=slot.device).scatter_add_(
        -2, slot.to(torch.int64), bit.expand(slot.shape))


def enqueue_dequeue(line: torch.Tensor, fill, tick: int, axis: int = 0):
    """One tick of a line whose slot axis is ``axis`` ([K, ...]; a replica
    stack's [B, K, ...] at axis 1): ``fill(out)`` writes this tick's
    words for every slot into ``out`` (shaped as the line: the rolled words
    at the receivers, each selected for the slot it lands in), they are
    enqueued, then slot ``tick mod K`` is dequeued: ``(arrivals, next
    line)``, equal to ``line_dequeue(line | words, tick)`` on one sim's
    line.  The next line is written in place of the words (the input line
    is read, never written), so the step allocates no [K, ...] temporary
    beside it."""
    cur = tick % line.shape[axis]
    out = torch.empty_like(line)
    fill(out)
    out |= line
    arr = out.select(axis, cur).clone()
    out.select(axis, cur).zero_()
    return arr, out
