"""Fault schedules for the GossipSub simulator: churn, link loss,
partitions and cold restart, in PyTorch.

Counterpart of the gossipsub part of ``go_libp2p_pubsub_tpu/models/
faults.py`` (its own copy: the port imports nothing of the JAX package).

- ``FaultSchedule`` is the host-side spec, validated at construction: a
  bad schedule raises ``ValueError`` naming the field.
- ``compile_faults`` lowers it against the circulant offsets into
  ``FaultParams``, which rides the sim's params.  The per-tick masks are
  computed from it on the device (``tick_masks``) with no host sync: the
  tick is a host int, so whether a partition window is active is a host
  comparison.

Fault model (one tick = one heartbeat): a peer inside one of its
half-open down intervals ``[start, end)`` neither sends nor receives
anything and loses its own due publishes; each undirected candidate edge
is down for a whole tick with probability ``drop_prob`` (a scalar, or a
``[C, N]`` per-edge rate: symmetric, one coin per edge drawn at its
positive-offset bit and mirrored to the partner's bit; asymmetric, one
coin per direction, ``directed_drops``); while a partition window is
active every edge between two groups is cut.  With ``cold_restart`` a
peer coming back up clears its possession words and mcache ring at the
rejoin tick.  The floodsub and randomsub forms (gather tables, dense
all-pairs) come with those routers.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.graph import lane_uniform, pack_rows

#: lane_uniform phase of the per-tick link draws, disjoint from the
#: simulator's phases (1-7, 12, 13, 15)
LINK_PHASE = 9


@dataclass(frozen=True)
class FaultSchedule:
    """Validated fault spec for one simulation of ``n_peers`` peers over
    ticks ``[0, horizon)``.

    down_intervals: ``(peer, start, end)`` half-open down windows,
        sorted and non-overlapping per peer; ``start == end`` is a no-op
        interval (never down).
    drop_prob: a float (undirected), or a ``[C, n_peers]`` per-edge
        array: symmetric (both views of each edge agree) keeps the shared
        coin; asymmetric draws one coin per direction.
    partition_group: int ``[n_peers]`` group assignment, required with
        partition_windows: edges between groups are cut during each
        window.
    partition_windows: ``(start, end)`` half-open windows, sorted and
        non-overlapping.
    seed: the fault stream's own lane-hash salt.
    cold_restart: a rejoining peer comes back cold (possession and
        mcache cleared at the rejoin tick).
    """

    n_peers: int
    horizon: int
    down_intervals: tuple = ()
    drop_prob: object = 0.0
    partition_group: object = None
    partition_windows: tuple = ()
    seed: int = 0
    cold_restart: bool = False

    def __post_init__(self):
        if self.n_peers < 1:
            raise ValueError("n_peers must be >= 1")
        if self.horizon < 1:
            raise ValueError("horizon must be >= 1 (ticks [0, horizon))")
        ivs = tuple((int(p), int(s), int(e))
                    for p, s, e in self.down_intervals)
        object.__setattr__(self, "down_intervals", ivs)
        per_peer: dict[int, list[tuple[int, int]]] = {}
        for p, s, e in ivs:
            if not (0 <= p < self.n_peers):
                raise ValueError(
                    f"down_intervals: peer {p} out of range "
                    f"[0, {self.n_peers})")
            if not (0 <= s <= e <= self.horizon):
                raise ValueError(
                    f"down_intervals: interval [{s}, {e}) for peer {p} "
                    f"must satisfy 0 <= start <= end <= horizon="
                    f"{self.horizon}")
            if s < e:
                per_peer.setdefault(p, []).append((s, e))
        for p, lst in per_peer.items():
            for (s0, e0), (s1, e1) in zip(lst, lst[1:]):
                if s1 < e0:
                    raise ValueError(
                        f"down_intervals: peer {p} intervals "
                        f"[{s0}, {e0}) and [{s1}, {e1}) overlap or are "
                        "non-monotone (sort them, merge overlaps)")
        dp = self.drop_prob
        if np.isscalar(dp) or getattr(dp, "ndim", None) == 0:
            if not (0.0 <= float(dp) <= 1.0):
                raise ValueError(
                    f"drop_prob: {float(dp)} outside [0, 1]")
        else:
            arr = np.asarray(dp, dtype=np.float32)
            if arr.ndim != 2 or arr.shape[1] != self.n_peers:
                raise ValueError(
                    "drop_prob: per-edge form must be [C, n_peers] "
                    f"(got shape {arr.shape})")
            if ((arr < 0.0) | (arr > 1.0)).any():
                raise ValueError(
                    "drop_prob: per-edge values outside [0, 1]")
            object.__setattr__(self, "drop_prob", arr)
        wins = tuple((int(s), int(e)) for s, e in self.partition_windows)
        object.__setattr__(self, "partition_windows", wins)
        for s, e in wins:
            if not (0 <= s < e <= self.horizon):
                raise ValueError(
                    f"partition_windows: window [{s}, {e}) must satisfy "
                    f"0 <= start < end <= horizon={self.horizon}")
        for (s0, e0), (s1, e1) in zip(wins, wins[1:]):
            if s1 < e0:
                raise ValueError(
                    f"partition_windows: windows [{s0}, {e0}) and "
                    f"[{s1}, {e1}) overlap or are non-monotone")
        if wins and self.partition_group is None:
            raise ValueError(
                "partition_group: required when partition_windows are "
                "given (who is on which side?)")
        if self.partition_group is not None:
            grp = np.asarray(self.partition_group)
            if grp.shape != (self.n_peers,):
                raise ValueError(
                    f"partition_group: must be int [n_peers="
                    f"{self.n_peers}] (got shape {grp.shape})")
            if not np.issubdtype(grp.dtype, np.integer) or (grp < 0).any():
                raise ValueError(
                    "partition_group: must be non-negative integers")
            object.__setattr__(self, "partition_group",
                               grp.astype(np.int32))

    @property
    def max_down_intervals(self) -> int:
        """K: the width of the per-peer interval table."""
        if not self.down_intervals:
            return 0
        counts = np.bincount(
            np.asarray([p for p, _, _ in self.down_intervals]),
            minlength=self.n_peers)
        return int(counts.max())


@dataclass
class FaultParams:
    """A schedule compiled against one offset set.  ``None`` fields mean
    that fault class is off."""

    down_start: torch.Tensor                  # int32 [N, K] (K may be 0)
    down_end: torch.Tensor                    # int32 [N, K]
    seed: int                                 # u32 fault-stream salt
    drop_prob: torch.Tensor | None = None     # f32 [] or [C, N]
    cross_bits: torch.Tensor | None = None    # int32 [N]: bit c = edge c
    #                                           crosses the partition
    part_start: tuple[int, ...] | None = None  # partition windows (host)
    part_end: tuple[int, ...] | None = None
    cold_restart: bool = False
    directed_drops: bool = False              # one coin per direction


def compile_faults(schedule: FaultSchedule, offsets, *,
                   device) -> FaultParams:
    """Lower ``schedule`` against the circulant ``offsets`` (closed under
    negation, no 0) into tensors on ``device``; partition-crossing edges
    are packed into one word per peer."""
    offs = tuple(int(o) for o in offsets)
    C = len(offs)
    n = schedule.n_peers
    idx = {o: i for i, o in enumerate(offs)}
    if any(-o not in idx for o in offs):
        raise ValueError("offsets must be closed under negation "
                         "(fault link masks pair each edge's two views)")
    cinv = tuple(idx[-o] for o in offs)
    if 0 in idx:
        raise ValueError("offsets must not contain 0 (self-edges have "
                         "no link to drop)")
    if C > 32:
        raise ValueError("packed link words need C <= 32")
    down_start, down_end = _down_tables(schedule)

    def t_(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    kw = {}
    dp = schedule.drop_prob
    if isinstance(dp, np.ndarray):
        if dp.shape[0] != C:
            raise ValueError(
                f"drop_prob: per-edge form is [C={dp.shape[0]}, N] but "
                f"the offset set has C={C} candidates")
        # p's bit c and (p + o_c)'s bit cinv[c] are one edge: symmetric
        # when the two views agree everywhere
        symmetric = all(np.allclose(dp[c], np.roll(dp[cinv[c]], -o))
                        for c, o in enumerate(offs))
        kw["drop_prob"] = t_(dp)
        kw["directed_drops"] = not symmetric
    elif float(dp) > 0.0:
        kw["drop_prob"] = torch.tensor(float(dp), dtype=torch.float32,
                                       device=device)
    if schedule.partition_windows:
        grp = schedule.partition_group
        bits = np.zeros(n, dtype=np.uint32)
        for c, o in enumerate(offs):
            bits |= (grp != np.roll(grp, -o)).astype(np.uint32) << c
        kw["cross_bits"] = t_(bits.view(np.int32))
        kw["part_start"] = tuple(s for s, _ in schedule.partition_windows)
        kw["part_end"] = tuple(e for _, e in schedule.partition_windows)
    return FaultParams(down_start=t_(down_start), down_end=t_(down_end),
                       seed=int(schedule.seed) & 0xFFFFFFFF,
                       cold_restart=bool(schedule.cold_restart), **kw)


def _down_tables(schedule: FaultSchedule):
    k = schedule.max_down_intervals
    n = schedule.n_peers
    down_start = np.zeros((n, k), dtype=np.int32)
    down_end = np.zeros((n, k), dtype=np.int32)
    fill = np.zeros(n, dtype=np.int64)
    for p, s, e in schedule.down_intervals:
        down_start[p, fill[p]] = s
        down_end[p, fill[p]] = e
        fill[p] += 1
    return down_start, down_end


# -- per-tick masks (device tensors from the host tick) ---------------------

def alive_mask(fp: FaultParams, tick: int) -> torch.Tensor:
    """bool [N]: peer up at ``tick`` (no down interval covers it)."""
    if fp.down_start.shape[1] == 0:
        return torch.ones(fp.down_start.shape[0], dtype=torch.bool,
                          device=fp.down_start.device)
    return ~((tick >= fp.down_start) & (tick < fp.down_end)).any(1)


def rejoined_mask(fp: FaultParams, tick: int) -> torch.Tensor:
    """bool [N]: peer came back up exactly at ``tick`` (down at tick - 1);
    at tick 0 nothing rejoins (intervals start at 0 or later)."""
    return alive_mask(fp, tick) & ~alive_mask(fp, tick - 1)


def alive_word(alive: torch.Tensor) -> torch.Tensor:
    """bool [N] -> int32 [N] all-ones / all-zeros word mask."""
    return torch.where(alive, -1, 0).to(torch.int32)


def cand_alive_bits(alive: torch.Tensor, offsets) -> torch.Tensor:
    """int32 [N]: bit c set iff candidate p + offsets[c] is alive."""
    out = torch.zeros(alive.shape, dtype=torch.int32, device=alive.device)
    for c, off in enumerate(offsets):
        out = out | (torch.roll(alive, -int(off)).to(torch.int32) << c)
    return out


def _partition_active(fp: FaultParams, tick: int) -> bool:
    return any(s <= tick < e for s, e in zip(fp.part_start, fp.part_end))


def _link_drop_draw(fp: FaultParams, C: int, n: int, tick: int,
                    stride: int) -> torch.Tensor:
    """bool [C, N]: this tick's directed drop coins (fault-seeded lane
    hash, phase ``LINK_PHASE``)."""
    u = lane_uniform((C, n), tick, LINK_PHASE, fp.seed, stride=stride,
                     device=fp.down_start.device)
    return u < fp.drop_prob


def link_ok_bits(fp: FaultParams, offsets, cinv, tick: int,
                 n_stream: int | None = None) -> torch.Tensor | None:
    """int32 [N]: bit c set iff edge (p, p + offsets[c]) is up this tick;
    None without link faults (churn only).  Symmetric drops are drawn at
    the positive-offset bits and mirrored to the partner's bit cinv[c];
    directed drops draw every bit."""
    if fp.drop_prob is None and fp.cross_bits is None:
        return None
    C = len(offsets)
    n = fp.down_start.shape[0]
    drop = torch.zeros((n,), dtype=torch.int32, device=fp.down_start.device)
    if fp.drop_prob is not None:
        draw_f = _link_drop_draw(fp, C, n, tick,
                                 n if n_stream is None else n_stream)
        if fp.directed_drops:
            drop = pack_rows(draw_f)
        else:
            pos = sum(1 << c for c, o in enumerate(offsets) if int(o) > 0)
            draw = pack_rows(draw_f) & pos
            mirror = torch.zeros_like(draw)
            for c, off in enumerate(offsets):
                if int(off) <= 0:
                    continue
                bit = (draw >> c) & 1
                mirror = mirror | (torch.roll(bit, int(off)) << cinv[c])
            drop = draw | mirror
    if fp.cross_bits is not None and _partition_active(fp, tick):
        drop = drop | fp.cross_bits
    return ~drop & ((1 << C) - 1)


@dataclass
class TickMasks:
    """One tick's fault masks, int32 [N] words: ``alive_w`` all-ones at a
    live peer (gates its possession words), ``alive_all`` its C-bit form,
    ``send_ok`` the edges a peer may send on (alive and link up),
    ``cand_alive`` the live candidates, ``flood_ok`` = send_ok ∧
    cand_alive (the IWANT flood's gate)."""

    alive_w: torch.Tensor
    alive_all: torch.Tensor
    send_ok: torch.Tensor
    cand_alive: torch.Tensor
    flood_ok: torch.Tensor


def tick_masks(fp: FaultParams, offsets, cinv, tick: int) -> TickMasks:
    """The masks of ``tick`` (the reference step's fault prologue)."""
    C = len(offsets)
    alive = alive_mask(fp, tick)
    link = link_ok_bits(fp, offsets, cinv, tick)
    cand_alive = cand_alive_bits(alive, offsets)
    alive_all = torch.where(alive, (1 << C) - 1, 0).to(torch.int32)
    send_ok = alive_all if link is None else alive_all & link
    return TickMasks(alive_w=alive_word(alive),
                     alive_all=alive_all, send_ok=send_ok,
                     cand_alive=cand_alive, flood_ok=send_ok & cand_alive)
