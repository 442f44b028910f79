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
rejoin tick.

The mesh-less simulators (``models/floodsub.py``, ``models/randomsub.py``)
take three more forms: the unpacked circulant form (``compile_faults(...,
pack_links=False)``, partition crossings as bool ``[C, N]`` rows, any C,
masks from ``link_ok_rows``), the gather-table form
(``compile_faults_gather``, crossings as bool ``[N, K]`` slots,
``link_ok_gather``) and the dense all-pairs form (``compile_faults_dense``,
the raw group assignment, ``link_ok_dense``).  The last two take a scalar
drop rate only, one coin per undirected pair keyed on its canonical
``(min, max)`` lane (``_pair_uniform``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.graph import (MASK32, fmix32, i32, lane_seed, lane_uniform,
                         pack_rows, popcount32, shr, to_i32)

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
    # the mesh-less simulators' forms of the partition crossings (at most
    # one of cross_bits / cross_rows / cross_nk / group is set)
    cross_rows: torch.Tensor | None = None    # bool [C, N] (any C)
    cross_nk: torch.Tensor | None = None      # bool [N, K] gather slots
    group: torch.Tensor | None = None         # int32 [N] (dense all-pairs)


def compile_faults(schedule: FaultSchedule, offsets, *, device,
                   pack_links: bool | None = None) -> FaultParams:
    """Lower ``schedule`` against the circulant ``offsets`` (closed under
    negation, no 0) into tensors on ``device``.  ``pack_links=True``
    packs the partition-crossing edges into one word per peer (C <= 32,
    the gossipsub form); ``False`` keeps them as bool ``[C, N]`` rows
    (the floodsub and randomsub form, any C).  Default: packed iff
    C <= 32."""
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
    if pack_links is None:
        pack_links = C <= 32
    if pack_links and C > 32:
        raise ValueError("pack_links needs C <= 32")
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
        if pack_links:
            bits = np.zeros(n, dtype=np.uint32)
            for c, o in enumerate(offs):
                bits |= (grp != np.roll(grp, -o)).astype(np.uint32) << c
            kw["cross_bits"] = t_(bits.view(np.int32))
        else:
            kw["cross_rows"] = t_(np.stack([grp != np.roll(grp, -o)
                                            for o in offs]))
        kw.update(_windows(schedule))
    return FaultParams(down_start=t_(down_start), down_end=t_(down_end),
                       seed=int(schedule.seed) & 0xFFFFFFFF,
                       cold_restart=bool(schedule.cold_restart), **kw)


def _windows(schedule: FaultSchedule) -> dict:
    return dict(part_start=tuple(s for s, _ in schedule.partition_windows),
                part_end=tuple(e for _, e in schedule.partition_windows))


def _scalar_drop(schedule: FaultSchedule, path: str, device):
    """The gather and dense forms' drop rate: a 0-d f32 tensor, or None
    at 0; the per-edge ``[C, N]`` form raises (it is keyed to circulant
    offsets)."""
    dp = schedule.drop_prob
    if isinstance(dp, np.ndarray):
        raise ValueError(
            f"drop_prob: the per-edge [C, N] form needs circulant "
            f"offsets; the {path} path draws per-undirected-edge "
            "coins from a canonical pair hash and takes a SCALAR "
            "probability only")
    if float(dp) <= 0.0:
        return None
    return torch.tensor(float(dp), dtype=torch.float32, device=device)


def compile_faults_gather(schedule: FaultSchedule, nbrs, nbr_mask, *,
                          device) -> FaultParams:
    """Lower ``schedule`` against a gather neighbor table (int ``nbrs``
    [N, K], bool ``nbr_mask`` [N, K]): the churn tables as the circulant
    form's, a scalar drop rate (one coin per undirected pair,
    ``link_ok_gather``), the partition-crossing slots as bool [N, K]."""
    nbrs = np.asarray(nbrs)
    if nbrs.shape[0] != schedule.n_peers:
        raise ValueError(
            f"nbrs table has {nbrs.shape[0]} rows but the schedule "
            f"covers n_peers={schedule.n_peers}")
    down_start, down_end = _down_tables(schedule)
    kw = {}
    dp = _scalar_drop(schedule, "gather", device)
    if dp is not None:
        kw["drop_prob"] = dp
    if schedule.partition_windows:
        grp = schedule.partition_group
        # the sentinel slot (index N) reads the pad group -1: masked anyway
        grp_pad = np.concatenate([grp, np.full(1, -1, grp.dtype)])
        kw["cross_nk"] = torch.from_numpy(
            (grp[:, None] != grp_pad[nbrs]) & np.asarray(nbr_mask)).to(
            device)
        kw.update(_windows(schedule))
    return FaultParams(
        down_start=torch.from_numpy(down_start).to(device),
        down_end=torch.from_numpy(down_end).to(device),
        seed=int(schedule.seed) & MASK32, **kw)


def compile_faults_dense(schedule: FaultSchedule, *, device) -> FaultParams:
    """Lower ``schedule`` for the dense all-pairs step (randomsub's
    matmul hop): a scalar drop rate with one canonical-pair coin per
    undirected pair drawn on the fly (``link_ok_dense``), the partitions
    as the raw group assignment."""
    down_start, down_end = _down_tables(schedule)
    kw = {}
    dp = _scalar_drop(schedule, "dense", device)
    if dp is not None:
        kw["drop_prob"] = dp
    if schedule.partition_windows:
        kw["group"] = torch.from_numpy(
            np.asarray(schedule.partition_group, dtype=np.int32)).to(device)
        kw.update(_windows(schedule))
    return FaultParams(
        down_start=torch.from_numpy(down_start).to(device),
        down_end=torch.from_numpy(down_end).to(device),
        seed=int(schedule.seed) & MASK32, **kw)


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
    """bool [N]: peer up at ``tick`` (no down interval covers it); a
    replica stack's [B, N]."""
    if fp.down_start.shape[-1] == 0:
        return torch.ones(fp.down_start.shape[:-1], dtype=torch.bool,
                          device=fp.down_start.device)
    return ~((tick >= fp.down_start) & (tick < fp.down_end)).any(-1)


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
        out = out | (torch.roll(alive, -int(off), -1).to(torch.int32)
                     << c)
    return out


def _partition_active(fp: FaultParams, tick: int) -> bool:
    return any(s <= tick < e for s, e in zip(fp.part_start, fp.part_end))


def _link_drop_draw(fp: FaultParams, C: int, n: int, tick: int,
                    stride: int) -> torch.Tensor:
    """bool [C, N]: this tick's directed drop coins (fault-seeded lane
    hash, phase ``LINK_PHASE``); a replica stack's [B, C, N], each replica
    on its own fault seed and drop rate."""
    u = lane_uniform((C, n), tick, LINK_PHASE, fp.seed, stride=stride,
                     device=fp.down_start.device)
    dp = fp.drop_prob
    return u < (dp.view(-1, 1, 1) if dp.dim() == 1 else dp)


def link_ok_bits(fp: FaultParams, offsets, cinv, tick: int,
                 n_stream: int | None = None) -> torch.Tensor | None:
    """int32 [N]: bit c set iff edge (p, p + offsets[c]) is up this tick;
    None without link faults (churn only).  Symmetric drops are drawn at
    the positive-offset bits and mirrored to the partner's bit cinv[c];
    directed drops draw every bit."""
    if fp.drop_prob is None and fp.cross_bits is None:
        return None
    C = len(offsets)
    n = fp.down_start.shape[-2]
    drop = torch.zeros(fp.down_start.shape[:-1], dtype=torch.int32,
                       device=fp.down_start.device)
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
                mirror = mirror | (torch.roll(bit, int(off), -1)
                                   << cinv[c])
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
    cand_alive (the IWANT flood's gate); for the telemetry ``faults``
    group, ``alive`` the bool [N] peer-up mask and ``link`` the link word
    alone (bit c: edge c up; None without link faults)."""

    alive_w: torch.Tensor
    alive_all: torch.Tensor
    send_ok: torch.Tensor
    cand_alive: torch.Tensor
    flood_ok: torch.Tensor
    alive: torch.Tensor
    link: torch.Tensor | None


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
                     cand_alive=cand_alive, flood_ok=send_ok & cand_alive,
                     alive=alive, link=link)


def fault_counts(fp: FaultParams, masks: TickMasks, n_candidates: int):
    """The telemetry ``faults`` group of one tick's masks, int32 0-d
    tensors ``(down_peers, dropped_edge_ticks)`` (a replica stack's [B]
    each).  Undirected drops show on both views of an edge, so their count
    is halved to undirected edge-ticks; directed drops count each down
    direction (a partition cut counts 2); without link faults nothing
    drops."""
    down = (~masks.alive).sum(-1, dtype=torch.int32)
    if masks.link is None:
        return down, torch.zeros_like(down)
    cut = popcount32(~masks.link & ((1 << n_candidates) - 1)).sum(
        -1, dtype=torch.int32)
    return down, torch.div(cut, 1 if fp.directed_drops else 2,
                           rounding_mode="floor")


# -- the mesh-less simulators' link masks ------------------------------------

def link_ok_rows(fp: FaultParams, offsets, cinv, tick: int,
                 n_stream: int | None = None) -> torch.Tensor | None:
    """bool [C, N]: edge (p, p + offsets[c]) up this tick (the unpacked
    form, any C); None without link faults.  Symmetric drops are drawn
    at the positive offsets' rows and rolled onto the partner's row
    ``cinv[c]``; directed drops draw every row."""
    if fp.drop_prob is None and fp.cross_rows is None:
        return None
    C = len(offsets)
    n = fp.down_start.shape[-2]
    up = torch.ones((C, n), dtype=torch.bool, device=fp.down_start.device)
    if fp.drop_prob is not None:
        draw = _link_drop_draw(fp, C, n, tick,
                               n if n_stream is None else n_stream)
        if fp.directed_drops:
            up = ~draw
        else:
            rows = [None] * C
            for c, off in enumerate(offsets):
                if int(off) > 0:
                    rows[c] = draw[c]
                    rows[cinv[c]] = torch.roll(draw[c], int(off), -1)
            up = ~torch.stack(rows)
    if fp.cross_rows is not None and _partition_active(fp, tick):
        up = up & ~fp.cross_rows
    return up


def _pair_uniform(lo: torch.Tensor, hi: torch.Tensor, span: int,
                  tick: int, seed: int) -> torch.Tensor:
    """f32 uniforms keyed on the canonical undirected pair ``(lo, hi)``
    (equal for both directed views): the lane is ``lo * span + hi`` in
    u32 with wrap, as the reference computes it, so past 2^32 lanes
    (``span`` near 1M) distinct pairs may share a coin exactly as there.
    The lanes are int32 while none passes 2^31, else int64 masked to
    their low 32 bits."""
    if (span - 1) * span + span - 1 <= MASK32 >> 1:
        lane = lo.to(torch.int32) * span + hi.to(torch.int32)
    else:
        lane = to_i32(lo.to(torch.int64) * span + hi.to(torch.int64))
    h = fmix32(lane ^ i32(lane_seed(tick, LINK_PHASE, seed)))
    return shr(h, 8).to(torch.float32) * (1.0 / (1 << 24))


def link_ok_gather(fp: FaultParams, nbrs: torch.Tensor,
                   tick: int) -> torch.Tensor | None:
    """bool [N, K]: table slot (i, k) carries this tick (its undirected
    link is up); None without link faults.  Both views of an edge share
    the canonical ``(min, max)`` coin."""
    if fp.drop_prob is None and fp.cross_nk is None:
        return None
    n = nbrs.shape[0]
    up = torch.ones(nbrs.shape, dtype=torch.bool, device=nbrs.device)
    if fp.drop_prob is not None:
        i = torch.arange(n, dtype=nbrs.dtype, device=nbrs.device)[:, None]
        u = _pair_uniform(torch.minimum(i, nbrs), torch.maximum(i, nbrs),
                          n, tick, fp.seed)
        up = u >= fp.drop_prob
    if fp.cross_nk is not None and _partition_active(fp, tick):
        up = up & ~fp.cross_nk
    return up


def link_ok_dense(fp: FaultParams, n: int,
                  tick: int) -> torch.Tensor | None:
    """bool [N, N]: adjacency entry (receiver p, sender q) carries this
    tick; None without link faults.  One canonical-pair coin per
    undirected pair, the diagonal always up (a self-pair has no link);
    partitions cut the group-crossing pairs."""
    if fp.drop_prob is None and fp.group is None:
        return None
    dev = fp.down_start.device
    up = torch.ones((n, n), dtype=torch.bool, device=dev)
    if fp.drop_prob is not None:
        p = torch.arange(n, dtype=torch.int32, device=dev)
        u = _pair_uniform(torch.minimum(p[:, None], p[None, :]),
                          torch.maximum(p[:, None], p[None, :]), n, tick,
                          fp.seed)
        up = (u >= fp.drop_prob) | torch.eye(n, dtype=torch.bool,
                                             device=dev)
    if fp.group is not None and _partition_active(fp, tick):
        up = up & (fp.group[:, None] == fp.group[None, :])
    return up
