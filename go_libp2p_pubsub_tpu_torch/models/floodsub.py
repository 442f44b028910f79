"""FloodSub simulator: every peer floods each new message to all its
neighbors, one hop a tick, in PyTorch.

Counterpart of ``go_libp2p_pubsub_tpu/models/floodsub.py`` (its own copy:
the port imports nothing of the JAX package).  One step advances one tick
for every simulated peer: inject the due publishes, hear what the
neighbors held at the end of the last tick, record first deliveries.
Possession is packed words ``[W, N]`` (bit j of word w is message
32 w + j), first-delivery ticks int16 ``[W, 32, N]``, peer axis last.

Two topologies, as in the reference:

- circulant (``make_circulant_step_core``): peer p's neighbors are
  p + o for the ring's offsets, so a hop is the OR of rolled words;
- gather (``make_gather_step_core``, ``flood_step``): an arbitrary padded
  neighbor table ``nbrs`` [N, K] (sentinel N), a hop is a gather and an
  OR fold over the K slots.

Both take fault schedules (churn, scalar or per-edge link loss,
partitions; cold restart is refused, ``plan.MSG_FLOOD_COLD_RESTART``),
event-driven delays (``models/delays.py``: lag-l arrivals replay the
tick-(t - l) sends from the source-history ring ``src_ring``), telemetry
frames (floodsub's subset: payload copies sent, duplicates suppressed,
payload bytes, the latency histogram, the fault counters) and the
invariant checker's delivery group.  The reference leaves this simulator
to XLA (no Pallas kernel), so the port's hop is plain PyTorch: rolls, a
gather, OR folds.  The tick is a host int, so the step never syncs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..device import check_on, resolve_device
from ..ops.graph import (
    WORD_BITS,
    count_bits_per_position,
    gather_slots,
    or_fold,
    pack_bits,
    pack_bits_pm,
    popcount32,
    propagate_circulant,
    slot_index,
)
from . import delays as _delays
from . import faults as _faults
from . import invariants as _invariants
from . import plan
from . import telemetry as _telemetry
from ._delivery import (
    first_tick_to_matrix,
    reach_by_hops_from_first_tick,
    reach_counts_from_first_tick,
    update_first_tick,
)


@dataclass
class FloodParams:
    """Per-simulation tensors; ``nbrs`` / ``nbr_mask`` are None on a
    circulant topology (the step carries the offsets)."""

    nbrs: torch.Tensor | None         # int32 [N, K], sentinel N
    nbr_mask: torch.Tensor | None     # bool [N, K]
    fwd_words: torch.Tensor           # int32 [W, N]: forwards bit m
    deliver_words: torch.Tensor       # int32 [W, N]: bit m is a delivery
    origin_words: torch.Tensor        # int32 [W, N]: bit m at its origin
    publish_tick: torch.Tensor        # int32 [M]
    faults: _faults.FaultParams | None = None
    delays: _delays.DelayParams | None = None


@dataclass
class FloodState:
    have: torch.Tensor                # int32 [W, N]
    first_tick: torch.Tensor | None   # int16 [W, 32, N], -1 = never
    tick: int
    # the invariant checker's carry (None until ``invariants.attach``)
    inv_viol: torch.Tensor | None = None    # int32 []
    inv_first: torch.Tensor | None = None   # int32 []
    # delay-armed sims: slot t mod K holds the words at the start of tick t
    src_ring: torch.Tensor | None = None    # int32 [K, W, N]


def _pm_words(bits: np.ndarray, device) -> torch.Tensor:
    return pack_bits_pm(torch.from_numpy(np.ascontiguousarray(bits))).to(
        device)


def make_flood_sim(nbrs, nbr_mask, subs: np.ndarray, relays, msg_topic,
                   msg_origin, msg_publish_tick,
                   track_first_tick: bool = True, fault_schedule=None,
                   fault_offsets=None, delays=None, *,
                   device: str | torch.device | None = None):
    """Build ``(params, state)`` on ``device`` (default ``cuda``).

    ``subs`` / ``relays``: bool [N, T] (relays forward without
    delivering; None: no relays); ``msg_*``: the message table [M].
    ``nbrs`` / ``nbr_mask`` (numpy [N, K]) give a gather topology, None a
    circulant one, whose offsets a ``fault_schedule`` then needs as
    ``fault_offsets``.  ``delays``: a ``DelayConfig``."""
    dev = resolve_device(device)
    n = subs.shape[0]
    m = len(msg_topic)
    if relays is None:
        relays = np.zeros_like(subs)
    fparams = None
    if fault_schedule is not None:
        if fault_schedule.n_peers != n:
            raise ValueError(
                f"fault_schedule.n_peers={fault_schedule.n_peers} != "
                f"sim peer count {n}")
        plan.check_meshless_faults("flood", fault_schedule)
        if nbrs is not None:
            fparams = _faults.compile_faults_gather(
                fault_schedule, nbrs, nbr_mask, device=dev)
        else:
            if fault_offsets is None:
                raise ValueError(
                    "fault_schedule needs fault_offsets (the circulant "
                    "offsets the step was built with)")
            fparams = _faults.compile_faults(fault_schedule, fault_offsets,
                                             device=dev, pack_links=False)
    msg_topic = np.asarray(msg_topic)
    sub_bits = subs[:, msg_topic]
    relay_bits = relays[:, msg_topic]
    origin_bits = np.zeros((n, m), dtype=bool)
    origin_bits[np.asarray(msg_origin), np.arange(m)] = True
    # a peer forwards what it is subscribed to or relays, and its own
    # publishes (publish-without-subscribe floods too)
    fwd = sub_bits | relay_bits | origin_bits
    params = FloodParams(
        nbrs=(None if nbrs is None else torch.from_numpy(
            np.asarray(nbrs, dtype=np.int32)).to(dev)),
        nbr_mask=(None if nbrs is None else torch.from_numpy(
            np.asarray(nbr_mask, dtype=bool)).to(dev)),
        fwd_words=_pm_words(fwd, dev),
        deliver_words=_pm_words(sub_bits, dev),
        origin_words=_pm_words(origin_bits, dev),
        publish_tick=torch.from_numpy(
            np.asarray(msg_publish_tick, dtype=np.int32)).to(dev),
        faults=fparams,
        delays=(None if delays is None
                else _delays.compile_delays(delays, dev)))
    w = params.fwd_words.shape[0]
    state = FloodState(
        have=torch.zeros((w, n), dtype=torch.int32, device=dev),
        first_tick=(torch.full((w, WORD_BITS, n), -1, dtype=torch.int16,
                               device=dev) if track_first_tick else None),
        tick=0,
        src_ring=(None if delays is None else torch.zeros(
            (int(delays.k_slots), w, n), dtype=torch.int32, device=dev)))
    return params, state


def _finish_step(params: FloodParams, state: FloodState,
                 heard: torch.Tensor, alive: torch.Tensor | None = None,
                 src_ring: torch.Tensor | None = None):
    """Accept what was heard (the hop read the words held at the end of
    the previous tick), inject the due publishes (a down origin's is
    lost), record first deliveries: ``(state, delivered_now)``."""
    accepted = heard & ~state.have & (params.fwd_words
                                      | params.deliver_words)
    due = pack_bits(params.publish_tick == state.tick)          # [W]
    injected = params.origin_words & due[:, None] & ~state.have
    if alive is not None:
        injected = injected & _faults.alive_word(alive)[None, :]
    delivered_now = (accepted | injected) & params.deliver_words
    new_state = replace(
        state, have=state.have | accepted | injected,
        first_tick=update_first_tick(state.first_tick, delivered_now,
                                     state.tick),
        tick=state.tick + 1,
        src_ring=src_ring if src_ring is not None else state.src_ring)
    return new_state, delivered_now


def _pc_sum(x: torch.Tensor) -> torch.Tensor:
    """Total set bits of int32 words, as a 0-d int32 tensor."""
    return popcount32(x).sum(dtype=torch.int32)


def _frame(tel, ws, params: FloodParams, state: FloodState, heard,
           delivered, sent_cnt, recv_cnt, fp, alive, dropped):
    """Floodsub's frame subset of one tick: ``dropped`` is the link
    mask's dropped count already in edge units (None: no link faults)."""
    kw = {}
    if tel.counters:
        accepted = heard & ~state.have & (params.fwd_words
                                          | params.deliver_words)
        kw.update(payload_sent=sent_cnt,
                  dup_suppressed=recv_cnt - _pc_sum(accepted))
        if tel.wire:
            kw["bytes_payload"] = (sent_cnt.to(torch.float32)
                                   * float(ws.payload_frame))
    if tel.latency_hist:
        kw["latency_hist"] = _telemetry.latency_histogram(
            delivered, params.publish_tick, state.tick, tel.latency_buckets)
    if tel.faults and fp is not None:
        kw["down_peers"] = (~alive).sum(dtype=torch.int32)
        if dropped is not None:
            kw["dropped_edge_ticks"] = dropped
    return _telemetry.make_frame(heard.device, **kw)


def _ring_write(state, words: torch.Tensor) -> torch.Tensor:
    """The source-history ring with slot ``tick mod K`` replaced."""
    ring = state.src_ring.clone()
    ring[state.tick % ring.shape[0]] = words
    return ring


def _ring_read(state, t_s: int) -> torch.Tensor:
    return state.src_ring[t_s % state.src_ring.shape[0]]


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def flood_step(params: FloodParams, state: FloodState) -> FloodState:
    """One tick over a gather topology (``make_gather_step_core``'s
    state)."""
    return make_gather_step_core()(params, state)[0]


def make_gather_step_core(telemetry=None, invariants=None):
    """``(params, state) -> (state, delivered_words)`` over a gather
    (``nbrs`` table) topology; with ``telemetry`` a third item, the
    tick's ``TelemetryFrame``; with ``invariants`` (an
    ``InvariantConfig``) the delivery group folded into the armed state's
    carry.  Honors ``params.faults`` (``compile_faults_gather``: a down
    peer neither sends, receives nor injects; a link drops on its
    canonical-pair coin; a partition window cuts the crossing slots) and
    ``params.delays``."""
    tel = telemetry
    ws = _telemetry.wire_sizes(tel) if tel is not None else None
    tables = {}

    def gather(src, params: FloodParams) -> torch.Tensor:
        """``gather_slots`` with the table's slot-major index made once
        per table (not a copy of [N, K] indices every tick)."""
        hit = tables.get(id(params.nbrs))
        if hit is None or hit[0] is not params.nbrs:
            tables.clear()
            hit = tables[id(params.nbrs)] = (params.nbrs,
                                             slot_index(params.nbrs))
        return gather_slots(src, params.nbrs, hit[1])

    def delayed_gather(params: FloodParams, state: FloodState):
        dlp = params.delays
        K = dlp.k_slots
        fp = params.faults
        tick = state.tick
        alive = aw_now = None
        if fp is not None:
            alive = _faults.alive_mask(fp, tick)
            aw_now = _faults.alive_word(alive)
        count = tel is not None and tel.counters
        dev = state.have.device
        sent_cnt = recv_cnt = _zero(dev) if count else None
        heard = torch.zeros_like(state.have)
        ok_now = src_now = link_now = None
        for lag in range(K):
            t_s = tick - lag
            src = state.have if lag == 0 else _ring_read(state, t_s)
            src = src & params.fwd_words
            ok = params.nbr_mask
            link_s = None
            if fp is not None:
                src = src & _faults.alive_word(
                    _faults.alive_mask(fp, t_s))[None, :]
                link_s = _faults.link_ok_gather(fp, params.nbrs, t_s)
                if link_s is not None:
                    ok = ok & link_s
            if lag == 0:
                ok_now, src_now, link_now = ok, src, link_s
            okl = ok & _delays.arrive_now(dlp, tuple(params.nbrs.shape),
                                          t_s, lag)
            g = torch.where(okl.T[None], gather(src, params), 0)
            arr = or_fold(g, 1)
            if aw_now is not None:
                arr = arr & aw_now[None, :]                # receiver up
            heard = heard | arr
            if count:
                recv = g if aw_now is None else g & aw_now[None, None, :]
                recv_cnt = recv_cnt + _pc_sum(recv)
        if count:
            # payload copies SENT this tick, every delay class
            sent_cnt = _pc_sum(torch.where(
                ok_now.T[None], gather(src_now, params), 0))
        new_state, delivered = _finish_step(
            params, state, heard, alive=alive,
            src_ring=_ring_write(state, state.have))
        if tel is None:
            return new_state, delivered
        dropped = None
        if fp is not None and link_now is not None:
            dropped = (~link_now & params.nbr_mask).sum(
                dtype=torch.int32) // 2
        return new_state, delivered, _frame(
            tel, ws, params, state, heard, delivered, sent_cnt, recv_cnt,
            fp, alive, dropped)

    def core(params: FloodParams, state: FloodState):
        if params.delays is not None:
            return delayed_gather(params, state)
        fp = params.faults
        src = state.have & params.fwd_words
        alive = aw = link_up = None
        if fp is not None:
            alive = _faults.alive_mask(fp, state.tick)
            aw = _faults.alive_word(alive)
            src = src & aw[None, :]                        # sender up
            link_up = _faults.link_ok_gather(fp, params.nbrs, state.tick)
        if link_up is None and tel is None:
            # no link faults: propagate_pm's hop; under pure churn only
            # the endpoints are masked
            heard = or_fold(torch.where(params.nbr_mask.T[None],
                                        gather(src, params), 0), 1)
            if aw is None:
                return _finish_step(params, state, heard)
            return _finish_step(params, state, heard & aw[None, :],
                                alive=alive)
        ok = params.nbr_mask if link_up is None \
            else params.nbr_mask & link_up                 # [N, K]
        g = torch.where(ok.T[None], gather(src, params), 0)
        heard = or_fold(g, 1)
        if aw is not None:
            heard = heard & aw[None, :]                    # receiver up
        new_state, delivered = _finish_step(params, state, heard,
                                            alive=alive)
        if tel is None:
            return new_state, delivered
        sent_cnt = recv_cnt = None
        if tel.counters:
            sent_cnt = _pc_sum(g)
            recv_cnt = _pc_sum(g if aw is None else g & aw[None, None, :])
        dropped = None
        if link_up is not None:
            # two table slots per undirected edge on a symmetric table
            dropped = (~link_up & params.nbr_mask).sum(
                dtype=torch.int32) // 2
        return new_state, delivered, _frame(
            tel, ws, params, state, heard, delivered, sent_cnt, recv_cnt,
            fp, alive, dropped)

    if invariants is not None:
        return _invariants.wrap_step_delivery(core, invariants,
                                              "floodsub (gather)")
    return core


def make_circulant_flood_step(offsets):
    """A flood step over a circulant topology: ``(params, state) ->
    state``."""
    core = make_circulant_step_core(offsets)

    def step(params: FloodParams, state: FloodState) -> FloodState:
        return core(params, state)[0]

    return step


def make_circulant_step_core(offsets, telemetry=None, invariants=None):
    """``(params, state) -> (state, delivered_words)`` over a circulant
    graph (the hop: rolls by the offsets).  Honors ``params.faults``
    (``compile_faults(..., pack_links=False)``: a down peer neither
    sends, receives nor injects, a down link carries nothing that tick,
    a partition window cuts the cross-group edges) and
    ``params.delays``.  With ``telemetry`` the hop runs as explicit
    per-edge rolls so the copies can be counted (the trajectory is the
    same), and the core returns the tick's frame third; ``invariants``
    as in ``make_gather_step_core``."""
    offsets = tuple(int(o) for o in offsets)
    idx = {o: i for i, o in enumerate(offsets)}
    cinv = (tuple(idx[-o] for o in offsets)
            if all(-o in idx for o in offsets) else None)
    tel = telemetry
    ws = _telemetry.wire_sizes(tel) if tel is not None else None

    def dropped_of(fp, link):
        # undirected drops show on both views of an edge (halved); directed
        # drops count each down direction
        if link is None:
            return None
        return (~link).sum(dtype=torch.int32) // (
            1 if fp.directed_drops else 2)

    def telemetry_core(params: FloodParams, state: FloodState):
        fp = params.faults
        alive = aw = link = None
        src = state.have & params.fwd_words
        if fp is not None:
            alive = _faults.alive_mask(fp, state.tick)
            aw = _faults.alive_word(alive)
            link = _faults.link_ok_rows(fp, offsets, cinv, state.tick)
            src = src & aw[None, :]                        # sender up
        dev = src.device
        sent_cnt, recv_cnt = _zero(dev), _zero(dev)
        heard = torch.zeros_like(src)
        for c, off in enumerate(offsets):
            sent = src if link is None else torch.where(link[c], src, 0)
            rolled = torch.roll(sent, off, -1)
            if aw is not None:
                rolled = rolled & aw                       # receiver up
            heard |= rolled
            if tel.counters:
                sent_cnt = sent_cnt + _pc_sum(sent)
                recv_cnt = recv_cnt + _pc_sum(rolled)
        new_state, delivered = _finish_step(params, state, heard,
                                            alive=alive)
        return new_state, delivered, _frame(
            tel, ws, params, state, heard, delivered, sent_cnt, recv_cnt,
            fp, alive, None if fp is None else dropped_of(fp, link))

    def delayed_core(params: FloodParams, state: FloodState):
        dlp = params.delays
        K = dlp.k_slots
        fp = params.faults
        tick = state.tick
        n = state.have.shape[1]
        C = len(offsets)
        alive = aw_now = None
        if fp is not None:
            alive = _faults.alive_mask(fp, tick)
            aw_now = _faults.alive_word(alive)
        count = tel is not None and tel.counters
        dev = state.have.device
        sent_cnt = recv_cnt = _zero(dev) if count else None
        heard = torch.zeros_like(state.have)
        link_now = src_now = None
        for lag in range(K):
            t_s = tick - lag
            src = state.have if lag == 0 else _ring_read(state, t_s)
            src = src & params.fwd_words
            link_s = None
            if fp is not None:
                # the send-time masks at the SEND tick; the receiver's
                # at arrival
                src = src & _faults.alive_word(
                    _faults.alive_mask(fp, t_s))[None, :]
                link_s = _faults.link_ok_rows(fp, offsets, cinv, t_s)
            if lag == 0:
                link_now, src_now = link_s, src
            dmask = _delays.arrive_now(dlp, (C, n), t_s, lag)
            if link_s is not None:
                dmask = dmask & link_s
            for c, off in enumerate(offsets):
                rolled = torch.roll(torch.where(dmask[c], src, 0), off, -1)
                if aw_now is not None:
                    rolled = rolled & aw_now               # receiver up
                heard |= rolled
                if count:
                    recv_cnt = recv_cnt + _pc_sum(rolled)
        if count:
            # payload copies SENT this tick, every delay class
            for c in range(C):
                s0 = (src_now if link_now is None
                      else torch.where(link_now[c], src_now, 0))
                sent_cnt = sent_cnt + _pc_sum(s0)
        new_state, delivered = _finish_step(
            params, state, heard, alive=alive,
            src_ring=_ring_write(state, state.have))
        if tel is None:
            return new_state, delivered
        return new_state, delivered, _frame(
            tel, ws, params, state, heard, delivered, sent_cnt, recv_cnt,
            fp, alive, None if fp is None else dropped_of(fp, link_now))

    def core(params: FloodParams, state: FloodState):
        if params.delays is not None:
            return delayed_core(params, state)
        if tel is not None:
            return telemetry_core(params, state)
        fp = params.faults
        if fp is None:
            heard = propagate_circulant(state.have & params.fwd_words,
                                        offsets)
            return _finish_step(params, state, heard)
        alive = _faults.alive_mask(fp, state.tick)
        aw = _faults.alive_word(alive)
        link = _faults.link_ok_rows(fp, offsets, cinv, state.tick)
        src = state.have & params.fwd_words & aw[None, :]  # sender up
        if link is None:
            # pure churn: every edge carries, only the endpoints are masked
            heard = propagate_circulant(src, offsets) & aw[None, :]
            return _finish_step(params, state, heard, alive=alive)
        heard = torch.zeros_like(src)
        for c, off in enumerate(offsets):
            heard |= torch.roll(torch.where(link[c], src, 0), off, -1)
        return _finish_step(params, state, heard & aw[None, :],
                            alive=alive)

    if invariants is not None:
        return _invariants.wrap_step_delivery(core, invariants,
                                              "floodsub (circulant)")
    return core


# -- runners -------------------------------------------------------------------

def flood_run(params: FloodParams, state: FloodState, n_ticks: int,
              step_fn=flood_step, *,
              device: str | torch.device | None = None) -> FloodState:
    """Advance ``n_ticks`` ticks on ``device`` (default ``cuda``);
    ``step_fn(params, state) -> state``."""
    dev = resolve_device(device)
    check_on(dev, have=state.have, fwd_words=params.fwd_words)
    for _ in range(n_ticks):
        state = step_fn(params, state)
    return state


def flood_run_curve(params: FloodParams, state: FloodState, n_ticks: int,
                    step_core, n_msgs: int, *,
                    device: str | torch.device | None = None):
    """``flood_run`` over a core (``(params, state) -> (state, delivered,
    ...)``) collecting the per-tick delivered counts: ``(state, counts
    int32 [n_ticks, n_msgs])``, stacked once at the end."""
    dev = resolve_device(device)
    check_on(dev, have=state.have, fwd_words=params.fwd_words)
    rows = []
    for _ in range(n_ticks):
        state, delivered = step_core(params, state)[:2]
        rows.append(count_bits_per_position(delivered, n_msgs))
    counts = (torch.stack(rows) if rows else
              torch.zeros((0, n_msgs), dtype=torch.int32, device=dev))
    return state, counts


# -- readouts ------------------------------------------------------------------

def first_tick_matrix(state: FloodState, m: int) -> torch.Tensor:
    """first_tick as [N, M] (word padding stripped)."""
    return first_tick_to_matrix(state.first_tick, m)


def reach_counts(params: FloodParams, state: FloodState) -> torch.Tensor:
    """Per-message delivered-peer counts: int32 [M]."""
    return reach_counts_from_first_tick(state.first_tick,
                                        params.publish_tick.shape[0])


def reach_by_hops(params: FloodParams, state: FloodState,
                  max_hops: int) -> torch.Tensor:
    """int32 [M, max_hops]: cumulative deliveries by hop count."""
    return reach_by_hops_from_first_tick(
        state.first_tick, params.publish_tick.shape[0], max_hops)
