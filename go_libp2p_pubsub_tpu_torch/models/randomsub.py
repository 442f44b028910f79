"""RandomSub simulator: every peer forwards each newly acquired message
once, to a random subset of its topic peers of expected size
max(D, ceil(sqrt(topic size))), in PyTorch.

Counterpart of ``go_libp2p_pubsub_tpu/models/randomsub.py`` (its own
copy: the port imports nothing of the JAX package).  As there, the
sample is a Bernoulli send along each candidate edge with probability
``send_prob = k / pool`` (a binomial fanout of the reference router's
mean), drawn from the counter-based lane hash at phase 1 and the run
salt (the reference's ``key_data(PRNGKey(seed))[-1]``, ``seed & 0xFFFFFFFF``,
carried as a host int).  Peer p may subscribe only to topic p mod T.

Two steps:

- ``make_randomsub_step``: the circulant form, C candidates p + o_c with
  their subscription masks unpacked to bool ``[C, N]`` (C may exceed 32:
  the sqrt fanout at 10k peers needs ~100 targets), the hop one roll per
  candidate;
- ``make_randomsub_dense_step``: the all-pairs form for small N, the
  tick's sender adjacency ``[N, N]`` hashed on the fly and the hop one
  bf16 matrix product with the unpacked frontier.  The reference computes
  that product outside any Pallas kernel (``jnp.dot``), so it stays
  ``torch.matmul``.

Both take fault schedules (cold restart refused,
``plan.MSG_RANDOMSUB_COLD_RESTART``; the dense step a scalar drop rate
and partitions only), event-driven delays (lag-l arrivals replay the
tick-(t - l) draws against the frontier-history ring ``src_ring``),
telemetry frames (payload copies sent, duplicates suppressed, payload
bytes, the latency histogram, the fault counters) and the invariant
checker's delivery group.  Words are ``[W, N]``, first-delivery ticks
int16 ``[W, 32, N]``, as in ``models/floodsub.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..device import check_on, resolve_device
from ..ops.graph import (
    MASK32,
    WORD_BITS,
    count_bits_per_position,
    lane_uniform,
    make_circulant_offsets,
    or_fold,
    pack_bits,
    popcount32,
    to_i32,
)
from . import delays as _delays
from . import faults as _faults
from . import invariants as _invariants
from . import plan
from . import telemetry as _telemetry
from .floodsub import _pc_sum, _pm_words, _ring_write
from ._delivery import (
    first_tick_to_matrix,
    reach_by_hops_from_first_tick,
    reach_counts_from_first_tick,
    update_first_tick,
)


@dataclass(frozen=True)
class RandomSubSimConfig:
    """Static config; ``d`` is RandomSubD, the fanout floor."""

    offsets: tuple[int, ...]       # C candidate ring offsets, ± paired
    n_topics: int = 1
    d: int = 6

    def __post_init__(self):
        offs = set(int(o) for o in self.offsets)
        if not offs or len(offs) != len(self.offsets):
            raise ValueError("offsets must be distinct and non-empty")
        if not all(-o in offs for o in offs):
            raise ValueError("offsets must be closed under negation")
        if any(o % self.n_topics for o in offs):
            raise ValueError("offsets must be multiples of n_topics")

    @property
    def n_candidates(self) -> int:
        return len(self.offsets)


def make_randomsub_offsets(n_topics: int, n_candidates: int, n_peers: int,
                           seed: int = 0) -> tuple[int, ...]:
    """The candidate ring (host numpy, the reference's draw)."""
    offs = make_circulant_offsets(n_topics, n_candidates, n_peers, seed=seed)
    return tuple(int(o) for o in offs)


@dataclass
class RandomSubParams:
    subscribed: torch.Tensor        # bool [N]
    cand_subscribed: torch.Tensor   # bool [C, N]: candidate p + o_c is
    send_prob: torch.Tensor         # f32 [N]: k / |sampling pool|
    origin_words: torch.Tensor      # int32 [W, N]
    deliver_words: torch.Tensor     # int32 [W, N]
    publish_tick: torch.Tensor      # int32 [M]
    faults: _faults.FaultParams | None = None
    delays: _delays.DelayParams | None = None


@dataclass
class RandomSubState:
    have: torch.Tensor              # int32 [W, N]
    fresh: torch.Tensor             # int32 [W, N]: acquired last tick
    first_tick: torch.Tensor | None  # int16 [W, 32, N]
    salt: int                       # run seed, key_data(PRNGKey(seed))[-1]
    tick: int
    # the invariant checker's carry (None until ``invariants.attach``)
    inv_viol: torch.Tensor | None = None    # int32 []
    inv_first: torch.Tensor | None = None   # int32 []
    # delay-armed sims: slot t mod K holds tick t's frontier
    src_ring: torch.Tensor | None = None    # int32 [K, W, N]


def make_randomsub_sim(cfg: RandomSubSimConfig, subs: np.ndarray,
                       msg_topic, msg_origin, msg_publish_tick,
                       seed: int = 0, track_first_tick: bool = True,
                       dense: bool = False, fault_schedule=None,
                       delays=None, *,
                       device: str | torch.device | None = None):
    """Build ``(params, state)`` on ``device`` (default ``cuda``).

    ``subs``: bool [N, T], peer p subscribed at most to topic p mod T;
    every message's origin lies in its topic's residue class.
    ``dense=True`` sizes ``send_prob`` for ``make_randomsub_dense_step``,
    whose sampling pool is every other member of the topic.
    ``fault_schedule`` compiles to the unpacked circulant form, or with
    ``dense`` to the all-pairs form (a scalar drop rate only)."""
    dev = resolve_device(device)
    if fault_schedule is not None:
        if fault_schedule.n_peers != subs.shape[0]:
            raise ValueError(
                f"fault_schedule.n_peers={fault_schedule.n_peers} != "
                f"sim peer count {subs.shape[0]}")
        plan.check_meshless_faults("randomsub", fault_schedule)
    n, t = subs.shape
    if t != cfg.n_topics:
        raise ValueError("subs topic dim != cfg.n_topics")
    own_topic = np.arange(n) % cfg.n_topics
    cross = subs & ~(np.arange(t)[None, :] == own_topic[:, None])
    if cross.any():
        raise ValueError("peers may only subscribe to topic (p mod T)")
    subscribed = subs[np.arange(n), own_topic]
    msg_topic = np.asarray(msg_topic)
    msg_origin = np.asarray(msg_origin)
    m = len(msg_topic)
    if ((msg_origin % cfg.n_topics) != msg_topic).any():
        raise ValueError("msg origin must be in the topic's residue class")
    origin_bits = np.zeros((n, m), dtype=bool)
    origin_bits[msg_origin, np.arange(m)] = True
    deliver_bits = subscribed[:, None] & (own_topic[:, None]
                                          == msg_topic[None, :])
    cand_sub = np.stack([np.roll(subscribed, -o) for o in cfg.offsets])
    # sqrt fanout k = max(D, ceil(sqrt(topic size))); the pool is the
    # peer's subscribed candidates (dense: every other topic member)
    topic_size = np.bincount(own_topic[subscribed], minlength=cfg.n_topics)
    k = np.maximum(cfg.d, np.ceil(np.sqrt(topic_size)))[own_topic]
    if dense:
        n_pool = np.maximum(topic_size[own_topic] - 1, 1)
    else:
        n_pool = np.maximum(cand_sub.sum(axis=0), 1)
    send_prob = np.minimum(1.0, k / n_pool).astype(np.float32)
    faults = None
    if fault_schedule is not None:
        faults = (_faults.compile_faults_dense(fault_schedule, device=dev)
                  if dense else
                  _faults.compile_faults(fault_schedule, cfg.offsets,
                                         device=dev, pack_links=False))
    params = RandomSubParams(
        subscribed=torch.from_numpy(subscribed).to(dev),
        cand_subscribed=torch.from_numpy(cand_sub).to(dev),
        send_prob=torch.from_numpy(send_prob).to(dev),
        origin_words=_pm_words(origin_bits, dev),
        deliver_words=_pm_words(deliver_bits, dev),
        publish_tick=torch.from_numpy(
            np.asarray(msg_publish_tick, dtype=np.int32)).to(dev),
        faults=faults,
        delays=(None if delays is None
                else _delays.compile_delays(delays, dev)))
    w = params.origin_words.shape[0]
    state = RandomSubState(
        have=torch.zeros((w, n), dtype=torch.int32, device=dev),
        fresh=torch.zeros((w, n), dtype=torch.int32, device=dev),
        first_tick=(torch.full((w, WORD_BITS, n), -1, dtype=torch.int16,
                               device=dev) if track_first_tick else None),
        salt=int(seed) & MASK32, tick=0,
        src_ring=(None if delays is None else torch.zeros(
            (int(delays.k_slots), w, n), dtype=torch.int32, device=dev)))
    return params, state


# -- the parts both steps share ------------------------------------------------

def _prologue(params: RandomSubParams, state: RandomSubState):
    """The due publishes (a down origin's lost) and the tick's frontier:
    ``(injected, frontier, alive, aw)``."""
    due = pack_bits(params.publish_tick == state.tick)          # [W]
    injected = params.origin_words & due[:, None] & ~state.have
    alive = aw = None
    if params.faults is not None:
        alive = _faults.alive_mask(params.faults, state.tick)
        aw = _faults.alive_word(alive)
        injected = injected & aw[None, :]
    return injected, state.fresh | injected, alive, aw


def _epilogue(params: RandomSubParams, state: RandomSubState, heard,
              injected, aw, ring):
    """Accept the heard news at subscribers (only they keep and forward;
    the frontier carries only RECEIVED news, so a publish is forwarded
    once, at its inject tick): ``(state, delivered_now, new)``."""
    if aw is not None:
        heard = heard & aw[None, :]                # a down peer hears nothing
    new = heard & ~state.have & ~injected
    new = torch.where(params.subscribed, new, 0)
    acquired = new | injected
    delivered_now = acquired & params.deliver_words
    new_state = replace(
        state, have=state.have | acquired, fresh=new,
        first_tick=update_first_tick(state.first_tick, delivered_now,
                                     state.tick),
        tick=state.tick + 1, src_ring=ring)
    return new_state, delivered_now, new


def _frame(tel, ws, params, state, delivered, new, sent_cnt, recv_cnt,
           fp, alive, dropped):
    kw = {}
    if tel.counters:
        kw.update(payload_sent=sent_cnt,
                  dup_suppressed=recv_cnt - _pc_sum(new))
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
    return _telemetry.make_frame(delivered.device, **kw)


class _SendTickDraws:
    """A delayed step's draws of each send tick, kept while its delay line
    replays them.  Tick s's send mask, link mask and edge delays are pure
    functions of (params, salt, s), and ticks s .. s + K - 1 each replay
    them at one lag: kept, each send tick's lane hashes are made once
    instead of K times.  Only the ticks of the current window stay."""

    def __init__(self):
        self._draws = {}

    def get(self, params, salt: int, t_s: int, tick: int, k: int, make):
        hit = self._draws.get((t_s, salt))
        if hit is None or hit[0] is not params:
            hit = self._draws[(t_s, salt)] = (params, make())
        for key in [key for key in self._draws
                    if not tick - k < key[0] <= tick]:
            del self._draws[key]
        return hit[1]


def _delays_of(dlp, shape, t_s: int) -> torch.Tensor:
    """int8 ``shape``: the delay of each edge-lane for sends at ``t_s``
    (``delays.edge_delays``; in [1, k_slots], at most 127)."""
    return _delays.edge_delays(dlp, shape, t_s).to(torch.int8)


# -- the circulant step --------------------------------------------------------

def make_randomsub_step(cfg: RandomSubSimConfig, telemetry=None,
                        invariants=None):
    """``(params, state) -> (state, delivered_words)``: one tick = inject
    the due publishes, send the frontier along each subscribed candidate
    edge with probability ``send_prob`` (a fresh draw each tick), record
    deliveries.  With ``telemetry`` a third item, the tick's frame; with
    ``invariants`` the delivery group folded into the armed state's
    carry.  Honors ``params.faults`` (the unpacked circulant form) and
    ``params.delays``."""
    offsets = tuple(int(o) for o in cfg.offsets)
    C = len(offsets)
    idx = {o: i for i, o in enumerate(offsets)}
    cinv = (tuple(idx[-o] for o in offsets)
            if all(-o in idx for o in offsets) else None)
    tel = telemetry
    ws = _telemetry.wire_sizes(tel) if tel is not None else None

    src_idx = {}
    kept = _SendTickDraws()

    def sources(n: int, dev) -> torch.Tensor:
        """int64 [C, N]: the sender ``(p - o_c) mod N`` whose send along
        candidate edge c peer p hears (made once per width and device)."""
        key = (n, str(dev))
        if key not in src_idx:
            offs = torch.tensor(offsets, dtype=torch.int64, device=dev)
            src_idx[key] = (torch.arange(n, dtype=torch.int64, device=dev)
                            - offs[:, None]) % n
        return src_idx[key]

    def hop(send, fr, src, alive, count):
        """What each peer hears, ``OR_c`` of its sender's words where that
        sender sent along edge c (the reference's per-edge rolls as one
        gather and a halving OR fold), and with ``count`` the copies
        received (``alive``: only live peers count them)."""
        s_g = send.gather(1, src)                          # [C, N]
        heard = or_fold(torch.where(s_g[None], fr[:, src], 0), 1)
        if not count:
            return heard, 0
        got = s_g if alive is None else s_g & alive
        return heard, (got * copies_of(fr)[src]).sum(dtype=torch.int64)

    def copies_of(fr: torch.Tensor) -> torch.Tensor:
        """int64 [N]: the set bits of each peer's words."""
        return popcount32(fr).sum(0, dtype=torch.int64)

    def sent_copies(send, fr) -> torch.Tensor:
        return (send.sum(0, dtype=torch.int64) * copies_of(fr)).sum()

    def sends(params, n, t_s, salt, fp):
        """bool [C, N]: the edges tick ``t_s`` sends on (a stateless draw,
        so the delay replay makes past ticks' again), and the link mask."""
        u = lane_uniform((C, n), t_s, 1, salt,
                         device=params.send_prob.device)
        send = params.cand_subscribed & (u < params.send_prob[None, :])
        link = None
        if fp is not None:
            # a down peer sends nothing; a down link carries nothing
            send = send & _faults.alive_mask(fp, t_s)[None, :]
            link = _faults.link_ok_rows(fp, offsets, cinv, t_s)
            if link is not None:
                send = send & link
        return send, link

    def step(params: RandomSubParams, state: RandomSubState):
        tick = state.tick
        n = params.subscribed.shape[0]
        injected, frontier, alive, aw = _prologue(params, state)
        fp = params.faults
        count = tel is not None and tel.counters
        src = sources(n, frontier.device)
        dlp = params.delays
        ring = state.src_ring
        if dlp is None:
            send, link = sends(params, n, tick, state.salt, fp)
            heard, recv64 = hop(send, frontier, src, alive, count)
            sent64 = sent_copies(send, frontier) if count else None
        else:
            K = dlp.k_slots
            heard, recv64 = torch.zeros_like(frontier), 0
            for lag in range(K):
                t_s = tick - lag
                fr_l = (frontier if lag == 0
                        else state.src_ring[t_s % K])
                send_l, link_l, d_l = kept.get(
                    params, state.salt, t_s, tick, K,
                    lambda: (*sends(params, n, t_s, state.salt, fp),
                             _delays_of(dlp, (C, n), t_s)))
                if lag == 0:
                    # copies SENT this tick, every delay class
                    link = link_l
                    sent64 = sent_copies(send_l, frontier) if count else None
                send_l = send_l & (d_l == lag + 1)         # arrives now
                h_l, r_l = hop(send_l, fr_l, src, alive, count)
                heard, recv64 = heard | h_l, recv64 + r_l
            ring = _ring_write(state, frontier)
        new_state, delivered, new = _epilogue(params, state, heard,
                                              injected, aw, ring)
        if tel is None:
            return new_state, delivered
        dropped = None
        if fp is not None and link is not None:
            # undirected drops show on both views (halved); directed
            # drops count each down direction
            dropped = (~link).sum(dtype=torch.int32) // (
                1 if fp.directed_drops else 2)
        # the int64 counts wrapped as the reference's int32 sums wrap
        return new_state, delivered, _frame(
            tel, ws, params, state, delivered, new,
            to_i32(sent64) if count else None,
            to_i32(recv64) if count else None, fp, alive, dropped)

    if invariants is not None:
        return _invariants.wrap_step_delivery(step, invariants,
                                              "randomsub (circulant)")
    return step


# -- the dense step ------------------------------------------------------------

def make_randomsub_dense_step(cfg: RandomSubSimConfig, telemetry=None,
                              invariants=None):
    """The all-pairs form for small N: one hop = ``adjacency [N, N] @
    frontier [N, 32 W]`` in bf16.  The tick's Bernoulli sender adjacency
    (``adj[p, q]``: q sends to p, same topic) is hashed on the fly, so the
    sampling pool is every topic member, the reference router's known-peer
    list.  Honors ``params.faults`` (``compile_faults_dense``: churn masks
    the adjacency's sender columns and receiver rows, a scalar link loss
    one canonical-pair coin per undirected pair, partitions the
    group-crossing entries), ``params.delays`` (K lag products, each
    tick-(t - l)'s redrawn adjacency masked to delay l + 1, against that
    tick's frontier from the ring), ``telemetry`` and ``invariants`` as
    ``make_randomsub_step``."""
    T = cfg.n_topics
    tel = telemetry
    ws = _telemetry.wire_sizes(tel) if tel is not None else None
    kept = _SendTickDraws()

    def draw_adj(params, n, t_s, salt, fp):
        """The sender-side adjacency of tick ``t_s`` and its link mask
        (stateless: the delay replay redraws past ticks)."""
        dev = params.send_prob.device
        a = lane_uniform((n, n), t_s, 1, salt, device=dev) \
            < params.send_prob[None, :]
        if T > 1:
            cls = torch.arange(n, device=dev) % T
            a = a & (cls[:, None] == cls[None, :])
        lnk = None
        if fp is not None:
            a = a & _faults.alive_mask(fp, t_s)[None, :]
            lnk = _faults.link_ok_dense(fp, n, t_s)
            if lnk is not None:
                a = a & lnk
        return a, lnk

    def unpack(fr: torch.Tensor) -> torch.Tensor:
        """Words [W, N] -> bf16 [N, 32 W] (column 32 w + j: bit j of word
        w)."""
        shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=fr.device)
        bits = (fr.T[:, :, None] >> shifts) & 1              # [N, W, 32]
        return bits.reshape(fr.shape[1], -1).to(torch.bfloat16)

    def hop(adj: torch.Tensor, fr: torch.Tensor) -> torch.Tensor:
        # bf16 operands, bf16 result (the reference asks XLA for an f32
        # one).  Every product is 0 or 1 and every partial sum of them is
        # >= 1 once any 1 entered it: rounding to bf16 is monotone and 1
        # is exact, so ``cnt > 0.5`` holds iff some sender sent, the same
        # bits as the f32 result.  The lag terms are summed in f32.
        return torch.matmul(adj.to(torch.bfloat16), unpack(fr)).to(
            torch.float32)

    def repack(heard_bits: torch.Tensor, w: int) -> torch.Tensor:
        """bool [N, 32 W] -> words [W, N]."""
        shifts = torch.arange(WORD_BITS, dtype=torch.int32,
                              device=heard_bits.device)
        b = heard_bits.reshape(-1, w, WORD_BITS).to(torch.int32) << shifts
        return b.sum(-1, dtype=torch.int32).T.contiguous()

    def copies(adj: torch.Tensor, fr: torch.Tensor) -> torch.Tensor:
        """Copies carried by ``adj``: each entry (p, q) carries sender
        q's whole frontier, so the sum over q of its column count times
        its frontier popcount, in integers (never read off the product)."""
        per_q = popcount32(fr).sum(0, dtype=torch.int64)        # [N]
        return (adj.sum(0, dtype=torch.int64) * per_q).sum()

    def step(params: RandomSubParams, state: RandomSubState):
        tick = state.tick
        n = params.subscribed.shape[0]
        W = state.have.shape[0]
        injected, frontier, alive, aw = _prologue(params, state)
        fp = params.faults
        dlp = params.delays
        ring = state.src_ring
        count = tel is not None and tel.counters
        sent64 = recv64 = None
        if dlp is None:
            adj, link = draw_adj(params, n, tick, state.salt, fp)
            if count:
                sent64 = copies(adj, frontier)
            if fp is not None:
                adj = adj & alive[:, None]                 # receiver up
            cnt = hop(adj, frontier)
            if count:
                recv64 = copies(adj, frontier)
            del adj
        else:
            K = dlp.k_slots
            cnt = None
            recv64 = 0
            for lag in range(K):
                t_s = tick - lag
                fr_l = frontier if lag == 0 else state.src_ring[t_s % K]
                a_l, lnk_l, d_l = kept.get(
                    params, state.salt, t_s, tick, K,
                    lambda: (*draw_adj(params, n, t_s, state.salt, fp),
                             _delays_of(dlp, (n, n), t_s)))
                if lag == 0:
                    link = lnk_l
                    if count:
                        sent64 = copies(a_l, frontier)
                a_l = a_l & (d_l == lag + 1)               # arrives now
                if fp is not None:
                    a_l = a_l & alive[:, None]             # receiver up NOW
                term = hop(a_l, fr_l)
                cnt = term if cnt is None else cnt + term
                if count:
                    recv64 = recv64 + copies(a_l, fr_l)
                del a_l
            ring = _ring_write(state, frontier)
        heard = repack(cnt > 0.5, W)
        new_state, delivered, new = _epilogue(params, state, heard,
                                              injected, None, ring)
        if tel is None:
            return new_state, delivered
        dropped = None
        if fp is not None and link is not None:
            # two entries per undirected pair; the diagonal never drops
            dropped = (~link).sum(dtype=torch.int32) // 2
        return new_state, delivered, _frame(
            tel, ws, params, state, delivered, new,
            # the int64 counts wrapped as the reference's int32 sums wrap
            None if sent64 is None else to_i32(sent64),
            None if recv64 is None else to_i32(recv64), fp, alive,
            dropped)

    if invariants is not None:
        return _invariants.wrap_step_delivery(step, invariants,
                                              "randomsub (dense)")
    return step


# -- runners -------------------------------------------------------------------

def randomsub_run(params: RandomSubParams, state: RandomSubState,
                  n_ticks: int, step, *,
                  device: str | torch.device | None = None
                  ) -> RandomSubState:
    """Advance ``n_ticks`` ticks on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    check_on(dev, have=state.have, subscribed=params.subscribed)
    for _ in range(n_ticks):
        state = step(params, state)[0]
    return state


def randomsub_run_curve(params: RandomSubParams, state: RandomSubState,
                        n_ticks: int, step, n_msgs: int, *,
                        device: str | torch.device | None = None):
    """``randomsub_run`` collecting the per-tick delivered counts:
    ``(state, counts int32 [n_ticks, n_msgs])``, stacked once at the
    end."""
    dev = resolve_device(device)
    check_on(dev, have=state.have, subscribed=params.subscribed)
    rows = []
    for _ in range(n_ticks):
        state, delivered = step(params, state)[:2]
        rows.append(count_bits_per_position(delivered, n_msgs))
    counts = (torch.stack(rows) if rows else
              torch.zeros((0, n_msgs), dtype=torch.int32, device=dev))
    return state, counts


# -- readouts ------------------------------------------------------------------

def first_tick_matrix(state: RandomSubState, m: int) -> torch.Tensor:
    return first_tick_to_matrix(state.first_tick, m)


def reach_counts(params: RandomSubParams,
                 state: RandomSubState) -> torch.Tensor:
    return reach_counts_from_first_tick(state.first_tick,
                                        params.publish_tick.shape[0])


def reach_by_hops(params: RandomSubParams, state: RandomSubState,
                  max_hops: int) -> torch.Tensor:
    return reach_by_hops_from_first_tick(
        state.first_tick, params.publish_tick.shape[0], max_hops)
