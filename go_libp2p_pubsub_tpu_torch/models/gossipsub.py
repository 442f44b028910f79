"""GossipSub simulator, scored v1.1 and unscored v1.0 heartbeats, in
PyTorch.

Counterpart of ``go_libp2p_pubsub_tpu/models/gossipsub.py`` on its
receive-kernel path: one ``step`` advances one heartbeat for every
simulated peer — publish injection, fanout maintenance, eager forward
over mesh ∪ fanout, lazy IHAVE/IWANT gossip, graft/prune maintenance
with backoff and, with a ``ScoreSimConfig``, the P1-P7 score, the
threshold gates and the RED gater (keyed by source IP where peers share
addresses), flood publishing, and the v1.1 attack formations (IHAVE
broken-promise spam, the IWANT flood, graft flood, stealthy promise
breakers, eclipse); scored or not, operator-pinned direct peers, PX
candidate rotation over an active subset of the candidates, Bernoulli
or exact-k gossip targets, and paired topics (every peer in its class r
and r + T/2: one mesh, backoff and P1 per topic slot, one maintenance
pass per slot, slot-B flags on a second ctrl byte).  The receive half
(payload receive, handshake, counter updates, next tick's gates) is one
kernel launch (``ops/kernels/receive.py``); every random top-k selection
is one launch of the select kernel (``ops/kernels/select.py``).
Everything else is plain PyTorch, as the reference leaves it to XLA.

The unscored heartbeat also runs T ticks per launch: ``make_fused_window``
(the fused-window kernel, ``ops/kernels/fused.py``) and its runners
``gossip_run_fused`` / ``gossip_run_curve_fused``, bit-identical to T
per-tick steps.

Representation (as in the reference): peer p belongs to topic p mod T
(paired: also to p mod T + T/2, its slot B) and has C circulant
candidates p + o_c; mesh/fanout/gate masks are
packed words [N] over the candidate bits; message possession is packed
words [W, N]; per-edge counters are [C, N], peer axis last.  Packed u32
words are int32 tensors holding the u32 bits.

PyTorch idiom: params and state are dataclasses of tensors, the tick
and the run salt (the reference's ``key_data(PRNGKey(seed))[-1]``) are
host ints, and the reference's ``lax.cond`` branches are Python ``if``s
— run unconditionally where that gives the same bits (a selection with
k = 0 selects nothing), so the scored step syncs with the host once per
tick and topic slot (the prune check) and the unscored step never does.
The port runs unpadded; options outside the slice raise their named
refusal (``models/plan.py``).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..device import check_on, resolve_device
from ..ops import graph
from ..ops.graph import (
    WORD_BITS,
    count_bits_per_position,
    expand_bits,
    lane_seed,
    lane_uniform,
    pack_bits,
    pack_rows,
    popcount32,
    ranks_desc,
    select_k_by_priority_bits,
)
from ..ops.kernels import fused as kfused
from ..ops.kernels import receive as krecv
from ..ops.kernels import select as kselect
from . import plan
from ._delivery import reach_counts_from_first_tick, update_first_tick


# --------------------------------------------------------------------------
# Static configuration (own copies of the reference's dataclasses)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class GossipSimConfig:
    """Static simulator config.  Protocol defaults mirror GossipSubParams
    (reference gossipsub.go:31-59)."""

    offsets: tuple[int, ...]       # C candidate ring offsets, ± paired
    n_topics: int = 1
    px_rotation: bool = True
    paired_topics: bool = False
    d: int = 6                     # GossipSubD
    d_lo: int = 5                  # GossipSubDlo
    d_hi: int = 12                 # GossipSubDhi
    d_score: int = 4               # GossipSubDscore
    d_out: int = 2                 # GossipSubDout
    d_lazy: int = 6                # GossipSubDlazy
    gossip_factor: float = 0.25    # GossipSubGossipFactor
    history_gossip: int = 3        # GossipSubHistoryGossip (IHAVE window)
    history_length: int = 5        # GossipSubHistoryLength (mcache span)
    backoff_ticks: int = 60        # GossipSubPruneBackoff / heartbeat
    fanout_ttl_ticks: int = 60     # GossipSubFanoutTTL / heartbeat
    gossip_retransmission: int = 3   # GossipSubGossipRetransmission
    max_ihave_length: int = 5000     # GossipSubMaxIHaveLength
    max_ihave_messages: int = 10     # GossipSubMaxIHaveMessages
    binomial_gossip_sampling: bool = True

    def __post_init__(self):
        offs = np.asarray(self.offsets, dtype=np.int64)
        if len(offs) == 0 or len(set(offs.tolist())) != len(offs):
            raise ValueError("offsets must be distinct and non-empty")
        if len(offs) > 32:
            raise ValueError("at most 32 candidates (uint32 bitmasks)")
        if not all((-o) in set(offs.tolist()) for o in offs.tolist()):
            raise ValueError("offsets must be closed under negation")
        if self.paired_topics and (self.n_topics < 2
                                   or self.n_topics % 2):
            raise ValueError("paired_topics needs an even n_topics >= 2")
        modulus = (self.n_topics // 2 if self.paired_topics
                   else self.n_topics)
        if any(o % modulus for o in offs.tolist()):
            raise ValueError(
                "offsets must be multiples of n_topics"
                + ("/2 (paired mode)" if self.paired_topics else ""))
        if not (self.d_lo <= self.d <= self.d_hi):
            raise ValueError("need Dlo <= D <= Dhi (gossipsub.go:33-35)")
        if self.d_score > self.d:
            raise ValueError("need Dscore <= D")
        if self.d_out >= self.d_lo or self.d_out > self.d // 2:
            raise ValueError(
                "need Dout < Dlo and Dout <= D/2 (gossipsub.go:266-272)")
        if self.d_hi >= len(offs):
            raise ValueError("need C > Dhi candidate columns")
        if self.history_gossip > self.history_length:
            raise ValueError(
                "need HistoryGossip <= HistoryLength (gossipsub.go:47)")
        if self.gossip_retransmission < 1:
            raise ValueError("gossip_retransmission must be >= 1")
        if not (1 <= self.backoff_ticks <= 32767):
            raise ValueError(
                "backoff_ticks must fit int16 remaining-tick storage")
        if self.max_ihave_length < 1 or self.max_ihave_messages < 1:
            raise ValueError("IHAVE caps must be >= 1")

    @property
    def n_candidates(self) -> int:
        return len(self.offsets)

    @property
    def cinv(self) -> tuple[int, ...]:
        """cinv[c] = bit of the negated offset (the partner's view of
        edge bit c)."""
        idx = {o: i for i, o in enumerate(self.offsets)}
        return tuple(idx[-o] for o in self.offsets)

    @property
    def outbound_mask(self) -> int:
        """Bitmask of outbound candidate bits (positive offsets)."""
        return sum(1 << c for c, o in enumerate(self.offsets) if o > 0)


def _pack_bits_pm_np(bits: np.ndarray) -> np.ndarray:
    """Host-side bool [N, M] -> uint32 [W, N] (little-endian bit order:
    bit j of word w = column w*32 + j)."""
    n, m = bits.shape
    w = (m + WORD_BITS - 1) // WORD_BITS
    pad = w * WORD_BITS - m
    if pad:
        bits = np.concatenate(
            [bits, np.zeros((n, pad), dtype=bits.dtype)], axis=-1)
    words = np.packbits(bits.astype(np.uint8), axis=-1,
                        bitorder="little").view("<u4").astype(
                            np.uint32, copy=False)
    return np.ascontiguousarray(words.T)


def make_gossip_offsets(n_topics: int, n_candidates: int, n_peers: int,
                        seed: int = 0,
                        paired: bool = False) -> tuple[int, ...]:
    """Random ± paired circulant offsets ≡ 0 (mod n_topics)."""
    modulus = n_topics // 2 if paired else n_topics
    offs = graph.make_circulant_offsets(modulus, n_candidates, n_peers,
                                        seed=seed)
    return tuple(int(o) for o in offs)


@dataclass(frozen=True)
class ScoreSimConfig:
    """Static v1.1 hardening config: the peer-score formula (P1..P7,
    score.go:256-333), thresholds (score_params.go:12-32) and the sybil
    behaviour toggles.  Decays are per-tick factors."""

    topic_weight: float = 1.0
    topic_score_cap: float = 0.0
    time_in_mesh_weight: float = 0.1
    time_in_mesh_quantum: int = 1
    time_in_mesh_cap: float = 10.0
    first_message_deliveries_weight: float = 1.0
    first_message_deliveries_decay: float = 0.9
    first_message_deliveries_cap: float = 50.0
    mesh_message_deliveries_weight: float = 0.0
    mesh_message_deliveries_decay: float = 0.9
    mesh_message_deliveries_cap: float = 20.0
    mesh_message_deliveries_threshold: float = 1.0
    mesh_message_deliveries_activation: int = 5
    mesh_failure_penalty_weight: float = 0.0
    mesh_failure_penalty_decay: float = 0.9
    invalid_message_deliveries_weight: float = -10.0
    invalid_message_deliveries_decay: float = 0.95
    app_specific_weight: float = 1.0
    ip_colocation_factor_weight: float = -5.0
    ip_colocation_factor_threshold: float = 1.0
    behaviour_penalty_weight: float = -10.0
    behaviour_penalty_decay: float = 0.9
    behaviour_penalty_threshold: float = 0.0
    decay_to_zero: float = 0.01
    gossip_threshold: float = -10.0
    publish_threshold: float = -50.0
    graylist_threshold: float = -80.0
    opportunistic_graft_threshold: float = 1.0
    opportunistic_graft_ticks: int = 60
    opportunistic_graft_peers: int = 2
    flood_publish: bool = False
    sybil_ihave_spam: bool = False
    sybil_graft_flood: bool = False
    sybil_iwant_spam: bool = False
    sybil_eclipse: bool = False
    byzantine_mutation: bool = False
    counter_dtype: str = "bfloat16"

    @property
    def bp_dtype(self) -> str:
        """behaviour_penalty storage dtype: counter_dtype while the
        decaying counter's worst case 2/(1-decay) stays far below bf16's
        +1-absorption point, else float32."""
        if self.counter_dtype == "float32":
            return "float32"
        if 2.0 / (1.0 - self.behaviour_penalty_decay) < 128.0:
            return self.counter_dtype
        return "float32"

    @property
    def track_p3(self) -> bool:
        """P3/P3b bookkeeping is on when either weight is nonzero."""
        return (self.mesh_message_deliveries_weight != 0
                or self.mesh_failure_penalty_weight != 0)

    def validate(self) -> None:
        """The reference's sign/range invariants (score_params.go)."""
        if self.topic_weight < 0:
            raise ValueError("topic_weight must be >= 0")
        for name in ("time_in_mesh_weight", "first_message_deliveries_weight",
                     "app_specific_weight"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        for name in ("mesh_message_deliveries_weight",
                     "mesh_failure_penalty_weight",
                     "invalid_message_deliveries_weight",
                     "ip_colocation_factor_weight",
                     "behaviour_penalty_weight"):
            if getattr(self, name) > 0:
                raise ValueError(f"{name} must be <= 0")
        for name in ("first_message_deliveries_decay",
                     "mesh_message_deliveries_decay",
                     "mesh_failure_penalty_decay",
                     "invalid_message_deliveries_decay",
                     "behaviour_penalty_decay"):
            d = getattr(self, name)
            if not (0 < d < 1):
                raise ValueError(f"{name} must be in (0, 1)")
        if not (self.graylist_threshold <= self.publish_threshold
                <= self.gossip_threshold <= 0):
            raise ValueError(
                "need graylist <= publish <= gossip threshold <= 0")


# --------------------------------------------------------------------------
# Params and state: dataclasses of tensors
# --------------------------------------------------------------------------


@dataclass
class GossipParams:
    """Per-simulation tensors.  Row c, column p of a [C, N] view
    describes candidate p + o_c."""

    subscribed: torch.Tensor        # bool [N]
    cand_sub_bits: torch.Tensor     # int32 [N]: bit c = candidate subscribed
    origin_words: torch.Tensor      # int32 [W, N]: bit m set at origin[m]
    deliver_words: torch.Tensor     # int32 [W, N]: msg m counts as delivery
    publish_tick: torch.Tensor      # int32 [M]
    # the v1.1 fields, None when scoring is off
    invalid_words: torch.Tensor | None = None    # int32 [W]: msg invalid
    cand_app_score: torch.Tensor | None = None   # f32 [C, N]: P5
    cand_colo_excess: torch.Tensor | None = None  # f32 [C, N]: P6 surplus
    cand_static_score: torch.Tensor | None = None  # f32 [C, N]: P5 + P6
    static_score_weights: tuple | None = None    # (app, colocation) weight
    static_score_zero: bool = False              # baked term all zero
    cand_sybil: torch.Tensor | None = None       # bool [C, N]
    sybil: torch.Tensor | None = None            # bool [N]
    # the attack formations (None when absent): unflagged peers that
    # advertise gossip but withhold the payload (behavioural P7)
    promise_break: torch.Tensor | None = None    # bool [N]
    # eclipse attackers and their victims; bit c of cand_victim_bits[p]
    # = candidate p + o_c is a victim
    eclipse_sybil: torch.Tensor | None = None    # bool [N]
    eclipse_victim: torch.Tensor | None = None   # bool [N]
    cand_victim_bits: torch.Tensor | None = None  # int32 [N]
    # same-IP sibling words, built only when some address is shared: bit
    # c of cand_same_ip[cc, p] = candidates c and cc of p share an IP
    cand_same_ip: torch.Tensor | None = None     # int32 [C, N]
    # operator-pinned direct edges (None when absent), scored or not
    cand_direct: torch.Tensor | None = None      # int32 [N]
    # paired topics: bit m set iff msg m is peer p's second topic, the
    # one its slot-B mesh forwards (None unpaired)
    slot_b_words: torch.Tensor | None = None     # int32 [W, N]


@dataclass
class ScoreState:
    """Per-edge reputation counters, [C, N]: p's view of candidate
    p + o_c."""

    time_in_mesh: torch.Tensor        # int16 (P1)
    first_deliveries: torch.Tensor    # counter dtype (P2)
    invalid_deliveries: torch.Tensor  # counter dtype (P4)
    behaviour_penalty: torch.Tensor   # bp dtype (P7)
    time_in_mesh_b: torch.Tensor | None = None  # int16, slot B's P1


@dataclass
class GossipState:
    mesh: torch.Tensor          # int32 [N] mesh membership bitmask
    fanout: torch.Tensor        # int32 [N] publish-without-join bitmask
    last_pub: torch.Tensor      # int32 [N] last publish tick
    backoff: torch.Tensor       # int16 [C, N] remaining backoff ticks
    have: torch.Tensor          # int32 [W, N]
    recent: torch.Tensor        # int32 [Hg, W, N] mcache ring
    first_tick: torch.Tensor | None  # int16 [W, 32, N]
    scores: ScoreState | None   # None unscored
    iwant_serves: torch.Tensor | None  # int16 [C, N] IWANT-serve ledger
    gates: tuple                # 7 (2 unscored; one more paired) x
    #                             int32 [N], this tick's gate words
    gates_fp: int               # fingerprint of the gates' config
    salt: int                   # run seed, key_data(PRNGKey(seed))[-1]
    tick: int
    # PX: the candidates whose address the peer currently holds (None
    # without px_candidates)
    active: torch.Tensor | None = None   # int32 [N]
    # paired topics: the second topic slot's mesh and backoff (None
    # unpaired)
    mesh_b: torch.Tensor | None = None      # int32 [N]
    backoff_b: torch.Tensor | None = None   # int16 [C, N]


# --------------------------------------------------------------------------
# Building a sim
# --------------------------------------------------------------------------


def _words(a: np.ndarray, device) -> torch.Tensor:
    """Host uint32 words -> int32 tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32)).to(device)


def make_gossip_sim(cfg: GossipSimConfig, subs: np.ndarray,
                    msg_topic: np.ndarray, msg_origin: np.ndarray,
                    msg_publish_tick: np.ndarray, seed: int = 0,
                    track_first_tick: bool = True,
                    score_cfg: ScoreSimConfig | None = None,
                    app_score: np.ndarray | None = None,
                    peer_ip: np.ndarray | None = None,
                    sybil: np.ndarray | None = None,
                    msg_invalid: np.ndarray | None = None,
                    flood_proto=None, promise_break=None,
                    px_candidates=None, direct_edges=None,
                    pad_to_block=None, fault_schedule=None,
                    eclipse_sybil=None, eclipse_victim=None,
                    byzantine=None, score_knobs=None, sim_knobs=None,
                    delays=None, delays_split: bool = False,
                    delays_counters: bool = False,
                    delays_probe: bool = False, *,
                    device: str | torch.device | None = None):
    """Build (params, state) on ``device`` (default ``cuda``).

    subs: bool [N, T], each peer subscribed to at most its residue-class
    topic or, with ``cfg.paired_topics``, to both topics of its pair {p
    mod T, p mod T + T/2} or neither.  Without score_cfg the sim runs the
    unscored v1.0 step (state without scores; two gate words).  With it: app_score [N] f32 is P5,
    sybil [N] flags peers that forward invalid messages (and, under the
    score config's sybil toggles, spam IHAVEs, flood IWANTs or flood
    GRAFTs), msg_invalid [M] marks messages failing validation, peer_ip
    [N] is each peer's address (shared addresses feed P6 and group the
    gater's statistics by source IP), promise_break [N] flags
    unflagged peers that withhold the payloads they advertise, and
    eclipse_sybil / eclipse_victim [N] (disjoint, both or neither) are
    the eclipse formation of ``score_cfg.sybil_eclipse``.  Scored or
    not: direct_edges bool [N, C] pins operator-configured direct peers
    (symmetric: both ends configure the edge), and px_candidates (Dhi <
    px_candidates <= C) starts each peer knowing a random subset of that
    size of its candidates, which PX rotation then refreshes."""
    dev = resolve_device(device)
    plan.check_sim_options(
        flood_proto=flood_proto, pad_to_block=pad_to_block,
        fault_schedule=fault_schedule, byzantine=byzantine,
        score_knobs=score_knobs, sim_knobs=sim_knobs, delays=delays,
        delays_split=delays_split, delays_counters=delays_counters,
        delays_probe=delays_probe)
    plan.check_kernel_config(cfg, score_cfg)
    sc = score_cfg
    n, t = subs.shape
    if t != cfg.n_topics:
        raise ValueError("subs topic dim != cfg.n_topics")
    own_topic = np.arange(n) % cfg.n_topics
    m = len(msg_topic)
    if m == 0:
        plan.refuse("no_messages")
    if m > cfg.max_ihave_length:
        raise ValueError(
            f"n_msgs={m} exceeds max_ihave_length="
            f"{cfg.max_ihave_length}: the sim's one-IHAVE-per-edge "
            "advert must fit the reference cap")
    origin_bits = np.zeros((n, m), dtype=bool)
    origin_bits[msg_origin, np.arange(m)] = True
    slot_b_bits = None
    if cfg.paired_topics:
        # every participant subscribes both topics of its pair {r,
        # r + T/2}; slot B holds the second
        second = (own_topic + cfg.n_topics // 2) % cfg.n_topics
        pair = ((np.arange(t)[None, :] == own_topic[:, None])
                | (np.arange(t)[None, :] == second[:, None]))
        if (subs & ~pair).any():
            raise ValueError(
                "paired mode: peers may only subscribe to "
                "{p mod T, p mod T + T/2}")
        both = subs[np.arange(n), own_topic] & subs[np.arange(n), second]
        neither = ~(subs[np.arange(n), own_topic]
                    | subs[np.arange(n), second])
        if not (both | neither).all():
            raise ValueError("paired mode: subscribe to both topics of "
                             "the pair, or neither")
        subscribed = both
        if (~((own_topic[msg_origin] == msg_topic)
              | (second[msg_origin] == msg_topic))).any():
            raise ValueError(
                "msg origin must subscribe to the message topic")
        deliver_bits = subscribed[:, None] & (
            (own_topic[:, None] == msg_topic[None, :])
            | (second[:, None] == msg_topic[None, :]))
        # msg m rides peer p's second topic slot (forwarded on mesh_b)
        slot_b_bits = second[:, None] == msg_topic[None, :]
    else:
        cross = subs & ~(np.arange(t)[None, :] == own_topic[:, None])
        if cross.any():
            raise ValueError("peers may only subscribe to topic (p mod T)")
        subscribed = subs[np.arange(n), own_topic]
        if ((msg_origin % cfg.n_topics) != msg_topic).any():
            raise ValueError(
                "msg origin must be in the topic's residue class")
        deliver_bits = subscribed[:, None] & (own_topic[:, None]
                                              == msg_topic[None, :])

    def cand_view(per_peer):
        """out[c, p] = per_peer[p + o_c]."""
        return np.stack([np.roll(per_peer, -o) for o in cfg.offsets],
                        axis=0)

    def cand_bits(per_peer_bool):
        """Packed: bit c set iff per_peer[p + o_c]."""
        out = np.zeros(n, dtype=np.uint32)
        for c, o in enumerate(cfg.offsets):
            out |= np.roll(per_peer_bool, -o).astype(np.uint32) << c
        return out

    def t_(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    scored = {}
    if sc is None:
        if (app_score is not None or peer_ip is not None
                or sybil is not None or msg_invalid is not None):
            raise ValueError("app_score, peer_ip, sybil and msg_invalid "
                             "are v1.1 score inputs: they need score_cfg")
    else:
        sc.validate()
        app = (np.zeros(n, dtype=np.float32) if app_score is None
               else np.asarray(app_score, dtype=np.float32))
        syb = (np.zeros(n, dtype=bool) if sybil is None
               else np.asarray(sybil, dtype=bool))
        if peer_ip is None:
            peer_ip = np.arange(n)
        _, ip_idx = np.unique(np.asarray(peer_ip), return_inverse=True)
        colo_count = np.bincount(ip_idx)[ip_idx].astype(np.float32)
        colo_excess = np.maximum(
            0.0, colo_count - sc.ip_colocation_factor_threshold)
        inv = (np.zeros(m, dtype=bool) if msg_invalid is None
               else np.asarray(msg_invalid, dtype=bool))
        app_v = cand_view(app)
        colo_v = cand_view(colo_excess)
        same_ip = None
        if (colo_count > 1).any():
            # shared addresses: the same-IP sibling masks for the
            # gater's per-IP grouping
            ips_v = cand_view(ip_idx)
            same = np.zeros((cfg.n_candidates, n), dtype=np.uint32)
            for c2 in range(cfg.n_candidates):
                same |= (ips_v == ips_v[c2][None, :]).astype(
                    np.uint32) << c2
            same_ip = _words(same, dev)
        static = (sc.app_specific_weight * app_v
                  + sc.ip_colocation_factor_weight * colo_v * colo_v)
        scored = dict(
            cand_same_ip=same_ip,
            invalid_words=_words(_pack_bits_pm_np(inv[None, :])[:, 0],
                                 dev),
            cand_app_score=t_(app_v.astype(np.float32)),
            cand_colo_excess=t_(colo_v.astype(np.float32)),
            cand_static_score=t_(static.astype(np.float32)),
            static_score_weights=(sc.app_specific_weight,
                                  sc.ip_colocation_factor_weight),
            static_score_zero=bool(not app_v.any() and not colo_v.any()),
            cand_sybil=t_(cand_view(syb)),
            sybil=t_(syb))
    direct_packed = None
    if direct_edges is not None:
        de = np.asarray(direct_edges, dtype=bool)
        if de.shape != (n, cfg.n_candidates):
            raise ValueError("direct_edges must be bool [N, C]")
        # both ends configure a direct edge: de[p, c] == de[p + o_c,
        # cinv_c]
        for c, o in enumerate(cfg.offsets):
            if not (de[:, c] == np.roll(de[:, cfg.cinv[c]], -o)).all():
                raise ValueError(
                    "direct_edges must be symmetric: peer p's bit c "
                    "and peer p+o_c's bit cinv[c] describe one edge")
        direct_packed = np.zeros(n, dtype=np.uint32)
        for c in range(cfg.n_candidates):
            direct_packed |= de[:, c].astype(np.uint32) << c
        scored["cand_direct"] = _words(direct_packed, dev)
    if promise_break is not None:
        if sc is None:
            raise ValueError("promise_break requires score_cfg (P7)")
        scored["promise_break"] = t_(np.asarray(promise_break, dtype=bool))
    if eclipse_sybil is not None or eclipse_victim is not None:
        if sc is None:
            raise ValueError("eclipse_sybil/eclipse_victim require "
                             "score_cfg (the defense under test)")
        if eclipse_sybil is None or eclipse_victim is None:
            raise ValueError("eclipse formations need BOTH "
                             "eclipse_sybil and eclipse_victim")
        es = np.asarray(eclipse_sybil, dtype=bool)
        ev = np.asarray(eclipse_victim, dtype=bool)
        if (es & ev).any():
            raise ValueError(
                "eclipse_sybil and eclipse_victim must be disjoint "
                "(an attacker cannot eclipse itself)")
        scored.update(eclipse_sybil=t_(es), eclipse_victim=t_(ev),
                      cand_victim_bits=_words(cand_bits(ev), dev))

    params = GossipParams(
        subscribed=t_(subscribed),
        cand_sub_bits=_words(cand_bits(subscribed), dev),
        origin_words=_words(_pack_bits_pm_np(origin_bits), dev),
        deliver_words=_words(_pack_bits_pm_np(deliver_bits), dev),
        publish_tick=t_(np.asarray(msg_publish_tick, dtype=np.int32)),
        slot_b_words=(None if slot_b_bits is None
                      else _words(_pack_bits_pm_np(slot_b_bits), dev)),
        **scored)
    w = params.origin_words.shape[0]
    c = cfg.n_candidates
    i16 = lambda: torch.zeros((c, n), dtype=torch.int16, device=dev)  # noqa: E731
    zbits = lambda: torch.zeros((n,), dtype=torch.int32, device=dev)  # noqa: E731
    active0 = None
    if px_candidates is not None:
        if not (cfg.d_hi < px_candidates <= c):
            raise ValueError("need Dhi < px_candidates <= C")
        # each peer starts knowing a random px_candidates-subset of its
        # pool (the reference's draw: its own generator, 65,536-peer
        # chunks)
        rng0 = np.random.default_rng(seed ^ 0x5F3759DF)
        act = np.zeros(n, dtype=np.uint32)
        for lo in range(0, n, 1 << 16):
            hi = min(n, lo + (1 << 16))
            rows = np.argsort(rng0.random((hi - lo, c)),
                              axis=1)[:, :px_candidates]
            bits = np.zeros((hi - lo,), dtype=np.uint32)
            for j in range(px_candidates):
                bits |= np.uint32(1) << rows[:, j].astype(np.uint32)
            act[lo:hi] = bits
        if direct_packed is not None:
            # direct peers are operator-pinned addresses: always held
            act |= direct_packed
        active0 = _words(act, dev)
    scores = None
    paired = cfg.paired_topics
    if sc is not None:
        cdt = krecv.DTYPES[sc.counter_dtype]
        scores = ScoreState(
            time_in_mesh=i16(),
            first_deliveries=torch.zeros((c, n), dtype=cdt, device=dev),
            invalid_deliveries=torch.zeros((c, n), dtype=cdt, device=dev),
            behaviour_penalty=torch.zeros(
                (c, n), dtype=krecv.DTYPES[sc.bp_dtype], device=dev),
            time_in_mesh_b=i16() if paired else None)
    state = GossipState(
        mesh=zbits(), fanout=zbits(),
        last_pub=torch.full((n,), -(10 ** 9), dtype=torch.int32,
                            device=dev),
        backoff=i16(),
        have=torch.zeros((w, n), dtype=torch.int32, device=dev),
        recent=torch.zeros((cfg.history_gossip, w, n), dtype=torch.int32,
                           device=dev),
        first_tick=(torch.full((w, WORD_BITS, n), -1, dtype=torch.int16,
                               device=dev) if track_first_tick else None),
        scores=scores, iwant_serves=None if sc is None else i16(),
        gates=(), gates_fp=0,
        salt=seed & graph.MASK32, tick=0, active=active0,
        mesh_b=zbits() if paired else None,
        backoff_b=i16() if paired else None)
    # seed the gate pipeline: tick 0's gate words
    return params, refresh_gates(cfg, sc, params, state)


# --------------------------------------------------------------------------
# Scores and gates
# --------------------------------------------------------------------------


def _static_term(sc: ScoreSimConfig, params: GossipParams):
    """The baked P5+P6 term, or None when it is identically zero."""
    if params.static_score_zero:
        return None
    if params.static_score_weights != (sc.app_specific_weight,
                                       sc.ip_colocation_factor_weight):
        plan.refuse("reweighted_static")
    return params.cand_static_score


def compute_scores(sc: ScoreSimConfig, params: GossipParams,
                   st: GossipState,
                   cols: torch.Tensor | None = None) -> torch.Tensor:
    """The peer-score formula, densified: f32 [C, N] — peer p's opinion
    of candidate p + o_c (score.go:256-333).  ``cols`` (int64 peer
    indices) computes only those columns."""
    s = st.scores

    def g(x):
        return x if cols is None else x.index_select(1, cols)

    static = _static_term(sc, params)
    return krecv.score_from_counters(
        krecv.score_consts(sc), g(s.time_in_mesh).to(torch.float32),
        g(s.first_deliveries).to(torch.float32),
        g(s.invalid_deliveries).to(torch.float32),
        g(s.behaviour_penalty).to(torch.float32),
        None if static is None else g(static),
        tim_b=(None if s.time_in_mesh_b is None
               else g(s.time_in_mesh_b).to(torch.float32)))


def gates_fingerprint(cfg: GossipSimConfig,
                      sc: ScoreSimConfig | None) -> int:
    """Stable fingerprint of the scalar config fields the carried gate
    words depend on (the reference's, field for field)."""
    def scalars(obj):
        return tuple(
            (f.name, getattr(obj, f.name)) for f in fields(obj)
            if isinstance(getattr(obj, f.name),
                          (bool, int, float, str, type(None))))

    desc = (("C", cfg.n_candidates),
            ("offsets", tuple(int(o) for o in cfg.offsets)),
            scalars(cfg), None if sc is None else scalars(sc))
    return zlib.crc32(repr(desc).encode())


def gossip_targets_row(cfg: GossipSimConfig, sc: ScoreSimConfig | None,
                       params: GossipParams, *, mesh, fanout, active,
                       gossip_row, tick: int, salt: int,
                       mesh_b=None) -> torch.Tensor:
    """The lazy-gossip targets gate row: Bernoulli(k/|elig|), or the
    exact uniform k-subset (``binomial_gossip_sampling=False``), over
    the non-mesh subscribed candidates (under PX: the ``active`` ones;
    paired: one selection shared by both topic slots, outside either
    mesh; scored: above the gossip threshold, ``gossip_row``), k = max(Dlazy,
    factor * |elig|) (emitGossip gossipsub.go:1656-1712);
    IHAVE-spamming sybils target every subscribed candidate
    (gossipsub_spam_test.go:135).  Shared by compute_gates and the
    step's PX epilogue, which re-emits the row from the rotated active
    set."""
    k = krecv.receive_consts(cfg, sc)
    all_c = (1 << cfg.n_candidates) - 1
    sub_all = torch.where(params.subscribed, all_c, 0).to(torch.int32)
    elig = params.cand_sub_bits & ~mesh & ~fanout & sub_all
    if active is not None:
        elig = elig & active
    if mesh_b is not None:
        elig = elig & ~mesh_b
    if gossip_row is not None:
        elig = elig & gossip_row
    targets = krecv.targets_row(k, elig, lane_seed(tick, 1, salt),
                                mesh.shape[0])
    if sc is not None and sc.sybil_ihave_spam:
        targets = torch.where(params.sybil, params.cand_sub_bits, targets)
    return targets


def compute_gates(cfg: GossipSimConfig, sc: ScoreSimConfig | None,
                  params: GossipParams, st: GossipState,
                  salt: int) -> tuple:
    """The packed gate words for ``st.tick`` (tuple of int32 [N]) — the
    reference's compute_gates rows: scored, accept, gossip, publish,
    nonneg, payload (accept ∧ RED gater), targets, backoff; unscored,
    targets and backoff; paired, slot B's backoff last.  Where
    candidates share addresses the gater's goodput is keyed by source IP
    (``params.cand_same_ip``)."""
    bo_b = (() if st.backoff_b is None
            else (pack_rows(st.backoff_b > 0),))
    if sc is None:
        return (gossip_targets_row(cfg, None, params, mesh=st.mesh,
                                   fanout=st.fanout, active=st.active,
                                   gossip_row=None, tick=st.tick,
                                   salt=salt, mesh_b=st.mesh_b),
                pack_rows(st.backoff > 0), *bo_b)
    k = krecv.receive_consts(cfg, sc)
    n = st.mesh.shape[0]
    score = compute_scores(sc, params, st)
    accept = pack_rows(score >= k.gray_thr)
    gossip = pack_rows(score >= k.gossip_thr)
    rows = [accept, gossip, pack_rows(score >= k.publish_thr),
            pack_rows(score >= 0)]
    s0 = st.scores
    gater = krecv.gater_row(s0.first_deliveries.to(torch.float32),
                            s0.invalid_deliveries.to(torch.float32),
                            lane_seed(st.tick, 6, salt), n,
                            same_ip=params.cand_same_ip)
    rows.append(accept & gater)
    rows.append(gossip_targets_row(cfg, sc, params, mesh=st.mesh,
                                   fanout=st.fanout, active=st.active,
                                   gossip_row=gossip, tick=st.tick,
                                   salt=salt, mesh_b=st.mesh_b))
    rows.append(pack_rows(st.backoff > 0))
    return (*rows, *bo_b)


def px_rotate(cfg: GossipSimConfig, params: GossipParams, *, active, rot,
              keep, sel_k) -> torch.Tensor:
    """PX-driven candidate refresh (gossipsub.go:856-937): the edges in
    ``rot`` (received PRUNEs and PRUNE-responses, own negative-score
    drops) leave the active set and as many fresh pool candidates are
    dialed in (``sel_k`` at phase 7, drawn for every peer: k = 0 selects
    nothing); edges in ``keep`` (mesh, fanout) and pinned direct peers
    are never deactivated and fold in."""
    all_c = (1 << cfg.n_candidates) - 1
    if params.cand_direct is not None:
        keep = keep | params.cand_direct
    deact = rot & active & ~keep
    pool_new = ~active & ~keep & params.cand_sub_bits & all_c
    repl = sel_k(pool_new, popcount32(deact), 7)
    return (active & ~deact) | repl | keep


def refresh_gates(cfg: GossipSimConfig, sc: ScoreSimConfig | None,
                  params: GossipParams, st: GossipState) -> GossipState:
    """Recompute the carried gate words (after building a state, or
    after editing any field they read)."""
    return replace(st, gates=compute_gates(cfg, sc, params, st, st.salt),
                   gates_fp=gates_fingerprint(cfg, sc))


# --------------------------------------------------------------------------
# The step
# --------------------------------------------------------------------------


def _prunes(cfg: GossipSimConfig, sc: ScoreSimConfig,
            params: GossipParams, state: GossipState,
            mesh_ng: torch.Tensor, deg: torch.Tensor,
            phase: int) -> torch.Tensor:
    """Prune to D where deg > Dhi: keep the Dscore best by score, then
    at least Dout outbound, random fill to D (v1.1, gossipsub.go:
    1376-1435), on the lane stream of ``phase``.  Per-peer independent,
    so computed on the columns of the over-subscribed peers only — the
    step's host sync, one per topic slot."""
    C = cfg.n_candidates
    idx = torch.nonzero(deg > cfg.d_hi).flatten()
    prunes = torch.zeros_like(mesh_ng)
    if idx.numel() == 0:
        return prunes
    n = mesh_ng.shape[0]
    score = compute_scores(sc, params, state, cols=idx)
    rnd = lane_uniform((C, n), state.tick, phase, state.salt, stride=n,
                       device=mesh_ng.device, cols=idx)
    m_s = mesh_ng.index_select(0, idx)
    top = select_k_by_priority_bits(m_s, score,
                                    torch.full_like(m_s, cfg.d_score),
                                    tiebreak=rnd)
    out = cfg.outbound_mask
    need_out = (cfg.d_out - popcount32(top & out)).clamp(min=0)
    taken = top | select_k_by_priority_bits(m_s & ~top & out, rnd,
                                            need_out)
    fill = select_k_by_priority_bits(
        m_s & ~taken, rnd, (cfg.d - popcount32(taken)).clamp(min=0))
    prunes[idx] = m_s & ~(taken | fill)
    return prunes


def _opportunistic(sc: ScoreSimConfig, params: GossipParams,
                   state: GossipState, mesh_ng: torch.Tensor,
                   deg: torch.Tensor, can_graft: torch.Tensor):
    """Opportunistic grafting (gossipsub.go:1467-1498): where the mesh's
    median score is below the threshold, up to opportunistic_graft_peers
    graftable candidates scoring above the median.  Returns the
    selection's (eligible bits, k)."""
    C = state.backoff.shape[0]
    score = compute_scores(sc, params, state)
    in_mesh = expand_bits(mesh_ng, C)
    # median = the mesh bit at descending rank C-1-deg//2 (non-mesh bits
    # pinned to +inf rank first); one pick per peer with deg > 0, so
    # the sum over C is exact in any order
    mesh_rank = ranks_desc(torch.where(in_mesh, score, torch.inf))
    med_pick = in_mesh & (mesh_rank == (C - 1 - deg // 2)[None, :])
    median = torch.where(deg > 0,
                         torch.where(med_pick, score, 0.0).sum(0), 0.0)
    og_row = (median < sc.opportunistic_graft_threshold) & params.subscribed
    og_elig = can_graft & pack_rows(score > median[None, :])
    og_need = torch.where(og_row, sc.opportunistic_graft_peers, 0)
    return og_elig, og_need.to(torch.int32)


#: the lane phases of each topic slot's graft, prune and opportunistic
#: graft draws: slot A, and slot B under paired topics
SLOT_PHASES = ((2, 3, 5), (12, 13, 15))


def maintain_slot(cfg: GossipSimConfig, sc: ScoreSimConfig | None,
                  params: GossipParams, state: GossipState, slot: int, *,
                  sub_all: torch.Tensor,
                  accept_bits: torch.Tensor | None) -> dict:
    """One topic slot's heartbeat maintenance selections on the
    start-of-tick state (gossipsub.go:1299-1552): scored, negative-score
    drops, graft to D below Dlo, score-ranked prune to D above Dhi,
    opportunistic graft every opportunistic_graft_ticks, then the
    graft-flood and eclipse graft overrides; unscored (v1.0), graft to D
    below Dlo, random prune to D above Dhi.  ``slot`` 0 is the mesh and
    backoff of the peer's own topic, 1 (paired topics) those of its
    second, each on its own lane phases (``SLOT_PHASES``).  Returns the
    words the handshake needs: grafts, dropped, neg (scored), mesh_sel,
    backoff_bits2, would_accept, a_sent.  ``sub_all`` and (scored)
    ``accept_bits``, the accept gate row with the direct peers let
    through, are the step's own.  Scored, one host sync (the prune)."""
    C = cfg.n_candidates
    n = params.subscribed.shape[0]
    tick, salt = state.tick, state.salt
    ph_graft, ph_prune, ph_og = SLOT_PHASES[slot]
    mesh0 = state.mesh_b if slot else state.mesh
    # the slot's backoff gate row: row 6 scored / 1 unscored, slot B's
    # last
    bo_row0 = state.gates[-1] if slot else state.gates[6 if sc else 1]
    cand_sub = params.cand_sub_bits
    direct, active = params.cand_direct, state.active

    def sel_k(elig, kk, phase):
        return kselect.select_k_bits(elig, kk, C,
                                     lane_seed(tick, phase, salt), n)

    neg = None
    mesh_ng = mesh0
    if sc is not None:
        nonneg_bits = state.gates[3]
        neg = mesh0 & ~nonneg_bits
        mesh_ng = mesh0 & nonneg_bits
    deg = popcount32(mesh_ng)
    can_graft = cand_sub & ~mesh_ng & ~bo_row0 & sub_all
    if direct is not None:
        # never GRAFT at a direct peer (gossipsub.go:1340-1345)
        can_graft = can_graft & ~direct
    if active is not None:
        can_graft = can_graft & active
    if sc is not None:
        can_graft = can_graft & nonneg_bits
    need = torch.where(deg < cfg.d_lo, cfg.d - deg, 0).to(torch.int32)
    grafts = sel_k(can_graft, need, ph_graft)
    if sc is None:
        # v1.0 random retention of D where deg > Dhi, drawn for every
        # peer (no host sync; masked to the over-full ones)
        keep = sel_k(mesh_ng, torch.full_like(deg, cfg.d), ph_prune)
        prunes = torch.where(deg > cfg.d_hi, mesh_ng & ~keep, 0)
    else:
        prunes = _prunes(cfg, sc, params, state, mesh_ng, deg, ph_prune)
        if tick % sc.opportunistic_graft_ticks == 0:
            grafts = grafts | sel_k(
                *_opportunistic(sc, params, state, mesh_ng, deg,
                                can_graft & ~grafts), ph_og)
        if sc.sybil_graft_flood:
            # GRAFT-flooding sybils re-graft every tick, ignoring their
            # own backoff (gossipsub_spam_test.go:349)
            grafts = torch.where(params.sybil, cand_sub & ~mesh_ng, grafts)
        if sc.sybil_eclipse and params.eclipse_sybil is not None:
            # eclipse attackers GRAFT at every subscribed victim
            # candidate every tick, ignoring their own backoff
            grafts = torch.where(
                params.eclipse_sybil,
                params.cand_victim_bits & cand_sub & ~mesh_ng, grafts)
    mesh_sel = (mesh_ng | grafts) & ~prunes
    dropped = prunes if neg is None else prunes | neg
    backoff_bits2 = bo_row0 | dropped
    would_accept = sub_all & ~backoff_bits2
    if direct is not None:
        # a GRAFT from a direct peer is answered with a PRUNE
        # (gossipsub.go:737-745)
        would_accept = would_accept & ~direct
    if sc is not None:
        would_accept = would_accept & nonneg_bits
        a_sent = would_accept | ~accept_bits
    else:
        a_sent = would_accept
    return dict(grafts=grafts, dropped=dropped, neg=neg, mesh_sel=mesh_sel,
                backoff_bits2=backoff_bits2, would_accept=would_accept,
                a_sent=a_sent)


def make_gossip_step(cfg: GossipSimConfig,
                     score_cfg: ScoreSimConfig | None = None, *,
                     device: str | torch.device | None = None,
                     force_split: bool = False,
                     pipeline_gates: bool = True, shard_mesh=None,
                     telemetry=None, rpc_probe: bool = False,
                     invariants=None):
    """Build ``step(params, state) -> (state, delivered_words)``.

    Per tick: 1. inject due publishes; 1b. fanout TTL and refill;
    2. eager forward over mesh ∪ fanout; 3. lazy gossip over this
    tick's target row; 4. maintenance selections (``maintain_slot``;
    paired topics, one pass per topic slot); then the receive kernel
    resolves the exchange and emits next tick's gates.

    Paired topics (``cfg.paired_topics``): each sender's fresh words
    split by its slot (slot-B messages forward on ``mesh_b``; an
    unsubscribed peer sends everything on the slot-A/fanout path), slot
    B's forwards and handshake ride a second ctrl byte, PX keeps both
    meshes and rotates both slots' negative-score drops out, and one
    gossip selection serves both slots outside either mesh.

    Direct peers (``params.cand_direct``) bypass the graylist and the
    gater, are always forwarded to, never grafted, and answer a GRAFT
    with a PRUNE.  Under PX (``state.active``) fanout and grafts draw
    from the active candidates only; after the kernel, the pruned
    addresses rotate out of the active set (``px_rotate``, from the
    kernel's ``px_rot`` word) and the targets gate row is re-emitted
    from the rotated set.  With ``flood_publish`` a peer's own due
    publishes also go to every candidate above the publish threshold
    (CTRL_FLOOD).

    Attacks (scored, in the reference kernel path's order): eclipse
    attackers forward and advertise nothing; IHAVE-spamming sybils and
    promise breakers advertise (CTRL_ADV) without delivering (CTRL_TGT),
    so the receiver's kernel charges the broken promise to P7; the
    sybil word carries the IHAVE targets override and the IWANT-flood
    serve accrual into the kernel.
    """
    dev = resolve_device(device)
    plan.check_paired_step(cfg, score_cfg, force_split)
    plan.check_step_options(force_split=force_split,
                            pipeline_gates=pipeline_gates,
                            shard_mesh=shard_mesh, telemetry=telemetry,
                            rpc_probe=rpc_probe, invariants=invariants)
    krecv.receive_consts(cfg, score_cfg)     # the options' refusals
    consts = {}

    def kernel_consts(**variant):
        """The receive constants of what this sim carries: promise
        breakers (the receiver tracks promises), an active set (PX),
        same-IP sibling words."""
        key = tuple(sorted(variant.items()))
        if key not in consts:
            consts[key] = krecv.receive_consts(cfg, score_cfg, **variant)
        return consts[key]

    sc = score_cfg
    C = cfg.n_candidates
    ALL = (1 << C) - 1
    Hg = cfg.history_gossip
    step_fp = gates_fingerprint(cfg, sc)
    paired = cfg.paired_topics
    n_gates = krecv.n_gates(sc is not None, paired)

    def step(params: GossipParams, state: GossipState):
        check_on(dev, subscribed=params.subscribed, mesh=state.mesh)
        if len(state.gates) != n_gates:
            raise ValueError(
                f"state carries {len(state.gates)} gate words, the step "
                f"expects {n_gates}: refresh_gates first")
        if state.gates_fp != step_fp:
            raise ValueError(
                "state's carried gates were emitted under a different "
                "(cfg, score_cfg) than this step's — refresh_gates with "
                "the new config before stepping")
        tick, salt = state.tick, state.salt
        sub = params.subscribed
        n = sub.shape[0]
        sub_all = torch.where(sub, ALL, 0).to(torch.int32)
        cand_sub = params.cand_sub_bits
        direct, active = params.cand_direct, state.active
        if sc is not None:
            (accept_bits, gossip_bits, pub_ok_bits, _, payload_bits,
             targets, _) = state.gates[:7]
            if direct is not None:
                # direct peers bypass the graylist and the gater for
                # control and payload (AcceptFrom gossipsub.go:578)
                accept_bits = accept_bits | direct
                payload_bits = payload_bits | direct
            valid = ~params.invalid_words                   # [W]
        else:
            targets, accept_bits = state.gates[0], None

        def sel_k(elig, kk, phase):
            return kselect.select_k_bits(elig, kk, C,
                                         lane_seed(tick, phase, salt), n)

        # -- 1. publish injection
        due = pack_bits(params.publish_tick == tick)        # [W]
        injected = params.origin_words & due[:, None] & ~state.have
        publishing = (injected != 0).any(0)

        # -- 1b. fanout TTL + refill (own publishes only; scored: above
        # the publish threshold)
        last_pub = torch.where(publishing, tick, state.last_pub)
        alive = ~sub & ((tick - last_pub) < cfg.fanout_ttl_ticks)
        fanout = torch.where(alive, state.fanout, 0)
        f_need = torch.where(alive, cfg.d - popcount32(fanout), 0)
        f_elig = cand_sub & ~fanout
        if direct is not None:
            # direct peers receive everything anyway
            f_elig = f_elig & ~direct
        if active is not None:
            f_elig = f_elig & active
        if sc is not None:
            f_elig = f_elig & pub_ok_bits
        fanout = fanout | sel_k(f_elig, f_need.to(torch.int32), 4)

        # -- 2. eager-forward and 3. advert words (scored: honest peers
        # drop invalid messages; sybils forward them)
        fresh = state.recent[(tick - 1) % Hg] | injected
        adv = injected
        for h in range(Hg):
            adv = adv | state.recent[h]
        if sc is not None:
            syb = params.sybil[None, :]
            fresh = torch.where(syb, fresh, fresh & valid[:, None])
            adv = torch.where(syb, adv, adv & valid[:, None])
        fresh_b = None
        if paired:
            # split by the sender's topic slot: slot-B messages forward
            # on mesh_b; unsubscribed (fanout-only) peers send all they
            # have on the slot-A/fanout path (gossipsub.go:989-999)
            slot_b = params.slot_b_words
            fresh_b = fresh & slot_b
            fresh = torch.where(sub[None, :], fresh & ~slot_b, fresh)
        out_bits = state.mesh | fanout
        if direct is not None:
            # always eager-forward targets (gossipsub.go:945-950)
            out_bits = out_bits | (direct & cand_sub)
        # own publishes flood to every candidate above the publish
        # threshold (gossipsub.go:953-959); the bits are raised only by
        # a peer that publishes this tick (another sender's injected
        # words are zero), so the kernel reads the injected stream over
        # the few edges that carry it
        flood_bits = (torch.where(publishing, cand_sub & pub_ok_bits, 0)
                      if sc is not None and sc.flood_publish else None)
        seen = state.have | injected
        eclipse = (sc is not None and sc.sybil_eclipse
                   and params.eclipse_sybil is not None)
        if eclipse:
            # eclipse attackers are silent occupiers: inside a victim's
            # mesh they forward, advertise and flood nothing
            out_bits = torch.where(params.eclipse_sybil, 0, out_bits)
            targets = torch.where(params.eclipse_sybil, 0, targets)
            if flood_bits is not None:
                flood_bits = torch.where(params.eclipse_sybil, 0,
                                         flood_bits)
        # promise withholding: these peers advertise but never deliver;
        # the receiver derives the broken promise (behavioural P7)
        withhold = None
        if sc is not None and sc.sybil_ihave_spam:
            withhold = params.sybil
        if sc is not None and params.promise_break is not None:
            withhold = (params.promise_break if withhold is None
                        else withhold | params.promise_break)

        # -- 4. maintenance selections (start-of-tick state only), one
        # pass per topic slot
        sel = maintain_slot(cfg, sc, params, state, 0, sub_all=sub_all,
                            accept_bits=accept_bits)
        sel_b = (maintain_slot(cfg, sc, params, state, 1, sub_all=sub_all,
                               accept_bits=accept_bits)
                 if paired else None)

        # -- the receive kernel: exchange, handshake, counters, gates;
        # the raw advert (CTRL_ADV) against the delivering one (CTRL_TGT)
        # is the broken promise the receiver sees
        tgt_deliver = (targets if withhold is None
                       else torch.where(withhold, 0, targets))
        ctrl = krecv.ctrl_bytes(C, out=out_bits, tgt=tgt_deliver,
                                graft=sel["grafts"], drop=sel["dropped"],
                                a=sel["a_sent"], adv=targets,
                                flood=flood_bits)
        ops = dict(
            gseeds=(lane_seed(tick + 1, 6, salt),
                    lane_seed(tick + 1, 1, salt)),
            ctrl=ctrl, fresh=fresh, adv=adv, sub_all=sub_all,
            cand_sub=cand_sub, fanout=fanout, wa=sel["would_accept"],
            grafts=sel["grafts"], dropped=sel["dropped"],
            meshsel=sel["mesh_sel"], seen=seen, injected=injected,
            backoff=state.backoff)
        if sc is not None:
            s0 = state.scores
            ops.update(
                valid=valid, pay=payload_bits, gsp=gossip_bits,
                acc=accept_bits, bo2=sel["backoff_bits2"],
                static=_static_term(sc, params), fd=s0.first_deliveries,
                inv=s0.invalid_deliveries, bp=s0.behaviour_penalty,
                tim=s0.time_in_mesh, iws=state.iwant_serves)
        if paired:
            # slot B's sender flags on a second ctrl byte: its eager
            # forwards (direct peers on every topic; eclipse attackers
            # silent) and its handshake
            out_b = state.mesh_b
            if direct is not None:
                out_b = out_b | (direct & cand_sub)
            if eclipse:
                out_b = torch.where(params.eclipse_sybil, 0, out_b)
            ops.update(
                ctrl2=krecv.ctrl2_bytes(C, out_b=out_b,
                                        graft_b=sel_b["grafts"],
                                        drop_b=sel_b["dropped"],
                                        a_b=sel_b["a_sent"]),
                fresh_b=fresh_b, wa_b=sel_b["would_accept"],
                grafts_b=sel_b["grafts"], dropped_b=sel_b["dropped"],
                meshsel_b=sel_b["mesh_sel"], backoff_b=state.backoff_b)
            if sc is not None:
                ops.update(bo2_b=sel_b["backoff_bits2"],
                           tim_b=state.scores.time_in_mesh_b)
        variant = {}
        if sc is not None and params.promise_break is not None:
            variant["promise_break"] = True
        if active is not None:
            variant["px"] = True
        if params.cand_same_ip is not None:
            variant["same_ip"] = True
        kk = kernel_consts(**variant)
        if kk.flood_publish:
            # the injected words once more, as a sender stream
            ops["inj_send"] = injected
        if kk.with_same_ip:
            ops["same_ip"] = params.cand_same_ip
        if kk.attacks:
            # the sybil word: the IHAVE targets override and the IWANT
            # flood's receivers
            spam = sc.sybil_ihave_spam or sc.sybil_iwant_spam
            ops["syb"] = (torch.where(params.sybil, ALL, 0).to(torch.int32)
                          if spam else torch.zeros_like(sub_all))
        outs = iter(krecv.receive_update(kk, **ops))
        acq, mesh_new = next(outs), next(outs)
        mesh_b_new = next(outs) if paired else None
        backoff_new = next(outs)
        backoff_b_new = next(outs) if paired else None
        gates_new = tuple(next(outs) for _ in range(n_gates))
        scores = iws_o = None
        if sc is not None:
            fd_o, inv_o, bp_o, tim_o = (next(outs) for _ in range(4))
            tim_b_o = next(outs) if paired else None
            iws_o = next(outs)
            scores = ScoreState(time_in_mesh=tim_o, first_deliveries=fd_o,
                                invalid_deliveries=inv_o,
                                behaviour_penalty=bp_o,
                                time_in_mesh_b=tim_b_o)

        # -- PX: rotate the pruned addresses out of the active set, then
        # re-emit the targets gate row from the rotated set (the kernel
        # wrote its row before the rotation was known)
        if active is not None:
            px_word = next(outs)
            if cfg.px_rotation:
                # both slots' negative-score drops rotate out; both
                # slots' meshes stay
                rot = px_word
                for s_ in (sel, sel_b):
                    if s_ is not None and s_["neg"] is not None:
                        rot = rot | s_["neg"]
                keep = mesh_new | fanout
                if paired:
                    keep = keep | mesh_b_new
                active = px_rotate(cfg, params, active=active, rot=rot,
                                   keep=keep, sel_k=sel_k)
            i_tgt = 5 if sc is not None else 0
            tgt_new = gossip_targets_row(
                cfg, sc, params, mesh=mesh_new, fanout=fanout,
                active=active,
                gossip_row=gates_new[1] if sc is not None else None,
                tick=tick + 1, salt=salt, mesh_b=mesh_b_new)
            gates_new = (*gates_new[:i_tgt], tgt_new,
                         *gates_new[i_tgt + 1:])

        # -- epilogue: possession, mcache ring, deliveries, tick
        recent = state.recent.clone()
        recent[tick % Hg] = acq
        delivered_now = acq & params.deliver_words
        if sc is not None:
            delivered_now = delivered_now & ~params.invalid_words[:, None]
        new_state = GossipState(
            mesh=mesh_new, fanout=fanout, last_pub=last_pub,
            backoff=backoff_new, have=state.have | acq, recent=recent,
            first_tick=update_first_tick(state.first_tick, delivered_now,
                                         tick),
            scores=scores, iwant_serves=iws_o, gates=gates_new,
            gates_fp=state.gates_fp, salt=salt, tick=tick + 1,
            active=active, mesh_b=mesh_b_new, backoff_b=backoff_b_new)
        return new_state, delivered_now

    return step


# --------------------------------------------------------------------------
# Runners and readouts
# --------------------------------------------------------------------------


def make_fused_window(cfg: GossipSimConfig,
                      score_cfg: ScoreSimConfig | None = None, *,
                      ticks_fused: int = 8,
                      device: str | torch.device | None = None,
                      telemetry=None, shard_mesh=None):
    """Build ``window(params, state) -> (state, delivered)``: T =
    ``ticks_fused`` unscored ticks in ONE launch of the fused kernel
    (``ops/kernels/fused.py``), the carry read and written once per
    window.  ``delivered`` is int32 [T, W, N] — row t is tick
    ``state.tick + t``'s delivered words.  Bit-identical to T per-tick
    steps of ``make_gossip_step(cfg, None)``, with Bernoulli or exact-k
    gossip targets; a sim with PX or direct peers is refused by name.

    On the host the window computes the T x 4 lane seeds; the T due
    words are computed on the device, so a window never syncs with the
    host.  A window the port does not run raises its named refusal
    (``plan.check_fused_window``; on the card, ``fused_grid`` from the
    launch) — there is no per-tick fallback."""
    dev = resolve_device(device)
    T = int(ticks_fused)
    plan.check_fused_window(cfg, score_cfg, T, telemetry=telemetry,
                            shard_mesh=shard_mesh)
    k = kfused.fused_consts(cfg)
    all_c = (1 << cfg.n_candidates) - 1
    step_fp = gates_fingerprint(cfg, None)

    def window(params: GossipParams, state: GossipState):
        check_on(dev, subscribed=params.subscribed, mesh=state.mesh)
        plan.check_fused_operands(params, state)
        if len(state.gates) != krecv.N_GATES_UNSCORED:
            raise ValueError(
                f"state carries {len(state.gates)} gate words, the "
                f"unscored window expects {krecv.N_GATES_UNSCORED}: the "
                "state was built for a scored config")
        if state.gates_fp != step_fp:
            raise ValueError(
                "state's carried gates were emitted under a different "
                "(cfg, score_cfg) than this window's — refresh_gates "
                "with the new config first")
        tick0 = state.tick
        ticks = torch.arange(tick0, tick0 + T, dtype=torch.int32,
                             device=dev)
        due = pack_bits(params.publish_tick[None, :] == ticks[:, None])
        (have, recent, mesh, fanout, last_pub, backoff, tgt, bog,
         acq) = kfused.fused_gossip_update(
            k, tick0=tick0, seeds=kfused.window_seeds(tick0, T, state.salt),
            due=due,
            sub_all=torch.where(params.subscribed, all_c, 0).to(
                torch.int32),
            cand_sub=params.cand_sub_bits, origin=params.origin_words,
            have=state.have, recent=state.recent, mesh=state.mesh,
            fanout=state.fanout, last_pub=state.last_pub,
            backoff=state.backoff, tgt=state.gates[0], bog=state.gates[1])
        delivered = acq & params.deliver_words[None]
        first_tick = state.first_tick
        for t in range(T):
            first_tick = update_first_tick(first_tick, delivered[t],
                                           tick0 + t)
        return replace(state, mesh=mesh, fanout=fanout, last_pub=last_pub,
                       backoff=backoff, have=have, recent=recent,
                       first_tick=first_tick, gates=(tgt, bog),
                       tick=tick0 + T), delivered

    window.ticks_fused = T
    return window


def gossip_run(params: GossipParams, state: GossipState, n_ticks: int,
               step, *, device: str | torch.device | None = None
               ) -> GossipState:
    """Advance ``n_ticks`` heartbeats on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    check_on(dev, subscribed=params.subscribed, mesh=state.mesh)
    for _ in range(n_ticks):
        state = step(params, state)[0]
    return state


def gossip_run_curve(params: GossipParams, state: GossipState,
                     n_ticks: int, step, n_msgs: int, *,
                     device: str | torch.device | None = None):
    """``gossip_run`` collecting per-tick delivered counts: returns
    ``(state, counts int32 [n_ticks, n_msgs])``."""
    dev = resolve_device(device)
    check_on(dev, subscribed=params.subscribed, mesh=state.mesh)
    rows = []
    for _ in range(n_ticks):
        state, delivered = step(params, state)
        rows.append(count_bits_per_position(delivered, n_msgs))
    counts = (torch.stack(rows) if rows else
              torch.zeros((0, n_msgs), dtype=torch.int32, device=dev))
    return state, counts


def gossip_run_fused(params: GossipParams, state: GossipState,
                     n_ticks: int, window, *,
                     device: str | torch.device | None = None
                     ) -> GossipState:
    """``gossip_run`` over fused windows (``make_fused_window``): one
    launch per ``window.ticks_fused`` ticks, the final state
    bit-identical to ``gossip_run`` with the per-tick step.  A horizon
    the window does not divide raises ``fused_horizon``."""
    dev = resolve_device(device)
    check_on(dev, subscribed=params.subscribed, mesh=state.mesh)
    for _ in range(plan.check_fused_horizon(n_ticks, window.ticks_fused)):
        state = window(params, state)[0]
    return state


def gossip_run_curve_fused(params: GossipParams, state: GossipState,
                           n_ticks: int, window, n_msgs: int, *,
                           device: str | torch.device | None = None):
    """``gossip_run_curve`` over fused windows: per-tick delivered
    counts [n_ticks, n_msgs], rows bit-identical to the per-tick
    runner's."""
    dev = resolve_device(device)
    check_on(dev, subscribed=params.subscribed, mesh=state.mesh)
    rows = []
    for _ in range(plan.check_fused_horizon(n_ticks, window.ticks_fused)):
        state, delivered = window(params, state)
        rows += [count_bits_per_position(d, n_msgs) for d in delivered]
    counts = (torch.stack(rows) if rows else
              torch.zeros((0, n_msgs), dtype=torch.int32, device=dev))
    return state, counts


def reach_counts(params: GossipParams, state: GossipState) -> torch.Tensor:
    return reach_counts_from_first_tick(state.first_tick,
                                        params.publish_tick.shape[0])


def reach_counts_from_have(params: GossipParams, state: GossipState,
                           mask: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Per-message reached-peer counts from the possession words
    (optional bool [N] ``mask`` restricts the count)."""
    m = params.publish_tick.shape[0]
    shifts = torch.arange(WORD_BITS, dtype=torch.int32,
                          device=state.have.device)
    bits = (state.have[:, None, :] >> shifts[None, :, None]) & 1
    if mask is not None:
        bits = bits * mask.to(torch.int32)[None, None, :]
    return bits.sum(2, dtype=torch.int32).reshape(-1)[:m]


def mesh_degrees(state: GossipState) -> torch.Tensor:
    return popcount32(state.mesh)


def eclipse_takeover(state: GossipState, params: GossipParams,
                     cfg: GossipSimConfig) -> float:
    """The eclipse metric: the share of the victim set's occupied mesh
    slots held by eclipse attackers (0 = clean meshes, 1 = fully
    eclipsed), over victims with nonzero degree."""
    es, ev = params.eclipse_sybil, params.eclipse_victim
    occ = torch.zeros(es.shape, dtype=torch.int64, device=es.device)
    deg = torch.zeros_like(occ)
    for c, o in enumerate(cfg.offsets):
        bit = ((state.mesh >> c) & 1).bool()
        deg += bit
        occ += bit & torch.roll(es, -int(o))
    return float(occ[ev].sum()) / max(int(deg[ev].sum()), 1)


def iwant_serve_level(state: GossipState,
                      cfg: GossipSimConfig) -> torch.Tensor:
    """Per serving peer, its outstanding gossip-retransmission load,
    int32 [N]: ledger row c is kept at the requester p and burdens its
    candidate p + o_c, so each row is rolled back to the server."""
    s32 = state.iwant_serves.to(torch.int32)
    level = torch.zeros_like(s32[0])
    for c, o in enumerate(cfg.offsets):
        level += torch.roll(s32[c], int(o))
    return level
