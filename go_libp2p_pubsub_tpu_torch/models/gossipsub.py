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
pass per slot, slot-B flags on a second ctrl byte); any of these under a
fault schedule (churn, link loss, partitions, cold restart:
``models/faults.py``), on event-driven delays (``models/delays.py``:
K-slot delay lines, paired topics excepted) and with traced knobs
(``models/knobs.py``: the
degree family, gossip_factor, the tick counts, the four defense
parameters and the link-drop rate as 0-d tensors of the params, so one
step serves any protocol point).  The receive half
(payload receive, handshake, counter updates, next tick's gates) is one
kernel launch (``ops/kernels/receive.py``), or, where the reference's own
kernel planner refuses the sim (byzantine payload mutation, P3/P3b and
``force_split``, C > 16, a SimKnobs point on an IWANT-flood config), the
reference's per-edge receive loops in plain PyTorch
(``models/_receive_loops.py``; ``plan.receive_path`` routes); every
random top-k selection is one launch of the select kernel
(``ops/kernels/select.py``).  Everything else is plain PyTorch, as the
reference leaves it to XLA.

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
from . import _batch
from . import delays as _delays
from . import faults as _faults
from . import invariants as _invariants
from . import knobs as _knobs
from . import _receive_loops as _loops
from . import plan
from . import telemetry as _telemetry
from ._batch import index_trees, stack_trees, tree_copy  # noqa: F401
from ._delivery import (
    first_tick_to_matrix,
    reach_counts_from_first_tick,
    update_first_tick,
)


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


#: the defense parameters a sweep varies as data (0-d tensors instead of
#: constants), in ScoreKnobs field order; the rest of ScoreSimConfig
#: stays static
SCORE_KNOB_FIELDS = ("invalid_message_deliveries_weight",
                     "behaviour_penalty_weight",
                     "graylist_threshold", "gossip_threshold")


@dataclass(frozen=True)
class ScoreKnobs:
    """The four defense knobs as float32 0-d tensors on the sim's device
    (the reference's ``ScoreKnobs``): the P4 and P7 weights, the graylist
    and gossip thresholds.  None on the params bakes the ScoreSimConfig
    values."""

    invalid_message_deliveries_weight: torch.Tensor   # <= 0
    behaviour_penalty_weight: torch.Tensor            # <= 0
    graylist_threshold: torch.Tensor
    gossip_threshold: torch.Tensor


def make_score_knobs(sc: ScoreSimConfig, overrides: dict, surface: str, *,
                     device) -> ScoreKnobs:
    """Validated ScoreKnobs over ``sc`` (missing keys take its values);
    ``surface`` names the argument in the messages (``score_knobs`` or
    ``sim_knobs``, as the reference words them)."""
    kv = {f: float(overrides.get(f, getattr(sc, f)))
          for f in SCORE_KNOB_FIELDS}
    for f in ("invalid_message_deliveries_weight",
              "behaviour_penalty_weight"):
        if kv[f] > 0:
            raise ValueError(f"{surface}: {f} must be <= 0")
    if not (kv["graylist_threshold"] <= sc.publish_threshold
            <= kv["gossip_threshold"] <= 0):
        raise ValueError(
            f"{surface}: need graylist <= publish (static) <= "
            "gossip threshold <= 0")
    return ScoreKnobs(**{f: torch.tensor(kv[f], dtype=torch.float32,
                                         device=device)
                         for f in SCORE_KNOB_FIELDS})


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
    # byzantine payload mutators (score_cfg.byzantine_mutation): bit c of
    # cand_byz[p] = candidate p + o_c corrupts every copy it relays or
    # serves (the id kept: the receiver's validator rejects it)
    byzantine: torch.Tensor | None = None        # bool [N]
    cand_byz: torch.Tensor | None = None         # int32 [N]
    # same-IP sibling words, built only when some address is shared: bit
    # c of cand_same_ip[cc, p] = candidates c and cc of p share an IP
    cand_same_ip: torch.Tensor | None = None     # int32 [C, N]
    # operator-pinned direct edges (None when absent), scored or not
    cand_direct: torch.Tensor | None = None      # int32 [N]
    # paired topics: bit m set iff msg m is peer p's second topic, the
    # one its slot-B mesh forwards (None unpaired)
    slot_b_words: torch.Tensor | None = None     # int32 [W, N]
    # the compiled fault schedule (None without one)
    faults: _faults.FaultParams | None = None
    # the defense knobs armed through the legacy score_knobs surface, or
    # the protocol knobs (with the defense sub-tree folded in) armed
    # through sim_knobs; at most one of the two, None = baked
    score_knobs: ScoreKnobs | None = None
    sim_knobs: _knobs.SimKnobs | None = None
    # event-driven delays (``models/delays.py``): base and jitter as 0-d
    # tensors (the delay knobs replace them), the line depth a host int;
    # None = one tick per hop
    delays: _delays.DelayParams | None = None


@dataclass
class ScoreState:
    """Per-edge reputation counters, [C, N]: p's view of candidate
    p + o_c."""

    time_in_mesh: torch.Tensor        # int16 (P1)
    first_deliveries: torch.Tensor    # counter dtype (P2)
    invalid_deliveries: torch.Tensor  # counter dtype (P4)
    behaviour_penalty: torch.Tensor   # bp dtype (P7)
    time_in_mesh_b: torch.Tensor | None = None  # int16, slot B's P1
    # P3 and P3b, counter dtype, only under score_cfg.track_p3
    mesh_deliveries: torch.Tensor | None = None        # P3
    mesh_failure_penalty: torch.Tensor | None = None   # P3b, deficit²


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
    # delays: the K-slot circular delay lines (None without delays).
    # pay_line holds the in-flight payload words per receiving edge (row
    # j = the receiver's bit for the sender), ctrl_line the in-flight
    # control words (GRAFT, PRUNE, retraction and, where some peer
    # withholds what it advertises, the broken-promise advert); with
    # delays_counters the gossip-class and advert observer lines the
    # telemetry counters read at arrival
    pay_line: torch.Tensor | None = None    # int32 [K, C, W, N]
    ctrl_line: torch.Tensor | None = None   # int32 [K, R, N]
    gsp_line: torch.Tensor | None = None    # int32 [K, C, W, N]
    adv_line: torch.Tensor | None = None    # int32 [K, C, W, N]
    # with delays_probe, the probe's observer line: the three send-class
    # attempt words (eager forward, IHAVE advert, publish flood) of the
    # RPCs in flight, receiver-indexed
    probe_line: torch.Tensor | None = None  # int32 [K, 3, N]
    # the invariant checker's carry (``models/invariants.py``; None until
    # ``attach``): the cumulative violation mask, a u32 word held as int32,
    # and the first violating tick (-1 while clean)
    inv_viol: torch.Tensor | None = None    # int32 []
    inv_first: torch.Tensor | None = None   # int32 []


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
    the eclipse formation of ``score_cfg.sybil_eclipse``, byzantine [N]
    the payload mutators of ``score_cfg.byzantine_mutation`` (live only
    with both, as in the reference; the step then runs the receive
    loops).  Scored or not: direct_edges bool [N, C] pins operator-configured direct peers
    (symmetric: both ends configure the edge), and px_candidates (Dhi <
    px_candidates <= C) starts each peer knowing a random subset of that
    size of its candidates, which PX rotation then refreshes.
    fault_schedule (``models/faults.py`` ``FaultSchedule`` over the sim's
    peers) injects churn, link loss, partitions and cold restarts.

    Knobs (``models/knobs.py``): score_knobs, a dict over
    SCORE_KNOB_FIELDS (needs score_cfg; missing keys take its values), or
    sim_knobs, a dict mixing the protocol knobs (SIM_KNOB_FIELDS), the
    same defense fields, the fault knob ``drop_prob`` (it overrides the
    schedule's link-drop rate: it needs a fault_schedule with a nonzero
    scalar drop_prob) and the delay knobs ``delay_base`` /
    ``delay_jitter`` (they override the DelayConfig's: they need one) —
    one surface or the other.  Each lifts those parameters from constants
    of the step to 0-d tensors of the params, so one step serves any
    point; missing keys take the config's own values (``knob_params``
    arms built params the same way).

    Delays (``models/delays.py``): ``delays``, a DelayConfig, makes every
    transfer take base + a per-edge jitter draw ticks through the K-slot
    delay lines the state then carries (paired topics raise the
    reference's NotImplementedError); ``delays_counters=True`` adds the
    observer lines the delayed telemetry counters need, and
    ``delays_probe=True`` the probe line a delay-armed ``rpc_probe`` step
    dequeues its arrival masks from.  ``delays_split=True`` (the split
    path) is refused by name as ``delays_split``."""
    dev = resolve_device(device)
    plan.check_sim_options(
        flood_proto=flood_proto, pad_to_block=pad_to_block, delays=delays,
        delays_split=delays_split, delays_counters=delays_counters)
    if delays is not None and cfg.paired_topics:
        # per-slot delay lines and delayed cross-slot control routing are
        # not modelled (the reference's refusal)
        raise NotImplementedError(plan.MSG_DELAYS_PAIRED)
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
    if byzantine is not None:
        if sc is None:
            raise ValueError(
                "byzantine requires score_cfg (mutated copies feed "
                "the validation-reject P4 path)")
        bz = np.asarray(byzantine, dtype=bool)
        scored.update(byzantine=t_(bz), cand_byz=_words(cand_bits(bz), dev))

    if fault_schedule is not None:
        # the schedule covers the true peer count (the port runs
        # unpadded)
        if fault_schedule.n_peers != n:
            raise ValueError(
                f"fault_schedule.n_peers={fault_schedule.n_peers} != "
                f"sim peer count {n}")
        scored["faults"] = _faults.compile_faults(fault_schedule,
                                                  cfg.offsets, device=dev)
    if delays is not None:
        scored["delays"] = _delays.compile_delays(delays, dev)

    params = GossipParams(
        subscribed=t_(subscribed),
        cand_sub_bits=_words(cand_bits(subscribed), dev),
        origin_words=_words(_pack_bits_pm_np(origin_bits), dev),
        deliver_words=_words(_pack_bits_pm_np(deliver_bits), dev),
        publish_tick=t_(np.asarray(msg_publish_tick, dtype=np.int32)),
        slot_b_words=(None if slot_b_bits is None
                      else _words(_pack_bits_pm_np(slot_b_bits), dev)),
        **scored)
    params = knob_params(cfg, sc, params, score_knobs=score_knobs,
                         sim_knobs=sim_knobs, px_candidates=px_candidates,
                         delays=delays)
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
    if delays is None:
        for flag, on in (("delays_split", delays_split),
                         ("delays_counters", delays_counters),
                         ("delays_probe", delays_probe)):
            if on:
                raise ValueError(f"{flag}=True needs a DelayConfig")
    scores = None
    paired = cfg.paired_topics
    if sc is not None:
        cdt = krecv.DTYPES[sc.counter_dtype]

        def zc():
            return torch.zeros((c, n), dtype=cdt, device=dev)
        scores = ScoreState(
            time_in_mesh=i16(), first_deliveries=zc(),
            invalid_deliveries=zc(),
            behaviour_penalty=torch.zeros(
                (c, n), dtype=krecv.DTYPES[sc.bp_dtype], device=dev),
            time_in_mesh_b=i16() if paired else None,
            mesh_deliveries=zc() if sc.track_p3 else None,
            mesh_failure_penalty=zc() if sc.track_p3 else None)
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
    if delays is not None:
        state = _delay_lines(sc, params, state, delays.k_slots,
                             delays_counters, delays_probe)
    # seed the gate pipeline: tick 0's gate words
    return params, refresh_gates(cfg, sc, params, state)


def _delay_lines(sc: ScoreSimConfig | None, params: GossipParams,
                 state: GossipState, k_slots: int,
                 counters: bool, probe: bool = False) -> GossipState:
    """``state`` with empty K-slot delay lines; the ctrl line's fourth row
    (the broken-promise advert) exists iff some peer may withhold what it
    advertises, ``counters`` adds the two observer lines and ``probe`` the
    probe line."""
    w, n = state.have.shape
    c = state.backoff.shape[0]
    has_cheat = sc is not None and (sc.sybil_ihave_spam
                                    or params.promise_break is not None)

    def line(*shape):
        return torch.zeros((int(k_slots), *shape), dtype=torch.int32,
                           device=state.have.device)
    lines = dict(pay_line=line(c, w, n), ctrl_line=line(3 + has_cheat, n))
    if counters:
        lines.update(gsp_line=line(c, w, n), adv_line=line(c, w, n))
    if probe:
        lines["probe_line"] = line(3, n)
    return replace(state, **lines)


def arm_delays(sc: ScoreSimConfig | None, params: GossipParams,
               state: GossipState, delays: _delays.DelayConfig, *,
               delays_counters: bool = False, delays_probe: bool = False):
    """(params, state) of a sim built without delays, armed with
    ``delays`` as ``make_gossip_sim(..., delays=delays,
    delays_counters=..., delays_probe=...)`` arms it: the compiled
    DelayParams and empty lines (paired topics raise the reference's
    NotImplementedError)."""
    if state.mesh_b is not None:
        raise NotImplementedError(plan.MSG_DELAYS_PAIRED)
    params = replace(params, delays=_delays.compile_delays(
        delays, params.subscribed.device))
    return params, _delay_lines(sc, params, state, delays.k_slots,
                                delays_counters, delays_probe)


def knob_params(cfg: GossipSimConfig, sc: ScoreSimConfig | None,
                params: GossipParams, *, score_knobs: dict | None = None,
                sim_knobs: dict | None = None,
                px_candidates: int | None = None,
                delays: _delays.DelayConfig | None = None) -> GossipParams:
    """``params`` with the knob leaves of one surface armed (the
    reference's make_gossip_sim validations and messages): score_knobs
    sets ``score_knobs``; sim_knobs sets ``sim_knobs`` and, with
    ``drop_prob``, replaces ``faults.drop_prob`` and nothing else of the
    schedule, with ``delay_base`` / ``delay_jitter`` ``delays.base`` /
    ``delays.jitter`` (checked against the line depth; ``delays``, the
    sim's DelayConfig, gives the values a missing key keeps, else they
    are read from the built params).  Neither: ``params`` as they
    are."""
    dev = params.subscribed.device
    out = {}
    if score_knobs is not None:
        if sc is None:
            raise ValueError("score_knobs require score_cfg")
        unknown = set(score_knobs) - set(SCORE_KNOB_FIELDS)
        if unknown:
            raise ValueError(
                f"score_knobs: unknown knob(s) {sorted(unknown)} — "
                f"sweepable knobs are {SCORE_KNOB_FIELDS}")
        out["score_knobs"] = make_score_knobs(sc, score_knobs,
                                              "score_knobs", device=dev)
    if sim_knobs is not None:
        if score_knobs is not None:
            raise ValueError(
                "pass parameter overrides through ONE surface: "
                "sim_knobs (which folds the ScoreKnobs fields in) or "
                "the legacy score_knobs dict, not both")
        proto_kv, score_kv, fault_kv, delay_kv = \
            _knobs.split_knob_overrides(sim_knobs, SCORE_KNOB_FIELDS)
        out["sim_knobs"] = _knobs.make_sim_knobs(
            cfg, sc, {**proto_kv, **score_kv}, px_candidates=px_candidates,
            device=dev)
        if fault_kv:
            fp0 = params.faults
            if fp0 is None:
                raise ValueError(
                    "sim_knobs: the drop_prob knob overrides a "
                    "compiled FaultParams leaf — pass a "
                    "fault_schedule alongside it")
            if fp0.drop_prob is None or fp0.drop_prob.ndim != 0:
                raise ValueError(
                    "sim_knobs: the drop_prob knob needs a schedule "
                    "with a nonzero SCALAR drop_prob (the link-fault "
                    "code path must compile in, and the per-edge "
                    "[C, N] form is not scalar-overridable); knob "
                    "value 0.0 then disables drops at run time")
            dpv = float(fault_kv["drop_prob"])
            if not (0.0 <= dpv <= 1.0):
                raise ValueError(
                    f"sim_knobs: drop_prob={dpv} outside [0, 1]")
            out["faults"] = replace(fp0, drop_prob=torch.tensor(
                dpv, dtype=torch.float32, device=dev))
        if delay_kv:
            dp0 = params.delays
            if dp0 is None:
                raise ValueError(
                    "sim_knobs: the delay_base/delay_jitter knobs "
                    "override compiled DelayParams leaves — pass a "
                    "DelayConfig alongside them (the delay-line code "
                    "path must compile in; its k_slots depth bounds "
                    "the sweepable points)")
            if delays is None:
                # the built values (a host read, when arming only)
                delays = _delays.DelayConfig(
                    base=int(dp0.base), jitter=int(dp0.jitter),
                    k_slots=dp0.k_slots)
            db = int(delay_kv.get("delay_base", delays.base))
            dj = int(delay_kv.get("delay_jitter", delays.jitter))
            delays.validate_point(base=db, jitter=dj)
            out["delays"] = replace(
                dp0, base=torch.tensor(db, dtype=torch.int32, device=dev),
                jitter=torch.tensor(dj, dtype=torch.int32, device=dev))
    return replace(params, **out) if out else params


# --------------------------------------------------------------------------
# Scores and gates
# --------------------------------------------------------------------------


def active_score_knobs(params: GossipParams) -> ScoreKnobs | None:
    """The ScoreKnobs in effect for this sim, whichever surface armed
    them (make_gossip_sim allows at most one)."""
    if params.score_knobs is not None:
        return params.score_knobs
    if params.sim_knobs is not None:
        return params.sim_knobs.score
    return None


def _lead(v, nd: int):
    """A knob value as the step consumes it against a [..., N] (``nd``
    1) or [..., C, N] (``nd`` 2) operand: an int or a 0-d tensor as it
    is, a replica stack's [B] leaf with ``nd`` unit axes after it."""
    if isinstance(v, torch.Tensor) and v.dim() == 1:
        return v.view(-1, *([1] * nd))
    return v


def knobbed_score_consts(sc: ScoreSimConfig, params: GossipParams,
                         pick=None) -> krecv.ScoreConsts:
    """The score formula's scalars with the armed defense knobs (the P4
    and P7 weights as 0-d tensors: ``krecv.knob_score_consts``); a
    replica stack's [B] weights shaped by ``pick`` (default: against
    [B, C, N] counters)."""
    s = krecv.score_consts(sc)
    kn = active_score_knobs(params)
    if kn is None:
        return s
    pick = pick or (lambda v: _lead(v, 2))
    return krecv.knob_score_consts(
        s, krecv._f32(sc.topic_weight),
        pick(kn.invalid_message_deliveries_weight),
        pick(kn.behaviour_penalty_weight))


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
    indices) computes only those columns; on a replica stack ([B, C, N])
    ``cols`` is a pair (replica, peer) of int64 indices, and the result
    [C, K] holds each pair's column."""
    s = st.scores
    pick = None
    if isinstance(cols, tuple):
        bi, pi = cols

        def g(x):
            return x[bi, :, pi].T

        def g_word(x):
            return x[bi, pi]

        def pick(v):
            return v[bi] if isinstance(v, torch.Tensor) and v.dim() else v
    else:
        def g(x):
            return x if cols is None else x.index_select(-1, cols)

        def g_word(x):
            return x if cols is None else x.index_select(-1, cols)

    static = _static_term(sc, params)
    tim = g(s.time_in_mesh).to(torch.float32)
    p3 = None
    if sc.track_p3:
        # P3: the squared delivery deficit of an active mesh edge; P3b:
        # the sticky prune penalty (score.go:256-333)
        f = krecv._f32
        in_mesh = expand_bits(g_word(st.mesh), tim.shape[-2])
        deficit = (f(sc.mesh_message_deliveries_threshold)
                   - g(s.mesh_deliveries).to(torch.float32)).clamp(min=0.0)
        active = tim > sc.mesh_message_deliveries_activation
        p3 = (f(sc.topic_weight * sc.mesh_message_deliveries_weight)
              * torch.where(in_mesh & active, deficit * deficit, 0.0),
              f(sc.topic_weight * sc.mesh_failure_penalty_weight)
              * g(s.mesh_failure_penalty).to(torch.float32))
    return krecv.score_from_counters(
        knobbed_score_consts(sc, params, pick), tim,
        g(s.first_deliveries).to(torch.float32),
        g(s.invalid_deliveries).to(torch.float32),
        g(s.behaviour_penalty).to(torch.float32),
        None if static is None else g(static),
        tim_b=(None if s.time_in_mesh_b is None
               else g(s.time_in_mesh_b).to(torch.float32)), p3=p3)


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
    skn = params.sim_knobs
    targets = krecv.targets_row(
        k, elig, lane_seed(tick, 1, salt), mesh.shape[-1],
        gossip_factor=None if skn is None else _lead(skn.gossip_factor, 1),
        d_lazy=None if skn is None else _lead(skn.d_lazy, 1))
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
    n = st.mesh.shape[-1]
    score = compute_scores(sc, params, st)
    kn = active_score_knobs(params)
    accept = pack_rows(score >= (k.gray_thr if kn is None
                                 else _lead(kn.graylist_threshold, 2)))
    gossip = pack_rows(score >= (k.gossip_thr if kn is None
                                 else _lead(kn.gossip_threshold, 2)))
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


def kernel_capability(cfg: GossipSimConfig, sc: ScoreSimConfig | None,
                      params: GossipParams, state: GossipState) -> str | None:
    """None where the step's receive half takes the receive kernel (B1);
    else the reason, in the reference's words: a SimKnobs point on an
    IWANT-flood config (``MSG_KERNEL_KNOB_IWANT_SPAM``) and any other
    config ``plan.receive_path`` sends to the receive loops (byzantine
    mutators, P3/P3b, more than 16 candidates: ``MSG_KERNEL_CONFIG``), and
    delays on an IWANT-flood config, which the step refuses
    (``MSG_KERNEL_DELAY_IWANT_SPAM``)."""
    iwant_spam = sc is not None and sc.sybil_iwant_spam
    if params.sim_knobs is not None and iwant_spam:
        return plan.MSG_KERNEL_KNOB_IWANT_SPAM
    if params.delays is not None and iwant_spam:
        return plan.MSG_KERNEL_DELAY_IWANT_SPAM
    if plan.receive_path(cfg, sc, params) != plan.KERNEL:
        return plan.MSG_KERNEL_CONFIG
    return None


@dataclass(frozen=True)
class EdgeGeometry:
    """The device tensors the delay exchange reads a ring's edges with,
    made once per (config, ring size, device): ``index`` int64 [C, N], row
    j at lane p holds (p + o_j) mod N (a gather along the peer axis by it
    reads, at each peer, its candidate j); ``cinv`` and ``bit`` int32
    [C, 1], the partner bit of each row and the row's own."""

    index: torch.Tensor
    cinv: torch.Tensor
    bit: torch.Tensor

    @staticmethod
    def of(cfg: GossipSimConfig, n: int, device) -> "EdgeGeometry":
        p = torch.arange(n, dtype=torch.int64, device=device)
        C = cfg.n_candidates
        return EdgeGeometry(
            index=torch.stack([(p + o) % n for o in cfg.offsets]),
            cinv=torch.tensor(cfg.cinv, dtype=torch.int32,
                              device=device)[:, None],
            bit=torch.arange(C, dtype=torch.int32, device=device)[:, None])


def transfer_bits(bits: torch.Tensor, cfg: GossipSimConfig,
                  pair: bool = False,
                  geo: EdgeGeometry | None = None) -> torch.Tensor:
    """Packed edge transfer: what each peer's partners sent it.  Bit c of
    ``bits`` (edge p -> p + o_c), rolled by o_c, lands at the partner's
    bit cinv[c]: bit j of the result at p is bit cinv[j] of bits[p + o_j].
    With ``pair`` (C <= 16) the word carries two C-bit masks, in its low
    and high 16 bits, moved by the same gather.  ``geo``: the ring's
    ``EdgeGeometry`` (made here where not given)."""
    if geo is None:
        geo = EdgeGeometry.of(cfg, bits.shape[-1], bits.device)
    sel = 0x10001 if pair else 1
    rows = (bits[..., None, :] >> geo.cinv) & sel  # (C <= 16: no sign bit)
    got = torch.gather(rows, -1, geo.index.expand(rows.shape))
    return (got << geo.bit).sum(-2, dtype=torch.int32)


def delay_exchange(cfg: GossipSimConfig, sc: ScoreSimConfig | None,
                   params: GossipParams, state: GossipState, *, tick: int,
                   sel: dict, targets, withhold, out_bits, flood_bits,
                   fresh, adv, injected, payload_bits, gossip_bits,
                   accept_bits, fm, counters: bool,
                   geo: EdgeGeometry, probe=None) -> dict:
    """This tick's transfers through the delay lines (the reference's
    ``delay_exchange(split=False)``, the combined form).

    The sends, exactly the one-hop step's and gated at the send tick
    (scored: the receiver's payload and gossip gates, carried to the
    sender by one pair transfer), are rolled to their receivers and
    enqueued at slot ``(t + d - 1) mod K``, d drawn per directed edge-tick
    (``delays.edge_delays`` at the receiver's lane); the tick's arrivals
    dequeue from slot ``t mod K``.  Control: GRAFTs and PRUNEs (under
    faults only those sent over a live link) ride the ctrl line; at
    arrival a down peer processes none, the graylist drops them (scored),
    and a GRAFT that will not be confirmed (would not be accepted, or its
    confirmation cannot be sent) is retracted: at once over an edge whose
    draw is 1, else through the ctrl line; a failed local send is known at
    once.  With ``counters``: the send-side telemetry tallies and the
    gossip-class and advert observer lines.  With ``probe`` (the RPC
    probe's three post-fault send words: eager forward, IHAVE advert,
    publish flood, each or None) they ride the probe line to their
    receivers, and ``arr_probe`` [3, N] is this tick's arrivals.

    Returns the dequeued payload words ``arr_pay`` [C, W, N] (row j = the
    receiving bit), the resolved control words ``graft_arr``,
    ``prune_arr``, ``retract`` and (some peer withholds) ``cheat_arr``,
    the next lines, and with ``counters`` ``tel_send`` (payload, IHAVE ids
    and RPCs) and the dequeued observer words ``arr_gsp``, ``arr_adv``.
    A replica stack (every operand and line with a leading [B], the draws
    at each replica's seed and knobs) gives each of these with a leading
    [B], the tallies per replica.
    The draw, the payload lines and the control line run inside
    ``record_function`` ranges ``delays.draw``, ``delays.payload`` and
    ``delays.control`` (a profile's ``ranges``)."""
    dl = params.delays
    K, C = dl.k_slots, cfg.n_candidates
    n = state.have.shape[-1]
    # (a replica stack: the replica axis leads every word, and a line's
    # slot axis is its second)
    lead = state.have.dim() - 2
    rf = torch.profiler.record_function
    with rf("delays.draw"):
        d_edge = _delays.edge_delays(dl, (C, n), tick, stride=n)
        slot = (tick + d_edge - 1) % K                       # [.., C, N]
        slot_sel = _delays.slot_words(slot, K)               # [.., K, N]
        in_slot = (slot.unsqueeze(-3) == torch.arange(
            K, dtype=torch.int32, device=slot.device)[:, None, None])
    cheat_raw = (torch.where(withhold, targets, 0)
                 if withhold is not None else None)

    def total(x):
        """A tally over every axis but the replica's."""
        return x.reshape(*x.shape[:lead], -1).sum(-1, dtype=torch.int64)

    # -- the payload and gossip sends, gated at the send tick, rolled to
    # their receivers and through the payload line
    with rf("delays.payload"):
        send_gsp = (targets if withhold is None
                    else torch.where(withhold, 0, targets))
        send_fwd, send_flood = out_bits, flood_bits
        if sc is not None:
            # the receiver's payload and payload-and-gossip gates, carried to
            # the sender in one pair transfer (the reference skips it when
            # every gate is open, which it then equals: no branch here)
            gate_recv = transfer_bits(
                payload_bits | ((payload_bits & gossip_bits) << 16), cfg,
                pair=True, geo=geo)
            send_fwd = out_bits & gate_recv
            send_gsp = send_gsp & graph.shr(gate_recv, 16)
            if flood_bits is not None:
                send_flood = flood_bits & gate_recv
        rows = lambda bits: expand_bits(bits, C).unsqueeze(-2)  # noqa: E731
        pay = torch.where(rows(send_fwd), fresh.unsqueeze(-3), 0)  # [C, W, N]
        if send_flood is not None:
            pay = pay | torch.where(rows(send_flood), injected.unsqueeze(-3),
                                    0)
        gsp_words = torch.where(rows(send_gsp), adv.unsqueeze(-3), 0)

        zero = torch.zeros((), dtype=torch.int32, device=pay.device)

        def rolled(words):
            """Sender edge c's words at their receivers, in row cinv[c]
            (the receiver's bit for the sender): row j at p holds row
            cinv[j] of peer p + o_j (a stack: within each replica)."""
            src = words.index_select(-3, geo.cinv[:, 0])
            return torch.gather(src, -1,
                                geo.index[:, None, :].expand(src.shape))

        def enqueue(line, words):
            """(arrivals, next line): ``words`` at each edge's slot."""
            return _delays.enqueue_dequeue(line, lambda out: torch.where(
                in_slot.unsqueeze(-2), rolled(words).unsqueeze(-4), zero,
                out=out), tick, axis=lead)

        arr_pay, pay_line = enqueue(state.pay_line, pay | gsp_words)
        out = dict(arr_pay=arr_pay, pay_line=pay_line)
        if counters:
            # send-side tallies at the send tick from the pre-roll words (a
            # popcount does not see the roll); adverts counted from the
            # targets before withholding, as the reference counts them
            adv_any = (adv != 0).any(-2)
            adv_words = torch.where(rows(targets), adv.unsqueeze(-3), 0)
            out["tel_send"] = dict(
                payload=total(popcount32(pay)),
                ihave_ids=total(popcount32(adv_words)),
                ihave_rpcs=total(torch.where(adv_any, popcount32(targets),
                                             0)))
            out["arr_gsp"], out["gsp_line"] = enqueue(state.gsp_line,
                                                      gsp_words)
            out["arr_adv"], out["adv_line"] = enqueue(state.adv_line,
                                                      adv_words)
    # -- control: enqueue this tick's GRAFTs and PRUNEs (and the
    # broken-promise adverts), dequeue this tick's arrivals
    with rf("delays.control"):
        grafts, dropped = sel["grafts"], sel["dropped"]
        if fm is not None:
            grafts_tx, dropped_tx = grafts & fm.send_ok, dropped & fm.send_ok
        else:
            grafts_tx, dropped_tx = grafts, dropped
        zrow = torch.zeros_like(grafts)
        # GRAFTs and PRUNEs in one pair transfer (C <= 16)
        hs_fly = transfer_bits(grafts_tx | (dropped_tx << 16), cfg,
                               pair=True, geo=geo)
        ctrl = [hs_fly & 0xFFFF, graph.shr(hs_fly, 16), zrow]
        R = state.ctrl_line.shape[-2]
        if R == 4:
            # broken-promise adverts, gossip-gated at the send tick like real
            # gossip, indexed at the receiver
            cheat_fly = transfer_bits(cheat_raw, cfg, geo=geo)
            if sc is not None:
                cheat_fly = cheat_fly & payload_bits & gossip_bits
            ctrl.append(cheat_fly)
        arr_ctrl, ctrl_line = _delays.enqueue_dequeue(
            state.ctrl_line, lambda out: torch.bitwise_and(
                torch.stack(ctrl, -2).unsqueeze(-3), slot_sel.unsqueeze(-2),
                out=out),
            tick, axis=lead)
        # (a stack's rows are strided views: the kernel reads them whole)
        graft_raw, prune_arr, retr_arr = (arr_ctrl[..., r, :].contiguous()
                                          for r in range(3))
        cheat_arr = arr_ctrl[..., 3, :].contiguous() if R == 4 else None
        if fm is not None:
            # a down peer processes no inbound control
            graft_raw = graft_raw & fm.alive_all
            prune_arr = prune_arr & fm.alive_all
            retr_arr = retr_arr & fm.alive_all
            if cheat_arr is not None:
                cheat_arr = cheat_arr & fm.alive_all
        graft_arr = graft_raw
        if sc is not None:
            # graylisted peers' control dropped at arrival; the retraction is
            # a PRUNE response and passes
            graft_arr = graft_raw & accept_bits
            prune_arr = prune_arr & accept_bits

        # -- the handshake at arrival: a GRAFT that will not be confirmed is
        # retracted, at once where the grafter's edge draw is 1, else through
        # the ctrl line (enqueued after the dequeue)
        conf = sel["a_sent"]
        if fm is not None:
            # an unsendable confirmation counts as a rejection
            conf = conf & fm.send_ok
        retr_fly = transfer_bits(graft_raw & ~conf, cfg, geo=geo)
        d1_bits = _delays.pack_edges(d_edge == 1)
        retract = retr_fly & d1_bits
        retr_later = retr_fly & ~d1_bits
        ctrl_line[..., 2, :] |= retr_later.unsqueeze(-2) & slot_sel
        if fm is not None:
            # a failed local send is known at once; a dead grafter processes
            # no inbound retraction
            retract = (retract & fm.alive_all) | (grafts & ~fm.send_ok)
        out.update(graft_arr=graft_arr, prune_arr=prune_arr,
                   retract=retract | retr_arr, cheat_arr=cheat_arr,
                   ctrl_line=ctrl_line, probe_line=state.probe_line)
    if probe is not None:
        # the probe's observer line: the attempt words of the sends that
        # entered the network, at their receivers (a readout: possession
        # never reads it)
        fwd_w, adv_w, flood_w = (zrow if w_ is None else w_ for w_ in probe)
        fly = transfer_bits(fwd_w | (adv_w << 16), cfg, pair=True, geo=geo)
        rows_p = [fly & 0xFFFF, graph.shr(fly, 16),
                  transfer_bits(flood_w, cfg, geo=geo)]
        out["arr_probe"], out["probe_line"] = _delays.enqueue_dequeue(
            state.probe_line, lambda o: torch.bitwise_and(
                torch.stack(rows_p, -2).unsqueeze(-3),
                slot_sel.unsqueeze(-2), out=o),
            tick, axis=lead)
    return out


def degree_knobs(cfg: GossipSimConfig, params: GossipParams):
    """Where the step reads the degree family and the fanout TTL: the
    armed SimKnobs (0-d tensors), else ``cfg`` (ints) — the same field
    names, so every consumer reads ``K.d``, ``K.d_lo``, ... either way
    and no Python ``if`` or ``range`` ever reads a knob's value."""
    return cfg if params.sim_knobs is None else params.sim_knobs


def _fill(like: torch.Tensor, v) -> torch.Tensor:
    """``like``-shaped tensor of ``v``, an int or a 0-d knob tensor."""
    if isinstance(v, torch.Tensor):
        return v.to(like.dtype).expand(like.shape)
    return torch.full_like(like, v)


def _prunes(cfg: GossipSimConfig, sc: ScoreSimConfig,
            params: GossipParams, state: GossipState,
            mesh_ng: torch.Tensor, deg: torch.Tensor,
            phase: int) -> torch.Tensor:
    """Prune to D where deg > Dhi: keep the Dscore best by score, then
    at least Dout outbound, random fill to D (v1.1, gossipsub.go:
    1376-1435), on the lane stream of ``phase``.  Per-peer independent,
    so computed on the columns of the over-subscribed peers only — the
    step's host sync, one per topic slot (with or without knobs)."""
    C = cfg.n_candidates
    K = degree_knobs(cfg, params)
    n = mesh_ng.shape[-1]
    # a replica stack: the over-subscribed columns of every replica in
    # one sync, each column with its replica's salt and knobs
    idx = torch.nonzero((deg > _lead(K.d_hi, 1)).flatten()).flatten()
    prunes = torch.zeros_like(mesh_ng)
    if idx.numel() == 0:
        return prunes
    if mesh_ng.dim() == 2:
        bi = torch.div(idx, n, rounding_mode="floor")
        cols = (bi, idx - bi * n)

        def per(v):
            return v[bi] if isinstance(v, torch.Tensor) and v.dim() else v
        salt = lane_seed(state.tick, phase, state.salt)[bi]
        rnd = graph.lane_uniform_from_seed((C, n), salt, stride=n,
                                           device=mesh_ng.device,
                                           cols=cols[1])
    else:
        cols = idx

        def per(v):
            return v
        rnd = lane_uniform((C, n), state.tick, phase, state.salt, stride=n,
                           device=mesh_ng.device, cols=idx)
    score = compute_scores(sc, params, state, cols=cols)
    m_s = mesh_ng.reshape(-1).index_select(0, idx)
    top = select_k_by_priority_bits(m_s, score, _fill(m_s, per(K.d_score)),
                                    tiebreak=rnd)
    out = cfg.outbound_mask
    need_out = (per(K.d_out) - popcount32(top & out)).clamp(min=0)
    taken = top | select_k_by_priority_bits(m_s & ~top & out, rnd,
                                            need_out)
    fill = select_k_by_priority_bits(
        m_s & ~taken, rnd, (per(K.d) - popcount32(taken)).clamp(min=0))
    prunes.view(-1)[idx] = m_s & ~(taken | fill)
    return prunes


def _opportunistic(sc: ScoreSimConfig, params: GossipParams,
                   state: GossipState, mesh_ng: torch.Tensor,
                   deg: torch.Tensor, can_graft: torch.Tensor):
    """Opportunistic grafting (gossipsub.go:1467-1498): where the mesh's
    median score is below the threshold, up to opportunistic_graft_peers
    graftable candidates scoring above the median.  Returns the
    selection's (eligible bits, k)."""
    C = state.backoff.shape[-2]
    score = compute_scores(sc, params, state)
    in_mesh = expand_bits(mesh_ng, C)
    # median = the mesh bit at descending rank C-1-deg//2 (non-mesh bits
    # pinned to +inf rank first); one pick per peer with deg > 0, so
    # the sum over C is exact in any order
    mesh_rank = ranks_desc(torch.where(in_mesh, score, torch.inf))
    med_pick = in_mesh & (mesh_rank == (C - 1 - deg // 2)[..., None, :])
    median = torch.where(deg > 0,
                         torch.where(med_pick, score, 0.0).sum(-2), 0.0)
    og_row = (median < sc.opportunistic_graft_threshold) & params.subscribed
    og_elig = can_graft & pack_rows(score > median[..., None, :])
    og_need = torch.where(og_row, sc.opportunistic_graft_peers, 0)
    return og_elig, og_need.to(torch.int32)


#: the lane phases of each topic slot's graft, prune and opportunistic
#: graft draws: slot A, and slot B under paired topics
SLOT_PHASES = ((2, 3, 5), (12, 13, 15))


def maintain_slot(cfg: GossipSimConfig, sc: ScoreSimConfig | None,
                  params: GossipParams, state: GossipState, slot: int, *,
                  sub_all: torch.Tensor,
                  accept_bits: torch.Tensor | None,
                  fmasks: _faults.TickMasks | None = None) -> dict:
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
    through, are the step's own.  Under faults (``fmasks``, the tick's
    masks) mesh edges to or at a dead peer drop with PRUNE and backoff at
    both ends (folded into ``dropped``), and nobody grafts at or by a
    dead peer.  Scored, one host sync (the prune)."""
    C = cfg.n_candidates
    K = degree_knobs(cfg, params)
    n = params.subscribed.shape[-1]
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

    dead = None
    if fmasks is not None:
        # both ends start the same backoff at the death tick, so a
        # rejoiner and its old partners become graftable together
        dead = mesh0 & ~(fmasks.cand_alive & fmasks.alive_all)
        mesh0 = mesh0 & ~dead
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
    if fmasks is not None:
        can_graft = can_graft & fmasks.cand_alive & fmasks.alive_all
    need = torch.where(deg < _lead(K.d_lo, 1), _lead(K.d, 1) - deg,
                       0).to(torch.int32)
    grafts = sel_k(can_graft, need, ph_graft)
    if sc is None:
        # v1.0 random retention of D where deg > Dhi, drawn for every
        # peer (no host sync; masked to the over-full ones)
        keep = sel_k(mesh_ng, _fill(deg, _lead(K.d, 1)), ph_prune)
        prunes = torch.where(deg > _lead(K.d_hi, 1), mesh_ng & ~keep, 0)
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
    if fmasks is not None:
        # over the overrides too: not even a graft-flooding sybil grafts
        # while dead or at the dead
        grafts = grafts & fmasks.cand_alive & fmasks.alive_all
    mesh_sel = (mesh_ng | grafts) & ~prunes
    dropped = prunes if neg is None else prunes | neg
    if dead is not None:
        dropped = dropped | dead
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

    Faults (``params.faults``, ``models/faults.py``): the tick's masks
    are computed once on the device from the host tick; under cold
    restart a rejoining peer's possession and mcache are cleared first.
    A down origin's publish is lost; a down peer, or either end of a
    down link, sends nothing (forwards, adverts, floods and the handshake
    bytes are masked by ``send_ok``, the handshake words the kernel reads
    stay unmasked: only the notification is lost); dead candidates take
    no fanout slot and no graft, and mesh edges to or at a dead peer drop
    with PRUNE and backoff at both ends (``maintain_slot``); the kernel's
    faulted variant gates what a down receiver hears and the control it
    receives (``alive_w``) and the IWANT flood's edges (``flood_ok``).

    Telemetry (``telemetry``, a ``models/telemetry.py`` TelemetryConfig):
    the step returns ``(state, delivered, frame)``, the state trajectory
    bit-identical to the step without it (telemetry only reads).  The RPC
    and duplicate counters and the latency-bucket rows come from the
    receive kernel's tally (its ``+tel`` variant); GRAFT and PRUNE are
    counted as transmitted (under faults, over a live link toward a live
    partner; both slots when paired); the mesh gauges read the end-of-
    tick mesh (both slots), the score group the start-of-tick scores (one
    more [C, N] pass), the faults group the tick's masks.  No host sync is
    added.

    Knobs (``params.sim_knobs`` / ``params.score_knobs``,
    ``make_gossip_sim``): the degree family and the fanout TTL are read
    from the params' 0-d tensors in the prologue, fanout and maintenance
    (never by a Python ``if`` or ``range``: no host sync is added);
    gossip_factor, d_lazy, the backoff restart and the defense knobs ride
    one f32 vector into the kernel's ``+knobs`` variant (built on the
    device once per sim), and compute_scores / compute_gates read the
    defense knobs on the PyTorch side.  A SimKnobs point on an IWANT-flood
    config runs on the receive loops, where the flood's serve budget reads
    ``gossip_retransmission`` (the reference's kernel bakes it and
    refuses the point).

    The receive loops (``models/_receive_loops.py``): where
    ``plan.receive_path`` leaves the kernel — live byzantine mutation,
    P3/P3b, ``force_split``, C > 16, a SimKnobs point on an IWANT flood —
    the reference's XLA receive half runs in PyTorch, combined or split,
    then PX and the next tick's gates from the new state; the loops take
    no telemetry, delays or paired topics (``loops_*`` refusals).

    Delays (``params.delays``, ``make_gossip_sim(delays=...)``): this
    tick's sends go into the state's delay lines and this tick's arrivals
    come out (``delay_exchange``); the receive kernel's delay mode
    (``+delays``) takes the arrivals and the control words resolved at
    arrival in place of the sender streams.  Faults mask the sends, the
    arrivals and the control in the step (no faulted delayed variant);
    telemetry's counters are tallied in the step from the observer lines
    (``delays_counters=True``) and the latency histogram from the tick's
    deliveries (``delayed_tally``, ``latency_histogram``).  The reference's
    errors in its order: paired topics (``plan.MSG_DELAYS_PAIRED``),
    counters without the observer lines, params without lines, then the
    IWANT flood (``plan.MSG_KERNEL_DELAY_IWANT_SPAM``).  No host sync is
    added.

    A replica stack (``stack_sims`` / ``stack_trees``) steps as one sim
    does, delay-armed or with telemetry too: the delay lines are ``[B, K,
    ...]`` and the draws per replica (``delay_exchange``), B1 runs its
    stack kernel once (``+delays``, ``+tel``), and every frame field is a
    ``[B]`` tensor, each replica's own reduction (``telemetry_run_batch``
    stacks them ``[T, B]``).

    Invariants (``invariants``, a ``models/invariants.py``
    InvariantConfig): after the new state is built, ``apply_invariants``
    checks it against the start-of-tick possession (before a cold-restart
    clear, the rejoiners exempt), the tick's delivered words, the fault
    alive word and the attack bypass mask, and folds the bits into the
    state's ``inv_viol`` / ``inv_first`` (an unarmed state raises the
    reference's ValueError).  It reads what the step computed and writes
    only those two leaves: no kernel and no host sync is added; with
    telemetry the frame is returned as without it.

    RPC probe (``rpc_probe=True``): the step also returns, last (after
    the frame with telemetry), the reference's per-edge probe dict
    (``probe_snapshot``): the attempt masks before fault masking, the
    content words and the tick's fault words; paired, slot B's masks and
    the slot-split payload; delay-armed (the state built with
    ``delays_probe=True``, else the reference's ValueError), the arrival
    masks dequeued from the probe line.  Every value is one the step
    computes anyway: B1 is launched as without the probe, the trajectory
    is the probe-free step's (but for the probe line) and no host sync is
    added.  A replica stack refuses it (``batched_probe``).
    """
    dev = resolve_device(device)
    plan.check_paired_step(cfg, score_cfg, force_split)
    plan.check_step_options(pipeline_gates=pipeline_gates,
                            shard_mesh=shard_mesh)
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
    tel = telemetry
    icfg = invariants
    ws = _telemetry.wire_sizes(tel) if tel is not None else None
    lat_b = tel.latency_buckets if tel is not None and tel.latency_hist else 0
    # the kernel's tally runs for the counters or the latency rows
    with_t = tel is not None and (tel.counters or lat_b > 0)

    # the knob vector of the sim last stepped, keyed by its knob leaves'
    # identity (built once per sim, on the device, never per tick)
    knob_cache = []
    # the delay exchange's edge geometry of the ring last stepped
    geo_cache = {}

    def edge_geometry(n: int) -> EdgeGeometry:
        if n not in geo_cache:
            geo_cache.clear()
            geo_cache[n] = EdgeGeometry.of(cfg, n, dev)
        return geo_cache[n]

    def knob_vector(params: GossipParams):
        """B1's f32 knob operand in the kernel's KNOB_* order (three
        protocol scalars; scored, the four defense knobs after them), or
        None for a sim without knobs."""
        skn, kkn = params.sim_knobs, active_score_knobs(params)
        if skn is None and kkn is None:
            return None
        if knob_cache and knob_cache[0] is skn and knob_cache[1] is kkn:
            return knob_cache[2]
        vals = [cfg.gossip_factor, cfg.d_lazy, cfg.backoff_ticks]
        if skn is not None:
            vals = [skn.gossip_factor, skn.d_lazy, skn.backoff_ticks]
        if sc is not None:
            vals += ([getattr(sc, f) for f in SCORE_KNOB_FIELDS]
                     if kkn is None else
                     [getattr(kkn, f) for f in SCORE_KNOB_FIELDS])
        # (a replica stack's [B] leaves give its [B, K] rows; a baked
        # value is the same in every row)
        lead = next((v.shape for v in vals if isinstance(v, torch.Tensor)),
                    ())
        vec = torch.stack([
            v.to(torch.float32) if isinstance(v, torch.Tensor)
            else torch.full(lead, float(v), dtype=torch.float32, device=dev)
            for v in vals], -1)
        knob_cache[:] = [skn, kkn, vec]
        return vec

    def apply_invariants(params, state, new_state, *, have_pre, rejoin_w,
                         delivered_now, alive_w, sub_all):
        """One tick's checks folded into ``new_state``'s carry (the
        reference's ``apply_invariants``): a readout of the step's own
        values, on the device."""
        bits = _invariants.delivery_violations(
            icfg, have_pre, new_state.have, delivered_now, alive_w=alive_w,
            invalid_words=params.invalid_words if sc is not None else None,
            allowed_clear_w=rejoin_w)
        honest_all = None
        if sc is not None and (sc.sybil_graft_flood or sc.sybil_eclipse):
            # attackers that bypass their own backoff hold mesh edges
            # inside it (the partner accepted)
            bypass = torch.zeros_like(params.subscribed)
            if sc.sybil_graft_flood and params.sybil is not None:
                bypass = bypass | params.sybil
            if sc.sybil_eclipse and params.eclipse_sybil is not None:
                bypass = bypass | params.eclipse_sybil
            honest_all = torch.where(bypass, 0, ALL).to(torch.int32)
        # the mesh words as [C, N] rows, once for both groups
        rows = {}
        if icfg.mesh or (icfg.scores and sc is not None):
            rows["in_mesh"] = _invariants.in_mesh_rows(new_state.mesh, C)
            if paired:
                rows["in_mesh_b"] = _invariants.in_mesh_rows(
                    new_state.mesh_b, C)
        bits = bits | _invariants.gossip_mesh_violations(
            icfg, C, mesh_new=new_state.mesh, backoff_new=new_state.backoff,
            cand_sub_bits=params.cand_sub_bits, sub_all=sub_all,
            honest_all=honest_all, mesh_b_new=new_state.mesh_b,
            backoff_b_new=new_state.backoff_b, **rows)
        if sc is not None and new_state.scores is not None:
            bits = bits | _invariants.gossip_score_violations(
                icfg, sc, new_state.scores, mesh_new=new_state.mesh,
                mesh_b_new=new_state.mesh_b, **rows)
        viol, first = _invariants.fold(state.inv_viol, state.inv_first,
                                       bits, state.tick)
        return replace(new_state, inv_viol=viol, inv_first=first)

    def step(params: GossipParams, state: GossipState):
        check_on(dev, subscribed=params.subscribed, mesh=state.mesh)
        # delays: the reference's checks, in its order
        dl = params.delays
        if dl is not None:
            if paired:
                raise NotImplementedError(plan.MSG_DELAYS_PAIRED)
            if rpc_probe and state.probe_line is None:
                raise ValueError(plan.MSG_DELAYS_NEED_PROBE_LINE)
            if tel is not None and tel.counters and (
                    state.adv_line is None or state.gsp_line is None):
                raise ValueError(plan.MSG_DELAYS_NEED_COUNTER_LINES)
            if state.pay_line is None or state.ctrl_line is None:
                raise ValueError(plan.MSG_DELAYS_NEED_LINES)
        if dl is not None and sc is not None and sc.sybil_iwant_spam:
            # its flood budget reads partner advert views the delayed
            # kernel does not stream
            raise ValueError(plan.MSG_KERNEL_DELAY_IWANT_SPAM)
        # the kernel, or the receive loops where the reference's kernel
        # planner refuses the sim (models/plan.py receive_path)
        route = plan.receive_path(cfg, sc, params, force_split=force_split)
        if route != plan.KERNEL:
            plan.check_loops(paired=paired, telemetry=tel, delays=dl)
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
        if _batch.is_stacked(state):
            # a replica stack: one step for all (B1 once, B3 as often as
            # for one replica)
            plan.check_batched(cfg, sc, params, state, rpc_probe=rpc_probe)
        # the degree family and fanout TTL: ints, or the armed knobs'
        # 0-d tensors (gossip_retransmission's one consumer, the IWANT
        # flood's serve budget, is in the receive loops: a knob point on
        # a flood config runs there)
        K = degree_knobs(cfg, params)
        sub = params.subscribed
        n = sub.shape[-1]
        sub_all = torch.where(sub, graph.i32(ALL), 0).to(torch.int32)
        cand_sub = params.cand_sub_bits
        direct, active = params.cand_direct, state.active
        # -- fault masks, once per tick on the device from the host tick;
        # a peer rejoining this tick under cold restart comes back with
        # its possession words and mcache ring cleared before anything
        # reads them
        fp = params.faults
        fm = None
        if fp is not None:
            fm = _faults.tick_masks(fp, cfg.offsets, cfg.cinv, tick)
        if icfg is not None:
            _invariants.require_armed(state, "gossipsub")
        # the checker's possession-monotonicity exemption: the words before
        # the clear, and the rejoiners
        have_pre, rejoin_w = state.have, None
        if fp is not None and fp.cold_restart:
            rejoin_w = _faults.alive_word(_faults.rejoined_mask(fp, tick))
            clear = ~rejoin_w[..., None, :]
            state = replace(state, have=state.have & clear,
                            recent=state.recent & clear[..., None, :, :])
        if sc is not None:
            (accept_bits, gossip_bits, pub_ok_bits, _, payload_bits,
             targets, _) = state.gates[:7]
            if direct is not None:
                # direct peers bypass the graylist and the gater for
                # control and payload (AcceptFrom gossipsub.go:578)
                accept_bits = accept_bits | direct
                payload_bits = payload_bits | direct
            valid = ~params.invalid_words                   # [W] ([B, W])
        else:
            targets, accept_bits = state.gates[0], None

        def sel_k(elig, kk, phase):
            return kselect.select_k_bits(elig, kk, C,
                                         lane_seed(tick, phase, salt), n)

        # -- 1. publish injection
        due = pack_bits(params.publish_tick == tick)        # [W]
        injected = params.origin_words & due[..., None] & ~state.have
        if fm is not None:
            # a down origin's publish is lost, not deferred
            injected = injected & fm.alive_w[..., None, :]
        publishing = (injected != 0).any(-2)

        # -- 1b. fanout TTL + refill (own publishes only; scored: above
        # the publish threshold)
        last_pub = torch.where(publishing, tick, state.last_pub)
        alive = ~sub & ((tick - last_pub) < _lead(K.fanout_ttl_ticks, 1))
        fanout = torch.where(alive, state.fanout, 0)
        f_need = torch.where(alive, _lead(K.d, 1) - popcount32(fanout), 0)
        f_elig = cand_sub & ~fanout
        if direct is not None:
            # direct peers receive everything anyway
            f_elig = f_elig & ~direct
        if active is not None:
            f_elig = f_elig & active
        if sc is not None:
            f_elig = f_elig & pub_ok_bits
        if fm is not None:
            # dead candidates make useless fanout targets
            f_elig = f_elig & fm.cand_alive
        fanout = fanout | sel_k(f_elig, f_need.to(torch.int32), 4)

        # -- 2. eager-forward and 3. advert words (scored: honest peers
        # drop invalid messages; sybils forward them)
        fresh = state.recent.select(-3, (tick - 1) % Hg) | injected
        adv = injected
        for h in range(Hg):
            adv = adv | state.recent.select(-3, h)
        if sc is not None:
            syb = params.sybil[..., None, :]
            fresh = torch.where(syb, fresh, fresh & valid[..., None])
            adv = torch.where(syb, adv, adv & valid[..., None])
        fresh_all, fresh_b = fresh, None
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
        out_b = None
        if paired:
            # slot B's eager forwards (direct peers on every topic; eclipse
            # attackers silent)
            out_b = state.mesh_b
            if direct is not None:
                out_b = out_b | (direct & cand_sub)
            if eclipse:
                out_b = torch.where(params.eclipse_sybil, 0, out_b)
        probe_raw = None
        if rpc_probe:
            # the RPC probe's attempt masks: the edge words before fault
            # masking; the flood word is every candidate above the publish
            # threshold, as the reference records it (the exporter reads
            # it only where the sender injects)
            flood_raw = None
            if sc is not None and sc.flood_publish:
                flood_raw = cand_sub & pub_ok_bits
                if eclipse:
                    flood_raw = torch.where(params.eclipse_sybil, 0,
                                            flood_raw)
            probe_raw = (out_bits, targets, flood_raw)
        if fm is not None:
            # faults cut sends at their source: a down peer, or either
            # end of a down link, forwards, gossips and floods nothing
            out_bits = out_bits & fm.send_ok
            targets = targets & fm.send_ok
            if flood_bits is not None:
                flood_bits = flood_bits & fm.send_ok
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
                            accept_bits=accept_bits, fmasks=fm)
        sel_b = (maintain_slot(cfg, sc, params, state, 1, sub_all=sub_all,
                               accept_bits=accept_bits, fmasks=fm)
                 if paired else None)

        snap = None
        if rpc_probe:
            snap = probe_snapshot(
                probe_raw, sel=sel, sel_b=sel_b, fm=fm, injected=injected,
                withhold=withhold, fresh=fresh_all, adv=adv, seen=seen,
                all_bits=ALL)
            if paired:
                # slot B's attempt masks and the slot-split payload words
                snap.update(fwd_b=out_b, fresh_a=fresh, fresh_b=fresh_b)

        def tx(word):
            """A handshake word as sent: under faults a dead peer or a
            down link transmits nothing (the local effects of a drop, the
            mesh removal and own backoff, still apply: the kernel reads
            the unmasked words)."""
            return word if fm is None else word & fm.send_ok

        def finish(acq, **fields):
            """The new state from the receive half's outputs (possession,
            mcache ring, deliveries, tick; the gates emitted from the new
            state where ``fields`` brings none) and the delivered words,
            with the checker's bits folded in."""
            recent = state.recent.clone()
            recent.select(-3, tick % Hg).copy_(acq)
            delivered = acq & params.deliver_words
            if sc is not None:
                delivered = delivered & ~params.invalid_words[..., None]
            new = GossipState(
                fanout=fanout, last_pub=last_pub, have=state.have | acq,
                recent=recent,
                first_tick=update_first_tick(state.first_tick, delivered,
                                             tick),
                gates_fp=state.gates_fp, salt=salt, tick=tick + 1,
                inv_viol=state.inv_viol, inv_first=state.inv_first,
                **{"gates": (), **fields})
            if not new.gates:
                new = replace(new, gates=compute_gates(cfg, sc, params, new,
                                                       salt))
            if icfg is not None:
                new = apply_invariants(
                    params, state, new, have_pre=have_pre,
                    rejoin_w=rejoin_w, delivered_now=delivered,
                    alive_w=None if fm is None else fm.alive_w,
                    sub_all=sub_all)
            return new, delivered

        if route != plan.KERNEL:
            # -- the receive loops (models/_receive_loops.py), then PX
            # (4b) and the next tick's gates from the new state
            rx = _loops.receive(
                cfg, sc, params, state, split=route == plan.SPLIT,
                geo=edge_geometry(n), fm=fm, sub_all=sub_all, sel=sel,
                injected=injected, fresh=fresh, adv=adv, seen=seen,
                targets=targets, withhold=withhold, out_bits=out_bits,
                flood_bits=flood_bits,
                payload_bits=payload_bits if sc is not None else None,
                gossip_bits=gossip_bits if sc is not None else None,
                accept_bits=accept_bits,
                valid=valid if sc is not None else None)
            if active is not None and cfg.px_rotation:
                rot = rx["px_rot"]
                if sel["neg"] is not None:
                    rot = rot | sel["neg"]
                active = px_rotate(cfg, params, active=active, rot=rot,
                                   keep=rx["mesh"] | fanout, sel_k=sel_k)
            out = finish(
                rx["acq"], mesh=rx["mesh"], backoff=rx["backoff"],
                scores=(None if sc is None else ScoreState(**rx["scores"])),
                iwant_serves=rx.get("iwant_serves"), active=active)
            return out if snap is None else (*out, snap)

        ops = dict(
            gseeds=(lane_seed(tick + 1, 6, salt),
                    lane_seed(tick + 1, 1, salt)),
            sub_all=sub_all, cand_sub=cand_sub, fanout=fanout,
            wa=sel["would_accept"], grafts=sel["grafts"],
            dropped=sel["dropped"], meshsel=sel["mesh_sel"], seen=seen,
            injected=injected, backoff=state.backoff)
        dex = None
        if dl is None:
            # -- the receive kernel: exchange, handshake, counters, gates;
            # the raw advert (CTRL_ADV) against the delivering one
            # (CTRL_TGT) is the broken promise the receiver sees
            tgt_deliver = (targets if withhold is None
                           else torch.where(withhold, 0, targets))
            ops.update(ctrl=krecv.ctrl_bytes(
                C, out=out_bits, tgt=tgt_deliver, graft=tx(sel["grafts"]),
                drop=tx(sel["dropped"]), a=tx(sel["a_sent"]), adv=targets,
                flood=flood_bits), fresh=fresh, adv=adv)
            if sc is not None:
                ops.update(pay=payload_bits, gsp=gossip_bits,
                           acc=accept_bits)
        else:
            # -- delays: the sends go into the lines and this tick's
            # arrivals come out (faults masked here: a down peer hears
            # nothing); the kernel's delay mode takes the arrivals and the
            # resolved control words in place of the sender streams; the
            # probe's words as sent (after fault masking) ride its line
            probe_sent = None
            if snap is not None:
                flood_sent = probe_raw[2]
                if flood_sent is not None and fm is not None:
                    flood_sent = flood_sent & fm.send_ok
                probe_sent = (out_bits, targets, flood_sent)
            dex = delay_exchange(
                cfg, sc, params, state, tick=tick, sel=sel, targets=targets,
                withhold=withhold, out_bits=out_bits, flood_bits=flood_bits,
                fresh=fresh, adv=adv, injected=injected,
                payload_bits=payload_bits if sc is not None else None,
                gossip_bits=gossip_bits if sc is not None else None,
                accept_bits=accept_bits, fm=fm,
                counters=tel is not None and tel.counters,
                geo=edge_geometry(n), probe=probe_sent)
            if snap is not None:
                # the arrival masks: the probe line's three rows and the
                # control resolved at arrival
                snap.update(arr_fwd=dex["arr_probe"][0],
                            arr_ihave=dex["arr_probe"][1],
                            arr_flood=dex["arr_probe"][2],
                            arr_graft=dex["graft_arr"],
                            arr_prune=dex["prune_arr"])
            arr = dex["arr_pay"]
            if fm is not None:
                arr = arr & fm.alive_w[..., None, None, :]
            ops.update(arr=arr.reshape(*arr.shape[:-3], C * arr.shape[-2], n),
                       graft_arr=dex["graft_arr"],
                       prune_arr=dex["prune_arr"], retract=dex["retract"])
            if dex["cheat_arr"] is not None:
                ops["cheat_arr"] = dex["cheat_arr"]
        if sc is not None:
            s0 = state.scores
            ops.update(
                valid=valid, bo2=sel["backoff_bits2"],
                static=_static_term(sc, params), fd=s0.first_deliveries,
                inv=s0.invalid_deliveries, bp=s0.behaviour_penalty,
                tim=s0.time_in_mesh, iws=state.iwant_serves)
        if paired:
            # slot B's sender flags on a second ctrl byte: its eager
            # forwards and its handshake
            ops.update(
                ctrl2=krecv.ctrl2_bytes(C, out_b=tx(out_b),
                                        graft_b=tx(sel_b["grafts"]),
                                        drop_b=tx(sel_b["dropped"]),
                                        a_b=tx(sel_b["a_sent"])),
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
        if dl is not None:
            # faults and telemetry are composed in the step, not in the
            # delayed kernel
            variant["delays"] = True
        elif fm is not None:
            variant["faults"] = True
        knob_vec = knob_vector(params)
        if knob_vec is not None:
            # gossip_factor, d_lazy and backoff_ticks (and, scored, the
            # defense knobs) are read in the kernel
            variant["knobs"] = True
            ops["knobs"] = knob_vec
        if with_t and dl is None:
            variant.update(telemetry=True, tel_lat_buckets=lat_b)
            if lat_b:
                # the tick's bucket masks and the deliver words the
                # bucket rows count against
                ops["lat_masks"] = _telemetry.latency_bucket_masks(
                    params.publish_tick, tick, lat_b, state.have.shape[-2])
                dlv_eff = params.deliver_words
                if sc is not None:
                    dlv_eff = dlv_eff & ~params.invalid_words[..., None]
                ops["dlv_eff"] = dlv_eff
        kk = kernel_consts(**variant)
        if kk.flood_publish and dl is None:
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
        if kk.faults:
            # the receiver's alive word; under the IWANT flood, the
            # edges a flood may cross (sender alive, link up, partner
            # alive)
            ops["alive_w"] = fm.alive_w
            if kk.iwant_spam:
                ops["flood_ok"] = fm.flood_ok
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
        tel_row = next(outs) if kk.telemetry else None

        # -- epilogue: possession, mcache ring, deliveries, tick
        new_state, delivered_now = finish(
            acq, mesh=mesh_new, backoff=backoff_new, scores=scores,
            iwant_serves=iws_o, gates=gates_new, active=active,
            mesh_b=mesh_b_new, backoff_b=backoff_b_new,
            **({} if dex is None else {
                name: dex.get(name) for name in ("pay_line", "ctrl_line",
                                                 "gsp_line", "adv_line",
                                                 "probe_line")}))
        if tel is None:
            return ((new_state, delivered_now) if snap is None
                    else (new_state, delivered_now, snap))
        # (a replica stack: every field of the frame a [B] tensor, each
        # replica's own reduction)
        kw = {}
        if tel.counters:
            def sent(word):
                # handshake RPCs on the wire: none over a down link or
                # toward a dead partner
                return (word if fm is None
                        else word & fm.send_ok & fm.cand_alive)

            slots = (sel,) if sel_b is None else (sel, sel_b)
            graft_cnt = sum(popcount32(sent(s_["grafts"])).sum(
                -1, dtype=torch.int32) for s_ in slots)
            prune_cnt = sum(popcount32(sent(s_["dropped"])).sum(
                -1, dtype=torch.int32) for s_ in slots)
            sums = (tel_row if dex is None else delayed_tally(
                dex, seen, sub_all, None if fm is None else fm.alive_w))
            kw.update(counter_fields(sums, graft_cnt, prune_cnt, ws
                                     if tel.wire else None))
        if tel.mesh or tel.degree_hist:
            deg_t = popcount32(mesh_new)
            if paired:
                deg_t = deg_t + popcount32(mesh_b_new)
            kw.update(mesh_fields(tel, deg_t, sub))
        if (tel.scores or tel.score_hist) and sc is not None:
            # the start-of-tick scores the gates acted on: one more pass
            # over the [C, N] counters
            score_t = compute_scores(sc, params, state)
            mask_t = graph.expand_bits(cand_sub & sub_all, C)
            if tel.scores:
                kw.update(zip(("score_mean", "score_min", "score_frac_neg",
                               "score_frac_below_gossip"),
                              _telemetry.score_stats(score_t, mask_t,
                                                     sc.gossip_threshold)))
            if tel.score_hist:
                kw["score_hist"] = _telemetry.score_histogram(
                    score_t, mask_t, tel.score_bucket_edges,
                    batch_dims=sub.dim() - 1)
        if lat_b and dex is not None:
            # delays: from the tick's deliveries (the delayed kernel keeps
            # no tally)
            kw["latency_hist"] = _telemetry.latency_histogram(
                delivered_now, params.publish_tick, tick, lat_b)
        elif lat_b:
            kw["latency_hist"] = tel_row[..., len(krecv.TEL_ROWS):]
        if tel.faults and fm is not None:
            kw["down_peers"], kw["dropped_edge_ticks"] = \
                _faults.fault_counts(fp, fm, C)
        frame = _telemetry.make_frame(dev, shape=sub.shape[:-1], **kw)
        return ((new_state, delivered_now, frame) if snap is None
                else (new_state, delivered_now, frame, snap))

    return step


def probe_snapshot(probe_raw, *, sel: dict, sel_b: dict | None, fm,
                   injected, withhold, fresh, adv, seen,
                   all_bits: int) -> dict:
    """One tick's RPC probe dict (the reference's ``rpc_snap``): the
    attempt masks before fault masking (``fwd`` eager forward, ``ihave``
    the advert targets, ``graft`` / ``prune`` the handshake, ``flood``
    the publish flood), the content words (``inj`` the injected publishes,
    ``fresh`` the eager-forward set, ``adv`` the advert window, ``seen``
    the possession with this tick's publishes) and the fault words
    (``send_ok``, ``alive``; all-healthy constants without a schedule);
    ``withhold`` the promise breakers (bool).  ``sel_b``, paired: slot B's
    handshake.  Every value is the step's own: a readout."""
    fwd, ihave, flood = probe_raw
    n = fwd.shape[-1]
    dev = fwd.device
    snap = dict(
        fwd=fwd, ihave=ihave, graft=sel["grafts"], prune=sel["dropped"],
        flood=(flood if flood is not None
               else torch.zeros((n,), dtype=torch.int32, device=dev)),
        inj=injected,
        withhold=(withhold if withhold is not None
                  else torch.zeros((n,), dtype=torch.bool, device=dev)),
        send_ok=(fm.send_ok if fm is not None else torch.full(
            (n,), graph.i32(all_bits), dtype=torch.int32, device=dev)),
        alive=(fm.alive if fm is not None
               else torch.ones((n,), dtype=torch.bool, device=dev)),
        fresh=fresh, adv=adv, seen=seen)
    if sel_b is not None:
        snap.update(graft_b=sel_b["grafts"], prune_b=sel_b["dropped"])
    return snap


def delayed_tally(dex: dict, seen: torch.Tensor, sub_all: torch.Tensor,
                  alive_w: torch.Tensor | None) -> torch.Tensor:
    """The counters' tally rows (``krecv.TEL_ROWS`` order) of a delayed
    tick: the send side counted at the send tick (``dex["tel_send"]``),
    the arrival side against this tick's possession ``seen`` from the
    dequeued payload, gossip-class and advert words (a down receiver's
    masked by ``alive_w``): copies received, gossip-pulled ids it lacked,
    advertised ids it lacked and the (edge, receiver) pairs with one, and
    the subscribers' new ids.  int32 [8]; a replica stack's [B, 8], each
    replica's own sums."""
    got, g_gsp, g_adv = dex["arr_pay"], dex["arr_gsp"], dex["arr_adv"]
    if alive_w is not None:
        a_w = alive_w[..., None, None, :]
        got, g_gsp, g_adv = (x & a_w for x in (got, g_gsp, g_adv))
    lead = seen.dim() - 2
    lack = ~seen.unsqueeze(-3)                               # [1, W, N]
    req = popcount32(g_adv & lack).sum(-2, dtype=torch.int32)  # [C, N]
    heard = (got & lack).select(-3, 0)
    for j in range(1, got.shape[-3]):
        heard = heard | (got.select(-3, j) & lack.select(-3, 0))

    def total(x):
        return x.reshape(*x.shape[:lead], -1).sum(-1, dtype=torch.int64)

    ts = dex["tel_send"]
    rows = [ts["payload"], ts["ihave_ids"], total(popcount32(g_gsp & lack)),
            total(popcount32(got)), total(req), ts["ihave_rpcs"],
            total(req > 0),
            total(popcount32(torch.where(sub_all[..., None, :] != 0, heard,
                                         0)))]
    return torch.stack(rows, -1).to(torch.int32)


def counter_fields(sums: torch.Tensor, graft_cnt, prune_cnt,
                   ws: _telemetry.WireSizes | None) -> dict:
    """The counters group of a frame from one tick's tally rows (int32
    [8 + ...], ``krecv.TEL_ROWS`` order; a replica stack's [B, 8 + ...])
    and its GRAFT and PRUNE counts;
    with ``ws`` the wire bytes, f32 products of the exact counts added in
    the reference's order."""
    out = dict(
        payload_sent=sums[..., krecv.TEL_PAYLOAD],
        ihave_rpcs=sums[..., krecv.TEL_IHAVE_RPCS],
        ihave_ids=sums[..., krecv.TEL_IHAVE_IDS],
        iwant_rpcs=sums[..., krecv.TEL_IWANT_RPCS],
        iwant_ids_requested=sums[..., krecv.TEL_IWANT_REQ],
        iwant_ids_served=sums[..., krecv.TEL_IWANT_SERVED],
        graft_sends=graft_cnt, prune_sends=prune_cnt,
        dup_suppressed=sums[..., krecv.TEL_RECV]
        - sums[..., krecv.TEL_NEW_IDS])
    if ws is not None:
        def f32(x):
            return x.to(torch.float32)

        out["bytes_payload"] = (
            f32(out["payload_sent"] + out["iwant_ids_served"])
            * float(ws.payload_frame))
        out["bytes_control"] = (
            f32(out["ihave_rpcs"]) * float(ws.ihave_base)
            + f32(out["ihave_ids"]) * float(ws.ihave_per_id)
            + f32(out["iwant_rpcs"]) * float(ws.iwant_base)
            + f32(out["iwant_ids_requested"]) * float(ws.iwant_per_id)
            + f32(graft_cnt) * float(ws.graft_frame)
            + f32(prune_cnt) * float(ws.prune_frame))
    return out


def mesh_fields(tel: _telemetry.TelemetryConfig, deg: torch.Tensor,
                subscribed: torch.Tensor) -> dict:
    """The mesh group (and the degree histogram) of a frame from the
    end-of-tick mesh degrees."""
    out = {}
    if tel.mesh:
        out.update(zip(("mesh_deg_min", "mesh_deg_mean", "mesh_deg_max"),
                       _telemetry.degree_stats(deg, subscribed)))
    if tel.degree_hist:
        out["mesh_deg_hist"] = _telemetry.degree_histogram(
            deg, subscribed, tel.degree_buckets)
    return out


# --------------------------------------------------------------------------
# Runners and readouts
# --------------------------------------------------------------------------


def window_masks(cfg: GossipSimConfig, fp: _faults.FaultParams | None,
                 tick0: int, ticks: int) -> list:
    """Each tick's fault masks of a window (``faults.tick_masks``; none
    without a schedule)."""
    if fp is None:
        return []
    return [_faults.tick_masks(fp, cfg.offsets, cfg.cinv, tick0 + t)
            for t in range(ticks)]


def window_fault_rows(cfg: GossipSimConfig,
                      fp: _faults.FaultParams | None, tick0: int,
                      ticks: int, masks: list | None = None) -> dict:
    """A fused window's per-tick fault rows, int32 [T, N] on the device:
    each tick's masks as the step computes them (``alive``, ``send_ok``,
    ``cand_alive``; with cold restart ``rejoin``), or none without a
    schedule; ``masks``, the window's ``window_masks`` when already made
    (the telemetry window's faults group reads them too)."""
    if fp is None:
        return {}
    if masks is None:
        masks = window_masks(cfg, fp, tick0, ticks)
    rows = dict(alive=torch.stack([m.alive_w for m in masks]),
                send_ok=torch.stack([m.send_ok for m in masks]),
                cand_alive=torch.stack([m.cand_alive for m in masks]))
    if fp.cold_restart:
        rows["rejoin"] = torch.stack([
            _faults.alive_word(_faults.rejoined_mask(fp, tick0 + t))
            for t in range(ticks)])
    return rows


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
    gossip targets, with or without a fault schedule (and cold restart);
    a sim with PX or direct peers is refused by name.  With
    ``telemetry`` the window returns ``(state, delivered, frames)``, each
    frame leaf stacked [T, ...] and equal to the per-tick telemetry
    step's: the counters and latency rows from the kernel's per-tick
    tally (GRAFT and PRUNE transmitted counted in the kernel), the mesh
    gauges from its per-tick mesh rows, the faults group from the
    window's masks.

    On the host the window computes the T x 4 lane seeds; the T due
    words and, under faults, the T ticks' fault rows
    (``window_fault_rows``: T link draws) are computed on the device
    before the launch, so a window never syncs with the host.  A window
    the port does not run raises its named refusal
    (``plan.check_fused_window``; on the card, ``fused_grid`` from the
    launch) — there is no per-tick fallback."""
    dev = resolve_device(device)
    T = int(ticks_fused)
    plan.check_fused_window(cfg, score_cfg, T, shard_mesh=shard_mesh)
    tel = telemetry
    lat_b = tel.latency_buckets if tel is not None and tel.latency_hist else 0
    # the kernel's telemetry rows serve the counters, latency and mesh
    # groups
    with_t = tel is not None and (tel.counters or lat_b > 0 or tel.mesh
                                  or tel.degree_hist)
    ws = _telemetry.wire_sizes(tel) if tel is not None else None
    k = kfused.fused_consts(cfg, telemetry=with_t, tel_lat_buckets=lat_b)
    C = cfg.n_candidates
    all_c = (1 << C) - 1
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
        fp = params.faults
        masks = window_masks(cfg, fp, tick0, T)
        tel_ops = {}
        if lat_b:
            tel_ops = dict(lat_masks=_telemetry.latency_bucket_masks(
                params.publish_tick, ticks[:, None], lat_b,
                state.have.shape[0]), dlv=params.deliver_words)
        (have, recent, mesh, fanout, last_pub, backoff, tgt, bog, acq,
         *tel_out) = kfused.fused_gossip_update(
            k, tick0=tick0, seeds=kfused.window_seeds(tick0, T, state.salt),
            due=due,
            sub_all=torch.where(params.subscribed, all_c, 0).to(
                torch.int32),
            cand_sub=params.cand_sub_bits, origin=params.origin_words,
            have=state.have, recent=state.recent, mesh=state.mesh,
            fanout=state.fanout, last_pub=state.last_pub,
            backoff=state.backoff, tgt=state.gates[0], bog=state.gates[1],
            **window_fault_rows(cfg, fp, tick0, T, masks), **tel_ops)
        delivered = acq & params.deliver_words[None]
        first_tick = state.first_tick
        for t in range(T):
            first_tick = update_first_tick(first_tick, delivered[t],
                                           tick0 + t)
        new_state = replace(state, mesh=mesh, fanout=fanout,
                            last_pub=last_pub, backoff=backoff, have=have,
                            recent=recent, first_tick=first_tick,
                            gates=(tgt, bog), tick=tick0 + T)
        if tel is None:
            return new_state, delivered
        mesh_rows, tel_rows = tel_out if with_t else (None, None)
        n_rows = len(krecv.TEL_ROWS)
        frames = []
        for t in range(T):
            kw = {}
            if tel.counters:
                sums = tel_rows[t]
                kw.update(counter_fields(
                    sums, sums[n_rows + lat_b], sums[n_rows + lat_b + 1],
                    ws if tel.wire else None))
            if tel.mesh or tel.degree_hist:
                kw.update(mesh_fields(tel, popcount32(mesh_rows[t]),
                                      params.subscribed))
            if lat_b:
                kw["latency_hist"] = tel_rows[t, n_rows:n_rows + lat_b]
            if tel.faults and fp is not None:
                kw["down_peers"], kw["dropped_edge_ticks"] = \
                    _faults.fault_counts(fp, masks[t], C)
            frames.append(_telemetry.make_frame(dev, **kw))
        return new_state, delivered, _telemetry.stack_frames(frames)

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
        state, delivered = step(params, state)[:2]
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


def gossip_run_frames_fused(params: GossipParams, state: GossipState,
                            n_ticks: int, window, *,
                            device: str | torch.device | None = None):
    """The telemetry runner over fused windows (``make_fused_window`` with
    ``telemetry``): ``(state, frames)``, every frame leaf ``[n_ticks,
    ...]`` and equal to ``telemetry_run`` with the per-tick telemetry
    step's frames; concatenated once at the end."""
    dev = resolve_device(device)
    check_on(dev, subscribed=params.subscribed, mesh=state.mesh)
    frames = []
    for _ in range(plan.check_fused_horizon(n_ticks, window.ticks_fused)):
        state, _, fr = window(params, state)
        frames.append(fr)
    return state, _telemetry.concat_frames(frames)


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
        state, delivered = window(params, state)[:2]
        rows += [count_bits_per_position(d, n_msgs) for d in delivered]
    counts = (torch.stack(rows) if rows else
              torch.zeros((0, n_msgs), dtype=torch.int32, device=dev))
    return state, counts


def _snapshot_run(params: GossipParams, state: GossipState, n_ticks: int,
                  step, take, device) -> tuple:
    """Advance ``n_ticks`` collecting ``take(step output)`` (a dict of
    tensors) each tick; the rows stay on the device and are stacked once,
    at the end, every leaf ``[n_ticks, ...]``."""
    dev = resolve_device(device)
    check_on(dev, subscribed=params.subscribed, mesh=state.mesh)
    if _batch.is_stacked(state):
        plan.refuse("batched_probe")
    rows = []
    for _ in range(n_ticks):
        out = step(params, state)
        state = out[0]
        rows.append(take(out))
    return state, ({k: torch.stack([r[k] for r in rows]) for k in rows[0]}
                   if rows else {})


def _mesh_rows(s: GossipState, have: bool) -> dict:
    snap = {"have": s.have} if have else {}
    snap["mesh"] = s.mesh
    if s.mesh_b is not None:
        snap["mesh_b"] = s.mesh_b
    return snap


def gossip_run_mesh_snapshots(params: GossipParams, state: GossipState,
                              n_ticks: int, step, *,
                              device: str | torch.device | None = None):
    """Advance ``n_ticks`` collecting the end-of-tick mesh word: ``(state,
    snaps)``, ``snaps["mesh"]`` int32 [n_ticks, N] (and ``"mesh_b"``
    paired), row k the mesh after tick ``start + k`` — the input of
    ``interop.export.mesh_trace_events``.  Any step, with telemetry or
    not."""
    return _snapshot_run(params, state, n_ticks, step,
                         lambda out: _mesh_rows(out[0], False), device)


def gossip_run_acq_snapshots(params: GossipParams, state: GossipState,
                             n_ticks: int, step, *,
                             device: str | torch.device | None = None):
    """Advance ``n_ticks`` collecting the end-of-tick possession and mesh
    words: ``snaps["have"]`` int32 [n_ticks, W, N], ``snaps["mesh"]``
    [n_ticks, N] (and ``"mesh_b"`` paired) — the input of
    ``interop.export.reject_events`` and ``duplicate_events``."""
    return _snapshot_run(params, state, n_ticks, step,
                         lambda out: _mesh_rows(out[0], True), device)


def gossip_run_rpc_snapshots(params: GossipParams, state: GossipState,
                             n_ticks: int, step, *,
                             device: str | torch.device | None = None):
    """Advance ``n_ticks`` collecting the RPC probe dict, the step's last
    output (``make_gossip_step(..., rpc_probe=True)``, with telemetry or
    not): every probe leaf gains a leading [n_ticks] — the input of
    ``interop.export.rpc_events``."""
    return _snapshot_run(params, state, n_ticks, step,
                         lambda out: out[-1], device)


# --------------------------------------------------------------------------
# Replica batching: B sims of one static config, one step a tick
# --------------------------------------------------------------------------


#: the make_gossip_sim options that shape the step and must agree across
#: the replicas of a stack (the reference's list)
STACK_STATIC_KEYS = ("score_cfg", "track_first_tick", "pad_to_block",
                     "px_candidates")


def stack_sims(cfg: GossipSimConfig, specs, *, device=None, **common):
    """Build B replicas of ONE static config and stack them for the
    batched runners: ``specs`` is a list of make_gossip_sim keyword dicts
    (subs, msg_topic, msg_origin, msg_publish_tick, seed, ...), ``common``
    the keywords every replica shares.  Returns ``(params_B, state_B)``,
    every leaf with a leading replica axis (``models/_batch.py``).  A
    spec that disagrees on static config (STACK_STATIC_KEYS) raises here,
    naming the key, with the reference's message."""
    merged = [{**common, **spec} for spec in specs]
    for key in STACK_STATIC_KEYS:
        vals = [m.get(key) for m in merged]
        for i, v in enumerate(vals[1:], start=1):
            if v != vals[0]:
                raise ValueError(
                    f"stack_sims: replica {i} spec disagrees with "
                    f"replica 0 on static config {key!r} "
                    f"({v!r} vs {vals[0]!r}) — all replicas of a batch "
                    "share one compiled step, so static config must "
                    "match (vary arrays instead)")
    builds = [make_gossip_sim(cfg, device=device, **m) for m in merged]
    return (stack_trees([b[0] for b in builds]),
            stack_trees([b[1] for b in builds]))


def _check_stack(params: GossipParams, state: GossipState, dev) -> None:
    check_on(dev, subscribed=params.subscribed, mesh=state.mesh)
    if not _batch.is_stacked(state) or params.subscribed.dim() != 2:
        raise ValueError("the batched runners take a replica stack "
                         "(stack_sims / stack_trees): one sim runs on "
                         "gossip_run")


def gossip_run_batch(params: GossipParams, state: GossipState,
                     n_ticks: int, step, *,
                     device: str | torch.device | None = None
                     ) -> GossipState:
    """Advance B stacked replicas (``stack_sims`` / ``stack_trees``)
    ``n_ticks`` heartbeats, ONE step a tick for the whole stack (B1 once,
    B3 as often as for one replica).  Per replica the trajectory is
    bit-identical to ``gossip_run`` on that replica alone."""
    dev = resolve_device(device)
    _check_stack(params, state, dev)
    for _ in range(n_ticks):
        state = step(params, state)[0]
    return state


def gossip_run_curve_batch(params: GossipParams, state: GossipState,
                           n_ticks: int, step, n_msgs: int, *,
                           device: str | torch.device | None = None):
    """``gossip_run_curve`` over B stacked replicas: returns ``(state_B,
    counts int32 [n_ticks, B, n_msgs])``."""
    dev = resolve_device(device)
    _check_stack(params, state, dev)
    rows = []
    for _ in range(n_ticks):
        state, delivered = step(params, state)[:2]
        rows.append(count_bits_per_position(delivered, n_msgs))
    b = params.subscribed.shape[0]
    counts = (torch.stack(rows) if rows else
              torch.zeros((0, b, n_msgs), dtype=torch.int32, device=dev))
    return state, counts


def gossip_run_knob_batch(params: GossipParams, state: GossipState,
                          n_ticks: int, step, honest=None, *,
                          device: str | torch.device | None = None):
    """The sweep engine: B stacked replicas, each with its own SimKnobs
    point, fault tables, attack formation flags, seed and message
    schedule under ONE static config, ``n_ticks`` heartbeats on one step
    a tick, then every replica's final per-message reach from the
    possession words, honest-masked where ``honest`` (bool [B, N], a
    tensor or a numpy array) is given.  Returns ``(state_B, reach int32
    [B, M])``; with invariant-armed states each replica's carry is in
    ``state_B.inv_viol`` / ``inv_first`` ([B])."""
    dev = resolve_device(device)
    state = gossip_run_batch(params, state, n_ticks, step, device=dev)
    mask = None
    if honest is not None:
        mask = torch.as_tensor(np.asarray(honest, dtype=bool)
                               if not isinstance(honest, torch.Tensor)
                               else honest, device=dev)
    return state, reach_counts_from_have(params, state, mask)


#: the tournament's name for the knob batch (the reference's alias)
gossip_run_tournament = gossip_run_knob_batch


def reach_counts(params: GossipParams, state: GossipState) -> torch.Tensor:
    return reach_counts_from_first_tick(state.first_tick,
                                        params.publish_tick.shape[0])


def reach_counts_from_have(params: GossipParams, state: GossipState,
                           mask: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Per-message reached-peer counts from the possession words
    (optional bool [N] ``mask`` restricts the count); a replica stack's
    [B, M], ``mask`` [B, N]."""
    m = params.publish_tick.shape[-1]
    shifts = torch.arange(WORD_BITS, dtype=torch.int32,
                          device=state.have.device)
    bits = (state.have[..., :, None, :] >> shifts[:, None]) & 1
    if mask is not None:
        bits = bits * mask.to(torch.int32)[..., None, None, :]
    counts = bits.sum(-1, dtype=torch.int32)
    return counts.reshape(*counts.shape[:-2], -1)[..., :m]


def mesh_degrees(state: GossipState) -> torch.Tensor:
    return popcount32(state.mesh)


def first_tick_matrix(state: GossipState, m: int) -> torch.Tensor:
    """int16 [N, M]: the tick peer p first held message m, -1 never."""
    return first_tick_to_matrix(state.first_tick, m)


def reach_by_hops(params: GossipParams, state: GossipState, max_hops: int,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """int32 [M, max_hops]: cumulative deliveries by hop (ticks after the
    publish); ``mask`` (bool [N]) counts a peer subset only (say, the
    honest peers).  One hop at a time: no [hops, N, M] temporary."""
    m = params.publish_tick.shape[0]
    ft = first_tick_to_matrix(state.first_tick, m).to(torch.int32)
    rel = torch.where(ft >= 0, ft - params.publish_tick[None, :], -1)
    if mask is not None:
        rel = torch.where(torch.as_tensor(mask, device=rel.device)[:, None],
                          rel, -1)
    per_hop = torch.stack([(rel == h).sum(0, dtype=torch.int32)
                           for h in range(max_hops)])
    return torch.cumsum(per_hop, 0, dtype=torch.int32).T


def transfer_mask(mask: torch.Tensor, cfg: GossipSimConfig) -> torch.Tensor:
    """The edge transfer of an unpacked bool [C, N] mask: row cinv[c] is
    row c rolled by o_c (``transfer_bits`` on packed words)."""
    rows = [None] * cfg.n_candidates
    for c, off in enumerate(cfg.offsets):
        rows[cfg.cinv[c]] = torch.roll(mask[c], int(off), 0)
    return torch.stack(rows)


def mesh_matrix(state: GossipState, cfg: GossipSimConfig) -> torch.Tensor:
    """The mesh word as bool [C, N]."""
    return expand_bits(state.mesh, cfg.n_candidates)


def mesh_symmetry_fraction(state: GossipState,
                           cfg: GossipSimConfig) -> torch.Tensor:
    """f32 []: the share of mesh edges whose partner holds the edge too."""
    partner = transfer_bits(state.mesh, cfg)
    agree = popcount32(state.mesh & partner).sum(dtype=torch.int32)
    total = popcount32(state.mesh).sum(dtype=torch.int32)
    return agree.to(torch.float32) / total.clamp(min=1).to(torch.float32)


def score_snapshot(sc: ScoreSimConfig, params: GossipParams,
                   st: GossipState) -> dict:
    """Every edge's score by component (the reference's
    ``WithPeerScoreInspect`` readout): f32 [C, N] weighted contributions
    ``p1_time_in_mesh``, ``p2_first_deliveries``,
    ``p3_mesh_delivery_deficit`` and ``p3b_mesh_failure_penalty`` (zero
    without P3 tracking), ``p4_invalid_deliveries``, ``p5_app_specific``,
    ``p6_ip_colocation``, ``p7_behaviour_penalty``, paired also
    ``p1b_time_in_mesh``, and their sum ``score`` (the topic part capped
    at ``topic_score_cap``), in the reference's operation order."""
    s = st.scores
    c = s.time_in_mesh.shape[-2]
    f32 = lambda x: x.to(torch.float32)  # noqa: E731
    tim = f32(s.time_in_mesh)
    invd = f32(s.invalid_deliveries)
    w = sc.topic_weight
    kn = active_score_knobs(params)
    w_inv = (kn.invalid_message_deliveries_weight if kn is not None
             else sc.invalid_message_deliveries_weight)
    w_bp = (kn.behaviour_penalty_weight if kn is not None
            else sc.behaviour_penalty_weight)
    out = {
        "p1_time_in_mesh": w * sc.time_in_mesh_weight * torch.clamp(
            tim / sc.time_in_mesh_quantum, max=sc.time_in_mesh_cap),
        "p2_first_deliveries": (w * sc.first_message_deliveries_weight
                                * f32(s.first_deliveries)),
        "p4_invalid_deliveries": w * w_inv * invd * invd,
        "p5_app_specific": sc.app_specific_weight * params.cand_app_score,
        "p6_ip_colocation": (sc.ip_colocation_factor_weight
                             * params.cand_colo_excess
                             * params.cand_colo_excess),
    }
    if sc.track_p3:
        in_mesh = expand_bits(st.mesh, c)
        deficit = torch.clamp(sc.mesh_message_deliveries_threshold
                              - f32(s.mesh_deliveries), min=0.0)
        active = tim > sc.mesh_message_deliveries_activation
        out["p3_mesh_delivery_deficit"] = (
            w * sc.mesh_message_deliveries_weight
            * torch.where(in_mesh & active, deficit * deficit, 0.0))
        out["p3b_mesh_failure_penalty"] = (
            w * sc.mesh_failure_penalty_weight
            * f32(s.mesh_failure_penalty))
    else:
        out["p3_mesh_delivery_deficit"] = torch.zeros_like(tim)
        out["p3b_mesh_failure_penalty"] = torch.zeros_like(tim)
    if s.time_in_mesh_b is not None:
        out["p1b_time_in_mesh"] = w * sc.time_in_mesh_weight * torch.clamp(
            f32(s.time_in_mesh_b) / sc.time_in_mesh_quantum,
            max=sc.time_in_mesh_cap)
    bp_excess = torch.clamp(f32(s.behaviour_penalty)
                            - sc.behaviour_penalty_threshold, min=0.0)
    out["p7_behaviour_penalty"] = w_bp * bp_excess * bp_excess
    topic_part = (out["p1_time_in_mesh"] + out["p2_first_deliveries"]
                  + out["p3_mesh_delivery_deficit"]
                  + out["p3b_mesh_failure_penalty"]
                  + out["p4_invalid_deliveries"])
    if "p1b_time_in_mesh" in out:
        topic_part = topic_part + out["p1b_time_in_mesh"]
    if sc.topic_score_cap > 0:
        # the cap binds the summed topic part only (score.go:256-268)
        topic_part = torch.clamp(topic_part, max=sc.topic_score_cap)
    out["score"] = (topic_part + out["p5_app_specific"]
                    + out["p6_ip_colocation"]
                    + out["p7_behaviour_penalty"])
    return out


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
