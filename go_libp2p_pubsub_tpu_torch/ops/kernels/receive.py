"""The heartbeat's receive half: the CUDA kernel ``csrc/receive.cu`` and
its plain PyTorch version.

Counterpart of ``go_libp2p_pubsub_tpu/ops/pallas/receive.py``
(``make_receive_update`` / ``_receive_kernel``) for the options the port
runs, scored (v1.1) and unscored (v1.0, ``score_cfg=None``); scored,
with or without the attack options (``track_promises``, the IHAVE-spam
targets override and the IWANT-flood serve accrual); the router-surface
options, served by one more kernel variant (``ReceiveConsts.full``):
flood publishing and the shared-IP gater (scored), exact-k gossip
targets and the PX trigger word (scored or not); and paired topics
(``ReceiveConsts.paired``, one more variant with every option of the
full one): a second topic slot with its own handshake, mesh, backoff
and, scored, time in mesh; and each of these under fault schedules
(``ReceiveConsts.faults``); and each of these with the telemetry tally
(``ReceiveConsts.telemetry``, the ``+tel`` variants, from a source of
their own, ``csrc/receive_tel.cu``); and each of these with the knob
vector (``ReceiveConsts.knobs``, the ``+knobs`` variants, from
``csrc/receive_knobs.cu`` and ``csrc/receive_tel_knobs.cu``); and the
delay mode (``ReceiveConsts.delays``, the ``+delays`` variants of the
flagship, attack, full and unscored families, with and without knobs,
from ``csrc/receive_delays.cu``), where the arrivals come from the
step's delay lines in place of the sender streams.
The port runs unpadded, so the sender view of edge j is the plain
``(p + o_j) mod N`` read — no wrap-extended flats.

Operands (peer axis last, packed u32 words as int32), both variants:

- ``gseeds`` (gater, targets): host u32 lane seeds for tick + 1 (the
  unscored variant draws only the targets);
- ``ctrl`` uint8 [C, N]: per sender edge bit, the CTRL_* flags;
- ``fresh``, ``adv`` [W, N]: the senders' eager and advert words;
- ``sub_all``, ``cand_sub``, ``fanout``, ``wa``, ``grafts``,
  ``dropped``, ``meshsel`` [N];
- ``seen``, ``injected`` [W, N]; ``backoff`` int16 [C, N].

Scored only (``SCORED_OPERANDS``):

- ``valid`` int32 [W]: message validity masks (``~invalid_words``);
- ``pay``, ``gsp``, ``acc``, ``bo2`` [N];
- ``static`` f32 [C, N] or None (an all-zero static score is elided);
- ``fd``, ``inv`` (counter dtype), ``bp`` (bp dtype), ``tim``, ``iws``
  int16, all [C, N].

With the attack options (``ReceiveConsts.attacks``): ``syb`` int32 [N],
the sybil word (all C bits for an IHAVE- or IWANT-spamming sybil, else
0).  With ``flood_publish``: ``inj_send`` int32 [W, N], the injected
words once more, read as a sender stream over the edges whose ctrl byte
carries CTRL_FLOOD.  With ``with_same_ip``: ``same_ip`` int32 [C, N],
the same-IP sibling words (bit c of row cc: candidates c and cc share an
address).  Paired (``PAIRED_OPERANDS``): ``ctrl2`` uint8 [C, N], slot
B's sender flags (CTRL2_*); ``fresh_b`` [W, N], the senders' slot-B
words, read over the edges whose ``ctrl2`` carries CTRL2_OUT_B;
``wa_b``, ``grafts_b``, ``dropped_b``, ``meshsel_b`` [N] and, scored,
``bo2_b`` [N]; ``backoff_b`` int16 [C, N] and, scored, ``tim_b`` int16
[C, N].  On an edge whose offset is an odd multiple of T/2
(``ReceiveConsts.odd_mask``) the partner holds the topic in its other
slot: the two ctrl bytes' GRAFT/PRUNE/A bits cross slots.  Under
faults: ``alive_w`` int32 [N], the receiver's alive word (all-ones, or
0 at a down peer), which gates the words it hears and the GRAFT, PRUNE,
A and broken-promise bits it receives (the senders' masks ride the
ctrl bytes); with the IWANT flood also ``flood_ok`` int32 [N], the
edges a flood may cross (sender alive, link up, partner alive).
With telemetry and latency buckets (``tel_lat_buckets`` L > 0):
``lat_masks`` int32 [L, W], the tick's latency-bucket message masks
(``models/telemetry.py`` ``latency_bucket_masks``), and ``dlv_eff``
int32 [W, N], the deliver words the bucket tallies count against
(scored: ``deliver_words & ~invalid_words``).  In delay mode
(``DELAY_OPERANDS``) no ``ctrl``, ``fresh``, ``adv``, ``inj_send`` and,
scored, no ``pay``, ``gsp``, ``acc``: ``arr`` int32 [C·W, N], this
tick's arrivals per receiving edge (row j·W + w; send-gated, rolled and
alive-masked by the step), ``graft_arr`` and ``prune_arr`` [N], the
GRAFT and PRUNE bits arriving (alive-masked and, scored, accept-gated),
``retract`` [N], the retractions taking effect, and with the attack
options tracking promises ``cheat_arr`` [N], the broken-promise adverts
arriving (a bit counts where the receiver lacks some id).  With knobs:
``knobs`` float32 [3] unscored, [7] scored, the armed knob values in the
reference's ``KNOB_*`` order (``gossip_factor``, ``d_lazy``,
``backoff_ticks``; the P4 and P7 weights, the graylist and gossip
thresholds), read in place of the baked constants; the integer knobs are
exact through float32 and cast back where consumed.

Returns make_receive_update's output order: scored ``(acq [W, N], mesh
[N], backoff [C, N], *gates (7 x [N]), fd, inv, bp, tim, iws)``,
unscored ``(acq, mesh, backoff, targets, backoff gate)``; paired, each
slot-B output after its slot-A twin (``mesh_b`` after ``mesh``,
``backoff_b`` after ``backoff``, ``tim_b`` after ``tim``) and slot B's
backoff gate row after the others; with ``with_px`` one more word last,
``px_rot`` int32 [N]: the PRUNEs and PRUNE-responses received (paired:
either slot's), which trigger the step's PX rotation (the targets row
of such a launch is written before the rotation and the step overwrites
it); with telemetry one more output last, ``tel`` int32 [8 + L]: the
tick's tally in the reference's row order (``TEL_ROWS``), then the L
latency-bucket rows.

A replica stack (``models/_batch.py``): every operand with a leading
[B] (``valid`` [B, W], ``knobs`` [B, K], ``lat_masks`` [B, L, W]) and
``gseeds`` two int [B] tensors, one launch for the B replicas (the
flagship and attack options' stack kernels, ``*_reps``: with and without
faults and knobs in ``csrc/receive.cu`` and ``csrc/receive_knobs.cu``,
their delay mode in ``csrc/receive_delays_reps.cu``, their telemetry
tally in ``csrc/receive_tel_reps.cu`` and ``csrc/receive_tel_knobs_reps.cu``),
every output with a leading [B] (each gate a contiguous [B, N] block, the
tally [B, 8 + L]); the plain version runs each replica's operands in
turn.  Paired topics and the full variant take one sim (``batched_*``
refusals).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import graph
from ...models import plan
from . import _build

# ctrl byte layout (receive.py CTRL_*): per sender edge bit c, one byte
CTRL_OUT = 0       # eager-forward member (mesh | fanout)
CTRL_TGT = 1       # lazy-gossip target (delivering)
CTRL_GRAFT = 2     # GRAFT sent
CTRL_DROP = 3      # PRUNE sent (prunes | negative-score drops)
CTRL_A = 4         # "no PRUNE would come back"
CTRL_ADV = 5       # raw IHAVE advert
CTRL_FLOOD = 6     # flood-publish target (own publishes, flood_publish)
# second ctrl byte (paired topics): the slot-B flags of the same edge
CTRL2_OUT_B = 0    # slot-B eager-forward member (mesh_b | direct)
CTRL2_GRAFT_B = 1  # slot-B GRAFT sent
CTRL2_DROP_B = 2   # slot-B PRUNE sent
CTRL2_A_B = 3      # slot-B "no PRUNE would come back"
N_GATES = 7        # accept, gossip, publish, nonneg, payload, targets, backoff
N_GATES_UNSCORED = 2   # targets, backoff
#: the telemetry tally's rows (ops/pallas/receive.py TEL_*), summed over
#: the receivers: payload copies sent (eager, slot B, flood), ids
#: advertised, gossip-pulled ids delivered, received copies (the merged
#: word after the alive mask), advertised ids the receiver lacked, edges
#: carrying a nonempty IHAVE, (edge, receiver) pairs with a lacked id,
#: new acquisitions; the latency-bucket rows follow
TEL_ROWS = ("payload", "ihave_ids", "iwant_served", "recv", "iwant_req",
            "ihave_rpcs", "iwant_rpcs", "new_ids")
(TEL_PAYLOAD, TEL_IHAVE_IDS, TEL_IWANT_SERVED, TEL_RECV, TEL_IWANT_REQ,
 TEL_IHAVE_RPCS, TEL_IWANT_RPCS, TEL_NEW_IDS) = range(len(TEL_ROWS))
#: the knob vector's rows (ops/pallas/receive.py KNOB_*): the first three
#: always, the defense knobs scored only
(KNOB_GF, KNOB_DLAZY, KNOB_BT, KNOB_INVW, KNOB_BPW, KNOB_GRAY,
 KNOB_GSP) = range(7)

#: launches of the CUDA kernel by variant (``variant(k)``: scored,
#: unscored, attacks, full, paired, paired_unscored, each also with a
#: ``_faults`` suffix, and each of those with a ``+tel`` suffix; the first
#: four and unscored full with a ``+delays`` suffix; then a ``+knobs``
#: suffix), a replica stack's launch (one for B replicas) under its
#: variant's key;
#: chip_smoke.py clears it before a main path and reads it after
launches: Counter[str] = Counter()

#: (C, W, scored) variants the CUDA kernel is instantiated for
KERNEL_SHAPES = {(c, w, scored) for c in (8, 16) for w in (1, 2)
                 for scored in (True, False)}

#: operands only the scored variant takes
SCORED_OPERANDS = ("valid", "pay", "gsp", "acc", "bo2", "static", "fd",
                   "inv", "bp", "tim", "iws")

#: operands only the paired variant takes (``bo2_b`` and ``tim_b``
#: scored only)
PAIRED_OPERANDS = ("ctrl2", "fresh_b", "wa_b", "bo2_b", "grafts_b",
                   "dropped_b", "meshsel_b", "backoff_b", "tim_b")

#: operands of the delay mode (``cheat_arr`` with track_promises only), in
#: place of the sender streams and, scored, the receiver's gate words
DELAY_OPERANDS = ("arr", "graft_arr", "prune_arr", "retract", "cheat_arr")
SENDER_OPERANDS = ("ctrl", "fresh", "adv", "inj_send", "pay", "gsp", "acc")

#: ScoreSimConfig counter_dtype / bp_dtype names -> torch dtypes
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def n_gates(scored: bool, paired: bool) -> int:
    """The carried gate words: seven scored, two unscored, and slot B's
    backoff row last when paired."""
    return (N_GATES if scored else N_GATES_UNSCORED) + int(paired)


def _f32(x: float) -> float:
    """A host scalar rounded once to f32, as a weak-typed JAX scalar is
    (products of config floats fold in double first)."""
    return float(np.float32(x))


@dataclass(frozen=True)
class ScoreConsts:
    """The peer-score formula's scalars, each folded on the host (in
    double) and rounded once to f32."""

    c_tim: float           # topic_weight * time_in_mesh_weight
    tim_quantum: float
    tim_cap: float
    c_fd: float            # topic_weight * first_message_deliveries_weight
    c_inv: float           # topic_weight * invalid_message_deliveries_weight
    topic_cap: float
    bp_thr: float
    w_bp: float
    # (c_inv and w_bp are 0-d float32 tensors where knobs arm them:
    # knob_score_consts)


def knob_score_consts(s: ScoreConsts, topic_weight: float,
                      w_inv: torch.Tensor, w_bp: torch.Tensor) -> ScoreConsts:
    """``s`` with the P4 and P7 weights armed as float32 0-d tensors:
    c_inv is the float32 product of the rounded ``topic_weight`` and the
    knob (the reference's ``w * w_inv`` with a traced weight), not the
    rounding of the double product that the baked constant is."""
    return replace(s, c_inv=topic_weight * w_inv, w_bp=w_bp)


def score_consts(sc) -> ScoreConsts:
    w_t = sc.topic_weight
    return ScoreConsts(
        c_tim=_f32(w_t * sc.time_in_mesh_weight),
        tim_quantum=_f32(sc.time_in_mesh_quantum),
        tim_cap=_f32(sc.time_in_mesh_cap),
        c_fd=_f32(w_t * sc.first_message_deliveries_weight),
        c_inv=_f32(w_t * sc.invalid_message_deliveries_weight),
        topic_cap=_f32(sc.topic_score_cap),
        bp_thr=_f32(sc.behaviour_penalty_threshold),
        w_bp=_f32(sc.behaviour_penalty_weight))


@dataclass(frozen=True)
class ReceiveConsts:
    """The static scalars of one (cfg, score_cfg), folded on the host;
    the score fields are None for the unscored step."""

    offsets: tuple[int, ...]
    cinv: tuple[int, ...]
    backoff_restart: int
    d_lazy: int
    history_length: int
    gossip_factor: float
    retransmission: int = 0
    counter_dtype: torch.dtype | None = None
    bp_dtype: torch.dtype | None = None
    fd_cap: float | None = None
    fd_decay: float | None = None
    inv_decay: float | None = None
    bp_decay: float | None = None
    decay_to_zero: float | None = None
    gray_thr: float | None = None
    gossip_thr: float | None = None
    publish_thr: float | None = None
    score: ScoreConsts | None = None
    # the attack options (scored only): P7 for broken promises at the
    # receiver, the IHAVE-spam targets override, the IWANT-flood accrual
    track_promises: bool = False
    ihave_spam: bool = False
    iwant_spam: bool = False
    # the router-surface options: flood publishing and the shared-IP
    # gater (scored only), exact-k gossip targets and the PX trigger
    # word (scored or not)
    flood_publish: bool = False
    exact_k: bool = False
    with_px: bool = False
    with_same_ip: bool = False
    # paired topics: the paired variant, and its static cross-slot
    # routing (bit j: edge j's offset is an odd multiple of T/2, so the
    # sender's slot-A control is the receiver's slot B and back)
    paired: bool = False
    odd_mask: int = 0
    # fault schedules: the receiver's alive word gates what it hears and
    # the handshake it receives; under the IWANT flood, the flood_ok word
    # gates the flood's accrual
    faults: bool = False
    # the telemetry tally (one more output) and its latency-bucket rows
    telemetry: bool = False
    tel_lat_buckets: int = 0
    # the knob vector operand in place of the baked gossip_factor, d_lazy,
    # backoff restart and (scored) P4/P7 weights and thresholds; scored,
    # the rounded topic weight its P4 product takes
    knobs: bool = False
    topic_weight: float | None = None
    # the delay mode: arrivals and resolved control words from the step's
    # delay lines in place of the sender streams
    delays: bool = False

    @property
    def n_candidates(self) -> int:
        return len(self.offsets)

    @property
    def scored(self) -> bool:
        return self.score is not None

    @property
    def attacks(self) -> bool:
        """The attack variant: it takes the ``syb`` operand."""
        return self.track_promises or self.ihave_spam or self.iwant_spam

    @property
    def full(self) -> bool:
        """The full variant: some router-surface option is on."""
        return (self.flood_publish or self.exact_k or self.with_px
                or self.with_same_ip)


def odd_edge_mask(cfg) -> int:
    """Paired topics: the candidate bits of the odd edges, whose offset
    is an odd multiple of T/2, so that the partner holds the topic in
    its other slot (0 without paired topics)."""
    return sum(1 << j for j, o in enumerate(cfg.offsets)
               if cfg.paired_topics and o % cfg.n_topics)


def receive_consts(cfg, sc, *, promise_break: bool = False,
                   px: bool = False, same_ip: bool = False,
                   faults: bool = False, telemetry: bool = False,
                   tel_lat_buckets: int = 0,
                   knobs: bool = False,
                   delays: bool = False) -> ReceiveConsts:
    """Check the options (named refusals outside the slice) and fold the
    constants (``sc`` None: the unscored step's).  The receiver tracks
    broken promises when sybils spam IHAVEs or ``promise_break`` (the
    sim has promise breakers); ``px`` (the state has an active set) adds
    the ``px_rot`` output, ``same_ip`` (the params have sibling words)
    the ``same_ip`` operand, ``faults`` (the sim has a fault schedule)
    the ``alive_w`` operand and, under the IWANT flood, ``flood_ok``;
    ``telemetry`` the tally output, with ``tel_lat_buckets`` latency rows
    and their ``lat_masks`` and ``dlv_eff`` operands, ``knobs`` (the sim
    carries knobs) the ``knobs`` operand, ``delays`` (the sim carries
    delays) the delay mode's operands (``DELAY_OPERANDS``); the step
    composes faults and telemetry around a delayed launch, so no delayed
    variant takes them, and paired topics and the IWANT flood raise the
    reference's errors."""
    plan.check_kernel_config(cfg, sc)
    exact_k = not cfg.binomial_gossip_sampling
    if tel_lat_buckets and not telemetry:
        raise ValueError("latency-bucket rows need telemetry=True")
    if delays:
        if cfg.paired_topics:
            raise NotImplementedError(plan.MSG_DELAYS_PAIRED)
        if sc is not None and sc.sybil_iwant_spam:
            raise ValueError(plan.MSG_KERNEL_DELAY_IWANT_SPAM)
        if faults or telemetry:
            raise ValueError("the delay mode takes no fault or telemetry "
                             "operands: the step composes them around it")
    paired = dict(paired=cfg.paired_topics, odd_mask=odd_edge_mask(cfg),
                  faults=faults, telemetry=telemetry,
                  tel_lat_buckets=int(tel_lat_buckets), knobs=knobs,
                  delays=delays)
    if sc is None:
        if same_ip:
            raise ValueError("same-IP sibling words need a score config")
        return ReceiveConsts(
            offsets=tuple(int(o) for o in cfg.offsets),
            cinv=tuple(cfg.cinv), backoff_restart=cfg.backoff_ticks - 1,
            d_lazy=cfg.d_lazy, history_length=cfg.history_length,
            gossip_factor=_f32(cfg.gossip_factor), exact_k=exact_k,
            with_px=px, **paired)
    return ReceiveConsts(
        offsets=tuple(int(o) for o in cfg.offsets), cinv=tuple(cfg.cinv),
        flood_publish=sc.flood_publish, exact_k=exact_k, with_px=px,
        with_same_ip=same_ip, **paired,
        counter_dtype=DTYPES[sc.counter_dtype],
        bp_dtype=DTYPES[sc.bp_dtype],
        backoff_restart=cfg.backoff_ticks - 1, d_lazy=cfg.d_lazy,
        history_length=cfg.history_length,
        gossip_factor=_f32(cfg.gossip_factor),
        retransmission=cfg.gossip_retransmission,
        track_promises=sc.sybil_ihave_spam or promise_break,
        ihave_spam=sc.sybil_ihave_spam, iwant_spam=sc.sybil_iwant_spam,
        fd_cap=_f32(sc.first_message_deliveries_cap),
        fd_decay=_f32(sc.first_message_deliveries_decay),
        inv_decay=_f32(sc.invalid_message_deliveries_decay),
        bp_decay=_f32(sc.behaviour_penalty_decay),
        decay_to_zero=_f32(sc.decay_to_zero),
        gray_thr=_f32(sc.graylist_threshold),
        gossip_thr=_f32(sc.gossip_threshold),
        publish_thr=_f32(sc.publish_threshold),
        score=score_consts(sc), topic_weight=_f32(sc.topic_weight))


def score_from_counters(s: ScoreConsts, tim: torch.Tensor,
                        fd: torch.Tensor, inv: torch.Tensor,
                        bp: torch.Tensor,
                        static: torch.Tensor | None,
                        tim_b: torch.Tensor | None = None,
                        p3: tuple | None = None) -> torch.Tensor:
    """The peer-score formula on f32 counters, in the reference's op
    order (compute_scores / the kernel's stage 2); paired topics add
    slot B's P1 (``tim_b``) to the topic part before its cap, and
    ``p3``, the weighted P3 and P3b terms (the receive loops' P3/P3b
    bookkeeping), are added after it, before the cap."""
    tq = tim / torch.full_like(tim, s.tim_quantum)
    topic = (s.c_tim * tq.clamp(max=s.tim_cap) + s.c_fd * fd
             + s.c_inv * inv * inv)
    if tim_b is not None:
        tqb = tim_b / torch.full_like(tim_b, s.tim_quantum)
        topic = topic + s.c_tim * tqb.clamp(max=s.tim_cap)
    if p3 is not None:
        topic = topic + p3[0] + p3[1]
    if s.topic_cap > 0:
        topic = topic.clamp(max=s.topic_cap)
    bp_ex = (bp - s.bp_thr).clamp(min=0.0)
    if static is not None:
        topic = topic + static
    return topic + s.w_bp * bp_ex * bp_ex


def sum_rows(x: torch.Tensor) -> torch.Tensor:
    """Sum over the candidate axis in c = 0..C-1 order from 0.0 (the
    kernel's sequential sum; torch's own reduction order is not fixed)."""
    acc = torch.zeros_like(x[..., 0, :])
    for c in range(x.shape[-2]):
        acc = acc + x[..., c, :]
    return acc


def gater_row(fd: torch.Tensor, inv: torch.Tensor, seed: int,
              stride: int, same_ip: torch.Tensor | None = None
              ) -> torch.Tensor:
    """The RED gater's packed payload-acceptance draw (peer_gater.go:
    320-363) from f32 stored counters: all-ones where the peer is not
    under invalid-traffic pressure.  With ``same_ip`` (sibling words
    [C, N]) each edge's goodput uses the sums over its same-IP siblings
    (peer_gater.go:119-151), added in candidate order; the pressure
    uses the ungrouped totals."""
    C = fd.shape[-2]
    inv_tot = sum_rows(inv)
    del_tot = sum_rows(fd)
    pressure = 16.0 * inv_tot / (1.0 + del_tot + 16.0 * inv_tot)
    gater_on = pressure > _f32(0.33)
    if same_ip is not None:
        inv_g = torch.zeros_like(inv)
        fd_g = torch.zeros_like(fd)
        for cc in range(C):
            sib = graph.expand_bits(same_ip[..., cc, :], C)
            inv_g = inv_g + torch.where(sib, inv[..., cc, None, :], 0.0)
            fd_g = fd_g + torch.where(sib, fd[..., cc, None, :], 0.0)
        inv, fd = inv_g, fd_g
    goodput = (1.0 + fd) / (1.0 + fd + 16.0 * inv)
    u = graph.lane_uniform_from_seed(tuple(fd.shape[-2:]), seed, stride,
                                     fd.device)
    all_c = (1 << C) - 1
    return graph.pack_rows(u < goodput) | torch.where(
        gater_on, 0, all_c).to(torch.int32)


def targets_row(k: ReceiveConsts, elig: torch.Tensor, seed: int,
                stride: int, gossip_factor: torch.Tensor | None = None,
                d_lazy: torch.Tensor | None = None) -> torch.Tensor:
    """Lazy-gossip targets over packed ``elig``: Bernoulli(k/|elig|),
    or with ``k.exact_k`` the exact uniform k-subset
    (``ops.graph.select_k_bits`` on the same lane stream); the knobs
    ``gossip_factor`` (float32) and ``d_lazy`` (int32), 0-d tensors,
    replace ``k``'s where given."""
    C = k.n_candidates
    n_el = graph.popcount32(elig)
    gf = k.gossip_factor if gossip_factor is None else gossip_factor
    n_go = (gf * n_el.to(torch.float32)).to(torch.int32)
    n_go = (n_go.clamp(min=k.d_lazy) if d_lazy is None
            else torch.maximum(n_go, d_lazy))
    if k.exact_k:
        return graph.select_k_bits(
            elig, n_go, graph.lane_uniform_from_seed(
                (C, elig.shape[-1]), seed, stride, elig.device))
    p_g = (n_go.to(torch.float32)
           / n_el.clamp(min=1).to(torch.float32)).clamp(max=1.0)
    u = graph.lane_uniform_from_seed((C, elig.shape[-1]), seed, stride,
                                     elig.device)
    return elig & graph.pack_rows(u < p_g[..., None, :])


def _pack_ctrl(C: int, words) -> torch.Tensor:
    """uint8 [C, N]: byte c of sender p packs bit c of each (position,
    flag word) pair at its position (a replica stack's [B, C, N])."""
    out = words[0][1]
    cidx = torch.arange(C, dtype=torch.int32, device=out.device)[:, None]
    ctrl = torch.zeros((*out.shape[:-1], C, out.shape[-1]),
                       dtype=torch.uint8, device=out.device)
    for bit, word in words:
        ctrl |= (((word[..., None, :] >> cidx) & 1) << bit).to(torch.uint8)
    return ctrl


def ctrl_bytes(C: int, *, out, tgt, graft, drop, a, adv,
               flood=None) -> torch.Tensor:
    """The ctrl operand, uint8 [C, N]: byte c of sender p packs bit c of
    each per-sender flag word at its CTRL_* position (``flood``, the
    flood-publish targets, only with flood publishing)."""
    words = [(CTRL_OUT, out), (CTRL_TGT, tgt), (CTRL_GRAFT, graft),
             (CTRL_DROP, drop), (CTRL_A, a), (CTRL_ADV, adv)]
    if flood is not None:
        words.append((CTRL_FLOOD, flood))
    return _pack_ctrl(C, words)


def ctrl2_bytes(C: int, *, out_b, graft_b, drop_b, a_b) -> torch.Tensor:
    """The paired variant's second ctrl operand, uint8 [C, N]: slot B's
    flags at their CTRL2_* positions."""
    return _pack_ctrl(C, [(CTRL2_OUT_B, out_b), (CTRL2_GRAFT_B, graft_b),
                          (CTRL2_DROP_B, drop_b), (CTRL2_A_B, a_b)])


def _decay_keep(k: ReceiveConsts, x: torch.Tensor, decay: float,
                dtype: torch.dtype) -> torch.Tensor:
    x = x * decay
    return torch.where(x < k.decay_to_zero, 0.0, x).to(dtype)


def _arrivals(k: ReceiveConsts, arr, seen, valid=None, cheat_arr=None):
    """Stage 1 of the delay mode over the C receiving edges, from this
    tick's arrivals (``arr`` row j·W + w): the news heard per message word
    and, with ``valid`` (scored), the per-edge valid/invalid news counts;
    with ``k.track_promises``, the broken-promise adverts arriving at a
    receiver that lacks some id."""
    W, n = seen.shape
    z = torch.zeros((n,), dtype=torch.int32, device=seen.device)
    heard = [z] * W
    fd_cnt, iv_cnt = [], []
    for j in range(k.n_candidates):
        fd_j = iv_j = z
        for w in range(W):
            news = arr[j * W + w] & ~seen[w]
            heard[w] = heard[w] | news
            if valid is not None:
                fd_j = fd_j + graph.popcount32(news & valid[w])
                iv_j = iv_j + graph.popcount32(news & ~valid[w])
        fd_cnt.append(fd_j)
        iv_cnt.append(iv_j)
    broken = z
    if k.track_promises:
        lacked = torch.zeros((n,), dtype=torch.bool, device=seen.device)
        for w in range(W):
            lacked = lacked | (~seen[w] != 0)
        broken = torch.where(lacked, cheat_arr, 0)
    return heard, fd_cnt, iv_cnt, broken


def _exchange(k: ReceiveConsts, ctrl, fresh, adv, seen, pay=None,
              gsp=None, valid=None, inj_send=None, ctrl2=None,
              fresh_b=None, alive_w=None, tel=None):
    """Stage 1 over the C receiving edges: the senders' words heard
    (``news`` per message word), the GRAFT/PRUNE/A bits received and,
    with ``valid`` (scored), the per-edge valid/invalid news counts.
    Unscored (``pay`` None) no gate closes an edge.  With
    ``k.track_promises``, the broken-promise bits: the sender advertised
    (CTRL_ADV) without delivering (CTRL_TGT), the receiver's gossip gate
    is open and it lacks some id; with ``k.iwant_spam``, per edge the
    popcount of the sender's raw advert words (read whatever the gates
    say); with ``k.flood_publish``, the sender's injected words
    (``inj_send``) over the edges it flood-publishes on (CTRL_FLOOD),
    under the receiver's payload gate.  With ``k.paired``, the sender's
    slot-B words (``fresh_b``) over the edges in its slot-B mesh
    (CTRL2_OUT_B), under the receiver's payload gate, and the slot-B
    GRAFT/PRUNE/A bits received (the last output, else None): on an odd
    edge the two ctrl bytes' handshakes cross slots.  With ``k.faults``
    the receiver's ``alive_w`` word (all-ones or all-zeros) gates what
    it hears, the handshake bits it receives and its broken promises
    (the senders' masks ride the ctrl bytes); the advert window count
    stays raw.  With ``tel`` (a list of int64 0-d accumulators, the first
    seven ``TEL_ROWS``) the telemetry tallies of the combined path: the
    words sent counted before the receiver's alive mask, the words
    received, served and requested after it."""
    W = fresh.shape[0]
    n = seen.shape[1]
    z = torch.zeros((n,), dtype=torch.int32, device=seen.device)
    heard = [z] * W
    fd_cnt, iv_cnt, padv = [], [], []
    graft_recv = prune_recv = a_recv = broken = z
    hs_b = [z, z, z]                 # slot B: GRAFT, PRUNE, A received
    if k.track_promises:
        lacked = torch.zeros((n,), dtype=torch.bool, device=seen.device)
        for w in range(W):
            lacked = lacked | (~seen[w] != 0)
        lacked = lacked.to(torch.int32)
    for j, (o, ci) in enumerate(zip(k.offsets, k.cinv)):
        # sender q = (p + o_j) mod N: roll(x, -o)[p] = x[(p + o) mod N]
        ctl = torch.roll(ctrl[ci], -o).to(torch.int32)
        hs_a = [(ctl >> CTRL_GRAFT) & 1, (ctl >> CTRL_DROP) & 1,
                (ctl >> CTRL_A) & 1]
        if k.paired:
            ctl2 = torch.roll(ctrl2[ci], -o).to(torch.int32)
            hs2 = [(ctl2 >> CTRL2_GRAFT_B) & 1, (ctl2 >> CTRL2_DROP_B) & 1,
                   (ctl2 >> CTRL2_A_B) & 1]
            if (k.odd_mask >> j) & 1:
                hs_a, hs2 = hs2, hs_a
            hs_b = [acc | (bit << j) for acc, bit in zip(hs_b, hs2)]
        graft_recv = graft_recv | (hs_a[0] << j)
        prune_recv = prune_recv | (hs_a[1] << j)
        a_recv = a_recv | (hs_a[2] << j)
        ok_p = 1 if pay is None else (pay >> j) & 1
        ok_g = 1 if gsp is None else ok_p & ((gsp >> j) & 1)
        fwd_on = ((ctl >> CTRL_OUT) & ok_p & 1) != 0
        gsp_on = ((ctl >> CTRL_TGT) & ok_g & 1) != 0
        if k.flood_publish:
            fl_on = ((ctl >> CTRL_FLOOD) & ok_p & 1) != 0
        if k.paired:
            fb_on = ((ctl2 >> CTRL2_OUT_B) & ok_p & 1) != 0
        fd_j = iv_j = z
        if tel is not None:
            adv_on = ((ctl >> CTRL_ADV) & 1) != 0   # the sender targeted it
            req_c = z
            adv_nz = torch.zeros((n,), dtype=torch.bool, device=seen.device)
        for w in range(W):
            got = torch.where(fwd_on, torch.roll(fresh[w], -o), 0)
            if k.paired:
                got = got | torch.where(fb_on, torch.roll(fresh_b[w], -o),
                                        0)
            if k.flood_publish:
                got = got | torch.where(fl_on, torch.roll(inj_send[w], -o),
                                        0)
            fwd_q = got
            adv_q = torch.roll(adv[w], -o)
            gsp_q = torch.where(gsp_on, adv_q, 0)
            got = got | gsp_q
            if k.faults:
                got = got & alive_w            # a down peer hears nothing
            if tel is not None:
                adv_w_q = torch.where(adv_on, adv_q, 0)
                r_adv = adv_w_q if alive_w is None else adv_w_q & alive_w
                gsp_m = gsp_q if alive_w is None else gsp_q & alive_w
                for i, x in enumerate((fwd_q, adv_w_q, gsp_m & ~seen[w],
                                       got)):
                    tel[i] += graph.popcount32(x).sum(dtype=torch.int64)
                req_c = req_c + graph.popcount32(r_adv & ~seen[w])
                adv_nz = adv_nz | (adv_q != 0)
            news = got & ~seen[w]
            heard[w] = heard[w] | news
            if valid is not None:
                fd_j = fd_j + graph.popcount32(news & valid[w])
                iv_j = iv_j + graph.popcount32(news & ~valid[w])
        fd_cnt.append(fd_j)
        iv_cnt.append(iv_j)
        if tel is not None:
            # one IHAVE RPC per targeted edge with a nonempty advert, one
            # IWANT RPC per (edge, receiver) with a lacked id
            tel[TEL_IWANT_REQ] += req_c.sum(dtype=torch.int64)
            tel[TEL_IHAVE_RPCS] += (adv_on & adv_nz).sum(dtype=torch.int64)
            tel[TEL_IWANT_RPCS] += (req_c > 0).sum(dtype=torch.int64)
        if k.track_promises:
            adv_r = (ctl >> CTRL_ADV) & 1
            m_g = (ctl >> CTRL_TGT) & 1
            broken = broken | ((adv_r & (1 ^ m_g) & ok_g & lacked) << j)
        if k.iwant_spam:
            pa_j = z
            for w in range(W):
                pa_j = pa_j + graph.popcount32(torch.roll(adv[w], -o))
            padv.append(pa_j)
    if k.faults:
        # a down receiver processes no inbound control and records no
        # broken promise
        graft_recv, prune_recv, a_recv, broken = (
            x & alive_w for x in (graft_recv, prune_recv, a_recv, broken))
        hs_b = [x & alive_w for x in hs_b]
    return (heard, graft_recv, prune_recv, a_recv, fd_cnt, iv_cnt, broken,
            padv, hs_b if k.paired else None)


def _tel_start(k: ReceiveConsts, device):
    """The exchange's telemetry accumulators (None without telemetry)."""
    if not k.telemetry:
        return None
    return [torch.zeros((), dtype=torch.int64, device=device)
            for _ in TEL_ROWS]


def _tel_rows(k: ReceiveConsts, tel, heard, sub_all, acq, lat_masks,
              dlv_eff) -> tuple:
    """The tally output, ``(int32 [8 + L],)`` (empty without telemetry):
    the exchange's rows, the new acquisitions (subscribed heard words;
    injected publishes are no received copy) and the L latency-bucket
    rows of the delivered acquisitions."""
    if tel is None:
        return ()
    subbed = sub_all != 0
    for w in range(len(heard)):
        tel[TEL_NEW_IDS] += graph.popcount32(
            torch.where(subbed, heard[w], 0)).sum(dtype=torch.int64)
    rows = list(tel)
    for b in range(k.tel_lat_buckets):
        rows.append(sum(graph.popcount32(
            acq[w] & dlv_eff[w] & lat_masks[b, w]).sum(dtype=torch.int64)
            for w in range(len(heard))))
    return (torch.stack(rows).to(torch.int32),)


def _acquired(heard, sub_all, injected) -> torch.Tensor:
    subbed = sub_all != 0
    return torch.stack([torch.where(subbed, heard[w], 0) | injected[w]
                        for w in range(len(heard))])


def _backoff(k: ReceiveConsts, backoff, bo_trig, knobs=None):
    """The backoff write (trigger: restart, else count down to 0) and
    its packed > 0 gate row; with ``knobs`` the restart is
    backoff_ticks - 1 from the vector."""
    bo32 = backoff.to(torch.int32)
    restart = (k.backoff_restart if knobs is None
               else knobs[KNOB_BT].to(torch.int32) - 1)
    bo_new = torch.where(graph.expand_bits(bo_trig, k.n_candidates),
                         restart, (bo32 - 1).clamp(min=0))
    return bo_new.to(torch.int16), graph.pack_rows(bo_new > 0)


def _replica_ops(ops: dict, b: int) -> dict:
    """Replica ``b``'s operands of a stacked receive call (``gseeds`` a
    pair of [B] seed tensors; every tensor operand with its leading
    [B])."""
    out = {}
    for name, v in ops.items():
        if name == "gseeds":
            out[name] = tuple(int(g[b]) & graph.MASK32 for g in v)
        elif isinstance(v, torch.Tensor):
            out[name] = v[b]
        else:
            out[name] = v
    return out


def receive_update_plain(k: ReceiveConsts, **ops):
    """Plain PyTorch version of the receive kernel (same operands, same
    outputs, bit-identical).  A replica stack's operands (every one with
    a leading [B], ``gseeds`` two [B] seed tensors) give every output
    stacked [B, ...]: each replica's outputs are its own call's."""
    if ops["sub_all"].dim() == 2:
        outs = [receive_update_plain(k, **_replica_ops(ops, b))
                for b in range(ops["sub_all"].shape[0])]
        return tuple(torch.stack(x) for x in zip(*outs))
    if k.scored:
        return _receive_plain_scored(k, **ops)
    return _receive_plain_unscored(k, **ops)


def _handshake(meshsel, wa, grafts, graft_recv, prune_recv, a_recv,
               retract=None):
    """A slot's handshake resolution: (mesh, retract); the GRAFTs sent
    that no A bit confirms are retracted, or in delay mode ``retract`` is
    given."""
    accept = graft_recv & wa
    if retract is None:
        retract = grafts & ~a_recv
    return ((meshsel | accept) & ~prune_recv) & ~retract, retract


def _targets_knobs(knobs) -> dict:
    """targets_row's knob arguments from the vector (none without)."""
    if knobs is None:
        return {}
    return dict(gossip_factor=knobs[KNOB_GF],
                d_lazy=knobs[KNOB_DLAZY].to(torch.int32))


def _slot_b(k: ReceiveConsts, hs_b, *, wa_b, grafts_b, dropped_b,
            meshsel_b, backoff_b, acc=None, knobs=None):
    """Slot B's handshake and backoff (paired): (mesh_b, backoff_b,
    backoff gate row, viol_b, px trigger bits); scored, the GRAFTs and
    PRUNEs received pass the accept gate first."""
    graft_b, prune_b, a_b = hs_b
    if acc is not None:
        graft_b, prune_b = graft_b & acc, prune_b & acc
    mesh_b, retract_b = _handshake(meshsel_b, wa_b, grafts_b, graft_b,
                                   prune_b, a_b)
    bo_b, bo_gate_b = _backoff(k, backoff_b, dropped_b | prune_b | retract_b,
                               knobs)
    return mesh_b, bo_b, bo_gate_b, graft_b, prune_b | retract_b


def _receive_plain_unscored(k: ReceiveConsts, *, gseeds, sub_all, cand_sub,
                            fanout, wa, grafts, dropped, meshsel, seen,
                            injected, backoff, ctrl=None, fresh=None,
                            adv=None, ctrl2=None, fresh_b=None,
                            alive_w=None, lat_masks=None, dlv_eff=None,
                            knobs=None, arr=None, graft_arr=None,
                            prune_arr=None, retract=None, **paired_ops):
    tel = _tel_start(k, seen.device)
    if k.delays:
        heard = _arrivals(k, arr, seen)[0]
        graft_recv, prune_recv, a_recv = graft_arr, prune_arr, None
        ex = None
    else:
        ex = _exchange(k, ctrl, fresh, adv, seen, ctrl2=ctrl2,
                       fresh_b=fresh_b, alive_w=alive_w, tel=tel)
        heard, graft_recv, prune_recv, a_recv = ex[:4]
    mesh, retract = _handshake(meshsel, wa, grafts, graft_recv, prune_recv,
                               a_recv, retract)
    bo_new, bo_gate = _backoff(k, backoff, dropped | prune_recv | retract,
                               knobs)
    elig = cand_sub & ~mesh & ~fanout & sub_all
    px_val = prune_recv | retract
    mesh_b = bo_b = ()
    gate_b = ()
    if k.paired:
        mb, bb, gb, _, px_b = _slot_b(k, ex[-1], knobs=knobs, **paired_ops)
        elig = elig & ~mb
        px_val = px_val | px_b
        mesh_b, bo_b, gate_b = (mb,), (bb,), (gb,)
    tgt = targets_row(k, elig, gseeds[1], mesh.shape[0],
                      **_targets_knobs(knobs))
    px = (px_val,) if k.with_px else ()
    acq = _acquired(heard, sub_all, injected)
    return (acq, mesh, *mesh_b, bo_new, *bo_b, tgt, bo_gate, *gate_b, *px,
            *_tel_rows(k, tel, heard, sub_all, acq, lat_masks, dlv_eff))


def _receive_plain_scored(k: ReceiveConsts, *, valid, gseeds, sub_all,
                          cand_sub, fanout, wa, bo2, grafts, dropped,
                          meshsel, seen, injected, backoff, static, fd, inv,
                          bp, tim, iws, ctrl=None, fresh=None, adv=None,
                          pay=None, gsp=None, acc=None, syb=None,
                          inj_send=None, same_ip=None, ctrl2=None,
                          fresh_b=None, bo2_b=None, tim_b=None,
                          alive_w=None, flood_ok=None, lat_masks=None,
                          dlv_eff=None, knobs=None, arr=None,
                          graft_arr=None, prune_arr=None, retract=None,
                          cheat_arr=None, **paired_ops):
    C = k.n_candidates
    n = sub_all.shape[0]
    tel = _tel_start(k, seen.device)
    if k.delays:
        # the step gated and masked the control words at arrival
        heard, fd_cnt, iv_cnt, broken = _arrivals(k, arr, seen, valid,
                                                  cheat_arr)
        graft_recv, prune_recv, a_recv = graft_arr, prune_arr, None
        padv = hs_b = None
    else:
        (heard, graft_recv, prune_recv, a_recv, fd_cnt, iv_cnt, broken,
         padv, hs_b) = _exchange(k, ctrl, fresh, adv, seen, pay, gsp, valid,
                                 inj_send, ctrl2, fresh_b, alive_w, tel)
        graft_recv = graft_recv & acc
        prune_recv = prune_recv & acc
    viol = graft_recv & bo2
    mesh, retract = _handshake(meshsel, wa, grafts, graft_recv, prune_recv,
                               a_recv, retract)
    px_val = prune_recv | retract
    acq = _acquired(heard, sub_all, injected)
    bo_new, bo_gate = _backoff(k, backoff, dropped | prune_recv | retract,
                               knobs)
    if k.paired:
        mesh_b, bo_b, bo_gate_b, graft_b, px_b = _slot_b(
            k, hs_b, acc=acc, knobs=knobs, **paired_ops)
        viol_b = graft_b & bo2_b
        px_val = px_val | px_b

    in_mesh = graph.expand_bits(mesh, C)
    tim_new = torch.where(in_mesh, (tim.to(torch.int32) + 1).clamp(
        max=32766), 0).to(torch.int16)
    tim_b_new = None
    if k.paired:
        tim_b_new = torch.where(
            graph.expand_bits(mesh_b, C),
            (tim_b.to(torch.int32) + 1).clamp(max=32766), 0).to(torch.int16)
    fd_stack = torch.stack(fd_cnt)
    iv_stack = torch.stack(iv_cnt)
    fd_f = (fd.to(torch.float32) + fd_stack.to(torch.float32)).clamp(
        max=k.fd_cap)
    fd_new = _decay_keep(k, fd_f, k.fd_decay, k.counter_dtype)
    inv_new = _decay_keep(
        k, inv.to(torch.float32) + iv_stack.to(torch.float32),
        k.inv_decay, k.counter_dtype)
    bp_f = bp.to(torch.float32) + graph.expand_bits(viol, C).to(
        torch.float32)
    if k.paired:
        # each slot's backoff violations count (gossipsub.go:747-765)
        bp_f = bp_f + graph.expand_bits(viol_b, C).to(torch.float32)
    if k.track_promises:
        bp_f = bp_f + graph.expand_bits(broken, C).to(torch.float32)
    bp_new = _decay_keep(k, bp_f, k.bp_decay, k.bp_dtype)
    s32 = iws.to(torch.int32)
    pull = fd_stack + iv_stack
    if k.iwant_spam:
        # sybil receivers re-request the partner's whole advertised
        # window until the edge's retransmission budget (taken on the
        # ledger before its decay) is spent
        pa = torch.stack(padv)
        flood = torch.where((s32 < k.retransmission * pa) & (pa > 0), pa, 0)
        if k.faults:
            # no flood over a faulted edge: a dead sybil requests
            # nothing, a dead or cut-off partner serves nothing
            flood = torch.where(graph.expand_bits(flood_ok, C), flood, 0)
        pull = torch.where((syb != 0)[None, :], flood, pull)
    H = k.history_length
    dec = s32 - torch.div(s32 + (H - 1), H, rounding_mode="floor")
    iws_new = (dec + pull).clamp(0, 30000).to(torch.int16)

    # stage 2: next tick's gates from the stored (rounded) counters; with
    # knobs the P4 and P7 weights and the two thresholds from the vector
    s_c, gray_thr, gossip_thr = k.score, k.gray_thr, k.gossip_thr
    if knobs is not None:
        s_c = knob_score_consts(s_c, k.topic_weight, knobs[KNOB_INVW],
                                knobs[KNOB_BPW])
        gray_thr, gossip_thr = knobs[KNOB_GRAY], knobs[KNOB_GSP]
    fd_n = fd_new.to(torch.float32)
    inv_n = inv_new.to(torch.float32)
    score = score_from_counters(
        s_c, tim_new.to(torch.float32), fd_n, inv_n,
        bp_new.to(torch.float32), static,
        tim_b=None if tim_b_new is None else tim_b_new.to(torch.float32))
    accept_g = graph.pack_rows(score >= gray_thr)
    gossip_g = graph.pack_rows(score >= gossip_thr)
    pub_g = graph.pack_rows(score >= k.publish_thr)
    nonneg_g = graph.pack_rows(score >= 0)
    gater = gater_row(fd_n, inv_n, gseeds[0], n, same_ip)
    elig = cand_sub & ~mesh & ~fanout & sub_all & gossip_g
    if k.paired:
        # one gossip selection for both topic slots, outside either mesh
        elig = elig & ~mesh_b
    tgt = targets_row(k, elig, gseeds[1], n, **_targets_knobs(knobs))
    if k.ihave_spam:
        # IHAVE-spamming sybils target every subscribed candidate
        tgt = (tgt & ~syb) | (cand_sub & syb)
    gates = (accept_g, gossip_g, pub_g, nonneg_g, accept_g & gater, tgt,
             bo_gate)
    px = (px_val,) if k.with_px else ()
    px += _tel_rows(k, tel, heard, sub_all, acq, lat_masks, dlv_eff)
    if not k.paired:
        return (acq, mesh, bo_new, *gates, fd_new, inv_new, bp_new,
                tim_new, iws_new, *px)
    return (acq, mesh, mesh_b, bo_new, bo_b, *gates, bo_gate_b, fd_new,
            inv_new, bp_new, tim_new, tim_b_new, iws_new, *px)


class _Args(ctypes.Structure):
    """Mirror of ``struct ReceiveArgs`` in csrc/receive.cu."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "ctrl", "fresh", "adv", "pay", "gsp", "acc", "sub_all",
            "cand_sub", "fanout", "wa", "bo2", "grafts", "dropped",
            "meshsel", "seen", "inj", "valid", "backoff", "stat", "fd",
            "inv", "bp", "tim", "iws", "syb", "acq", "mesh", "backoff_out",
            "gates", "fd_out", "inv_out", "bp_out", "tim_out", "iws_out")]
        + [("n", ctypes.c_longlong),
           ("offsets", ctypes.c_int * 16), ("cinv", ctypes.c_int * 16),
           ("seed_gater", ctypes.c_uint), ("seed_targets", ctypes.c_uint),
           ("stride", ctypes.c_uint),
           ("backoff_restart", ctypes.c_int), ("d_lazy", ctypes.c_int),
           ("history_length", ctypes.c_int),
           ("has_topic_cap", ctypes.c_int),
           ("track_promises", ctypes.c_int), ("ihave_spam", ctypes.c_int),
           ("iwant_spam", ctypes.c_int), ("retransmission", ctypes.c_int)]
        + [(name, ctypes.c_float) for name in (
            "gossip_factor", "fd_cap", "fd_decay", "inv_decay",
            "bp_decay", "decay_to_zero", "c_tim", "tim_quantum",
            "tim_cap", "c_fd", "c_inv", "topic_cap", "bp_thr", "w_bp",
            "gray_thr", "gossip_thr", "publish_thr")]
        # the full variant's fields, last: a source without them reads
        # the struct's head unchanged (kernel_ab.py)
        + [(name, ctypes.c_void_p) for name in (
            "inj_send", "same_ip", "px_rot")]
        + [("full", ctypes.c_int), ("flood_publish", ctypes.c_int),
           ("exact_k", ctypes.c_int)]
        # the paired variant's fields, after those
        + [(name, ctypes.c_void_p) for name in (
            "ctrl2", "fresh_b", "wa_b", "bo2_b", "grafts_b", "dropped_b",
            "meshsel_b", "backoff_b", "tim_b", "mesh_b_out",
            "backoff_b_out", "tim_b_out")]
        + [("odd_mask", ctypes.c_uint), ("paired", ctypes.c_int)]
        # the fault options' fields, after those
        + [(name, ctypes.c_void_p) for name in ("alive_w", "flood_ok")]
        + [("faults", ctypes.c_int)]
        # the telemetry fields, after those
        + [(name, ctypes.c_void_p) for name in ("lat_masks", "dlv_eff",
                                                 "tel")]
        + [("tel_lat_buckets", ctypes.c_int)]
        # the knob fields, after those
        + [("knobs", ctypes.c_void_p), ("topic_weight", ctypes.c_float)]
        # the delay mode's fields, after those
        + [(name, ctypes.c_void_p) for name in (
            "arr", "graft_arr", "prune_arr", "retract_in", "cheat_arr")]
        # the replica axis, last
        + [("reps", ctypes.c_int), ("seeds", ctypes.c_void_p),
           ("knob_stride", ctypes.c_int)])


_WORDS_N = ("sub_all", "cand_sub", "fanout", "wa", "grafts", "dropped",
            "meshsel")
_WORDS_N_SCORED = ("pay", "gsp", "acc", "bo2")


def _check_operands(k: ReceiveConsts, ops: dict) -> int | None:
    """Check the operands' names, shapes, dtypes and layout; returns B
    for a replica stack (every operand with a leading [B]), else None."""
    C = k.n_candidates
    *lead, W, n = ops["seen"].shape
    if (C, W, k.scored) not in KERNEL_SHAPES:
        plan.refuse("kernel_shape")
    B = lead[0] if lead else None
    if B is not None:
        if k.paired:
            plan.refuse("batched_paired")
        if k.full:
            plan.refuse("batched_surface")
        for g in ops["gseeds"]:
            if not isinstance(g, torch.Tensor) or tuple(g.shape) != (B,):
                raise ValueError("a replica stack's gseeds are two [B] "
                                 "seed tensors")
    names = set(ops) - {"gseeds"}
    want_names = {"ctrl", "fresh", "adv", "seen", "injected", "backoff",
                  *_WORDS_N}
    if k.scored:
        want_names |= set(SCORED_OPERANDS)
    if k.attacks:
        want_names.add("syb")
    if k.flood_publish:
        want_names.add("inj_send")
    if k.with_same_ip:
        want_names.add("same_ip")
    if k.paired:
        want_names |= set(PAIRED_OPERANDS)
        if not k.scored:
            want_names -= {"bo2_b", "tim_b"}
    if k.faults:
        want_names.add("alive_w")
        if k.iwant_spam:
            want_names.add("flood_ok")
    if k.tel_lat_buckets:
        want_names |= {"lat_masks", "dlv_eff"}
    if k.knobs:
        want_names.add("knobs")
    if k.delays:
        want_names = (want_names - set(SENDER_OPERANDS)) | set(
            DELAY_OPERANDS[:4 + k.track_promises])
    if names != want_names:
        variant = ("paired" if k.paired else "full" if k.full else
                   "attack" if k.attacks else
                   "scored" if k.scored else "unscored")
        if k.faults:
            variant += " faulted"
        if k.telemetry:
            variant += " telemetry"
        if k.delays:
            variant += " delayed"
        if k.knobs:
            variant += " knobbed"
        raise ValueError(
            f"{variant} receive operands: "
            f"missing {sorted(want_names - names)}, unexpected "
            f"{sorted(names - want_names)}")
    want = {"ctrl": ((C, n), torch.uint8),
            "fresh": ((W, n), torch.int32), "adv": ((W, n), torch.int32),
            "arr": ((C * W, n), torch.int32),
            "seen": ((W, n), torch.int32),
            "injected": ((W, n), torch.int32),
            "backoff": ((C, n), torch.int16)}
    want.update({name: ((n,), torch.int32) for name in
                 (*_WORDS_N, *DELAY_OPERANDS[1:])})
    if k.attacks:
        want["syb"] = ((n,), torch.int32)
    if k.flood_publish:
        want["inj_send"] = ((W, n), torch.int32)
    if k.with_same_ip:
        want["same_ip"] = ((C, n), torch.int32)
    for name in ("alive_w", "flood_ok"):
        if name in want_names:
            want[name] = ((n,), torch.int32)
    if k.tel_lat_buckets:
        want["lat_masks"] = ((k.tel_lat_buckets, W), torch.int32)
        want["dlv_eff"] = ((W, n), torch.int32)
    if k.knobs:
        want["knobs"] = ((KNOB_GSP + 1 if k.scored else KNOB_BT + 1,),
                         torch.float32)
    if k.paired:
        want.update({"ctrl2": ((C, n), torch.uint8),
                     "fresh_b": ((W, n), torch.int32),
                     "backoff_b": ((C, n), torch.int16)})
        want.update({name: ((n,), torch.int32) for name in (
            "wa_b", "grafts_b", "dropped_b", "meshsel_b")})
        if k.scored:
            want.update({"bo2_b": ((n,), torch.int32),
                         "tim_b": ((C, n), torch.int16)})
    if k.scored:
        want.update({"valid": ((W,), torch.int32),
                     "fd": ((C, n), k.counter_dtype),
                     "inv": ((C, n), k.counter_dtype),
                     "bp": ((C, n), k.bp_dtype),
                     "tim": ((C, n), torch.int16),
                     "iws": ((C, n), torch.int16)})
        want.update({name: ((n,), torch.int32)
                     for name in _WORDS_N_SCORED})
        if ops["static"] is not None:
            want["static"] = ((C, n), torch.float32)
    device = ops["sub_all"].device
    for name, (shape, dtype) in want.items():
        if name not in want_names:
            continue
        t = ops[name]
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, sub_all on {device}")
        if B is not None:
            shape = (B, *shape)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B


def receive_update(k: ReceiveConsts, **ops):
    """One tick's receive half (operands and outputs: module docstring).

    CUDA tensors launch the kernel (a failed build or launch raises);
    CPU tensors run ``receive_update_plain``.  A replica stack (every
    operand with a leading [B], ``gseeds`` two [B] seed tensors) is ONE
    launch over the B replicas' tiles, each output stacked [B, ...]."""
    B = _check_operands(k, ops)
    if ops["sub_all"].device.type == "cpu":
        return receive_update_plain(k, **ops)
    # the kernel stages these by bulk copies, which need 16-byte aligned
    # operands: a view that starts off one is copied
    ops = {name: (v.clone() if name in STAGED_OPERANDS and v is not None
                  and v.data_ptr() % 16 else v)
           for name, v in ops.items()}
    C = k.n_candidates
    *lead, W, n = ops["seen"].shape
    dev = ops["sub_all"].device
    acq = torch.empty((*lead, W, n), dtype=torch.int32, device=dev)
    mesh = torch.empty((*lead, n), dtype=torch.int32, device=dev)
    bo_out = torch.empty((*lead, C, n), dtype=torch.int16, device=dev)
    # gate g of every replica in one contiguous [B, N] block
    gates = torch.empty((n_gates(k.scored, k.paired), *lead, n),
                        dtype=torch.int32, device=dev)
    outs = [("acq", acq), ("mesh", mesh), ("backoff_out", bo_out),
            ("gates", gates)]
    a = _Args()
    streams = DELAY_OPERANDS[:3] if k.delays else ("ctrl", "fresh", "adv")
    for name in (*streams, *_WORDS_N, "seen", "backoff"):
        setattr(a, name, ops[name].data_ptr())
    if k.delays:
        a.retract_in = ops["retract"].data_ptr()
        if k.track_promises:
            a.cheat_arr = ops["cheat_arr"].data_ptr()
    a.inj = ops["injected"].data_ptr()
    a.n = n
    for j in range(C):
        a.offsets[j] = k.offsets[j] % n
        a.cinv[j] = k.cinv[j]
    seeds = None
    if B is None:
        a.seed_gater, a.seed_targets = (int(g) & graph.MASK32
                                        for g in ops["gseeds"])
    else:
        # each replica's (gater, targets) lane seeds, [B, 2]
        seeds = torch.stack([g.to(torch.int32) for g in ops["gseeds"]],
                            -1).contiguous()
        a.reps = B
        a.seeds = seeds.data_ptr()
    a.stride = n & graph.MASK32
    a.backoff_restart = k.backoff_restart
    a.d_lazy = k.d_lazy
    a.history_length = k.history_length
    a.gossip_factor = k.gossip_factor
    if k.scored:
        counters = [(name, torch.empty_like(ops[name]))
                    for name in ("fd", "inv", "bp", "tim", "iws")]
        outs += [(f"{name}_out", t) for name, t in counters]
        for name in (*_WORDS_N_SCORED, "valid", "fd", "inv", "bp", "tim",
                     "iws"):
            if name in ops:         # (delay mode: no pay, gsp, acc)
                setattr(a, name, ops[name].data_ptr())
        a.stat = (None if ops["static"] is None
                  else ops["static"].data_ptr())
        a.has_topic_cap = int(k.score.topic_cap > 0)
        for name in ("fd_cap", "fd_decay", "inv_decay", "bp_decay",
                     "decay_to_zero", "gray_thr", "gossip_thr",
                     "publish_thr"):
            setattr(a, name, getattr(k, name))
        for name in ("c_tim", "tim_quantum", "tim_cap", "c_fd", "c_inv",
                     "topic_cap", "bp_thr", "w_bp"):
            setattr(a, name, getattr(k.score, name))
    if k.attacks:
        a.syb = ops["syb"].data_ptr()
        for name in ("track_promises", "ihave_spam", "iwant_spam",
                     "retransmission"):
            setattr(a, name, int(getattr(k, name)))
    a.full = int(k.full)
    a.flood_publish = int(k.flood_publish)
    a.exact_k = int(k.exact_k)
    if k.flood_publish and not k.delays:
        a.inj_send = ops["inj_send"].data_ptr()
    if k.with_same_ip:
        a.same_ip = ops["same_ip"].data_ptr()
    paired_outs = []
    if k.paired:
        a.paired = 1
        a.odd_mask = k.odd_mask
        for name in PAIRED_OPERANDS:
            if name in ops:
                setattr(a, name, ops[name].data_ptr())
        paired_outs = [("mesh_b_out", torch.empty_like(mesh)),
                       ("backoff_b_out", torch.empty_like(bo_out))]
        if k.scored:
            paired_outs.append(("tim_b_out", torch.empty_like(ops["tim"])))
    if k.with_px:
        outs.append(("px_rot", torch.empty((*lead, n), dtype=torch.int32,
                                           device=dev)))
    if k.faults:
        a.faults = 1
        a.alive_w = ops["alive_w"].data_ptr()
        if "flood_ok" in ops:
            a.flood_ok = ops["flood_ok"].data_ptr()
    tel = ()
    if k.telemetry:
        # the tally is summed by atomics: zeroed here, on the stream (a
        # stack's: a row block a replica)
        tel = (torch.zeros((*lead, len(TEL_ROWS) + k.tel_lat_buckets),
                           dtype=torch.int32, device=dev),)
        a.tel = tel[0].data_ptr()
        a.tel_lat_buckets = k.tel_lat_buckets
        if k.tel_lat_buckets:
            a.lat_masks = ops["lat_masks"].data_ptr()
            a.dlv_eff = ops["dlv_eff"].data_ptr()
    if k.knobs:
        # null keeps the baked launch arguments
        a.knobs = ops["knobs"].data_ptr()
        a.knob_stride = ops["knobs"].shape[-1]
        if k.scored:
            a.topic_weight = k.topic_weight
    for name, t in outs + paired_outs:
        setattr(a, name, t.data_ptr())
    name = library(k, stacked=B is not None)
    lib = _build.load(name)
    fn = getattr(lib, "gossip_" + name.replace("receive", "receive_update"))
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ctypes.byref(a), C, W, int(k.scored), int(k.attacks),
                 int(k.counter_dtype == torch.bfloat16),
                 int(k.bp_dtype == torch.bfloat16), stream)
    _build.check(err, "receive_update")
    launches[variant(k)] += 1
    rest = [t for _, t in outs[4:]] + list(tel)
    if not k.paired:
        return (acq, mesh, bo_out, *gates.unbind(0), *rest)
    # the reference's order: each slot-B output after its slot-A twin
    mesh_b, bo_b, *tim_b = (t for _, t in paired_outs)
    if k.scored:
        fd_o, inv_o, bp_o, tim_o, iws_o, *px = rest
        rest = [fd_o, inv_o, bp_o, tim_o, *tim_b, iws_o, *px]
    return (acq, mesh, mesh_b, bo_out, bo_b, *gates.unbind(0), *rest)


#: peers a tile of the receive kernels' persistent grid
#: (``csrc/receive_body.cuh`` RECEIVE_TILE; a block has 128 threads)
RECEIVE_TILE = 112
#: the operands the receive kernels stage in shared memory by bulk copies
#: (each must start on a 16-byte boundary)
STAGED_OPERANDS = ("backoff", "tim", "fd", "inv", "bp", "iws", "backoff_b",
                   "tim_b", "same_ip", "arr", "ctrl", "ctrl2", "static")

#: the receive kernels' sources (``csrc/<name>.cu``), one library each:
#: without and with the telemetry tally, each without and with knobs; the
#: delay mode, without and with knobs; a replica stack's delay mode and
#: telemetry tally (the stacks of the others are in ``receive.cu`` and
#: ``receive_knobs.cu``)
SOURCES = ("receive", "receive_tel", "receive_knobs", "receive_tel_knobs",
           "receive_delays", "receive_delays_reps", "receive_tel_reps",
           "receive_tel_knobs_reps")


def library(k: ReceiveConsts, stacked: bool = False) -> str:
    """The source whose library holds ``k``'s kernel (``stacked``: for a
    replica stack)."""
    if k.delays:
        name = "receive_delays"
    else:
        name = SOURCES[int(k.telemetry) + 2 * int(k.knobs)]
    if stacked and (k.delays or k.telemetry):
        name += "_reps"
    return name


def launch_config(k: ReceiveConsts, stacked: bool = False) -> dict:
    """The last launch of ``k``'s library: its tile (peers), blocks a
    multiprocessor, dynamic shared memory (bytes) and grid."""
    out = (ctypes.c_int * 4)()
    fn = _build.load(library(k, stacked)).gossip_receive_launch_config
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn(out)
    return dict(zip(("tile", "blocks_per_sm", "smem_bytes", "grid"), out))


def variant(k: ReceiveConsts) -> str:
    """The name of ``k``'s kernel variant, the key of its launch count."""
    if k.paired:
        name = "paired" if k.scored else "paired_unscored"
    elif k.full:
        name = "full"
    elif k.attacks:
        name = "attacks"
    else:
        name = "scored" if k.scored else "unscored"
    if k.faults:
        name += "_faults"
    if k.telemetry:
        name += "+tel"
    if k.delays:
        name += "+delays"
    return name + "+knobs" if k.knobs else name


def operand_bytes(ops: dict, outs) -> int:
    """Bytes the receive half must move: each operand read once, each
    output written once."""
    total = sum(t.numel() * t.element_size() for name, t in ops.items()
                if isinstance(t, torch.Tensor))
    return total + sum(t.numel() * t.element_size() for t in outs)
