"""The heartbeat's receive half: the CUDA kernel ``csrc/receive.cu`` and
its plain PyTorch version.

Counterpart of ``go_libp2p_pubsub_tpu/ops/pallas/receive.py``
(``make_receive_update`` / ``_receive_kernel``) for the unpaired options
the port runs, scored (v1.1) and unscored (v1.0, ``score_cfg=None``);
scored, with or without the attack options (``track_promises``, the
IHAVE-spam targets override and the IWANT-flood serve accrual).
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

Attack variant only (``ReceiveConsts.attacks``): ``syb`` int32 [N], the
sybil word (all C bits for an IHAVE- or IWANT-spamming sybil, else 0).

Returns make_receive_update's output order: scored ``(acq [W, N], mesh
[N], backoff [C, N], *gates (7 x [N]), fd, inv, bp, tim, iws)``,
unscored ``(acq, mesh, backoff, targets, backoff gate)``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

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
N_GATES = 7        # accept, gossip, publish, nonneg, payload, targets, backoff
N_GATES_UNSCORED = 2   # targets, backoff

#: launches of the CUDA kernel: the scored, unscored and scored attack
#: variants (plain integers; chip_smoke.py resets them before a main path
#: and reads them after)
launches = 0
launches_unscored = 0
launches_attacks = 0

#: (C, W, scored) variants the CUDA kernel is instantiated for
KERNEL_SHAPES = {(c, w, scored) for c in (8, 16) for w in (1, 2)
                 for scored in (True, False)}

#: operands only the scored variant takes
SCORED_OPERANDS = ("valid", "pay", "gsp", "acc", "bo2", "static", "fd",
                   "inv", "bp", "tim", "iws")

#: ScoreSimConfig counter_dtype / bp_dtype names -> torch dtypes
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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


def receive_consts(cfg, sc, *, promise_break: bool = False
                   ) -> ReceiveConsts:
    """Check the options (named refusals outside the slice) and fold the
    constants (``sc`` None: the unscored step's).  The receiver tracks
    broken promises when sybils spam IHAVEs or ``promise_break`` (the
    sim has promise breakers)."""
    plan.check_kernel_config(cfg, sc)
    if sc is None:
        return ReceiveConsts(
            offsets=tuple(int(o) for o in cfg.offsets),
            cinv=tuple(cfg.cinv), backoff_restart=cfg.backoff_ticks - 1,
            d_lazy=cfg.d_lazy, history_length=cfg.history_length,
            gossip_factor=_f32(cfg.gossip_factor))
    return ReceiveConsts(
        offsets=tuple(int(o) for o in cfg.offsets), cinv=tuple(cfg.cinv),
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
        score=score_consts(sc))


def score_from_counters(s: ScoreConsts, tim: torch.Tensor,
                        fd: torch.Tensor, inv: torch.Tensor,
                        bp: torch.Tensor,
                        static: torch.Tensor | None) -> torch.Tensor:
    """The peer-score formula on f32 counters, in the reference's op
    order (compute_scores / the kernel's stage 2)."""
    tq = tim / torch.full_like(tim, s.tim_quantum)
    topic = (s.c_tim * tq.clamp(max=s.tim_cap) + s.c_fd * fd
             + s.c_inv * inv * inv)
    if s.topic_cap > 0:
        topic = topic.clamp(max=s.topic_cap)
    bp_ex = (bp - s.bp_thr).clamp(min=0.0)
    if static is not None:
        topic = topic + static
    return topic + s.w_bp * bp_ex * bp_ex


def sum_rows(x: torch.Tensor) -> torch.Tensor:
    """Sum over the candidate axis in c = 0..C-1 order from 0.0 (the
    kernel's sequential sum; torch's own reduction order is not fixed)."""
    acc = torch.zeros_like(x[0])
    for c in range(x.shape[0]):
        acc = acc + x[c]
    return acc


def gater_row(fd: torch.Tensor, inv: torch.Tensor, seed: int,
              stride: int) -> torch.Tensor:
    """The RED gater's packed payload-acceptance draw (peer_gater.go:
    320-363) from f32 stored counters: all-ones where the peer is not
    under invalid-traffic pressure."""
    C = fd.shape[0]
    inv_tot = sum_rows(inv)
    del_tot = sum_rows(fd)
    pressure = 16.0 * inv_tot / (1.0 + del_tot + 16.0 * inv_tot)
    gater_on = pressure > _f32(0.33)
    goodput = (1.0 + fd) / (1.0 + fd + 16.0 * inv)
    u = graph.lane_uniform_from_seed(fd.shape, seed, stride, fd.device)
    all_c = (1 << C) - 1
    return graph.pack_rows(u < goodput) | torch.where(
        gater_on, 0, all_c).to(torch.int32)


def targets_row(k: ReceiveConsts, elig: torch.Tensor, seed: int,
                stride: int) -> torch.Tensor:
    """Bernoulli(k/|elig|) lazy-gossip targets over packed ``elig``."""
    C = k.n_candidates
    n_el = graph.popcount32(elig)
    n_go = torch.clamp((k.gossip_factor * n_el.to(torch.float32)).to(
        torch.int32), min=k.d_lazy)
    p_g = (n_go.to(torch.float32)
           / n_el.clamp(min=1).to(torch.float32)).clamp(max=1.0)
    u = graph.lane_uniform_from_seed((C, elig.shape[0]), seed, stride,
                                     elig.device)
    return elig & graph.pack_rows(u < p_g[None, :])


def ctrl_bytes(C: int, *, out, tgt, graft, drop, a, adv) -> torch.Tensor:
    """The ctrl operand, uint8 [C, N]: byte c of sender p packs bit c of
    each per-sender flag word at its CTRL_* position."""
    cidx = torch.arange(C, dtype=torch.int32, device=out.device)[:, None]
    ctrl = torch.zeros((C, out.shape[0]), dtype=torch.uint8,
                       device=out.device)
    for bit, word in ((CTRL_OUT, out), (CTRL_TGT, tgt), (CTRL_GRAFT, graft),
                      (CTRL_DROP, drop), (CTRL_A, a), (CTRL_ADV, adv)):
        ctrl |= (((word[None, :] >> cidx) & 1) << bit).to(torch.uint8)
    return ctrl


def _decay_keep(k: ReceiveConsts, x: torch.Tensor, decay: float,
                dtype: torch.dtype) -> torch.Tensor:
    x = x * decay
    return torch.where(x < k.decay_to_zero, 0.0, x).to(dtype)


def _exchange(k: ReceiveConsts, ctrl, fresh, adv, seen, pay=None,
              gsp=None, valid=None):
    """Stage 1 over the C receiving edges: the senders' words heard
    (``news`` per message word), the GRAFT/PRUNE/A bits received and,
    with ``valid`` (scored), the per-edge valid/invalid news counts.
    Unscored (``pay`` None) no gate closes an edge.  With
    ``k.track_promises``, the broken-promise bits: the sender advertised
    (CTRL_ADV) without delivering (CTRL_TGT), the receiver's gossip gate
    is open and it lacks some id; with ``k.iwant_spam``, per edge the
    popcount of the sender's raw advert words (read whatever the gates
    say)."""
    W = fresh.shape[0]
    n = seen.shape[1]
    z = torch.zeros((n,), dtype=torch.int32, device=seen.device)
    heard = [z] * W
    fd_cnt, iv_cnt, padv = [], [], []
    graft_recv = prune_recv = a_recv = broken = z
    if k.track_promises:
        lacked = torch.zeros((n,), dtype=torch.bool, device=seen.device)
        for w in range(W):
            lacked = lacked | (~seen[w] != 0)
        lacked = lacked.to(torch.int32)
    for j, (o, ci) in enumerate(zip(k.offsets, k.cinv)):
        # sender q = (p + o_j) mod N: roll(x, -o)[p] = x[(p + o) mod N]
        ctl = torch.roll(ctrl[ci], -o).to(torch.int32)
        graft_recv = graft_recv | (((ctl >> CTRL_GRAFT) & 1) << j)
        prune_recv = prune_recv | (((ctl >> CTRL_DROP) & 1) << j)
        a_recv = a_recv | (((ctl >> CTRL_A) & 1) << j)
        ok_p = 1 if pay is None else (pay >> j) & 1
        ok_g = 1 if gsp is None else ok_p & ((gsp >> j) & 1)
        fwd_on = ((ctl >> CTRL_OUT) & ok_p & 1) != 0
        gsp_on = ((ctl >> CTRL_TGT) & ok_g & 1) != 0
        fd_j = iv_j = z
        for w in range(W):
            got = (torch.where(fwd_on, torch.roll(fresh[w], -o), 0)
                   | torch.where(gsp_on, torch.roll(adv[w], -o), 0))
            news = got & ~seen[w]
            heard[w] = heard[w] | news
            if valid is not None:
                fd_j = fd_j + graph.popcount32(news & valid[w])
                iv_j = iv_j + graph.popcount32(news & ~valid[w])
        fd_cnt.append(fd_j)
        iv_cnt.append(iv_j)
        if k.track_promises:
            adv_r = (ctl >> CTRL_ADV) & 1
            m_g = (ctl >> CTRL_TGT) & 1
            broken = broken | ((adv_r & (1 ^ m_g) & ok_g & lacked) << j)
        if k.iwant_spam:
            pa_j = z
            for w in range(W):
                pa_j = pa_j + graph.popcount32(torch.roll(adv[w], -o))
            padv.append(pa_j)
    return (heard, graft_recv, prune_recv, a_recv, fd_cnt, iv_cnt, broken,
            padv)


def _acquired(heard, sub_all, injected) -> torch.Tensor:
    subbed = sub_all != 0
    return torch.stack([torch.where(subbed, heard[w], 0) | injected[w]
                        for w in range(len(heard))])


def _backoff(k: ReceiveConsts, backoff, bo_trig):
    """The backoff write (trigger: restart, else count down to 0) and
    its packed > 0 gate row."""
    bo32 = backoff.to(torch.int32)
    bo_new = torch.where(graph.expand_bits(bo_trig, k.n_candidates),
                         k.backoff_restart, (bo32 - 1).clamp(min=0))
    return bo_new.to(torch.int16), graph.pack_rows(bo_new > 0)


def receive_update_plain(k: ReceiveConsts, **ops):
    """Plain PyTorch version of the receive kernel (same operands, same
    outputs, bit-identical)."""
    if k.scored:
        return _receive_plain_scored(k, **ops)
    return _receive_plain_unscored(k, **ops)


def _receive_plain_unscored(k: ReceiveConsts, *, gseeds, ctrl, fresh, adv,
                            sub_all, cand_sub, fanout, wa, grafts, dropped,
                            meshsel, seen, injected, backoff):
    heard, graft_recv, prune_recv, a_recv = _exchange(
        k, ctrl, fresh, adv, seen)[:4]
    accept = graft_recv & wa
    retract = grafts & ~a_recv
    mesh = ((meshsel | accept) & ~prune_recv) & ~retract
    bo_new, bo_gate = _backoff(k, backoff, dropped | prune_recv | retract)
    tgt = targets_row(k, cand_sub & ~mesh & ~fanout & sub_all, gseeds[1],
                      mesh.shape[0])
    return (_acquired(heard, sub_all, injected), mesh, bo_new, tgt,
            bo_gate)


def _receive_plain_scored(k: ReceiveConsts, *, valid, gseeds, ctrl, fresh,
                          adv, pay, gsp, acc, sub_all, cand_sub, fanout, wa,
                          bo2, grafts, dropped, meshsel, seen, injected,
                          backoff, static, fd, inv, bp, tim, iws, syb=None):
    C = k.n_candidates
    n = pay.shape[0]
    (heard, graft_recv, prune_recv, a_recv, fd_cnt, iv_cnt, broken,
     padv) = _exchange(k, ctrl, fresh, adv, seen, pay, gsp, valid)
    graft_recv = graft_recv & acc
    prune_recv = prune_recv & acc
    viol = graft_recv & bo2
    accept = graft_recv & wa
    retract = grafts & ~a_recv
    mesh = ((meshsel | accept) & ~prune_recv) & ~retract
    acq = _acquired(heard, sub_all, injected)
    bo_new, bo_gate = _backoff(k, backoff, dropped | prune_recv | retract)

    in_mesh = graph.expand_bits(mesh, C)
    tim_new = torch.where(in_mesh, (tim.to(torch.int32) + 1).clamp(
        max=32766), 0).to(torch.int16)
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
        pull = torch.where((syb != 0)[None, :], flood, pull)
    H = k.history_length
    dec = s32 - torch.div(s32 + (H - 1), H, rounding_mode="floor")
    iws_new = (dec + pull).clamp(0, 30000).to(torch.int16)

    # stage 2: next tick's gates from the stored (rounded) counters
    fd_n = fd_new.to(torch.float32)
    inv_n = inv_new.to(torch.float32)
    score = score_from_counters(k.score, tim_new.to(torch.float32), fd_n,
                                inv_n, bp_new.to(torch.float32), static)
    accept_g = graph.pack_rows(score >= k.gray_thr)
    gossip_g = graph.pack_rows(score >= k.gossip_thr)
    pub_g = graph.pack_rows(score >= k.publish_thr)
    nonneg_g = graph.pack_rows(score >= 0)
    gater = gater_row(fd_n, inv_n, gseeds[0], n)
    elig = cand_sub & ~mesh & ~fanout & sub_all & gossip_g
    tgt = targets_row(k, elig, gseeds[1], n)
    if k.ihave_spam:
        # IHAVE-spamming sybils target every subscribed candidate
        tgt = (tgt & ~syb) | (cand_sub & syb)
    gates = (accept_g, gossip_g, pub_g, nonneg_g, accept_g & gater, tgt,
             bo_gate)
    return (acq, mesh, bo_new, *gates, fd_new, inv_new, bp_new, tim_new,
            iws_new)


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
            "gray_thr", "gossip_thr", "publish_thr")])


_WORDS_N = ("sub_all", "cand_sub", "fanout", "wa", "grafts", "dropped",
            "meshsel")
_WORDS_N_SCORED = ("pay", "gsp", "acc", "bo2")


def _check_operands(k: ReceiveConsts, ops: dict) -> None:
    C = k.n_candidates
    W, n = ops["fresh"].shape
    if (C, W, k.scored) not in KERNEL_SHAPES:
        plan.refuse("kernel_shape")
    names = set(ops) - {"gseeds"}
    want_names = {"ctrl", "fresh", "adv", "seen", "injected", "backoff",
                  *_WORDS_N}
    if k.scored:
        want_names |= set(SCORED_OPERANDS)
    if k.attacks:
        want_names.add("syb")
    if names != want_names:
        variant = ("attack" if k.attacks else
                   "scored" if k.scored else "unscored")
        raise ValueError(
            f"{variant} receive operands: "
            f"missing {sorted(want_names - names)}, unexpected "
            f"{sorted(names - want_names)}")
    want = {"ctrl": ((C, n), torch.uint8),
            "fresh": ((W, n), torch.int32), "adv": ((W, n), torch.int32),
            "seen": ((W, n), torch.int32),
            "injected": ((W, n), torch.int32),
            "backoff": ((C, n), torch.int16)}
    want.update({name: ((n,), torch.int32) for name in _WORDS_N})
    if k.attacks:
        want["syb"] = ((n,), torch.int32)
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
        t = ops[name]
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, sub_all on {device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def receive_update(k: ReceiveConsts, **ops):
    """One tick's receive half (operands and outputs: module docstring).

    CUDA tensors launch the kernel (a failed build or launch raises);
    CPU tensors run ``receive_update_plain``."""
    global launches, launches_unscored, launches_attacks
    _check_operands(k, ops)
    if ops["sub_all"].device.type == "cpu":
        return receive_update_plain(k, **ops)
    C = k.n_candidates
    W, n = ops["fresh"].shape
    dev = ops["sub_all"].device
    n_gates = N_GATES if k.scored else N_GATES_UNSCORED
    acq = torch.empty((W, n), dtype=torch.int32, device=dev)
    mesh = torch.empty((n,), dtype=torch.int32, device=dev)
    bo_out = torch.empty((C, n), dtype=torch.int16, device=dev)
    gates = torch.empty((n_gates, n), dtype=torch.int32, device=dev)
    outs = [("acq", acq), ("mesh", mesh), ("backoff_out", bo_out),
            ("gates", gates)]
    a = _Args()
    for name in ("ctrl", "fresh", "adv", *_WORDS_N, "seen", "backoff"):
        setattr(a, name, ops[name].data_ptr())
    a.inj = ops["injected"].data_ptr()
    a.n = n
    for j in range(C):
        a.offsets[j] = k.offsets[j] % n
        a.cinv[j] = k.cinv[j]
    a.seed_gater, a.seed_targets = (int(g) & graph.MASK32
                                    for g in ops["gseeds"])
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
    for name, t in outs:
        setattr(a, name, t.data_ptr())
    lib = _build.load("receive")
    fn = lib.gossip_receive_update
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
    if k.attacks:
        launches_attacks += 1
    elif k.scored:
        launches += 1
    else:
        launches_unscored += 1
    return (acq, mesh, bo_out, *gates.unbind(0),
            *(t for _, t in outs[4:]))


def operand_bytes(ops: dict, outs) -> int:
    """Bytes the receive half must move: each operand read once, each
    output written once."""
    total = sum(t.numel() * t.element_size() for name, t in ops.items()
                if isinstance(t, torch.Tensor))
    return total + sum(t.numel() * t.element_size() for t in outs)
