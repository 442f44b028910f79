"""Simulator -> TraceEvent export: the port's copy of the JAX package's
``interop/export.py``, writing the same bytes for the same inputs.

The simulator emits the event stream of go-libp2p-pubsub's tracer so a
run can be replayed and compared with the reference's own
``traced``/``tracestat`` tooling.  The delivery record (``first_tick``)
and the publish table give PUBLISH_MESSAGE / DELIVER_MESSAGE; fault
schedules give JOIN/LEAVE (``churn_events``) and ADD_PEER / REMOVE_PEER
(``peer_events``, with the candidate ring); per-tick mesh snapshots give
GRAFT/PRUNE (``mesh_trace_events``), possession snapshots
REJECT_MESSAGE / DUPLICATE_MESSAGE (``reject_events``,
``duplicate_events``), and the per-edge RPC probe SEND_RPC / RECV_RPC /
DROP_RPC (``rpc_events``): all 13 event types.  Files are written in the
tracer's two sink formats, varint-delimited protobuf
(``write_pb_trace``, NewPBTracer) and ndjson (``write_json_trace``,
NewJSONTracer), with the latency histograms in a JSON sidecar
(``write_telemetry_frames``).

Inputs are host arrays: numpy, or the port's tensors (``host_array``
brings them across: the int32 tensors that hold u32 words become uint32,
as the JAX package's arrays are).  Host Python throughout, as in the
reference: export runs, not benchmarks of the device.

Synthetic identities: sim peer i gets peer id ``b"sim-%d" % i``; message
m gets id ``b"msg-%d" % m``; tick t maps to timestamp t * 1e9 ns (one
heartbeat = one second, the reference default interval).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..artifacts import (write_bytes_atomic, write_json_atomic,
                         write_text_atomic)
from ..pb import trace as tr
from ..pb.proto import write_delimited
from ..pb.trace import TraceType, proto_to_jsonable

NS_PER_TICK = 1_000_000_000  # 1 Hz heartbeat (gossipsub.go:44)


def peer_id(i: int) -> bytes:
    return b"sim-%d" % i


def msg_id(m: int) -> bytes:
    return b"msg-%d" % m


def host_array(x) -> np.ndarray:
    """A host numpy array of ``x`` (a tensor on any device, or an array);
    int32 words are viewed as the uint32 words they hold."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def host_snapshots(snaps: dict) -> dict:
    """A snapshot runner's dict (``gossip_run_*_snapshots``) as host
    arrays, leaf by leaf (``host_array``)."""
    return {k: host_array(v) for k, v in snaps.items()}


def _churn_items(fault_schedule, peer_topic: np.ndarray):
    """FaultSchedule churn -> sorted (tick, kind, topic, peer) items,
    kind -2 = LEAVE, -1 = JOIN — the single expansion both
    churn_events and events_from_sim consume.

    Adjacent intervals ([a, b) followed by [b, c) on one peer — legal
    per the schedule validator, and one continuous outage to
    alive_mask) are MERGED first, so the stream never shows a
    same-tick JOIN+LEAVE pair that would leave a replay consumer
    believing the peer came back up."""
    per_peer: dict[int, list[list[int]]] = {}
    for p, s, e in fault_schedule.down_intervals:
        lst = per_peer.setdefault(int(p), [])
        if lst and lst[-1][1] == s:      # validator guarantees sorted
            lst[-1][1] = e
        else:
            lst.append([s, e])
    items = []
    for p, ivs in per_peer.items():
        for s, e in ivs:
            items.append((s, -2, int(peer_topic[p]), p))        # LEAVE
            if e < fault_schedule.horizon:
                items.append((e, -1, int(peer_topic[p]), p))    # JOIN
    items.sort()
    return items


def churn_events(fault_schedule, peer_topic: np.ndarray,
                 topic_name=lambda t: f"topic-{t}"):
    """FaultSchedule churn -> JOIN/LEAVE TraceEvents (reference
    trace.proto types 9/10 — the events the reference's own harness
    emits when hosts come and go).

    A peer LEAVEs its topic at each down interval's start and re-JOINs
    at its end (no JOIN when the interval runs to the schedule horizon
    — the peer never came back within the run).  ``peer_topic``: int
    [N] residue-class topic per peer (the sim's membership model).
    Returned sorted by (tick, LEAVE-before-JOIN-before-payload order),
    mergeable into events_from_sim's stream via ``fault_schedule=``.
    """
    items = _churn_items(fault_schedule, peer_topic)
    out = []
    for t, kind, tpc, p in items:
        if kind == -2:
            out.append(tr.TraceEvent(
                type=TraceType.LEAVE, peer_id=peer_id(p),
                timestamp=t * NS_PER_TICK,
                leave=tr.LeaveEv(topic=topic_name(tpc))))
        else:
            out.append(tr.TraceEvent(
                type=TraceType.JOIN, peer_id=peer_id(p),
                timestamp=t * NS_PER_TICK,
                join=tr.JoinEv(topic=topic_name(tpc))))
    return out


def events_from_sim(first_tick_matrix: np.ndarray,
                    msg_topic: np.ndarray,
                    msg_origin: np.ndarray,
                    msg_publish_tick: np.ndarray,
                    topic_name=lambda t: f"topic-{t}",
                    fault_schedule=None,
                    peer_topic: np.ndarray | None = None):
    """Yield TraceEvents (publish + every first delivery) in tick order.

    first_tick_matrix: int [N, M] (models *.first_tick_matrix output;
    -1 = not delivered).  Origins' own inject-tick deliveries are emitted
    as their PUBLISH_MESSAGE events.

    With ``fault_schedule`` (+ ``peer_topic`` [N]), churn JOIN/LEAVE
    events are merged into the stream in tick order (leave/join sort
    before same-tick payload events), so churn runs validate against
    reference traces that carry the same event types.
    """
    n, m = first_tick_matrix.shape
    items = []                              # (tick, kind, payload)
    if fault_schedule is not None:
        if peer_topic is None:
            raise ValueError(
                "fault_schedule needs peer_topic (int [N]): JOIN/LEAVE "
                "events carry the churned peer's topic — a silent "
                "topic-0 default would mislabel every multi-topic "
                "churn trace")
        items.extend(_churn_items(fault_schedule, peer_topic))
    for j in range(m):
        items.append((int(msg_publish_tick[j]), 0, j, int(msg_origin[j])))
    peers, msgs = np.nonzero(first_tick_matrix >= 0)
    ticks = first_tick_matrix[peers, msgs]
    for p, j, t in zip(peers, msgs, ticks):
        # the origin's own copy gets BOTH events, like the reference
        # (publishMessage traces DeliverMessage for local publishes,
        # pubsub.go:1056-1060)
        items.append((int(t), 1, int(j), int(p)))
    items.sort()                        # chronological stream, pubs first
    out = []
    for t, kind, j, p in items:
        if kind == -2:
            out.append(tr.TraceEvent(
                type=TraceType.LEAVE, peer_id=peer_id(p),
                timestamp=t * NS_PER_TICK,
                leave=tr.LeaveEv(topic=topic_name(j))))
        elif kind == -1:
            out.append(tr.TraceEvent(
                type=TraceType.JOIN, peer_id=peer_id(p),
                timestamp=t * NS_PER_TICK,
                join=tr.JoinEv(topic=topic_name(j))))
        elif kind == 0:
            out.append(tr.TraceEvent(
                type=TraceType.PUBLISH_MESSAGE,
                peer_id=peer_id(p), timestamp=t * NS_PER_TICK,
                publish_message=tr.PublishMessageEv(
                    message_id=msg_id(j),
                    topic=topic_name(int(msg_topic[j])))))
        else:
            out.append(tr.TraceEvent(
                type=TraceType.DELIVER_MESSAGE,
                peer_id=peer_id(p), timestamp=t * NS_PER_TICK,
                deliver_message=tr.DeliverMessageEv(
                    message_id=msg_id(j),
                    topic=topic_name(int(msg_topic[j])))))
    return out


def mesh_trace_events(mesh_snapshots: np.ndarray, offsets,
                      peer_topic: np.ndarray,
                      start_tick: int = 0,
                      initial_mesh: np.ndarray | None = None,
                      topic_name=lambda t: f"topic-{t}"):
    """Host-side diff of per-tick mesh words -> GRAFT/PRUNE TraceEvents
    (reference trace.proto types 11/12 — the mesh-maintenance events
    the reference tracer emits from its heartbeat).

    mesh_snapshots: uint32 [T, N], row k = the mesh bitmask AFTER tick
    ``start_tick + k`` (models/gossipsub.py gossip_run_mesh_snapshots).
    ``initial_mesh`` [N] is the baseline before the first diffed tick
    (the pre-run ``state.mesh``; defaults to the empty mesh).  A bit
    gained between consecutive snapshots is a GRAFT by that peer at
    that tick, a bit lost is a PRUNE; the event's ``peer_id`` field
    carries the mesh partner (the grafted/pruned edge's other end, as
    in the reference's GraftEv/PruneEv), the topic is the grafting
    peer's residue-class topic (``peer_topic`` int [N]).

    Returned in tick order (GRAFTs before PRUNEs within a tick);
    merge with an events_from_sim stream via merge_event_streams, and
    in paired mode call once per mesh slot with that slot's topics.
    """
    snaps = np.asarray(host_array(mesh_snapshots), dtype=np.uint64)
    t_ticks, n = snaps.shape
    offs = tuple(int(o) for o in offsets)
    prev = (np.zeros(n, dtype=np.uint64) if initial_mesh is None
            else np.asarray(host_array(initial_mesh), dtype=np.uint64))
    out = []
    for k in range(t_ticks):
        cur = snaps[k]
        diff = cur ^ prev
        if diff.any():
            ts = (start_tick + k) * NS_PER_TICK
            for kind in (0, 1):                     # grafts, then prunes
                for c, off in enumerate(offs):
                    cur_c = (cur >> np.uint64(c)) & np.uint64(1)
                    prev_c = (prev >> np.uint64(c)) & np.uint64(1)
                    flip = (cur_c & ~prev_c if kind == 0
                            else prev_c & ~cur_c)
                    for p in np.flatnonzero(flip):
                        partner = peer_id(int((p + off) % n))
                        tpc = topic_name(int(peer_topic[p]))
                        if kind == 0:
                            out.append(tr.TraceEvent(
                                type=TraceType.GRAFT,
                                peer_id=peer_id(int(p)), timestamp=ts,
                                graft=tr.GraftEv(peer_id=partner,
                                                 topic=tpc)))
                        else:
                            out.append(tr.TraceEvent(
                                type=TraceType.PRUNE,
                                peer_id=peer_id(int(p)), timestamp=ts,
                                prune=tr.PruneEv(peer_id=partner,
                                                 topic=tpc)))
        prev = cur
    return out


def reject_events(have_snapshots: np.ndarray, msg_invalid: np.ndarray,
                  msg_topic: np.ndarray, start_tick: int = 0,
                  initial_have: np.ndarray | None = None,
                  n_true: int | None = None,
                  topic_name=lambda t: f"topic-{t}",
                  reason: str = "validation failed"):
    """Host-side diff of per-tick possession words -> REJECT_MESSAGE
    TraceEvents (reference trace.proto type 1).

    A peer's FIRST acquisition of a validation-failing message is the
    tick its router rejects it (validation.go:274-351 — the same
    copies P4 counts in aggregate; the telemetry seen-cache counters
    measure them network-wide, this emits the per-event stream).

    have_snapshots: uint32 [T, W, N], row k = possession AFTER tick
    ``start_tick + k`` (models/gossipsub.py gossip_run_acq_snapshots).
    ``initial_have`` [W, N] is the pre-run baseline (defaults to
    empty).  ``n_true`` slices kernel-padded snapshots to the true
    ring.  ``received_from`` is left unset: the sim's one-tick window
    makes the rejecting peer and tick exact but the sending edge of
    the FIRST copy unobservable from possession diffs (use
    duplicate_events' replay for per-edge attribution of repeats).

    Exact — acquisition is a pure function of the possession words,
    independent of path, gates, or faults."""
    snaps = np.asarray(host_array(have_snapshots), dtype=np.uint32)
    if n_true is not None:
        snaps = snaps[:, :, :n_true]
    t_ticks = snaps.shape[0]
    inv_ids = np.flatnonzero(np.asarray(msg_invalid, dtype=bool))
    prev = (np.zeros_like(snaps[0]) if initial_have is None
            else np.asarray(host_array(initial_have),
                            dtype=np.uint32)[:, :snaps.shape[2]])
    out = []
    for k in range(t_ticks):
        cur = snaps[k]
        new = cur & ~prev
        ts = (start_tick + k) * NS_PER_TICK
        for m in inv_ids:
            w, b = divmod(int(m), 32)
            for p in np.flatnonzero((new[w] >> np.uint32(b))
                                    & np.uint32(1)):
                out.append(tr.TraceEvent(
                    type=TraceType.REJECT_MESSAGE,
                    peer_id=peer_id(int(p)), timestamp=ts,
                    reject_message=tr.RejectMessageEv(
                        message_id=msg_id(int(m)), reason=reason,
                        topic=topic_name(int(msg_topic[m])))))
        prev = cur
    return out


def duplicate_events(have_snapshots: np.ndarray,
                     mesh_snapshots: np.ndarray, offsets,
                     msg_topic: np.ndarray, start_tick: int = 0,
                     initial_have: np.ndarray | None = None,
                     initial_mesh: np.ndarray | None = None,
                     n_true: int | None = None,
                     mesh_b_snapshots: np.ndarray | None = None,
                     initial_mesh_b: np.ndarray | None = None,
                     slot_b_words: np.ndarray | None = None,
                     topic_name=lambda t: f"topic-{t}"):
    """Host-side eager-forward replay -> DUPLICATE_MESSAGE TraceEvents
    (reference trace.proto type 2, the seen-cache hit pubsub.go:
    851-868), with per-copy sender attribution (``received_from``).

    Replay model: at tick t every peer forwards its tick t-1
    acquisitions along its mesh edges (out_bits = start-of-tick mesh,
    forwardMessage gossipsub.go:989-999); a copy landing on a peer
    that already holds the id is a duplicate.  Same-tick multi-source
    copies count as duplicates for every sender after the first in
    candidate-bit order (arrival order inside the one-tick window is
    unobservable; the count matches the reference's serial seen-cache
    exactly).  Under this model the per-tick event count EQUALS the
    telemetry ``dup_suppressed`` counter for gossip-free,
    fully-subscribed, fault-free runs (pinned by
    tests/test_torch_trace_export.py); gossip pulls are lack-gated in the
    sim and contribute no duplicates, so in general the stream covers
    the eager-mesh duplicate class (fanout/flood-publish copies and
    gater-closed edges fall outside the replay).

    have_snapshots [T, W, N] / mesh_snapshots [T, N]: END-of-tick
    rows from gossip_run_acq_snapshots; ``initial_*`` are the pre-run
    baselines.  Events start at the SECOND snapshot tick (the first
    needs pre-run acquisition history).  ``n_true`` slices
    kernel-padded snapshots (the replay's rolls must wrap at the true
    ring).

    Paired-topic runs: pass ``mesh_b_snapshots`` (and
    ``slot_b_words`` — GossipParams.slot_b_words, uint32 [W, N]: bit
    m set iff message m rides peer p's SECOND topic slot) so the
    replay splits each sender's fresh set by topic slot and walks
    BOTH meshes, as the sim's forwarding does."""
    snaps = np.asarray(host_array(have_snapshots), dtype=np.uint32)
    meshes = np.asarray(host_array(mesh_snapshots), dtype=np.uint32)
    meshes_b = (None if mesh_b_snapshots is None
                else np.asarray(host_array(mesh_b_snapshots),
                                dtype=np.uint32))
    if meshes_b is not None and slot_b_words is None:
        raise ValueError(
            "duplicate_events: mesh_b_snapshots needs slot_b_words "
            "(which messages ride the second topic slot) — without "
            "the split the replay would forward every id on both "
            "meshes and overcount")
    if slot_b_words is not None and meshes_b is None:
        raise ValueError(
            "duplicate_events: slot_b_words needs mesh_b_snapshots "
            "(the second slot's mesh to forward along) — without it "
            "every slot-B id would drop out of the replay and "
            "undercount")
    if n_true is not None:
        snaps = snaps[:, :, :n_true]
        meshes = meshes[:, :n_true]
        if meshes_b is not None:
            meshes_b = meshes_b[:, :n_true]
    t_ticks, w_words, n = snaps.shape
    offs = tuple(int(o) for o in offsets)
    slot_b = (None if slot_b_words is None
              else np.asarray(host_array(slot_b_words),
                              dtype=np.uint32)[:, :n])
    h0 = (np.zeros_like(snaps[0]) if initial_have is None
          else np.asarray(host_array(initial_have), dtype=np.uint32)[:, :n])
    m0 = (np.zeros_like(meshes[0]) if initial_mesh is None
          else np.asarray(host_array(initial_mesh), dtype=np.uint32)[:n])
    hav = np.concatenate([h0[None], snaps])      # hav[i] = end of tick
    msh = np.concatenate([m0[None], meshes])     #   start_tick + i - 1
    msh_b = None
    if meshes_b is not None:
        m0b = (np.zeros_like(meshes_b[0]) if initial_mesh_b is None
               else np.asarray(host_array(initial_mesh_b),
                               dtype=np.uint32)[:n])
        msh_b = np.concatenate([m0b[None], meshes_b])
    out = []
    for k in range(2, t_ticks + 1):
        tick = start_tick + k - 1
        ts = tick * NS_PER_TICK
        acq_prev = hav[k - 1] & ~hav[k - 2]      # [W, N] sender fresh
        have_prev = hav[k - 1]
        mesh_out = msh[k - 1]                    # start-of-tick mesh
        mesh_b_out = None if msh_b is None else msh_b[k - 1]
        already = have_prev.copy()               # per-receiver cache
        for c, off in enumerate(offs):
            senders = ((mesh_out >> np.uint32(c)) & np.uint32(1)
                       ).astype(bool)
            senders_b = (None if mesh_b_out is None else
                         ((mesh_b_out >> np.uint32(c)) & np.uint32(1)
                          ).astype(bool))
            for w in range(w_words):
                if slot_b is None:
                    sent = np.where(senders, acq_prev[w], 0)
                else:
                    # the sim forwards slot-A content on mesh and
                    # slot-B content on mesh_b, merged per edge
                    sent = (np.where(senders,
                                     acq_prev[w] & ~slot_b[w], 0)
                            | np.where(senders_b,
                                       acq_prev[w] & slot_b[w], 0))
                copy_w = np.roll(sent, off)
                dup = copy_w & already[w]
                for r in np.flatnonzero(dup):
                    src = peer_id(int((r - off) % n))
                    for b in range(32):
                        if (dup[r] >> np.uint32(b)) & np.uint32(1):
                            m = w * 32 + b
                            out.append(tr.TraceEvent(
                                type=TraceType.DUPLICATE_MESSAGE,
                                peer_id=peer_id(int(r)), timestamp=ts,
                                duplicate_message=tr.DuplicateMessageEv(
                                    message_id=msg_id(m),
                                    received_from=src,
                                    topic=topic_name(
                                        int(msg_topic[m])))))
                already[w] = already[w] | copy_w
    return out


def peer_events(offsets, n: int, fault_schedule=None,
                proto: str = "/meshsub/1.1.0"):
    """Topology + churn -> ADD_PEER / REMOVE_PEER TraceEvents
    (reference trace.proto types 4/5 — the host's connection events,
    pubsub.go:268-320).

    The sim's circulant candidate graph IS its connection set: at tick
    0 every live peer ADD_PEERs each live candidate partner.  Churn
    (``fault_schedule`` down intervals, adjacent intervals merged like
    churn_events) maps to connection loss: when p goes down, every
    live partner emits REMOVE_PEER for p (p itself is off and traces
    nothing); when p comes back, both directions re-ADD.  Two peers
    rejoining the same tick dedupe to one event per (observer,
    subject).  Returned in tick order."""
    offs = tuple(int(o) for o in offsets)

    merged: dict[int, list[list[int]]] = {}
    if fault_schedule is not None:
        for p, s, e in fault_schedule.down_intervals:
            lst = merged.setdefault(int(p), [])
            if lst and lst[-1][1] == s:
                lst[-1][1] = e
            else:
                lst.append([int(s), int(e)])

    def alive_at(p: int, t: int) -> bool:
        return not any(s <= t < e for s, e in merged.get(p, ()))

    items = []         # (tick, kind 0=add 1=remove, observer, subject)
    seen = set()

    def emit(t, kind, obs, subj):
        key = (t, kind, obs, subj)
        if key not in seen:
            seen.add(key)
            items.append(key)

    for p in range(n):
        if not alive_at(p, 0):
            continue
        for o in offs:
            q = (p + o) % n
            if q != p and alive_at(q, 0):
                emit(0, 0, p, q)
    for p, ivs in merged.items():
        for s, e in ivs:
            if s > 0:          # down from tick 0 = never connected
                for o in offs:
                    q = (p + o) % n
                    if q != p and alive_at(q, s):
                        emit(s, 1, q, p)
            if fault_schedule is not None and e < fault_schedule.horizon:
                for o in offs:
                    q = (p + o) % n
                    if q != p and alive_at(q, e):
                        emit(e, 0, p, q)
                        emit(e, 0, q, p)
    items.sort()
    out = []
    for t, kind, obs, subj in items:
        if kind == 0:
            out.append(tr.TraceEvent(
                type=TraceType.ADD_PEER, peer_id=peer_id(obs),
                timestamp=t * NS_PER_TICK,
                add_peer=tr.AddPeerEv(peer_id=peer_id(subj),
                                      proto=proto)))
        else:
            out.append(tr.TraceEvent(
                type=TraceType.REMOVE_PEER, peer_id=peer_id(obs),
                timestamp=t * NS_PER_TICK,
                remove_peer=tr.RemovePeerEv(peer_id=peer_id(subj))))
    return out


def _ids_of(words_col: np.ndarray, n_msgs: int) -> list[int]:
    """Set bit positions of one peer's [W] possession column."""
    out = []
    for w, word in enumerate(words_col):
        word = int(word)
        while word:
            b = (word & -word).bit_length() - 1
            m = w * 32 + b
            if m < n_msgs:
                out.append(m)
            word &= word - 1
    return out


def rpc_events(rpc_snaps: dict, offsets, msg_topic: np.ndarray,
               peer_topic: np.ndarray, start_tick: int = 0,
               n_true: int | None = None,
               topic_name=lambda t: f"topic-{t}",
               peer_topic_b: np.ndarray | None = None,
               slot_b_words: np.ndarray | None = None):
    """Per-edge RPC probe snapshots -> SEND_RPC / RECV_RPC / DROP_RPC
    TraceEvents with full RPCMeta (reference trace.proto types 6/7/8).

    ``rpc_snaps``: the dict gossip_run_rpc_snapshots collected (step
    built with rpc_probe=True) — per-tick ATTEMPT masks (eager
    forward, IHAVE, GRAFT, PRUNE), content words, and fault masks.

    RPC model (mirrors the sim's one-tick window and the reference's
    per-peer RPC coalescing, gossipsub.go sendRPC/flush):

    - Each attempted directed edge-tick (p -> q) with any payload or
      control carries ONE RPC: meta.messages = p's fresh forwards (on
      mesh/fanout edges), meta.control.ihave = the merged advert (on
      gossip-target edges), meta.control.graft/prune = the handshake.
    - A dead sender attempts nothing (the node is off — no events,
      like the reference's stopped host).
    - An alive sender on a fault-masked edge (link down, or the
      partner dead) emits DROP_RPC with the same meta — the RPC that
      left the router and died on the wire (the reference's DropRPC,
      tracer.go:Drop on a full/closed outbound queue).
    - A healthy edge emits SEND_RPC at p and RECV_RPC at q.  If the
      RPC carried an IHAVE advertising ids q lacks, q responds with an
      IWANT RPC (reverse SEND/RECV, same tick — the link is up and
      symmetric), and p serves the requested ids as a payload RPC
      unless it is a withholding spammer (the broken-promise gap).

    On a fault-free unscored run the stream's aggregate counts equal
    the telemetry counters exactly (messages == payload_sent +
    iwant_ids_served, ihave/iwant ids and RPC counts, graft/prune
    sends; pinned by tests/test_torch_trace_export.py).

    Since round 11 flood-publish sends are captured too (the fixed
    round-10 refusal): a ``flood``-targeted edge carries the sender's
    own due publishes (``inj``) in its RPC — on flood-only edges those
    are the whole payload, on mesh edges they were already inside the
    fresh set.

    PAIRED-TOPIC overlays (round 13 — the lifted refusal): snapshots
    carrying the per-slot fields (``fwd_b`` / ``graft_b`` /
    ``prune_b`` / ``fresh_a`` / ``fresh_b``) reconstruct both topic
    slots — slot-B mesh forwards merge into the same edge RPC,
    GRAFT/PRUNE metas carry each slot's own topic, and with
    ``slot_b_words`` (GossipParams.slot_b_words, uint32 [W, N]) the
    merged IHAVE splits into per-topic entries; pass
    ``peer_topic_b`` (each peer's SECOND topic)."""
    offs = tuple(int(o) for o in offsets)
    rpc_snaps = host_snapshots(rpc_snaps)
    fwd = np.asarray(rpc_snaps["fwd"])
    ihave = np.asarray(rpc_snaps["ihave"])
    graft = np.asarray(rpc_snaps["graft"])
    prune = np.asarray(rpc_snaps["prune"])
    withhold = np.asarray(rpc_snaps["withhold"])
    send_ok = np.asarray(rpc_snaps["send_ok"])
    alive = np.asarray(rpc_snaps["alive"])
    fresh = np.asarray(rpc_snaps["fresh"])
    adv = np.asarray(rpc_snaps["adv"])
    seen = np.asarray(rpc_snaps["seen"])
    # round-11 snapshot fields; tolerate round-10 recordings
    flood = (np.asarray(rpc_snaps["flood"])
             if "flood" in rpc_snaps else None)
    inj = np.asarray(rpc_snaps["inj"]) if "inj" in rpc_snaps else None
    # round-13 paired-slot fields
    paired = "fwd_b" in rpc_snaps
    if paired:
        if peer_topic_b is None:
            raise ValueError(
                "rpc_events: paired-topic snapshots need "
                "peer_topic_b (each peer's second topic slot)")
        fwd_b = np.asarray(rpc_snaps["fwd_b"])
        graft_b = np.asarray(rpc_snaps["graft_b"])
        prune_b = np.asarray(rpc_snaps["prune_b"])
        fresh_a = np.asarray(rpc_snaps["fresh_a"])
        fresh_b = np.asarray(rpc_snaps["fresh_b"])
    else:
        fwd_b = graft_b = prune_b = fresh_b = None
        fresh_a = fresh
    slot_b = (None if slot_b_words is None
              else np.asarray(host_array(slot_b_words), dtype=np.uint32))
    t_ticks = fwd.shape[0]
    n = fwd.shape[1] if n_true is None else n_true
    n_msgs = len(msg_topic)

    def msg_metas(ids):
        return [tr.MessageMeta(message_id=msg_id(m),
                               topic=topic_name(int(msg_topic[m])))
                for m in ids]

    out = []
    for k in range(t_ticks):
        ts = (start_tick + k) * NS_PER_TICK
        fresh_any = np.zeros(n, dtype=bool)
        fb_any = np.zeros(n, dtype=bool)
        adv_any = np.zeros(n, dtype=bool)
        inj_any = np.zeros(n, dtype=bool)
        for w in range(fresh.shape[1]):
            fresh_any |= fresh_a[k, w, :n] != 0
            adv_any |= adv[k, w, :n] != 0
            if fresh_b is not None:
                fb_any |= fresh_b[k, w, :n] != 0
            if inj is not None:
                inj_any |= inj[k, w, :n] != 0
        for c, off in enumerate(offs):
            bit = np.uint32(1) << np.uint32(c)
            f_e = ((fwd[k, :n] & bit) != 0) & fresh_any
            ih_e = ((ihave[k, :n] & bit) != 0) & adv_any
            g_e = (graft[k, :n] & bit) != 0
            p_e = (prune[k, :n] & bit) != 0
            fl_e = (((flood[k, :n] & bit) != 0) & inj_any
                    if flood is not None else np.zeros(n, dtype=bool))
            if paired:
                fb_e = ((fwd_b[k, :n] & bit) != 0) & fb_any
                gb_e = (graft_b[k, :n] & bit) != 0
                pb_e = (prune_b[k, :n] & bit) != 0
            else:
                fb_e = gb_e = pb_e = np.zeros(n, dtype=bool)
            attempted = (f_e | ih_e | g_e | p_e | fl_e
                         | fb_e | gb_e | pb_e) & alive[k, :n]
            for p in np.flatnonzero(attempted):
                p = int(p)
                q = (p + off) % n
                # slot-A fresh ⊇ slot-A inj, so a mesh edge that also
                # floods needs no merge for its own slot; flood-ONLY
                # edges carry just the due publishes, and slot-B mesh
                # content merges into the same edge RPC (disjoint id
                # sets by construction)
                msgs = sorted(set(
                    (_ids_of(fresh_a[k, :, p], n_msgs) if f_e[p]
                     else [])
                    + (_ids_of(fresh_b[k, :, p], n_msgs)
                       if paired and fb_e[p] else [])
                    + (_ids_of(inj[k, :, p], n_msgs) if fl_e[p]
                       else [])))
                ctl_kw = {}
                if ih_e[p]:
                    if slot_b is not None:
                        # per-topic IHAVE split: message m rides the
                        # slot its bit in slot_b_words[:, p] says
                        ids_all = _ids_of(adv[k, :, p], n_msgs)
                        on_b = {m for m in ids_all
                                if (int(slot_b[m // 32, p])
                                    >> (m % 32)) & 1}
                        entries = []
                        ids_a = [m for m in ids_all if m not in on_b]
                        if ids_a:
                            entries.append(tr.ControlIHaveMeta(
                                topic=topic_name(int(peer_topic[p])),
                                message_ids=[msg_id(m)
                                             for m in ids_a]))
                        if on_b:
                            entries.append(tr.ControlIHaveMeta(
                                topic=topic_name(
                                    int(peer_topic_b[p])),
                                message_ids=[msg_id(m) for m in
                                             sorted(on_b)]))
                        ctl_kw["ihave"] = entries
                    else:
                        ctl_kw["ihave"] = [tr.ControlIHaveMeta(
                            topic=topic_name(int(peer_topic[p])),
                            message_ids=[msg_id(m) for m in _ids_of(
                                adv[k, :, p], n_msgs)])]
                grafts_meta = []
                if g_e[p]:
                    grafts_meta.append(tr.ControlGraftMeta(
                        topic=topic_name(int(peer_topic[p]))))
                if paired and gb_e[p]:
                    grafts_meta.append(tr.ControlGraftMeta(
                        topic=topic_name(int(peer_topic_b[p]))))
                if grafts_meta:
                    ctl_kw["graft"] = grafts_meta
                prunes_meta = []
                if p_e[p]:
                    prunes_meta.append(tr.ControlPruneMeta(
                        topic=topic_name(int(peer_topic[p]))))
                if paired and pb_e[p]:
                    prunes_meta.append(tr.ControlPruneMeta(
                        topic=topic_name(int(peer_topic_b[p]))))
                if prunes_meta:
                    ctl_kw["prune"] = prunes_meta
                meta = tr.RPCMeta(
                    messages=msg_metas(msgs),
                    control=(tr.ControlMeta(**ctl_kw) if ctl_kw
                             else None))
                ok = bool(((send_ok[k, p] & bit) != 0)
                          and alive[k, q])
                if not ok:
                    out.append(tr.TraceEvent(
                        type=TraceType.DROP_RPC, peer_id=peer_id(p),
                        timestamp=ts,
                        drop_rpc=tr.DropRPCEv(send_to=peer_id(q),
                                              meta=meta)))
                    continue
                out.append(tr.TraceEvent(
                    type=TraceType.SEND_RPC, peer_id=peer_id(p),
                    timestamp=ts,
                    send_rpc=tr.SendRPCEv(send_to=peer_id(q),
                                          meta=meta)))
                out.append(tr.TraceEvent(
                    type=TraceType.RECV_RPC, peer_id=peer_id(q),
                    timestamp=ts,
                    recv_rpc=tr.RecvRPCEv(received_from=peer_id(p),
                                          meta=meta)))
                if ih_e[p]:
                    lack = _lack_ids(adv[k, :, p], seen[k, :, q],
                                     n_msgs)
                    if lack:
                        iw_meta = tr.RPCMeta(control=tr.ControlMeta(
                            iwant=[tr.ControlIWantMeta(
                                message_ids=[msg_id(m)
                                             for m in lack])]))
                        out.append(tr.TraceEvent(
                            type=TraceType.SEND_RPC,
                            peer_id=peer_id(q), timestamp=ts,
                            send_rpc=tr.SendRPCEv(
                                send_to=peer_id(p), meta=iw_meta)))
                        out.append(tr.TraceEvent(
                            type=TraceType.RECV_RPC,
                            peer_id=peer_id(p), timestamp=ts,
                            recv_rpc=tr.RecvRPCEv(
                                received_from=peer_id(q),
                                meta=iw_meta)))
                        if not withhold[k, p]:
                            sv_meta = tr.RPCMeta(
                                messages=msg_metas(lack))
                            out.append(tr.TraceEvent(
                                type=TraceType.SEND_RPC,
                                peer_id=peer_id(p), timestamp=ts,
                                send_rpc=tr.SendRPCEv(
                                    send_to=peer_id(q),
                                    meta=sv_meta)))
                            out.append(tr.TraceEvent(
                                type=TraceType.RECV_RPC,
                                peer_id=peer_id(q), timestamp=ts,
                                recv_rpc=tr.RecvRPCEv(
                                    received_from=peer_id(p),
                                    meta=sv_meta)))
    return out


def _lack_ids(adv_col: np.ndarray, seen_col: np.ndarray,
              n_msgs: int) -> list[int]:
    """Ids advertised in ``adv_col`` [W] that ``seen_col`` [W] lacks."""
    return _ids_of(np.asarray(
        [np.uint32(a) & ~np.uint32(s)
         for a, s in zip(adv_col, seen_col)]), n_msgs)


def write_telemetry_frames(path: str, frames, tcfg,
                           counts=None, publish_tick=None,
                           msg_topic=None, start_tick: int = 0) -> None:
    """JSON histogram-frames sidecar for ``tracestat --frames`` — the
    device-side latency distribution a trace file cannot carry (the trace
    has per-event latencies, but at scale only the histogram ships).

    ``frames`` (the port's ``TelemetryFrame``, stacked by a runner) must
    come from a latency_hist-enabled telemetry run.  With ``counts``
    (per-tick delivered counts, [T, M]) plus the publish table, the exact
    per-topic split is added host-side
    (``models/telemetry.latency_hists_by_topic``)."""
    from ..models import telemetry as _tl

    arrs = _tl.frames_to_arrays(frames)
    if "latency_hist" not in arrs:
        raise ValueError(
            "write_telemetry_frames: frames carry no latency_hist — "
            "run with TelemetryConfig(latency_hist=True)")
    per_tick = arrs["latency_hist"].reshape(
        -1, arrs["latency_hist"].shape[-1])
    obj = {
        "ns_per_tick": NS_PER_TICK,
        "latency_buckets": int(tcfg.latency_buckets),
        "latency_hist": [int(c) for c in per_tick.sum(axis=0)],
        "latency_hist_per_tick": [[int(c) for c in row]
                                  for row in per_tick],
    }
    if counts is not None:
        if publish_tick is None or msg_topic is None:
            raise ValueError(
                "write_telemetry_frames: counts needs publish_tick "
                "and msg_topic for the per-topic split")
        obj["latency_hist_by_topic"] = _tl.latency_hists_by_topic(
            counts, publish_tick, msg_topic, tcfg.latency_buckets,
            start_tick=start_tick)
    write_json_atomic(path, obj, indent=None)


def merge_event_streams(*streams):
    """Merge TraceEvent streams into one timestamp-ordered stream
    (stable sort: within a tick, each stream's internal order is kept
    and earlier streams sort first)."""
    out = [e for stream in streams for e in stream]
    out.sort(key=lambda e: e.timestamp)
    return out


def write_pb_trace(path: str, events) -> None:
    """Varint-delimited pb file — the PBTracer/reference format."""
    write_bytes_atomic(path, b"".join(write_delimited(evt)
                                      for evt in events))


def write_json_trace(path: str, events) -> None:
    """ndjson file — the JSONTracer/reference format."""
    write_text_atomic(path, "".join(
        json.dumps(proto_to_jsonable(evt)) + "\n" for evt in events))
