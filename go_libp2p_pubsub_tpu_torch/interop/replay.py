"""Reading a simulator-exported trace back: the trace-reading half of the
JAX package's ``interop/replay.py``, the port's own copy.

``load_pb_trace`` reads a varint-delimited pb file into TraceEvents;
``possession_from_trace`` and ``mesh_from_trace`` rebuild the
simulator's final possession and mesh from the event stream alone — the
equivalence oracle for the 13-type export.  The other half of the
reference module (its in-memory tracer and the runners that drive the
asyncio protocol core) waits with the protocol core.
"""

from __future__ import annotations

import numpy as np

from ..pb import trace as tr
from ..pb.proto import iter_delimited
from ..pb.trace import TraceType


def load_pb_trace(path: str) -> list:
    """Read a varint-delimited pb trace file (``export.write_pb_trace``,
    the PBTracer format) back into TraceEvent objects."""
    with open(path, "rb") as f:
        data = f.read()
    return list(iter_delimited(tr.TraceEvent, data))


def _sim_peer(peer_id: bytes) -> int:
    """Inverse of export.peer_id (b"sim-%d")."""
    return int(peer_id[4:])


def _sim_msg(message_id: bytes) -> int:
    """Inverse of export.msg_id (b"msg-%d")."""
    return int(message_id[4:])


def possession_from_trace(events, n_peers: int,
                          n_msgs: int) -> np.ndarray:
    """bool [N, M] possession replay from a sim-exported stream.

    A peer holds message m iff the stream shows it acquiring a copy:
    PUBLISH_MESSAGE (the origin's own copy), DELIVER_MESSAGE (a valid
    subscriber delivery), or REJECT_MESSAGE (a validation-failing
    acquisition — the sim's possession words include those; the router
    saw the bytes even though it rejected them).  DUPLICATE_MESSAGE
    copies are repeats by definition and add nothing.  Equals the
    simulator's final ``have`` words on fully-subscribed runs (pinned
    by tests/test_torch_trace_export.py)."""
    have = np.zeros((n_peers, n_msgs), dtype=bool)
    for ev in events:
        if ev.type == TraceType.PUBLISH_MESSAGE:
            have[_sim_peer(ev.peer_id),
                 _sim_msg(ev.publish_message.message_id)] = True
        elif ev.type == TraceType.DELIVER_MESSAGE:
            have[_sim_peer(ev.peer_id),
                 _sim_msg(ev.deliver_message.message_id)] = True
        elif ev.type == TraceType.REJECT_MESSAGE:
            have[_sim_peer(ev.peer_id),
                 _sim_msg(ev.reject_message.message_id)] = True
    return have


def mesh_from_trace(events, offsets, n_peers: int) -> np.ndarray:
    """uint32 [N] final mesh replay from the GRAFT/PRUNE stream: each
    GRAFT sets the grafting peer's candidate bit for the partner, each
    PRUNE clears it — exactly the mesh word the simulator ends with
    (pinned by tests/test_torch_trace_export.py)."""
    offs = tuple(int(o) for o in offsets)
    bit_of = {o % n_peers: c for c, o in enumerate(offs)}
    mesh = np.zeros(n_peers, dtype=np.uint32)
    for ev in events:
        if ev.type == TraceType.GRAFT:
            p = _sim_peer(ev.peer_id)
            q = _sim_peer(ev.graft.peer_id)
            mesh[p] |= np.uint32(1) << np.uint32(
                bit_of[(q - p) % n_peers])
        elif ev.type == TraceType.PRUNE:
            p = _sim_peer(ev.peer_id)
            q = _sim_peer(ev.prune.peer_id)
            mesh[p] &= ~(np.uint32(1) << np.uint32(
                bit_of[(q - p) % n_peers]))
    return mesh
