"""Trace event wire schema: the port's copy of the JAX package's
``pb/trace.py``.

Mirrors go-libp2p-pubsub's trace contract (``pb/trace.proto``): 13 event
types plus an RPC-metadata mirror, over the port's proto2 codec
(``pb/proto.py``).  The simulator's exporter (``interop/export.py``)
writes these events in the reference tracer's two sink formats;
``proto_to_jsonable`` renders one for the ndjson sink.
"""

from __future__ import annotations

import base64

from .proto import BOOL, BYTES, ENUM, INT64, STRING, Field, Message


class TraceType:
    PUBLISH_MESSAGE = 0
    REJECT_MESSAGE = 1
    DUPLICATE_MESSAGE = 2
    DELIVER_MESSAGE = 3
    ADD_PEER = 4
    REMOVE_PEER = 5
    RECV_RPC = 6
    SEND_RPC = 7
    DROP_RPC = 8
    JOIN = 9
    LEAVE = 10
    GRAFT = 11
    PRUNE = 12

    NAMES = {
        0: "PUBLISH_MESSAGE", 1: "REJECT_MESSAGE", 2: "DUPLICATE_MESSAGE",
        3: "DELIVER_MESSAGE", 4: "ADD_PEER", 5: "REMOVE_PEER", 6: "RECV_RPC",
        7: "SEND_RPC", 8: "DROP_RPC", 9: "JOIN", 10: "LEAVE", 11: "GRAFT",
        12: "PRUNE",
    }


class PublishMessageEv(Message):
    FIELDS = (Field(1, "message_id", BYTES), Field(2, "topic", STRING))


class RejectMessageEv(Message):
    FIELDS = (
        Field(1, "message_id", BYTES),
        Field(2, "received_from", BYTES),
        Field(3, "reason", STRING),
        Field(4, "topic", STRING),
    )


class DuplicateMessageEv(Message):
    FIELDS = (
        Field(1, "message_id", BYTES),
        Field(2, "received_from", BYTES),
        Field(3, "topic", STRING),
    )


class DeliverMessageEv(Message):
    FIELDS = (
        Field(1, "message_id", BYTES),
        Field(2, "topic", STRING),
        Field(3, "received_from", BYTES),
    )


class AddPeerEv(Message):
    FIELDS = (Field(1, "peer_id", BYTES), Field(2, "proto", STRING))


class RemovePeerEv(Message):
    FIELDS = (Field(1, "peer_id", BYTES),)


class MessageMeta(Message):
    FIELDS = (Field(1, "message_id", BYTES), Field(2, "topic", STRING))


class SubMeta(Message):
    FIELDS = (Field(1, "subscribe", BOOL), Field(2, "topic", STRING))


class ControlIHaveMeta(Message):
    FIELDS = (Field(1, "topic", STRING), Field(2, "message_ids", BYTES, repeated=True))


class ControlIWantMeta(Message):
    FIELDS = (Field(1, "message_ids", BYTES, repeated=True),)


class ControlGraftMeta(Message):
    FIELDS = (Field(1, "topic", STRING),)


class ControlPruneMeta(Message):
    FIELDS = (Field(1, "topic", STRING), Field(2, "peers", BYTES, repeated=True))


class ControlMeta(Message):
    FIELDS = (
        Field(1, "ihave", ControlIHaveMeta, repeated=True),
        Field(2, "iwant", ControlIWantMeta, repeated=True),
        Field(3, "graft", ControlGraftMeta, repeated=True),
        Field(4, "prune", ControlPruneMeta, repeated=True),
    )


class RPCMeta(Message):
    FIELDS = (
        Field(1, "messages", MessageMeta, repeated=True),
        Field(2, "subscription", SubMeta, repeated=True),
        Field(3, "control", ControlMeta),
    )


class RecvRPCEv(Message):
    FIELDS = (Field(1, "received_from", BYTES), Field(2, "meta", RPCMeta))


class SendRPCEv(Message):
    FIELDS = (Field(1, "send_to", BYTES), Field(2, "meta", RPCMeta))


class DropRPCEv(Message):
    FIELDS = (Field(1, "send_to", BYTES), Field(2, "meta", RPCMeta))


class JoinEv(Message):
    FIELDS = (Field(1, "topic", STRING),)


class LeaveEv(Message):
    # Field number 2 matches the reference schema (trace.proto `Leave.topic = 2`).
    FIELDS = (Field(2, "topic", STRING),)


class GraftEv(Message):
    FIELDS = (Field(1, "peer_id", BYTES), Field(2, "topic", STRING))


class PruneEv(Message):
    FIELDS = (Field(1, "peer_id", BYTES), Field(2, "topic", STRING))


class TraceEvent(Message):
    FIELDS = (
        Field(1, "type", ENUM),
        Field(2, "peer_id", BYTES),
        Field(3, "timestamp", INT64),
        Field(4, "publish_message", PublishMessageEv),
        Field(5, "reject_message", RejectMessageEv),
        Field(6, "duplicate_message", DuplicateMessageEv),
        Field(7, "deliver_message", DeliverMessageEv),
        Field(8, "add_peer", AddPeerEv),
        Field(9, "remove_peer", RemovePeerEv),
        Field(10, "recv_rpc", RecvRPCEv),
        Field(11, "send_rpc", SendRPCEv),
        Field(12, "drop_rpc", DropRPCEv),
        Field(13, "join", JoinEv),
        Field(14, "leave", LeaveEv),
        Field(15, "graft", GraftEv),
        Field(16, "prune", PruneEv),
    )


class TraceEventBatch(Message):
    FIELDS = (Field(1, "batch", TraceEvent, repeated=True),)


def proto_to_jsonable(msg: Message):
    """A schema-driven proto message as JSON-compatible dicts (bytes ->
    base64, like protobuf's canonical JSON; unset and empty repeated
    fields left out) — the ndjson sink's rendering."""
    out = {}
    for f in msg.FIELDS:
        v = getattr(msg, f.name)
        if v is None or (f.repeated and not v):
            continue

        def render(x):
            if isinstance(x, Message):
                return proto_to_jsonable(x)
            if isinstance(x, (bytes, bytearray, memoryview)):
                return base64.b64encode(bytes(x)).decode("ascii")
            return x

        out[f.name] = [render(x) for x in v] if f.repeated else render(v)
    return out
