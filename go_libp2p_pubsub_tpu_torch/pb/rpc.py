"""Pubsub RPC wire schema.

Field numbers and structure mirror the reference wire contract
(go-libp2p-pubsub's pb/rpc.proto) so frames interoperate byte-for-byte with
the Go implementation.  Message IDs are declared BYTES (wire-identical to the
reference's string fields; see pb/proto.py module docstring).
"""

from __future__ import annotations

from .proto import BOOL, BYTES, STRING, UINT64, Field, Message


class SubOpts(Message):
    FIELDS = (
        Field(1, "subscribe", BOOL),
        Field(2, "topicid", STRING),
    )


class PubMessage(Message):
    """A published message (reference pb/rpc.proto ``Message``, fields 1-6)."""

    FIELDS = (
        Field(1, "from_peer", BYTES),   # `from` is a Python keyword
        Field(2, "data", BYTES),
        Field(3, "seqno", BYTES),
        Field(4, "topic", STRING),
        Field(5, "signature", BYTES),
        Field(6, "key", BYTES),
    )


class CompatMessage(Message):
    """Old multi-topic message (reference compat/compat.proto:5-12).

    Field 4 is ``repeated string topicIDs`` — wire-compatible with the new
    single ``topic`` field (same tag), used by compatibility tests.
    """

    FIELDS = (
        Field(1, "from_peer", BYTES),
        Field(2, "data", BYTES),
        Field(3, "seqno", BYTES),
        Field(4, "topic_ids", STRING, repeated=True),
        Field(5, "signature", BYTES),
        Field(6, "key", BYTES),
    )


class ControlIHave(Message):
    FIELDS = (
        Field(1, "topic_id", STRING),
        Field(2, "message_ids", BYTES, repeated=True),
    )


class ControlIWant(Message):
    FIELDS = (
        Field(1, "message_ids", BYTES, repeated=True),
    )


class ControlGraft(Message):
    FIELDS = (
        Field(1, "topic_id", STRING),
    )


class PeerInfo(Message):
    FIELDS = (
        Field(1, "peer_id", BYTES),
        Field(2, "signed_peer_record", BYTES),
    )


class ControlPrune(Message):
    FIELDS = (
        Field(1, "topic_id", STRING),
        Field(2, "peers", PeerInfo, repeated=True),
        Field(3, "backoff", UINT64),
    )


class ControlMessage(Message):
    FIELDS = (
        Field(1, "ihave", ControlIHave, repeated=True),
        Field(2, "iwant", ControlIWant, repeated=True),
        Field(3, "graft", ControlGraft, repeated=True),
        Field(4, "prune", ControlPrune, repeated=True),
    )

    def is_empty(self) -> bool:
        return not (self.ihave or self.iwant or self.graft or self.prune)


class RPC(Message):
    FIELDS = (
        Field(1, "subscriptions", SubOpts, repeated=True),
        Field(2, "publish", PubMessage, repeated=True),
        Field(3, "control", ControlMessage),
    )
