"""Minimal proto2 wire codec.

This framework is wire-compatible with the reference pubsub protocol
(go-libp2p-pubsub's schemas pb/rpc.proto and pb/trace.proto)
but does not depend on protoc or the protobuf runtime: messages are plain
Python dataclass-like objects whose serialization is driven by a per-class
``FIELDS`` table.  Only the subset of proto2 the pubsub wire format uses is
implemented: varint scalars (bool/uint64/int64/enum) and length-delimited
fields (bytes/string/embedded message), with ``optional`` and ``repeated``
labels.  Unknown fields are skipped on decode (forward compatibility, the same
behavior protobuf runtimes guarantee).

Design note: fields declared ``string`` in the reference schema that actually
carry arbitrary binary (message IDs — see the reference's own comment in
rpc.proto that "go protobuf emits invalid utf8 strings") are declared BYTES
here.  The wire encoding of string and bytes is identical (wire type 2), so
interop is unaffected and round-trips are lossless.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional, Union

WIRE_VARINT = 0
WIRE_I64 = 1
WIRE_LEN = 2
WIRE_I32 = 5

# Scalar kinds understood by the codec.
BYTES = "bytes"
STRING = "string"
BOOL = "bool"
UINT64 = "uint64"
INT64 = "int64"
ENUM = "enum"

_VARINT_KINDS = (BOOL, UINT64, INT64, ENUM)


def encode_uvarint(value: int) -> bytes:
    if value < 0:
        # proto2 int64: negative values are encoded as 10-byte two's complement.
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_uvarint(buf: Union[bytes, memoryview], pos: int = 0) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            if result >= 1 << 64:
                # matches Go binary.Uvarint overflow behavior
                raise ValueError("varint overflows 64 bits")
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


class Field:
    """One field of a proto2 message.

    kind: BYTES/STRING/BOOL/UINT64/INT64/ENUM or a Message subclass.
    """

    __slots__ = ("num", "name", "kind", "repeated")

    def __init__(self, num: int, name: str, kind: Any, repeated: bool = False):
        self.num = num
        self.name = name
        self.kind = kind
        self.repeated = repeated


class Message:
    """Base class for schema-driven proto2 messages.

    Subclasses define ``FIELDS: tuple[Field, ...]``.  Every field is stored as
    an instance attribute: ``None`` when unset (optional) or a list
    (repeated, default empty list).
    """

    FIELDS: tuple[Field, ...] = ()

    def __init__(self, **kwargs: Any):
        for f in self.FIELDS:
            if f.repeated:
                v = kwargs.pop(f.name, None)
                setattr(self, f.name, list(v) if v else [])
            else:
                setattr(self, f.name, kwargs.pop(f.name, None))
        if kwargs:
            raise TypeError(f"unknown fields for {type(self).__name__}: {sorted(kwargs)}")

    # -- encoding ---------------------------------------------------------

    def encode(self) -> bytes:
        out = bytearray()
        for f in self.FIELDS:
            v = getattr(self, f.name)
            if f.repeated:
                for item in v:
                    _encode_field(out, f, item)
            elif v is not None:
                _encode_field(out, f, v)
        return bytes(out)

    def byte_size(self) -> int:
        return len(self.encode())

    # -- decoding ---------------------------------------------------------

    @classmethod
    def decode(cls, data: Union[bytes, memoryview]):
        msg = cls()
        by_num = cls._field_index()
        buf = memoryview(data)
        pos = 0
        n = len(buf)
        while pos < n:
            tag, pos = decode_uvarint(buf, pos)
            num, wt = tag >> 3, tag & 7
            f = by_num.get(num)
            if f is None:
                pos = _skip_field(buf, pos, wt)
                continue
            val, pos = _decode_field(f, buf, pos, wt)
            if f.repeated:
                getattr(msg, f.name).append(val)
            elif (isinstance(f.kind, type) and issubclass(f.kind, Message)
                  and getattr(msg, f.name) is not None):
                # proto2: duplicate occurrences of a singular embedded
                # message merge rather than replace
                getattr(msg, f.name).merge_from(val)
            else:
                setattr(msg, f.name, val)
        return msg

    def merge_from(self, other: "Message") -> None:
        """Merge ``other`` into self with proto2 semantics: repeated fields
        concatenate, singular embedded messages merge recursively, set
        scalars replace."""
        for f in self.FIELDS:
            ov = getattr(other, f.name)
            if f.repeated:
                getattr(self, f.name).extend(ov)
            elif ov is not None:
                sv = getattr(self, f.name)
                if (sv is not None and isinstance(f.kind, type)
                        and issubclass(f.kind, Message)):
                    sv.merge_from(ov)
                else:
                    setattr(self, f.name, ov)

    _FIELD_INDEX_CACHE: dict[type, dict[int, Field]] = {}

    @classmethod
    def _field_index(cls) -> dict[int, Field]:
        idx = Message._FIELD_INDEX_CACHE.get(cls)
        if idx is None:
            idx = {f.num: f for f in cls.FIELDS}
            Message._FIELD_INDEX_CACHE[cls] = idx
        return idx

    # -- misc -------------------------------------------------------------

    def __eq__(self, other: Any) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        return all(getattr(self, f.name) == getattr(other, f.name) for f in self.FIELDS)

    def __repr__(self) -> str:
        parts = []
        for f in self.FIELDS:
            v = getattr(self, f.name)
            if v is None or (f.repeated and not v):
                continue
            parts.append(f"{f.name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


def _encode_field(out: bytearray, f: Field, v: Any) -> None:
    kind = f.kind
    if isinstance(kind, type) and issubclass(kind, Message):
        body = v.encode()
        out += encode_uvarint((f.num << 3) | WIRE_LEN)
        out += encode_uvarint(len(body))
        out += body
    elif kind is BYTES:
        if isinstance(v, str):  # tolerate str for bytes-declared wire strings
            v = v.encode("utf-8", "surrogateescape")
        out += encode_uvarint((f.num << 3) | WIRE_LEN)
        out += encode_uvarint(len(v))
        out += v
    elif kind is STRING:
        b = v.encode("utf-8", "surrogateescape") if isinstance(v, str) else bytes(v)
        out += encode_uvarint((f.num << 3) | WIRE_LEN)
        out += encode_uvarint(len(b))
        out += b
    elif kind is BOOL:
        out += encode_uvarint((f.num << 3) | WIRE_VARINT)
        out += b"\x01" if v else b"\x00"
    elif kind in (UINT64, INT64, ENUM):
        out += encode_uvarint((f.num << 3) | WIRE_VARINT)
        out += encode_uvarint(int(v))
    else:
        raise TypeError(f"unsupported field kind {kind!r}")


def _decode_field(f: Field, buf: memoryview, pos: int, wt: int) -> tuple[Any, int]:
    kind = f.kind
    if isinstance(kind, type) and issubclass(kind, Message):
        if wt != WIRE_LEN:
            raise ValueError(f"field {f.name}: expected length-delimited, got wire type {wt}")
        ln, pos = decode_uvarint(buf, pos)
        end = pos + ln
        if end > len(buf):
            raise ValueError(f"field {f.name}: truncated message")
        return kind.decode(buf[pos:end]), end
    if kind in (BYTES, STRING):
        if wt != WIRE_LEN:
            raise ValueError(f"field {f.name}: expected length-delimited, got wire type {wt}")
        ln, pos = decode_uvarint(buf, pos)
        end = pos + ln
        if end > len(buf):
            raise ValueError(f"field {f.name}: truncated bytes")
        raw = bytes(buf[pos:end])
        if kind is STRING:
            return raw.decode("utf-8", "surrogateescape"), end
        return raw, end
    if kind in _VARINT_KINDS:
        if wt != WIRE_VARINT:
            raise ValueError(f"field {f.name}: expected varint, got wire type {wt}")
        v, pos = decode_uvarint(buf, pos)
        if kind is BOOL:
            return bool(v), pos
        if kind is INT64 and v >= 1 << 63:
            v -= 1 << 64
        return v, pos
    raise TypeError(f"unsupported field kind {kind!r}")


def _skip_field(buf: memoryview, pos: int, wt: int) -> int:
    if wt == WIRE_VARINT:
        _, pos = decode_uvarint(buf, pos)
        return pos
    elif wt == WIRE_I64:
        pos += 8
    elif wt == WIRE_LEN:
        ln, pos = decode_uvarint(buf, pos)
        pos += ln
    elif wt == WIRE_I32:
        pos += 4
    else:
        raise ValueError(f"cannot skip wire type {wt}")
    if pos > len(buf):
        raise ValueError("truncated unknown field")
    return pos


# -- varint-delimited framing (go-msgio/protoio compatible) ----------------


def write_delimited(msg: Message) -> bytes:
    """Frame a message the way the reference streams RPCs.

    The reference writes each RPC as uvarint(length) || body
    (protoio delimited writer, go-libp2p-pubsub comm.go).
    """
    body = msg.encode()
    return encode_uvarint(len(body)) + body


def read_delimited(cls: type, buf: Union[bytes, memoryview], pos: int = 0,
                   max_size: Optional[int] = None) -> tuple[Any, int]:
    ln, pos = decode_uvarint(buf, pos)
    if max_size is not None and ln > max_size:
        raise ValueError(f"delimited message of {ln} bytes exceeds max {max_size}")
    end = pos + ln
    if end > len(buf):
        raise ValueError("truncated delimited message")
    return cls.decode(memoryview(buf)[pos:end]), end


def iter_delimited(cls: type, buf: Union[bytes, memoryview]) -> Iterator[Any]:
    pos = 0
    n = len(buf)
    while pos < n:
        msg, pos = read_delimited(cls, buf, pos)
        yield msg
