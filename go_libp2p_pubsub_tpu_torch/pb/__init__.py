"""Wire format layer: the port's copies of the JAX package's proto2 codec
(``proto.py``), RPC schema (``rpc.py``) and trace schema (``trace.py``).
The telemetry layer measures its wire-size constants from these encodings
(``models/telemetry.py`` ``wire_sizes``); the trace exporter
(``interop/export.py``) writes trace events in them."""

from .proto import (  # noqa: F401
    Field,
    Message,
    decode_uvarint,
    encode_uvarint,
    iter_delimited,
    read_delimited,
    write_delimited,
)
from .rpc import (  # noqa: F401
    RPC,
    CompatMessage,
    ControlGraft,
    ControlIHave,
    ControlIWant,
    ControlMessage,
    ControlPrune,
    PeerInfo,
    PubMessage,
    SubOpts,
)
from .trace import TraceEvent, TraceEventBatch, TraceType  # noqa: F401
