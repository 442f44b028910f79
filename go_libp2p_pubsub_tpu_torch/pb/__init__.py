"""Wire format layer: the port's copies of the JAX package's proto2 codec
(``proto.py``) and RPC schema (``rpc.py``).  The telemetry layer measures
its wire-size constants from these encodings (``models/telemetry.py``
``wire_sizes``)."""

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
