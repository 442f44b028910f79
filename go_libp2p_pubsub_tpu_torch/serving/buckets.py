"""Shape buckets for the multi-tenant scenario front end: the port's copy
of the JAX package's ``serving/buckets.py``.

A sweepd server steps ONE static shape.  The front end serves arbitrary
request shapes by quantizing each incoming ``(n, t, m, ticks, k_slots)``
into a bounded set of bucket specs (peer count, topics and messages round
UP to the next power of two, ticks to the next tick quantum) and routing
the request to its bucket's resident server.  Under a ``max_buckets`` cap
the least-recently-used bucket is evicted; the front end's registry of
bucket runners is process-global, so a re-created bucket of a shape this
process already ran adds no compile.

The AOT blob.  The reference serialises a bucket's batched dispatch with
``jax.export``; PyTorch keeps no executable to serialise (the step is
Python over eager tensors, the CUDA libraries are built once per source by
``ops/kernels/_build.py``).  ``export_bucket_runner`` writes the port's
own record of a bucket runner instead: the spec, the batch, the static
config fingerprint, the receive route ``plan.receive_path`` picks, the
kernel libraries that route launches with the content hash each is keyed
by, and the leaf layout (names, shapes, dtypes) of the padded reference
batch.  ``make_aot_runner`` checks every one of these against the loading
process and returns the batched dispatch, which then adds nothing to the
front end's compile count: what a cold start saves is the registry entry,
not a trace.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from collections import OrderedDict

import numpy as np
import torch

__all__ = [
    "BucketSpec", "BucketLRU", "quantize_shape",
    "bucket_fingerprint", "aot_blob_path", "export_bucket_runner",
    "make_aot_runner",
]

#: floors keep tiny requests from quantizing into degenerate sims
#: (the candidate ring and the residue-class topics need room)
MIN_PEERS = 64
MIN_TICKS = 4

#: the blob's format tag and version
AOT_FORMAT = "tpu-pubsub-torch-bucket-runner"
AOT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One resident runner's static shape (quantized)."""

    n: int
    t: int
    m: int
    ticks: int
    k_slots: int = 0

    def key(self) -> str:
        return (f"n{self.n}-t{self.t}-m{self.m}-ticks{self.ticks}"
                f"-k{self.k_slots}")


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def quantize_shape(n: int, t: int, m: int, ticks: int,
                   k_slots: int = 0, *,
                   tick_quantum: int = 8) -> BucketSpec:
    """Quantize a raw request shape into its bucket spec: n/t/m round up
    to the next power of two (n floored at MIN_PEERS), ticks to the next
    multiple of ``tick_quantum``, k_slots to the next power of two (0 = no
    delay line).  Quantizing UP only: a request never lands in a bucket
    smaller than itself, so padding is always possible and results are
    conservative (more peers, more ticks)."""
    for name, v in (("n", n), ("t", t), ("m", m), ("ticks", ticks)):
        if not isinstance(v, (int, np.integer)) or isinstance(v, bool) \
                or v <= 0:
            raise ValueError(
                f"shape: {name}={v!r} must be a positive integer")
    if not isinstance(k_slots, (int, np.integer)) or k_slots < 0:
        raise ValueError(f"shape: k_slots={k_slots!r} must be a "
                         "non-negative integer")
    q = max(1, int(tick_quantum))
    return BucketSpec(
        n=max(_next_pow2(n), MIN_PEERS),
        t=_next_pow2(t),
        m=_next_pow2(m),
        ticks=max(-(-int(ticks) // q) * q, MIN_TICKS),
        k_slots=_next_pow2(k_slots) if k_slots else 0)


class BucketLRU:
    """Bounded mapping of BucketSpec -> bucket entry with LRU eviction.
    ``get`` refreshes recency; ``put`` evicts (and returns) the
    least-recently-used entries past ``max_buckets``."""

    def __init__(self, max_buckets: int, metrics=None):
        if max_buckets < 1:
            raise ValueError(
                f"max_buckets={max_buckets} must be >= 1")
        self.max_buckets = max_buckets
        self._d: OrderedDict = OrderedDict()
        self.evictions = 0
        self._m_evict = self._m_resident = None
        if metrics is not None:
            self._m_evict = metrics.counter(
                "serving_bucket_evictions_total",
                "LRU bucket evictions")
            self._m_resident = metrics.gauge(
                "serving_buckets_resident", "resident shape buckets")

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, spec) -> bool:
        return spec in self._d

    def specs(self) -> list:
        return list(self._d)

    def get(self, spec):
        if spec not in self._d:
            return None
        self._d.move_to_end(spec)
        return self._d[spec]

    def put(self, spec, entry) -> list:
        """Insert (refreshing recency) and return the evicted ``(spec,
        entry)`` pairs: the caller owns their teardown."""
        self._d[spec] = entry
        self._d.move_to_end(spec)
        evicted = []
        while len(self._d) > self.max_buckets:
            evicted.append(self._d.popitem(last=False))
            self.evictions += 1
        if self._m_evict is not None:
            self._m_evict.set_total(self.evictions)
            self._m_resident.set(len(self._d))
        return evicted


# --------------------------------------------------------------------------
# AOT persistence (the port's record of a bucket runner)
# --------------------------------------------------------------------------


def bucket_fingerprint(spec: BucketSpec, server) -> int:
    """Blob cache key: the bucket spec + the server's static config
    fingerprint (config_fingerprint over cfg/sc: knob points and
    formations are data of the params and do NOT contribute)."""
    from ..parallel.checkpoint import config_fingerprint
    return zlib.crc32(
        spec.key().encode()
        + f"b{server.batch}".encode()
        + config_fingerprint(server.cfg, server.sc).to_bytes(
            8, "little", signed=True))


def aot_blob_path(aot_dir: str, spec: BucketSpec, server) -> str:
    return os.path.join(
        aot_dir,
        f"bucket-{spec.key()}-{bucket_fingerprint(spec, server):08x}"
        ".jaxexp")


def _reference_batch(server):
    """One padded reference batch at the server's shape, built as
    ``submit`` builds a batch (invariant attachment included)."""
    from ..models import gossipsub as gs
    from ..models import invariants as iv
    builds = [gs.make_gossip_sim(server.cfg, score_cfg=server.sc,
                                 device=server.device,
                                 **server._build_kwargs({}))
              for _ in range(server.batch)]
    states = [b[1] for b in builds]
    if server.invariants is not None:
        states = [iv.attach(s) for s in states]
    params = gs.stack_trees([b[0] for b in builds])
    state = gs.stack_trees(states)
    honest = np.ones((server.batch, server.n), dtype=bool)
    return params, state, honest


def _layout(tree, prefix: str = "") -> dict:
    """``{path: [shape, dtype]}`` of every tensor leaf of a params/state
    tree (dataclasses and tuples walked in field order; host scalars by
    type name)."""
    out = {}
    if isinstance(tree, torch.Tensor):
        out[prefix] = [list(tree.shape), str(tree.dtype).split(".")[-1]]
    elif isinstance(tree, np.ndarray):
        out[prefix] = [list(tree.shape), tree.dtype.name]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            out.update(_layout(getattr(tree, f.name),
                               f"{prefix}/{f.name}" if prefix else f.name))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_layout(v, f"{prefix}/{i}"))
    elif tree is not None:
        out[prefix] = [[], type(tree).__name__]
    return out


def _route_libraries(route: str) -> tuple[str, ...]:
    """The kernel libraries a batched dispatch on ``route`` launches: B3
    batched on every route; on the kernel route also B1's sources."""
    from ..models import plan
    from ..ops.kernels import receive as krecv
    if route == plan.KERNEL:
        return ("select", *krecv.SOURCES)
    return ("select",)


def _record(server) -> dict:
    """Everything the blob holds, read off ``server`` in this process."""
    from ..models import plan
    from ..ops.kernels import _build
    from ..parallel.checkpoint import config_fingerprint
    params, state, honest = _reference_batch(server)
    route = plan.receive_path(server.cfg, server.sc, params)
    return {
        "format": AOT_FORMAT, "version": AOT_VERSION,
        "spec": [server.n, server.t, server.m, server.ticks,
                 server.k_slots],
        "batch": server.batch,
        "fingerprint": config_fingerprint(server.cfg, server.sc),
        "route": route,
        "libraries": {name: _build.source_hash(name)
                      for name in _route_libraries(route)},
        "leaves": {"params": _layout(params), "state": _layout(state),
                   "honest": _layout(honest)},
    }


def export_bucket_runner(server) -> bytes:
    """The server's bucket-runner record as bytes (JSON): spec, batch,
    config fingerprint, route, kernel libraries with their content
    hashes, the reference batch's leaf layout."""
    return json.dumps(_record(server), sort_keys=True).encode()


def make_aot_runner(server, blob: bytes):
    """Check an ``export_bucket_runner`` blob against ``server`` in this
    process and return the batched dispatch, ``runner(params, state,
    honest) -> (state, reach)``.  Attach with ``server._aot_runner =
    runner``: it is ``gossip_run_knob_batch`` on the server's step, the
    same arithmetic as a traced bucket.  Raises ValueError naming the
    first field that differs (a stale or foreign blob)."""
    from ..models import gossipsub as gs
    try:
        got = json.loads(bytes(blob).decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"not a bucket-runner record ({e})") from None
    if not isinstance(got, dict) or got.get("format") != AOT_FORMAT:
        raise ValueError("not a bucket-runner record (format "
                         f"{got.get('format') if isinstance(got, dict) else None!r})")
    want = _record(server)
    for field in ("version", "spec", "batch", "fingerprint", "route",
                  "libraries", "leaves"):
        if got.get(field) != want[field]:
            raise ValueError(
                f"blob field {field!r} is {got.get(field)!r}, this "
                f"process has {want[field]!r}")
    ticks, step, dev = server.ticks, server.step, server.device

    def runner(params, state, honest):
        return gs.gossip_run_knob_batch(params, state, ticks, step, honest,
                                        device=dev)
    return runner
