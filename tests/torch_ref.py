"""Reaching the JAX reference from the PyTorch port's tests.

Under jax 0.9 importing ``go_libp2p_pubsub_tpu.models.gossipsub`` raises
``TypeError`` in ``models/_batch.py`` (``in`` on the
``PrimitiveBatchersProxy``).  ``imported_reference`` swaps
``jax.interpreters.batching.primitive_batchers`` for a plain dict
during the import only, then restores it; on exit it also drops every
reference module it imported, so later tests import (or fail to import)
the JAX package exactly as they would without it.  Use it inside a
module-scoped fixture, never at import or collection time.

Data crosses between the packages as numpy arrays only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
from types import SimpleNamespace

import numpy as np

_PKG = "go_libp2p_pubsub_tpu"


@contextlib.contextmanager
def imported_reference():
    from jax.interpreters import batching

    before = set(sys.modules)
    import go_libp2p_pubsub_tpu.ops.graph as graph
    import go_libp2p_pubsub_tpu.ops.pallas.receive as receive
    import go_libp2p_pubsub_tpu.ops.pallas.select as select

    orig = batching.primitive_batchers
    batching.primitive_batchers = {}
    try:
        import go_libp2p_pubsub_tpu.models.gossipsub as gs
    finally:
        batching.primitive_batchers = orig
    try:
        yield SimpleNamespace(gs=gs, graph=graph, receive=receive,
                              select=select)
    finally:
        for name in sorted(set(sys.modules) - before, reverse=True):
            if name == _PKG or name.startswith(_PKG + "."):
                del sys.modules[name]
                parent, _, child = name.rpartition(".")
                if parent in sys.modules and hasattr(sys.modules[parent],
                                                     child):
                    delattr(sys.modules[parent], child)


def leaf_to_numpy(x):
    """A reference leaf as numpy: bf16 as its raw uint16 patterns."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


def tree_to_numpy(obj) -> dict:
    """A reference params/state dataclass as a dict of numpy leaves
    (nested dataclasses as dicts, tuples of arrays as lists)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or isinstance(v, (bool, int, float, str)):
            out[f.name] = v
        elif dataclasses.is_dataclass(v):
            out[f.name] = tree_to_numpy(v)
        elif isinstance(v, tuple) and v and hasattr(v[0], "shape"):
            out[f.name] = [leaf_to_numpy(g) for g in v]
        elif isinstance(v, tuple):
            out[f.name] = v
        else:
            out[f.name] = leaf_to_numpy(v)
    return out
