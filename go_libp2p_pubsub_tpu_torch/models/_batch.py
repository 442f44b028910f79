"""Replica batching: B builds of one static config stacked on a leading
replica axis, advanced by ONE step a tick.

Counterpart of ``go_libp2p_pubsub_tpu/models/_batch.py``.  The reference
stacks its pytrees and vmaps its step; here ``stack_trees`` stacks the
port's dataclasses leaf by leaf (every tensor gains a leading ``[B]``
axis, the layout the reference's stacked trees have, so ``index_trees``
is a view and ``convert`` compares leaf for leaf) and the step reads a
stacked ``(params, state)`` as it reads one sim, the peer axis innermost:
B1 and B3 each launch once for the whole stack (``ops/kernels``).

What the port keeps on the host, per sim, becomes per replica:

- ``GossipState.salt`` and ``FaultParams.seed`` (host ints of one sim)
  stack to int64 ``[B]`` tensors of their u32 values, so every lane
  seed of the step is a ``[B]`` tensor;
- the tick stays ONE host int: the batch moves in lockstep, and states
  at different ticks raise the named refusal ``batched_ticks`` (the
  reference carries the tick as a ``[B]`` leaf; every batched run of it
  starts its replicas at tick 0 together);
- a delay-armed stack's ``DelayParams`` leaves (``base``, ``jitter``,
  ``seed``) stack to [B] like any tensor leaf, and its K-slot lines to
  ``[B, K, ...]`` (``index_trees`` gives one sim's ``[K, ...]`` lines as
  views);
- every other host field (``gates_fp``, the static score weights, the
  fault schedule's flags and partition windows, the delay line depth) is
  static config: replicas that differ there raise a ``ValueError``
  naming the field, as a mismatched treedef does in the reference.

PyTorch has no buffer donation: the runners may update in place or
allocate, and ``tree_copy`` serves callers that reuse a state.
"""

from __future__ import annotations

import dataclasses

import torch

from . import plan

#: host ints of one sim that are per-replica data in a stack (stacked to
#: int64 [B] tensors of their u32 values)
REPLICA_SCALARS = ("salt", "seed")


def _is_tensor_tuple(v) -> bool:
    return isinstance(v, tuple) and bool(v) and all(
        isinstance(x, torch.Tensor) for x in v)


def _leaves(tree, path: str = ""):
    """{path: value} over a dataclass tree: tensors, host values, None;
    nested dataclasses by their dotted paths, tensor tuples by index."""
    out = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        p = f"{path}.{f.name}" if path else f.name
        if dataclasses.is_dataclass(v):
            out[p] = type(v)
            out.update(_leaves(v, p))
        elif _is_tensor_tuple(v):
            out[p] = len(v)
            out.update({f"{p}[{j}]": x for j, x in enumerate(v)})
        else:
            out[p] = v
    return out


def _describe_mismatch(i: int, ref_tree, tree) -> str | None:
    """The first field where replica ``i`` cannot stack onto replica 0
    (a leaf missing or extra, its shape, its dtype, a differing static
    field), or None: the reference's wording, by attribute path."""
    if type(ref_tree) is not type(tree):
        return (f"replica {i} is a {type(tree).__name__} but replica 0 "
                f"is a {type(ref_tree).__name__}")
    a, b = _leaves(ref_tree), _leaves(tree)
    for path in a:
        if path not in b:
            return (f"replica {i} is missing field {path!r} that replica "
                    "0 has (the replicas were built with different "
                    "options, so their structure differs)")
    for path in b:
        if path not in a:
            return (f"replica {i} has field {path!r} that replica 0 lacks "
                    "(the replicas were built with different options, so "
                    "their structure differs)")
    for path, va in a.items():
        vb = b[path]
        ta, tb = isinstance(va, torch.Tensor), isinstance(vb, torch.Tensor)
        if (va is None) != (vb is None) or ta != tb:
            which = "missing" if vb is None else "has"
            return (f"replica {i} {which} field {path!r} "
                    f"({'None' if vb is None else 'array'} vs "
                    f"{'None' if va is None else 'array'}: the replicas "
                    "were built with different options, so their "
                    "structure differs)")
        if ta:
            if tuple(va.shape) != tuple(vb.shape):
                return (f"replica {i} field {path!r} has shape "
                        f"{tuple(vb.shape)} but replica 0 has "
                        f"{tuple(va.shape)} (peer/message/fault table "
                        "sizes must match across the batch)")
            if va.dtype != vb.dtype:
                return (f"replica {i} field {path!r} has dtype {vb.dtype} "
                        f"but replica 0 has {va.dtype}")
            if va.device != vb.device:
                return (f"replica {i} field {path!r} is on {vb.device} "
                        f"but replica 0's is on {va.device}")
    for path, va in a.items():
        vb = b[path]
        name = path.rsplit(".", 1)[-1]
        if isinstance(va, torch.Tensor) or name in REPLICA_SCALARS:
            continue
        if name in ("part_start", "part_end") and va != vb:
            plan.refuse("batched_partitions", plan.REFUSALS[
                "batched_partitions"] + f" (replica {i}'s {path} is "
                f"{vb!r}, replica 0's {va!r})")
        if name == "tick" and va != vb:
            plan.refuse("batched_ticks", plan.REFUSALS["batched_ticks"]
                        + f" (replica {i} is at tick {vb}, replica 0 at "
                        f"{va})")
        if va != vb:
            return (f"replica {i} differs from replica 0 in static "
                    f"(non-array) config {path!r}: {vb!r} vs {va!r} (all "
                    "replicas of a batch share one step)")
    return None


def _stack(vals: list, name: str, device):
    v0 = vals[0]
    if v0 is None:
        return None
    if isinstance(v0, torch.Tensor):
        return torch.stack(vals)
    if dataclasses.is_dataclass(v0):
        return _stack_one(vals, device)
    if _is_tensor_tuple(v0):
        return tuple(torch.stack(xs) for xs in zip(*vals))
    if name in REPLICA_SCALARS and isinstance(v0, int):
        return torch.tensor([int(v) & 0xFFFFFFFF for v in vals],
                            dtype=torch.int64, device=device)
    return v0


def _stack_one(trees: list, device):
    out = {f.name: _stack([getattr(t, f.name) for t in trees], f.name,
                          device)
           for f in dataclasses.fields(trees[0])}
    return type(trees[0])(**out)


def _device(tree):
    for v in _leaves(tree).values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def stack_trees(trees):
    """Stack structurally identical trees (``GossipParams``,
    ``GossipState`` or any of their parts) leaf-wise on a new leading
    replica axis.  A replica that cannot share replica 0's step raises a
    ``ValueError`` naming the first offending field; states at different
    ticks raise ``batched_ticks``."""
    trees = list(trees)
    if not trees:
        raise ValueError("stack_trees needs at least one tree")
    for i, t in enumerate(trees[1:], start=1):
        msg = _describe_mismatch(i, trees[0], t)
        if msg is not None:
            raise ValueError(msg)
    return _stack_one(trees, _device(trees[0]))


def _index(v, name: str, i: int):
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        if name in REPLICA_SCALARS and v.dtype == torch.int64:
            return int(v[i]) & 0xFFFFFFFF
        return v[i]
    if dataclasses.is_dataclass(v):
        return index_trees(v, i)
    if _is_tensor_tuple(v):
        return tuple(x[i] for x in v)
    return v


def index_trees(tree, i: int):
    """Replica ``i`` of a stacked tree: every tensor leaf a view of its
    row, the per-replica scalars back as host ints."""
    return type(tree)(**{f.name: _index(getattr(tree, f.name), f.name, i)
                         for f in dataclasses.fields(tree)})


def tree_copy(tree):
    """Every tensor leaf of a tree copied into a fresh buffer (for a
    caller that runs the same state again)."""
    def cp(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if dataclasses.is_dataclass(v):
            return tree_copy(v)
        if _is_tensor_tuple(v):
            return tuple(x.clone() for x in v)
        return v
    return type(tree)(**{f.name: cp(getattr(tree, f.name))
                         for f in dataclasses.fields(tree)})


def is_stacked(state) -> bool:
    """Whether ``state`` (a GossipState) is a replica stack: its salt is
    a [B] tensor."""
    return isinstance(state.salt, torch.Tensor)
