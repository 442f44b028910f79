"""Checkpoint/resume of simulation state, in the JAX package's file format.

The port's copy of the reference's ``utils/checkpoint.py``.  A state is
saved mid-run, restored and continued bit-identically: mesh, backoffs,
score counters, possession, delivery records, everything.  One snapshot
format serves both packages, leaf for leaf:

- keys are the reference's tree paths (``mesh``, ``scores/
  first_deliveries``, ``gates/0``, ``key``, ``tick``), in its leaf order;
- the words the port holds as int32 are written as uint32; the run seed
  (``salt``) as the reference's PRNG key ``[0, salt]``; the host tick as
  an int32 leaf (a replica stack: key ``[B, 2]``, tick ``[B]``);
- bf16 leaves are stored as their bit patterns under
  ``bits:bfloat16:<key>``, every other leaf under ``raw::<key>``.

No ``ml_dtypes``: on the host a bf16 leaf is its uint16 bit pattern, and
no leaf of these states is uint16 otherwise, so a uint16 array here always
means bf16.  Restore needs a template state (the same ``make_*_sim``
call's), whose structure, dtypes and device it takes.

    save_state(path, state)          one .npz, atomic rename
    load_state(path, template)       the state in the template's structure
    load_legacy_gossip_state(...)    a pre-gate-pipeline snapshot migrated
"""

from __future__ import annotations

import dataclasses
import io
import os

import numpy as np
import torch

from ..models import plan
from ..models.floodsub import FloodState
from ..models.gossipsub import GossipState
from ..models.randomsub import RandomSubState
from ..models.telemetry import TelemetryFrame

__all__ = ["save_state", "load_state", "load_legacy_gossip_state",
           "host_leaves", "leaf_meta", "rebuild", "encode_npz",
           "decode_npz", "dtname"]

_META_GATES_FP = "meta!gates_fp"   # '!' can't collide with tree keys

#: the reference's leaf order of each state (its dataclass field order)
GOSSIP_ORDER = ("mesh", "fanout", "last_pub", "backoff", "have", "recent",
                "first_tick", "scores", "key", "tick", "iwant_serves",
                "mesh_b", "backoff_b", "active", "gates", "inv_viol",
                "inv_first", "pay_line", "ctrl_line", "gsp_line",
                "adv_line", "probe_line")
SCORES_ORDER = ("time_in_mesh", "first_deliveries", "mesh_deliveries",
                "mesh_failure_penalty", "invalid_deliveries",
                "behaviour_penalty", "time_in_mesh_b")
FLOOD_ORDER = ("have", "first_tick", "tick", "inv_viol", "inv_first",
               "src_ring")
RANDOMSUB_ORDER = ("have", "fresh", "first_tick", "key", "tick", "inv_viol",
                   "inv_first", "src_ring")
#: the leaves the port holds as int32 and the reference as uint32
GOSSIP_WORDS = ("mesh", "fanout", "have", "recent", "active", "mesh_b",
                "pay_line", "ctrl_line", "gsp_line", "adv_line",
                "probe_line", "inv_viol")
MESHLESS_WORDS = ("have", "fresh", "src_ring", "inv_viol")

_NP = {torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
       torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
       torch.float32: "float32", torch.float64: "float64",
       torch.bfloat16: "bfloat16"}


def dtname(arr: np.ndarray) -> str:
    """The logical dtype of a host leaf: uint16 arrays are bf16 bits."""
    return "bfloat16" if arr.dtype == np.uint16 else arr.dtype.name


# --------------------------------------------------------------------------
# Walking the port's trees in the reference's leaf order
# --------------------------------------------------------------------------


def _walk(tree, prefix: str) -> list[tuple[str, tuple, object, str]]:
    """``[(key, path, value, kind)]``: each leaf's snapshot key, its
    attribute path in ``tree``, its value and how it crosses (``word``:
    int32 held, uint32 written; ``plain``; ``key``: the salt; ``tick``:
    the host tick).  None leaves are left out, as the reference's tree
    flattening leaves them out."""
    def k(name):
        return f"{prefix}/{name}" if prefix else name

    out = []
    if isinstance(tree, torch.Tensor):
        return [(prefix, (), tree, "plain")]
    if isinstance(tree, GossipState):
        for name in GOSSIP_ORDER:
            if name == "scores":
                if tree.scores is not None:
                    for s in SCORES_ORDER:
                        v = getattr(tree.scores, s)
                        if v is not None:
                            out.append((k(f"scores/{s}"), ("scores", s), v,
                                        "plain"))
            elif name == "gates":
                out += [(k(f"gates/{i}"), ("gates", i), g, "word")
                        for i, g in enumerate(tree.gates)]
            elif name == "key":
                out.append((k("key"), ("salt",), tree.salt, "key"))
            elif name == "tick":
                out.append((k("tick"), ("tick",), tree.tick, "tick"))
            else:
                v = getattr(tree, name)
                if v is not None:
                    out.append((k(name), (name,), v,
                                "word" if name in GOSSIP_WORDS else "plain"))
        return out
    if isinstance(tree, (FloodState, RandomSubState)):
        order = FLOOD_ORDER if isinstance(tree, FloodState) \
            else RANDOMSUB_ORDER
        for name in order:
            if name == "key":
                out.append((k("key"), ("salt",), tree.salt, "key"))
            elif name == "tick":
                out.append((k("tick"), ("tick",), tree.tick, "tick"))
            else:
                v = getattr(tree, name)
                if v is not None:
                    out.append((k(name), (name,), v,
                                "word" if name in MESHLESS_WORDS
                                else "plain"))
        return out
    if isinstance(tree, TelemetryFrame):
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if v is not None:
                out.append((k(f.name), (f.name,), v, "plain"))
        return out
    raise TypeError(f"no snapshot layout for a {type(tree).__name__}")


def _replicas(tree) -> int | None:
    """A stack's replica count (its salt a [B] tensor), else None."""
    salt = getattr(tree, "salt", None)
    return int(salt.shape[0]) if isinstance(salt, torch.Tensor) else None


def _one_copy(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The tensors on the host through ONE device-to-host copy (their
    bytes packed on the device first); on the CPU, fresh copies."""
    if not tensors:
        return []
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8)
            for t in tensors]
    parts, starts, at = [], [], 0
    for f in flat:
        starts.append(at)
        parts.append(f)
        pad = -f.numel() % 8     # every piece starts 8-byte aligned
        if pad:
            parts.append(f.new_zeros(pad))
        at += f.numel() + pad
    packed = torch.cat(parts).cpu()
    return [packed[a:a + f.numel()].view(t.dtype).reshape(t.shape)
            for t, f, a in zip(tensors, flat, starts)]


def _host_array(t: torch.Tensor, kind: str) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    a = t.numpy()
    return a.view(np.uint32) if kind == "word" else a


def host_leaves(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """``{key: host array}`` of a port state, frame stack or bare tensor,
    in the reference's keys, order and dtypes; every device tensor comes
    across in one copy."""
    leaves = _walk(tree, prefix)
    b = _replicas(tree)
    tensors = [v for _, _, v, _ in leaves if isinstance(v, torch.Tensor)]
    host = iter(_one_copy(tensors))
    out = {}
    for key, _, v, kind in leaves:
        if kind == "key":
            salt = (next(host).numpy().astype(np.uint32)
                    if isinstance(v, torch.Tensor)
                    else np.uint32(int(v) & 0xFFFFFFFF))
            out[key] = np.stack([np.zeros_like(salt), salt], -1)
        elif kind == "tick":
            out[key] = (np.int32(v) if b is None
                        else np.full(b, v, dtype=np.int32))
        else:
            out[key] = _host_array(next(host), kind)
    return out


def leaf_meta(tree, prefix: str = "") -> dict[str, tuple[tuple, str]]:
    """``{key: (shape, dtype name)}`` of what ``host_leaves`` would give,
    read from the tensors' metadata (nothing is copied)."""
    b = _replicas(tree)
    out = {}
    for key, _, v, kind in _walk(tree, prefix):
        if kind == "key":
            out[key] = (((2,) if b is None else (b, 2)), "uint32")
        elif kind == "tick":
            out[key] = ((() if b is None else (b,)), "int32")
        else:
            out[key] = (tuple(v.shape),
                        "uint32" if kind == "word" else _NP[v.dtype])
    return out


def _to_value(arr: np.ndarray, like, kind: str):
    """A host leaf (already in the template's dtype) as the template
    leaf's kind of value on its device."""
    if kind == "key":
        salt = np.asarray(arr).astype(np.uint32)[..., -1]
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(salt.astype(np.int64)).to(like.device)
        return int(salt)
    if kind == "tick":
        tick = np.asarray(arr).reshape(-1)
        if (tick != tick[0]).any():
            plan.refuse("batched_ticks")
        return int(tick[0])
    a = np.array(arr)      # a writable copy: torch keeps no view of it
    if kind == "word":
        a = a.view(np.int32)
    if like.dtype == torch.bfloat16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(like.device)


def rebuild(template, by_key: dict[str, np.ndarray], prefix: str = ""):
    """``template``'s structure with every leaf taken from ``by_key``
    (keys as ``host_leaves`` gives them, arrays in the template's dtypes,
    bf16 as its bits), on the template's device; non-leaf fields
    (``gates_fp``, a stack's static config) from the template."""
    if isinstance(template, torch.Tensor):
        return _to_value(by_key[prefix], template, "plain")
    kw, gates, scores = {}, {}, {}
    for key, path, v, kind in _walk(template, prefix):
        val = _to_value(by_key[key], v, kind)
        if path[0] == "gates":
            gates[path[1]] = val
        elif path[0] == "scores":
            scores[path[1]] = val
        else:
            kw[path[0]] = val
    if gates:
        kw["gates"] = tuple(gates[i] for i in range(len(template.gates)))
    if scores:
        kw["scores"] = dataclasses.replace(template.scores, **scores)
    return dataclasses.replace(template, **kw)


# --------------------------------------------------------------------------
# The npz encoding and exact widening
# --------------------------------------------------------------------------


def encode_npz(by_key: dict[str, np.ndarray]) -> memoryview:
    """``{key: array}`` -> the npz bytes (a view of the buffer, not a
    copy): bf16 (uint16 here) as ``bits:bfloat16:key``, the rest as
    ``raw::key``."""
    enc = {}
    for k, arr in by_key.items():
        if arr.dtype == np.uint16:
            enc["bits:bfloat16:" + k] = arr
        else:
            enc["raw::" + k] = arr
    buf = io.BytesIO()
    np.savez(buf, **enc)
    return buf.getbuffer()


def decode_npz(src) -> dict[str, np.ndarray]:
    """npz (a path or a file object) -> ``{key: array}``, bf16 as its bits.
    The single home of the ``bits:dtype:key`` / ``raw::key`` knowledge."""
    with np.load(src) as z:
        by_key = {}
        for full in z.files:
            tag, dt, k = full.split(":", 2)
            arr = z[full]
            if tag == "bits":
                if dt != "bfloat16" or arr.dtype.itemsize != 2:
                    raise ValueError(f"leaf {k!r}: stored dtype {dt!r} is "
                                     "not one the port reads (bfloat16)")
                arr = arr.view(np.uint16)
            elif tag != "raw":
                raise ValueError(f"leaf {k!r}: unknown encoding {tag!r}")
            by_key[k] = arr
    return by_key


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _widen_exact(arr: np.ndarray, want: str, k: str,
                 what: str = "checkpoint") -> np.ndarray:
    """Allow exact-value widening (old snapshots stored behaviour_penalty
    in bf16 before it moved to f32); any lossy conversion errors.  bf16
    is its uint16 bits on both sides."""
    have = dtname(arr)
    if have == want:
        return arr
    vals = _bf16_to_f32(arr) if have == "bfloat16" else arr
    if want == "bfloat16":
        f = vals.astype(np.float32)
        out = (f.view(np.uint32) >> 16).astype(np.uint16)
        back = _bf16_to_f32(out)
        ok = np.array_equal(back, f, equal_nan=True) and np.array_equal(
            back.astype(vals.dtype), vals, equal_nan=vals.dtype.kind in "fc")
    else:
        out = vals.astype(np.dtype(want))
        back = out.astype(vals.dtype)
        ok = np.array_equal(back, vals, equal_nan=vals.dtype.kind in "fc")
        if ok and have == "bfloat16":
            ok = np.array_equal(out.astype(np.float32), vals, equal_nan=True)
    if not ok:
        raise ValueError(
            f"leaf {k!r}: {what} dtype {have} does not widen "
            f"losslessly to template {want}")
    return out


# --------------------------------------------------------------------------
# save / load
# --------------------------------------------------------------------------


def save_state(path: str, state) -> None:
    """Write a state snapshot to ``path`` (.npz, atomic rename)."""
    by_key = host_leaves(state)
    # the gates' config fingerprint is not a leaf but must survive the
    # round trip: the restored gate words would otherwise be re-tagged with
    # a same-shape template's fingerprint and pass the step's guard
    fp = getattr(state, "gates_fp", None)
    if fp is not None:
        by_key[_META_GATES_FP] = np.int64(fp)
    payload = encode_npz(by_key)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)


def _legacy_fixups(by_key: dict, meta: dict, what: str) -> None:
    """The reference's migrations, in place: an absent ``iwant_serves``
    (scored snapshots from before the serve ledger was always on) starts
    at zero; all-zero P3/P3b leaves a template without them lacks are
    dropped; an int32 absolute-expiry backoff is refused by name."""
    if "iwant_serves" in meta and "iwant_serves" not in by_key:
        shape, _ = meta["iwant_serves"]
        by_key["iwant_serves"] = np.zeros(shape, dtype=np.int16)
    for k in [k for k in by_key if k not in meta]:
        if (k.endswith(("mesh_deliveries", "mesh_failure_penalty"))
                and not np.any(by_key[k])):
            del by_key[k]
    if what == "checkpoint":
        for k, (_, want) in meta.items():
            if (k.split("/")[-1].startswith("backoff") and k in by_key
                    and by_key[k].dtype == np.int32 and want == "int16"):
                raise ValueError(
                    f"leaf {k!r}: int32 absolute-expiry backoff from a "
                    "pre-gate-pipeline snapshot cannot be loaded as int16 "
                    "remaining ticks — migrate with "
                    "utils.checkpoint.load_legacy_gossip_state")


def load_state(path: str, template):
    """Read a snapshot into the structure of ``template`` (the state
    returned by the same make_*_sim call that produced the original), on
    the template's device."""
    by_key = decode_npz(path)
    snap_fp = by_key.pop(_META_GATES_FP, None)
    tmpl_fp = getattr(template, "gates_fp", None)
    if (snap_fp is not None and tmpl_fp is not None
            and int(snap_fp) != int(tmpl_fp)):
        raise ValueError(
            "snapshot's carried gates were emitted under a different "
            "(cfg, score_cfg) than the template's — restore with the "
            "original config, or refresh_gates after loading into a "
            "template whose gates_fp you explicitly cleared")
    meta = leaf_meta(template)
    if (any(k.startswith("gates") for k in meta)
            and not any(k.startswith("gates") for k in by_key)):
        raise ValueError(
            "snapshot predates the gate-pipeline format (no "
            "carried gate words, backoff stored as absolute "
            "expiry ticks) — migrate it with "
            "utils.checkpoint.load_legacy_gossip_state(path, "
            "template, cfg, score_cfg, params)")
    _legacy_fixups(by_key, meta, "checkpoint")
    out = {}
    for k, (shape, want) in meta.items():
        if k not in by_key:
            raise ValueError(f"checkpoint missing leaf {k!r}")
        arr = by_key[k]
        if arr.shape != shape:
            raise ValueError(
                f"leaf {k!r}: checkpoint {dtname(arr)}{arr.shape} vs "
                f"template {want}{shape}")
        out[k] = _widen_exact(arr, want, k)
    extra = set(by_key) - set(meta)
    if extra:
        raise ValueError(
            f"checkpoint has leaves the template lacks: {sorted(extra)[:4]}"
            " — wrong sim configuration?")
    return rebuild(template, out)


def load_legacy_gossip_state(path: str, template, cfg, score_cfg, params):
    """Migrate a pre-gate-pipeline gossip snapshot: int32 absolute-expiry
    backoff becomes int16 remaining ticks (relative to the snapshot's own
    tick), and the gate words the old format never stored are emitted
    by ``refresh_gates`` under the given config.  ``template``, ``cfg``,
    ``score_cfg`` and ``params`` are those of the ``make_gossip_sim``
    call that would restore a current-format snapshot."""
    from ..models.gossipsub import refresh_gates

    by_key = decode_npz(path)
    by_key.pop(_META_GATES_FP, None)    # pre-pipeline: absent anyway
    tick = int(by_key["tick"])
    meta = leaf_meta(template)
    _legacy_fixups(by_key, meta, "legacy")
    out = {}
    for k, (shape, want) in meta.items():
        if k.startswith("gates"):
            continue                    # re-emitted below
        if k not in by_key:
            raise ValueError(f"legacy checkpoint missing leaf {k!r}")
        arr = by_key[k]
        if (k.split("/")[-1].startswith("backoff")
                and arr.dtype == np.int32 and want == "int16"):
            arr = np.minimum(np.maximum(arr - tick, 0),
                             np.iinfo(np.int16).max).astype(np.int16)
        else:
            arr = _widen_exact(arr, want, k, what="legacy")
        if arr.shape != shape:
            raise ValueError(
                f"leaf {k!r}: legacy {dtname(arr)}{arr.shape} vs "
                f"template {want}{shape}")
        out[k] = arr
    extra = set(by_key) - set(meta)
    if extra:
        raise ValueError(
            f"legacy checkpoint has leaves the template lacks: "
            f"{sorted(extra)[:4]} — wrong sim configuration?")
    for k, (shape, _) in meta.items():
        if k.startswith("gates"):
            out[k] = np.zeros(shape, dtype=np.uint32)   # placeholders
    state = rebuild(template, out)
    return refresh_gates(cfg, score_cfg, params, state)
