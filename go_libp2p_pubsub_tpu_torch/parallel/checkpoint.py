"""Preemption-tolerant execution: segmented runners with checksummed
on-disk snapshots and kill-safe resume.

The port's copy of the JAX package's ``parallel/checkpoint.py``, in its
snapshot format, so a snapshot either package writes is read and resumed
by the other, leaf for leaf (``utils/checkpoint.py`` gives the keys, the
dtypes and the bf16 bit encoding).  The tick horizon splits into segments,
each one call of the unsegmented runner (``gossip_run``,
``gossip_run_fused``, ``gossip_run_batch``, ``telemetry_run``,
``flood_run``, ``randomsub_run`` and the curve runners), and the FULL
carry — possession words, per-edge counters, mesh and backoff, scores,
delay lines, the invariant carry, the salt and the tick — is snapshotted
between segments.  Splitting is exact (every tick-dependent quantity is
keyed off the tick, which rides in the carry), so a resumed run is
bit-identical to the uninterrupted one.

Snapshot format (one file per segment, ``<tag>-seg<NNNNNN>.ckpt``):

  line 1   JSON header: magic, version, config fingerprint
           (``config_fingerprint``), tick, ticks_done, segment index,
           segment length, layout (the devices the carry was on: 1),
           payload byte length, payload CRC32.
  rest     npz payload of the leaves (``state/...``, ``aux/...``).

Writes are atomic (tmp + ``os.replace``); corrupted, truncated,
non-snapshot, fingerprint-mismatched files, layout mismatches, a stale
horizon, a completed run with per-tick outputs and an unusable delta chain
are rejected by name on read, with the reference's messages.

Between segments the carry comes to the host in ONE device-to-host copy,
synchronously (the next segment may update the state in place); the
encode, CRC and write run on the host arrays, on a writer thread with
``async_write``, which never touches a device tensor.

Kill-safety: ``install_kill_handlers`` turns SIGTERM/SIGINT into a
deferred stop flag; the segment loop finishes the segment in flight,
flushes its snapshot and raises ``CheckpointInterrupt``.

The journal codec (``journal_encode_line`` and friends) is the sweep
server's: each accepted scenario line carries a CRC32 suffix, so a line
torn by a kill is dropped on replay, not served as bad JSON.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import re
import signal
import threading
import zlib

import numpy as np
import torch

from ..device import check_on, resolve_device
from ..models import plan
from ..utils.checkpoint import (
    _widen_exact,
    decode_npz,
    dtname,
    encode_npz,
    host_leaves,
    leaf_meta,
    rebuild,
)

__all__ = [
    "MAGIC", "FORMAT_VERSION", "CheckpointConfig", "CheckpointInterrupt",
    "config_fingerprint", "snapshot_save", "snapshot_read",
    "latest_snapshot", "install_kill_handlers", "request_stop",
    "stop_requested", "clear_stop", "read_snapshot_chain",
    "journal_encode_line", "journal_decode_line", "read_journal",
    "ckpt_gossip_run", "ckpt_gossip_run_curve", "ckpt_gossip_run_fused",
    "ckpt_gossip_run_knob_batch", "ckpt_telemetry_run",
    "ckpt_flood_run", "ckpt_flood_run_curve",
    "ckpt_randomsub_run", "ckpt_randomsub_run_curve",
    "ckpt_sharded_gossip_run", "ckpt_sharded_gossip_run_fused",
    "ckpt_sharded_gossip_run_knob_batch", "segment_dispatch",
]

MAGIC = "tpu-pubsub-ckpt"
FORMAT_VERSION = 1

_SEG_RE = re.compile(r"-seg(\d{6})\.ckpt$")
_TAG_RE = re.compile(r"^[A-Za-z0-9_.-]+$")


# --------------------------------------------------------------------------
# Config
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Host-side checkpoint spec for the segmented runners.

    directory: snapshot directory (created on first save); a valid
        snapshot found here resumes the run from its tick.
    every: segment length in ticks; 0 = one segment spanning the horizon.
        It never changes a tick's arithmetic.
    keep: how many most-recent snapshots to retain.
    fingerprint: stored in every header and required to match on resume
        (``config_fingerprint(cfg, score_cfg)``).
    tag: snapshot filename prefix.
    async_write: overlap segment k's encode, CRC and write with segment
        k+1 (the device-to-host copy stays synchronous).
    full_every: a full snapshot every Kth boundary and deltas between.
    """

    directory: str
    every: int = 0
    keep: int = 2
    fingerprint: int = 0
    tag: str = "sim"
    async_write: bool = False
    full_every: int = 1

    def __post_init__(self):
        if not self.directory:
            raise ValueError(
                "CheckpointConfig: directory must be a non-empty path "
                "(snapshots need somewhere to live)")
        if int(self.every) < 0:
            raise ValueError(
                f"CheckpointConfig: every={self.every} must be >= 0 "
                "(segment length in ticks; 0 = single segment)")
        if int(self.keep) < 1:
            raise ValueError(
                f"CheckpointConfig: keep={self.keep} must be >= 1 "
                "(resume needs at least the latest snapshot)")
        if not _TAG_RE.match(self.tag):
            raise ValueError(
                f"CheckpointConfig: tag={self.tag!r} must match "
                "[A-Za-z0-9_.-]+ (it is a filename prefix)")
        if not isinstance(self.async_write, bool):
            raise ValueError(
                f"CheckpointConfig: async_write={self.async_write!r} "
                "must be a bool (host-side writer mode, never traced)")
        if int(self.full_every) < 1:
            raise ValueError(
                f"CheckpointConfig: full_every={self.full_every} must "
                "be >= 1 (1 = every snapshot full; K > 1 = deltas "
                "between every Kth full)")


class CheckpointInterrupt(RuntimeError):
    """A SIGTERM/SIGINT arrived mid-run: the segment in flight was
    finished and its snapshot flushed to ``path``.  Re-running the same
    call resumes from it."""

    def __init__(self, path: str, ticks_done: int, n_ticks: int):
        super().__init__(
            f"interrupted after {ticks_done}/{n_ticks} ticks; "
            f"snapshot flushed to {path}")
        self.path = path
        self.ticks_done = ticks_done
        self.n_ticks = n_ticks


# --------------------------------------------------------------------------
# Deferred signal handling
# --------------------------------------------------------------------------

_STOP = {"requested": False}


def request_stop(signum=None, frame=None) -> None:
    """Signal-handler body: defer the stop to the next segment boundary
    (never interrupts a device computation mid-flight)."""
    _STOP["requested"] = True


def stop_requested() -> bool:
    return _STOP["requested"]


def clear_stop() -> None:
    _STOP["requested"] = False


def install_kill_handlers():
    """Install the deferred SIGTERM/SIGINT handlers process-wide (main
    thread only — a no-op elsewhere, signal.signal would raise).
    Returns the list of (signum, previous_handler) pairs installed."""
    if threading.current_thread() is not threading.main_thread():
        return []
    prev = []
    for sig in (signal.SIGTERM, signal.SIGINT):
        prev.append((sig, signal.signal(sig, request_stop)))
    return prev


def _restore_handlers(prev) -> None:
    for sig, handler in prev:
        signal.signal(sig, handler)


# --------------------------------------------------------------------------
# Journal lines
# --------------------------------------------------------------------------

#: separator between a journal line's payload and its integrity suffix
#: (a tab never appears in the JSON-line protocols that use this)
_JOURNAL_SEP = "\t#crc32="


def journal_encode_line(raw: str) -> str:
    """One append-only journal line: the payload followed by its CRC32
    suffix, so a line torn mid-write fails the CRC and is detected as
    torn instead of surfacing as a corrupt payload downstream."""
    if "\n" in raw or "\r" in raw:
        raise ValueError("journal lines must be newline-free")
    return f"{raw}{_JOURNAL_SEP}{zlib.crc32(raw.encode()):08x}"


def journal_decode_line(line: str) -> str | None:
    """The payload of one journal line, or ``None`` when the line is torn
    (CRC suffix mismatched or truncated mid-suffix).  Lines without the
    suffix (journals written before it existed) are returned as-is."""
    payload, sep, crc_hex = line.rpartition(_JOURNAL_SEP)
    if not sep:
        return line
    try:
        want = int(crc_hex, 16)
    except ValueError:
        return None
    if zlib.crc32(payload.encode()) != want:
        return None
    return payload


def read_journal(path: str) -> tuple[list[str], int]:
    """``(payloads, n_torn)``: every line whose suffix verifies (or that
    predates the suffix), and the count of torn lines dropped.  A missing
    journal is an empty one.  A FINAL line with no separator, in a file
    where some line carries the suffix, is torn (the writer died before
    the suffix); a suffix-less line elsewhere is a legacy line."""
    try:
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
    except FileNotFoundError:
        return [], 0
    any_suffixed = any(_JOURNAL_SEP in ln for ln in lines)
    payloads, torn = [], 0
    for i, line in enumerate(lines):
        payload = journal_decode_line(line)
        if payload is None or (i == len(lines) - 1 and any_suffixed
                               and _JOURNAL_SEP not in line):
            torn += 1
        else:
            payloads.append(payload)
    return payloads, torn


# --------------------------------------------------------------------------
# Fingerprints
# --------------------------------------------------------------------------


def config_fingerprint(*objs) -> int:
    """Stable CRC32 fingerprint over config objects (dataclasses, scalars,
    tuples): scalar fields and (nested) tuples contribute their values,
    array-valued fields only their type name.  The reference's function:
    the port's config classes carry its class and field names, so the two
    packages give equal fingerprints for equal configs."""
    def desc(o):
        if o is None or isinstance(o, (bool, int, float, str)):
            return o
        if isinstance(o, tuple):
            return tuple(desc(x) for x in o)
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return (type(o).__name__,) + tuple(
                (f.name, desc(getattr(o, f.name)))
                for f in dataclasses.fields(o)
                if isinstance(getattr(o, f.name),
                              (bool, int, float, str, tuple,
                               type(None)))
                or dataclasses.is_dataclass(getattr(o, f.name)))
        return type(o).__name__
    return zlib.crc32(repr(tuple(desc(o) for o in objs)).encode())


# --------------------------------------------------------------------------
# Snapshot files
# --------------------------------------------------------------------------


def snapshot_save(path: str, header: dict,
                  by_key: dict[str, np.ndarray]) -> dict:
    """Write one snapshot file atomically: the JSON header line (magic,
    version, payload length and CRC32 added here), then the npz payload.
    Returns the header as written."""
    payload = encode_npz(by_key)
    h = dict(header)
    h["magic"] = MAGIC
    h["version"] = FORMAT_VERSION
    h["payload_bytes"] = len(payload)
    h["payload_crc32"] = zlib.crc32(payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(json.dumps(h, sort_keys=True).encode() + b"\n")
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return h


def snapshot_read(path: str, expect_fingerprint: int | None = None
                  ) -> tuple[dict, dict[str, np.ndarray]]:
    """Read and verify one snapshot: ``(header, {key: array})``.  Every
    failure is rejected by name: "not a checkpoint snapshot", "corrupted",
    "truncated", "fingerprint"."""
    with open(path, "rb") as f:
        blob = f.read()
    nl = blob.find(b"\n")
    if nl < 0:
        raise ValueError(
            f"{path}: corrupted snapshot — no header line "
            "(not a checkpoint snapshot?)")
    try:
        header = json.loads(blob[:nl].decode("utf-8", errors="strict"))
    except (ValueError, UnicodeDecodeError) as e:
        raise ValueError(
            f"{path}: corrupted snapshot — unparseable header "
            f"({e})") from e
    if not isinstance(header, dict) or header.get("magic") != MAGIC:
        raise ValueError(
            f"{path}: not a checkpoint snapshot (magic "
            f"{header.get('magic') if isinstance(header, dict) else None!r}"
            f" != {MAGIC!r})")
    if header.get("version") != FORMAT_VERSION:
        raise ValueError(
            f"{path}: snapshot format version {header.get('version')!r} "
            f"is not the supported {FORMAT_VERSION}")
    payload = blob[nl + 1:]
    want_n = header.get("payload_bytes")
    if not isinstance(want_n, int) or len(payload) != want_n:
        raise ValueError(
            f"{path}: truncated snapshot — header promises {want_n} "
            f"payload bytes, file carries {len(payload)}")
    if zlib.crc32(payload) != header.get("payload_crc32"):
        raise ValueError(
            f"{path}: corrupted snapshot — payload CRC32 mismatch "
            "(bit flip or partial write)")
    if (expect_fingerprint is not None
            and int(header.get("fingerprint", -1))
            != int(expect_fingerprint)):
        raise ValueError(
            f"{path}: snapshot config fingerprint "
            f"{header.get('fingerprint')} != expected "
            f"{int(expect_fingerprint)} — this snapshot was taken "
            "under a different configuration; refusing to resume")
    try:
        by_key = decode_npz(io.BytesIO(payload))
    except (ValueError, KeyError, OSError) as e:
        raise ValueError(
            f"{path}: corrupted snapshot — payload does not decode as "
            f"packed leaves ({e})") from e
    return header, by_key


def latest_snapshot(directory: str, tag: str):
    """``(segment_index, path)`` of the highest-numbered ``tag`` snapshot
    in ``directory``, or None.  Validation happens at read."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        if not name.startswith(tag + "-seg"):
            continue
        m = _SEG_RE.search(name)
        if m is None:
            continue
        idx = int(m.group(1))
        if best is None or idx > best[0]:
            best = (idx, os.path.join(directory, name))
    return best


# --------------------------------------------------------------------------
# Delta snapshots
# --------------------------------------------------------------------------
#
# With ``full_every = K > 1`` only every Kth boundary writes the full
# carry; the boundaries between encode against the previous snapshot: per
# leaf nothing when bit-identical, the flat changed indices and values
# when under half the lanes moved, else the full leaf.  The header links
# the chain; resume replays it from the full snapshot, checking every
# link's CRC, and a chain whose base is missing, corrupted or divergent is
# rejected as "unusable delta chain".

_D_IDX = "~didx/"      # payload key prefix: flat changed indices
_D_VAL = "~dval/"      # payload key prefix: values at those indices


def _encode_delta(by_key: dict[str, np.ndarray],
                  base: dict[str, np.ndarray]
                  ) -> tuple[dict[str, np.ndarray], dict]:
    """Encode ``by_key`` against ``base``: (payload dict, header fields)."""
    payload: dict[str, np.ndarray] = {}
    same: list[str] = []
    replaced: list[str] = []
    sparse: list[str] = []
    for k, arr in by_key.items():
        b = base.get(k)
        if (b is None or b.shape != arr.shape
                or b.dtype != arr.dtype):
            replaced.append(k)
            payload[k] = arr
            continue
        av = arr.reshape(-1)
        bv = b.reshape(-1)
        # compare as raw bits so float payloads diff exactly
        au = av.view(np.dtype(f"u{arr.dtype.itemsize}")) \
            if arr.dtype.kind not in "biu?" else av
        bu = bv.view(np.dtype(f"u{arr.dtype.itemsize}")) \
            if arr.dtype.kind not in "biu?" else bv
        idx = np.flatnonzero(au != bu)
        if idx.size == 0:
            same.append(k)
        elif idx.size * 2 < av.size:
            sparse.append(k)
            payload[_D_IDX + k] = idx.astype(np.int64)
            payload[_D_VAL + k] = av[idx]
        else:
            replaced.append(k)
            payload[k] = arr
    removed = sorted(set(base) - set(by_key))
    bits = {"delta_same": sorted(same),
            "delta_sparse": sorted(sparse),
            "delta_replaced": sorted(replaced),
            "delta_removed": removed}
    return payload, bits


def _apply_delta(base: dict[str, np.ndarray], header: dict,
                 payload: dict[str, np.ndarray], path: str
                 ) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for k in header.get("delta_same", []):
        if k not in base:
            raise ValueError(
                f"{path}: unusable delta chain — delta keeps leaf "
                f"{k!r} the base snapshot does not carry")
        out[k] = base[k]
    for k in header.get("delta_replaced", []):
        out[k] = payload[k]
    for k in header.get("delta_sparse", []):
        if k not in base:
            raise ValueError(
                f"{path}: unusable delta chain — delta patches leaf "
                f"{k!r} the base snapshot does not carry")
        arr = base[k].copy().reshape(-1)
        idx = payload[_D_IDX + k]
        arr[idx] = payload[_D_VAL + k]
        out[k] = arr.reshape(base[k].shape)
    return out


def _chain_path(directory: str, tag: str, idx: int) -> str:
    return os.path.join(directory, f"{tag}-seg{idx:06d}.ckpt")


def read_snapshot_chain(directory: str, tag: str, idx: int,
                        expect_fingerprint: int | None = None
                        ) -> tuple[dict, dict[str, np.ndarray]]:
    """Snapshot ``idx`` reconstructed through its delta chain when it is
    not a full one: ``(header, by_key)`` as ``snapshot_read`` gives for a
    full snapshot.  Every failure along the chain raises "unusable delta
    chain"."""
    path = _chain_path(directory, tag, idx)
    header, payload = snapshot_read(path, expect_fingerprint)
    if header.get("kind", "full") == "full":
        return header, payload
    full_idx = header.get("full_segment")
    if not isinstance(full_idx, int) or full_idx < 1 or full_idx > idx:
        raise ValueError(
            f"{path}: unusable delta chain — header names no valid "
            f"full_segment (got {full_idx!r})")
    chain = []     # [(path, header, payload)] from full to idx
    for j in range(full_idx, idx + 1):
        pj = _chain_path(directory, tag, j)
        try:
            hj, kj = snapshot_read(pj, expect_fingerprint)
        except FileNotFoundError as e:
            raise ValueError(
                f"{path}: unusable delta chain — link {pj} is missing "
                "(pruned with keep smaller than the chain, or deleted)"
            ) from e
        except ValueError as e:
            raise ValueError(
                f"{path}: unusable delta chain — link {pj} does not "
                f"read back ({e})") from e
        chain.append((pj, hj, kj))
    p0, h0, by_key = chain[0]
    if h0.get("kind", "full") != "full":
        raise ValueError(
            f"{path}: unusable delta chain — link {p0} should be the "
            "chain's full snapshot but is itself a delta")
    prev_crc = h0.get("payload_crc32")
    for pj, hj, kj in chain[1:]:
        if hj.get("kind", "full") != "delta":
            raise ValueError(
                f"{path}: unusable delta chain — link {pj} is not a "
                "delta (mixed chains: was the directory reused?)")
        if hj.get("base_crc32") != prev_crc:
            raise ValueError(
                f"{path}: unusable delta chain — link {pj} was "
                "encoded against a different base snapshot than the "
                "one on disk (CRC mismatch); refusing to resume")
        by_key = _apply_delta(by_key, hj, kj, pj)
        prev_crc = hj.get("payload_crc32")
    return chain[-1][1], by_key


# --------------------------------------------------------------------------
# Async writer
# --------------------------------------------------------------------------


class _AsyncWriter:
    """One snapshot write in flight: ``submit`` joins the previous write,
    then starts the job on a daemon thread.  A failed write re-raises on
    the next submit or at ``drain``.  Jobs take host arrays only."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None

    def _run(self, job):
        try:
            job()
        except BaseException as e:       # surfaced on next submit/drain
            self._err = e

    def _join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, job) -> None:
        self._join()
        self._thread = threading.Thread(target=self._run, args=(job,),
                                        daemon=True)
        self._thread.start()

    def drain(self) -> None:
        """Block until the write in flight (if any) is on disk; re-raise
        its failure."""
        self._join()


def _restore_state(by_key: dict[str, np.ndarray], template):
    """The state in ``template``'s structure from the packed ``state/...``
    leaves, on the template's device.  Shape mismatches, missing and
    extra leaves are named; dtypes must widen exactly."""
    meta = leaf_meta(template, "state")
    out = {}
    for k, (shape, want) in meta.items():
        if k not in by_key:
            raise ValueError(f"snapshot missing state leaf {k!r} — "
                             "wrong sim configuration?")
        arr = by_key[k]
        if arr.shape != shape:
            raise ValueError(
                f"leaf {k!r}: snapshot {dtname(arr)}{arr.shape} vs "
                f"template {want}{shape} — peer-axis "
                "layout or sim configuration mismatch")
        out[k] = _widen_exact(arr, want, k, what="snapshot")
    extra = sorted(k for k in by_key
                   if k.startswith("state/") and k not in meta)
    if extra:
        raise ValueError(
            f"snapshot has state leaves the template lacks: "
            f"{extra[:4]} — wrong sim configuration?")
    return rebuild(template, out, "state")


def _layout(state) -> dict:
    """The header's peer-axis layout: the port's carry lies on one
    device."""
    return {"devices": 1}


# --------------------------------------------------------------------------
# The segment engine
# --------------------------------------------------------------------------


def _run_segmented(run_segment, state, n_ticks: int,
                   ckpt: CheckpointConfig, *, has_aux: bool = False):
    """Drive ``run_segment(state, seg_len) -> (state, aux_piece|None)``
    over the horizon with snapshots between segments, resuming from the
    latest valid snapshot in ``ckpt.directory`` when one exists.  Per-tick
    outputs (curve counts, telemetry frames) are concatenated on the host
    along their tick axis and ride in the snapshots under ``aux/...``, so
    a resumed run returns the full-horizon outputs bit-identically."""
    if n_ticks < 0:
        raise ValueError(f"n_ticks={n_ticks} must be >= 0")
    every = int(ckpt.every) or max(int(n_ticks), 1)
    full_every = max(1, int(ckpt.full_every))
    ticks_done = 0
    seg_idx = 0
    aux_acc: dict[str, np.ndarray] | None = None
    aux_template = None
    # the delta chain's base: the previous boundary's full host dict and
    # its payload CRC on disk
    prev_by_key: dict[str, np.ndarray] | None = None
    last_crc: dict[str, object] = {"crc": None}

    found = latest_snapshot(ckpt.directory, ckpt.tag)
    if found is not None:
        seg_idx, path = found
        header, by_key = read_snapshot_chain(
            ckpt.directory, ckpt.tag, seg_idx,
            expect_fingerprint=ckpt.fingerprint)
        ticks_done = int(header["ticks_done"])
        prev_by_key = dict(by_key)
        last_crc["crc"] = header.get("payload_crc32")
        if ticks_done > n_ticks:
            raise ValueError(
                f"{path}: snapshot is {ticks_done} ticks in but the "
                f"requested horizon is only {n_ticks} — refusing to "
                "resume past the end (wrong directory or horizon?)")
        state = _restore_state(by_key, state)
        loaded_aux = {k: v for k, v in by_key.items()
                      if k.startswith("aux")}
        if loaded_aux:
            aux_acc = loaded_aux
        if has_aux and ticks_done == n_ticks and ticks_done > 0:
            raise ValueError(
                f"{path}: run already complete at {ticks_done} ticks — "
                "the per-tick outputs cannot be restructured without "
                "running a segment; point CheckpointConfig.directory "
                "somewhere fresh to rerun")

    prev_handlers = install_kill_handlers()
    writer = _AsyncWriter() if ckpt.async_write else None
    try:
        while ticks_done < n_ticks:
            seg = min(every, n_ticks - ticks_done)
            state, piece = run_segment(state, seg)
            ticks_done += seg
            seg_idx += 1
            # the one synchronous device-to-host copy of the carry (and of
            # the segment's per-tick outputs)
            by_key = host_leaves(state, "state")
            if piece is not None:
                aux_template = piece
                pk = host_leaves(piece, "aux")
                if aux_acc is None:
                    aux_acc = pk
                elif set(aux_acc) != set(pk):
                    raise ValueError(
                        "resumed aux keys do not match this run's "
                        f"per-tick outputs: {sorted(aux_acc)[:3]} vs "
                        f"{sorted(pk)[:3]} — wrong snapshot chain?")
                else:
                    aux_acc = {k: np.concatenate([aux_acc[k], pk[k]],
                                                 axis=0) for k in pk}
            os.makedirs(ckpt.directory, exist_ok=True)
            path = os.path.join(ckpt.directory,
                                f"{ckpt.tag}-seg{seg_idx:06d}.ckpt")
            is_full = (full_every == 1 or prev_by_key is None
                       or (seg_idx - 1) % full_every == 0)
            header = {
                "fingerprint": int(ckpt.fingerprint),
                "tick": int(state.tick),
                "ticks_done": ticks_done,
                "n_ticks": int(n_ticks),
                "segment": seg_idx,
                "every": int(ckpt.every),
                "layout": _layout(state),
                "tag": ckpt.tag,
                "kind": "full" if is_full else "delta",
                "full_every": full_every,
            }
            if not is_full:
                header["base_segment"] = seg_idx - 1
                header["full_segment"] = (
                    seg_idx - ((seg_idx - 1) % full_every))
            if aux_acc is not None:
                by_key.update(aux_acc)
            base = prev_by_key
            prev_by_key = by_key

            def job(path=path, header=header, by_key=by_key,
                    base=base, seg_idx=seg_idx):
                if header["kind"] == "delta":
                    payload, bits = _encode_delta(by_key, base)
                    header.update(bits)
                    # writes are serialized, so the previous boundary's
                    # CRC is final by the time this job runs
                    header["base_crc32"] = last_crc["crc"]
                    written = snapshot_save(path, header, payload)
                else:
                    written = snapshot_save(path, header, by_key)
                last_crc["crc"] = written["payload_crc32"]
                _prune(ckpt, seg_idx)

            if writer is None:
                job()
            else:
                writer.submit(job)
            if stop_requested() and ticks_done < n_ticks:
                if writer is not None:
                    writer.drain()
                raise CheckpointInterrupt(path, ticks_done, n_ticks)
        if writer is not None:
            writer.drain()
    finally:
        if writer is not None:
            try:
                writer.drain()
            except Exception:
                pass  # only reachable with a primary exception unwinding
        _restore_handlers(prev_handlers)

    if not has_aux or aux_template is None:
        # zero segments ran: nothing to restructure
        return state, None
    return state, rebuild(aux_template, aux_acc, "aux")


def _prune(ckpt: CheckpointConfig, newest: int) -> None:
    """Delete snapshots older than the ``keep`` window, except the links
    the oldest kept snapshot's delta chain still needs."""
    if not os.path.isdir(ckpt.directory):
        return
    oldest = max(1, newest - int(ckpt.keep) + 1)
    full_every = max(1, int(ckpt.full_every))
    floor = oldest - ((oldest - 1) % full_every)
    for name in os.listdir(ckpt.directory):
        if not name.startswith(ckpt.tag + "-seg"):
            continue
        m = _SEG_RE.search(name)
        if m is not None and int(m.group(1)) < floor:
            os.unlink(os.path.join(ckpt.directory, name))


# --------------------------------------------------------------------------
# Runners — segmented twins of the models/ ones
# --------------------------------------------------------------------------


def ckpt_gossip_run(params, state, n_ticks: int, step,
                    ckpt: CheckpointConfig, *, device=None):
    """``gossip_run``, segmented: the same final state, snapshots between
    segments, resume from the latest one."""
    from ..models.gossipsub import gossip_run
    dev = resolve_device(device)

    def seg(s, n):
        return gossip_run(params, s, n, step, device=dev), None
    return _run_segmented(seg, state, n_ticks, ckpt)[0]


def ckpt_gossip_run_fused(params, state, n_ticks: int, window,
                          ckpt: CheckpointConfig, *, device=None):
    """``gossip_run_fused``, segmented: each segment is whole fused
    windows, so an ``every`` that would split a window is refused with the
    reference's message (there is no mid-window carry to save)."""
    from ..models.gossipsub import gossip_run_fused
    dev = resolve_device(device)
    ticks_fused = int(getattr(window, "ticks_fused", 1))
    every = int(ckpt.every) or int(n_ticks)
    if every % ticks_fused != 0:
        raise ValueError(plan.msg_ckpt_mid_window(int(ckpt.every),
                                                  ticks_fused))
    plan.check_fused_horizon(n_ticks, ticks_fused)

    def seg(s, n):
        return gossip_run_fused(params, s, n, window, device=dev), None
    return _run_segmented(seg, state, n_ticks, ckpt)[0]


def ckpt_gossip_run_curve(params, state, n_ticks: int, step,
                          ckpt: CheckpointConfig, n_msgs: int, *,
                          device=None):
    """``gossip_run_curve``, segmented: the per-segment count blocks are
    concatenated (and carried through snapshots), so the returned
    [n_ticks, M] curve equals the single run's."""
    from ..models.gossipsub import gossip_run_curve
    dev = resolve_device(device)

    def seg(s, n):
        return gossip_run_curve(params, s, n, step, n_msgs, device=dev)
    return _run_segmented(seg, state, n_ticks, ckpt, has_aux=True)


def ckpt_gossip_run_knob_batch(params, state, n_ticks: int, step,
                               ckpt: CheckpointConfig, honest=None, *,
                               device=None):
    """``gossip_run_knob_batch``, segmented: the stacked replicas advance
    by ``gossip_run_batch``, then the per-replica reach is counted once
    from the final possession words, so ``(state, reach)`` equal the
    unsegmented dispatch's."""
    from ..models.gossipsub import gossip_run_batch, reach_counts_from_have
    dev = resolve_device(device)

    def seg(s, n):
        return gossip_run_batch(params, s, n, step, device=dev), None
    state = _run_segmented(seg, state, n_ticks, ckpt)[0]
    mask = None
    if honest is not None:
        mask = torch.as_tensor(np.asarray(honest, dtype=bool)
                               if not isinstance(honest, torch.Tensor)
                               else honest, device=dev)
    return state, reach_counts_from_have(params, state, mask)


def ckpt_telemetry_run(params, state, n_ticks: int, step,
                       ckpt: CheckpointConfig, *, device=None):
    """``telemetry_run``, segmented: every frame leaf (counters and
    histogram planes) concatenates along the tick axis and rides in the
    snapshots, so the resumed frames are bit-identical."""
    from ..models.telemetry import telemetry_run
    dev = resolve_device(device)

    def seg(s, n):
        check_on(dev, have=s.have)
        return telemetry_run(params, s, n, step)
    return _run_segmented(seg, state, n_ticks, ckpt, has_aux=True)


def ckpt_flood_run(params, state, n_ticks: int, step_fn,
                   ckpt: CheckpointConfig, *, device=None):
    from ..models.floodsub import flood_run
    dev = resolve_device(device)

    def seg(s, n):
        return flood_run(params, s, n, step_fn, device=dev), None
    return _run_segmented(seg, state, n_ticks, ckpt)[0]


def ckpt_flood_run_curve(params, state, n_ticks: int, step_core,
                         ckpt: CheckpointConfig, n_msgs: int, *,
                         device=None):
    from ..models.floodsub import flood_run_curve
    dev = resolve_device(device)

    def seg(s, n):
        return flood_run_curve(params, s, n, step_core, n_msgs, device=dev)
    return _run_segmented(seg, state, n_ticks, ckpt, has_aux=True)


def ckpt_randomsub_run(params, state, n_ticks: int, step,
                       ckpt: CheckpointConfig, *, device=None):
    from ..models.randomsub import randomsub_run
    dev = resolve_device(device)

    def seg(s, n):
        return randomsub_run(params, s, n, step, device=dev), None
    return _run_segmented(seg, state, n_ticks, ckpt)[0]


def ckpt_randomsub_run_curve(params, state, n_ticks: int, step,
                             ckpt: CheckpointConfig, n_msgs: int, *,
                             device=None):
    from ..models.randomsub import randomsub_run_curve
    dev = resolve_device(device)

    def seg(s, n):
        return randomsub_run_curve(params, s, n, step, n_msgs, device=dev)
    return _run_segmented(seg, state, n_ticks, ckpt, has_aux=True)


def ckpt_sharded_gossip_run(*args, **kwargs):
    """The sharded runner, segmented: refused by name (A9)."""
    plan.refuse("sharded_checkpoint")


def ckpt_sharded_gossip_run_fused(*args, **kwargs):
    """The sharded fused runner, segmented: refused by name (A9)."""
    plan.refuse("sharded_checkpoint")


def ckpt_sharded_gossip_run_knob_batch(*args, **kwargs):
    """The sharded knob batch, segmented: refused by name (A9)."""
    plan.refuse("sharded_checkpoint")


def segment_dispatch() -> dict:
    """What runs inside a segment, by sim: the unsegmented runners."""
    from ..models import floodsub as fl
    from ..models import gossipsub as gs
    from ..models import randomsub as rs
    return {
        "gossipsub": gs.gossip_run,
        "gossipsub-curve": gs.gossip_run_curve,
        "gossipsub-batch": gs.gossip_run_batch,
        "gossipsub-fused": gs.gossip_run_fused,
        "floodsub": fl.flood_run,
        "randomsub": rs.randomsub_run,
    }
