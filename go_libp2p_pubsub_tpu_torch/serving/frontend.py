"""The fault-tolerant multi-tenant scenario front end: the port's copy of
the JAX package's ``serving/frontend.py``.

``ScenarioFrontend`` wraps a bounded set of shape-bucketed sweepd servers
(buckets.py) with the request lifecycle:

  admission control   a queue-depth cap: requests past it come back as
                      EXPLICIT ``overloaded`` rejection rows; every
                      admitted request produces exactly one terminal row
                      (result, error, timeout, or rejection).
  deadlines           per-request ``deadline_s`` (seconds from
                      admission); requests still queued past it are
                      culled with named ``timeout`` rows before every
                      dispatch.
  priority            higher ``priority`` dispatches first (FIFO within
                      a priority level).
  bounded retry       transient dispatch failures (RuntimeError/OSError,
                      a CUDA launch error among them; NOT request
                      validation errors, which are terminal rows) retry
                      up to ``max_retries`` times with exponential
                      backoff before the whole group fails with named
                      rows.  A bucket the port refuses by name
                      (``plan.SliceRefusal``: a ``k_slots`` bucket, whose
                      batched server's receive loops take no delay
                      lines) is a terminal error row, never retried.
  graceful drain      a deferred SIGTERM/SIGINT (parallel/checkpoint stop
                      flag) drains queued short requests, parks
                      interrupted long ones in the journal, and exits;
                      kill -9 loses nothing either: the CRC'd journal
                      replays accepted-but-unserved lines on restart.
  long scenarios      requests whose bucket horizon reaches
                      ``long_ticks`` route through ``ckpt_gossip_run``
                      with a per-request snapshot directory, so a kill
                      mid-scenario resumes on restart to the
                      BIT-IDENTICAL digest.

Request schema (front-end fields; everything else is the sweepd scenario
schema: knobs, drop_prob, churn, attack, attack_frac, seed):

    {"id": "r1", "n": 500, "t": 2, "m": 6, "ticks": 12, "k_slots": 0,
     "deadline_s": 2.5, "priority": 1, "knobs": {"d": 8}}

Shapes quantize UP into bucket specs (buckets.quantize_shape); the
request is served at its bucket's shape (more peers / more ticks than
asked: conservative), and the result row names the bucket it ran in.
The buckets' servers run on ``server_kw["device"]`` (default ``cuda``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
import json
import os
import shutil
import sys
import time
import zlib

import numpy as np
import torch

from . import buckets as bk
from .. import obs as _obs
from ..models import plan
from ..parallel import checkpoint as ck

__all__ = ["FrontendConfig", "ScenarioFrontend"]

#: front-end request fields, split off before the inner scenario request
#: reaches the bucket server's validator
SHAPE_FIELDS = ("n", "t", "m", "ticks", "k_slots")
FRONT_FIELDS = SHAPE_FIELDS + ("deadline_s", "priority")


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Host-side front-end spec.

    max_buckets: resident-runner cap (LRU eviction past it).
    batch: per-bucket dispatch width (>= 2; partial batches pad).
    queue_cap: admission-control depth; admissions past it are rejected
        with explicit ``overloaded`` rows.
    long_ticks: bucket horizons >= this route through the ckpt runner (0
        disables the long path).
    ckpt_dir: snapshot root for long scenarios (one subdir per request
        id); required when long_ticks > 0.
    ckpt_every: segment length for long scenarios (0 = horizon/4).
    aot_dir: bucket-runner cache: a bucket whose record is found here
        (and matches this process) loads it and adds no compile; a bucket
        built fresh writes its record here for the next cold start.
    max_retries / backoff_base_s: bounded retry with exponential backoff
        on transient dispatch failure.
    tick_quantum: quantize_shape's tick rounding.
    default_shape: (n, t, m, ticks) for requests that omit shape fields.
    server_kw: extra SweepServer kwargs shared by every bucket (seed,
        invariants, device, ...).
    """

    max_buckets: int = 4
    batch: int = 4
    queue_cap: int = 512
    long_ticks: int = 0
    ckpt_dir: str | None = None
    ckpt_every: int = 0
    aot_dir: str | None = None
    max_retries: int = 2
    backoff_base_s: float = 0.05
    tick_quantum: int = 8
    default_shape: tuple = (256, 2, 8, 16)
    server_kw: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.batch < 2:
            raise ValueError(
                f"FrontendConfig.batch={self.batch} must be >= 2 "
                "(the front-end compile counter reads the batched "
                "runner's jit cache; batch=1 is sweepd's sequential "
                "kernel demonstration, not a serving config)")
        if self.long_ticks > 0 and not self.ckpt_dir:
            raise ValueError(
                "FrontendConfig: long_ticks > 0 needs ckpt_dir — "
                "preemption-surviving scenarios snapshot to disk")


#: steps shared across bucket rebuilds: an evicted-then-recreated bucket
#: serves with the step object its shape first ran under
_STEP_MEMO: dict = {}
#: the process-global registry of bucket runners, the counterpart of the
#: reference's jit caches: a short-path runner per (spec, batch, server
#: kwargs) the first time a traced bucket of that key dispatches, a
#: long-path one per (key, segment length) its segmented runs step
_BATCH_RUNNERS: set = set()
_LONG_RUNNERS: set = set()


def _segment_lengths(ticks: int, every: int) -> set:
    """The segment lengths a ``ticks``-long segmented run steps."""
    return {min(every, ticks - done) for done in range(0, ticks, every)}


class _QItem:
    """One admitted request: the raw journal line, its split front/inner
    fields, its bucket spec, its lifecycle stamps, and its propagated
    trace id (the span spine)."""

    __slots__ = ("raw", "req", "inner", "spec", "deadline", "priority",
                 "seq", "t_admit", "trace_id")

    def __init__(self, raw, req, inner, spec, deadline, priority, seq,
                 t_admit, trace_id=None):
        self.raw, self.req, self.inner = raw, req, inner
        self.spec, self.deadline = spec, deadline
        self.priority, self.seq, self.t_admit = priority, seq, t_admit
        self.trace_id = trace_id


class _Bucket:
    """One resident runner: the sweepd server plus its serving
    bookkeeping (``key``: its registry key)."""

    __slots__ = ("spec", "server", "aot", "dispatches", "key")

    def __init__(self, spec, server, aot, key):
        self.spec, self.server, self.aot = spec, server, aot
        self.dispatches = 0
        self.key = key


class ScenarioFrontend:
    """See the module docstring.  In-process API:

        fe = ScenarioFrontend(FrontendConfig(...))
        rej = fe.admit({"id": "r1", "n": 500, "ticks": 12})  # None or
                                                     # a rejection row
        rows = fe.dispatch_ready()   # culls deadlines, serves the head
                                     # bucket when it has a full batch
        rows += fe.drain()           # force-dispatch everything
        fe.stats()

    Line protocol: ``serve_lines`` (the sweepd shape: flush/stats/metrics
    cmds, CRC'd journal, replay-on-start, deferred-kill drain)."""

    def __init__(self, cfg: FrontendConfig | None = None, *,
                 obs: _obs.Observability | None = None, **kw):
        self.cfg = cfg or FrontendConfig(**kw)
        # the observability plane: always on (host-only, cheap); callers
        # share one bundle across servers by passing their own
        self.obs = obs or _obs.Observability()
        self.buckets = bk.BucketLRU(self.cfg.max_buckets,
                                    metrics=self.obs.metrics)
        self._heap: list = []   # (-priority, seq, _QItem)
        self._seq = 0
        self._journal: str | None = None
        #: raw lines of interrupted long scenarios, kept in the journal
        #: across compactions until their restart completes
        self._parked_raw: list[str] = []
        # counters (every admitted request ends in exactly one of:
        # served, error, timeout, transient-failure; rejected requests
        # were never admitted: the accounting identity servestat checks)
        self.admitted = 0
        self.served = 0
        self.errors = 0
        self.timeouts = 0
        self.rejected_overload = 0
        self.retries = 0
        self.transient_failures = 0
        self.long_served = 0
        self.long_resumed = 0
        self.aot_loads = 0
        self.aot_exports = 0
        self.journal_replays = 0
        self._traced_specs: set = set()
        self._t0 = time.perf_counter()
        self.wall_device_s = 0.0
        # metric instruments: the accounting counters are MIRRORED
        # (set_total inside one atomic() block at every publish point),
        # so a scrape, even mid-burst, always sees the identity hold
        m = self.obs.metrics
        self._mc = {
            "serving_admitted_total": lambda: self.admitted,
            "serving_served_total": lambda: self.served,
            "serving_errors_total": lambda: self.errors,
            "serving_deadline_timeouts_total": lambda: self.timeouts,
            "serving_overload_rejected_total":
                lambda: self.rejected_overload,
            "serving_retries_total": lambda: self.retries,
            "serving_transient_failures_total":
                lambda: self.transient_failures,
            "serving_long_served_total": lambda: self.long_served,
            "serving_long_resumed_total": lambda: self.long_resumed,
            "serving_aot_loads_total": lambda: self.aot_loads,
            "serving_aot_exports_total": lambda: self.aot_exports,
            "serving_journal_replays_total":
                lambda: self.journal_replays,
        }
        for name in self._mc:
            m.counter(name)
        self._g_queue = m.gauge("serving_queue_depth",
                                "requests queued, all buckets")
        self._g_parked = m.gauge(
            "serving_parked",
            "interrupted long scenarios parked in the journal")
        self._g_compiles = m.gauge(
            "serving_compiles",
            "short-path bucket runners registered since construction")
        self._g_long_compiles = m.gauge(
            "serving_long_compiles",
            "long-path (ckpt) bucket runners registered")
        self._g_bucket_q = m.gauge(
            "serving_bucket_queue_depth",
            "queued requests per bucket spec")
        self._c_dispatches = m.counter(
            "serving_bucket_dispatches_total",
            "device dispatches per bucket spec")
        self._h_queue = m.histogram(
            "serving_queue_seconds",
            (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0),
            "admission-to-dispatch queue wait")
        self._h_dispatch = m.histogram(
            "serving_dispatch_seconds",
            (0.01, 0.05, 0.2, 1.0, 5.0, 30.0),
            "device-dispatch wall per bucket spec")
        self._bucket_q_keys: set = set()
        self._last_trace_id: str | None = None
        # the compile counter: the process-global runner registry's
        # growth since construction (AOT-loaded buckets bypass it)
        self._cache_base = len(_BATCH_RUNNERS)
        self._long_cache_base = len(_LONG_RUNNERS)

    # -- bucket management --------------------------------------------

    def compiles(self) -> int:
        """Bucket runners registered for the short-request path since
        construction: the zero-recompile claim is ``compiles() == number
        of distinct traced bucket shapes`` (AOT-loaded buckets add zero;
        LRU-evicted-and-rebuilt buckets add zero, the registry is
        process-global)."""
        return len(_BATCH_RUNNERS) - self._cache_base

    def long_compiles(self) -> int:
        """Bucket runners registered for the long-scenario (ckpt) path."""
        return len(_LONG_RUNNERS) - self._long_cache_base

    def _publish_metrics(self) -> None:
        """Project the accounting counters into the registry in ONE
        atomic block, called only at consistent points (end of admit, end
        of dispatch, after parking), so every scrape satisfies admitted
        == served + errors + timeouts + transient + queued + parked."""
        m = self.obs.metrics
        per: dict[str, int] = {}
        for entry in self._heap:
            key = entry[2].spec.key()
            per[key] = per.get(key, 0) + 1
        with m.atomic():
            for name, read in self._mc.items():
                m.counter(name).set_total(read())
            self._g_queue.set(len(self._heap))
            self._g_parked.set(len(self._parked_raw))
            self._g_compiles.set(self.compiles())
            self._g_long_compiles.set(self.long_compiles())
            for key in self._bucket_q_keys - set(per):
                self._g_bucket_q.set(0, bucket=key)
            for key, depth in per.items():
                self._g_bucket_q.set(depth, bucket=key)
            self._bucket_q_keys |= set(per)

    def _bucket(self, spec: bk.BucketSpec) -> _Bucket:
        """The spec's resident bucket, built on a miss.  Raises
        ``plan.SliceRefusal`` where the port refuses the bucket's
        server."""
        got = self.buckets.get(spec)
        if got is not None:
            return got
        from ..sweepd import SweepServer
        server = SweepServer(
            n=spec.n, t=spec.t, m=spec.m, ticks=spec.ticks,
            batch=self.cfg.batch, k_slots=spec.k_slots,
            **self.cfg.server_kw)
        memo_key = (spec, self.cfg.batch,
                    json.dumps(self.cfg.server_kw, sort_keys=True,
                               default=str))
        if memo_key in _STEP_MEMO:
            server.step = _STEP_MEMO[memo_key]
        else:
            _STEP_MEMO[memo_key] = server.step
        aot = False
        if self.cfg.aot_dir:
            path = bk.aot_blob_path(self.cfg.aot_dir, spec, server)
            if os.path.exists(path):
                try:
                    with open(path, "rb") as f:
                        server._aot_runner = bk.make_aot_runner(
                            server, f.read())
                    aot = True
                    self.aot_loads += 1
                except Exception as e:   # stale/foreign blob: rebuild
                    print(f"serving: AOT blob {path} unusable "
                          f"({e.__class__.__name__}: {e}) — falling "
                          "back to tracing", file=sys.stderr,
                          flush=True)
                    server._aot_runner = None
            if not aot:
                try:
                    os.makedirs(self.cfg.aot_dir, exist_ok=True)
                    blob = bk.export_bucket_runner(server)
                    tmp = path + ".tmp"
                    with open(tmp, "wb") as f:
                        f.write(blob)
                    os.replace(tmp, path)
                    self.aot_exports += 1
                except Exception as e:
                    print("serving: AOT export failed "
                          f"({e.__class__.__name__}: {e}) — bucket "
                          "serves traced", file=sys.stderr, flush=True)
        if not aot:
            self._traced_specs.add(spec)
        bucket = _Bucket(spec, server, aot, memo_key)
        self.buckets.put(spec, bucket)   # evicted servers just drop:
        # their runners stay in the process-global registry, so a
        # re-created bucket costs a host-side rebuild, not a compile
        return bucket

    # -- admission -----------------------------------------------------

    def _split(self, req: dict):
        inner = {k: v for k, v in req.items() if k not in FRONT_FIELDS}
        dn, dt, dm, dticks = self.cfg.default_shape
        spec = bk.quantize_shape(
            req.get("n", dn), req.get("t", dt), req.get("m", dm),
            req.get("ticks", dticks), req.get("k_slots", 0),
            tick_quantum=self.cfg.tick_quantum)
        return inner, spec

    def admit(self, req: dict, *, raw: str | None = None,
              now: float | None = None) -> dict | None:
        """Admit one request.  Returns ``None`` on success, or the
        request's terminal row (explicit ``overloaded`` rejection, or a
        validation error row): the caller emits it."""
        now = time.monotonic() if now is None else now
        self._last_trace_id = None
        if not isinstance(req, dict):
            self.errors += 1
            self._publish_metrics()
            return {"ok": False,
                    "error": "request must be a JSON object, got "
                             f"{type(req).__name__}"}
        if len(self._heap) >= self.cfg.queue_cap:
            self.rejected_overload += 1
            self._publish_metrics()
            return {"id": req.get("id"), "ok": False,
                    "overloaded": True,
                    "error": f"overloaded: queue depth "
                             f"{len(self._heap)} at the admission cap "
                             f"({self.cfg.queue_cap}) — the request "
                             "was rejected explicitly (never silently "
                             "dropped); resubmit after the queue "
                             "drains"}
        try:
            inner, spec = self._split(req)
            deadline_s = req.get("deadline_s")
            deadline = (None if deadline_s is None
                        else now + float(deadline_s))
            priority = int(req.get("priority", 0))
        except (ValueError, TypeError) as e:
            self.errors += 1
            self._publish_metrics()
            return {"id": req.get("id"), "ok": False, "error": str(e)}
        sp = self.obs.spans
        trace_id = sp.new_trace_id(req.get("id"))
        item = _QItem(raw if raw is not None else json.dumps(req),
                      req, inner, spec, deadline, priority, self._seq,
                      now, trace_id=trace_id)
        sp.instant(trace_id, "admit", bucket=spec.key(),
                   priority=priority)
        sp.begin(trace_id, "queue", bucket=spec.key())
        heapq.heappush(self._heap, (-priority, self._seq, item))
        self._seq += 1
        self.admitted += 1
        self._last_trace_id = trace_id
        self._publish_metrics()
        return None

    # -- dispatch ------------------------------------------------------

    def _cull_deadlines(self, now: float) -> list[dict]:
        rows = []
        keep = []
        for entry in self._heap:
            item = entry[2]
            if item.deadline is not None and now > item.deadline:
                self.timeouts += 1
                if item.trace_id is not None:
                    self._h_queue.observe(
                        self.obs.spans.end(item.trace_id, "queue",
                                           outcome="timeout"))
                    self.obs.spans.instant(item.trace_id, "serve",
                                           outcome="timeout")
                rows.append({
                    "id": item.req.get("id"), "ok": False,
                    "timeout": True, "trace_id": item.trace_id,
                    "error": "deadline exceeded: request waited "
                             f"{now - item.t_admit:.3f}s in queue, "
                             f"past its deadline_s="
                             f"{item.req.get('deadline_s')} — culled "
                             "before dispatch"})
            else:
                keep.append(entry)
        if len(keep) != len(self._heap):
            self._heap = keep
            heapq.heapify(self._heap)
        return rows

    def _pop_group(self) -> list[_QItem]:
        """Pop the head item plus queued same-bucket items up to the
        batch width (priority order, FIFO within a level)."""
        if not self._heap:
            return []
        head = heapq.heappop(self._heap)[2]
        group, keep = [head], []
        want = self.cfg.batch - 1
        while self._heap and want:
            entry = heapq.heappop(self._heap)
            if entry[2].spec == head.spec:
                group.append(entry[2])
                want -= 1
            else:
                keep.append(entry)
        for entry in keep:
            heapq.heappush(self._heap, entry)
        return group

    def _is_long(self, spec: bk.BucketSpec) -> bool:
        return (self.cfg.long_ticks > 0
                and spec.ticks >= self.cfg.long_ticks)

    def _end_dispatch_spans(self, items: list[_QItem], key: str,
                            outcome: str) -> None:
        """Close the group's open dispatch spans; the wall time of the
        first (all share the device call) feeds the per-bucket dispatch
        histogram."""
        wall = None
        for it in items:
            if it.trace_id is not None:
                d = self.obs.spans.end(it.trace_id, "dispatch",
                                       outcome=outcome)
                wall = d if wall is None else wall
        if wall is not None:
            self._h_dispatch.observe(wall, bucket=key)

    def _refused(self, items: list[_QItem], e: plan.SliceRefusal
                 ) -> list[dict]:
        """Terminal error rows for a bucket the port refuses by name
        (counted as errors, never retried: the same bucket is refused the
        same way every time)."""
        self.errors += len(items)
        return [{"id": it.req.get("id"), "ok": False, "error": str(e)}
                for it in items]

    def _submit_with_retry(self, bucket: _Bucket,
                           items: list[_QItem]) -> list[dict]:
        sp = self.obs.spans
        key = bucket.spec.key()
        # the pad phase: assembling the (padded) request group for the
        # bucket's static batch shape
        for it in items:
            if it.trace_id is not None:
                sp.begin(it.trace_id, "pad", bucket=key)
        reqs = [item.inner for item in items]
        pad_rows = self.cfg.batch - len(reqs)
        for it in items:
            if it.trace_id is not None:
                sp.end(it.trace_id, "pad", padded_rows=pad_rows)
        attempt = 0
        while True:
            try:
                for it in items:
                    if it.trace_id is not None:
                        sp.begin(it.trace_id, "dispatch", bucket=key,
                                 attempt=attempt)
                t0 = time.perf_counter()
                batches = bucket.server.batches
                rows = bucket.server.submit([dict(r) for r in reqs])
                self.wall_device_s += time.perf_counter() - t0
                if not bucket.aot and bucket.server.batches > batches:
                    _BATCH_RUNNERS.add(bucket.key)
                bucket.dispatches += 1
                self._c_dispatches.inc(bucket=key)
                self._end_dispatch_spans(items, key, "ok")
                return rows
            except ck.CheckpointInterrupt:
                raise   # drain machinery, not a dispatch failure
            except plan.SliceRefusal as e:
                self._end_dispatch_spans(items, key, "error")
                return self._refused(items, e)
            except (ValueError, TypeError) as e:
                # request-level problems are terminal rows, never
                # retried (the same input fails the same way)
                self.errors += len(items)
                self._end_dispatch_spans(items, key, "error")
                return [{"id": it.req.get("id"), "ok": False,
                         "error": str(e)} for it in items]
            except (RuntimeError, OSError) as e:
                attempt += 1
                if attempt > self.cfg.max_retries:
                    self.transient_failures += len(items)
                    self._end_dispatch_spans(items, key, "transient")
                    return [{"id": it.req.get("id"), "ok": False,
                             "transient": True,
                             "error": "dispatch failed after "
                                      f"{attempt} attempts "
                                      f"({e.__class__.__name__}: {e})"}
                            for it in items]
                self.retries += 1
                time.sleep(self.cfg.backoff_base_s
                           * (2 ** (attempt - 1)))

    # -- long scenarios (preemption-surviving) -------------------------

    def _ckpt_paths(self, item: _QItem):
        rid = str(item.req.get("id", item.seq))
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in rid) or "req"
        return os.path.join(self.cfg.ckpt_dir,
                            f"{safe}-{zlib.crc32(item.raw.encode()):08x}")

    def _dispatch_long(self, item: _QItem) -> dict:
        """One preemption-surviving scenario through the segmented
        runner: per-request snapshot directory, fingerprint bound to the
        request AND the bucket's static config, resume from the latest
        snapshot on restart, bit-identical digest (blake2b-16 over the
        final ``have``, ``mesh``, ``backoff`` and ``tick`` as the
        reference's leaves: words as uint32, the tick as an int32)."""
        from ..models import gossipsub as gs
        from ..models import invariants as iv
        from ..utils.checkpoint import host_leaves

        bucket = self._bucket(item.spec)
        server = bucket.server
        dev = server.device
        kw = server._build_kwargs(item.inner)   # may raise → caller
        params, state = gs.make_gossip_sim(server.cfg,
                                           score_cfg=server.sc,
                                           device=dev, **kw)
        if server.invariants is not None:
            state = iv.attach(state)
        honest = ~(np.asarray(kw["sybil"])
                   | np.asarray(kw["eclipse_sybil"])
                   | (np.asarray(kw["byzantine"])
                      if kw["byzantine"] is not None else False))
        directory = self._ckpt_paths(item)
        resumed = os.path.isdir(directory) and any(
            name.endswith(".ckpt") for name in os.listdir(directory))
        fp = (ck.config_fingerprint(server.cfg, server.sc)
              ^ zlib.crc32(item.raw.encode()))
        every = self.cfg.ckpt_every or max(item.spec.ticks // 4, 1)
        ckc = ck.CheckpointConfig(directory=directory, every=every,
                                  fingerprint=fp, tag="serve")
        t0 = time.perf_counter()
        try:
            out = ck.ckpt_gossip_run(params, state, item.spec.ticks,
                                     server.step, ckc, device=dev)
        except ck.CheckpointInterrupt:
            _LONG_RUNNERS.add((bucket.key, every))
            raise
        self.wall_device_s += time.perf_counter() - t0
        _LONG_RUNNERS.update((bucket.key, seg) for seg in
                             _segment_lengths(item.spec.ticks, every))
        mask = torch.as_tensor(honest, device=dev)
        reach = gs.reach_counts_from_have(params, out, mask).cpu().numpy()
        leaves = host_leaves(out)
        h = hashlib.blake2b(digest_size=16)
        for name in ("have", "mesh", "backoff", "tick"):
            h.update(np.asarray(leaves[name]).tobytes())
        want = np.array(
            [(honest & (server.members == tau)).sum()
             for tau in server.topic], dtype=np.float64)
        want_all = np.array(
            [(server.members == tau).sum() for tau in server.topic],
            dtype=np.float64)
        row = {
            "id": item.req.get("id"), "ok": True, "long": True,
            "bucket": item.spec.key(), "ticks": item.spec.ticks,
            "resumed": bool(resumed),
            "digest": h.hexdigest(),
            "honest_delivery_fraction":
                round(float((reach / want).mean()), 4),
            "delivery_fraction":
                round(float((reach / want_all).mean()), 4),
        }
        if server.invariants is not None:
            row["inv_bits"] = int(leaves["inv_viol"])
        shutil.rmtree(directory, ignore_errors=True)   # digest proven
        self.long_served += 1
        if resumed:
            self.long_resumed += 1
        return row

    def _dispatch_long_guarded(self, item: _QItem) -> dict:
        """_dispatch_long with the retry/terminal-row treatment of the
        short path; CheckpointInterrupt propagates (drain)."""
        group = [item]
        key = item.spec.key()
        attempt = 0
        while True:
            try:
                if item.trace_id is not None:
                    self.obs.spans.begin(item.trace_id, "dispatch",
                                         bucket=key, long=True,
                                         attempt=attempt)
                row = self._dispatch_long(item)
                self._c_dispatches.inc(bucket=key)
                self._end_dispatch_spans(group, key, "ok")
                return row
            except ck.CheckpointInterrupt:
                raise   # the dispatch span stays open: the caller
                # closes it with outcome="interrupted" when it parks
            except plan.SliceRefusal as e:
                self._end_dispatch_spans(group, key, "error")
                return self._refused(group, e)[0]
            except (ValueError, TypeError) as e:
                self.errors += 1
                self._end_dispatch_spans(group, key, "error")
                return {"id": item.req.get("id"), "ok": False,
                        "error": str(e)}
            except (RuntimeError, OSError) as e:
                attempt += 1
                if attempt > self.cfg.max_retries:
                    self.transient_failures += 1
                    self._end_dispatch_spans(group, key, "transient")
                    return {"id": item.req.get("id"), "ok": False,
                            "transient": True,
                            "error": "dispatch failed after "
                                     f"{attempt} attempts "
                                     f"({e.__class__.__name__}: {e})"}
                self.retries += 1
                time.sleep(self.cfg.backoff_base_s
                           * (2 ** (attempt - 1)))

    # -- the serve loop ------------------------------------------------

    def queued(self) -> int:
        return len(self._heap)

    def _head_ready(self) -> bool:
        """True when the head bucket has a full batch queued (or the
        head item is long: long scenarios dispatch individually)."""
        if not self._heap:
            return False
        head = self._heap[0][2]
        if self._is_long(head.spec):
            return True
        same = sum(1 for entry in self._heap
                   if entry[2].spec == head.spec)
        return same >= self.cfg.batch

    def dispatch_ready(self, *, force: bool = False,
                       now: float | None = None) -> list[dict]:
        """Cull expired deadlines, then dispatch the head bucket group
        when it is full (``force=True`` dispatches partial groups: the
        drain path).  One call, at most one device dispatch."""
        now = time.monotonic() if now is None else now
        sp = self.obs.spans
        rows = self._cull_deadlines(now)
        if rows:
            self._publish_metrics()
        if not self._heap or not (force or self._head_ready()):
            return rows
        head = self._heap[0][2]
        if self._is_long(head.spec):
            item = heapq.heappop(self._heap)[2]
            if item.trace_id is not None:
                self._h_queue.observe(sp.end(item.trace_id, "queue"))
            row = self._dispatch_long_guarded(item)
            row.setdefault("trace_id", item.trace_id)
            if item.trace_id is not None:
                sp.instant(item.trace_id, "serve",
                           outcome="ok" if row.get("ok") else "error")
            rows.append(row)
            self.served += 1
            self._publish_metrics()
            return rows
        group = self._pop_group()
        if not group:
            return rows
        for item in group:
            if item.trace_id is not None:
                self._h_queue.observe(sp.end(item.trace_id, "queue"))
        try:
            bucket = self._bucket(group[0].spec)
        except plan.SliceRefusal as e:
            got = self._refused(group, e)
        else:
            got = self._submit_with_retry(bucket, group)
        for item, row in zip(group, got):
            row.setdefault("bucket", item.spec.key())
            row["queue_s"] = round(now - item.t_admit, 4)
            row.setdefault("trace_id", item.trace_id)
            if item.trace_id is not None:
                sp.instant(item.trace_id, "serve",
                           outcome="ok" if row.get("ok") else "error")
            rows.append(row)
            self.served += 1
        self._publish_metrics()
        return rows

    def drain(self) -> list[dict]:
        """Dispatch everything still queued (partial groups included)."""
        rows = []
        while self._heap:
            rows.extend(self.dispatch_ready(force=True))
        return rows

    # -- counters ------------------------------------------------------

    def stats(self) -> dict:
        dev = self.wall_device_s
        return {
            "stats": True,
            "admitted": self.admitted, "served": self.served,
            "errors": self.errors, "timeouts": self.timeouts,
            "rejected_overload": self.rejected_overload,
            "transient_failures": self.transient_failures,
            "retries": self.retries,
            "queued": len(self._heap),
            "parked": len(self._parked_raw),
            "buckets": [s.key() for s in self.buckets.specs()],
            "bucket_count": len(self.buckets),
            "traced_buckets": len(self._traced_specs),
            "evictions": self.buckets.evictions,
            "compiles": self.compiles(),
            "long_compiles": self.long_compiles(),
            "long_served": self.long_served,
            "long_resumed": self.long_resumed,
            "aot_loads": self.aot_loads,
            "aot_exports": self.aot_exports,
            "journal_replays": self.journal_replays,
            "traces": self.obs.spans.trace_count(),
            "requests_per_sec": round(self.served / dev, 3) if dev
            else None,
            "wall_s": round(time.perf_counter() - self._t0, 2),
            "device_s": round(dev, 2),
        }

    # -- line protocol (journal + drain; the sweepd shape) -------------

    def _journal_append(self, raw: str, trace_id=None) -> None:
        if self._journal is None:
            return
        parent = os.path.dirname(self._journal)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(self._journal, "a") as f:
            f.write(ck.journal_encode_line(raw) + "\n")
            f.flush()
            os.fsync(f.fileno())
        if trace_id is not None:
            self.obs.spans.instant(trace_id, "journal",
                                   bytes=len(raw))

    def _journal_compact(self) -> None:
        """Rewrite the journal to the still-unserved lines: everything
        queued plus interrupted (parked) long scenarios, atomically (a
        crash mid-compaction must not lose requests)."""
        if self._journal is None:
            return
        from ..artifacts import write_text_atomic
        parent = os.path.dirname(self._journal)
        if parent:
            os.makedirs(parent, exist_ok=True)
        raws = [entry[2].raw for entry in sorted(self._heap)]
        raws += self._parked_raw
        write_text_atomic(self._journal,
                          "".join(ck.journal_encode_line(r) + "\n"
                                  for r in raws))

    def serve_lines(self, lines, out, *, journal: str | None = None,
                    lock=None) -> None:
        """Drive the front end from an iterable of JSON lines, one
        request per line, writing rows to ``out``.  Control lines:
        ``{"cmd": "flush"}`` drains the queue, ``{"cmd": "stats"}`` emits
        the counters row, ``{"cmd": "metrics"}`` emits the registry
        snapshot + span summary; EOF drains.  With ``journal=PATH`` every
        admitted line is CRC-appended before it can dispatch and the
        journal is compacted to the still-unserved lines after every
        dispatch; lines left by a killed server (torn tail lines dropped
        by name) are replayed on entry.  A pending deferred kill drains
        short requests and parks interrupted long ones in the journal for
        the restart to resume.  ``lock`` (a shared ``threading.RLock``)
        serializes line handling when several connection threads drive
        ONE front end (sweepd --multi's thread-per-connection socket
        loop)."""
        import contextlib

        lk = lock if lock is not None else contextlib.nullcontext()
        self._journal = journal

        def emit(obj):
            out.write(json.dumps(obj) + "\n")
            out.flush()

        def emit_all(rows):
            for row in rows:
                emit(row)
            if rows:
                self._journal_compact()

        def dispatch_guard(*, force: bool = False) -> None:
            """One dispatch_ready with interrupt parking: a
            CheckpointInterrupt (deferred kill mid-long-scenario) parks
            the request's journal line for the restart (its snapshot is
            already flushed) and emits the named interruption row."""
            head = self._heap[0][2] if self._heap else None
            try:
                emit_all(self.dispatch_ready(force=force))
            except ck.CheckpointInterrupt as e:
                self._parked_raw.append(head.raw)
                if head.trace_id is not None:
                    self._end_dispatch_spans([head], head.spec.key(),
                                             "interrupted")
                    self.obs.spans.instant(head.trace_id, "park",
                                           ticks_done=e.ticks_done)
                emit({"id": head.req.get("id"), "ok": False,
                      "interrupted": True, "journaled": True,
                      "trace_id": head.trace_id,
                      "error": "interrupted mid-scenario at tick "
                               f"{e.ticks_done}/{e.n_ticks} — "
                               "journaled; a restarted server "
                               "resumes from the snapshot to the "
                               "bit-identical digest"})
                self._journal_compact()
                self._publish_metrics()

        def drain_interruptible() -> None:
            """Drain; interrupted long scenarios park and the rest keeps
            draining."""
            while self._heap:
                dispatch_guard(force=True)

        def handle(raw: str, *, journal_new: bool) -> None:
            try:
                req = json.loads(raw)
            except json.JSONDecodeError as e:
                self.errors += 1
                emit({"ok": False, "error": f"bad JSON: {e}"})
                return
            cmd = req.get("cmd") if isinstance(req, dict) else None
            if cmd == "flush":
                drain_interruptible()
            elif cmd == "stats":
                emit(self.stats())
            elif cmd == "metrics":
                emit({"metrics": True,
                      "families": self.obs.metrics.snapshot(),
                      "spans": self.obs.spans.summary()})
            elif cmd:
                self.errors += 1
                emit({"ok": False,
                      "error": f"unknown cmd {cmd!r} "
                               "(flush/stats/metrics)"})
            else:
                row = self.admit(req, raw=raw)
                if row is not None:
                    emit(row)
                    return
                if journal_new:
                    self._journal_append(raw,
                                         trace_id=self._last_trace_id)
                while self._head_ready():
                    dispatch_guard()

        if journal is not None:
            replay, torn = ck.read_journal(journal)
            if torn:
                print(f"serving: dropping {torn} torn journal "
                      "line(s) (CRC mismatch — the writer died "
                      f"mid-append); replaying the {len(replay)} "
                      "intact line(s)", file=sys.stderr, flush=True)
            if replay:
                print(f"serving: replaying {len(replay)} journaled "
                      "request line(s) from an interrupted run",
                      file=sys.stderr, flush=True)
                with lk:
                    for raw in replay:
                        handle(raw, journal_new=False)
                    self.journal_replays += len(replay)
                    self._journal_compact()
                    self._publish_metrics()

        for line in lines:
            line = line.strip()
            if line:
                with lk:
                    handle(line, journal_new=True)
            if ck.stop_requested():
                print("serving: stop requested — draining queued "
                      "requests and parking interrupted long "
                      "scenarios", file=sys.stderr, flush=True)
                break
        with lk:
            drain_interruptible()
            self._journal_compact()
            emit(self.stats())
