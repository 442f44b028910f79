"""Per-request spans with propagated trace ids (the port's copy of the
JAX package's).

``SpanRecorder`` gives every admitted request a ``trace_id`` that
rides its queue item and its result row, and records the request's
lifecycle as named phases::

    admit -> queue -> pad -> dispatch -> serve        (short path)
    admit -> queue -> dispatch -> serve | park        (long path)
    ... plus journal instants wherever the raw line is persisted

Durations are wall-clock (``time.perf_counter``); the export is the
Chrome trace-event JSON format (``{"traceEvents": [...]}``, complete
``"X"`` events in microseconds) so a single request is debuggable end
to end in ``chrome://tracing`` / Perfetto, and the per-bucket
device-dispatch wall timing is right there as the ``dispatch`` span's
``args.bucket``.

Thread-safe (one lock); bounded (``capacity`` events, oldest dropped
with a counted ``dropped_events`` so truncation is never silent).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import zlib
from contextlib import contextmanager

__all__ = ["SpanRecorder"]

#: the request-lifecycle phases in order (the obsstat coverage check
#: asserts one ``admit`` per admitted request and a terminal event —
#: ``serve`` / ``park`` — for every trace that left the queue)
PHASES = ("admit", "queue", "pad", "dispatch", "serve", "park",
          "journal")

TERMINAL = ("serve", "park")


class SpanRecorder:
    def __init__(self, capacity: int = 100_000,
                 clock=time.perf_counter):
        self._lock = threading.Lock()
        self._clock = clock
        self.capacity = capacity
        self._events: list[dict] = []
        self._open: dict = {}           # (trace_id, name) -> (t0, args)
        self._seq = itertools.count()
        self.dropped_events = 0
        self.phase_counts: dict[str, int] = {}
        self._traces: set = set()

    # -- trace ids -----------------------------------------------------

    def new_trace_id(self, hint=None) -> str:
        n = next(self._seq)
        tag = str(hint) if hint is not None else "req"
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in tag)[:48] or "req"
        return f"{safe}-{n:06d}"

    # -- recording -----------------------------------------------------

    def _push(self, ev: dict) -> None:
        self._traces.add(ev["args"]["trace_id"])
        name = ev["name"]
        self.phase_counts[name] = self.phase_counts.get(name, 0) + 1
        if len(self._events) >= self.capacity:
            self._events.pop(0)
            self.dropped_events += 1
        self._events.append(ev)

    def _event(self, trace_id, name, ph, ts, dur=None, **args):
        ev = {"name": name, "cat": "serving", "ph": ph,
              "ts": int(ts * 1e6), "pid": os.getpid(),
              "tid": zlib.crc32(str(trace_id).encode()) & 0x7FFFFFFF,
              "args": dict(args, trace_id=trace_id)}
        if dur is not None:
            ev["dur"] = max(int(dur * 1e6), 0)
        return ev

    def begin(self, trace_id, name, **args) -> None:
        with self._lock:
            self._open[(trace_id, name)] = (self._clock(), args)

    def end(self, trace_id, name, **more) -> float:
        """Close an open span; returns its duration in seconds.
        Ending a span that was never begun records a zero-length span
        (visible, not a crash — the recorder must never take the
        serving path down)."""
        now = self._clock()
        with self._lock:
            t0, args = self._open.pop((trace_id, name), (now, {}))
            self._push(self._event(trace_id, name, "X", t0,
                                   dur=now - t0, **dict(args, **more)))
            return now - t0

    @contextmanager
    def span(self, trace_id, name, **args):
        self.begin(trace_id, name, **args)
        try:
            yield
        finally:
            self.end(trace_id, name)

    def instant(self, trace_id, name, **args) -> None:
        with self._lock:
            ev = self._event(trace_id, name, "i", self._clock(),
                             **args)
            ev["s"] = "t"   # thread-scoped instant
            self._push(ev)

    # -- accounting / export -------------------------------------------

    def trace_count(self) -> int:
        with self._lock:
            return len(self._traces)

    def open_spans(self) -> int:
        with self._lock:
            return len(self._open)

    def summary(self) -> dict:
        """The artifact row obsstat checks: per-phase counts, distinct
        traces, terminal coverage, and the never-silent drop/open
        tallies."""
        with self._lock:
            phases = dict(self.phase_counts)
            return {
                "traces": len(self._traces),
                "events": len(self._events),
                "phases": phases,
                "terminal": sum(phases.get(p, 0) for p in TERMINAL),
                "open_spans": len(self._open),
                "dropped_events": self.dropped_events,
            }

    def chrome_trace(self) -> dict:
        with self._lock:
            return {"traceEvents": [dict(ev) for ev in self._events],
                    "displayTimeUnit": "ms",
                    "otherData": {"recorder": "go_libp2p_pubsub_tpu_torch",
                                  "dropped_events":
                                      self.dropped_events}}

    def write_chrome_trace(self, path: str) -> None:
        from ..artifacts import write_text_atomic
        write_text_atomic(path, json.dumps(self.chrome_trace()))
