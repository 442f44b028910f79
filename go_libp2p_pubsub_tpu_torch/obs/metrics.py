"""The host-side metrics registry (the port's copy of the JAX package's).

One process-local registry of named instruments — counters, gauges,
and fixed-bucket histograms — with ATOMIC snapshot semantics: every
mutation takes the registry's RLock, ``atomic()`` exposes the same
lock for multi-instrument updates, and ``snapshot()`` reads under it.
A scraper therefore never observes a half-applied update group: the
serving front end publishes its whole accounting vector (admitted /
served / errors / timeouts / transient / queued / parked) in one
``atomic()`` block, so the no-silent-drop identity holds on EVERY
scrape, including mid-flight ones during a concurrent burst.

Two render surfaces, one snapshot:

* ``render_prometheus()`` — the Prometheus text exposition format
  (``# HELP`` / ``# TYPE`` / samples, histograms as cumulative
  ``_bucket{le=...}`` + ``_sum`` + ``_count``).
* ``render_json_lines()`` — one JSON object per metric family, the
  line-protocol / artifact form (``{"cmd": "metrics"}``).

Instruments are host Python only — device counters stay in
models/telemetry.py frames; this registry is where those frames and
the serving counters become scrapeable.
"""

from __future__ import annotations

import json
import re
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _label_key(labels: dict) -> tuple:
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"metrics: bad label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Instrument:
    """Base: a named family holding one value per label set."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str,
                 help: str):
        self._reg = registry
        self.name = name
        self.help = help
        self._values: dict = {}

    def value(self, **labels):
        with self._reg._lock:
            return self._values.get(_label_key(labels), 0)

    def _samples(self):
        """Snapshot rows under the registry lock (caller holds it)."""
        return [{"labels": dict(key), "value": v}
                for key, v in sorted(self._values.items())]


class Counter(_Instrument):
    """Monotonic counter.  ``inc`` adds; ``set_total`` publishes an
    externally-maintained monotonic total (the mirroring form the
    serving front end uses so its whole accounting vector lands in one
    ``atomic()`` block)."""

    kind = "counter"

    def inc(self, v: float = 1, **labels) -> None:
        if v < 0:
            raise ValueError(
                f"metrics: counter {self.name} cannot decrease "
                f"(inc({v}))")
        key = _label_key(labels)
        with self._reg._lock:
            self._values[key] = self._values.get(key, 0) + v

    def set_total(self, v: float, **labels) -> None:
        key = _label_key(labels)
        with self._reg._lock:
            if v < self._values.get(key, 0):
                raise ValueError(
                    f"metrics: counter {self.name} cannot decrease "
                    f"(set_total {v} < {self._values.get(key, 0)})")
            self._values[key] = v


class Gauge(_Instrument):
    """Point-in-time value (queue depth, resident buckets, ...)."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        with self._reg._lock:
            self._values[_label_key(labels)] = v

    def add(self, v: float = 1, **labels) -> None:
        key = _label_key(labels)
        with self._reg._lock:
            self._values[key] = self._values.get(key, 0) + v


class Histogram(_Instrument):
    """Fixed-bucket histogram: upper bounds set at registration (the
    in-scan telemetry convention — no dynamic rebucketing), per-label
    cumulative counts rendered Prometheus-style."""

    kind = "histogram"

    def __init__(self, registry, name, help, buckets):
        super().__init__(registry, name, help)
        ub = tuple(float(b) for b in buckets)
        if not ub or list(ub) != sorted(set(ub)):
            raise ValueError(
                f"metrics: histogram {name} buckets must be a "
                f"non-empty strictly-increasing sequence, got "
                f"{buckets!r}")
        self.buckets = ub

    def observe(self, v: float, **labels) -> None:
        key = _label_key(labels)
        with self._reg._lock:
            row = self._values.get(key)
            if row is None:
                row = self._values[key] = {
                    "counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0, "count": 0}
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    row["counts"][i] += 1
                    break
            else:
                row["counts"][-1] += 1
            row["sum"] += float(v)
            row["count"] += 1

    def _samples(self):
        out = []
        for key, row in sorted(self._values.items()):
            out.append({"labels": dict(key),
                        "buckets": list(self.buckets),
                        "counts": list(row["counts"]),
                        "sum": row["sum"], "count": row["count"]})
        return out


class MetricsRegistry:
    """See the module docstring."""

    def __init__(self, namespace: str = "pubsub"):
        if namespace and not _NAME_RE.match(namespace):
            raise ValueError(
                f"metrics: bad namespace {namespace!r}")
        self.namespace = namespace
        self._lock = threading.RLock()
        self._metrics: dict[str, _Instrument] = {}

    def atomic(self):
        """The registry lock as a context manager: updates applied
        inside one ``with registry.atomic():`` block are visible to
        ``snapshot()`` all-or-nothing."""
        return self._lock

    # -- registration (idempotent by name; kind clashes are errors) ----

    def _register(self, cls, name, help, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"metrics: bad metric name {name!r}")
        with self._lock:
            got = self._metrics.get(name)
            if got is not None:
                if type(got) is not cls:
                    raise ValueError(
                        f"metrics: {name} already registered as "
                        f"{got.kind}, not {cls.kind}")
                return got
            inst = cls(self, name, help, **kw)
            self._metrics[name] = inst
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, buckets, help: str = ""
                  ) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    # -- snapshot + renders --------------------------------------------

    def snapshot(self) -> list[dict]:
        """Atomic point-in-time copy of every family: one dict per
        metric, ``{"name", "kind", "help", "samples": [...]}``."""
        with self._lock:
            return [{"name": self._full(m.name), "kind": m.kind,
                     "help": m.help, "samples": m._samples()}
                    for m in self._metrics.values()]

    def _full(self, name: str) -> str:
        return f"{self.namespace}_{name}" if self.namespace else name

    def render_json_lines(self) -> str:
        return "".join(json.dumps(fam, sort_keys=True) + "\n"
                       for fam in self.snapshot())

    def render_prometheus(self) -> str:
        out = []
        for fam in self.snapshot():
            name = fam["name"]
            if fam["help"]:
                out.append(f"# HELP {name} {fam['help']}")
            out.append(f"# TYPE {name} {fam['kind']}")
            for s in fam["samples"]:
                if fam["kind"] == "histogram":
                    cum = 0
                    for ub, c in zip(s["buckets"] + ["+Inf"],
                                     s["counts"]):
                        cum += c
                        lb = dict(s["labels"], le=str(ub))
                        out.append(f"{name}_bucket{_lbl(lb)} {cum}")
                    out.append(
                        f"{name}_sum{_lbl(s['labels'])} {s['sum']}")
                    out.append(
                        f"{name}_count{_lbl(s['labels'])} "
                        f"{s['count']}")
                else:
                    out.append(f"{name}{_lbl(s['labels'])} "
                               f"{s['value']}")
        return "\n".join(out) + "\n"


def _esc(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _lbl(labels: dict) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{_esc(v)}"'
                    for k, v in sorted(labels.items()))
    return "{" + body + "}"
