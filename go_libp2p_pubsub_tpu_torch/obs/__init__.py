"""Service observability plane: the port's copy of the JAX package's
``obs/`` (pure host Python, no device work).

Three pieces, one bundle:

* ``MetricsRegistry`` (metrics.py) — host counters / gauges /
  fixed-bucket histograms with atomic snapshot semantics, rendered as
  Prometheus text or JSON lines.
* ``SpanRecorder`` (spans.py) — per-request lifecycle spans with a
  propagated ``trace_id``, exported as Chrome trace-event JSON.
* ``ScrapeServer`` (scrape.py) — the loopback HTTP endpoint
  (``sweepd --metrics-port``).

``Observability`` bundles a registry + recorder so the serving stack
passes ONE handle around; it is cheap enough to be always-on (pure
host Python — device-side observability stays in models/telemetry.py).
"""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .scrape import ScrapeServer
from .spans import SpanRecorder

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "Observability", "ScrapeServer", "SpanRecorder"]


class Observability:
    """One registry + one span recorder; ``scrape_server()`` wires
    them into an HTTP endpoint on demand."""

    def __init__(self, namespace: str = "pubsub",
                 span_capacity: int = 100_000):
        self.metrics = MetricsRegistry(namespace)
        self.spans = SpanRecorder(capacity=span_capacity)

    def scrape_server(self, *, host: str = "127.0.0.1",
                      port: int = 0) -> ScrapeServer:
        return ScrapeServer(self.metrics, self.spans, host=host,
                            port=port).start()
