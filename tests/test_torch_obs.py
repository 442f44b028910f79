"""The port's observability plane (``go_libp2p_pubsub_tpu_torch/obs``):
the registry, span and scrape tests of the JAX package's
``tests/test_obs.py`` on the port's copies, and the same instruments
rendered by both packages to the same Prometheus text and JSON lines.

The front end's tests (its accounting identity, mid-flight scrapes, the
frontend's journal counter) wait for the serving slice; the sweep
server's ``metrics`` verb is in ``tests/test_torch_sweepd.py``.
"""

import json
import threading
import time

import pytest

from go_libp2p_pubsub_tpu_torch.obs import (
    MetricsRegistry,
    Observability,
    SpanRecorder,
)
from torch_ref import imported_reference


def test_counter_monotonic():
    m = MetricsRegistry("t")
    c = m.counter("reqs_total")
    c.inc()
    c.inc(4)
    assert c.value() == 5
    c.set_total(9)
    assert c.value() == 9
    with pytest.raises(ValueError, match="cannot decrease"):
        c.inc(-1)
    with pytest.raises(ValueError, match="cannot decrease"):
        c.set_total(3)


def test_gauge_and_labels():
    m = MetricsRegistry("t")
    g = m.gauge("depth")
    g.set(7, bucket="a")
    g.add(-2, bucket="a")
    g.set(1, bucket="b")
    assert g.value(bucket="a") == 5
    assert g.value(bucket="b") == 1
    assert g.value(bucket="zzz") == 0
    with pytest.raises(ValueError, match="bad label name"):
        g.set(1, **{"bad-label": "x"})


def test_histogram_buckets_fixed_and_cumulative_render():
    m = MetricsRegistry("t")
    h = m.histogram("lat", (0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    prom = m.render_prometheus()
    assert 't_lat_bucket{le="0.1"} 1' in prom
    assert 't_lat_bucket{le="1.0"} 3' in prom
    assert 't_lat_bucket{le="10.0"} 4' in prom
    assert 't_lat_bucket{le="+Inf"} 5' in prom
    assert "t_lat_count 5" in prom
    with pytest.raises(ValueError, match="strictly-increasing"):
        m.histogram("bad", (1.0, 1.0))
    with pytest.raises(ValueError, match="strictly-increasing"):
        m.histogram("bad2", ())


def test_registration_idempotent_kind_clash_named():
    m = MetricsRegistry("t")
    assert m.counter("x_total") is m.counter("x_total")
    with pytest.raises(ValueError, match="already registered"):
        m.gauge("x_total")
    with pytest.raises(ValueError, match="bad metric name"):
        m.counter("9starts-with-digit")
    with pytest.raises(ValueError, match="bad namespace"):
        MetricsRegistry("no spaces")


def test_atomic_snapshot_all_or_nothing():
    """A scraper racing an atomic() update block must never see the
    identity broken: writer keeps a == b under the lock; reader
    snapshots concurrently and checks every observation."""
    m = MetricsRegistry("t")
    a, b = m.counter("a_total"), m.counter("b_total")
    stop = threading.Event()
    broken = []

    def reader():
        while not stop.is_set():
            snap = {f["name"]: f for f in m.snapshot()}
            va = (snap["t_a_total"]["samples"] or
                  [{"value": 0}])[0]["value"]
            vb = (snap["t_b_total"]["samples"] or
                  [{"value": 0}])[0]["value"]
            if va != vb:
                broken.append((va, vb))
    th = threading.Thread(target=reader)
    th.start()
    for i in range(300):
        with m.atomic():
            a.inc()
            b.inc()
    stop.set()
    th.join()
    assert not broken, broken[:3]
    assert a.value() == b.value() == 300


def test_prometheus_label_escaping_and_json_agreement():
    m = MetricsRegistry("t")
    m.counter("c_total").inc(2, path='a"b\\c')
    prom = m.render_prometheus()
    assert 't_c_total{path="a\\"b\\\\c"} 2' in prom
    fams = [json.loads(ln) for ln in
            m.render_json_lines().splitlines()]
    assert fams[0]["name"] == "t_c_total"
    assert fams[0]["samples"][0]["value"] == 2
    assert fams[0]["samples"][0]["labels"] == {"path": 'a"b\\c'}


# --------------------------------------------------------------------------
# spans
# --------------------------------------------------------------------------


def test_span_lifecycle_and_chrome_export(tmp_path):
    rec = SpanRecorder()
    tid = rec.new_trace_id("req/1")
    assert "/" not in tid
    rec.instant(tid, "admit")
    rec.begin(tid, "queue")
    time.sleep(0.002)
    dur = rec.end(tid, "queue")
    assert dur >= 0.002
    rec.instant(tid, "serve", outcome="ok")
    summ = rec.summary()
    assert summ["traces"] == 1 and summ["open_spans"] == 0
    assert summ["phases"] == {"admit": 1, "queue": 1, "serve": 1}
    assert summ["terminal"] == 1
    path = tmp_path / "trace.json"
    rec.write_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    assert len(trace["traceEvents"]) == 3
    x = next(e for e in trace["traceEvents"] if e["ph"] == "X")
    assert x["name"] == "queue" and x["dur"] >= 2000
    assert x["args"]["trace_id"] == tid


def test_span_end_without_begin_never_crashes():
    rec = SpanRecorder()
    assert rec.end("ghost-0", "dispatch") == 0.0
    assert rec.summary()["phases"] == {"dispatch": 1}


def test_span_capacity_drops_are_counted():
    rec = SpanRecorder(capacity=5)
    for i in range(8):
        rec.instant(f"t-{i}", "admit")
    summ = rec.summary()
    assert summ["events"] == 5 and summ["dropped_events"] == 3
    assert rec.chrome_trace()["otherData"]["dropped_events"] == 3


# --------------------------------------------------------------------------
# scrape server
# --------------------------------------------------------------------------


def test_scrape_server_endpoints():
    import urllib.request
    o = Observability(namespace="t")
    o.metrics.counter("up_total").inc()
    o.spans.instant(o.spans.new_trace_id("r"), "admit")
    srv = o.scrape_server(port=0)
    try:
        with urllib.request.urlopen(srv.url("/metrics")) as r:
            assert b"t_up_total 1" in r.read()
        with urllib.request.urlopen(srv.url("/metrics.json")) as r:
            fams = [json.loads(ln) for ln in
                    r.read().decode().splitlines()]
            assert any(f["name"] == "t_up_total" for f in fams)
        with urllib.request.urlopen(srv.url("/trace.json")) as r:
            assert len(json.loads(r.read())["traceEvents"]) == 1
        with urllib.request.urlopen(srv.url("/healthz")) as r:
            assert r.status == 204
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(srv.url("/nope"))
    finally:
        srv.close()


def _fill(mod):
    m = mod.MetricsRegistry("t")
    m.counter("reqs_total", "requests").inc(3, path='a"b')
    m.gauge("depth").set(7, bucket="x")
    h = m.histogram("lat", (0.1, 1.0, 10.0), "latency")
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v, kind="k")
    return m


def test_renders_equal_the_references():
    """One sequence of updates, both packages: the same Prometheus text and
    the same JSON lines."""
    import go_libp2p_pubsub_tpu_torch.obs as pobs
    with imported_reference():
        import go_libp2p_pubsub_tpu.obs as robs
        want = _fill(robs)
        want_prom, want_json = want.render_prometheus(), \
            want.render_json_lines()
    got = _fill(pobs)
    assert got.render_prometheus() == want_prom
    assert got.render_json_lines() == want_json
