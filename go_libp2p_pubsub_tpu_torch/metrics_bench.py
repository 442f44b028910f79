"""The JAX package's metrics benchmark (``bench_suite.py``
``bench_gossipsub_metrics``), as written, on the port.

Three phases, one artifact (the reference's fields; ``obsstat --check
METRICS_r19.json`` reads it):

* ``fleet``: ``python -m go_libp2p_pubsub_tpu_torch.sweepd --multi
  --socket ... --metrics-port 0`` (64 peers, 1 topic, 2 messages, 4
  ticks, batch 2, 4 buckets) as a child process, served by the port's
  ``loadgen`` fleet (GOSSIP_METRICS_PROCS = 3 processes,
  GOSSIP_METRICS_REQS = 6 requests each) while this process scrapes
  ``/metrics.json`` mid-flight: every scrape must satisfy the accounting
  identity; the closing ``stats`` / ``metrics`` verbs are cross-checked
  against the scrape field by field; ``/trace.json`` must load.
* ``spans``: an in-process front end driven through served, timed-out
  and overload-rejected requests: distinct traces == admissions, every
  trace terminal, no open span, no dropped event, the exported trace
  loads.
* ``delay_parity``: the 64-peer scored step with telemetry, plain against
  identity delays ``DelayConfig(1, 0, 1)`` with ``delays_counters=True``
  (max |diff| over the 11 counter fields must be 0) and against a real
  spread ``DelayConfig(2, 1, 4)`` (its counters must flow).
  ``REFERENCE_PARITY`` holds the JAX package's totals
  (``tests/torch_reference_gate.py --metrics``).

    python -m go_libp2p_pubsub_tpu_torch.metrics_bench [--device cpu]
        [--out metrics.json]
"""

from __future__ import annotations

import argparse
import json
import os
import socket as sk
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

from .device import resolve_device
from .serving import FrontendConfig, ScenarioFrontend

#: the JAX package's delay-parity totals (tests/torch_reference_gate.py
#: --metrics; METRICS_r19.json's)
REFERENCE_PARITY = {"max_abs_diff": 0, "identity_counter_total": 91948,
                    "delayed_counter_total": 51277}

FIELDS = ("payload_sent", "ihave_rpcs", "ihave_ids", "iwant_rpcs",
          "iwant_ids_requested", "iwant_ids_served", "graft_sends",
          "prune_sends", "dup_suppressed", "bytes_payload",
          "bytes_control")

ROOT = Path(__file__).resolve().parents[1]
IDENT_KEYS = ("served_total", "errors_total", "deadline_timeouts_total",
              "transient_failures_total", "queue_depth", "parked")


def _scrape(base_url: str) -> dict:
    with urllib.request.urlopen(base_url + "/metrics.json",
                                timeout=5) as r:
        fams = [json.loads(ln) for ln in r.read().decode().splitlines()]
    vals = {}
    for fam in fams:
        if fam["kind"] == "histogram" or not fam["samples"]:
            vals.setdefault(fam["name"], 0)
            continue
        s = fam["samples"][0]
        if not s["labels"]:
            vals[fam["name"]] = s["value"]
    admitted = vals.get("pubsub_serving_admitted_total", 0)
    accounted = sum(vals.get("pubsub_serving_" + k, 0) for k in IDENT_KEYS)
    return dict({k: vals.get("pubsub_serving_" + k, 0) for k in IDENT_KEYS},
                admitted=admitted, accounted=accounted,
                identity_ok=admitted == accounted)


def fleet(device, procs: int, per_proc: int, work: str) -> tuple:
    """The fleet phase: ``(row, scrapes, cross_check)``."""
    from .loadgen import run_fleet

    dev = resolve_device(device)
    sock_path = os.path.join(work, "sweepd.sock")
    child = subprocess.Popen(
        [sys.executable, "-m", "go_libp2p_pubsub_tpu_torch.sweepd",
         "--multi", "--socket", sock_path, "--metrics-port", "0",
         "--batch", "2", "--peers", "64", "--topics", "1", "--msgs", "2",
         "--ticks", "4", "--max-buckets", "4", "--device", dev.type],
        cwd=ROOT, stderr=subprocess.PIPE, text=True)
    base_url = None
    try:
        for line in child.stderr:
            if "metrics at " in line:
                base_url = (line.strip().split("metrics at ", 1)[1]
                            .rsplit("/metrics", 1)[0])
            if "listening on" in line:
                break
        assert base_url, "sweepd never announced its metrics endpoint"
        threading.Thread(target=child.stderr.read, daemon=True).start()
        box = {}

        def drive():
            box["out"] = run_fleet(sock_path, procs=procs,
                                   requests_per_proc=per_proc,
                                   connect_timeout_s=30.0)

        th = threading.Thread(target=drive)
        th.start()
        scrapes = [dict(_scrape(base_url), mid_flight=True)]
        while th.is_alive():
            time.sleep(0.25)
            scrapes.append(dict(_scrape(base_url), mid_flight=True))
        th.join()
        scrapes.append(dict(_scrape(base_url), mid_flight=False))
        out = box["out"]
        assert not out["worker_failures"], out["worker_failures"]
        sent = out["requests_sent"]
        assert len(out["rows"]) == sent, (len(out["rows"]), sent)
        assert all(s["identity_ok"] for s in scrapes), scrapes

        # the line-protocol stats row against the scrape, field by field
        with sk.socket(sk.AF_UNIX, sk.SOCK_STREAM) as s:
            s.connect(sock_path)
            with s.makefile("r") as rf, s.makefile("w") as wf:
                wf.write('{"cmd": "stats"}\n{"cmd": "metrics"}\n')
                wf.flush()
                s.shutdown(sk.SHUT_WR)
                proto = [json.loads(ln) for ln in rf if ln.strip()]
        stats_row = next(r for r in proto if r.get("stats"))
        met_row = next(r for r in proto if r.get("metrics"))
        fam_map = {f["name"]: f for f in met_row["families"]}

        def fam_val(name):
            smp = fam_map["pubsub_" + name]["samples"]
            return smp[0]["value"] if smp else 0

        pairs = {"admitted": "serving_admitted_total",
                 "served": "serving_served_total",
                 "errors": "serving_errors_total",
                 "timeouts": "serving_deadline_timeouts_total",
                 "transient_failures": "serving_transient_failures_total",
                 "rejected_overload": "serving_overload_rejected_total",
                 "retries": "serving_retries_total",
                 "queued": "serving_queue_depth",
                 "parked": "serving_parked"}
        cross = {k: {"stats": stats_row[k], "scrape": fam_val(v)}
                 for k, v in pairs.items()}
        cross_match = all(v["stats"] == v["scrape"] for v in cross.values())
        spans_match = (met_row["spans"]["traces"] == stats_row["admitted"]
                       == sent)
        assert cross_match, cross
        assert spans_match, (met_row["spans"], stats_row["admitted"], sent)
        with urllib.request.urlopen(base_url + "/trace.json",
                                    timeout=5) as r:
            trace = json.loads(r.read().decode())
        assert trace["traceEvents"], "empty live Chrome trace"
    finally:
        child.terminate()
        try:
            child.wait(timeout=30)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait(timeout=30)
    row = {
        "procs": procs, "requests_sent": sent,
        "rows_received": len(out["rows"]), "ok": out["ok"],
        "error_rows": out["errors"], "rps": out["rps"],
        "wall_s": out["wall_s"], "scrape_count": len(scrapes),
        "mid_flight_scrapes": sum(1 for s in scrapes if s["mid_flight"]),
        "identity_ok": all(s["identity_ok"] for s in scrapes),
        "cross_match": cross_match, "spans_match": spans_match,
        "trace_events": len(trace["traceEvents"]),
        "server_exit_code": child.returncode,
    }
    return row, scrapes, cross


def spans(device, work: str) -> dict:
    """The span phase: served, timed-out and rejected, in-process."""
    dev = resolve_device(device)
    fe = ScenarioFrontend(FrontendConfig(
        max_buckets=2, batch=2, queue_cap=6,
        server_kw={"seed": 0, "device": str(dev)}))
    span_rows = []
    for i in range(10):
        req = {"id": f"s{i}", "n": 64, "t": 1, "m": 2, "ticks": 4,
               "seed": i}
        if i in (4, 5):
            req["deadline_s"] = 0.0    # culled at the next dispatch
        rej = fe.admit(req)
        if rej is not None:
            span_rows.append(rej)
        if i % 4 == 3:
            time.sleep(0.01)
            span_rows.extend(fe.dispatch_ready(force=True))
    span_rows.extend(fe.drain())
    st = fe.stats()
    summ = fe.obs.spans.summary()
    trace_path = os.path.join(work, "metrics_trace.json")
    fe.obs.spans.write_chrome_trace(trace_path)
    with open(trace_path) as f:
        exported = json.load(f)
    rejected = sum(1 for r in span_rows if r.get("overloaded"))
    row = {
        "requests": 10, "admitted": st["admitted"],
        "served": st["served"], "timeouts": st["timeouts"],
        "rejected_overload": st["rejected_overload"],
        "traces": summ["traces"], "terminal": summ["terminal"],
        "open_spans": summ["open_spans"],
        "dropped_events": summ["dropped_events"],
        "phases": summ["phases"],
        "exported_events": len(exported["traceEvents"]),
        "trace_path": trace_path,
    }
    assert summ["traces"] == st["admitted"] == 10 - rejected, row
    assert summ["terminal"] == st["admitted"], row
    assert summ["open_spans"] == 0 == summ["dropped_events"], row
    assert st["timeouts"] > 0, row
    return row


def counter_totals(device, delays) -> np.ndarray:
    """[ticks, 11] counter totals of the 64-peer scored step with
    telemetry (delay-armed with counters where ``delays``)."""
    from .models import gossipsub as gs
    from .models import telemetry as tl

    dev = resolve_device(device)
    pn, pt, pm, pticks = 64, 2, 4, 6
    subs = np.zeros((pn, pt), dtype=bool)
    subs[np.arange(pn), np.arange(pn) % pt] = True
    rng = np.random.default_rng(0)
    ptopic = rng.integers(0, pt, pm)
    porigin = rng.integers(0, pn // pt, pm) * pt + ptopic
    ptks = np.zeros(pm, dtype=np.int32)
    pcfg = gs.GossipSimConfig(
        offsets=gs.make_gossip_offsets(pt, 8, pn, seed=1),
        n_topics=pt, d=3, d_lo=2, d_hi=6, d_score=2, d_out=1,
        d_lazy=2, backoff_ticks=8)
    psc = gs.ScoreSimConfig()
    kw = dict(score_cfg=psc, delays=delays)
    if delays is not None:
        kw["delays_counters"] = True
    params, state = gs.make_gossip_sim(pcfg, subs, ptopic, porigin, ptks,
                                       device=dev, **kw)
    step = gs.make_gossip_step(pcfg, psc, telemetry=tl.TelemetryConfig(),
                               device=dev)
    out = []
    for _ in range(pticks):
        state, _d, frame = step(params, state)
        out.append(np.array([int(getattr(frame, f).sum()) for f in FIELDS],
                            dtype=np.int64))
    return np.stack(out)


def delay_parity(device=None) -> dict:
    """The delay-parity phase: its row.  Raises if a gate fails."""
    from .models.delays import DelayConfig

    dev = resolve_device(device)
    t0 = time.perf_counter()
    ref = counter_totals(dev, None)
    idn = counter_totals(dev, DelayConfig(base=1, jitter=0, k_slots=1))
    spread = counter_totals(dev, DelayConfig(base=2, jitter=1, k_slots=4))
    row = {
        "fields": len(FIELDS), "ticks": int(ref.shape[0]),
        "max_abs_diff": int(np.abs(ref - idn).max()),
        "identity_counter_total": int(idn.sum()),
        "delayed_counter_total": int(spread.sum()),
        "wall_s": round(time.perf_counter() - t0, 2),
    }
    assert row["max_abs_diff"] == 0, row
    assert spread.sum() > 0, row
    return row


def run(device=None, procs: int | None = None,
        per_proc: int | None = None, hook=None) -> dict:
    """The row as written: its artifact (the reference's fields).
    ``hook(phase)``, where given, is a context manager entered around
    each phase.  Raises if a gate fails."""
    import contextlib
    import shutil

    hook = hook or (lambda phase: contextlib.nullcontext())
    dev = resolve_device(device)
    procs = procs or int(os.environ.get("GOSSIP_METRICS_PROCS", 3))
    per_proc = per_proc or int(os.environ.get("GOSSIP_METRICS_REQS", 6))
    work = tempfile.mkdtemp(prefix="metrics_bench_")
    try:
        with hook("fleet"):
            fleet_row, scrapes, cross = fleet(dev, procs, per_proc, work)
        with hook("spans"):
            span_row = spans(dev, work)
        with hook("delay_parity"):
            parity = delay_parity(dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {
        "round": 19,
        "platform": dev.type,
        "hardware_queued": False,
        "fleet": fleet_row,
        "scrapes": scrapes,
        "cross_check": cross,
        "spans": span_row,
        "delay_parity": parity,
        "rows": [
            dict({"id": "fleet"}, **fleet_row),
            dict({"id": "spans"}, **span_row),
            dict({"id": "delay_parity"}, **parity),
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m go_libp2p_pubsub_tpu_torch.metrics_bench",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", metavar="PATH",
                    help="write the row's artifact here (obsstat reads it)")
    ns = ap.parse_args(argv)
    dev = resolve_device(ns.device)
    art = run(dev)
    if ns.out:
        from .artifacts import write_json_atomic
        write_json_atomic(ns.out, art)
    par = art["delay_parity"]
    out = {"metrics": art, "parity_equals_reference": all(
        par[k] == v for k, v in REFERENCE_PARITY.items())}
    if dev.type == "cuda":
        from .flagship import card
        out["card"] = card()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
