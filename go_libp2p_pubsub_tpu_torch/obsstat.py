"""obsstat: inspect a metrics bench artifact and gate the observability
claims against a committed baseline (the port's copy of the JAX
package's ``tools/obsstat.py``).

    python -m go_libp2p_pubsub_tpu_torch.obsstat metrics.json
    python -m go_libp2p_pubsub_tpu_torch.obsstat metrics.json \
        --check METRICS_r19.json [--rps-slack 0.5]

Prints the fleet/spans/delay-parity summary rows.  Exit codes (the
servestat --check convention):

  0  clean
  1  regression: a scrape — including a MID-FLIGHT one taken during
     the concurrent client burst — where the accounting identity
     (admitted == served + errors + timeouts + transient + queued +
     parked) fails, a stats-vs-scrape cross-check mismatch, a span
     ledger that lost a request (distinct traces != admissions, a
     trace without a terminal event, open spans or dropped events
     after the drain), a fleet that received fewer terminal rows than
     it sent, an empty Chrome trace, a delay-armed counter parity
     diff != 0 (the lifted counters-group refusal), or (with --check)
     fleet throughput dropping more than ``--rps-slack`` below the
     committed baseline / span-phase coverage shrinking below it
  2  unusable input: missing/unparseable artifact, no summary rows,
     or no scrape/span sections (the observability claims can't be
     checked)
"""

from __future__ import annotations

import argparse
import json
import sys


def load(path: str) -> dict:
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"obsstat: cannot read {path}: {e}", file=sys.stderr)
        raise SystemExit(2)
    if not obj.get("rows"):
        print(f"obsstat: {path} carries no summary rows",
              file=sys.stderr)
        raise SystemExit(2)
    if not obj.get("scrapes") or not obj.get("spans"):
        print(f"obsstat: {path} carries no scrape/span sections — "
              "the observability claims cannot be checked",
              file=sys.stderr)
        raise SystemExit(2)
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m go_libp2p_pubsub_tpu_torch.obsstat",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("artifact")
    ap.add_argument("--check", metavar="BASELINE",
                    help="committed baseline artifact to gate against")
    ap.add_argument("--rps-slack", type=float, default=0.5,
                    help="allowed fractional fleet-throughput drop vs "
                         "baseline (default 0.5; CPU/TPU passes share "
                         "one artifact schema)")
    ns = ap.parse_args(argv)

    cur = load(ns.artifact)
    rc = 0
    for row in cur["rows"]:
        bits = " ".join(f"{k}={v}" for k, v in row.items()
                        if k not in ("id", "phases"))
        print(f"  {str(row.get('id')):<14s} {bits}")

    # -- scrape identity (every scrape, mid-flight included) ----------
    bad = [i for i, s in enumerate(cur["scrapes"])
           if not s.get("identity_ok")]
    if bad:
        print(f"obsstat: {len(bad)} scrape(s) broke the accounting "
              f"identity (first at index {bad[0]}: "
              f"{cur['scrapes'][bad[0]]}) — a silent drop was "
              "VISIBLE on the wire", file=sys.stderr)
        rc = 1
    mid = sum(1 for s in cur["scrapes"] if s.get("mid_flight"))
    if mid < 1:
        print("obsstat: no mid-flight scrape was taken — the "
              "concurrent-burst identity claim was not exercised",
              file=sys.stderr)
        rc = 1

    # -- fleet accounting from the client side ------------------------
    fleet = cur.get("fleet", {})
    if fleet.get("rows_received") != fleet.get("requests_sent"):
        print(f"obsstat: the fleet sent {fleet.get('requests_sent')} "
              f"requests but received {fleet.get('rows_received')} "
              "terminal rows — requests went missing", file=sys.stderr)
        rc = 1
    if not fleet.get("cross_match"):
        print("obsstat: the live scrape disagrees with the front "
              "end's own stats row (cross_check)", file=sys.stderr)
        rc = 1
    if not fleet.get("spans_match"):
        print("obsstat: live span count != admissions on the "
              "resident server", file=sys.stderr)
        rc = 1
    if not fleet.get("trace_events"):
        print("obsstat: the live /trace.json export was empty",
              file=sys.stderr)
        rc = 1
    for k, v in (cur.get("cross_check") or {}).items():
        if v.get("stats") != v.get("scrape"):
            print(f"obsstat: cross-check field {k}: stats="
                  f"{v.get('stats')} vs scrape={v.get('scrape')}",
                  file=sys.stderr)
            rc = 1

    # -- span ledger ---------------------------------------------------
    spans = cur["spans"]
    if spans.get("traces") != spans.get("admitted"):
        print(f"obsstat: {spans.get('traces')} distinct traces for "
              f"{spans.get('admitted')} admissions — a request ran "
              "without a trace (or a rejection got one)",
              file=sys.stderr)
        rc = 1
    if spans.get("terminal") != spans.get("admitted"):
        print(f"obsstat: {spans.get('terminal')} terminal span "
              f"events for {spans.get('admitted')} admissions — a "
              "request's lifecycle never closed", file=sys.stderr)
        rc = 1
    if spans.get("open_spans") or spans.get("dropped_events"):
        print(f"obsstat: open_spans={spans.get('open_spans')} "
              f"dropped_events={spans.get('dropped_events')} after "
              "the drain — the span ledger is lossy", file=sys.stderr)
        rc = 1
    if not spans.get("exported_events"):
        print("obsstat: the exported Chrome trace carries no events",
              file=sys.stderr)
        rc = 1

    # -- delay-armed counter parity (the lifted refusal) --------------
    par = cur.get("delay_parity", {})
    if par.get("max_abs_diff", 1) != 0:
        print(f"obsstat: delay-armed counter parity diff "
              f"{par.get('max_abs_diff')} != 0 — identity delays "
              "changed a telemetry counter", file=sys.stderr)
        rc = 1
    if not par.get("delayed_counter_total"):
        print("obsstat: the delayed run counted nothing — the "
              "delay-armed counter path is dead", file=sys.stderr)
        rc = 1

    if ns.check:
        base = load(ns.check)
        b_fleet = base.get("fleet", {})
        rps_cur, rps_base = fleet.get("rps"), b_fleet.get("rps")
        if rps_cur is not None and rps_base:
            floor = rps_base * (1.0 - ns.rps_slack)
            verdict = "OK" if rps_cur >= floor else "REGRESSED"
            print(f"check: fleet rps {rps_cur:.2f} vs baseline "
                  f"{rps_base:.2f} (floor {floor:.2f}) -> {verdict}")
            if rps_cur < floor:
                rc = 1
        b_phases = set((base["spans"].get("phases") or {}))
        c_phases = set((spans.get("phases") or {}))
        if not b_phases <= c_phases:
            print("obsstat: span phase coverage shrank vs baseline: "
                  f"missing {sorted(b_phases - c_phases)}",
                  file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
