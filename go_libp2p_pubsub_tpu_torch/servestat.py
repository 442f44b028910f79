"""servestat: inspect a serving-front-end bench artifact and gate the
fault-tolerance claims against a committed baseline (the port's copy of
the JAX package's ``tools/servestat.py``).

    python -m go_libp2p_pubsub_tpu_torch.servestat serving.json
    python -m go_libp2p_pubsub_tpu_torch.servestat serving.json \
        --check SERVE_r18.json [--rps-slack 0.5] [--p99-slack 3.0]

Prints the load/overload/kill-recovery/cold-start summary rows.
Exit codes (tracestat/tourneystat --check convention):

  0  clean
  1  regression: compile count != traced bucket count (the
     multi-tenant zero-recompile claim), a request unaccounted for
     (served + errors + timeouts + rejections + queued must equal
     admissions — silent drops are the one unforgivable failure), an
     overload phase that produced NO explicit rejection rows, a
     kill-recovery digest mismatch (a resumed long scenario must be
     bit-identical), an AOT cold start that still registered a
     runner, or (with --check) throughput dropping more than
     ``--rps-slack`` below / p99 queue latency growing more than
     ``--p99-slack`` above the committed baseline
  2  unusable input: missing/unparseable artifact, no summary rows,
     or no compile counter (the bucketed-compile claim can't be
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
        print(f"servestat: cannot read {path}: {e}", file=sys.stderr)
        raise SystemExit(2)
    if not obj.get("rows"):
        print(f"servestat: {path} carries no summary rows",
              file=sys.stderr)
        raise SystemExit(2)
    if "compiles" not in obj or obj.get("compiles") is None:
        print(f"servestat: {path} carries no compile counter — the "
              "bucketed zero-recompile claim cannot be checked",
              file=sys.stderr)
        raise SystemExit(2)
    return obj


def _accounted(phase: dict) -> bool:
    """The no-silent-drop identity: every admitted request ends in
    exactly one terminal bucket, and rejections were never admitted."""
    return (phase.get("admitted", 0)
            == phase.get("served", 0) + phase.get("errors", 0)
            + phase.get("timeouts", 0)
            + phase.get("transient_failures", 0)
            + phase.get("queued", 0) + phase.get("parked", 0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m go_libp2p_pubsub_tpu_torch.servestat",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("artifact")
    ap.add_argument("--check", metavar="BASELINE",
                    help="committed baseline artifact to gate against")
    ap.add_argument("--rps-slack", type=float, default=0.5,
                    help="allowed fractional throughput drop vs "
                         "baseline (default 0.5; CPU/TPU passes share "
                         "one artifact schema)")
    ap.add_argument("--p99-slack", type=float, default=3.0,
                    help="allowed p99 queue-latency growth factor vs "
                         "baseline (default 3.0x — queue latency is "
                         "load-shaped, gate loosely)")
    ns = ap.parse_args(argv)

    cur = load(ns.artifact)
    rc = 0
    for row in cur["rows"]:
        bits = " ".join(f"{k}={v}" for k, v in row.items()
                        if k != "id")
        print(f"  {str(row.get('id')):<18s} {bits}")
    print(f"compiles={cur['compiles']} "
          f"traced_buckets={cur.get('traced_buckets')} "
          f"bucket_count={cur.get('bucket_count')}")

    load_p = cur.get("load", {})
    if cur["compiles"] != cur.get("traced_buckets"):
        print(f"servestat: compile count {cur['compiles']} != traced "
              f"bucket count {cur.get('traced_buckets')} — the "
              "front end recompiled (or double-counted) an executable",
              file=sys.stderr)
        rc = 1
    for name in ("load", "overload", "kill_recovery"):
        phase = cur.get(name)
        if phase and not _accounted(phase):
            print(f"servestat: {name} phase lost requests: admitted="
                  f"{phase.get('admitted')} vs served="
                  f"{phase.get('served')} errors={phase.get('errors')}"
                  f" timeouts={phase.get('timeouts')} transient="
                  f"{phase.get('transient_failures')} queued="
                  f"{phase.get('queued')} parked={phase.get('parked')}"
                  " — a silent drop", file=sys.stderr)
            rc = 1
    over = cur.get("overload", {})
    if over and not over.get("rejected_overload"):
        print("servestat: the overload phase produced no explicit "
              "rejection rows — backpressure is not engaging (or "
              "drops are silent)", file=sys.stderr)
        rc = 1
    kill = cur.get("kill_recovery", {})
    if kill and not kill.get("digest_match"):
        print("servestat: kill-recovery digest mismatch — a resumed "
              "long scenario is NOT bit-identical to the "
              "uninterrupted run", file=sys.stderr)
        rc = 1
    cold = cur.get("cold_start", {})
    if cold and cold.get("aot_compiles", 0) != 0:
        print(f"servestat: the AOT cold start compiled "
              f"{cold['aot_compiles']} executable(s) — the exported "
              "blobs are not being served", file=sys.stderr)
        rc = 1

    if ns.check:
        base = load(ns.check)
        b_load = base.get("load", {})
        rps_cur, rps_base = (load_p.get("throughput_rps"),
                             b_load.get("throughput_rps"))
        if rps_cur is not None and rps_base:
            floor = rps_base * (1.0 - ns.rps_slack)
            verdict = "OK" if rps_cur >= floor else "REGRESSED"
            print(f"check: throughput_rps {rps_cur:.2f} vs baseline "
                  f"{rps_base:.2f} (floor {floor:.2f}) -> {verdict}")
            if rps_cur < floor:
                rc = 1
        p99_cur, p99_base = (load_p.get("p99_queue_s"),
                             b_load.get("p99_queue_s"))
        if p99_cur is not None and p99_base:
            ceil = p99_base * ns.p99_slack
            verdict = "OK" if p99_cur <= ceil else "REGRESSED"
            print(f"check: p99_queue_s {p99_cur:.3f} vs baseline "
                  f"{p99_base:.3f} (ceiling {ceil:.3f}) -> {verdict}")
            if p99_cur > ceil:
                rc = 1
        if (base.get("bucket_count")
                and cur.get("bucket_count", 0)
                < base["bucket_count"]):
            print("servestat: bucket coverage shrank vs baseline: "
                  f"{cur.get('bucket_count')} < "
                  f"{base['bucket_count']}", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
