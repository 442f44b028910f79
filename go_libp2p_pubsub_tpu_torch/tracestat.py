"""Aggregate statistics over pubsub trace files: the port's copy of the
JAX package's ``tools/tracestat.py`` (the analog of the reference
ecosystem's external ``tracestat`` tool), the same report for the same
files.

Reads either sink format (``interop/export.py`` writes both): ndjson
(NewJSONTracer) or varint-delimited protobuf (NewPBTracer).  Prints
per-event-type counts, the 13-type event coverage matrix, per-message
delivery coverage, the publish->deliver latency distribution (global and
per topic, p50/p90/p99), and control-plane event rates (GRAFT/PRUNE/
JOIN/LEAVE/... per second over the trace span).

``--frames frames.json`` feeds the device-side histogram sidecar
(``interop/export.py`` ``write_telemetry_frames``): latency percentiles
then come from the in-run latency_hist buckets — tick-exact at any
scale, no per-event replay — and the per-topic split prefers the
sidecar's host-exact per-topic histograms over the trace-replay pairing
(kept as the fallback when no sidecar rides along).

``--check baseline.json`` turns the report into a regression gate:
compare against a committed OBS_r*.json artifact (a prior ``--json``
report) and exit 1 when event-type coverage shrank or p99 delivery
latency regressed beyond --p99-slack (default 1 bucket/tick).

An empty or unparseable trace file — or an empty/histogram-free frames
sidecar — is an error (exit 2 with the offending path named), never a
silent zero-count report.

Usage: python -m go_libp2p_pubsub_tpu_torch.tracestat trace.json
           [trace2.pb ...] [--json] [--frames frames.json]
           [--check OBS_rNN.json] [--p99-slack T]
"""

from __future__ import annotations

import base64
import json
import sys

from .histutil import hist_percentiles
from .pb import trace as tr
from .pb.proto import iter_delimited
from .pb.trace import TraceType

_SUB_KEYS = ("publish_message", "deliver_message", "reject_message",
             "duplicate_message")

# everything that is not payload-path (publish/deliver/reject/dup) is
# control-plane bookkeeping: peer/RPC/membership/mesh events
_CONTROL_TYPES = (TraceType.ADD_PEER, TraceType.REMOVE_PEER,
                  TraceType.RECV_RPC, TraceType.SEND_RPC,
                  TraceType.DROP_RPC, TraceType.JOIN, TraceType.LEAVE,
                  TraceType.GRAFT, TraceType.PRUNE)


class TraceParseError(Exception):
    """A trace file that cannot be summarized (empty / unparseable)."""


def _is_json(data: bytes) -> bool:
    """Sniff the sink format: a delimited-pb stream could by chance
    start with 0x7b ('{' — a 123-byte first event), so actually try to
    parse the first line as JSON."""
    if data[:1] != b"{":
        return False
    first = data.split(b"\n", 1)[0]
    try:
        json.loads(first.decode("utf-8", "surrogateescape"))
        return True
    except (ValueError, UnicodeDecodeError):
        return False


def load_events(path: str):
    """Read a trace file into a list of ``(type, msg_id, ts, topic)``
    tuples (either sink format).  Raises TraceParseError — with the
    path and reason — on an empty, event-free, or unparseable file
    instead of yielding a silent zero-count summary."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise TraceParseError(f"{path}: cannot read trace file ({e})")
    if not data:
        raise TraceParseError(f"{path}: empty trace file")
    events = []
    if _is_json(data):
        lines = data.decode("utf-8", "surrogateescape").splitlines()
        for lineno, line in enumerate(lines, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError as e:
                raise TraceParseError(
                    f"{path}:{lineno}: unparseable ndjson line ({e})")
            if not isinstance(ev, dict):
                raise TraceParseError(
                    f"{path}:{lineno}: ndjson line is not an object")
            mid = topic = None
            for k in _SUB_KEYS:
                sub = ev.get(k)
                if sub and "message_id" in sub:
                    mid = base64.b64decode(sub["message_id"])
                    topic = sub.get("topic")
                    break
            events.append((ev.get("type"), mid, ev.get("timestamp"),
                           topic))
    else:
        try:
            for ev in iter_delimited(tr.TraceEvent, data):
                sub = (ev.publish_message or ev.deliver_message
                       or ev.reject_message or ev.duplicate_message)
                mid = sub.message_id if sub else None
                topic = sub.topic if sub else None
                events.append((ev.type, mid, ev.timestamp, topic))
        except ValueError as e:
            raise TraceParseError(
                f"{path}: unparseable delimited-pb stream ({e})")
    if not events:
        raise TraceParseError(f"{path}: no trace events in file")
    return events


def _percentiles(latencies):
    """{p50, p90, p99, count} of a latency list (ns)."""
    lat = sorted(latencies)
    k = len(lat)

    def q(p):
        return lat[min(k - 1, (k * p) // 100)]

    return {"p50": q(50), "p90": q(90), "p99": q(99), "count": k}


def _hist_percentiles(hist):
    """{p50, p90, p99, count} from bucket counts (bucket value = index;
    the same rank convention as _percentiles over the expanded sample,
    so unit-width buckets give exactly the sample percentiles).
    Delegates to the shared histutil helper — the same code
    models/telemetry.py's summaries use, so the gate and the
    device-side report can never disagree on the convention."""
    return hist_percentiles(hist)


def load_frames(path: str) -> dict:
    """Read a histogram-frames sidecar (``interop/export.py``
    ``write_telemetry_frames``).  Raises TraceParseError on an empty,
    unparseable, or histogram-free file — the same exit-2 contract as
    the trace streams."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise TraceParseError(f"{path}: cannot read frames file ({e})")
    if not data:
        raise TraceParseError(f"{path}: empty frames file")
    try:
        obj = json.loads(data)
    except ValueError as e:
        raise TraceParseError(f"{path}: unparseable frames json ({e})")
    hist = obj.get("latency_hist") if isinstance(obj, dict) else None
    if not hist or not any(int(c) for c in hist):
        raise TraceParseError(
            f"{path}: frames carry no latency_hist counts (run with "
            "TelemetryConfig(latency_hist=True))")
    return obj


def coverage_matrix(counts: dict) -> dict:
    """Event-type coverage against the reference's 13 TraceEvent
    types: which are present in the stream, which are missing."""
    present = [TraceType.NAMES[t] for t in sorted(TraceType.NAMES)
               if counts.get(TraceType.NAMES[t], 0)]
    missing = [TraceType.NAMES[t] for t in sorted(TraceType.NAMES)
               if not counts.get(TraceType.NAMES[t], 0)]
    return {"types": len(TraceType.NAMES), "covered": len(present),
            "present": present, "missing": missing}


def stats(paths, frames_path=None):
    frames = load_frames(frames_path) if frames_path else None
    by_file = [load_events(p) for p in paths]
    counts = {}
    publish_ts = {}
    publish_topic = {}
    deliveries = {}
    latencies = []
    lat_by_topic = {}
    ts_min = ts_max = None
    # first pass: publish timestamps across ALL files — per-node traces
    # put publishes and deliveries in different files, and argument
    # order must not change the latency pairing
    for events in by_file:
        for typ, mid, ts, topic in events:
            if typ == TraceType.PUBLISH_MESSAGE and mid is not None:
                publish_ts.setdefault(mid, ts)
                if topic is not None:
                    publish_topic.setdefault(mid, topic)
    for events in by_file:
        for typ, mid, ts, topic in events:
            name = TraceType.NAMES.get(typ, str(typ))
            counts[name] = counts.get(name, 0) + 1
            if ts is not None:
                ts_min = ts if ts_min is None else min(ts_min, ts)
                ts_max = ts if ts_max is None else max(ts_max, ts)
            if typ == TraceType.DELIVER_MESSAGE and mid is not None:
                deliveries[mid] = deliveries.get(mid, 0) + 1
                if ts is not None and publish_ts.get(mid) is not None:
                    lat = ts - publish_ts[mid]
                    latencies.append(lat)
                    # topic from the delivery itself, else the publish
                    tpc = (topic if topic is not None
                           else publish_topic.get(mid))
                    if tpc is not None:
                        lat_by_topic.setdefault(tpc, []).append(lat)
    # coverage is per PUBLISHED message: a lost message counts as 0,
    # not as absent
    per_pub = ({mid: deliveries.get(mid, 0) for mid in publish_ts}
               or deliveries)
    out = {
        "events": counts,
        "messages_published": len(publish_ts),
        "messages_delivered": len(deliveries),
        "total_deliveries": sum(deliveries.values()),
        "min_deliveries_per_msg": (min(per_pub.values())
                                   if per_pub else 0),
        "max_deliveries_per_msg": (max(per_pub.values())
                                   if per_pub else 0),
    }
    out["coverage"] = coverage_matrix(counts)
    if latencies:
        pct = _percentiles(latencies)
        out["latency_ns"] = {
            "min": min(latencies),
            "p50": pct["p50"], "p90": pct["p90"], "p99": pct["p99"],
            "max": max(latencies),
            "mean": sum(latencies) / len(latencies),
        }
    if frames is not None:
        # device-side latency distribution: the in-scan histogram is
        # tick-exact and PREFERRED over the host-replay pairing above
        # (which needs every DELIVER event in the stream — at scale
        # only the histogram ships)
        out["latency_ticks"] = _hist_percentiles(frames["latency_hist"])
        out["latency_ticks"]["source"] = "frames"
        by_topic = frames.get("latency_hist_by_topic")
        if by_topic:
            out["latency_by_topic_ticks"] = {
                tpc: _hist_percentiles(h)
                for tpc, h in sorted(by_topic.items())}
    elif latencies:
        # host-replay fallback, converted to the tick domain so the
        # --check gate compares one unit either way
        ns = 1_000_000_000
        out["latency_ticks"] = _percentiles(
            [la // ns for la in latencies])
        out["latency_ticks"]["source"] = "trace-replay"
    if lat_by_topic and "latency_by_topic_ticks" not in out:
        out["latency_by_topic_ns"] = {
            tpc: _percentiles(lat)
            for tpc, lat in sorted(lat_by_topic.items())}
    # control-plane event rates over the trace's timestamp span (the
    # GossipSub paper's control-overhead measurements are rates, not
    # totals)
    ctl = {TraceType.NAMES[t]: counts.get(TraceType.NAMES[t], 0)
           for t in _CONTROL_TYPES
           if counts.get(TraceType.NAMES[t], 0)}
    if ctl and ts_min is not None:
        span_s = (ts_max - ts_min) / 1e9
        out["control"] = {
            "span_seconds": span_s,
            "total_events": sum(ctl.values()),
            "events_per_sec": (
                {name: cnt / span_s for name, cnt in sorted(ctl.items())}
                if span_s > 0 else None),
        }
    return out


def check_regression(out: dict, baseline: dict,
                     p99_slack: int = 1) -> list[str]:
    """Regression findings of the current report vs a committed
    OBS_r*.json baseline (a prior --json report).  Empty = gate
    green.  Two ratchets:

    - COVERAGE: every event type the baseline exported must still be
      exported (new types appearing is fine — that is the direction
      the ratchet points).
    - LATENCY: tick-domain p99 may not exceed the baseline's by more
      than ``p99_slack`` ticks (device histograms are bucket-exact,
      so slack 1 absorbs only boundary flips, not real regressions).
    """
    problems = []
    base_cov = set(baseline.get("coverage", {}).get("present", ()))
    now_cov = set(out.get("coverage", {}).get("present", ()))
    for typ in sorted(base_cov - now_cov):
        problems.append(
            f"coverage regression: {typ} was exported by the baseline "
            "but is missing from this trace")
    b99 = baseline.get("latency_ticks", {}).get("p99")
    n99 = out.get("latency_ticks", {}).get("p99")
    if b99 is not None:
        if n99 is None:
            problems.append(
                "latency regression: baseline has a tick-domain p99 "
                f"({b99}) but this report has none (no frames sidecar "
                "and no replayable deliveries)")
        elif n99 > b99 + p99_slack:
            problems.append(
                f"latency regression: p99 {n99} ticks vs baseline "
                f"{b99} (+ slack {p99_slack})")
    return problems


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    as_json = "--json" in argv
    frames_path = check_path = None
    p99_slack = 1
    args = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--json":
            pass
        elif a in ("--frames", "--check", "--p99-slack"):
            if i + 1 >= len(argv):
                raise SystemExit(f"tracestat: {a} needs a value")
            val = argv[i + 1]
            if a == "--frames":
                frames_path = val
            elif a == "--check":
                check_path = val
            else:
                p99_slack = int(val)
            i += 1
        else:
            args.append(a)
        i += 1
    if not args:
        raise SystemExit(__doc__)
    try:
        out = stats(args, frames_path=frames_path)
    except TraceParseError as e:
        print(f"tracestat: error: {e}", file=sys.stderr)
        raise SystemExit(2)
    if check_path is not None:
        try:
            with open(check_path) as f:
                baseline = json.load(f)
        except (OSError, ValueError) as e:
            print(f"tracestat: error: {check_path}: unreadable "
                  f"baseline ({e})", file=sys.stderr)
            raise SystemExit(2)
        problems = check_regression(out, baseline, p99_slack=p99_slack)
        cov = out.get("coverage", {})
        for p in problems:
            print(f"tracestat --check: {p}", file=sys.stderr)
        if problems:
            raise SystemExit(1)
        # stderr: with --json the stdout stream must stay pure JSON
        # (baselines are produced by `--check ... --json > OBS_rNN.json`)
        print(f"tracestat --check: OK ({cov.get('covered')}/"
              f"{cov.get('types')} event types, p99 "
              f"{out.get('latency_ticks', {}).get('p99')} ticks vs "
              f"baseline {baseline.get('latency_ticks', {}).get('p99')})",
              file=sys.stderr)
        if not as_json:
            return
    if as_json:
        print(json.dumps(out, indent=2))
        return
    print("events:")
    for name, cnt in sorted(out["events"].items()):
        print(f"  {name:24s} {cnt}")
    cov = out["coverage"]
    print(f"event-type coverage: {cov['covered']}/{cov['types']}"
          + (f"  (missing: {', '.join(cov['missing'])})"
             if cov["missing"] else "  (all 13 reference types)"))
    print(f"messages published : {out['messages_published']}")
    print(f"messages delivered : {out['messages_delivered']}")
    print(f"total deliveries   : {out['total_deliveries']} "
          f"(per msg {out['min_deliveries_per_msg']}"
          f"..{out['max_deliveries_per_msg']})")
    if "latency_ns" in out:
        la = out["latency_ns"]
        print("publish->deliver latency (ns): "
              f"min {la['min']}  p50 {la['p50']}  p90 {la['p90']}  "
              f"p99 {la['p99']}  max {la['max']}  mean {la['mean']:.0f}")
    if "latency_ticks" in out:
        lt = out["latency_ticks"]
        print(f"latency (ticks, {lt['source']}): p50 {lt['p50']}  "
              f"p90 {lt['p90']}  p99 {lt['p99']}  "
              f"({lt['count']} deliveries)")
    for tpc, pct in out.get("latency_by_topic_ticks", {}).items():
        print(f"  topic {tpc:16s} p50 {pct['p50']}  p90 {pct['p90']}  "
              f"p99 {pct['p99']}  ({pct['count']} deliveries, ticks)")
    for tpc, pct in out.get("latency_by_topic_ns", {}).items():
        print(f"  topic {tpc:16s} p50 {pct['p50']}  p90 {pct['p90']}  "
              f"p99 {pct['p99']}  ({pct['count']} deliveries)")
    if "control" in out:
        ctl = out["control"]
        print(f"control events     : {ctl['total_events']} over "
              f"{ctl['span_seconds']:.1f}s")
        for name, rate in (ctl["events_per_sec"] or {}).items():
            print(f"  {name:24s} {rate:.2f}/s")


if __name__ == "__main__":
    main()
