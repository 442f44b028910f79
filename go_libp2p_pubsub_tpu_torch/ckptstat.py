"""ckptstat: the port's copy of the JAX package's ``tools/ckptstat.py``:
print a checkpointed-execution artifact (``checkpoint_bench.py``) as a
table and gate it.

    python -m go_libp2p_pubsub_tpu_torch.ckptstat ARTIFACT
        [--check BASELINE] [--overhead-slack 10] [--max-compiles 2]

The rows: the uninterrupted run (``single``), the segmented runs (S in
{2, 4}, a full snapshot flushed between segments), the kill-resume run
(interrupted by the deferred SIGTERM machinery and resumed from its
snapshot) and, where the artifact has it, the sharded D->D' restore.
The gate is the contract: every row reproduces the single run's digest
bit for bit.  ``compiles`` is the artifact's count (the port's: the
distinct step objects a row's segments ran plus the kernel sources built
during the row).

Exit codes (tracestat/tourneystat/sweepstat/delaystat/shardstat
convention):

  0  clean
  1  regression: any row whose digest differs from the single-scan
     row (resume bit-identity broken), a segmented row that compiled
     more than --max-compiles executables (recompile-per-segment:
     equal segments must share ONE compiled program, plus at most a
     remainder), segmented wall-clock more than --overhead-slack x
     the single-scan row (snapshot I/O swamping the run), or (with
     --check) a baseline row id missing from the current artifact or
     a baseline-true bit_identical flag going false
  2  unusable input: missing/unparseable artifact, no rows, or no
     single-scan reference row (nothing to compare against)
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
        print(f"ckptstat: cannot read {path}: {e}", file=sys.stderr)
        raise SystemExit(2)
    rows = obj.get("rows") if isinstance(obj, dict) else None
    if not rows or not isinstance(rows, list):
        print(f"ckptstat: {path} carries no rows", file=sys.stderr)
        raise SystemExit(2)
    if not any(isinstance(r, dict) and r.get("id") == "single"
               for r in rows):
        print(f"ckptstat: {path} has no single-scan reference row — "
              "resume bit-identity has no reference", file=sys.stderr)
        raise SystemExit(2)
    return obj


def gates(rows: list, overhead_slack: float = 10.0,
          max_compiles: int = 2) -> list[tuple[str, str]]:
    """The contract's failures, ``[(gate, message)]``: ``identity`` (a
    row's digest is not the single run's), ``compiles`` (more than
    ``max_compiles``), ``overhead`` (a segmented row's wall above
    ``overhead_slack`` times the single run's)."""
    single = next(r for r in rows if r.get("id") == "single")
    out = []
    for r in rows:
        if r["id"] == "single":
            continue
        if r.get("digest") != single.get("digest") \
                or not r.get("bit_identical"):
            out.append(("identity",
                        f"ckptstat: {r['id']} digest {r.get('digest')} != "
                        f"single-scan {single.get('digest')} — resume "
                        "bit-identity broken"))
        if (r.get("compiles") is not None
                and r["compiles"] > max_compiles):
            out.append(("compiles",
                        f"ckptstat: {r['id']} compiled {r['compiles']} "
                        f"executables (> {max_compiles}) — equal "
                        "segments must reuse one compiled program "
                        "(recompile-per-segment regression)"))
        if (r["id"].startswith("segmented")
                and single.get("wall_s")
                and r.get("wall_s", 0)
                > single["wall_s"] * overhead_slack):
            out.append(("overhead",
                        f"ckptstat: {r['id']} wall {r['wall_s']:.3f}s "
                        f"exceeds {overhead_slack}x the single-scan "
                        f"row ({single['wall_s']:.3f}s) — segment/snapshot "
                        "overhead past slack"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m go_libp2p_pubsub_tpu_torch.ckptstat",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("artifact")
    ap.add_argument("--check", metavar="BASELINE",
                    help="committed baseline artifact to gate against")
    ap.add_argument("--overhead-slack", type=float, default=10.0,
                    help="max allowed segmented wall-clock as a factor "
                         "of the single-scan row (default 10: snapshot "
                         "serialization is host I/O — generous, but a "
                         "runaway per-segment cost still trips)")
    ap.add_argument("--max-compiles", type=int, default=2,
                    help="max compiled executables per segmented row "
                         "(default 2: the shared equal-segment program "
                         "plus at most one remainder length)")
    ns = ap.parse_args(argv)

    cur = load(ns.artifact)
    rows = [r for r in cur["rows"] if isinstance(r, dict)]
    shape = cur.get("shape", {})
    print(f"checkpointed execution: {shape.get('n')} peers x "
          f"{shape.get('t')} topics, {shape.get('ticks')} ticks, "
          f"platform={cur.get('platform')} "
          f"({cur.get('n_devices')} devices"
          f"{', hardware row queued' if cur.get('hardware_queued') else ''})")
    for r in rows:
        extra = ""
        if r.get("segments") is not None:
            extra += f"  segments={r['segments']}"
        if r.get("compiles") is not None:
            extra += f"  compiles={r['compiles']}"
        if r.get("snapshot_bytes") is not None:
            extra += f"  snapshot={r['snapshot_bytes']} B"
        if r.get("devices_save") is not None:
            extra += (f"  D{r['devices_save']}->"
                      f"D{r['devices_resume']}")
        print(f"  {r['id']:<14s} wall={r.get('wall_s', 0):.3f}s "
              f"digest={r.get('digest')} "
              f"bit_identical={r.get('bit_identical')}{extra}")

    findings = gates(rows, ns.overhead_slack, ns.max_compiles)
    for _, msg in findings:
        print(msg, file=sys.stderr)
    rc = 1 if findings else 0

    if ns.check:
        base = load(ns.check)
        base_rows = {r["id"]: r for r in base["rows"]
                     if isinstance(r, dict)}
        cur_ids = {r["id"] for r in rows}
        missing = set(base_rows) - cur_ids
        if missing:
            print("ckptstat: row coverage shrank vs baseline: "
                  f"missing {sorted(missing)}", file=sys.stderr)
            rc = 1
        for rid, ref in sorted(base_rows.items()):
            r = next((x for x in rows if x["id"] == rid), None)
            if r is None:
                continue
            if ref.get("bit_identical") and not r.get("bit_identical"):
                print(f"ckptstat: {rid} was bit_identical in the "
                      "baseline and no longer is", file=sys.stderr)
                rc = 1
            verdict = "OK" if r.get("bit_identical", rid == "single") \
                else "REGRESSED"
            print(f"check: {rid} bit_identical="
                  f"{r.get('bit_identical')} vs baseline "
                  f"{ref.get('bit_identical')} -> {verdict}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
