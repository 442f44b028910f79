"""loadgen: a multi-process client fleet for the sweepd socket server, the
port's copy of the JAX package's ``tools/loadgen.py``.

Starts ``--procs`` worker processes, each holding its OWN connection to
a ``sweepd --socket`` (its thread-per-connection loop serves them
concurrently against the one resident server), each writing
``--requests`` JSON request lines and reading result rows until the
server's EOF drain.  The parent merges every worker's rows and reports
the fleet totals: requests sent, terminal rows received, error rows,
and requests/second over the fleet wall clock.

Row accounting across a concurrent fleet: the front end's dispatch
batches mix requests from different connections, and a drain triggered
on one connection emits rows for requests admitted on another — so
PER-WORKER row counts vary, but the fleet TOTAL of terminal rows
equals the total of requests sent (the no-silent-drop identity,
observed from the client side).  ``metrics_bench.py``'s fleet phase
drives this fleet while scraping ``--metrics-port`` mid-flight.

    python -m go_libp2p_pubsub_tpu_torch.loadgen /tmp/sweepd.sock \
        --procs 4 --requests 8

Stdlib only: the fleet is the CLIENT side.  ``run_fleet`` is the
embeddable face.  Its workers start by ``spawn`` (the reference forks),
so a caller that holds CUDA or threads can drive a fleet; each worker
imports this module again.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import socket
import time

__all__ = ["run_fleet", "main"]


def _default_request(worker: int, i: int) -> dict:
    """A small short-path request; ids are fleet-unique so rows can be
    joined back to their request no matter which connection emitted
    them."""
    return {"id": f"w{worker}-r{i}", "n": 64, "t": 1, "m": 2,
            "ticks": 4, "seed": (worker * 1_000_003 + i) % 2**31}


def _connect(path: str, timeout_s: float) -> socket.socket:
    deadline = time.monotonic() + timeout_s
    while True:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.connect(path)
            return sock
        except (FileNotFoundError, ConnectionRefusedError):
            sock.close()
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.05)


def _worker(path: str, worker: int, n_requests: int, make_request,
            connect_timeout_s: float, queue) -> None:
    rows: list = []
    err = None
    try:
        sock = _connect(path, connect_timeout_s)
        with sock, sock.makefile("r") as rf, sock.makefile("w") as wf:
            for i in range(n_requests):
                wf.write(json.dumps(make_request(worker, i)) + "\n")
            wf.flush()
            # half-close: the server sees EOF, drains (rows for
            # requests still queued — possibly admitted on OTHER
            # connections — come back here), and closes
            sock.shutdown(socket.SHUT_WR)
            for line in rf:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
    except Exception as e:
        # any worker failure is surfaced in the parent's summary
        err = f"{e.__class__.__name__}: {e}"
    queue.put({"worker": worker, "rows": rows, "error": err})


def run_fleet(socket_path: str, *, procs: int = 4,
              requests_per_proc: int = 8, make_request=None,
              connect_timeout_s: float = 10.0) -> dict:
    """Drive ``procs`` client processes (started by ``spawn``: a
    ``make_request`` must be importable), ``requests_per_proc`` requests
    each, against a listening sweepd socket.  Returns the merged
    summary: ``rows`` (every terminal row the fleet received, fleet
    order unspecified), ``stats_rows`` (one final counters row per
    connection), ``ok``/``errors`` row counts, ``worker_failures``,
    and ``rps`` over the fleet wall clock."""
    if procs < 1 or requests_per_proc < 1:
        raise ValueError(
            f"loadgen: procs={procs} and requests_per_proc="
            f"{requests_per_proc} must both be >= 1")
    make_request = make_request or _default_request
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    t0 = time.perf_counter()
    workers = [
        ctx.Process(target=_worker,
                    args=(socket_path, w, requests_per_proc,
                          make_request, connect_timeout_s, queue),
                    daemon=True)
        for w in range(procs)
    ]
    for p in workers:
        p.start()
    results = [queue.get() for _ in workers]
    for p in workers:
        p.join(timeout=30)
    wall = time.perf_counter() - t0

    rows, stats_rows, failures = [], [], []
    for res in sorted(results, key=lambda r: r["worker"]):
        if res["error"]:
            failures.append({"worker": res["worker"],
                             "error": res["error"]})
        for row in res["rows"]:
            (stats_rows if row.get("stats") else rows).append(row)
    ok = sum(1 for r in rows if r.get("ok"))
    sent = procs * requests_per_proc
    return {
        "procs": procs,
        "requests_sent": sent,
        "rows": rows,
        "stats_rows": stats_rows,
        "ok": ok,
        "errors": len(rows) - ok,
        "worker_failures": failures,
        "wall_s": round(wall, 3),
        "rps": round(sent / wall, 2) if wall else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m go_libp2p_pubsub_tpu_torch.loadgen",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("socket", help="sweepd --socket path")
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8,
                    help="requests per worker process")
    ap.add_argument("--connect-timeout", type=float, default=10.0)
    ns = ap.parse_args(argv)
    out = run_fleet(ns.socket, procs=ns.procs,
                    requests_per_proc=ns.requests,
                    connect_timeout_s=ns.connect_timeout)
    summary = {k: v for k, v in out.items()
               if k not in ("rows", "stats_rows")}
    summary["rows_received"] = len(out["rows"])
    print(json.dumps(summary, indent=2))
    # client-side no-silent-drop check: every request sent came back
    # as exactly one terminal row somewhere in the fleet
    if summary["rows_received"] != out["requests_sent"] \
            or out["worker_failures"]:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
