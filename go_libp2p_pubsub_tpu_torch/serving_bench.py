"""The JAX package's serving benchmark (``bench_suite.py``
``bench_gossipsub_serving``), as written, on the port's front end
(``serving/``), plus the front end at the sweepd CLI's full width.

``run(device)`` is the row's four phases, one artifact (the reference's
fields; ``servestat --check SERVE_r18.json`` reads it):

* ``load``: GOSSIP_SERVE_REQS (2,000) requests with Zipf-popular shapes
  (a = 1.1) over a five-shape pool (``max_buckets=4``, so the cold shape
  cycles through LRU eviction) and Poisson arrivals paced at
  GOSSIP_SERVE_RPS (400/s), seed 18; every 20th request carries a 0.05 s
  deadline, every 10th priority 1.  Throughput, p50/p99 queue seconds,
  and ``compiles == traced_buckets == 5`` with ``evictions > 0``.
* ``overload``: 300 requests into a ``queue_cap=32`` front end that
  dispatches every 16th arrival: explicit ``overloaded`` rows, and the
  accounting identity.
* ``kill_recovery``: a child server process serving one long scenario
  (GOSSIP_SERVE_KILL_TICKS = 400 ticks, snapshots every 2) is SIGKILLed
  once two snapshots exist; a restarted child replays the journal,
  resumes and must give the digest of an uninterrupted run, which must be
  ``REFERENCE_KILL_DIGEST``.
* ``cold_start``: two child processes over one AOT directory, the first
  builds and writes the two buckets' runner records, the second loads
  them (``compiles == 0``, ``aot_loads == 2``); both give
  ``REFERENCE_COLD_ROWS``.

Each child is ``python -m go_libp2p_pubsub_tpu_torch.serving_bench
--child kill|cold --device DEV ...`` and reports the kernel sources it
built (0 where the parent built them).

``full_width(device)`` serves the sweepd CLI's shape through the front
end: 36 requests drawn Zipf over (10,000, 10, 16, 100), (5,000, 10, 16,
60) and (20,000, 10, 16, 100) (buckets ``n16384-t16-m16-ticks104``,
``n8192-t16-m16-ticks64``, ``n32768-t16-m16-ticks104``), Poisson arrivals
at 4/s, ``max_buckets=2``, ``batch=6``, the row's every-20th deadline and
every-10th priority; then the same requests through ``SweepServer.submit``
at each bucket's shape, whose rows must equal the front end's (but for
``batch`` and ``queue_s``).

``REFERENCE_KILL_DIGEST`` and ``REFERENCE_COLD_ROWS`` are the JAX
package's, from ``tests/torch_reference_gate.py --serving``.

    python -m go_libp2p_pubsub_tpu_torch.serving_bench [--device cpu]
        [--out serving.json] [--full-width]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np

from .device import resolve_device
from .serving import FrontendConfig, ScenarioFrontend, quantize_shape

#: the load phase's shape pool, Zipf exponent and seed
POOL = [(256, 2, 8, 16), (128, 2, 4, 8), (256, 4, 8, 16), (64, 2, 4, 8),
        (256, 2, 8, 24)]
ZIPF_A = 1.1
SEED = 18
#: the cold-start children's shapes, four requests each
COLD_SHAPES = ((256, 2, 8, 16), (128, 2, 4, 8))
#: the full-width pool: the sweepd CLI's shape and two neighbours
FULL_POOL = [(10_000, 10, 16, 100), (5_000, 10, 16, 60),
             (20_000, 10, 16, 100)]
FULL_REQS, FULL_RPS, FULL_BATCH, FULL_BUCKETS = 36, 4.0, 6, 2

#: the JAX package's digest of the kill scenario run uninterrupted
#: (tests/torch_reference_gate.py --serving; SERVE_r18.json's)
REFERENCE_KILL_DIGEST = "6c44dbed67c2467e5b9747b645043bef"
#: the JAX package's cold-start rows: [id, delivery_fraction,
#: honest_delivery_fraction] (tests/torch_reference_gate.py --serving)
REFERENCE_COLD_ROWS = [
    ["c-n256-ticks16-0", 1.0, 1.0], ["c-n256-ticks16-1", 1.0, 1.0],
    ["c-n256-ticks16-2", 1.0, 1.0], ["c-n256-ticks16-3", 1.0, 1.0],
    ["c-n128-ticks8-0", 1.0, 1.0], ["c-n128-ticks8-1", 1.0, 1.0],
    ["c-n128-ticks8-2", 1.0, 1.0], ["c-n128-ticks8-3", 1.0, 1.0]]

ROOT = Path(__file__).resolve().parents[1]


def _zipf(pool, n: int, rps: float, rng):
    """The row's draw: shape indices by Zipf weight, then the Poisson
    gaps (in the reference's order of calls on ``rng``)."""
    w = np.array([1.0 / (r + 1) ** ZIPF_A for r in range(len(pool))])
    w /= w.sum()
    return rng.choice(len(pool), size=n, p=w), rng.exponential(
        1.0 / rps, size=n)


def _serve_paced(fe, pool, shape_ix, gaps, make_id) -> tuple[list, float]:
    """Admit the drawn requests at their arrival times (dispatching once
    after each), then drain: ``(rows, wall seconds)``."""
    rows = []
    t_load = time.perf_counter()
    t_next = t_load
    for i in range(len(shape_ix)):
        t_next += gaps[i]
        lag = t_next - time.perf_counter()
        if lag > 0:
            time.sleep(lag)
        n, t, m, ticks = pool[shape_ix[i]]
        req = {"id": make_id(i), "n": n, "t": t, "m": m, "ticks": ticks,
               "seed": int(i % 64)}
        if i % 20 == 0:
            req["deadline_s"] = 0.05    # tight: times out under backlog
        if i % 10 == 0:
            req["priority"] = 1
        rej = fe.admit(req)
        if rej is not None:
            rows.append(rej)
        rows.extend(fe.dispatch_ready())
    rows.extend(fe.drain())
    return rows, time.perf_counter() - t_load


def load_phase(device, n_reqs: int, rps: float) -> tuple[dict, dict]:
    """The load phase as written: ``(load row, front-end stats)``."""
    dev = resolve_device(device)
    shape_ix, gaps = _zipf(POOL, n_reqs, rps, np.random.default_rng(SEED))
    fe = ScenarioFrontend(FrontendConfig(
        max_buckets=4, batch=8, queue_cap=max(4 * n_reqs, 4096),
        server_kw={"seed": 0, "device": str(dev)}))
    rows, load_wall = _serve_paced(fe, POOL, shape_ix, gaps,
                                   lambda i: f"r{i}")
    st = fe.stats()
    assert st["admitted"] == n_reqs and st["queued"] == 0, st
    assert (st["served"] + st["errors"] + st["timeouts"]
            + st["transient_failures"]) == n_reqs, st
    assert st["compiles"] == st["traced_buckets"] == len(POOL), st
    assert st["evictions"] > 0, st     # the pool outnumbers the cap
    ok_rows = [r for r in rows if r.get("ok") and "queue_s" in r]
    assert all(r.get("inv_bits", 0) == 0 for r in ok_rows)
    q = np.array([r["queue_s"] for r in ok_rows])
    load = {
        "admitted": st["admitted"], "served": st["served"],
        "errors": st["errors"], "timeouts": st["timeouts"],
        "transient_failures": st["transient_failures"],
        "queued": st["queued"], "parked": st["parked"],
        "rejected_overload": st["rejected_overload"],
        "retries": st["retries"],
        "throughput_rps": round(st["served"] / load_wall, 2),
        "p50_queue_s": round(float(np.percentile(q, 50)), 4),
        "p99_queue_s": round(float(np.percentile(q, 99)), 4),
        "wall_s": round(load_wall, 2),
        "device_s": st["device_s"],
        "evictions": st["evictions"],
        "wall_s_unrounded": load_wall,
    }
    return load, st


def overload_phase(device) -> dict:
    """A burst into a tiny admission cap: one dispatch (<= one batch of
    8) per 16 admissions, so admissions past the cap come back as named
    rejections."""
    dev = resolve_device(device)
    fe2 = ScenarioFrontend(FrontendConfig(
        max_buckets=2, batch=8, queue_cap=32,
        server_kw={"seed": 0, "device": str(dev)}))
    over_rows = []
    for i in range(300):
        rej = fe2.admit({"id": f"o{i}", "n": 256, "t": 2, "m": 8,
                         "ticks": 16, "seed": int(i % 16)})
        if rej is not None:
            over_rows.append(rej)
        if i % 16 == 15:
            over_rows.extend(fe2.dispatch_ready())
    over_rows.extend(fe2.drain())
    st2 = fe2.stats()
    assert st2["rejected_overload"] > 0, st2
    assert all(r.get("overloaded") and "overloaded:" in r["error"]
               for r in over_rows if not r.get("ok")
               and not r.get("timeout")), over_rows
    assert (st2["admitted"] + st2["rejected_overload"] == 300
            and st2["queued"] == 0), st2
    return {
        "requests": 300, "queue_cap": 32,
        "admitted": st2["admitted"], "served": st2["served"],
        "errors": st2["errors"], "timeouts": st2["timeouts"],
        "transient_failures": st2["transient_failures"],
        "queued": st2["queued"], "parked": st2["parked"],
        "rejected_overload": st2["rejected_overload"],
        "reject_rate": round(st2["rejected_overload"] / 300, 4),
    }


def kill_line(kill_ticks: int) -> str:
    """The kill scenario's journal line (keys sorted, as the row writes
    it: the snapshot directory's name and fingerprint hash it)."""
    return json.dumps({"id": "kill1", "n": 256, "t": 2, "m": 8,
                       "ticks": kill_ticks, "seed": 1}, sort_keys=True)


def kill_config(kill_ticks: int, ckpt_dir: str, every: int,
                **server_kw) -> FrontendConfig:
    return FrontendConfig(batch=2, max_buckets=2,
                          long_ticks=kill_ticks // 2, ckpt_dir=ckpt_dir,
                          ckpt_every=every,
                          server_kw=dict({"seed": 0}, **server_kw))


def uninterrupted_digest(device, kill_ticks: int, work: str) -> dict:
    """The kill scenario served whole (another snapshot directory and
    segmentation: the digest depends on neither): its long row."""
    dev = resolve_device(device)
    fe = ScenarioFrontend(kill_config(
        kill_ticks, os.path.join(work, "ckpt_ref"),
        max(kill_ticks // 2, 1), device=str(dev)))
    buf = io.StringIO()
    fe.serve_lines([kill_line(kill_ticks)], buf)
    row = next(json.loads(ln) for ln in buf.getvalue().splitlines()
               if json.loads(ln).get("long"))
    assert row["ok"], row
    return row


def _child(kind: str, device: str, *args: str) -> list[str]:
    return [sys.executable, "-m", "go_libp2p_pubsub_tpu_torch.serving_bench",
            "--child", kind, "--device", device, *args]


def _child_report(lines: list[dict]) -> dict:
    return next(r for r in lines if r.get("child"))


def kill_recovery(device, kill_ticks: int, work: str) -> dict:
    """SIGKILL mid-long-scenario, restart, digest."""
    dev = resolve_device(device)
    raw = kill_line(kill_ticks)
    ckpt_dir = os.path.join(work, "ckpt")
    journal = os.path.join(work, "serve.journal")
    snapdir = os.path.join(ckpt_dir,
                           f"kill1-{zlib.crc32(raw.encode()):08x}")
    args = ["--ticks", str(kill_ticks), "--ckpt-dir", ckpt_dir,
            "--journal", journal]

    def start(first: bool):
        return subprocess.Popen(
            _child("kill", dev.type, *args, *(["--first"] if first else [])),
            cwd=ROOT, stdout=subprocess.PIPE, text=True)

    child = start(first=True)
    try:
        deadline = time.time() + 300
        while time.time() < deadline:
            if (os.path.isdir(snapdir)
                    and sum(f.endswith(".ckpt")
                            for f in os.listdir(snapdir)) >= 2):
                break
            if child.poll() is not None:
                raise AssertionError(
                    "kill child finished before it could be killed: "
                    + (child.communicate()[0] or ""))
            time.sleep(0.01)
        else:
            raise AssertionError("kill child never produced snapshots")
        child.send_signal(signal.SIGKILL)
        first_out, _ = child.communicate(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=60)
    first_report = _child_report(
        [json.loads(ln) for ln in first_out.splitlines() if ln.strip()])
    ref_row = uninterrupted_digest(dev, kill_ticks, work)
    restart = start(first=False)
    out, _ = restart.communicate(timeout=600)
    assert restart.returncode == 0, out
    parsed = [json.loads(ln) for ln in out.splitlines() if ln.strip()]
    res_row = next(r for r in parsed if r.get("long"))
    res_stats = next(r for r in parsed if r.get("stats"))
    assert res_row["resumed"], res_row
    match = res_row["digest"] == ref_row["digest"]
    assert match, (res_row, ref_row)
    return {
        "ticks": kill_ticks, "sigkill": True,
        "admitted": res_stats["admitted"],
        "served": res_stats["served"],
        "errors": res_stats["errors"],
        "timeouts": res_stats["timeouts"],
        "transient_failures": res_stats["transient_failures"],
        "queued": res_stats["queued"], "parked": res_stats["parked"],
        "resumed": res_stats["long_resumed"],
        "digest": res_row["digest"], "digest_match": match,
        "sources_built": [first_report["sources_built"],
                          _child_report(parsed)["sources_built"]],
    }


def cold_rows(fe, t0: float | None = None) -> tuple[list[dict], float]:
    """The cold-start requests on ``fe`` (either package's front end):
    four a shape, each shape drained; ``(rows, seconds from t0 (default:
    now) to the first shape's rows)``."""
    t0 = time.perf_counter() if t0 is None else t0
    first = None
    rows = []
    for n, t, m, ticks in COLD_SHAPES:
        for i in range(4):
            fe.admit({"id": f"c-n{n}-ticks{ticks}-{i}", "n": n, "t": t,
                      "m": m, "ticks": ticks, "seed": i})
        rows += fe.drain()
        if first is None:
            first = time.perf_counter() - t0
    return rows, first


def cold_table(rows: list[dict]) -> list[list]:
    return [[r.get("id"), r.get("delivery_fraction"),
             r.get("honest_delivery_fraction")] for r in rows]


def cold_start(device, work: str) -> tuple[dict, dict, dict]:
    """Time-to-first-result for a fresh process, building and writing
    the runner records vs loading them: ``(row, traced, aot)``."""
    dev = resolve_device(device)
    aot_dir = os.path.join(work, "aot")

    def cold_child():
        r = subprocess.run(_child("cold", dev.type, "--aot-dir", aot_dir),
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=900)
        assert r.returncode == 0, r.stderr
        return _child_report([json.loads(ln) for ln in
                              r.stdout.splitlines() if ln.strip()])

    traced = cold_child()     # empty cache: builds + writes records
    aot = cold_child()        # warm cache: loads records, zero compiles
    assert traced["compiles"] == traced["aot_exports"] == 2, traced
    assert aot["compiles"] == 0 and aot["aot_loads"] == 2, aot
    assert aot["rows"] == traced["rows"], (traced, aot)
    row = {
        "buckets": 2,
        "traced_s": traced["first_result_s"],
        "traced_total_s": traced["total_s"],
        "aot_s": aot["first_result_s"],
        "aot_total_s": aot["total_s"],
        "speedup_x": round(traced["total_s"] / aot["total_s"], 2),
        "aot_compiles": aot["compiles"],
        "aot_loads": aot["aot_loads"],
        "bit_identical": aot["rows"] == traced["rows"],
    }
    return row, traced, aot


def run(device=None, n_reqs: int | None = None, rps: float | None = None,
        kill_ticks: int | None = None, hook=None) -> dict:
    """The row as written: its artifact (the reference's fields), plus
    ``cold_rows`` (the AOT pass's) and the children's built sources.
    ``hook(phase)``, where given, is a context manager entered around
    each phase (a caller's counters and clocks).  Raises if a gate
    fails."""
    import contextlib
    import shutil

    hook = hook or (lambda phase: contextlib.nullcontext())
    dev = resolve_device(device)
    n_reqs = n_reqs or int(os.environ.get("GOSSIP_SERVE_REQS", 2000))
    rps = rps or float(os.environ.get("GOSSIP_SERVE_RPS", 400.0))
    kill_ticks = kill_ticks or int(
        os.environ.get("GOSSIP_SERVE_KILL_TICKS", 400))
    work = tempfile.mkdtemp(prefix="serving_bench_")
    try:
        with hook("load"):
            load, st = load_phase(dev, n_reqs, rps)
        with hook("overload"):
            overload = overload_phase(dev)
        with hook("kill_recovery"):
            kill = kill_recovery(dev, kill_ticks, work)
        with hook("cold_start"):
            cold, traced, aot = cold_start(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {
        "round": 18,
        "platform": dev.type,
        "hardware_queued": False,
        "requests": n_reqs,
        "zipf_a": ZIPF_A,
        "arrival_rps": rps,
        "shape_pool": [f"n{p[0]}-t{p[1]}-m{p[2]}-ticks{p[3]}"
                       for p in POOL],
        "compiles": st["compiles"],
        "traced_buckets": st["traced_buckets"],
        "bucket_count": st["bucket_count"],
        "evictions": st["evictions"],
        "load": load,
        "overload": overload,
        "kill_recovery": kill,
        "cold_start": cold,
        "rows": [
            dict({"id": "load"}, **{k: v for k, v in load.items()
                                    if k != "wall_s_unrounded"}),
            dict({"id": "overload"}, **overload),
            dict({"id": "kill_recovery"},
                 **{k: v for k, v in kill.items() if k != "sources_built"}),
            dict({"id": "cold_start"}, **cold),
        ],
        "cold_rows": aot["rows"],
        "sources_built": kill["sources_built"] + [
            traced["sources_built"], aot["sources_built"]],
    }


def full_width(device=None, hook=None) -> dict:
    """The front end at the sweepd CLI's shape (module docstring): its
    stats, served/s, replica heartbeats/s, and whether its rows equal
    ``SweepServer.submit``'s at each bucket's shape.  ``hook(phase)``, a
    context manager, is entered around the ``front_end`` and the
    ``direct`` runs."""
    import contextlib

    from .sweepd import SweepServer

    hook = hook or (lambda phase: contextlib.nullcontext())
    dev = resolve_device(device)
    shape_ix, gaps = _zipf(FULL_POOL, FULL_REQS, FULL_RPS,
                           np.random.default_rng(SEED))
    fe = ScenarioFrontend(FrontendConfig(
        max_buckets=FULL_BUCKETS, batch=FULL_BATCH,
        server_kw={"seed": 0, "device": str(dev)}))
    with hook("front_end"):
        rows, wall = _serve_paced(fe, FULL_POOL, shape_ix, gaps,
                                  lambda i: f"f{i}")
    st = fe.stats()
    ok = [r for r in rows if r.get("ok")]
    specs = [quantize_shape(*FULL_POOL[ix]) for ix in shape_ix]
    ticks = sum(specs[int(r["id"][1:])].ticks for r in ok)
    # the same requests straight through a one-shape server per bucket
    by_bucket: dict = {}
    for i, spec in enumerate(specs):
        by_bucket.setdefault(spec, []).append(
            {"id": f"f{i}", "seed": int(i % 64)})
    direct = {}
    with hook("direct"):
        for spec, reqs in by_bucket.items():
            srv = SweepServer(n=spec.n, t=spec.t, m=spec.m,
                              ticks=spec.ticks, batch=FULL_BATCH, seed=0,
                              device=dev)
            for r in srv.submit(reqs):
                direct[r["id"]] = r

    def strip(r):
        return {k: v for k, v in r.items()
                if k not in ("batch", "queue_s", "bucket", "trace_id")}
    rows_equal = bool(ok) and all(strip(r) == strip(direct[r["id"]])
                                  for r in ok)
    return {
        "pool": [f"{p[0]}x{p[1]}x{p[2]}x{p[3]}" for p in FULL_POOL],
        "requests": FULL_REQS, "batch": FULL_BATCH,
        "max_buckets": FULL_BUCKETS,
        "distinct_shapes": len(set(int(i) for i in shape_ix)),
        "stats": st, "wall_s": wall,
        "served_per_s": st["served"] / wall,
        "replica_hbps": ticks / fe.wall_device_s
        if fe.wall_device_s else None,
        "rows_equal_submit": rows_equal,
    }


# -- the children ----------------------------------------------------------


def _sources_built() -> int:
    from .ops.kernels import _build
    return _build.compiled


def _kill_child(ns) -> int:
    dev = resolve_device(ns.device)
    if dev.type == "cuda":
        from .ops.kernels import _build
        _build.load("select")   # a launch's library, found built
    print(json.dumps({"child": "kill", "sources_built": _sources_built()}),
          flush=True)
    fe = ScenarioFrontend(kill_config(ns.ticks, ns.ckpt_dir, 2,
                                      device=str(dev)))
    lines = [kill_line(ns.ticks)] if ns.first else []
    fe.serve_lines(lines, sys.stdout, journal=ns.journal)
    return 0


def _cold_child(ns) -> int:
    t0 = time.perf_counter()
    dev = resolve_device(ns.device)
    fe = ScenarioFrontend(FrontendConfig(
        batch=4, max_buckets=4, aot_dir=ns.aot_dir,
        server_kw={"seed": 0, "device": str(dev)}))
    rows, first = cold_rows(fe, t0)
    st = fe.stats()
    print(json.dumps({
        "child": "cold", "cold": True,
        "first_result_s": round(first, 3),
        "total_s": round(time.perf_counter() - t0, 3),
        "compiles": st["compiles"], "aot_loads": st["aot_loads"],
        "aot_exports": st["aot_exports"],
        "traced_buckets": st["traced_buckets"],
        "rows": cold_table(rows),
        "sources_built": _sources_built(),
    }), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m go_libp2p_pubsub_tpu_torch.serving_bench",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", metavar="PATH",
                    help="write the row's artifact here (servestat reads it)")
    ap.add_argument("--full-width", action="store_true",
                    help="also serve the sweepd CLI's shape")
    ap.add_argument("--child", choices=("kill", "cold"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--ticks", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-dir", help=argparse.SUPPRESS)
    ap.add_argument("--journal", help=argparse.SUPPRESS)
    ap.add_argument("--first", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--aot-dir", help=argparse.SUPPRESS)
    ns = ap.parse_args(argv)
    if ns.child == "kill":
        return _kill_child(ns)
    if ns.child == "cold":
        return _cold_child(ns)
    dev = resolve_device(ns.device)
    art = run(dev)
    if ns.out:
        from .artifacts import write_json_atomic
        write_json_atomic(ns.out, art)
    out = {"serving": {k: v for k, v in art.items() if k != "cold_rows"},
           "cold_rows_equal_reference": art["cold_rows"]
           == REFERENCE_COLD_ROWS}
    if ns.full_width:
        out["full_width"] = full_width(dev)
    if dev.type == "cuda":
        from .flagship import card
        out["card"] = card()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
