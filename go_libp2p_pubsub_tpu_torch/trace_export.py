"""The trace-export pipeline: the JAX package's trace-export benchmark as
written (``bench_suite.py`` ``_trace_export_run``, the body of
``bench_gossipsub_trace_export`` and its kernel twin), unpadded.

One faulted, scored GossipSub run at 100,000 peers — 100 topics (peer p
in topic p mod 100), M = 16 messages published over ticks [0, 4), C = 16
candidates (``make_gossip_offsets(100, 16, n, seed=0)``),
``ScoreSimConfig()``, the first two messages invalid and published by
sybil origins, about 0.2% of the peers down for two or three ticks
(``(p, 1 + p % 2, 4 + p % 2)``), link loss 0.02 (fault seed 1) — is
collected three times on the device, each run from the built state:

- ``telemetry_run_curve`` for ``T_TEL`` = 6 ticks with
  ``TelemetryConfig(latency_hist=True, latency_buckets=16)``: the final
  state's first-delivery ticks, the per-tick delivered counts and the
  frames;
- ``gossip_run_acq_snapshots`` for ``T_ACQ`` = 6 ticks: possession and
  mesh after each tick;
- ``gossip_run_rpc_snapshots`` for ``T_RPC`` = 2 ticks with the RPC probe.

The host then exports six streams (``interop/export.py``: deliveries with
churn, mesh GRAFT/PRUNE, REJECT, DUPLICATE, peer ADD/REMOVE and the RPC
SEND/RECV/DROP), merges them into the 13-type trace, writes it in the
reference tracer's pb format with the frames sidecar, and checks it:
13/13 event types, its SHA-256 against ``REFERENCE_SHA256`` (the JAX
package's XLA twin at 100,000 peers wrote the same bytes), and the port's
``tracestat`` report against the committed ``OBS_r10.json``
(``--check``: coverage and the tick-domain p99).

``collect`` runs the device side and returns a bundle of host arrays
(picklable, so ``export`` can run in another process); ``export`` writes
and checks; ``run`` does both.  ``probe_forms`` steps the RPC probe on
every per-tick family (``PROBE_FORMS``, 20,000 peers) and digests its
snapshots: ``chip_smoke.py`` holds the card's to the CPU's.

    python -m go_libp2p_pubsub_tpu_torch.trace_export [--n 100000]
        [--out DIR]

runs it on the GPU (a temporary directory by default) and prints one JSON
object: ``n_events``, ``bytes_total``, ``collect_s``, ``export_s``,
``write_s``, events/s and bytes/event, the trace's SHA-256, the tracestat
check, the receive kernel's launches by variant and the select kernel's.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile
import time
from collections import Counter
from dataclasses import fields, replace
from pathlib import Path

import numpy as np
import torch

from . import (adversarial, churn, convert, everything, flagship, knob_sweep,
               loops_flagship, pipelined, resident)
from .device import resolve_device
from .interop import export as ex
from .knob_sweep import tree_digest
from .models import faults as fl
from .models import gossipsub as gs
from .models import invariants as iv
from .models import telemetry as tl
from .ops.kernels import receive as krecv
from .ops.kernels import select as kselect
from .tracestat import check_regression, stats

N_PEERS, N_TOPICS, N_MSGS, N_CAND = 100_000, 100, 16, 16
T_TEL, T_RPC = 6, 2
T_ACQ = T_TEL
TEL = dict(latency_hist=True, latency_buckets=16)

#: SHA-256 of the 100,000-peer trace file the JAX package's XLA twin
#: writes (``JAX_PLATFORMS=cpu python tests/torch_reference_gate.py
#: --trace-export``, which prints it): the port's trace must be these bytes
REFERENCE_SHA256 = (
    "74085f035ef68e38ba0604d7c4760853b22ec8d3d18275455a8cef9dd86182c7")

#: the committed tracestat baseline the trace is checked against
BASELINE = Path(__file__).resolve().parents[1] / "OBS_r10.json"


def draws(n: int = N_PEERS) -> dict:
    """The benchmark's inputs at ``n`` peers, in its draw order
    (``default_rng(0)``: the messages, then the down victims): subs,
    messages, the invalid flags and sybil origins, the fault schedule's
    keyword arguments and each peer's topic."""
    t, m = N_TOPICS, N_MSGS
    rng = np.random.default_rng(0)
    topic, origin, tick = resident.msgs(rng, n, t, m, 4)
    invalid = np.zeros(m, dtype=bool)
    invalid[:2] = True
    sybil = np.zeros(n, dtype=bool)
    sybil[origin[:2]] = True
    victims = np.flatnonzero(rng.random(n) < 0.002)
    sched = dict(n_peers=n, horizon=T_TEL,
                 down_intervals=[(int(p), 1 + int(p % 2), 4 + int(p % 2))
                                 for p in victims],
                 drop_prob=0.02, seed=1)
    return dict(subs=resident.subs_matrix(n, t), topic=topic,
                origin=origin, tick=tick, invalid=invalid, sybil=sybil,
                sched=sched, peer_topic=(np.arange(n) % t).astype(np.int64))


def build(d: dict, device):
    """``(cfg, sc, params, state, schedule)`` of the benchmark's sim from
    ``draws``' inputs."""
    n = d["subs"].shape[0]
    cfg = gs.GossipSimConfig(
        offsets=gs.make_gossip_offsets(N_TOPICS, N_CAND, n, seed=0),
        n_topics=N_TOPICS)
    sc = gs.ScoreSimConfig()
    sched = fl.FaultSchedule(**d["sched"])
    params, state = gs.make_gossip_sim(
        cfg, d["subs"], d["topic"], d["origin"], d["tick"], score_cfg=sc,
        sybil=d["sybil"], msg_invalid=d["invalid"], fault_schedule=sched,
        device=device)
    return cfg, sc, params, state, sched


def _cpu_frames(frames: tl.TelemetryFrame) -> tl.TelemetryFrame:
    return replace(frames, **{
        f.name: getattr(frames, f.name).cpu() for f in fields(frames)
        if getattr(frames, f.name) is not None})


def collect(device: str | torch.device | None = None,
            n_peers: int = N_PEERS) -> dict:
    """The device side: the three runs from the built state, their
    outputs brought to the host.  Returns the bundle ``export`` takes,
    with ``collect_s`` (wall seconds of the runs and the copies, the
    benchmark's clock), the receive kernel's launches by variant and the
    select kernel's (counted from zero here) and, on the card, the peak
    device memory."""
    dev = resolve_device(device)
    d = draws(n_peers)
    cfg, sc, params, state, sched = build(d, dev)
    m = N_MSGS
    tcfg = tl.TelemetryConfig(**TEL)
    krecv.launches.clear()
    kselect.launches = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, counts, frames = tl.telemetry_run_curve(
        params, gs.tree_copy(state), T_TEL,
        gs.make_gossip_step(cfg, sc, device=dev, telemetry=tcfg), m)
    _, snaps = gs.gossip_run_acq_snapshots(
        params, gs.tree_copy(state), T_ACQ,
        gs.make_gossip_step(cfg, sc, device=dev), device=dev)
    _, rsnaps = gs.gossip_run_rpc_snapshots(
        params, state, T_RPC,
        gs.make_gossip_step(cfg, sc, device=dev, rpc_probe=True),
        device=dev)
    bundle = dict(
        n=n_peers, offsets=tuple(cfg.offsets), sched=sched,
        **{k: d[k] for k in ("topic", "origin", "tick", "invalid",
                             "peer_topic")},
        ftm=gs.first_tick_matrix(out, m).cpu().numpy(),
        have=ex.host_array(snaps["have"]), mesh=ex.host_array(snaps["mesh"]),
        rpc=ex.host_snapshots(rsnaps), counts=counts.cpu().numpy(),
        frames=_cpu_frames(frames), tel=TEL)
    bundle["collect_s"] = time.perf_counter() - t0
    bundle["receive_launches"] = dict(krecv.launches)
    bundle["select_launches"] = kselect.launches
    bundle["peak_bytes"] = (torch.cuda.max_memory_allocated()
                            if dev.type == "cuda" else None)
    return bundle


def export(bundle: dict, out_dir: str | os.PathLike,
           baseline: str | os.PathLike | None = BASELINE) -> dict:
    """The host side: the six streams merged, the pb trace and the frames
    sidecar written into ``out_dir``, the trace's SHA-256 and the port's
    tracestat report checked against ``baseline`` (None: no check).
    Returns the benchmark's rows and the checks; raises, as the benchmark
    asserts, unless all 13 event types are present."""
    n, offsets, sched = bundle["n"], bundle["offsets"], bundle["sched"]
    topic, origin, tick = bundle["topic"], bundle["origin"], bundle["tick"]
    peer_topic = bundle["peer_topic"]
    t0 = time.perf_counter()
    merged = ex.merge_event_streams(
        ex.events_from_sim(bundle["ftm"], topic, origin, tick,
                           fault_schedule=sched, peer_topic=peer_topic),
        ex.mesh_trace_events(bundle["mesh"], offsets, peer_topic),
        ex.reject_events(bundle["have"], bundle["invalid"], topic),
        ex.duplicate_events(bundle["have"], bundle["mesh"], offsets, topic),
        ex.peer_events(offsets, n, fault_schedule=sched),
        ex.rpc_events(bundle["rpc"], offsets, topic, peer_topic, n_true=n))
    export_s = time.perf_counter() - t0
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "gossipsub_trace_export.pb"
    fr_path = out_dir / "gossipsub_trace_export_frames.json"
    t0 = time.perf_counter()
    ex.write_pb_trace(str(path), merged)
    ex.write_telemetry_frames(
        str(fr_path), bundle["frames"], tl.TelemetryConfig(**bundle["tel"]),
        counts=bundle["counts"], publish_tick=tick, msg_topic=topic)
    write_s = time.perf_counter() - t0
    n_events = len(merged)
    n_bytes = os.path.getsize(path)
    types = Counter(ex.TraceType.NAMES[e.type] for e in merged)
    del merged
    if len(types) != len(ex.TraceType.NAMES):
        # the benchmark's own assertion: every reference event type
        raise RuntimeError(f"only {len(types)} event types: {dict(types)}")
    sha = hashlib.sha256(path.read_bytes()).hexdigest()
    report = stats([str(path)], frames_path=str(fr_path))
    problems = None
    if baseline is not None:
        with open(baseline) as f:
            problems = check_regression(report, json.load(f))
    dt = export_s + write_s
    return dict(
        n_peers=n, n_events=n_events, bytes_total=n_bytes,
        collect_s=bundle["collect_s"], export_s=export_s, write_s=write_s,
        events_per_s=n_events / dt, bytes_per_event=n_bytes / n_events,
        sha256=sha, types=dict(sorted(types.items())),
        n_types=len(types), tracestat=report, check_problems=problems,
        receive_launches=bundle["receive_launches"],
        select_launches=bundle["select_launches"],
        peak_bytes=bundle["peak_bytes"], trace=str(path),
        frames=str(fr_path))


# -- the probe's forms: each per-tick family, card against CPU ---------------

FORM_PEERS, FORM_TICKS = 20_000, 8
#: the families (the earlier benchmarks' builders) and the modes each runs
#: in: clean, under the churn benchmark's kind of schedule from tick 0,
#: faulted with every telemetry group, at a knob point, faulted with the
#: invariant checker; the delayed families (``pipelined.family_sim``, the
#: probe line armed); the receive loops (``loops_flagship.build``)
PROBE_FAMILIES = ("scored", "unscored", "attack", "full", "paired",
                  "paired_unscored")
PROBE_MODES = ("clean", "faults", "telemetry", "knobs", "armed")
PROBE_DELAYED = ("scored", "attacks", "full", "unscored")
PROBE_LOOPS = ("byzantine", "p3", "wide")
PROBE_FORMS = ([f"{f}/{m}" for f in PROBE_FAMILIES for m in PROBE_MODES]
               + [f"{f}/delays" for f in PROBE_DELAYED]
               + [f"loops/{k}" for k in PROBE_LOOPS])
#: the knob point of the scored forms (protocol and defense knobs), of the
#: unscored ones (the protocol knobs); the IWANT flood takes the hardened
#: defense through ``score_knobs``
PROBE_KNOBS = {"gossip_factor": 0.4, "d_lazy": 4, "backoff_ticks": 6,
               "invalid_message_deliveries_weight": -20.0,
               "behaviour_penalty_weight": -40.0,
               "graylist_threshold": -60.0, "gossip_threshold": -5.0}
PROBE_TEL = dict(latency_hist=True, degree_hist=True, score_hist=True,
                 latency_buckets=16)


def probe_form(label: str, device, n: int):
    """``(cfg, sc, params, state, telemetry, invariants)`` of one probe
    form (``PROBE_FORMS``) at ``n`` peers."""
    fam, mode = label.split("/")
    tcfg = icfg = None
    if fam == "loops":
        cfg, sc, params, state = loops_flagship.build(mode, device, n,
                                                      horizon=48)[:4]
        if state.inv_viol is not None:
            icfg = iv.InvariantConfig()
        return cfg, sc, params, state, None, icfg
    if mode == "delays":
        cfg, sc, params, state = pipelined.family_sim(
            fam, device, n, horizon=16, delays_probe=True)
        return cfg, sc, params, state, None, None
    if fam in ("unscored", "paired_unscored"):
        cfg, params, state = resident.build(
            device, n_peers=n, horizon=16, paired=fam == "paired_unscored")[:3]
        sc = None
    else:
        cfg, sc, params, state = {
            "scored": lambda: flagship.build(device, n_peers=n, horizon=48),
            "attack": lambda: adversarial.build(device, n_peers=n,
                                                horizon=48),
            "full": lambda: everything.build(device, n_peers=n, horizon=48),
            "paired": lambda: everything.build(device, n_peers=n, horizon=48,
                                               paired=True),
        }[fam]()[:4]
    if mode in ("faults", "telemetry", "armed"):
        sched = churn.schedule(n, np.random.default_rng(3), 0, 400)
        params = replace(params, faults=fl.compile_faults(
            sched, cfg.offsets, device=device))
    if mode == "telemetry":
        tcfg = tl.TelemetryConfig(**PROBE_TEL)
    elif mode == "armed":
        state, icfg = iv.attach(state), iv.InvariantConfig()
    elif mode == "knobs":
        if sc is None:
            surface = dict(sim_knobs={k: PROBE_KNOBS[k] for k in (
                "gossip_factor", "d_lazy", "backoff_ticks")})
        elif sc.sybil_iwant_spam:
            surface = dict(score_knobs=knob_sweep.DEFENSE_POINTS["hardened"])
        else:
            surface = dict(sim_knobs=PROBE_KNOBS)
        params = gs.knob_params(cfg, sc, params, **surface)
        state = gs.refresh_gates(cfg, sc, params, state)
    return cfg, sc, params, state, tcfg, icfg


def probe_forms(device=None, n_peers: int = FORM_PEERS,
                ticks: int = FORM_TICKS, check_plain: bool = False,
                labels=PROBE_FORMS) -> dict:
    """``{label: {"digest": ..., "plain_equal": ...}}``: each probe form
    stepped ``ticks`` ticks at ``n_peers`` with the probe
    (``gossip_run_rpc_snapshots``), the digest of every tick's snapshot
    and the end state; with ``check_plain`` the probe-free step too, its
    end state equal to the probe step's but for the probe line (else
    None)."""
    dev = resolve_device(device)
    out = {}
    for label in labels:
        cfg, sc, params, state, tcfg, icfg = probe_form(label, dev, n_peers)
        kw = dict(device=dev, telemetry=tcfg, invariants=icfg)
        end, snaps = gs.gossip_run_rpc_snapshots(
            params, gs.tree_copy(state), ticks,
            gs.make_gossip_step(cfg, sc, rpc_probe=True, **kw), device=dev)
        end_np = convert.state_to_numpy(end)
        row = dict(digest=tree_digest(dict(snaps=ex.host_snapshots(snaps),
                                           state=end_np)), plain_equal=None)
        if check_plain:
            plain = gs.gossip_run(params, state, ticks,
                                  gs.make_gossip_step(cfg, sc, **kw),
                                  device=dev)
            row["plain_equal"] = (
                tree_digest(dict(convert.state_to_numpy(plain),
                                 probe_line=None))
                == tree_digest(dict(end_np, probe_line=None)))
        out[label] = row
        del params, state, end, snaps
    return out


def run(device: str | torch.device | None = None, n_peers: int = N_PEERS,
        out_dir: str | os.PathLike | None = None) -> dict:
    """The benchmark as written on ``device`` (default ``cuda``): collect,
    then export into ``out_dir`` (a temporary directory, removed after,
    when None).  ``ok``: 13 event types, the tracestat check clean and, at
    100,000 peers, the reference's SHA-256."""
    bundle = collect(device, n_peers)
    if out_dir is None:
        with tempfile.TemporaryDirectory() as tmp:
            rows = export(bundle, tmp)
    else:
        rows = export(bundle, out_dir)
    rows["digest_ok"] = (rows["sha256"] == REFERENCE_SHA256
                         if n_peers == N_PEERS else None)
    rows["ok"] = (rows["n_types"] == 13 and not rows["check_problems"]
                  and rows["digest_ok"] is not False)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N_PEERS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    rows = run(n_peers=args.n, out_dir=args.out)
    rows.pop("tracestat")
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
