"""The pipelined-gossip benchmark on event-driven delays, its two checks
at full width, and a profile of a delayed heartbeat.

The configuration is the JAX package's (bench_suite.py
``bench_gossipsub_pipelined``): 100,000 peers, 100 topics, C = 16
candidates (``make_gossip_offsets(100, 16, n, seed=7)``), M = 24
messages drawn by ``_msgs(default_rng(0), n, t, m, 8)`` (published over
ticks [0, 8)), ``ScoreSimConfig()``, seed 3, no first-tick records, the
delay line ``DelayConfig(base=1, jitter=0, k_slots=8)`` and telemetry with
the latency histogram alone (48 buckets).  ``build`` makes it at any size
(the full-width run: 1,000,000 peers, nothing else changed).

Its points sweep the heartbeat/RTT ratio through the delay knobs
(``POINTS``): ``base1`` (one tick a hop: the one-hop timing), ``base2``,
``base4`` and ``base4j2`` (jitter 2).  As the reference runs them
(``bench_suite.py:1231-1244``), ``run`` builds the four points with
``make_gossip_sim(..., sim_knobs=point)``, stacks them (``stack_trees``: a
replica stack whose delay knobs are ``[4]`` leaves) and advances the stack
48 ticks from build as ONE dispatch: ``telemetry_run_batch`` under one
telemetry step, one step a tick for the four replicas.  A batched tick
launches the delayed knob stack variant of the receive kernel,
``scored+delays+knobs``, once (48 launches) and no other receive variant,
the select kernel as often as one replica alone launches it, and no kernel
library is built during the timed run (the reference's ``compiles <=
1``).

Rows per point, read from its replica: the delivery fraction (the mean
over messages of ``reach_counts_from_have`` over the members per topic),
the latency percentiles p50/p90/p99 of its summed histogram
(``frames.latency_hist.sum(0)[i]``, ``histutil.hist_percentiles``) and the
histogram, the digest of every leaf of its state
(``knob_sweep.tree_digest``); then ``p99_stretch_base4`` (base4's p99
over base1's), the replica heartbeats/s (4 x 48 over the dispatch's wall
time, as the benchmark computes it), the launches and the peak memory.
Gates, the benchmark's own: every point's delivery fraction (rounded to 4
places, as the benchmark rounds it) at least base1's minus 0.05, and
every point with base > 1 filling at least two latency buckets.

``run_sequential`` is the same benchmark one point after another (one
built sim, each point armed on it by ``arm``: the params and gates
``make_gossip_sim(..., sim_knobs=point)`` builds, and run through
``telemetry_run``), each point's counts reset just before its run and
read just after; ``cross_check`` holds every replica of the batched run
to its point run alone, digest and histogram.

Two more checks (``identity``, ``steady_state``), at 1,000,000 peers on
the card: ``DelayConfig(1, 0, 1)`` on the flagship (``flagship.build``)
for 48 ticks gives the same digest of every leaf both runs share as the
flagship without delays (the reference's own pin); and the flagship with
``DelayConfig(4, 2, 8)`` beside the one without, 100 warm-up and 100 timed
heartbeats each, then 20 of the delayed one profiled (the delay draw, the
payload lines and the control line as ranges of their own).

    python -m go_libp2p_pubsub_tpu_torch.pipelined [--n 1000000] [--profile 20]

runs the benchmark (one batched dispatch) at ``--n`` peers and the two
checks on the GPU and prints one JSON object.

``family_sim`` builds the delayed sims of the receive families the delay
mode serves (the flagship's scored options, the attack options, the full
variant and unscored), which ``chip_smoke.py`` and ``kernel_ab.py`` hold
against the plain version.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from . import adversarial, convert, everything, flagship, resident
from .flagship import card, profile_ticks
from .histutil import hist_percentiles
from .knob_sweep import tree_digest
from .models import _batch
from .models import gossipsub as gs
from .models import telemetry as tl
from .models.delays import DelayConfig
from .ops.kernels import _build
from .ops.kernels import receive as krecv
from .ops.kernels import select as ksel

N_PEERS, N_TOPICS, N_CAND, N_MSGS = 100_000, 100, 16, 24
TICKS, K_SLOTS, MSG_HORIZON, SEED = 48, 8, 8, 3
FULL_WIDTH = 1_000_000
DELAYS = DelayConfig(base=1, jitter=0, k_slots=K_SLOTS)
#: the benchmark's telemetry: the latency histogram alone, a bucket a tick
TELEMETRY = dict(counters=False, wire=False, mesh=False, scores=False,
                 faults=False, latency_hist=True, latency_buckets=TICKS)
POINTS = {"base1": {"delay_base": 1}, "base2": {"delay_base": 2},
          "base4": {"delay_base": 4},
          "base4j2": {"delay_base": 4, "delay_jitter": 2}}
VARIANT = "scored+delays+knobs"
#: the steady-state check's delays and heartbeats
STEADY_DELAYS = DelayConfig(base=4, jitter=2, k_slots=K_SLOTS)
STEADY_WARMUP, STEADY_TIMED = 100, 100
#: a delayed configuration whose lines carry traffic within a few ticks:
#: the delayed receive families' sims (``family_sim``)
PROBE_DELAYS = DelayConfig(base=4, jitter=2, k_slots=8)


def build(device, n_peers: int = N_PEERS, sim_knobs: dict | None = None,
          delays: DelayConfig = DELAYS):
    """(cfg, score_cfg, params, state) of the benchmark's sim at
    ``n_peers`` (``sim_knobs``: a point built in)."""
    n, t, m = n_peers, N_TOPICS, N_MSGS
    rng = np.random.default_rng(0)
    topic = rng.integers(0, t, m)
    origin = rng.integers(0, n // t, m) * t + topic
    tick = np.sort(rng.integers(0, MSG_HORIZON, m)).astype(np.int32)
    cfg = gs.GossipSimConfig(
        offsets=gs.make_gossip_offsets(t, N_CAND, n, seed=7), n_topics=t)
    sc = gs.ScoreSimConfig()
    params, state = gs.make_gossip_sim(
        cfg, resident.subs_matrix(n, t), topic, origin, tick, seed=SEED,
        score_cfg=sc, delays=delays, track_first_tick=False,
        sim_knobs=sim_knobs, device=device)
    return cfg, sc, params, state


def arm(sim: tuple, point: dict) -> tuple:
    """``sim`` (built without knobs) armed at ``point``: the params and
    gates ``build(..., sim_knobs=point)`` makes."""
    cfg, sc, params, state = sim
    params = gs.knob_params(cfg, sc, params, sim_knobs=point, delays=DELAYS)
    return cfg, sc, params, gs.refresh_gates(cfg, sc, params, state)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build_stack(device, n_peers: int = N_PEERS) -> tuple:
    """(cfg, score_cfg, params, state): the four points built with their
    knobs (``build(..., sim_knobs=point)``) and stacked, replica i the
    i-th of ``POINTS``."""
    builds = [build(device, n_peers, sim_knobs=point)
              for point in POINTS.values()]
    cfg, sc = builds[0][:2]
    params = gs.stack_trees([b[2] for b in builds])
    state = gs.stack_trees([b[3] for b in builds])
    return cfg, sc, params, state


def _row(point: dict, reach: torch.Tensor, per_topic: int, hist: list,
         state) -> dict:
    return dict(
        delay_base=int(point.get("delay_base", DELAYS.base)),
        delay_jitter=int(point.get("delay_jitter", DELAYS.jitter)),
        delivery_fraction=float(reach.to(torch.float64).mean()) / per_topic,
        latency=hist_percentiles(hist), hist=hist,
        digest=tree_digest(convert.state_to_numpy(state)))


def run(device, n_peers: int = N_PEERS, ticks: int = TICKS) -> dict:
    """The benchmark as the reference runs it: the four points stacked
    and advanced as ONE dispatch (``telemetry_run_batch`` under one
    telemetry step), the launch counts reset just before and read just
    after.  The rows (each from its replica), the gates, the stretch, the
    replica rate, the launches (``launches_ok``: the delayed knob stack
    variant once a tick and no other receive variant, the select kernel
    launched) and whether a library was built during the run."""
    cfg, sc, params, state = build_stack(device, n_peers)
    step = gs.make_gossip_step(cfg, sc, device=device,
                               telemetry=tl.TelemetryConfig(**TELEMETRY))
    dev = params.subscribed.device
    if dev.type == "cuda":
        # the stack kernel's library, built (or loaded) before the clock
        _build.load(krecv.library(krecv.receive_consts(
            cfg, sc, delays=True, knobs=True), stacked=True))
    libs0 = set(_build._LIBS)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    krecv.launches.clear()
    ksel.launches = 0
    t0 = time.perf_counter()
    state, frames = tl.telemetry_run_batch(params, state, ticks, step)
    _sync(dev)
    wall = time.perf_counter() - t0
    launched = dict(krecv.launches)
    select_launches = ksel.launches
    built = sorted(set(_build._LIBS) - libs0)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    hists = frames.latency_hist.sum(0).cpu().tolist()           # [B, L]
    reach = gs.reach_counts_from_have(params, state)            # [B, M]
    per_topic = params.subscribed.shape[-1] // cfg.n_topics
    rows = {pid: _row(point, reach[i], per_topic, [int(c) for c in hists[i]],
                      _batch.index_trees(state, i))
            for i, (pid, point) in enumerate(POINTS.items())}
    del params, state, step, frames
    g = gates(rows)
    p99 = {pid: r["latency"]["p99"] for pid, r in rows.items()}
    # (the plain versions on the CPU launch nothing)
    launches_ok = (launched == {VARIANT: ticks} and select_launches > 0
                   or dev.type == "cpu")
    return dict(
        n_peers=n_peers, ticks=ticks, rows=rows, gates=g, p99=p99,
        p99_stretch_base4=p99["base4"] / max(p99["base1"] or 0, 1),
        wall_s=wall, replica_heartbeats_per_s=len(rows) * ticks / wall,
        launches=launched, select_launches=select_launches,
        launches_ok=launches_ok, libraries_built=built, peak_bytes=peak,
        ok=g["ok"] and launches_ok and not built)


def run_point(sim: tuple, step, point: dict, ticks: int = TICKS) -> dict:
    """One point armed on ``sim`` and run ``ticks`` from build by ``step``
    (the telemetry step), its launch counts reset just before and read
    just after: its row."""
    cfg, sc, params, state = arm(sim, point)
    dev = params.subscribed.device
    libs0 = set(_build._LIBS)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    krecv.launches.clear()
    ksel.launches = 0
    t0 = time.perf_counter()
    state, frames = tl.telemetry_run(params, state, ticks, step)
    _sync(dev)
    wall = time.perf_counter() - t0
    launched = dict(krecv.launches)
    hist = [int(c) for c in frames.latency_hist.sum(0).cpu().tolist()]
    reach = gs.reach_counts_from_have(params, state)
    row = _row(point, reach, params.subscribed.shape[0] // cfg.n_topics,
               hist, state)
    return dict(
        row, wall_s=wall, heartbeats_per_s=ticks / wall, launches=launched,
        select_launches=ksel.launches,
        launches_ok=launched == {VARIANT: ticks} and ksel.launches > 0,
        libraries_built=sorted(set(_build._LIBS) - libs0),
        peak_bytes=(torch.cuda.max_memory_allocated()
                    if dev.type == "cuda" else None))


def gates(rows: dict) -> dict:
    """The benchmark's two gates on the rows (delivery fractions rounded to
    4 places as it rounds them)."""
    base = round(rows["base1"]["delivery_fraction"], 4)
    delivery = {pid: round(r["delivery_fraction"], 4) >= base - 0.05
                for pid, r in rows.items()}
    buckets = {pid: sum(1 for c in r["hist"] if c) >= 2
               for pid, r in rows.items() if r["delay_base"] > 1}
    return dict(delivery=delivery, buckets=buckets,
                ok=all(delivery.values()) and all(buckets.values()))


def run_sequential(device, n_peers: int = N_PEERS,
                   ticks: int = TICKS) -> dict:
    """The benchmark one point after another: every point armed on one
    built sim and run by one telemetry step; the rows, the gates, the
    stretch and the replica rate, and the launch checks (every point's
    variant once a tick, no library built after the first)."""
    sim = build(device, n_peers)
    step = gs.make_gossip_step(sim[0], sim[1], device=device,
                               telemetry=tl.TelemetryConfig(**TELEMETRY))
    rows = {pid: run_point(sim, step, point, ticks)
            for pid, point in POINTS.items()}
    del sim, step
    g = gates(rows)
    p99 = {pid: r["latency"]["p99"] for pid, r in rows.items()}
    wall = sum(r["wall_s"] for r in rows.values())
    later = [r["libraries_built"] for r in list(rows.values())[1:]]
    # (the plain versions on the CPU launch nothing)
    launches_ok = (all(r["launches_ok"] for r in rows.values())
                   or torch.device(device).type == "cpu")
    return dict(
        n_peers=n_peers, ticks=ticks, rows=rows, gates=g, p99=p99,
        p99_stretch_base4=p99["base4"] / max(p99["base1"] or 0, 1),
        replica_heartbeats_per_s=len(rows) * ticks / wall,
        launches_ok=launches_ok, rebuilt_after_first=any(later),
        ok=g["ok"] and launches_ok and not any(later))


def cross_check(batched: dict, sequential: dict) -> dict:
    """Every replica of the batched run against its point run alone: the
    digest of every state leaf and the histogram equal, and the select
    kernel launched as often a batched tick as for one point."""
    same = {pid: row["digest"] == sequential["rows"][pid]["digest"]
            and row["hist"] == sequential["rows"][pid]["hist"]
            for pid, row in batched["rows"].items()}
    one = {r["select_launches"] for r in sequential["rows"].values()}
    select_same = one == {batched["select_launches"]}
    return dict(rows=same, select_one_point=sorted(one),
                select_batched=batched["select_launches"],
                ok=all(same.values()) and (
                    select_same or not batched["launches"]))


def _shared_digest(state) -> str:
    """The digest of every state leaf a run without delays also has."""
    tree = convert.state_to_numpy(state)
    for name in ("pay_line", "ctrl_line", "gsp_line", "adv_line"):
        tree[name] = None
    return tree_digest(tree)


def identity(device, n_peers: int = FULL_WIDTH, ticks: int = TICKS) -> dict:
    """The flagship with ``DelayConfig(1, 0, 1)`` and without delays,
    ``ticks`` from build: the digests of the leaves both carry."""
    out = {}
    for label, dc in (("plain", None), ("k1", DelayConfig(1, 0, 1))):
        cfg, sc, params, state, _ = flagship.build(
            device, n_peers=n_peers, horizon=ticks, delays=dc)
        step = gs.make_gossip_step(cfg, sc, device=device)
        state = gs.gossip_run(params, state, ticks, step, device=device)
        out[label] = _shared_digest(state)
        del params, state, step
    out["ok"] = out["plain"] == out["k1"]
    return out


def steady_state(device, n_peers: int = FULL_WIDTH,
                 warmup: int = STEADY_WARMUP, timed: int = STEADY_TIMED,
                 profile: int = 20) -> dict:
    """The flagship with ``STEADY_DELAYS`` and without delays on the same
    card: heartbeats/s over ``timed`` after ``warmup`` and peak memory
    each, launches; then ``profile`` more delayed heartbeats timed and
    profiled (``flagship.profile_ticks``, with the delay ranges)."""
    out = {}
    horizon = warmup + timed + 2 * profile
    for label, dc in (("plain", None), ("delayed", STEADY_DELAYS)):
        cfg, sc, params, state, _ = flagship.build(
            device, n_peers=n_peers, horizon=horizon, delays=dc)
        step = gs.make_gossip_step(cfg, sc, device=device)
        _sync(device)
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        krecv.launches.clear()
        state = gs.gossip_run(params, state, warmup, step, device=device)
        _sync(device)
        t0 = time.perf_counter()
        state = gs.gossip_run(params, state, timed, step, device=device)
        _sync(device)
        dt = time.perf_counter() - t0
        deg = gs.mesh_degrees(state)[params.subscribed].to(
            torch.float64).mean().item()
        out[label] = dict(
            heartbeats_per_s=timed / dt, ms_per_tick=dt * 1e3 / timed,
            mean_mesh_degree=deg, launches=dict(krecv.launches),
            peak_bytes=(torch.cuda.max_memory_allocated()
                        if torch.device(device).type == "cuda" else None))
        if label == "delayed" and profile:
            box = [state]

            def more():
                box[0] = gs.gossip_run(params, box[0], profile, step,
                                       device=device)
            out["profile_delayed"] = profile_ticks(more, profile,
                                                   ranges=("delays.",))
        del params, state, step
    return out


def family_sim(name: str, device, n_peers: int = FULL_WIDTH,
               delays: DelayConfig = PROBE_DELAYS, horizon: int = 400,
               knobs: dict | None = None,
               delays_probe: bool = False) -> tuple:
    """(cfg, score_cfg, params, state) of a delayed sim of one receive
    family: ``scored`` the flagship, ``attacks`` the adversarial
    configuration without the IWANT flood (which the delay mode refuses),
    ``full`` the everything-on configuration without it and with exact-k
    targets (flood publishing, PX, direct peers, the shared-IP gater),
    ``unscored`` the resident configuration (``horizon`` its messages'
    publish window); ``knobs``, a point armed on it; ``delays_probe``, the
    RPC probe's line too."""
    if name == "scored":
        cfg, sc, params, state = flagship.build(
            device, n_peers=n_peers, horizon=horizon)[:4]
    elif name == "attacks":
        cfg, sc, params, state = adversarial.build(
            device, n_peers=n_peers, horizon=horizon, iwant_spam=False)[:4]
    elif name == "full":
        cfg, sc, params, state = everything.build(
            device, n_peers=n_peers, horizon=horizon)[:4]
        sc = dataclasses.replace(sc, sybil_iwant_spam=False)
        cfg = dataclasses.replace(cfg, binomial_gossip_sampling=False)
    elif name == "unscored":
        cfg, params, state = resident.build(device, n_peers=n_peers,
                                            horizon=horizon)[:3]
        sc = None
    else:
        raise ValueError(f"no delayed receive family {name!r}")
    params, state = gs.arm_delays(sc, params, state, delays,
                                  delays_probe=delays_probe)
    if knobs is not None:
        params = gs.knob_params(cfg, sc, params, sim_knobs=knobs,
                                delays=delays)
    return cfg, sc, params, gs.refresh_gates(cfg, sc, params, state)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=FULL_WIDTH)
    ap.add_argument("--profile", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the pipelined benchmark needs an NVIDIA GPU")
    dev = torch.device("cuda")
    out = dict(benchmark=run(dev, args.n), identity=identity(dev, args.n),
               steady_state=steady_state(dev, args.n,
                                         profile=args.profile))
    out["device"] = torch.cuda.get_device_name(0)
    out["card"] = card()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
