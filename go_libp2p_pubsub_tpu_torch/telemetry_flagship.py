"""The telemetry-kernel benchmark: the scored flagship with telemetry off
against on, its rows and gates, and a profile of the telemetry heartbeat.

The configuration is the one the JAX package's benchmark measures its
observation cost on (bench_suite.py ``bench_gossipsub_telemetry_kernel``):
the flagship (100 topics, C = 16, M = 32, ``ScoreSimConfig()``, seed 0,
no first-tick records) at n = 1,024,000 peers, 1M rounded up to a
multiple of lcm(100, 4096, 8192) as the benchmark rounds it, with
``TelemetryConfig()`` at its defaults (counters, wire, mesh, scores and
faults on, histograms off).  Messages are drawn over the 400-tick horizon
in the benchmark's order (``flagship.build``).  Each mode builds its own
sim: 100 warm-up heartbeats, then 3 timed windows of 100, off through
``gossip_run``, on through ``telemetry_run`` with each window's frames
summarized (``summarize_frames``) inside the timing, as the benchmark
does.  Rows: both rates (heartbeats/s), the telemetry overhead in percent,
the control-overhead ratio (control bytes over payload bytes) and its
totals over the timed windows.  Gates: on both runs the flagship's (mean
mesh degree at least Dlo, every message published 30 ticks before the end
at every peer of its topic); the two runs' states equal by a digest of
every state leaf (telemetry only reads); some payload sent and a finite
ratio; the receive kernel's flagship variant launched once per tick on the
off-run and its telemetry variant (``scored+tel``) once per tick on the
on-run, no other.

    python -m go_libp2p_pubsub_tpu_torch.telemetry_flagship [--profile 20]

(``--warmup 100 --ticks 100 --reps 3`` by default) runs the benchmark as
written on the GPU and prints one JSON object: its
rows and gates, and profiles of ``--profile`` more heartbeats with and
without telemetry (``flagship.profile_ticks``), with the telemetry groups
the step adds around the kernel timed alone (the start-of-tick scores'
extra [C, N] pass and the mesh gauges).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import time
from dataclasses import fields, is_dataclass

import torch

from . import flagship
from .models import gossipsub as gs
from .models import telemetry as tl
from .ops.graph import expand_bits, popcount32
from .ops.kernels import receive as krecv
from .ops.kernels import select as ksel

WARMUP, TICKS, REPS = 100, 100, 3
#: the totals the benchmark reports beside the ratio
TOTALS = ("bytes_payload", "bytes_control", "payload_sent", "ihave_ids",
          "iwant_ids_served", "graft_sends", "prune_sends")


def bench_peers(named: int = 1_000_000, n_topics: int = flagship.N_TOPICS,
                block: int = 8192) -> int:
    """The benchmark's n: ``named`` rounded up to a multiple of
    lcm(topics, 4096, block)."""
    q = math.lcm(n_topics, 4096, block)
    return -(-named // q) * q


N_PEERS = bench_peers()


def build(device, n_peers: int = N_PEERS, warmup: int = WARMUP,
          ticks: int = TICKS, reps: int = REPS):
    """(cfg, score_cfg, params, state, msg_publish_tick) of the benchmark
    over ``warmup + ticks * reps`` heartbeats."""
    return flagship.build(device, n_peers=n_peers,
                          horizon=warmup + ticks * reps)


def state_digest(state: gs.GossipState) -> str:
    """sha256 of every state leaf (nested score state and gate words
    included) and the host scalars."""
    h = hashlib.sha256()

    def add(x):
        if isinstance(x, torch.Tensor):
            h.update(x.detach().cpu().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
        elif is_dataclass(x):
            for f in fields(x):
                add(getattr(x, f.name))
        elif isinstance(x, tuple):
            for v in x:
                add(v)
        else:
            h.update(repr(x).encode())
    add(state)
    return h.hexdigest()[:16]


def flagship_gates(cfg, params, state, msg_tick, horizon: int) -> dict:
    """The flagship's two gates on an end state: mean mesh degree of the
    subscribed peers at least Dlo, every message published 30 ticks before
    the end at every peer of its topic."""
    sub = params.subscribed
    deg = gs.mesh_degrees(state)[sub].to(torch.float64).mean().item()
    reach = gs.reach_counts_from_have(params, state).cpu().numpy()
    settled = msg_tick < horizon - 30
    want = params.subscribed.shape[0] // cfg.n_topics
    delivered = bool((reach[settled] == want).all())
    return dict(mean_mesh_degree=deg, settled_messages=int(settled.sum()),
                delivered=delivered,
                ok=deg >= cfg.d_lo and delivered)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(device, n_peers: int = N_PEERS, warmup: int = WARMUP,
        ticks: int = TICKS, reps: int = REPS) -> dict:
    """The benchmark as written on ``device``: off, then on, each from its
    own built sim, the launch counts reset just before each run and read
    just after (on the CPU the plain versions run and nothing launches:
    the rows and totals, not the rates, are what such a run is for)."""
    dev = torch.device(device)
    horizon = warmup + ticks * reps
    tcfg = tl.TelemetryConfig()
    out = {"n_peers": n_peers}
    for mode in ("off", "on"):
        cfg, sc, params, state, msg_tick = build(dev, n_peers, warmup,
                                                 ticks, reps)
        step = gs.make_gossip_step(cfg, sc, device=dev, telemetry=(
            tcfg if mode == "on" else None))
        _sync(dev)
        krecv.launches.clear()
        ksel.launches = 0
        summaries = []
        if mode == "off":
            state = gs.gossip_run(params, state, warmup, step, device=dev)
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(reps):
                state = gs.gossip_run(params, state, ticks, step,
                                      device=dev)
                _sync(dev)
        else:
            state, _ = tl.telemetry_run(params, state, warmup, step)
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(reps):
                state, frames = tl.telemetry_run(params, state, ticks, step)
                summaries.append(tl.summarize_frames(frames))
        dt = time.perf_counter() - t0
        out[mode] = dict(
            heartbeats_per_s=ticks * reps / dt,
            ms_per_tick=dt * 1e3 / (ticks * reps),
            launches=dict(krecv.launches, select=ksel.launches),
            digest=state_digest(state),
            gates=flagship_gates(cfg, params, state, msg_tick, horizon))
        if mode == "on":
            totals = {k: sum(s[k] for s in summaries) for k in TOTALS}
            out["totals"] = totals
            out["control_overhead_ratio"] = (
                totals["bytes_control"] / totals["bytes_payload"]
                if totals["bytes_payload"] > 0 else 0.0)
            out["final_mesh_deg_mean"] = summaries[-1]["final_mesh_deg_mean"]
        del params, state, step
    out["telemetry_overhead_pct"] = 100.0 * (
        out["off"]["heartbeats_per_s"] / out["on"]["heartbeats_per_s"] - 1.0)
    n_ticks = warmup + ticks * reps
    checks = dict(
        gates=out["off"]["gates"]["ok"] and out["on"]["gates"]["ok"],
        digest=out["off"]["digest"] == out["on"]["digest"],
        frames=(out["totals"]["payload_sent"] > 0
                and math.isfinite(out["control_overhead_ratio"])
                and out["control_overhead_ratio"] > 0),
        # (the CPU runs the plain versions: nothing launches)
        launches=dev.type != "cuda" or (
            {k: v for k, v in out["off"]["launches"].items()
             if k != "select"} == {"scored": n_ticks}
            and {k: v for k, v in out["on"]["launches"].items()
                 if k != "select"} == {"scored+tel": n_ticks}))
    out["checks"] = checks
    out["ok"] = all(checks.values())
    return out


def _events_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile(warmup: int, n_profile: int) -> dict:
    """Profiles of ``n_profile`` heartbeats with and without telemetry
    after ``warmup``, and the telemetry groups the step adds around the
    kernel, each timed alone on the warmed state (CUDA events)."""
    dev = torch.device("cuda")
    cfg, sc, params, state, _ = build(dev, warmup=warmup,
                                      ticks=2 * n_profile, reps=1)
    out = {}
    tcfg = tl.TelemetryConfig()
    for mode in ("off", "on"):
        step = gs.make_gossip_step(cfg, sc, device=dev, telemetry=(
            tcfg if mode == "on" else None))
        box = [gs.gossip_run(params, state, warmup, step, device=dev)]

        def more(step=step, box=box):
            box[0] = gs.gossip_run(params, box[0], n_profile, step,
                                   device=dev)
        out[mode] = flagship.profile_ticks(more, n_profile)
    st = box[0]
    C = cfg.n_candidates
    sub_all = torch.where(params.subscribed, (1 << C) - 1, 0).to(torch.int32)

    def scores_group():
        score = gs.compute_scores(sc, params, st)
        mask = expand_bits(params.cand_sub_bits & sub_all, C)
        tl.score_stats(score, mask, sc.gossip_threshold)

    def mesh_group():
        tl.degree_stats(popcount32(st.mesh), params.subscribed)

    out["scores_group_ms"] = _events_ms(scores_group)
    out["mesh_group_ms"] = _events_ms(mesh_group)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--ticks", type=int, default=TICKS)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--profile", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the telemetry benchmark needs an NVIDIA GPU")
    out = run("cuda", warmup=args.warmup, ticks=args.ticks, reps=args.reps)
    out["profile"] = profile(args.warmup, args.profile)
    out["device"] = torch.cuda.get_device_name(0)
    out["card"] = flagship.card()
    print(json.dumps(out))
    if not out["ok"]:
        raise SystemExit(f"telemetry benchmark checks failed: {out['checks']}")


if __name__ == "__main__":
    main()
