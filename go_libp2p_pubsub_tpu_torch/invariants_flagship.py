"""The invariants-kernel benchmark: the scored flagship with the in-step
invariant checker off against on, its rows and gates, and a profile of
the armed heartbeat.

The configuration is the one the JAX package's benchmark measures the
checker's cost on (bench_suite.py ``bench_gossipsub_invariants_kernel``,
body ``_bench_invariants(kernel=True)``): the flagship (100 topics,
C = 16, M = 32, ``ScoreSimConfig()``, seed 0, no first-tick records) at
n = 1,024,000 peers — 1,000,000 rounded up to a multiple of lcm(100,
4096, 8192) = 204,800 as the benchmark rounds it — with its 32 messages
drawn by ``default_rng(0)`` over the 200-tick horizon in the benchmark's
order (``flagship.build``).  The benchmark pads the sim to 8192 peers a
block for its TPU kernel; 1,024,000 = 125 · 8192, so the pad is empty and
the port builds unpadded (``tests/test_torch_invariants.py`` shows the
reference's padded sim equal to its unpadded one at a multiple of its
block).  Each mode builds its own sim: "off" steps it without the
checker, "on" arms it (``invariants.attach``) and steps it with
``InvariantConfig()`` (all three groups); each runs 100 warm-up and 100
timed heartbeats through ``gossip_run``.

Rows: both rates (heartbeats/s), ``invariant_overhead_pct`` = 100 ·
(off / on − 1), and the on-run's ``report`` (read once, after the timing:
the checker itself never syncs).  Gates: ``bits == 0``; on both runs the
flagship's (mean mesh degree at least Dlo, every message published 30
ticks before the end at every peer of its topic); every state leaf equal
between the two runs but the two carry scalars (a digest of every leaf);
the receive kernel's flagship variant once per tick on both runs and no
other, and the select kernel as many times on both.

    python -m go_libp2p_pubsub_tpu_torch.invariants_flagship [--profile 20]

(``--warmup 100 --ticks 100`` by default) runs the benchmark as written on
the GPU and prints one JSON object: its rows and gates, and profiles of
``--profile`` more heartbeats with and without the checker
(``flagship.profile_ticks``: the device busy time a tick of each, whose
difference is the checker's device time).
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace

import torch

from . import convert, flagship, knob_sweep, telemetry_flagship
from .models import gossipsub as gs
from .models import invariants as iv
from .ops.kernels import receive as krecv
from .ops.kernels import select as ksel

WARMUP, TICKS = 100, 100
N_PEERS = telemetry_flagship.bench_peers()


def build(device, n_peers: int = N_PEERS, warmup: int = WARMUP,
          ticks: int = TICKS):
    """(cfg, score_cfg, params, state, msg_publish_tick) of the benchmark
    over ``warmup + ticks`` heartbeats."""
    return flagship.build(device, n_peers=n_peers, horizon=warmup + ticks)


def unarmed(state: gs.GossipState) -> gs.GossipState:
    """``state`` without the checker's two scalars."""
    return replace(state, inv_viol=None, inv_first=None)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(device, n_peers: int = N_PEERS, warmup: int = WARMUP,
        ticks: int = TICKS) -> dict:
    """The benchmark as written on ``device``: off, then on, each from its
    own built sim, the launch counts reset just before each run and read
    just after (on the CPU the plain versions run and nothing launches:
    the report, gates and digests, not the rates, are what such a run is
    for).  ``tree_digest``: each end state's ``knob_sweep.tree_digest``
    (every leaf, the carry too), for holding a run against the
    reference's."""
    dev = torch.device(device)
    horizon = warmup + ticks
    out = {"n_peers": n_peers}
    for mode in ("off", "on"):
        cfg, sc, params, state, msg_tick = build(dev, n_peers, warmup, ticks)
        icfg = None
        if mode == "on":
            state, icfg = iv.attach(state), iv.InvariantConfig()
        step = gs.make_gossip_step(cfg, sc, device=dev, invariants=icfg)
        _sync(dev)
        krecv.launches.clear()
        ksel.launches = 0
        state = gs.gossip_run(params, state, warmup, step, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        state = gs.gossip_run(params, state, ticks, step, device=dev)
        _sync(dev)
        dt = time.perf_counter() - t0
        row = dict(
            heartbeats_per_s=ticks / dt, ms_per_tick=dt * 1e3 / ticks,
            launches=dict(krecv.launches, select=ksel.launches),
            digest=telemetry_flagship.state_digest(unarmed(state)),
            tree_digest=knob_sweep.tree_digest(convert.state_to_numpy(state)),
            gates=telemetry_flagship.flagship_gates(cfg, params, state,
                                                    msg_tick, horizon))
        if mode == "on":
            out["report"] = iv.report(state)
        out[mode] = row
        del params, state, step
    out["invariant_overhead_pct"] = 100.0 * (
        out["off"]["heartbeats_per_s"] / out["on"]["heartbeats_per_s"] - 1.0)
    n_ticks = warmup + ticks
    launches = out["off"]["launches"], out["on"]["launches"]
    checks = dict(
        bits=out["report"]["bits"] == 0 and out["report"]["first_tick"] == -1,
        gates=out["off"]["gates"]["ok"] and out["on"]["gates"]["ok"],
        digest=out["off"]["digest"] == out["on"]["digest"],
        # (the CPU runs the plain versions: nothing launches)
        launches=launches[0] == launches[1] and (
            dev.type != "cuda"
            or ({k: v for k, v in launches[0].items() if k != "select"}
                == {"scored": n_ticks} and launches[0]["select"] > 0)))
    out["checks"] = checks
    out["ok"] = all(checks.values())
    return out


def profile(warmup: int, n_profile: int) -> dict:
    """Profiles of ``n_profile`` heartbeats with and without the checker
    after ``warmup``; ``busy_delta_ms``: the checker's device time a tick
    (the armed busy time less the unarmed)."""
    dev = torch.device("cuda")
    cfg, sc, params, state, _ = build(dev, warmup=warmup,
                                      ticks=2 * n_profile)
    out = {}
    for mode in ("off", "on"):
        icfg = iv.InvariantConfig() if mode == "on" else None
        step = gs.make_gossip_step(cfg, sc, device=dev, invariants=icfg)
        s0 = iv.attach(state) if mode == "on" else state
        box = [gs.gossip_run(params, s0, warmup, step, device=dev)]

        def more(step=step, box=box):
            box[0] = gs.gossip_run(params, box[0], n_profile, step,
                                   device=dev)
        out[mode] = flagship.profile_ticks(more, n_profile)
    out["busy_delta_ms"] = (out["on"]["device_busy_ms_per_tick"]
                            - out["off"]["device_busy_ms_per_tick"])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--ticks", type=int, default=TICKS)
    ap.add_argument("--profile", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the invariants benchmark needs an NVIDIA GPU")
    out = run("cuda", warmup=args.warmup, ticks=args.ticks)
    out["profile"] = profile(args.warmup, args.profile)
    out["device"] = torch.cuda.get_device_name(0)
    out["card"] = flagship.card()
    print(json.dumps(out))
    if not out["ok"]:
        raise SystemExit(f"invariants benchmark checks failed: "
                         f"{out['checks']}")


if __name__ == "__main__":
    main()
