"""The scored GossipSub v1.1 flagship, and a profile of its heartbeat.

The flagship is the configuration the JAX package's benchmark measures
(bench_suite.py ``bench_gossipsub_v11``): 1,000,000 peers, 100 topics,
C = 16 circulant candidates, M = 32 messages published over the run's
horizon, ``ScoreSimConfig()`` (P1-P7 and the RED gater), seed 0, no
first-tick records.  ``build`` makes it at any size.

    python -m go_libp2p_pubsub_tpu_torch.flagship [--warmup 100] [--ticks 20]

times ``--ticks`` heartbeats of the 1M-peer flagship on the GPU after
``--warmup``, profiles as many more with torch.profiler, and prints one
JSON object: wall time per tick (unprofiled), device busy time per tick
(the sum of kernel times), the device's idle share, and the kernels and
PyTorch ops by device time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .models import gossipsub as gs

N_PEERS, N_TOPICS, N_CAND, N_MSGS = 1_000_000, 100, 16, 32


def build(device, n_peers: int = N_PEERS, n_topics: int = N_TOPICS,
          horizon: int = 400, seed: int = 0):
    """(cfg, score_cfg, params, state, msg_publish_tick) of the flagship;
    messages are published at ticks drawn over [0, horizon)."""
    n, t = n_peers, n_topics
    rng = np.random.default_rng(seed)
    cfg = gs.GossipSimConfig(
        offsets=gs.make_gossip_offsets(t, N_CAND, n, seed=seed),
        n_topics=t)
    sc = gs.ScoreSimConfig()
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    topic = rng.integers(0, t, N_MSGS)
    origin = rng.integers(0, n // t, N_MSGS) * t + topic
    tick = np.sort(rng.integers(0, horizon, N_MSGS)).astype(np.int32)
    params, state = gs.make_gossip_sim(cfg, subs, topic, origin, tick,
                                       seed=seed, score_cfg=sc,
                                       track_first_tick=False,
                                       device=device)
    return cfg, sc, params, state, tick


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def profile_ticks(run, ticks: int) -> dict:
    """Time ``run()`` (``ticks`` heartbeats on the GPU) unprofiled, then
    profile a second call: device time per kernel and per PyTorch op,
    and the device's busy time against the unprofiled wall time."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = sorted(((e.key, e.self_device_time_total, e.count)
                      for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda r: -r[1])
    ops = sorted(((e.key, e.device_time_total, e.count) for e in events
                  if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")
                  and e.device_time_total > 0),
                 key=lambda r: -r[1])
    busy_us = sum(r[1] for r in kernels)

    def per_tick(rows):
        return [{"name": k[:90], "ms_per_tick": us / ticks / 1e3,
                 "calls_per_tick": c / ticks} for k, us, c in rows[:20]]

    return {
        "ticks": ticks, "wall_ms_per_tick": wall_us / ticks / 1e3,
        "device_busy_ms_per_tick": busy_us / ticks / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
        "kernels": per_tick(kernels), "ops": per_tick(ops),
    }


def profile(warmup: int, ticks: int) -> dict:
    """Time ``ticks`` heartbeats after ``warmup``, then profile as many
    more (``profile_ticks``)."""
    dev = torch.device("cuda")
    cfg, sc, params, state, _ = build(dev, horizon=warmup + 2 * ticks)
    step = gs.make_gossip_step(cfg, sc, device=dev)
    box = [gs.gossip_run(params, state, warmup, step, device=dev)]

    def run():
        box[0] = gs.gossip_run(params, box[0], ticks, step, device=dev)
    return profile_ticks(run, ticks)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--ticks", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the profile needs an NVIDIA GPU")
    out = profile(args.warmup, args.ticks)
    out["device"] = torch.cuda.get_device_name(0)
    out["card"] = card()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
