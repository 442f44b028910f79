"""The JAX package's batched flagship benchmark, as written, on the port.

Counterpart of ``bench_suite.py`` ``bench_gossipsub_v11_batched``: B
replicas of the scored v1.1 flagship (1,000,000 peers, 100 topics, C = 16,
M = 32 messages, ``ScoreSimConfig()``), the ring and the messages drawn
once with seed 0 as the benchmark draws them (``flagship.inputs``), each
replica's mesh seed its index (``make_gossip_sim(seed=r)``, r = 0..B-1),
stacked on a replica axis and advanced by ONE step a tick
(``gossip_run_batch``: B1 once, B3 as often as one replica's tick): 100
warm-up ticks, then 3 timed blocks of 100.  Its gates, per replica: the
mesh formed (the mean degree of every replica's subscribed peers at least
Dlo), every message published 30 ticks before the end reached every
subscriber of its topic, and every IWANT-serve ledger under the flood
cap.  The metric is replica heartbeats per second (B × the ticks of one
trajectory per wall-clock second).

    python -m go_libp2p_pubsub_tpu_torch.batched_flagship [--replicas 4]

runs it on the GPU and prints one JSON object: the rate, the device's
busy time and launches per batched tick and its idle share over 20
profiled ticks, the peak device memory, the gates and the card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import convert, flagship
from .knob_sweep import tree_digest
from .models import gossipsub as gs
from .ops.kernels import receive as krecv
from .ops.kernels import select as kselect

N_REPLICAS = 4
WARMUP, TIMED, BLOCKS = 100, 100, 3


def build(device, n_peers: int = flagship.N_PEERS, replicas: int = N_REPLICAS,
          horizon: int = WARMUP + TIMED * BLOCKS):
    """``(cfg, score_cfg, params_B, state_B, msg_publish_tick)``: the
    flagship's draws with seed 0, one replica a mesh seed 0..B-1."""
    cfg, subs, topic, origin, tick = flagship.inputs(n_peers,
                                                     horizon=horizon)
    sc = gs.ScoreSimConfig()
    params, state = gs.stack_sims(
        cfg, [dict(seed=r) for r in range(replicas)], device=device,
        subs=subs, msg_topic=topic, msg_origin=origin,
        msg_publish_tick=tick, score_cfg=sc, track_first_tick=False)
    return cfg, sc, params, state, tick


def gates(cfg, params, state, tick, horizon: int) -> dict:
    """The benchmark's gates over every replica: the mean mesh degree of
    the subscribed peers, the settled messages' reach against the topic
    size, the IWANT-serve ledgers' maximum against the flood cap;
    failures raise."""
    n, t = params.subscribed.shape[-1], cfg.n_topics
    sub = params.subscribed
    deg = gs.mesh_degrees(state)[sub].to(torch.float64)
    mean_deg = float(deg.mean())
    if mean_deg < cfg.d_lo:
        raise AssertionError(f"mesh failed to form: mean {mean_deg}")
    settled = tick < horizon - 30
    reach = gs.reach_counts_from_have(params, state).cpu().numpy()
    if not (reach[:, settled] == n // t).all():
        raise AssertionError(f"delivery gate: {reach[:, settled]}")
    cap = ((cfg.gossip_retransmission + 1) * 32
           * params.origin_words.shape[-2])
    serves = int(state.iwant_serves.max())
    if serves >= cap:
        raise AssertionError(f"IWANT containment: {serves} >= {cap}")
    return {"mean_mesh_degree": mean_deg,
            "min_replica_mesh_degree": min(
                float(gs.mesh_degrees(state)[b][sub[b]].float().mean())
                for b in range(sub.shape[0])),
            "settled_msgs": int(settled.sum()), "iwant_serves_max": serves,
            "iwant_cap": cap}


def run(device, n_peers: int = flagship.N_PEERS,
        replicas: int = N_REPLICAS, profile: int = 20,
        check_replica0: bool = False) -> dict:
    """The benchmark as written (``build``, 100 warm-up and 3 × 100 timed
    ticks, ``gates``), then ``profile`` more ticks profiled
    (``flagship.profile_ticks``); with ``check_replica0`` also replica
    0's digest against one seed-0 sim run alone over the same ticks, and
    that run's B3 launches a tick over the timed ticks.  The
    returned dict also holds the run's ``params``, final ``state`` and
    ``step`` (a caller that prints it pops them)."""
    horizon = WARMUP + TIMED * BLOCKS
    torch.cuda.reset_peak_memory_stats(device)
    cfg, sc, params, state, tick = build(device, n_peers, replicas,
                                         horizon)
    step = gs.make_gossip_step(cfg, sc, device=device)
    state = gs.gossip_run_batch(params, state, WARMUP, step, device=device)
    torch.cuda.synchronize(device)
    kselect.launches = 0
    krecv.launches.clear()
    t0 = time.perf_counter()
    for _ in range(BLOCKS):
        state = gs.gossip_run_batch(params, state, TIMED, step,
                                    device=device)
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    ticks = TIMED * BLOCKS
    launches = {"select": kselect.launches / ticks,
                **{k: v / ticks for k, v in krecv.launches.items()}}
    out = {"replicas": replicas, "n_peers": n_peers,
           "replica_heartbeats_per_s": replicas * ticks / dt,
           "wall_s": dt, "launches_per_batched_tick": launches,
           "gates": gates(cfg, params, state, tick, horizon)}
    if check_replica0:
        c1, s1, p1, st1, _ = flagship.build(device, n_peers,
                                            horizon=horizon, seed=0)
        step1 = gs.make_gossip_step(c1, s1, device=device)
        st1 = gs.gossip_run(p1, st1, WARMUP, step1, device=device)
        kselect.launches = 0
        st1 = gs.gossip_run(p1, st1, ticks, step1, device=device)
        # B3's launches a tick of one replica alone, over the same ticks
        out["select_launches_one_replica"] = kselect.launches / ticks
        d_batch = tree_digest(convert.state_to_numpy(
            gs.index_trees(state, 0)))
        d_alone = tree_digest(convert.state_to_numpy(st1))
        if d_batch != d_alone:
            raise AssertionError("replica 0 differs from the seed-0 sim "
                                 "run alone")
        out["replica0_digest"] = d_batch[:16]
        del p1, st1
    if profile:
        box = [state]

        def more():
            box[0] = gs.gossip_run_batch(params, box[0], profile, step,
                                         device=device)
        prof = flagship.profile_ticks(more, profile)
        out["profile"] = {k: prof[k] for k in (
            "wall_ms_per_tick", "device_busy_ms_per_tick",
            "device_idle_share", "launches_per_tick")}
        out["profile"]["kernels"] = prof["kernels"][:8]
        state = box[0]
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    out.update(params=params, state=state, step=step)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--replicas", type=int, default=N_REPLICAS)
    ap.add_argument("--n", type=int, default=flagship.N_PEERS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the batched flagship needs an NVIDIA GPU")
    dev = torch.device("cuda")
    out = run(dev, args.n, args.replicas)
    for key in ("params", "state", "step"):
        out.pop(key)
    out["device"] = torch.cuda.get_device_name(0)
    out["card"] = flagship.card()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
