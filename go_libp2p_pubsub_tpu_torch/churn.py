"""The scored GossipSub v1.1 churn configuration, its three readouts, and a
profile of its heartbeat.

The configuration is the one the JAX package's benchmark measures its
resilience on (bench_suite.py ``bench_gossipsub_v11_churn``): the
flagship (1,000,000 peers, 100 topics, C = 16, M = 32,
``ScoreSimConfig()``, seed 0, no first-tick records) under a fault
schedule: 10% of the peers down for one of three staggered 20-tick
waves, every link down 2% of the ticks, and the network split in half
over ticks [warmup + 20, warmup + 50), fault seed 1.  Messages are drawn
over [0, horizon - 40); the last four are the recovery probes, published
at heal - 2 from partition side 0.  100 warm-up heartbeats, then 150
timed ones through ``gossip_run_curve``.  ``build`` makes it at any size,
in the benchmark's draw order.  Its readouts (``readouts``): heartbeats/s,
the delivery fraction over the settled messages (gate: above 0.80), and
the median partition-heal recovery ticks of the probes (gate: at least
one probe reaches 99% of its topic).

    python -m go_libp2p_pubsub_tpu_torch.churn [--warmup 100] [--ticks 150] [--profile 20]

runs the benchmark as written on the GPU and prints one JSON object: its
readouts and gates, the device's peak memory, the time of one tick's
fault masks alone (the link draw), and a profile of ``--profile`` more
heartbeats (``flagship.profile_ticks``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .flagship import N_CAND, N_MSGS, N_PEERS, N_TOPICS, card, profile_ticks
from .models import _delivery
from .models import faults as fl
from .models import gossipsub as gs
from .resident import msgs, subs_matrix

WARMUP, TIMED = 100, 150
CHURN_FRAC, DROP_PROB, FAULT_SEED = 0.10, 0.02, 1
N_PROBES = 4
#: the benchmark's two gates
MIN_DELIVERY_FRACTION, RECOVERY_FRAC = 0.80, 0.99


def schedule(n: int, rng, start: int, horizon: int, *,
             cold_restart: bool = False) -> fl.FaultSchedule:
    """The benchmark's fault schedule from ``start`` (its warm-up): the
    victims drawn from ``rng`` (10%), each down for one of three
    staggered 20-tick waves from start + 5, 2% link loss, and a
    half/half partition over [start + 20, start + 50)."""
    victims = np.flatnonzero(rng.random(n) < CHURN_FRAC)
    wave = victims % 3 * 5
    ivs = np.stack([victims, start + 5 + wave, start + 25 + wave], axis=1)
    return fl.FaultSchedule(
        n_peers=n, horizon=horizon, down_intervals=ivs.tolist(),
        drop_prob=DROP_PROB,
        partition_group=(np.arange(n) < n // 2).astype(np.int64),
        partition_windows=[(start + 20, start + 50)], seed=FAULT_SEED,
        cold_restart=cold_restart)


def heal_tick(warmup: int = WARMUP) -> int:
    """The tick the partition heals at."""
    return warmup + 50


def build(device, n_peers: int = N_PEERS, n_topics: int = N_TOPICS,
          warmup: int = WARMUP, ticks: int = TIMED, seed: int = 0):
    """(cfg, score_cfg, params, state, msg_publish_tick, probes) of the
    benchmark over ``warmup + ticks`` heartbeats: messages over
    [0, horizon - 40), the last ``N_PROBES`` published at heal - 2 from
    partition side 0 (``probes``, their indices), then the schedule, in
    the benchmark's draw order."""
    n, t = n_peers, n_topics
    horizon = warmup + ticks
    heal = heal_tick(warmup)
    rng = np.random.default_rng(seed)
    cfg = gs.GossipSimConfig(
        offsets=gs.make_gossip_offsets(t, N_CAND, n, seed=seed),
        n_topics=t)
    sc = gs.ScoreSimConfig()
    topic, origin, tick = msgs(rng, n, t, N_MSGS, horizon - 40)
    probes = np.arange(N_MSGS - N_PROBES, N_MSGS)
    tick[probes] = heal - 2
    origin[probes] = (origin[probes] % (n // 2 // t)) * t + topic[probes]
    sched = schedule(n, rng, warmup, horizon)
    params, state = gs.make_gossip_sim(cfg, subs_matrix(n, t), topic,
                                       origin, tick, seed=seed, score_cfg=sc,
                                       track_first_tick=False,
                                       fault_schedule=sched, device=device)
    return cfg, sc, params, state, tick, probes


def readouts(params: gs.GossipParams, state: gs.GossipState,
             counts: torch.Tensor, probes: np.ndarray, n_topics: int,
             warmup: int = WARMUP) -> dict:
    """The benchmark's rows on a run's end state and its per-tick counts
    (``gossip_run_curve`` from ``warmup``): the delivery fraction of the
    settled messages (the final reach from the possession words over
    n / T each) and each probe's ticks from heal to 99% of its topic;
    ``ok`` is both gates."""
    n = params.subscribed.shape[0]
    m = params.publish_tick.shape[0]
    want = np.full(m, n // n_topics, dtype=np.float32)
    reach = gs.reach_counts_from_have(params, state).cpu().numpy()
    settled = np.ones(m, dtype=bool)
    settled[probes] = False
    frac = float((reach[settled] / want[settled]).mean())
    rec = _delivery.recovery_ticks(
        counts, heal_tick(warmup) - warmup,
        torch.from_numpy(want).to(counts.device),
        frac=RECOVERY_FRAC).cpu().numpy()[probes]
    rec_ok = rec[rec >= 0]
    out = dict(delivery_fraction=frac, settled_messages=int(settled.sum()),
               delivery_ok=frac > MIN_DELIVERY_FRACTION,
               probe_recovery_ticks=rec.tolist(),
               probes_recovered=int(len(rec_ok)),
               recovery_ticks_median=(float(np.median(rec_ok))
                                      if len(rec_ok) else None))
    out["ok"] = out["delivery_ok"] and len(rec_ok) > 0
    return out


def link_draw_ms(cfg, params: gs.GossipParams, tick: int,
                 reps: int = 20) -> float:
    """Mean time of one tick's fault masks (``faults.tick_masks``: the
    alive and candidate-alive words and the [C, N] link draw), by CUDA
    events over ``reps`` back-to-back calls."""
    def once():
        fl.tick_masks(params.faults, cfg.offsets, cfg.cinv, tick)

    once()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        once()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(warmup: int, ticks: int, n_profile: int) -> dict:
    """The benchmark as written on the GPU, then ``n_profile`` more
    heartbeats profiled."""
    dev = torch.device("cuda")
    cfg, sc, params, state, _, probes = build(dev, warmup=warmup,
                                              ticks=ticks)
    step = gs.make_gossip_step(cfg, sc, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = gs.gossip_run(params, state, warmup, step, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, counts = gs.gossip_run_curve(params, state, ticks, step,
                                        N_MSGS, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = readouts(params, state, counts, probes, cfg.n_topics, warmup)
    out.update(heartbeats_per_s=ticks / dt, ms_per_tick=dt * 1e3 / ticks,
               peak_bytes=torch.cuda.max_memory_allocated(),
               link_draw_ms=link_draw_ms(cfg, params,
                                         heal_tick(warmup) - 20))
    box = [state]

    def more():
        box[0] = gs.gossip_run(params, box[0], n_profile, step, device=dev)
    out["profile"] = profile_ticks(more, n_profile)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--ticks", type=int, default=TIMED)
    ap.add_argument("--profile", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the churn benchmark needs an NVIDIA GPU")
    out = run(args.warmup, args.ticks, args.profile)
    out["device"] = torch.cuda.get_device_name(0)
    out["card"] = card()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
