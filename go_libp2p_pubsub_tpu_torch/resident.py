"""The unscored GossipSub v1.0 resident-window configuration, and a
profile of its two paths.

The configuration is the one the JAX package's benchmark measures its
tick-resident window on (bench_suite.py ``bench_gossipsub_resident``):
1,048,576 peers, 10 topics, C = 16 circulant candidates (offsets seed 7),
M = 24 messages (W = 1), every peer subscribed to its residue-class
topic, messages drawn with seed 0, sim seed 3, unscored, T = 8 ticks per
fused window.  ``build`` makes it at any size.

    python -m go_libp2p_pubsub_tpu_torch.resident [--warmup 64] [--ticks 32]

times ``--ticks`` heartbeats of the 1M-peer configuration on the GPU
after ``--warmup``, on the per-tick step and on fused windows, profiles
as many more of each with torch.profiler, and prints one JSON object:
per path, wall time per tick (unprofiled), device busy time per tick
(the sum of kernel times), the device's idle share, and the kernels and
PyTorch ops by device time (``flagship.profile_ticks``).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .flagship import card, profile_ticks
from .models import gossipsub as gs

N_PEERS, N_TOPICS, N_CAND, N_MSGS, WINDOW = 1_048_576, 10, 16, 24, 8
OFFSETS_SEED, SIM_SEED, MSG_SEED = 7, 3, 0


def subs_matrix(n: int, t: int, paired: bool = False) -> np.ndarray:
    """Every peer subscribed to its residue-class topic p mod t (and,
    ``paired``, to p mod t + t/2 as well)."""
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    if paired:
        subs[np.arange(n), (np.arange(n) % t + t // 2) % t] = True
    return subs


def msgs(rng, n: int, t: int, m: int, horizon: int):
    """m messages: topic, origin in the topic's class, publish tick in
    [0, horizon), sorted."""
    topic = rng.integers(0, t, m)
    origin = rng.integers(0, n // t, m) * t + topic
    tick = np.sort(rng.integers(0, horizon, m)).astype(np.int32)
    return topic, origin, tick


def build(device, n_peers: int = N_PEERS, n_topics: int = N_TOPICS,
          horizon: int = 8, exact_k: bool = False, paired: bool = False,
          fault_schedule=None):
    """(cfg, params, state, msg_topic, msg_publish_tick); messages are
    published at ticks drawn over [0, horizon) (the benchmark's 8: half
    its 16-tick run); ``exact_k`` draws the gossip targets as exact
    k-subsets (``binomial_gossip_sampling=False``); ``paired`` subscribes
    every peer to its class r and to r + T/2 (paired topics, per tick
    only: the fused window refuses them); ``fault_schedule`` runs it
    under faults."""
    n, t = n_peers, n_topics
    cfg = gs.GossipSimConfig(
        offsets=gs.make_gossip_offsets(t, N_CAND, n, seed=OFFSETS_SEED,
                                       paired=paired),
        n_topics=t, binomial_gossip_sampling=not exact_k,
        paired_topics=paired)
    topic, origin, tick = msgs(np.random.default_rng(MSG_SEED), n, t,
                               N_MSGS, horizon)
    params, state = gs.make_gossip_sim(cfg, subs_matrix(n, t, paired),
                                       topic, origin, tick,
                                       seed=SIM_SEED,
                                       track_first_tick=False,
                                       fault_schedule=fault_schedule,
                                       device=device)
    return cfg, params, state, topic, tick


def topic_reach(params: gs.GossipParams, state: gs.GossipState,
                msg_topic: np.ndarray, n_topics: int):
    """Per message: the members of its topic (subscribed peers p with
    p mod T == topic) that hold it, and the topic's member count.  N need
    not be a multiple of T: at the ring's wrap candidates cross residue
    classes, so peers of other classes may hold a message too; they are
    not counted."""
    n = params.subscribed.shape[0]
    cls = torch.arange(n, device=params.subscribed.device) % n_topics
    reach, members = [], []
    for m, tau in enumerate(msg_topic.tolist()):
        mask = params.subscribed & (cls == tau)
        reach.append(int(gs.reach_counts_from_have(params, state,
                                                   mask)[m]))
        members.append(int(mask.sum()))
    return np.array(reach), np.array(members)


def profile(warmup: int, ticks: int) -> dict:
    """Both paths after ``warmup`` ticks: ``ticks`` timed, then as many
    profiled (``ticks`` and ``warmup`` whole windows)."""
    dev = torch.device("cuda")
    out = {}
    for path in ("per_tick", "fused"):
        cfg, params, state, _, _ = build(dev,
                                         horizon=warmup + 2 * ticks)
        if path == "fused":
            win = gs.make_fused_window(cfg, None, ticks_fused=WINDOW,
                                       device=dev)

            def run_n(st, n):
                return gs.gossip_run_fused(params, st, n, win, device=dev)
        else:
            step = gs.make_gossip_step(cfg, None, device=dev)

            def run_n(st, n):
                return gs.gossip_run(params, st, n, step, device=dev)
        box = [run_n(state, warmup)]

        def run():
            box[0] = run_n(box[0], ticks)
        out[path] = profile_ticks(run, ticks)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warmup", type=int, default=64)
    ap.add_argument("--ticks", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the profile needs an NVIDIA GPU")
    out = profile(args.warmup, args.ticks)
    out["device"] = torch.cuda.get_device_name(0)
    out["card"] = card()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
