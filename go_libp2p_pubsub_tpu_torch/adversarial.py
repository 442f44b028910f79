"""The adversarial scored GossipSub v1.1 configuration, and a profile of
its heartbeat.

The configuration is the one the JAX package's benchmark measures its
score defences on (bench_suite.py ``bench_gossipsub_v11_adversarial``):
the flagship (1,000,000 peers, 100 topics, C = 16, M = 32, seed 0, no
first-tick records) with 20% sybils (``default_rng(7)``) running both
gossip-repair attacks at once, IHAVE broken-promise spam and the IWANT
retransmission flood, and every message published by an honest peer.
``build`` makes it at any size, in the benchmark's draw order.  Its
gates (``gates``): the honest subscribed peers' mean mesh degree, every
settled message held by every honest member of its topic, and every
edge's IWANT-serve ledger under (gossip_retransmission + 1) * 32 * W;
and whether the attacks are live (``attack_levels``).

    python -m go_libp2p_pubsub_tpu_torch.adversarial [--warmup 100] [--ticks 20]

times ``--ticks`` heartbeats of the 1M-peer configuration on the GPU
after ``--warmup``, profiles as many more with torch.profiler, and prints
one JSON object as ``flagship.profile_ticks`` does.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .flagship import N_CAND, N_MSGS, N_PEERS, N_TOPICS, card, profile_ticks
from .models import gossipsub as gs
from .resident import msgs, subs_matrix

SYBIL_FRAC, SYBIL_SEED = 0.2, 7


def draws(n: int, t: int, horizon: int, seed: int = 0):
    """(sybil, msg_topic, msg_origin, msg_publish_tick) in the
    benchmark's order: the messages first, then honest origins from the
    same generator; the sybils from their own."""
    rng = np.random.default_rng(seed)
    sybil = np.random.default_rng(SYBIL_SEED).random(n) < SYBIL_FRAC
    topic, _, tick = msgs(rng, n, t, N_MSGS, horizon)
    honest_ids = np.flatnonzero(~sybil)
    pick = honest_ids[rng.integers(0, len(honest_ids), N_MSGS)]
    return sybil, (pick % t).astype(topic.dtype), pick, tick


def build(device, n_peers: int = N_PEERS, n_topics: int = N_TOPICS,
          horizon: int = 400, seed: int = 0, iwant_spam: bool = True,
          sim_knobs: dict | None = None):
    """(cfg, score_cfg, params, state, msg_topic, msg_publish_tick,
    sybil); messages are published at ticks drawn over [0, horizon).
    ``iwant_spam=False`` leaves the IWANT flood off (the IHAVE spam
    alone: a knob sweep's defense configuration); ``sim_knobs``
    (``make_gossip_sim``'s) arms a knob point."""
    n, t = n_peers, n_topics
    sybil, topic, origin, tick = draws(n, t, horizon, seed)
    cfg = gs.GossipSimConfig(
        offsets=gs.make_gossip_offsets(t, N_CAND, n, seed=seed),
        n_topics=t)
    # both gossip-repair attacks at once (gossipsub_spam_test.go:135, :24)
    sc = gs.ScoreSimConfig(sybil_ihave_spam=True,
                           sybil_iwant_spam=iwant_spam)
    params, state = gs.make_gossip_sim(cfg, subs_matrix(n, t), topic,
                                       origin, tick, seed=seed,
                                       score_cfg=sc, sybil=sybil,
                                       track_first_tick=False,
                                       sim_knobs=sim_knobs, device=device)
    return cfg, sc, params, state, topic, tick, sybil


def honest_reach(params: gs.GossipParams, state: gs.GossipState,
                 msg_topic: np.ndarray, n_topics: int,
                 paired: bool = False):
    """Per message: the honest peers that hold it, and the honest
    members of its topic (p mod T == topic; ``paired``, also p mod T +
    T/2 == topic), as the benchmark counts them."""
    honest = ~params.sybil
    reach = gs.reach_counts_from_have(params, state, mask=honest)
    n = honest.shape[0]
    cls = torch.arange(n, device=honest.device) % n_topics
    second = (cls + n_topics // 2) % n_topics

    def members(tau):
        return (cls == tau) | (second == tau) if paired else cls == tau

    want = torch.stack([(honest & members(tau)).sum()
                        for tau in msg_topic.tolist()])
    return reach.cpu().numpy(), want.cpu().numpy()


def honest_degree(params: gs.GossipParams, state: gs.GossipState) -> float:
    """Mean mesh degree of the honest subscribed peers."""
    keep = params.subscribed & ~params.sybil
    return gs.mesh_degrees(state)[keep].to(torch.float64).mean().item()


def attack_levels(params: gs.GossipParams, state: gs.GossipState):
    """(largest behaviour penalty, largest sybil row of the serve
    ledger): both above 0 while the attacks are live.  The ledger decays
    to 0 within ticks of the last advert, so read these during a run,
    not only at its end."""
    bp = float(state.scores.behaviour_penalty.float().max())
    return bp, int(state.iwant_serves[:, params.sybil].max())


def gates(cfg, params, state, msg_topic, msg_tick, horizon: int) -> dict:
    """The benchmark's three gates on the run's end state (the mesh
    degree is slot A's where topics are paired); ``ok`` is all of
    them."""
    deg = honest_degree(params, state)
    reach, want = honest_reach(params, state, msg_topic, cfg.n_topics,
                               cfg.paired_topics)
    settled = msg_tick < horizon - 30
    serves_max = int(state.iwant_serves.max())
    # the IWANT flood accrues only while s < retrans * padv, so every
    # ledger stays below (retrans + 1) * padv <= (retrans + 1) * 32 * W
    cap = (cfg.gossip_retransmission + 1) * 32 * params.origin_words.shape[0]
    out = dict(
        honest_mean_degree=deg, degree_ok=deg >= cfg.d_lo,
        settled_messages=int(settled.sum()),
        delivery_ok=bool((reach[settled] == want[settled]).all()),
        serves_max=serves_max, serves_cap=cap)
    out["containment_ok"] = serves_max < out["serves_cap"]
    out["ok"] = (out["degree_ok"] and out["delivery_ok"]
                 and out["containment_ok"])
    if not out["delivery_ok"]:
        out["reach"] = reach[settled].tolist()
        out["want"] = want[settled].tolist()
    return out


def profile(warmup: int, ticks: int) -> dict:
    """Time ``ticks`` heartbeats after ``warmup``, then profile as many
    more (``profile_ticks``)."""
    dev = torch.device("cuda")
    cfg, sc, params, state, *_ = build(dev, horizon=warmup + 2 * ticks)
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
