"""The everything-on scored GossipSub v1.1 configuration with one topic
per peer, and a profile of its heartbeat.

The configuration is the JAX package's widest single-run benchmark
(bench_suite.py ``bench_gossipsub_v11_everything``) without its paired
topics, plus the two protocol options the reference library turns on for
real deployments: the flagship (1,000,000 peers, 100 topics, C = 16,
M = 32, seed 0, no first-tick records) with ``topic_score_cap=50``, 20%
sybils (``default_rng(7)``) running IHAVE broken-promise spam and the
IWANT retransmission flood from behind shared addresses (four to an IP:
P6 and the gater's per-IP grouping), honest origins, flood publishing, PX
candidate rotation over ``px_candidates=14`` of the 16 candidates, and a
sparse operator-pinned direct overlay (every peer p with p mod 1009 == 0,
on candidate 0 and its inverse).  ``build`` makes it at any size, in the
benchmark's draw order.  Its gates are the adversarial configuration's
(``adversarial.gates``); ``options_live`` shows each option at work.

    python -m go_libp2p_pubsub_tpu_torch.everything [--warmup 100] [--ticks 20]

times ``--ticks`` heartbeats of the 1M-peer configuration on the GPU
after ``--warmup``, profiles as many more with torch.profiler, and prints
one JSON object as ``flagship.profile_ticks`` does, with the PX
epilogue's share of the device time (the select launch of phase 7 is
not told apart from the other selections there; the re-emitted targets
row is timed on its own).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import adversarial
from .flagship import N_CAND, N_PEERS, N_TOPICS, card, profile_ticks
from .models import gossipsub as gs
from .resident import subs_matrix

PX_CANDIDATES = 14
DIRECT_MODULUS = 1009
SYBILS_PER_IP = 4
TOPIC_SCORE_CAP = 50.0


def score_config() -> gs.ScoreSimConfig:
    return gs.ScoreSimConfig(topic_score_cap=TOPIC_SCORE_CAP,
                             sybil_ihave_spam=True, sybil_iwant_spam=True,
                             flood_publish=True)


def overlay(offsets, cinv, n: int, sybil: np.ndarray):
    """(direct_edges bool [N, C], peer_ip [N]) as the benchmark makes
    them: a direct edge on candidates (0, cinv[0]) wherever either
    endpoint is pinned (p mod 1009 == 0), symmetric by construction; the
    sybils, in index order, four to an address above every honest one."""
    pinned = (np.arange(n) % DIRECT_MODULUS) == 0
    de = np.zeros((n, len(offsets)), dtype=bool)
    for c in (0, cinv[0]):
        de[:, c] = pinned | np.roll(pinned, -int(offsets[c]))
    ip = np.arange(n)
    sid = np.flatnonzero(sybil)
    ip[sid] = n + np.arange(len(sid)) // SYBILS_PER_IP
    return de, ip


def build(device, n_peers: int = N_PEERS, n_topics: int = N_TOPICS,
          horizon: int = 400, seed: int = 0):
    """(cfg, score_cfg, params, state, msg_topic, msg_publish_tick,
    sybil); messages are published at ticks drawn over [0, horizon)."""
    n, t = n_peers, n_topics
    sybil, topic, origin, tick = adversarial.draws(n, t, horizon, seed)
    cfg = gs.GossipSimConfig(
        offsets=gs.make_gossip_offsets(t, N_CAND, n, seed=seed),
        n_topics=t)
    sc = score_config()
    de, ip = overlay(cfg.offsets, cfg.cinv, n, sybil)
    params, state = gs.make_gossip_sim(
        cfg, subs_matrix(n, t), topic, origin, tick, seed=seed,
        score_cfg=sc, sybil=sybil, peer_ip=ip, direct_edges=de,
        px_candidates=PX_CANDIDATES, track_first_tick=False, device=device)
    return cfg, sc, params, state, topic, tick, sybil


def direct_in_mesh(params: gs.GossipParams, state: gs.GossipState) -> int:
    """Mesh edges that are direct edges (the router never grafts one)."""
    return int((state.mesh & params.cand_direct != 0).sum())


def options_live(params: gs.GossipParams, state0: gs.GossipState,
                 state: gs.GossipState) -> dict:
    """What a run's end state shows of each option (``state0`` the built
    state): peers whose active word was rotated, direct edges found in a
    mesh (must be 0), the same-IP sibling words present and the lowest
    static (P5 + P6) score a sybil candidate carries (below 0 under
    shared addresses)."""
    syb_static = params.cand_static_score[params.cand_sybil]
    return dict(
        active_rotated=int((state.active != state0.active).sum()),
        direct_in_mesh=direct_in_mesh(params, state),
        same_ip_words=params.cand_same_ip is not None,
        sybil_static_min=(float(syb_static.min()) if syb_static.numel()
                          else 0.0))


def profile(warmup: int, ticks: int) -> dict:
    """Time ``ticks`` heartbeats after ``warmup``, then profile as many
    more (``profile_ticks``); then the PX epilogue's re-emitted targets
    row alone, by CUDA events over ``ticks`` calls."""
    dev = torch.device("cuda")
    cfg, sc, params, state, *_ = build(dev, horizon=warmup + 2 * ticks)
    step = gs.make_gossip_step(cfg, sc, device=dev)
    box = [gs.gossip_run(params, state, warmup, step, device=dev)]

    def run():
        box[0] = gs.gossip_run(params, box[0], ticks, step, device=dev)
    out = profile_ticks(run, ticks)
    st = box[0]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(ticks):
        gs.gossip_targets_row(cfg, sc, params, mesh=st.mesh,
                              fanout=st.fanout, active=st.active,
                              gossip_row=st.gates[1], tick=st.tick,
                              salt=st.salt)
    end.record()
    torch.cuda.synchronize()
    out["px_targets_row_ms_per_tick"] = start.elapsed_time(end) / ticks
    return out


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
