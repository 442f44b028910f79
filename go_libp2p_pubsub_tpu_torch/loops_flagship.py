"""The receive loops at full width: the flagship's widths on each form of
the loops, with their gates, rates and a profile.

The three configurations (``build``):

- ``byzantine`` — the combined loops: the tournament's byzantine ×
  reference cell (``tournament.py``: every attack behaviour compiled in,
  a SimKnobs point at the config's values, a cold-restart schedule whose
  churn intervals are no-ops, the first 20% of the peers mutating what
  they relay, honest origins, the grid's draws) at the flagship's widths:
  1,000,000 peers, 100 topics, C = 16, M = 32 messages over the first 60%
  of the horizon, seed 0, the invariant checker armed;
- ``p3`` — the split loops: the flagship (``flagship.py``'s draws) with
  the P3/P3b configuration of the JAX package's
  ``tests/test_gossipsub_v11_sim.py`` (P3 and P3b weights -1, delivery
  threshold 0.5) and one message published a tick, so M = the horizon;
- ``wide`` — the split loops at C = 32: the flagship's config with 32
  candidates (``ScoreSimConfig()``), M = 32 over the horizon.

``run`` steps one of them ``warmup`` + ``timed`` heartbeats through
``gossip_run`` and returns its rows (heartbeats/s, peak memory, the
kernels' launches) and its gates: every message published 30 ticks before
the end held by every honest member of its topic; byzantine, P4 on some
edge from a mutator at the end of the warm-up or of the run and on no
other edge, the checker's report clean; p3, some mesh edge with P3
credit and some edge with a P3b penalty; and on every form B1 never
launched and B3 launched.

    python -m go_libp2p_pubsub_tpu_torch.loops_flagship [--kind byzantine]
        [--warmup 50] [--ticks 100] [--profile 10]

runs one on the GPU and prints its rows, gates and a profile of
``--profile`` more heartbeats (``flagship.profile_ticks``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import flagship, tournament
from .models import gossipsub as gs
from .models import invariants as iv
from .ops import graph
from .ops.kernels import receive as krecv
from .ops.kernels import select as ksel

KINDS = ("byzantine", "p3", "wide")
WARMUP, TIMED = 50, 100
#: the P3/P3b configuration of the JAX package's test_gossipsub_v11_sim.py
P3 = dict(mesh_message_deliveries_weight=-1.0,
          mesh_failure_penalty_weight=-1.0,
          mesh_message_deliveries_threshold=0.5)


def build(kind: str, device, n_peers: int = flagship.N_PEERS,
          horizon: int = WARMUP + TIMED):
    """(cfg, score_cfg, params, state, msgs) of ``kind``; ``msgs`` holds
    the messages' ``topic`` and ``tick`` and ``honest``, bool [N], the
    peers in no formation."""
    n, t = n_peers, flagship.N_TOPICS
    if kind == "byzantine":
        offsets = gs.make_gossip_offsets(t, flagship.N_CAND, n, seed=0)
        cfg, sc = tournament.tournament_static_config(offsets, t)
        builds, _, ctx = tournament.tournament_grid(
            n, t, flagship.N_MSGS, horizon, attacks=("byzantine",),
            defenses={"reference": {}})
        params, state = gs.make_gossip_sim(cfg, score_cfg=sc, device=device,
                                           **builds[0])
        return cfg, sc, params, iv.attach(state), dict(
            topic=ctx["topic"], tick=ctx["pub_tick"],
            honest=~ctx["attackers"])
    rng = np.random.default_rng(0)
    c = 32 if kind == "wide" else flagship.N_CAND
    m = horizon if kind == "p3" else flagship.N_MSGS
    cfg = gs.GossipSimConfig(offsets=gs.make_gossip_offsets(t, c, n, seed=0),
                             n_topics=t)
    sc = gs.ScoreSimConfig(**(P3 if kind == "p3" else {}))
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    topic = rng.integers(0, t, m)
    origin = rng.integers(0, n // t, m) * t + topic
    tick = (np.arange(m, dtype=np.int32) if kind == "p3"
            else np.sort(rng.integers(0, horizon, m)).astype(np.int32))
    params, state = gs.make_gossip_sim(cfg, subs, topic, origin, tick,
                                       score_cfg=sc, track_first_tick=False,
                                       device=device)
    return cfg, sc, params, state, dict(topic=topic, tick=tick,
                                        honest=np.ones(n, dtype=bool))


def gates(kind, cfg, params, state, msgs, p4_seen) -> dict:
    """The form's gates on the end state (``p4_seen``: the largest P4 a
    byzantine run's edges showed at its checkpoints, f32 [C, N])."""
    n, honest = params.subscribed.shape[0], msgs["honest"]
    mask = torch.from_numpy(honest).to(params.subscribed.device)
    reach = gs.reach_counts_from_have(params, state, mask=mask).cpu().numpy()
    members = np.arange(n) % cfg.n_topics
    want = np.array([(honest & (members == tau)).sum()
                     for tau in msgs["topic"]])
    settled = msgs["tick"] < state.tick - 30
    out = dict(delivered=bool((reach[settled] == want[settled]).all()),
               settled=int(settled.sum()))
    if kind == "byzantine":
        from_byz = graph.expand_bits(params.cand_byz, cfg.n_candidates)
        out.update(p4_on_mutator_edges=bool((p4_seen[from_byz] > 0).any()),
                   p4_elsewhere=bool((p4_seen[~from_byz] > 0).any()),
                   report=iv.report(state))
        out["ok"] = (out["delivered"] and out["p4_on_mutator_edges"]
                     and not out["p4_elsewhere"]
                     and out["report"]["bits"] == 0)
    elif kind == "p3":
        in_mesh = graph.expand_bits(state.mesh, cfg.n_candidates)
        md = state.scores.mesh_deliveries.float()
        mfp = state.scores.mesh_failure_penalty.float()
        out.update(p3_credit=bool((md[in_mesh] > 0).any()),
                   p3b_max=float(mfp.max()))
        out["ok"] = (out["delivered"] and out["p3_credit"]
                     and out["p3b_max"] > 0)
    else:
        out["ok"] = out["delivered"]
    return out


def run(kind: str, device, n_peers: int = flagship.N_PEERS,
        warmup: int = WARMUP, timed: int = TIMED) -> dict:
    """``kind`` for ``warmup`` + ``timed`` heartbeats: rows and gates.  The
    kernels' launch counts are reset before the warm-up and read after the
    timed ticks."""
    dev = torch.device(device)
    cfg, sc, params, state, msgs = build(kind, dev, n_peers,
                                         warmup + timed)
    step = gs.make_gossip_step(cfg, sc, device=dev, invariants=(
        iv.InvariantConfig() if state.inv_viol is not None else None))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    krecv.launches.clear()
    ksel.launches = 0
    state = gs.gossip_run(params, state, warmup, step, device=dev)
    p4_seen = (state.scores.invalid_deliveries.float()
               if kind == "byzantine" else None)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = gs.gossip_run(params, state, timed, step, device=dev)
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if p4_seen is not None:
        p4_seen = torch.maximum(p4_seen,
                                state.scores.invalid_deliveries.float())
    out = dict(kind=kind, n_peers=n_peers, n_candidates=cfg.n_candidates,
               n_msgs=int(params.publish_tick.shape[0]), warmup=warmup,
               timed=timed, heartbeats_per_s=timed / dt,
               ms_per_tick=dt * 1e3 / timed,
               launches={"receive": sum(krecv.launches.values()),
                         "select": ksel.launches},
               peak_bytes=(torch.cuda.max_memory_allocated() if cuda
                           else None),
               mean_mesh_degree=float(gs.mesh_degrees(state)[
                   params.subscribed].to(torch.float64).mean()))
    out["gates"] = gates(kind, cfg, params, state, msgs, p4_seen)
    out["ok"] = (out["gates"]["ok"] and out["launches"]["receive"] == 0
                 and out["launches"]["select"] > 0)
    out["state"], out["params"], out["step"] = state, params, step
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kind", choices=KINDS, default="byzantine")
    ap.add_argument("--n", type=int, default=flagship.N_PEERS)
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--ticks", type=int, default=TIMED)
    ap.add_argument("--profile", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the loops flagship needs an NVIDIA GPU")
    out = run(args.kind, "cuda", args.n, args.warmup, args.ticks)
    state, params, step = out.pop("state"), out.pop("params"), out.pop("step")
    box = [state]

    def more():
        box[0] = gs.gossip_run(params, box[0], args.profile, step)
    out["profile"] = flagship.profile_ticks(more, args.profile)
    out["card"] = flagship.card()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
