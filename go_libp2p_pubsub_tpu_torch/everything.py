"""The everything-on scored GossipSub v1.1 configurations, and a profile
of their heartbeat.

``build(..., paired=True)`` is the JAX package's widest single-run
benchmark as written (bench_suite.py ``bench_gossipsub_v11_everything``):
1,000,000 peers, 100 topics, C = 16, M = 32, seed 0, no first-tick
records, every peer subscribed to its residue class r and to r + T/2
(paired topics: one mesh, backoff and P1 per topic slot, the score summed
over both under ``topic_score_cap=50``), 20% sybils (``default_rng(7)``)
running IHAVE broken-promise spam and the IWANT retransmission flood from
behind shared addresses (four to an IP: P6 and the gater's per-IP
grouping), honest origins, PX candidate rotation over ``px_candidates=14``
of the 16 candidates, and a sparse operator-pinned direct overlay (every
peer p with p mod 1009 == 0, on candidate 0 and its inverse).

``build(..., paired=False)`` (the default) is the same with one topic per
peer plus flood publishing, which the reference library turns on for
real deployments and the paired benchmark leaves off.

``build`` makes either at any size, in the benchmark's draw order.  Their
gates are the adversarial configuration's (``adversarial.gates``, which
counts both topics' members where they are paired); ``options_live``
shows each option at work.

    python -m go_libp2p_pubsub_tpu_torch.everything [--paired] \
        [--warmup 100] [--ticks 20]

times ``--ticks`` heartbeats of the 1M-peer configuration on the GPU
after ``--warmup``, profiles as many more with torch.profiler, and prints
one JSON object as ``flagship.profile_ticks`` does, with the PX
epilogue's share of the device time (the select launch of phase 7 is
not told apart from the other selections there; the re-emitted targets
row is timed on its own), each topic slot's maintenance pass timed on
its own, and where the device memory goes (``step_memory``).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from . import adversarial
from .flagship import N_CAND, N_PEERS, N_TOPICS, card, profile_ticks
from .models import gossipsub as gs
from .ops.graph import popcount32
from .ops.kernels import receive as krecv
from .resident import subs_matrix

PX_CANDIDATES = 14
DIRECT_MODULUS = 1009
SYBILS_PER_IP = 4
TOPIC_SCORE_CAP = 50.0


def score_config(paired: bool = False) -> gs.ScoreSimConfig:
    """Both gossip-repair attacks under the topic cap; flood publishing
    only on the single-topic configuration (the paired benchmark leaves
    it off)."""
    return gs.ScoreSimConfig(topic_score_cap=TOPIC_SCORE_CAP,
                             sybil_ihave_spam=True, sybil_iwant_spam=True,
                             flood_publish=not paired)




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
          horizon: int = 400, seed: int = 0, paired: bool = False):
    """(cfg, score_cfg, params, state, msg_topic, msg_publish_tick,
    sybil); messages are published at ticks drawn over [0, horizon).
    ``paired``: the benchmark's paired topics, without flood
    publishing."""
    n, t = n_peers, n_topics
    sybil, topic, origin, tick = adversarial.draws(n, t, horizon, seed)
    cfg = gs.GossipSimConfig(
        offsets=gs.make_gossip_offsets(t, N_CAND, n, seed=seed,
                                       paired=paired),
        n_topics=t, paired_topics=paired)
    sc = score_config(paired)
    de, ip = overlay(cfg.offsets, cfg.cinv, n, sybil)
    params, state = gs.make_gossip_sim(
        cfg, subs_matrix(n, t, paired), topic, origin, tick, seed=seed,
        score_cfg=sc, sybil=sybil, peer_ip=ip,
        direct_edges=de, px_candidates=PX_CANDIDATES,
        track_first_tick=False, device=device)
    return cfg, sc, params, state, topic, tick, sybil


def direct_in_mesh(params: gs.GossipParams, state: gs.GossipState) -> int:
    """Peers with a direct edge in a mesh, either slot's (the router never
    grafts one)."""
    meshed = state.mesh if state.mesh_b is None else state.mesh | state.mesh_b
    return int((meshed & params.cand_direct != 0).sum())


def cross_slot_symmetry(cfg: gs.GossipSimConfig,
                        state: gs.GossipState) -> float:
    """The share of mesh edges, both slots', that the partner holds in
    its matching slot (the same slot on an even edge, the other on an
    odd one): the cross-slot handshake routing at work
    (tests/test_gossipsub_paired.py)."""
    agree = total = 0
    odd = krecv.odd_edge_mask(cfg)
    for c, (o, ci) in enumerate(zip(cfg.offsets, cfg.cinv)):
        even = not (odd >> c) & 1
        for mine_w, partner_w in (
                (state.mesh, state.mesh if even else state.mesh_b),
                (state.mesh_b, state.mesh_b if even else state.mesh)):
            mine = (mine_w >> c) & 1
            partner = (torch.roll(partner_w, -int(o)) >> ci) & 1
            agree += int((mine & partner).sum())
            total += int(mine.sum())
    return agree / max(total, 1)


def options_live(params: gs.GossipParams, active0: torch.Tensor,
                 state: gs.GossipState,
                 cfg: gs.GossipSimConfig | None = None) -> dict:
    """What a run's end state shows of each option (``active0`` the built
    state's active words): peers whose active word was rotated, peers with a direct edge
    in a mesh (must be 0), the same-IP sibling words present and the
    lowest static (P5 + P6) score a sybil candidate carries (below 0
    under shared addresses); paired (``cfg`` given), peers with a slot-B
    mesh, the largest slot-B time in mesh, peers with an odd edge in
    their slot-B mesh, the honest subscribed peers' mean slot-B degree
    and the cross-slot symmetry."""
    syb_static = params.cand_static_score[params.cand_sybil]
    out = dict(
        active_rotated=int((state.active != active0).sum()),
        direct_in_mesh=direct_in_mesh(params, state),
        same_ip_words=params.cand_same_ip is not None,
        sybil_static_min=(float(syb_static.min()) if syb_static.numel()
                          else 0.0))
    if state.mesh_b is not None:
        keep = params.subscribed & ~params.sybil
        out.update(
            mesh_b_peers=int((state.mesh_b != 0).sum()),
            time_in_mesh_b_max=int(state.scores.time_in_mesh_b.max()),
            odd_in_mesh_b=int(
                (state.mesh_b & krecv.odd_edge_mask(cfg) != 0).sum()),
            honest_mean_degree_b=popcount32(state.mesh_b)[keep].to(
                torch.float64).mean().item(),
            cross_slot_symmetry=cross_slot_symmetry(cfg, state))
    return out


def _events_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def maintenance_pass_ms(step, params, state, reps: int) -> list[float]:
    """Each topic slot's maintenance pass alone (``maintain_slot``, its
    host sync included), by CUDA events over ``reps`` back-to-back calls
    with the arguments that ``step`` gives it on ``state``: slot A's,
    then (paired) slot B's."""
    calls = []
    real = gs.maintain_slot

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    gs.maintain_slot = spy
    try:
        step(params, state)
    finally:
        gs.maintain_slot = real
    return [_events_ms(lambda: real(*args, **kwargs), reps)
            for args, kwargs in calls]


def _site(frames) -> str:
    """The innermost frame of this package, with its caller."""
    ours = [f for f in frames if "go_libp2p_pubsub_tpu_torch" in f["filename"]]
    return " < ".join(f"{f['name']}:{f['line']}" for f in ours[:2]) or "?"


def step_memory(step, params, state, top: int = 10) -> dict:
    """One heartbeat's device memory on ``state``: the bytes allocated
    before it (whatever is alive: params, states), its peak above them,
    and the bytes alive at that peak by allocation site (the innermost
    frame of this package), replayed from the caching allocator's
    history of the heartbeat."""
    dev = torch.cuda.current_device()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(stacks="python",
                                             max_entries=1_000_000)
    try:
        out = step(params, state)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    del out
    live, cur, best, at_peak = {}, 0, 0, {}
    for ev in snap["device_traces"][dev]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], _site(ev.get("frames", [])))
            cur += ev["size"]
            if cur > best:
                best, at_peak = cur, dict(live)
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])[0]
    sites: dict[str, int] = {}
    for size, site in at_peak.values():
        sites[site] = sites.get(site, 0) + size
    return dict(tick=state.tick, allocated_before=base,
                peak_above=peak - base, traced_peak_above=best,
                sites_at_peak=sorted(sites.items(), key=lambda r: -r[1])[:top])


def profile(warmup: int, ticks: int, paired: bool = False) -> dict:
    """Time ``ticks`` heartbeats after ``warmup``, then profile as many
    more (``profile_ticks``); then the PX epilogue's re-emitted targets
    row alone and each topic slot's maintenance pass alone, by CUDA
    events over ``ticks`` calls.  Memory: the built sim's bytes and
    ``step_memory`` on the heartbeat after warm-up and on the next
    opportunistic-grafting one."""
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cfg, sc, params, state, *_ = build(dev, horizon=warmup + 2 * ticks,
                                       paired=paired)
    torch.cuda.synchronize()
    built = torch.cuda.memory_allocated() - before
    step = gs.make_gossip_step(cfg, sc, device=dev)
    box = [gs.gossip_run(params, state, warmup, step, device=dev)]
    del state
    og = sc.opportunistic_graft_ticks
    st_og = gs.gossip_run(params, box[0], -box[0].tick % og, step,
                          device=dev)
    memory = dict(built=built, steps=[
        step_memory(step, params, st) for st in (box[0], st_og)])
    del st_og

    def run():
        box[0] = gs.gossip_run(params, box[0], ticks, step, device=dev)
    out = profile_ticks(run, ticks)
    out["memory_bytes"] = memory
    st = box[0]
    out["px_targets_row_ms_per_tick"] = _events_ms(
        lambda: gs.gossip_targets_row(
            cfg, sc, params, mesh=st.mesh, fanout=st.fanout,
            active=st.active, gossip_row=st.gates[1], tick=st.tick,
            salt=st.salt, mesh_b=st.mesh_b), ticks)
    out["maintenance_ms_per_pass"] = maintenance_pass_ms(step, params, st,
                                                         ticks)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--paired", action="store_true",
                    help="the benchmark's paired topics")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the profile needs an NVIDIA GPU")
    out = profile(args.warmup, args.ticks, args.paired)
    out["device"] = torch.cuda.get_device_name(0)
    out["card"] = card()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
