"""The resident, adversarial and everything-on configurations' gates,
checked on the JAX reference.

    JAX_PLATFORMS=cpu python tests/torch_reference_gate.py [--n 131072]
    JAX_PLATFORMS=cpu python tests/torch_reference_gate.py --adversarial \
        [--n 100000] [--ticks 400]
    JAX_PLATFORMS=cpu python tests/torch_reference_gate.py --everything \
        [--n 100000] [--ticks 400]
    JAX_PLATFORMS=cpu python tests/torch_reference_gate.py \
        --everything-paired [--n 100000] [--ticks 400]

Runs the JAX package's unscored per-tick step (XLA) on the resident
configuration (go_libp2p_pubsub_tpu_torch/resident.py: 10 topics, C = 16,
M = 24, offsets seed 7, sim seed 3, messages seed 0) for 64 + 256 ticks
at the JAX benchmark's CPU size, and prints the two gates chip_smoke.py
holds the port to on the card: the mean mesh degree against Dlo, and,
for each message published 30 or more ticks before the end, the members
of its topic (peers p with p mod 10 == topic) that hold it against the
member count.  N need not be a multiple of 10: at the ring's wrap
candidates cross residue classes, so messages also reach peers of other
classes, which the gate does not count.

With ``--adversarial`` it runs the JAX package's scored step (XLA) on
the adversarial configuration (go_libp2p_pubsub_tpu_torch/adversarial.py:
100 topics, C = 16, M = 32, 20% sybils spamming IHAVEs and flooding
IWANTs, honest origins, the benchmark's draws) for ``--ticks`` ticks
(the benchmark's 100 warm-up + 300) at the JAX benchmark's CPU size,
and prints the benchmark's three gates: the honest subscribed peers'
mean mesh degree against Dlo, every settled message held by every
honest member of its topic, and the largest IWANT-serve ledger entry
against (gossip_retransmission + 1) * 32 * W.  Exits 1 if a gate fails.

With ``--everything`` the same three gates on the everything-on
configuration (go_libp2p_pubsub_tpu_torch/everything.py: the adversarial
one plus topic_score_cap=50, flood publishing, PX rotation over 14 of the
16 candidates, the sparse direct overlay and the sybils four to an
address), and each option shown live: peers whose active word rotated,
direct edges in a mesh (0), the lowest static score of a sybil candidate.

With ``--everything-paired`` the same on the benchmark's own
everything-on configuration (``everything.build(..., paired=True)``:
paired topics, no flood publishing), its delivery gate counting both
residue classes of a topic, and reports the honest subscribed peers'
mean slot-B mesh degree against Dlo and the share of mesh edges, both
slots', that the partner holds in the matching slot (the cross-slot
symmetry of tests/test_gossipsub_paired.py).
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from go_libp2p_pubsub_tpu_torch import (  # noqa: E402
    adversarial,
    everything,
    resident,
)
from torch_ref import imported_reference  # noqa: E402


def adversarial_gates(n: int, horizon: int, full: bool = False,
                      paired: bool = False) -> int:
    """The three gates on the adversarial configuration, or (``full``)
    on the everything-on one, with one topic per peer or (``paired``)
    two."""
    t = adversarial.N_TOPICS
    sybil, topic, origin, tick = adversarial.draws(n, t, horizon)
    with imported_reference() as r:
        gs = r.gs
        cfg = gs.GossipSimConfig(
            offsets=gs.make_gossip_offsets(t, adversarial.N_CAND, n, seed=0,
                                           paired=paired),
            n_topics=t, paired_topics=paired)
        extra = {}
        if full:
            sc = gs.ScoreSimConfig(
                topic_score_cap=everything.TOPIC_SCORE_CAP,
                sybil_ihave_spam=True, sybil_iwant_spam=True,
                flood_publish=not paired)
            de, ip = everything.overlay(cfg.offsets, cfg.cinv, n, sybil)
            extra = dict(direct_edges=de, peer_ip=ip,
                         px_candidates=everything.PX_CANDIDATES)
        else:
            sc = gs.ScoreSimConfig(sybil_ihave_spam=True,
                                   sybil_iwant_spam=True)
        params, state = gs.make_gossip_sim(
            cfg, resident.subs_matrix(n, t, paired), topic, origin, tick,
            score_cfg=sc, sybil=sybil, track_first_tick=False, **extra)
        active0 = None if not full else np.asarray(state.active)
        # tick by tick: the attacks' levels fade between publishes, so
        # their largest values over the run show them live
        import jax
        step = jax.jit(gs.make_gossip_step(cfg, sc))
        bp_run = syb_run = serves_run = 0
        for _ in range(horizon):
            state = step(params, state)[0]
            s_t = np.asarray(state.iwant_serves)
            serves_run = max(serves_run, int(s_t.max()))
            syb_run = max(syb_run, int(s_t[:, sybil].max()))
            bp_run = max(bp_run, float(np.asarray(
                state.scores.behaviour_penalty, dtype=np.float32).max()))
        honest = ~sybil
        reach = np.asarray(gs.reach_counts_from_have(params, state,
                                                     mask=honest))
        deg = np.asarray(gs.mesh_degrees(state))[honest]
        serves = np.asarray(state.iwant_serves)
        bp_max = float(np.asarray(state.scores.behaviour_penalty,
                                  dtype=np.float32).max())
        w = params.origin_words.shape[0]
        if full:
            mesh = np.asarray(state.mesh)
            if paired:
                mesh = mesh | np.asarray(state.mesh_b)
            static = np.asarray(params.cand_static_score)
            print(f"options: active rotated at "
                  f"{int((np.asarray(state.active) != active0).sum())} "
                  f"peers; direct edges in a mesh "
                  f"{int((mesh & np.asarray(params.cand_direct) != 0).sum())}"
                  f" of {int(de.sum())}; same-IP words "
                  f"{params.cand_same_ip is not None}; lowest sybil "
                  f"static score "
                  f"{static[np.asarray(params.cand_sybil)].min()}; "
                  f"flood_publish {sc.flood_publish}")
        if paired:
            paired_report(cfg, params, state, honest, gs)
    cap = (cfg.gossip_retransmission + 1) * 32 * w
    ok = deg.mean() >= cfg.d_lo and serves.max() < cap
    print(f"N={n}, {horizon} ticks: honest mean mesh degree "
          f"{deg.mean():.4f} (Dlo {cfg.d_lo}); iwant_serves max "
          f"{serves.max()} at the end, {serves_run} over the run (bound "
          f"{cap}); over the run, sybil rows max {syb_run}, "
          f"behaviour_penalty max {bp_run} (at the end {bp_max})")
    cls = np.arange(n) % t
    second = (cls + t // 2) % t if paired else cls
    for j in range(len(topic)):
        want = int((honest & ((cls == topic[j])
                              | (second == topic[j]))).sum())
        settled = tick[j] < horizon - 30
        ok &= reach[j] == want or not settled
        print(f"msg {j}: topic {topic[j]} tick {tick[j]} honest members "
              f"{reach[j]}/{want}{'' if settled else ' (not settled)'}")
    print("gates", "pass" if ok else "FAIL")
    return 0 if ok else 1


def paired_report(cfg, params, state, honest, gs) -> None:
    """The slot-B mesh degree of the honest subscribed peers, and the
    cross-slot symmetry: the share of mesh edges, both slots', that the
    partner holds in the matching slot."""
    from go_libp2p_pubsub_tpu.ops.graph import popcount32

    t = cfg.n_topics
    keep = honest & np.asarray(params.subscribed)
    mesh_a, mesh_b = np.asarray(state.mesh), np.asarray(state.mesh_b)
    deg_b = np.asarray(popcount32(state.mesh_b))[keep]
    agree = total = 0
    for c, o in enumerate(cfg.offsets):
        even = o % t == 0
        for mine_w, partner_w in ((mesh_a, mesh_a if even else mesh_b),
                                  (mesh_b, mesh_b if even else mesh_a)):
            mine = (mine_w >> c) & 1
            partner = (np.roll(partner_w, -o) >> cfg.cinv[c]) & 1
            agree += int((mine & partner).sum())
            total += int(mine.sum())
    odd = sum(1 << c for c, o in enumerate(cfg.offsets) if o % t)
    print(f"paired: honest mean slot-B mesh degree {deg_b.mean():.4f} "
          f"(Dlo {cfg.d_lo}: {'met' if deg_b.mean() >= cfg.d_lo else 'NOT met'}"
          f"); cross-slot symmetry {agree / max(total, 1):.4f} of {total} "
          f"mesh edges; peers with an odd edge in mesh_b "
          f"{int(((mesh_b & np.uint32(odd)) != 0).sum())}; largest slot-B "
          f"time in mesh {int(np.asarray(state.scores.time_in_mesh_b).max())}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int)
    ap.add_argument("--adversarial", action="store_true")
    ap.add_argument("--everything", action="store_true")
    ap.add_argument("--everything-paired", action="store_true")
    ap.add_argument("--ticks", type=int, default=400)
    args = ap.parse_args()
    if args.adversarial or args.everything or args.everything_paired:
        return adversarial_gates(
            args.n or 100_000, args.ticks,
            full=args.everything or args.everything_paired,
            paired=args.everything_paired)
    n = args.n or 131_072
    t, horizon = resident.N_TOPICS, 64 + 256
    with imported_reference() as r:
        gs = r.gs
        cfg = gs.GossipSimConfig(
            offsets=gs.make_gossip_offsets(t, resident.N_CAND, n,
                                           seed=resident.OFFSETS_SEED),
            n_topics=t)
        topic, origin, tick = resident.msgs(
            np.random.default_rng(resident.MSG_SEED), n, t,
            resident.N_MSGS, horizon)
        params, state = gs.make_gossip_sim(
            cfg, resident.subs_matrix(n, t), topic, origin, tick,
            seed=resident.SIM_SEED, track_first_tick=False)
        state = gs.gossip_run(params, state, horizon,
                              gs.make_gossip_step(cfg, None))
        have = np.asarray(state.have)
        deg = float(np.asarray(gs.mesh_degrees(state)).mean())
    ok = deg >= cfg.d_lo
    print(f"N={n}: mean mesh degree {deg:.4f} (Dlo {cfg.d_lo})")
    cls = np.arange(n) % t
    for j in range(len(topic)):
        held = ((have[j // 32] >> (j % 32)) & 1).astype(bool)
        members = cls == topic[j]
        reach, n_mem = int((held & members).sum()), int(members.sum())
        settled = tick[j] < horizon - 30
        ok &= reach == n_mem or not settled
        print(f"msg {j}: topic {topic[j]} tick {tick[j]} members "
              f"{reach}/{n_mem} all peers {int(held.sum())}"
              f"{'' if settled else ' (not settled)'}")
    print("gates", "pass" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
