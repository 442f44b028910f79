"""The resident and adversarial configurations' gates, checked on the JAX
reference.

    JAX_PLATFORMS=cpu python tests/torch_reference_gate.py [--n 131072]
    JAX_PLATFORMS=cpu python tests/torch_reference_gate.py --adversarial \
        [--n 100000] [--ticks 400]

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
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from go_libp2p_pubsub_tpu_torch import adversarial, resident  # noqa: E402
from torch_ref import imported_reference  # noqa: E402


def adversarial_gates(n: int, horizon: int) -> int:
    t = adversarial.N_TOPICS
    sybil, topic, origin, tick = adversarial.draws(n, t, horizon)
    with imported_reference() as r:
        gs = r.gs
        cfg = gs.GossipSimConfig(
            offsets=gs.make_gossip_offsets(t, adversarial.N_CAND, n, seed=0),
            n_topics=t)
        sc = gs.ScoreSimConfig(sybil_ihave_spam=True, sybil_iwant_spam=True)
        params, state = gs.make_gossip_sim(
            cfg, resident.subs_matrix(n, t), topic, origin, tick,
            score_cfg=sc, sybil=sybil, track_first_tick=False)
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
    cap = (cfg.gossip_retransmission + 1) * 32 * w
    ok = deg.mean() >= cfg.d_lo and serves.max() < cap
    print(f"N={n}, {horizon} ticks: honest mean mesh degree "
          f"{deg.mean():.4f} (Dlo {cfg.d_lo}); iwant_serves max "
          f"{serves.max()} at the end, {serves_run} over the run (bound "
          f"{cap}); over the run, sybil rows max {syb_run}, "
          f"behaviour_penalty max {bp_run} (at the end {bp_max})")
    cls = np.arange(n) % t
    for j in range(len(topic)):
        want = int((honest & (cls == topic[j])).sum())
        settled = tick[j] < horizon - 30
        ok &= reach[j] == want or not settled
        print(f"msg {j}: topic {topic[j]} tick {tick[j]} honest members "
              f"{reach[j]}/{want}{'' if settled else ' (not settled)'}")
    print("gates", "pass" if ok else "FAIL")
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int)
    ap.add_argument("--adversarial", action="store_true")
    ap.add_argument("--ticks", type=int, default=400)
    args = ap.parse_args()
    if args.adversarial:
        return adversarial_gates(args.n or 100_000, args.ticks)
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
