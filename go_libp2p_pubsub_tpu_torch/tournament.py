"""Attack × defense tournament, cell by cell.

Counterpart of ``go_libp2p_pubsub_tpu/models/tournament.py``: every
attack formation {clean, spam, eclipse, byzantine, cold_restart} against
every defense point {reference, weak, hardened, tuned}, under ONE static
config with every attack behaviour compiled in (``tournament_static_config``:
IHAVE spam, the IWANT flood, eclipse, byzantine mutation), each cell
selecting its formation by flag arrays and its defense by a SimKnobs
point, every cell's state armed with the invariant checker.  Every cell
carries byzantine flags and a SimKnobs point on an IWANT-flood config,
so every cell runs the receive loops' combined form
(``models/_receive_loops.py``), as every cell of the reference runs its
XLA step.

The reference runs the grid as one batched dispatch (its replicas
stacked and its step vmapped); here ``run_tournament`` steps each cell
in turn on one device, and reduces each cell's honest-masked reach as
the reference's ``gossip_run_tournament`` does.  The report has the
reference's keys and values.  One dispatch for the whole grid and the
reference's ``tune_defense`` (coordinate descent over the defense knobs,
one grid per step) are not ported yet.

    python -m go_libp2p_pubsub_tpu_torch.tournament [--n 20000] [--ticks 150]

runs the grid at the reference benchmark's shape (20,000 peers, 20
topics, 24 messages, 150 ticks) on the GPU and prints the report with
its replica heartbeats per second and the card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .device import resolve_device
from .models import faults as _faults
from .models import gossipsub as gs
from .models import invariants as _inv

#: the formation axis: "clean" is the control row; "spam" runs both
#: gossip-repair attacks (IHAVE broken promises and the IWANT flood)
ATTACKS = ("clean", "spam", "eclipse", "byzantine", "cold_restart")

#: the reference's auto-tuned defense point, pinned explicitly
TUNED_DEFENSE = {"invalid_message_deliveries_weight": -10.0,
                 "behaviour_penalty_weight": -10.0,
                 "graylist_threshold": -80.0,
                 "gossip_threshold": -10.0}

#: the defense axis: SimKnobs override dicts.  "reference" is the
#: shipped ScoreSimConfig, "weak" turns the P4/P7 penalties off,
#: "hardened" quadruples them and tightens the thresholds
DEFENSES = {
    "reference": {},
    "weak": {"invalid_message_deliveries_weight": 0.0,
             "behaviour_penalty_weight": 0.0},
    "hardened": {"invalid_message_deliveries_weight": -40.0,
                 "behaviour_penalty_weight": -40.0,
                 "graylist_threshold": -50.0,
                 "gossip_threshold": -5.0},
    "tuned": TUNED_DEFENSE,
}


def tournament_static_config(offsets, n_topics: int):
    """The one (cfg, score_cfg) every cell shares: all attack behaviours
    compiled in, selected per cell by the flag arrays."""
    cfg = gs.GossipSimConfig(offsets=offsets, n_topics=n_topics)
    sc = gs.ScoreSimConfig(sybil_ihave_spam=True, sybil_iwant_spam=True,
                           sybil_eclipse=True, byzantine_mutation=True)
    return cfg, sc


def tournament_grid(n: int, t: int, m: int, horizon: int, *,
                    attack_frac: float = 0.2, victim_frac: float = 0.1,
                    churn_frac: float = 0.15, seed: int = 0,
                    attacks=ATTACKS, defenses=None):
    """The cell grid, in the reference's draw order: returns ``(builds,
    meta, ctx)``, ``builds`` a list of make_gossip_sim keyword dicts (one
    per attack × defense cell, attack-major), ``meta`` the matching
    ``{"attack", "defense"}`` rows, ``ctx`` the shared draws (attackers,
    victims, origin, topic, pub_tick, subs).

    The attacker, victim and churn sets and the message table are the
    same in every cell, which differ only in the armed behaviour and the
    knobs; origins are drawn from peers in no formation.  The
    cold-restart row's churners cycle down for 8 ticks from 30% of the
    horizon in 3 staggered waves; every other cell carries the same
    intervals as no-ops."""
    defenses = DEFENSES if defenses is None else defenses
    rng = np.random.default_rng(seed)
    attackers = np.zeros(n, dtype=bool)
    attackers[: int(n * attack_frac)] = True
    victims = np.zeros(n, dtype=bool)
    victims[int(n * attack_frac):
            int(n * (attack_frac + victim_frac))] = True
    pool = np.flatnonzero(~attackers & ~victims)
    # honest origins, publishes over the first 60% of the horizon
    origin = pool[rng.integers(0, len(pool), m)]
    topic = (origin % t).astype(np.int64)
    pub_tick = np.sort(rng.integers(0, max(1, int(horizon * 0.6)),
                                    m)).astype(np.int32)
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    churners = pool[rng.random(len(pool)) < churn_frac]
    lo = max(1, int(horizon * 0.3))
    ivs = [(int(p), lo + int(p % 3) * 4, lo + 8 + int(p % 3) * 4)
           for p in churners]
    noop_ivs = [(int(p), 0, 0) for p in churners]
    zeros = np.zeros(n, dtype=bool)

    def sched(churn: bool):
        return _faults.FaultSchedule(
            n_peers=n, horizon=horizon,
            down_intervals=(ivs if churn else noop_ivs),
            cold_restart=True, seed=seed)

    builds, meta = [], []
    for attack in attacks:
        for dname, knobs in defenses.items():
            # one seed for the whole grid: cells are paired controls
            builds.append(dict(
                subs=subs, msg_topic=topic, msg_origin=origin,
                msg_publish_tick=pub_tick, seed=seed,
                track_first_tick=False,
                sybil=(attackers if attack == "spam" else zeros),
                eclipse_sybil=(attackers if attack == "eclipse" else zeros),
                eclipse_victim=(victims if attack == "eclipse" else zeros),
                byzantine=(attackers if attack == "byzantine" else zeros),
                fault_schedule=sched(attack == "cold_restart"),
                sim_knobs=dict(knobs)))
            meta.append({"attack": attack, "defense": dname})
    return builds, meta, dict(attackers=attackers, victims=victims,
                              origin=origin, topic=topic, pub_tick=pub_tick,
                              subs=subs)


def run_tournament(n: int, t: int, m: int, n_ticks: int, *,
                   n_candidates: int = 16, seed: int = 0, attacks=ATTACKS,
                   defenses=None, invariants: bool = True, device=None,
                   cells: list | None = None) -> dict:
    """Build and run the grid, one cell after another on ``device``
    (default ``cuda``); returns the reference's report: ``{"rows":
    [{attack, defense, delivery_fraction[, eclipse_takeover], inv_bits,
    inv_first}, ...], "worst_case": {defense: {delivery_fraction,
    attack}}, ...}``.  Delivery fraction is the honest population's mean
    over messages of reached / wanted.  ``cells``, a list, receives each
    cell's ``(params, final state)``."""
    dev = resolve_device(device)
    defenses = DEFENSES if defenses is None else defenses
    offsets = gs.make_gossip_offsets(t, n_candidates, n, seed=seed)
    cfg, sc = tournament_static_config(offsets, t)
    builds, meta, ctx = tournament_grid(n, t, m, n_ticks, seed=seed,
                                        attacks=attacks, defenses=defenses)
    step = gs.make_gossip_step(
        cfg, sc, device=dev,
        invariants=_inv.InvariantConfig() if invariants else None)
    honest_row = ~ctx["attackers"]      # victims and churners are honest
    honest = torch.from_numpy(honest_row).to(dev)
    members = np.arange(n) % t
    want = np.array([(honest_row & (members == tau)).sum()
                     for tau in ctx["topic"]], dtype=np.float64)
    rows = []
    for b, mrow in zip(builds, meta):
        params, state = gs.make_gossip_sim(cfg, score_cfg=sc, device=dev,
                                           **b)
        if invariants:
            state = _inv.attach(state)
        state = gs.gossip_run(params, state, n_ticks, step, device=dev)
        reach = gs.reach_counts_from_have(params, state,
                                          mask=honest).cpu().numpy()
        row = dict(mrow, delivery_fraction=round(
            float((reach / want).mean()), 4))
        if mrow["attack"] == "eclipse":
            row["eclipse_takeover"] = round(
                gs.eclipse_takeover(state, params, cfg), 4)
        if invariants:
            row["inv_bits"] = int(state.inv_viol) & 0xFFFFFFFF
            row["inv_first"] = int(state.inv_first)
        rows.append(row)
        if cells is not None:
            cells.append((params, state))
    worst = {}
    for dname in defenses:
        w = min((r for r in rows if r["defense"] == dname),
                key=lambda r: r["delivery_fraction"])
        worst[dname] = {"delivery_fraction": w["delivery_fraction"],
                        "attack": w["attack"]}
    return {
        "n_peers": n, "n_topics": t, "n_msgs": m, "ticks": n_ticks,
        "replicas": len(builds),
        "attacks": list(attacks), "defenses": list(defenses),
        "rows": rows, "worst_case": worst,
        "reference_worst_case_delivery":
            worst.get("reference", {}).get("delivery_fraction"),
        "invariant_violations": sum(r.get("inv_bits", 0) != 0
                                    for r in rows),
    }


def main() -> None:
    from .flagship import card

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--topics", type=int, default=20)
    ap.add_argument("--msgs", type=int, default=24)
    ap.add_argument("--ticks", type=int, default=150)
    args = ap.parse_args()
    t0 = time.perf_counter()
    rep = run_tournament(args.n, args.topics, args.msgs, args.ticks)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rep.update(replica_heartbeats_per_s=rep["replicas"] * args.ticks / dt,
               wall_s=dt, card=card())
    print(json.dumps(rep))


if __name__ == "__main__":
    main()
