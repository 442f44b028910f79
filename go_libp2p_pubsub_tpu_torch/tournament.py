"""Attack × defense tournament, one dispatch for the whole grid.

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

``run_tournament`` stacks the cells' builds on a replica axis
(``models/_batch.py``) and advances the whole grid with ONE step a tick
(``gossip_run_tournament``: B3 as often as one cell's tick launches it),
then reduces each cell's honest-masked reach, as the reference's one
batched dispatch does; the report has the reference's keys and values.
``tune_defense`` is the reference's coordinate descent over the defense
knobs (``TUNE_SPACE``), each step one batched grid.

    python -m go_libp2p_pubsub_tpu_torch.tournament [--n 20000] [--ticks 150] [--tune]

runs the grid at the reference benchmark's shape (20,000 peers, 20
topics, 24 messages, 150 ticks) on the GPU and prints the report with
its replica heartbeats per second and the card; ``--tune`` runs
``tune_defense`` at that shape instead and prints its result and wall
time.
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


#: one step per (cfg, sc, invariants, device): a defense point is data of
#: the params, so every run_tournament / tune_defense over one shape steps
#: with the same step object (its cached constants and edge geometry)
_STEP_CACHE: dict = {}


def _cached_step(cfg, sc, invariants: bool, device=None):
    dev = resolve_device(device)
    key = (cfg, sc, invariants, dev)
    if key not in _STEP_CACHE:
        _STEP_CACHE[key] = gs.make_gossip_step(
            cfg, sc, device=dev,
            invariants=_inv.InvariantConfig() if invariants else None)
    return _STEP_CACHE[key]


def stack_grid(n: int, t: int, m: int, n_ticks: int, *,
               n_candidates: int = 16, seed: int = 0, attacks=ATTACKS,
               defenses=None, invariants: bool = True, device=None):
    """The grid built and stacked on ``device``: ``(cfg, sc, params_B,
    state_B, step, meta, ctx)``, every cell a replica (states armed with
    the checker where ``invariants``), ``step`` the shape's cached
    step."""
    dev = resolve_device(device)
    offsets = gs.make_gossip_offsets(t, n_candidates, n, seed=seed)
    cfg, sc = tournament_static_config(offsets, t)
    builds, meta, ctx = tournament_grid(n, t, m, n_ticks, seed=seed,
                                        attacks=attacks, defenses=defenses)
    pairs = [gs.make_gossip_sim(cfg, score_cfg=sc, device=dev, **b)
             for b in builds]
    states = [p[1] for p in pairs]
    if invariants:
        states = [_inv.attach(s) for s in states]
    params = gs.stack_trees([p[0] for p in pairs])
    state = gs.stack_trees(states)
    return (cfg, sc, params, state, _cached_step(cfg, sc, invariants, dev),
            meta, ctx)


def run_tournament(n: int, t: int, m: int, n_ticks: int, *,
                   n_candidates: int = 16, seed: int = 0, attacks=ATTACKS,
                   defenses=None, invariants: bool = True, device=None,
                   cells: list | None = None) -> dict:
    """Build the grid, stack its cells and run them as one batched
    dispatch on ``device`` (default ``cuda``); returns the reference's
    report: ``{"rows": [{attack, defense, delivery_fraction[,
    eclipse_takeover], inv_bits, inv_first}, ...], "worst_case":
    {defense: {delivery_fraction, attack}}, ...}``.  Delivery fraction is
    the honest population's mean over messages of reached / wanted.
    ``cells``, a list, receives each cell's ``(params, final state)``
    (views of the stack)."""
    dev = resolve_device(device)
    defenses = DEFENSES if defenses is None else defenses
    cfg, _, params, state, step, meta, ctx = stack_grid(
        n, t, m, n_ticks, n_candidates=n_candidates, seed=seed,
        attacks=attacks, defenses=defenses, invariants=invariants,
        device=dev)
    honest_row = ~ctx["attackers"]      # victims and churners are honest
    honest = np.broadcast_to(honest_row, (len(meta), n)).copy()
    state, reach = gs.gossip_run_tournament(params, state, n_ticks, step,
                                            honest, device=dev)
    reach = reach.cpu().numpy()
    members = np.arange(n) % t
    want = np.array([(honest_row & (members == tau)).sum()
                     for tau in ctx["topic"]], dtype=np.float64)
    inv = _inv.report_batch(state) if invariants else None
    rows = []
    for b, mrow in enumerate(meta):
        row = dict(mrow, delivery_fraction=round(
            float((reach[b] / want).mean()), 4))
        if mrow["attack"] == "eclipse" or cells is not None:
            p_b, s_b = gs.index_trees(params, b), gs.index_trees(state, b)
        if mrow["attack"] == "eclipse":
            row["eclipse_takeover"] = round(
                gs.eclipse_takeover(s_b, p_b, cfg), 4)
        if invariants:
            row["inv_bits"] = inv[b]["bits"]
            row["inv_first"] = inv[b]["first_tick"]
        rows.append(row)
        if cells is not None:
            cells.append((p_b, s_b))
    worst = {}
    for dname in defenses:
        w = min((r for r in rows if r["defense"] == dname),
                key=lambda r: r["delivery_fraction"])
        worst[dname] = {"delivery_fraction": w["delivery_fraction"],
                        "attack": w["attack"]}
    return {
        "n_peers": n, "n_topics": t, "n_msgs": m, "ticks": n_ticks,
        "replicas": len(meta),
        "attacks": list(attacks), "defenses": list(defenses),
        "rows": rows, "worst_case": worst,
        "reference_worst_case_delivery":
            worst.get("reference", {}).get("delivery_fraction"),
        "invariant_violations": sum(r.get("inv_bits", 0) != 0
                                    for r in rows),
    }


# --------------------------------------------------------------------------
# Defense auto-tuning: coordinate descent over the defense knobs, each
# step one batched grid (the reference's tune_defense)
# --------------------------------------------------------------------------

#: the coordinate-descent search space (graylist candidates respect the
#: static publish threshold, -50: graylist <= publish is a build
#: invariant)
TUNE_SPACE = {
    "invalid_message_deliveries_weight": (-5.0, -10.0, -20.0, -40.0),
    "behaviour_penalty_weight": (-5.0, -10.0, -20.0, -40.0),
    "graylist_threshold": (-80.0, -65.0, -50.0),
    "gossip_threshold": (-10.0, -5.0, -2.0),
}


def tune_defense(n: int, t: int, m: int, n_ticks: int, *,
                 seed: int = 0, passes: int = 1, space=None,
                 attacks=ATTACKS, start=None, log=None,
                 device=None) -> dict:
    """Coordinate descent over the ScoreKnobs defense space, maximizing
    the worst-case honest delivery fraction across the attack column
    (the reference's, step for step): each coordinate step runs every
    candidate value × every attack as ONE batched ``run_tournament``.

    Objective, lexicographic: (worst-case delivery, attack-column mean
    delivery, minus the eclipse takeover).  Returns ``{"tuned": point,
    "tuned_worst_case", "tuned_mean", "tuned_takeover",
    "reference_worst_case", "reference_mean", "reference_takeover",
    "delta", "delta_mean", "delta_takeover", "history", "shape"}``, the
    reference's dict."""
    space = dict(TUNE_SPACE if space is None else space)
    point = dict(start or {})
    history = []

    def takeover_of(report, dname):
        tk = [r.get("eclipse_takeover") for r in report["rows"]
              if r["defense"] == dname
              and r.get("eclipse_takeover") is not None]
        return tk[0] if tk else 0.0

    def objective(report, dname):
        col = [r["delivery_fraction"] for r in report["rows"]
               if r["defense"] == dname]
        return (report["worst_case"][dname]["delivery_fraction"],
                round(sum(col) / len(col), 6),
                -takeover_of(report, dname))

    def grid(defenses):
        return run_tournament(n, t, m, n_ticks, seed=seed, attacks=attacks,
                              defenses=defenses, device=device)

    # the reference row rides along once for the delta
    base = grid({"reference": {}, "start": dict(point)})
    ref_worst = base["worst_case"]["reference"]
    best = objective(base, "start")
    if log:
        log(f"tune: start (worst, mean)={best} "
            f"(reference worst {ref_worst['delivery_fraction']:.4f})")
    for p in range(passes):
        for coord, values in space.items():
            cands = {f"{coord}={v}": dict(point, **{coord: v})
                     for v in values}
            rep = grid(cands)
            scored = {name: objective(rep, name) for name in cands}
            name, val = max(scored.items(), key=lambda kv: kv[1])
            history.append({"pass": p, "coord": coord,
                            "candidates": scored})
            if val > best:
                best = val
                point = dict(cands[name])
                if log:
                    log(f"tune: {name} -> (worst, mean)={val} "
                        "(new best)")
            elif log:
                log(f"tune: {coord} best candidate {name} "
                    f"(worst, mean)={val} <= {best}, keeping point")
    final = grid({"reference": {}, "tuned": dict(point)})
    tuned_worst = final["worst_case"]["tuned"]
    ref_worst = final["worst_case"]["reference"]
    tuned_obj = objective(final, "tuned")
    ref_obj = objective(final, "reference")
    return {
        "tuned": point,
        "tuned_worst_case": tuned_worst,
        "tuned_mean": tuned_obj[1],
        "tuned_takeover": -tuned_obj[2],
        "reference_worst_case": ref_worst,
        "reference_mean": ref_obj[1],
        "reference_takeover": -ref_obj[2],
        "delta": round(tuned_worst["delivery_fraction"]
                       - ref_worst["delivery_fraction"], 4),
        "delta_mean": round(tuned_obj[1] - ref_obj[1], 6),
        "delta_takeover": round(ref_obj[2] - tuned_obj[2], 4),
        "history": history,
        "shape": {"n": n, "t": t, "m": m, "ticks": n_ticks},
    }


def main() -> None:
    from .flagship import card

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--topics", type=int, default=20)
    ap.add_argument("--msgs", type=int, default=24)
    ap.add_argument("--ticks", type=int, default=150)
    ap.add_argument("--tune", action="store_true",
                    help="run tune_defense at this shape instead")
    args = ap.parse_args()
    if args.tune:
        t0 = time.perf_counter()
        res = tune_defense(args.n, args.topics, args.msgs, args.ticks)
        torch.cuda.synchronize()
        res.update(wall_s=time.perf_counter() - t0, card=card())
        print(json.dumps(res))
        return
    t0 = time.perf_counter()
    rep = run_tournament(args.n, args.topics, args.msgs, args.ticks)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rep.update(replica_heartbeats_per_s=rep["replicas"] * args.ticks / dt,
               wall_s=dt, card=card())
    print(json.dumps(rep))


if __name__ == "__main__":
    main()
