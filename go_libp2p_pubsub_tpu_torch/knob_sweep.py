"""A knob sweep on one built step: the scored GossipSub v1.1 flagship at
the JAX package's documented protocol points, the score defenses on the
IHAVE-spam configuration and the fault knob on the churn benchmark, and a
profile of a knob point's heartbeat.

Knobs (``models/knobs.py``) lift protocol, defense and fault parameters
from constants of the step to 0-d tensors of the params, so one built
step serves every point.  Each configuration here is built once without
knobs, one step is built for it, and each point is armed on the built
sim (``arm``: the params and gates ``make_gossip_sim(...,
sim_knobs=point)`` builds):

- the flagship (``flagship.build``: 1,000,000 peers, 100 topics, C = 16,
  M = 32, ``ScoreSimConfig()``, seed 0) at ``baked`` (no knobs), ``ref``
  (every knob at the config's own value), ``d8`` and ``gf50_bo30`` (the
  JAX package's README config-as-data example), ``d5`` and ``gf40`` (its
  bench_suite.py kernel sweep server): ``FLAGSHIP_POINTS``;
- the IHAVE-spam configuration (``adversarial.build(iwant_spam=False)``:
  the adversarial benchmark's 20% sybils by ``default_rng(7)`` and honest
  origins, the IWANT flood off, which a knob point cannot ride) at
  ``baked`` and the tournament's four defenses plus ``hard``:
  ``DEFENSE_POINTS``;
- the churn benchmark (``churn.build``: 2% link loss) at ``baked`` and the
  fault knob at the schedule's own rate and at 5% with a P7 weight of -40:
  ``CHURN_POINTS``.

Each point runs ``WARMUP`` heartbeats, then ``TIMED`` timed ones (churn:
its benchmark's 100 + 150 through ``gossip_run_curve``), the receive
kernel's launch counts reset before and read after.  Its row: heartbeats/s,
the digest of every state leaf (``tree_digest``), the launches, and the
gates — flagship, mean mesh degree >= the point's Dlo and every message
published >= 30 ticks before the end at every member of its topic;
defense, the adversarial benchmark's honest-degree and honest-delivery
gates; churn, the benchmark's delivery fraction and recovery ticks with
its two gates.  Identity: ``ref``'s digest equals ``baked``'s, the
defense ``reference`` point's its ``baked``'s, and the churn point at the
schedule's own rate the knob-free churn run's.  A knob point launches its
``+knobs`` receive variant once per tick and no other; ``baked`` the
variant without.

    python -m go_libp2p_pubsub_tpu_torch.knob_sweep [--profile 20]

runs the sweep on the GPU and prints one JSON object: every row, the
checks, and a profile of ``--profile`` more heartbeats of the ``gf40``
point after its run (``flagship.profile_ticks``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np
import torch

from . import adversarial, churn, convert, flagship
from .flagship import card, profile_ticks
from .models import gossipsub as gs
from .ops.kernels import receive as krecv
from .ops.kernels import select as ksel

WARMUP, TIMED = 100, 100

#: the flagship's points (None: no knobs)
FLAGSHIP_POINTS = {
    "baked": None,
    "ref": {},
    "d8": {"d": 8, "d_lo": 6, "d_hi": 12},
    "gf50_bo30": {"gossip_factor": 0.5, "backoff_ticks": 30},
    "d5": {"d": 5, "d_hi": 9},
    "gf40": {"gossip_factor": 0.4, "backoff_ticks": 6},
}
#: the attack tournament's defenses (the JAX package's
#: models/tournament.py DEFENSES) and its sweep server's ``hard`` point
DEFENSE_POINTS = {
    "baked": None,
    "reference": {},
    "weak": {"invalid_message_deliveries_weight": 0.0,
             "behaviour_penalty_weight": 0.0},
    "hardened": {"invalid_message_deliveries_weight": -40.0,
                 "behaviour_penalty_weight": -40.0,
                 "graylist_threshold": -50.0,
                 "gossip_threshold": -5.0},
    "tuned": {"invalid_message_deliveries_weight": -10.0,
              "behaviour_penalty_weight": -10.0,
              "graylist_threshold": -80.0,
              "gossip_threshold": -10.0},
    "hard": {"behaviour_penalty_weight": -40.0,
             "graylist_threshold": -60.0},
}
#: the fault knob on the churn benchmark
CHURN_POINTS = {
    "baked": None,
    "drop02": {"drop_prob": churn.DROP_PROB},
    "drop05_bp40": {"drop_prob": 0.05, "behaviour_penalty_weight": -40.0},
}
#: the points whose digest must equal ``baked``'s in each sweep
IDENTITY = {"flagship": "ref", "defense": "reference", "churn": "drop02"}


def flagship_sim(device, n_peers: int = flagship.N_PEERS,
                 warmup: int = WARMUP, timed: int = TIMED, sim_knobs=None):
    return flagship.build(device, n_peers=n_peers, horizon=warmup + timed,
                          sim_knobs=sim_knobs)


def defense_sim(device, n_peers: int = flagship.N_PEERS,
                warmup: int = WARMUP, timed: int = TIMED, sim_knobs=None):
    return adversarial.build(device, n_peers=n_peers,
                             horizon=warmup + timed, iwant_spam=False,
                             sim_knobs=sim_knobs)


def churn_sim(device, n_peers: int = flagship.N_PEERS,
              warmup: int = churn.WARMUP, timed: int = churn.TIMED,
              sim_knobs=None):
    return churn.build(device, n_peers=n_peers, warmup=warmup, ticks=timed,
                       sim_knobs=sim_knobs)


#: each sweep's builder, points and (warm-up, timed) heartbeats
SWEEPS = {"flagship": (flagship_sim, FLAGSHIP_POINTS, (WARMUP, TIMED)),
          "defense": (defense_sim, DEFENSE_POINTS, (WARMUP, TIMED)),
          "churn": (churn_sim, CHURN_POINTS, (churn.WARMUP, churn.TIMED))}


def arm(sim: tuple, point: dict | None) -> tuple:
    """``sim`` (a builder's tuple, built without knobs) armed at
    ``point`` (None: as built): the params ``make_gossip_sim(...,
    sim_knobs=point)`` builds (``gossipsub.knob_params``) and the built
    state's gates recomputed under them, the rest as it is."""
    cfg, sc, params, state, *rest = sim
    if params.sim_knobs is not None or params.score_knobs is not None:
        raise ValueError("arm takes a sim built without knobs")
    params = gs.knob_params(cfg, sc, params, sim_knobs=point)
    return (cfg, sc, params, gs.refresh_gates(cfg, sc, params, state),
            *rest)


def tree_digest(tree: dict) -> str:
    """sha256 of every leaf of a state as numpy (``convert.state_to_numpy``
    here, the reference's leaves alike): fields by sorted name, each
    leaf's name, dtype and bytes; the PRNG key and the gates' fingerprint
    left out."""
    h = hashlib.sha256()

    def walk(name, x):
        if x is None or name in (".key", ".gates_fp"):
            return
        if isinstance(x, dict):
            for k in sorted(x):
                walk(f"{name}.{k}", x[k])
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{name}[{i}]", v)
        else:
            a = np.ascontiguousarray(np.asarray(x))
            h.update(name.encode())
            h.update(a.dtype.str.encode())
            h.update(a.tobytes())

    walk("", tree)
    return h.hexdigest()[:16]


def _launches(k_name: str, ticks: int) -> bool:
    return dict(krecv.launches) == {k_name: ticks}


def run_point(kind: str, sim: tuple, step, point: dict | None, *,
              warmup: int = WARMUP, timed: int = TIMED) -> dict:
    """One point of a sweep (``kind``: flagship, defense or churn) on the
    built ``sim`` and its ``step``: armed, run, gated; its row."""
    cfg, sc, params, state = arm(sim, point)[:4]
    dev = params.subscribed.device
    knobbed = point is not None
    k = krecv.receive_consts(cfg, sc, faults=params.faults is not None,
                             knobs=knobbed)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    krecv.launches.clear()
    ksel.launches = 0
    state = gs.gossip_run(params, state, warmup, step, device=dev)
    sync()
    t0 = time.perf_counter()
    if kind == "churn":
        state, counts = gs.gossip_run_curve(params, state, timed, step,
                                            params.publish_tick.shape[0],
                                            device=dev)
    else:
        state = gs.gossip_run(params, state, timed, step, device=dev)
    sync()
    dt = time.perf_counter() - t0
    ticks = warmup + timed
    row = dict(heartbeats_per_s=timed / dt, ms_per_tick=dt * 1e3 / timed,
               launches=dict(krecv.launches, select=ksel.launches),
               variant=krecv.variant(k),
               launches_ok=_launches(krecv.variant(k), ticks)
               and ksel.launches > 0,
               digest=tree_digest(convert.state_to_numpy(state)))
    if kind == "flagship":
        d_lo = cfg.d_lo if not point else point.get("d_lo", cfg.d_lo)
        deg = gs.mesh_degrees(state)[params.subscribed].to(
            torch.float64).mean().item()
        reach = gs.reach_counts_from_have(params, state).cpu().numpy()
        msg_tick = params.publish_tick.cpu().numpy()
        settled = msg_tick < ticks - 30
        want = params.subscribed.shape[0] // cfg.n_topics
        row.update(mean_mesh_degree=deg, d_lo=d_lo,
                   settled_messages=int(settled.sum()),
                   delivery_ok=bool((reach[settled] == want).all()))
        row["gates_ok"] = deg >= d_lo and row["delivery_ok"]
    elif kind == "defense":
        g = adversarial.gates(cfg, params, state, sim[4],
                              params.publish_tick.cpu().numpy(), ticks)
        row.update(honest_mean_degree=g["honest_mean_degree"],
                   degree_ok=g["degree_ok"], delivery_ok=g["delivery_ok"],
                   settled_messages=g["settled_messages"],
                   serves_max=g["serves_max"],
                   behaviour_penalty_max=float(
                       state.scores.behaviour_penalty.float().max()))
        row["gates_ok"] = g["degree_ok"] and g["delivery_ok"]
    else:
        out = churn.readouts(params, state, counts, sim[5], cfg.n_topics,
                             warmup)
        row.update({k_: out[k_] for k_ in (
            "delivery_fraction", "settled_messages", "probe_recovery_ticks",
            "recovery_ticks_median", "delivery_ok")})
        row["gates_ok"] = out["ok"]
    row["ok"] = row["gates_ok"] and row["launches_ok"]
    return row


def run_sweep(kind: str, device, n_peers: int = flagship.N_PEERS, *,
              warmup: int | None = None, timed: int | None = None,
              points: dict | None = None) -> dict:
    """Every point of one sweep on one built sim and one step: the rows,
    the identity check, and the points whose digest differs from
    ``baked``'s."""
    builder, all_points, (w0, t0) = SWEEPS[kind]
    points = all_points if points is None else points
    warmup = w0 if warmup is None else warmup
    timed = t0 if timed is None else timed
    sim = builder(device, n_peers=n_peers, warmup=warmup, timed=timed)
    step = gs.make_gossip_step(sim[0], sim[1], device=device)
    rows = {name: run_point(kind, sim, step, point, warmup=warmup,
                            timed=timed)
            for name, point in points.items()}
    base = rows["baked"]["digest"]
    ident = IDENTITY[kind]
    out = dict(rows=rows,
               differ_from_baked=sorted(n_ for n_, r in rows.items()
                                        if r["digest"] != base))
    if ident in rows:
        out["identity_ok"] = rows[ident]["digest"] == base
    out["ok"] = (all(r["ok"] for r in rows.values())
                 and out.get("identity_ok", True))
    return out


def run(device, n_peers: int = flagship.N_PEERS) -> dict:
    """The three sweeps (``run_sweep``) on ``device``."""
    out = {kind: run_sweep(kind, device, n_peers) for kind in SWEEPS}
    out["ok"] = all(out[kind]["ok"] for kind in SWEEPS)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the knob sweep needs an NVIDIA GPU")
    dev = torch.device("cuda")
    out = run(dev)
    # a profile of the gf40 point after its run
    sim = flagship_sim(dev, timed=TIMED + 2 * args.profile)
    cfg, sc, params, state = arm(sim, FLAGSHIP_POINTS["gf40"])[:4]
    step = gs.make_gossip_step(cfg, sc, device=dev)
    box = [gs.gossip_run(params, state, WARMUP + TIMED, step, device=dev)]

    def more():
        box[0] = gs.gossip_run(params, box[0], args.profile, step,
                               device=dev)
    out["profile_gf40"] = profile_ticks(more, args.profile)
    out["device"] = torch.cuda.get_device_name(0)
    out["card"] = card()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
