"""The resident, adversarial and everything-on configurations' gates,
checked on the JAX reference.

    JAX_PLATFORMS=cpu python tests/torch_reference_gate.py [--n 131072]
    JAX_PLATFORMS=cpu python tests/torch_reference_gate.py --adversarial \
        [--n 100000] [--ticks 400]
    JAX_PLATFORMS=cpu python tests/torch_reference_gate.py --everything \
        [--n 100000] [--ticks 400]
    JAX_PLATFORMS=cpu python tests/torch_reference_gate.py \
        --everything-paired [--n 100000] [--ticks 400]
    JAX_PLATFORMS=cpu python tests/torch_reference_gate.py --churn \
        [--n 100000]
    JAX_PLATFORMS=cpu python tests/torch_reference_gate.py --telemetry \
        [--n 100000] [--port]
    JAX_PLATFORMS=cpu python tests/torch_reference_gate.py --knobs \
        [--n 100000] [--port]
    JAX_PLATFORMS=cpu python tests/torch_reference_gate.py --pipelined \
        [--n 100000] [--port]
    JAX_PLATFORMS=cpu python tests/torch_reference_gate.py --invariants \
        [--n 100000] [--port]
    JAX_PLATFORMS=cpu python tests/torch_reference_gate.py --tournament \
        [--n 20000] [--port]
    JAX_PLATFORMS=cpu python tests/torch_reference_gate.py --batched \
        [--n 100000] [--port]
    JAX_PLATFORMS=cpu python tests/torch_reference_gate.py --randomsub \
        [--n 10000] [--port]

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

With ``--churn`` it runs the JAX package's churn benchmark
(bench_suite.py ``bench_gossipsub_v11_churn``, the flagship under 10%
churn in three staggered waves, 2% link loss and a 30-tick half/half
partition; go_libp2p_pubsub_tpu_torch/churn.py) as written, 100 warm-up
and 150 curve ticks, at its CPU size, and prints its rows unrounded: the
delivery fraction of the settled messages against its gate (above
0.80), each recovery probe's ticks from heal to 99% of its topic and
their median (gate: at least one probe recovered).

With ``--telemetry`` it runs the JAX package's telemetry-kernel benchmark
(bench_suite.py ``bench_gossipsub_telemetry_kernel``: the flagship with
telemetry off, then on with ``TelemetryConfig()``, 100 warm-up and 3 x 100
timed heartbeats, each timed window's frames summarized;
go_libp2p_pubsub_tpu_torch/telemetry_flagship.py) on its unpadded XLA step
at ``--n`` peers, and prints the control-overhead ratio and the totals
unrounded, the flagship's gates on both runs and whether the two runs'
states are equal.  With ``--port`` the port's plain CPU run of the same
benchmark (``telemetry_flagship.run("cpu", n_peers=n)``, many minutes at
100,000 peers) must give the same ratio and totals; exits 1 if not.

With ``--knobs`` it runs the knob sweep (go_libp2p_pubsub_tpu_torch/
knob_sweep.py: the flagship at its protocol points, the defenses on the
IHAVE-spam configuration, the fault knob on the churn benchmark) on the
JAX package's XLA step at ``--n`` peers, each point's sim built by its
``make_gossip_sim(sim_knobs=point)`` and stepped as the sweep steps it,
and prints each point's gates and the digest of every state leaf
(``knob_sweep.tree_digest``); exits 1 if a gate or an identity (ref,
reference and the churn point at 0.02 equal to baked) fails.  With
``--port`` the port's plain CPU run of the same sweep
(``knob_sweep.run_sweep``, about an hour at 100,000 peers) must give the
same digests and gates.

With ``--pipelined`` it runs the JAX package's pipelined-gossip benchmark
(bench_suite.py ``bench_gossipsub_pipelined``; go_libp2p_pubsub_tpu_torch/
pipelined.py: the delay line DelayConfig(1, 0, 8), the points base1,
base2, base4 and base4j2 through the delay knobs, the latency histogram
on) on the JAX package's XLA step at ``--n`` peers as the benchmark runs
it: each point's sim built by its ``make_gossip_sim(sim_knobs=point)``,
the four stacked and stepped 48 ticks from build as one batched dispatch
(``telemetry_run_batch``), and prints the benchmark's rows (delivery
fraction, latency percentiles, histogram, the p99 stretch) and the digest
of every leaf of each replica's state; exits 1 if one of its two gates
fails.  With ``--port`` the port's plain CPU run of the batched form
(``pipelined.run("cpu", n)``, a few minutes at 100,000 peers) must give
the same digests and rows.

With ``--invariants`` it runs the configuration of the JAX package's
invariant-overhead benchmark (bench_suite.py ``_bench_invariants``, its XLA
form ``kernel=False``: the flagship, 32 messages by ``default_rng(0)`` over
the 200-tick horizon; go_libp2p_pubsub_tpu_torch/invariants_flagship.py)
on the JAX package's XLA step at ``--n`` peers, the checker off, then
armed with ``InvariantConfig()``, 100 warm-up and 100 more ticks each, and
prints the armed run's report, the flagship's gates on both runs and the
digest of every state leaf (``knob_sweep.tree_digest``) of both end
states; exits 1 unless the report has no bits, the gates pass and the two
end states are equal but for the carry.  With ``--port`` the port's plain
CPU run (``invariants_flagship.run("cpu", n)``, a few minutes at 100,000
peers) must give the same digests, the carry's too.

With ``--tournament`` it runs the JAX package's attack × defense
tournament (``models/tournament.py`` ``run_tournament(n, 20, 24, 150)``,
bench_suite.py ``bench_gossipsub_tournament``, 20 cells as one batched
dispatch) on the CPU at ``--n`` peers (default 20,000, the benchmark's),
prints each row beside TOURNEY_r12.json's and whether the run reproduces
that file; exits 1 if any cell has an invariant bit.  With ``--port`` the
port's cell-by-cell CPU run (``tournament.run_tournament(..., device=
"cpu")``) must give the same report.

With ``--randomsub`` it runs the JAX package's RandomSub-10k benchmark
(bench_suite.py ``bench_randomsub_10k``: one topic, 32 messages, C = 128,
the dense step, 50 + 300 ticks; go_libp2p_pubsub_tpu_torch/randomsub_10k.py)
on the reference at ``--n`` peers (default 10,000, the benchmark's) and
prints its reach gate (every message at every peer) and the digest of
every state leaf; with ``--port`` the port's plain CPU run must give the
same reach and digest.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from go_libp2p_pubsub_tpu_torch import (  # noqa: E402
    adversarial,
    churn,
    everything,
    flagship,
    invariants_flagship,
    knob_sweep,
    pipelined,
    resident,
    telemetry_flagship,
)
from torch_ref import imported_reference, tree_to_numpy  # noqa: E402


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


def reference_churn_sim(r, n: int):
    """The reference's churn benchmark sim at ``n`` peers, built as
    bench_suite.py ``bench_gossipsub_v11_churn`` builds it (its lines, with
    the reference's modules): (cfg, score_cfg, params, state, schedule,
    probes, heal, warmup, ticks)."""
    gs, fl = r.gs, r.faults
    t = 100
    m, C = 32, 16
    warmup, T = 100, 150
    horizon = warmup + T
    part_start, heal = warmup + 20, warmup + 50
    rng = np.random.default_rng(0)
    cfg = gs.GossipSimConfig(
        offsets=gs.make_gossip_offsets(t, C, n, seed=0), n_topics=t)
    score_cfg = gs.ScoreSimConfig()
    topic = rng.integers(0, t, m)
    origin = rng.integers(0, n // t, m) * t + topic
    tick = np.sort(rng.integers(0, horizon - 40, m)).astype(np.int32)
    grp = (np.arange(n) < n // 2).astype(np.int64)
    probe = np.arange(m - 4, m)
    tick[probe] = heal - 2
    origin[probe] = (origin[probe] % (n // 2 // t)) * t + topic[probe]
    victims = np.flatnonzero(rng.random(n) < 0.10)
    ivs = [(int(p), warmup + 5 + int(p % 3) * 5,
            warmup + 25 + int(p % 3) * 5) for p in victims]
    sched = fl.FaultSchedule(
        n_peers=n, horizon=horizon, down_intervals=ivs, drop_prob=0.02,
        partition_group=grp, partition_windows=[(part_start, heal)],
        seed=1)
    subs = resident.subs_matrix(n, t)
    params, state = gs.make_gossip_sim(
        cfg, subs, topic, origin, tick, score_cfg=score_cfg,
        track_first_tick=False, fault_schedule=sched)
    return cfg, score_cfg, params, state, sched, probe, heal, warmup, T


def churn_gates(n: int) -> int:
    """The churn benchmark's rows and gates on the reference."""
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.faults as rfl
        from go_libp2p_pubsub_tpu.models._delivery import recovery_ticks

        r.faults = rfl
        (cfg, sc, params, state, _, probe, heal, warmup,
         T) = reference_churn_sim(r, n)
        gs = r.gs
        m, t = params.publish_tick.shape[0], cfg.n_topics
        step = gs.make_gossip_step(cfg, sc)
        state = gs.gossip_run(params, state, warmup, step)
        state, counts = gs.gossip_run_curve(params, state, T, step, m)
        counts = np.asarray(counts)
        want = np.full(m, n // t, dtype=np.float32)
        reach = np.asarray(gs.reach_counts_from_have(params, state))
        settled = np.ones(m, dtype=bool)
        settled[probe] = False
        frac = float((reach[settled] / want[settled]).mean())
        rec = np.asarray(recovery_ticks(counts, heal - warmup, want,
                                        frac=0.99))[probe]
    rec_ok = rec[rec >= 0]
    ok = frac > 0.80 and len(rec_ok) > 0
    print(f"N={n}, {warmup} + {T} ticks: delivery fraction {frac!r} over "
          f"{int(settled.sum())} settled messages (gate > 0.8); probes' "
          f"recovery ticks {rec.tolist()}, median of the recovered "
          f"{float(np.median(rec_ok)) if len(rec_ok) else None} "
          f"({len(rec_ok)} of {len(rec)} recovered)")
    for j in range(m):
        print(f"msg {j}: tick {int(params.publish_tick[j])} reach "
              f"{reach[j]}/{int(want[j])}"
              f"{'' if settled[j] else ' (recovery probe)'}")
    print("gates", "pass" if ok else "FAIL")
    return 0 if ok else 1


def telemetry_rows(n: int, port: bool) -> int:
    """The telemetry benchmark's rows on the reference (and, with
    ``port``, the port's CPU run against them)."""
    warmup, ticks, reps = (telemetry_flagship.WARMUP,
                           telemetry_flagship.TICKS, telemetry_flagship.REPS)
    horizon = warmup + ticks * reps
    with imported_reference() as r:
        gs, tl = r.gs, r.gs._telemetry
        t, m, C = 100, 32, 16
        rng = np.random.default_rng(0)
        cfg = gs.GossipSimConfig(
            offsets=gs.make_gossip_offsets(t, C, n, seed=0), n_topics=t)
        sc = gs.ScoreSimConfig()
        topic = rng.integers(0, t, m)
        origin = rng.integers(0, n // t, m) * t + topic
        tick = np.sort(rng.integers(0, horizon, m)).astype(np.int32)
        ends, summaries = {}, []
        for mode in ("off", "on"):
            params, state = gs.make_gossip_sim(
                cfg, resident.subs_matrix(n, t), topic, origin, tick,
                score_cfg=sc, track_first_tick=False)
            step = gs.make_gossip_step(cfg, sc, telemetry=(
                tl.TelemetryConfig() if mode == "on" else None))
            if mode == "off":
                state = gs.gossip_run(params, state, horizon, step)
            else:
                state, _ = tl.telemetry_run(params, state, warmup, step)
                for _ in range(reps):
                    state, fr = tl.telemetry_run(params, state, ticks, step)
                    summaries.append(tl.summarize_frames(fr))
            deg = float(np.asarray(gs.mesh_degrees(state))[
                np.asarray(params.subscribed)].mean())
            reach = np.asarray(gs.reach_counts_from_have(params, state))
            settled = tick < horizon - 30
            ends[mode] = (np.asarray(state.mesh), np.asarray(state.have),
                          deg, bool((reach[settled] == n // t).all()))
    totals = {k: sum(s_[k] for s_ in summaries)
              for k in telemetry_flagship.TOTALS}
    ratio = totals["bytes_control"] / totals["bytes_payload"]
    same = all(np.array_equal(a, b) for a, b in zip(ends["off"][:2],
                                                    ends["on"][:2]))
    ok = same and all(e[2] >= cfg.d_lo and e[3] for e in ends.values())
    print(f"N={n}, {warmup} + {reps} x {ticks} ticks: control overhead "
          f"ratio {ratio!r}; totals {totals}; mean mesh degree off "
          f"{ends['off'][2]:.4f}, on {ends['on'][2]:.4f} (Dlo {cfg.d_lo}); "
          f"settled messages at every member: off {ends['off'][3]}, on "
          f"{ends['on'][3]}; off and on end states equal: {same}")
    if port:
        out = telemetry_flagship.run("cpu", n_peers=n, warmup=warmup,
                                     ticks=ticks, reps=reps)
        match = (out["totals"] == totals
                 and out["control_overhead_ratio"] == ratio)
        print(f"port (CPU): control overhead ratio "
              f"{out['control_overhead_ratio']!r}; totals {out['totals']}; "
              f"checks {out['checks']}; equal to the reference: {match}")
        ok = ok and match and out["ok"]
    print("gates", "pass" if ok else "FAIL")
    return 0 if ok else 1


def reference_knob_sims(r, kind: str, n: int):
    """The reference's sim builder of one sweep at ``n`` peers, in the
    port's builders' draw order: ``build(point) -> (cfg, sc, params,
    state, msg_topic, msg_tick, probes)``; and its (warm-up, timed)
    ticks."""
    gs = r.gs
    t, m, C = flagship.N_TOPICS, flagship.N_MSGS, flagship.N_CAND
    warmup, timed = knob_sweep.SWEEPS[kind][2]
    horizon = warmup + timed
    if kind == "churn":
        def build(point):
            (cfg, sc, _, _, sched, probes, *_) = reference_churn_sim(r, n)
            kw = {} if point is None else {"sim_knobs": point}
            rng = np.random.default_rng(0)
            topic = rng.integers(0, t, m)
            origin = rng.integers(0, n // t, m) * t + topic
            tick = np.sort(rng.integers(0, horizon - 40, m)).astype(np.int32)
            tick[probes] = churn.heal_tick() - 2
            origin[probes] = ((origin[probes] % (n // 2 // t)) * t
                              + topic[probes])
            params, state = gs.make_gossip_sim(
                cfg, resident.subs_matrix(n, t), topic, origin, tick,
                score_cfg=sc, track_first_tick=False, fault_schedule=sched,
                **kw)
            return cfg, sc, params, state, topic, tick, probes
        return build, warmup, timed
    cfg = gs.GossipSimConfig(offsets=gs.make_gossip_offsets(t, C, n, seed=0),
                             n_topics=t)
    if kind == "flagship":
        rng = np.random.default_rng(0)
        topic = rng.integers(0, t, m)
        origin = rng.integers(0, n // t, m) * t + topic
        tick = np.sort(rng.integers(0, horizon, m)).astype(np.int32)
        sc, extra = gs.ScoreSimConfig(), {}
    else:
        sybil, topic, origin, tick = adversarial.draws(n, t, horizon)
        sc, extra = gs.ScoreSimConfig(sybil_ihave_spam=True), dict(
            sybil=sybil)

    def build(point):
        kw = dict(extra) if point is None else dict(extra, sim_knobs=point)
        params, state = gs.make_gossip_sim(
            cfg, resident.subs_matrix(n, t), topic, origin, tick,
            score_cfg=sc, track_first_tick=False, **kw)
        return cfg, sc, params, state, topic, tick, None
    return build, warmup, timed


def knob_rows(n: int, port: bool) -> int:
    """The knob sweep's gates and digests on the reference (and, with
    ``port``, the port's CPU run against them)."""
    import jax

    from torch_ref import tree_to_numpy

    ok, want = True, {}
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.faults as rfl
        from go_libp2p_pubsub_tpu.models._delivery import recovery_ticks

        r.faults = rfl
        gs = r.gs
        for kind in knob_sweep.SWEEPS:
            build, warmup, timed = reference_knob_sims(r, kind, n)
            horizon = warmup + timed
            steps = {}
            rows = want[kind] = {}
            for pname, point in knob_sweep.SWEEPS[kind][1].items():
                cfg, sc, params, state, topic, tick, probes = build(point)
                key = point is None
                if key not in steps:
                    steps[key] = jax.jit(gs.make_gossip_step(cfg, sc))
                m = len(topic)
                counts = []
                for i in range(horizon):
                    state, dlv = steps[key](params, state)
                    if kind == "churn" and i >= warmup:
                        counts.append(np.asarray(
                            gs.count_bits_per_position(dlv, m)))
                row = dict(digest=knob_sweep.tree_digest(
                    tree_to_numpy(state)))
                if kind == "flagship":
                    d_lo = cfg.d_lo if not point else point.get("d_lo",
                                                                 cfg.d_lo)
                    deg = float(np.asarray(gs.mesh_degrees(state))[
                        np.asarray(params.subscribed)].mean())
                    reach = np.asarray(gs.reach_counts_from_have(params,
                                                                 state))
                    settled = tick < horizon - 30
                    row.update(mean_mesh_degree=deg, d_lo=d_lo,
                               delivery_ok=bool((reach[settled]
                                                 == n // cfg.n_topics).all()))
                    row["gates_ok"] = deg >= d_lo and row["delivery_ok"]
                elif kind == "defense":
                    honest = ~np.asarray(params.sybil)
                    reach = np.asarray(gs.reach_counts_from_have(
                        params, state, mask=honest))
                    keep = honest & np.asarray(params.subscribed)
                    deg = float(np.asarray(gs.mesh_degrees(state))[
                        keep].mean())
                    cls = np.arange(n) % cfg.n_topics
                    members = np.array([(honest & (cls == tau)).sum()
                                        for tau in topic])
                    settled = tick < horizon - 30
                    row.update(honest_mean_degree=deg,
                               delivery_ok=bool((reach[settled]
                                                 == members[settled]).all()))
                    row["gates_ok"] = deg >= cfg.d_lo and row["delivery_ok"]
                else:
                    reach = np.asarray(gs.reach_counts_from_have(params,
                                                                 state))
                    w_ = np.full(m, n // cfg.n_topics, dtype=np.float32)
                    settled = np.ones(m, dtype=bool)
                    settled[probes] = False
                    frac = float((reach[settled] / w_[settled]).mean())
                    rec = np.asarray(recovery_ticks(
                        np.stack(counts), churn.heal_tick() - warmup, w_,
                        frac=churn.RECOVERY_FRAC))[probes]
                    row.update(delivery_fraction=frac,
                               probe_recovery_ticks=rec.tolist(),
                               delivery_ok=frac
                               > churn.MIN_DELIVERY_FRACTION)
                    row["gates_ok"] = row["delivery_ok"] and bool(
                        (rec >= 0).any())
                rows[pname] = row
                ok &= row["gates_ok"]
                print(f"{kind} {pname}: {row}", flush=True)
            ident = knob_sweep.IDENTITY[kind]
            same = rows[ident]["digest"] == rows["baked"]["digest"]
            ok &= same
            differ = sorted(p_ for p_, r_ in rows.items()
                            if r_["digest"] != rows["baked"]["digest"])
            print(f"{kind}: {ident} == baked: {same}; digests differing "
                  f"from baked: {differ}", flush=True)
    if port:
        for kind in knob_sweep.SWEEPS:
            got = knob_sweep.run_sweep(kind, "cpu", n)
            for pname, row in got["rows"].items():
                w_ = want[kind][pname]
                match = (row["digest"] == w_["digest"]
                         and row["gates_ok"] == w_["gates_ok"])
                ok &= match
                print(f"port (CPU) {kind} {pname}: digest {row['digest']}, "
                      f"gates {row['gates_ok']}; equal to the reference: "
                      f"{match}", flush=True)
    print("gates", "pass" if ok else "FAIL")
    return 0 if ok else 1


def pipelined_rows(n: int, port: bool) -> int:
    """The pipelined benchmark's rows, gates and digests on the reference
    (and, with ``port``, the port's CPU run against them)."""
    import jax

    from go_libp2p_pubsub_tpu_torch.histutil import hist_percentiles
    from torch_ref import tree_to_numpy

    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.delays as rdl
        import go_libp2p_pubsub_tpu.models.telemetry as rtl

        gs = r.gs
        t, m = pipelined.N_TOPICS, pipelined.N_MSGS
        rng = np.random.default_rng(0)
        topic = rng.integers(0, t, m)
        origin = rng.integers(0, n // t, m) * t + topic
        tick = np.sort(rng.integers(0, pipelined.MSG_HORIZON, m)).astype(
            np.int32)
        cfg = gs.GossipSimConfig(
            offsets=gs.make_gossip_offsets(t, pipelined.N_CAND, n, seed=7),
            n_topics=t)
        sc = gs.ScoreSimConfig()
        dc = rdl.DelayConfig(base=pipelined.DELAYS.base,
                             jitter=pipelined.DELAYS.jitter,
                             k_slots=pipelined.DELAYS.k_slots)
        step = gs.make_gossip_step(
            cfg, sc, telemetry=rtl.TelemetryConfig(**pipelined.TELEMETRY))
        # as the benchmark runs them: the four points built with their
        # knobs, stacked, and advanced as one batched dispatch
        builds = [gs.make_gossip_sim(
            cfg, resident.subs_matrix(n, t), topic, origin, tick,
            seed=pipelined.SEED, score_cfg=sc, delays=dc,
            track_first_tick=False, sim_knobs=point)
            for point in pipelined.POINTS.values()]
        params = gs.stack_trees([p_ for p_, _ in builds])
        state, frames = rtl.telemetry_run_batch(
            params, gs.stack_trees([s_ for _, s_ in builds]),
            pipelined.TICKS, step)
        hists = np.asarray(frames.latency_hist).sum(0)           # [B, L]
        reach = np.asarray(jax.vmap(gs.reach_counts_from_have)(params,
                                                               state))
        rows = {}
        for i, (pid, point) in enumerate(pipelined.POINTS.items()):
            hist = hists[i]
            rows[pid] = dict(
                delay_base=int(point.get("delay_base", dc.base)),
                delay_jitter=int(point.get("delay_jitter", dc.jitter)),
                delivery_fraction=float(reach[i].astype(np.float64).mean())
                / (n // t), hist=[int(c) for c in hist],
                latency=hist_percentiles(hist),
                digest=knob_sweep.tree_digest(tree_to_numpy(
                    gs.index_trees(state, i))))
            print(f"{pid}: {rows[pid]}", flush=True)
    g = pipelined.gates(rows)
    p99 = {pid: r_["latency"]["p99"] for pid, r_ in rows.items()}
    print(f"gates {g}; p99 {p99}; p99_stretch_base4 "
          f"{p99['base4'] / max(p99['base1'] or 0, 1)!r}", flush=True)
    ok = g["ok"]
    if port:
        got = pipelined.run("cpu", n)
        for pid, row in got["rows"].items():
            w_ = rows[pid]
            match = all(row[k] == w_[k] for k in (
                "digest", "hist", "latency", "delivery_fraction"))
            ok &= match
            print(f"port (CPU) {pid}: digest {row['digest']}, delivery "
                  f"fraction {row['delivery_fraction']!r}, latency "
                  f"{row['latency']}; equal to the reference: {match}",
                  flush=True)
    print("gates", "pass" if ok else "FAIL")
    return 0 if ok else 1


def invariants_rows(n: int, port: bool) -> int:
    """The invariant-overhead benchmark's report, gates and digests on the
    reference's XLA step (and, with ``port``, the port's CPU run against
    them)."""
    warmup, ticks = invariants_flagship.WARMUP, invariants_flagship.TICKS
    horizon = warmup + ticks
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.invariants as iv
        gs = r.gs
        t, m, C = 100, 32, 16
        rng = np.random.default_rng(0)
        cfg = gs.GossipSimConfig(
            offsets=gs.make_gossip_offsets(t, C, n, seed=0), n_topics=t)
        sc = gs.ScoreSimConfig()
        topic = rng.integers(0, t, m)
        origin = rng.integers(0, n // t, m) * t + topic
        tick = np.sort(rng.integers(0, horizon, m)).astype(np.int32)
        digests, gates, report = {}, {}, None
        for mode in ("off", "on"):
            params, state = gs.make_gossip_sim(
                cfg, resident.subs_matrix(n, t), topic, origin, tick,
                score_cfg=sc, track_first_tick=False)
            icfg = None
            if mode == "on":
                state, icfg = iv.attach(state), iv.InvariantConfig()
            step = gs.make_gossip_step(cfg, sc, invariants=icfg)
            state = gs.gossip_run(params, state, warmup, step)
            state = gs.gossip_run(params, state, ticks, step)
            tree = tree_to_numpy(state)
            digests[mode] = knob_sweep.tree_digest(tree)
            if mode == "on":
                report = iv.report(state)
                digests["on_unarmed"] = knob_sweep.tree_digest(
                    dict(tree, inv_viol=None, inv_first=None))
            deg = float(np.asarray(gs.mesh_degrees(state))[
                np.asarray(params.subscribed)].mean())
            reach = np.asarray(gs.reach_counts_from_have(params, state))
            settled = tick < horizon - 30
            gates[mode] = (deg, bool((reach[settled] == n // t).all()))
    same = digests["off"] == digests["on_unarmed"]
    ok = (report["bits"] == 0 and same
          and all(d >= cfg.d_lo and dl for d, dl in gates.values()))
    print(f"N={n}, {warmup} + {ticks} ticks: report {report}; mean mesh "
          f"degree off {gates['off'][0]:.4f}, on {gates['on'][0]:.4f} (Dlo "
          f"{cfg.d_lo}); settled messages at every member: off "
          f"{gates['off'][1]}, on {gates['on'][1]}; digests off "
          f"{digests['off']}, on {digests['on']}; off and on end states "
          f"equal but for the carry: {same}")
    if port:
        out = invariants_flagship.run("cpu", n_peers=n, warmup=warmup,
                                      ticks=ticks)
        match = (out["off"]["tree_digest"] == digests["off"]
                 and out["on"]["tree_digest"] == digests["on"]
                 and out["report"] == report)
        print(f"port (CPU): report {out['report']}; digests off "
              f"{out['off']['tree_digest']}, on {out['on']['tree_digest']}; "
              f"checks {out['checks']}; equal to the reference: {match}")
        ok = ok and match and out["ok"]
    print("gates", "pass" if ok else "FAIL")
    return 0 if ok else 1


def randomsub_rows(n: int, port: bool) -> int:
    """The JAX package's RandomSub-10k benchmark (``bench_randomsub_10k``:
    one topic, M = 32 by ``default_rng(0)`` over [0, 320), C = 128, the
    dense step, 50 + 300 ticks) on the reference at ``n`` peers: its reach
    gate and a digest of every state leaf (and, with ``port``, the port's
    plain CPU run, ``randomsub_10k.run(True, "cpu", n)``, against them)."""
    from go_libp2p_pubsub_tpu_torch import randomsub_10k

    t, m, c = 1, 32, randomsub_10k.N_CAND
    ticks = 50 + 3 * 100
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.randomsub as rs
        rng = np.random.default_rng(0)
        cfg = rs.RandomSubSimConfig(
            offsets=rs.make_randomsub_offsets(t, c, n, seed=0), n_topics=t)
        topic = rng.integers(0, t, m)
        origin = rng.integers(0, n // t, m) * t + topic
        tick = np.sort(rng.integers(0, ticks - 30, m)).astype(np.int32)
        params, state = rs.make_randomsub_sim(
            cfg, resident.subs_matrix(n, t), topic, origin, tick, dense=True)
        state = rs.randomsub_run(params, state, ticks,
                                 rs.make_randomsub_dense_step(cfg))
        reach = np.asarray(rs.reach_counts(params, state))
        digest = knob_sweep.tree_digest(tree_to_numpy(state))
    ok = bool((reach == n).all())
    print(f"N={n}, {ticks} ticks, dense step: reach {reach.tolist()} "
          f"(gate: every message at all {n}): {ok}; digest {digest}")
    if port:
        out = randomsub_10k.run(True, "cpu", n_peers=n)
        match = out["digest"] == digest and out["reach_min"] == reach.min()
        print(f"port (CPU): reach min {out['reach_min']}, digest "
              f"{out['digest']}, {out['heartbeats_per_s']!r} heartbeats/s "
              f"on this CPU; equal to the reference: {match}")
        ok = ok and match and out["ok"]
    print("gates", "pass" if ok else "FAIL")
    return 0 if ok else 1


def tournament_rows(n: int, port: bool) -> int:
    """The reference's attack × defense tournament at its benchmark shape
    (``run_tournament(n, 20, 24, 150)``, one batched dispatch on the
    CPU): its rows beside the JAX package's committed TOURNEY_r12.json,
    and with ``port`` the port's cell-by-cell CPU run, whose rows must
    equal the reference's."""
    import json
    import time
    from pathlib import Path

    from go_libp2p_pubsub_tpu_torch import tournament as ptn

    t, m, ticks = 20, 24, 150
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.tournament as rtn
        t0 = time.perf_counter()
        rep = rtn.run_tournament(n, t, m, ticks, seed=0)
        dt = time.perf_counter() - t0
    committed = json.loads((Path(__file__).resolve().parents[1]
                            / "TOURNEY_r12.json").read_text())
    same_shape = (committed["n_peers"], committed["n_topics"],
                  committed["n_msgs"], committed["ticks"]) == (n, t, m, ticks)
    reproduces = same_shape and committed["rows"] == rep["rows"]
    print(f"reference run_tournament({n}, {t}, {m}, {ticks}) on the CPU in "
          f"{dt:.1f} s ({rep['replicas'] * ticks / dt:.2f} replica "
          f"heartbeats/s)")
    for row in rep["rows"]:
        old = next((c for c in committed["rows"]
                    if (c["attack"], c["defense"])
                    == (row["attack"], row["defense"])), None)
        print(f"  {json.dumps(row)}  committed: {json.dumps(old)}")
    print(f"worst case {rep['worst_case']}; invariant violations "
          f"{rep['invariant_violations']}; reproduces TOURNEY_r12.json: "
          f"{reproduces}")
    ok = rep["invariant_violations"] == 0
    if port:
        t0 = time.perf_counter()
        mine = ptn.run_tournament(n, t, m, ticks, seed=0, device="cpu")
        dt = time.perf_counter() - t0
        match = mine == rep
        print(f"port (CPU, one dispatch) in {dt:.1f} s: rows equal to the "
              f"reference's: {mine['rows'] == rep['rows']}; report equal: "
              f"{match}")
        ok = ok and match
    print("gates", "pass" if ok else "FAIL")
    return 0 if ok else 1


def batched_rows(n: int, port: bool, replicas: int = 4) -> int:
    """The JAX package's batched flagship benchmark at its CPU shape
    (``bench_gossipsub_v11_batched``: ``replicas`` flagship replicas,
    mesh seeds 0..B-1, the ring and the messages drawn with seed 0, 100
    warm-up and 3 × 100 ticks through ``gossip_run_batch``) with its
    gates per replica (the mean mesh degree of every replica's subscribed
    peers against Dlo, every settled message at every topic member, the
    IWANT-serve ledgers under the flood cap) and each replica's digest;
    with ``port`` the port's CPU run of ``batched_flagship`` (the same
    build, ``gossip_run_batch``) replica by replica against them."""
    import time

    from go_libp2p_pubsub_tpu_torch import batched_flagship as bf
    from go_libp2p_pubsub_tpu_torch import convert
    from go_libp2p_pubsub_tpu_torch import flagship as pflag
    from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs

    horizon = bf.WARMUP + bf.TIMED * bf.BLOCKS
    cfg_p, subs, topic, origin, tick = pflag.inputs(n, horizon=horizon)
    with imported_reference() as r:
        gs = r.gs
        cfg = gs.GossipSimConfig(offsets=cfg_p.offsets, n_topics=100)
        sc = gs.ScoreSimConfig()
        builds = [gs.make_gossip_sim(cfg, subs, topic, origin, tick, seed=b,
                                     score_cfg=sc, track_first_tick=False)
                  for b in range(replicas)]
        params = gs.stack_trees([b[0] for b in builds])
        state = gs.stack_trees([b[1] for b in builds])
        step = gs.make_gossip_step(cfg, sc)
        t0 = time.perf_counter()
        state = gs.gossip_run_batch(params, state, horizon, step)
        dt = time.perf_counter() - t0
        sub = np.asarray(params.subscribed)
        deg = float(np.asarray(gs.mesh_degrees(state))[sub].mean())
        settled = tick < horizon - 30
        reach = np.stack([np.asarray(gs.reach_counts_from_have(
            gs.index_trees(params, b), gs.index_trees(state, b)))
            for b in range(replicas)])
        serves = int(np.asarray(state.iwant_serves).max())
        digests = [knob_sweep.tree_digest(tree_to_numpy(
            gs.index_trees(state, b))) for b in range(replicas)]
    cap = (cfg.gossip_retransmission + 1) * 32
    ok = (deg >= cfg.d_lo and (reach[:, settled] == n // 100).all()
          and serves < cap)
    print(f"reference batched flagship, {replicas} x {n} peers, "
          f"{horizon} ticks on the CPU in {dt:.1f} s: mean mesh degree "
          f"{deg:.4f} (Dlo {cfg.d_lo}); settled messages at every member "
          f"in every replica: {bool((reach[:, settled] == n // 100).all())}"
          f"; IWANT serves max {serves} (cap {cap}); digests "
          f"{[d[:16] for d in digests]}")
    if port:
        c_p, s_p, p_p, st_p, _ = bf.build("cpu", n, replicas)
        t0 = time.perf_counter()
        st_p = pgs.gossip_run_batch(p_p, st_p, horizon,
                                    pgs.make_gossip_step(c_p, s_p,
                                                         device="cpu"),
                                    device="cpu")
        dt = time.perf_counter() - t0
        mine = [knob_sweep.tree_digest(convert.state_to_numpy(
            pgs.index_trees(st_p, b))) for b in range(replicas)]
        gates = bf.gates(c_p, p_p, st_p, tick, horizon)
        match = mine == digests
        print(f"port (CPU) in {dt:.1f} s: gates {gates}; every replica's "
              f"digest equal to the reference's: {match}")
        ok = ok and match
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
    ap.add_argument("--churn", action="store_true")
    ap.add_argument("--telemetry", action="store_true")
    ap.add_argument("--knobs", action="store_true")
    ap.add_argument("--pipelined", action="store_true")
    ap.add_argument("--invariants", action="store_true")
    ap.add_argument("--tournament", action="store_true")
    ap.add_argument("--batched", action="store_true")
    ap.add_argument("--randomsub", action="store_true")
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--ticks", type=int, default=400)
    args = ap.parse_args()
    if args.churn:
        return churn_gates(args.n or 100_000)
    if args.telemetry:
        return telemetry_rows(args.n or 100_000, args.port)
    if args.knobs:
        return knob_rows(args.n or 100_000, args.port)
    if args.pipelined:
        return pipelined_rows(args.n or 100_000, args.port)
    if args.invariants:
        return invariants_rows(args.n or 100_000, args.port)
    if args.tournament:
        return tournament_rows(args.n or 20_000, args.port)
    if args.batched:
        return batched_rows(args.n or 100_000, args.port)
    if args.randomsub:
        return randomsub_rows(args.n or 10_000, args.port)
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
