"""Replica batching with per-replica data beyond the seed: the
reference's four heterogeneous SimKnobs points through
``gossip_run_knob_batch`` (its reach ``[B, M]`` too), a stack of fault
schedules (distinct fault seeds and churn victims, link loss and a shared
partition window), and invariant-armed replicas (the checker's ``[B]``
carry) — each against the reference's batched runner, leaf for leaf, and
against the port's sequential run of every replica.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch.models import faults as pfl
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import invariants as piv
from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as krecv
from test_torch_batch import ref, run_both  # noqa: F401  (fixture)
from test_torch_knobs import one_thread  # noqa: F401  (autouse)

#: the reference's tests/test_knobs.py shapes and points
N, T, M, C = 80, 2, 6, 8
POINTS = [{}, {"d": 4, "d_hi": 5},
          {"gossip_factor": 0.5, "d_lazy": 3},
          {"backoff_ticks": 4, "graylist_threshold": -60.0}]


def knob_cfg(gs):
    return gs.GossipSimConfig(
        offsets=gs.make_gossip_offsets(T, C, N, seed=1), n_topics=T, d=3,
        d_lo=2, d_hi=6, d_score=2, d_out=1, d_lazy=2, backoff_ticks=8)


def knob_specs(fl):
    subs = np.zeros((N, T), dtype=bool)
    subs[np.arange(N), np.arange(N) % T] = True
    rng = np.random.default_rng(0)
    topic = rng.integers(0, T, M)
    origin = rng.integers(0, N // T, M) * T + topic
    ticks = np.zeros(M, dtype=np.int32)
    return [dict(subs=subs, msg_topic=topic, msg_origin=origin,
                 msg_publish_tick=ticks, seed=7, sim_knobs=k)
            for k in POINTS]


def test_heterogeneous_knob_points_match_reference_and_sequential(ref):
    builds, final, reach, _ = run_both(
        ref, knob_cfg, knob_specs, 8, sc_kw={},
        honest=lambda b: np.ones((b, N), dtype=bool))
    assert reach.shape == (len(POINTS), M)
    for i, (p, _) in enumerate(builds):
        # the reach of each replica, from its own run's possession words
        seq = pgs.gossip_run(p, builds[i][1], 8,
                             pgs.make_gossip_step(knob_cfg(pgs),
                                                  pgs.ScoreSimConfig(),
                                                  device="cpu"),
                             device="cpu")
        assert torch.equal(reach[i], pgs.reach_counts_from_have(p, seq))
    # the points differ where they should: the degree point's meshes stay
    # at or under its d_hi, the defaults' do not all
    deg = pgs.mesh_degrees(final)
    assert int(deg[1].max()) <= 5 < int(deg[0].max())


def test_knob_vector_is_per_replica():
    """The knob operand of a stack is [B, K], row b replica b's point (no
    replica reads another's cached vector)."""
    cfg = knob_cfg(pgs)
    sc = pgs.ScoreSimConfig()
    builds = [pgs.make_gossip_sim(cfg, score_cfg=sc, device="cpu", **s)
              for s in knob_specs(None)]
    params = pgs.stack_trees([p for p, _ in builds])
    state = pgs.stack_trees([s for _, s in builds])
    seen = []
    orig = krecv.receive_update

    def spy(k, **ops):
        seen.append(ops["knobs"].clone())
        return orig(k, **ops)
    krecv.receive_update = spy
    try:
        step = pgs.make_gossip_step(cfg, sc, device="cpu")
        step(params, state)
        step(builds[3][0], builds[3][1])
    finally:
        krecv.receive_update = orig
    assert seen[0].shape == (4, krecv.KNOB_GSP + 1)
    assert seen[0][2, krecv.KNOB_GF] == 0.5
    assert seen[0][3, krecv.KNOB_BT] == 4 and seen[0][3, krecv.KNOB_GRAY] == -60
    assert torch.equal(seen[1], seen[0][3])


def fault_cfg(gs):
    return gs.GossipSimConfig(
        offsets=gs.make_gossip_offsets(2, 16, 240, seed=1), n_topics=2)


def fault_specs(fl, n=240, t=2, m=8, B=3):
    """The reference's tests/test_faults.py batch: distinct fault seeds
    and churn victims per replica, link loss, one partition window."""
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    rng = np.random.default_rng(0)
    topic = rng.integers(0, t, m)
    origin = rng.integers(0, n // t, m) * t + topic
    ticks = rng.integers(0, 10, m).astype(np.int32)
    grp = (np.arange(n) % 2).astype(np.int64)

    def sched(k):
        return fl.FaultSchedule(
            n_peers=n, horizon=60, seed=100 + k,
            down_intervals=[(10 + 2 * k, 5, 25)], drop_prob=0.05,
            partition_group=grp, partition_windows=[(12, 20)])
    return [dict(subs=subs, msg_topic=topic, msg_origin=origin,
                 msg_publish_tick=ticks, seed=k, fault_schedule=sched(k))
            for k in range(B)]


@pytest.mark.parametrize("scored", [False, True], ids=["unscored",
                                                        "scored"])
def test_fault_schedules_match_reference_and_sequential(ref, scored):
    _, final, _, _ = run_both(ref, fault_cfg, fault_specs, 60 if not scored
                              else 30, sc_kw={} if scored else None)
    # non-vacuous: the replicas' draws differ
    assert not torch.equal(final.mesh[0], final.mesh[1])


def test_fault_stack_keeps_per_replica_seeds():
    builds = [pgs.make_gossip_sim(fault_cfg(pgs), device="cpu", **s)
              for s in fault_specs(pfl)]
    params = pgs.stack_trees([p for p, _ in builds])
    assert params.faults.seed.tolist() == [100, 101, 102]
    assert params.faults.part_start == (12,)
    cfg = fault_cfg(pgs)
    masks = [pfl.tick_masks(p.faults, cfg.offsets, cfg.cinv, 15)
             for p, _ in builds]
    stacked = pfl.tick_masks(params.faults, cfg.offsets, cfg.cinv, 15)
    for b, m in enumerate(masks):
        for f in ("alive_w", "send_ok", "cand_alive", "flood_ok"):
            assert torch.equal(getattr(stacked, f)[b], getattr(m, f)), f
    assert not torch.equal(stacked.send_ok[0], stacked.send_ok[1])


def inv_cfg(gs):
    return gs.GossipSimConfig(
        offsets=gs.make_gossip_offsets(2, 16, 240, seed=1), n_topics=2)


def inv_specs(fl):
    out = []
    for seed in (0, 1):
        n, t, m = 240, 2, 8
        subs = np.zeros((n, t), dtype=bool)
        subs[np.arange(n), np.arange(n) % t] = True
        rng = np.random.default_rng(seed)
        topic = rng.integers(0, t, m)
        origin = rng.integers(0, n // t, m) * t + topic
        ticks = rng.integers(0, 10, m).astype(np.int32)
        out.append(dict(subs=subs, msg_topic=topic, msg_origin=origin,
                        msg_publish_tick=ticks, seed=seed))
    return out


def test_armed_replicas_match_reference_and_sequential(ref):
    _, final, _, _ = run_both(ref, inv_cfg, inv_specs, 15, sc_kw={},
                              arm=True)
    assert final.inv_viol.shape == (2,) and final.inv_first.shape == (2,)
    reports = piv.report_batch(final)
    assert [r["bits"] for r in reports] == [0, 0]


def test_armed_stack_records_a_defect_in_its_replica_only():
    """A forged mesh bit at an unsubscribed candidate in replica 1 trips
    mesh-subscription there at tick 0; replica 0 stays clean."""
    cfg = inv_cfg(pgs)
    sc = pgs.ScoreSimConfig()
    builds = [pgs.make_gossip_sim(cfg, score_cfg=sc, device="cpu", **s)
              for s in inv_specs(None)]
    params = pgs.stack_trees([p for p, _ in builds])
    state = pgs.stack_trees([piv.attach(s) for _, s in builds])
    unsub = ~params.cand_sub_bits[1, 0] & ((1 << 16) - 1)
    if int(unsub) == 0:
        params.cand_sub_bits[1, 0] &= ~1
        unsub = torch.tensor(1, dtype=torch.int32)
    state.mesh[1, 0] |= unsub & -unsub
    step = pgs.make_gossip_step(cfg, sc, device="cpu",
                                invariants=piv.InvariantConfig())
    out = step(params, state)[0]
    rep = piv.report_batch(out)
    assert rep[0]["bits"] == 0
    assert "mesh-subscription" in rep[1]["violations"]
    assert rep[1]["first_tick"] == 0
