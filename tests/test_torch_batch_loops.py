"""Replica batching on the per-edge receive loops (the receive half the
reference's kernel planner leaves to XLA): the combined form with
byzantine payload mutation, both gossip-repair attacks and a SimKnobs
point per replica, under cold-restart churn; the split form by
``force_split`` and by P3/P3b — at C = 16, each stack against the
reference's ``gossip_run_batch`` leaf for leaf and against the port's
sequential run of every replica.  Per replica the flag arrays, knob
points, fault seeds and mesh seeds differ.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import plan
from test_torch_batch import ref, run_both  # noqa: F401  (fixture)
from test_torch_knobs import one_thread  # noqa: F401  (autouse)

N, T, M = 512, 4, 16


def make_cfg(gs):
    return gs.GossipSimConfig(offsets=gs.make_gossip_offsets(T, 16, N,
                                                             seed=2),
                              n_topics=T)


def specs_for(case):
    """Three replicas' keywords: their own seeds, flags and knob points
    (the formations' arrays drawn per replica)."""
    def specs(fl):
        out = []
        subs = np.zeros((N, T), dtype=bool)
        subs[np.arange(N), np.arange(N) % T] = True
        for r in range(3):
            rng = np.random.default_rng(40 + r)
            kw = {}
            pool = np.ones(N, dtype=bool)
            if case.get("byz"):
                kw["byzantine"] = rng.random(N) < 0.1
                kw["sybil"] = rng.random(N) < 0.1
                pool &= ~kw["byzantine"] & ~kw["sybil"]
                kw["sim_knobs"] = {"gossip_retransmission": 1 + r,
                                   "behaviour_penalty_weight": -5.0 * r}
            if case.get("cold"):
                victims = np.flatnonzero(rng.random(N) < 0.1)
                kw["fault_schedule"] = fl.FaultSchedule(
                    n_peers=N, horizon=40, seed=9 + r, cold_restart=True,
                    down_intervals=[(int(p), 3 + int(p % 3), 9 + int(p % 3))
                                    for p in victims])
            ids = np.flatnonzero(pool)
            origin = ids[rng.integers(0, len(ids), M)]
            ticks = np.sort(rng.integers(0, 12, M)).astype(np.int32)
            out.append(dict(subs=subs, msg_topic=origin % T,
                            msg_origin=origin, msg_publish_tick=ticks,
                            seed=r, **kw))
        # (every replica's interval table the same width)
        if case.get("cold"):
            k = max(s["fault_schedule"].max_down_intervals for s in out)
            assert all(s["fault_schedule"].max_down_intervals == k
                       for s in out)
        return out
    return specs


CASES = {
    "combined_byzantine": (dict(byz=True), dict(
        byzantine_mutation=True, sybil_ihave_spam=True,
        sybil_iwant_spam=True), {}, plan.COMBINED),
    "split_forced": ({}, {}, dict(force_split=True), plan.SPLIT),
    "split_p3": ({}, dict(mesh_message_deliveries_weight=-1.0,
                          mesh_failure_penalty_weight=-1.0), {},
                 plan.SPLIT),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loops_stack_matches_reference_and_sequential(ref, name):
    case, sc_kw, step_kw, route = CASES[name]
    builds, final, _, _ = run_both(ref, make_cfg, specs_for(case), 20,
                                   sc_kw=sc_kw, step_kw=step_kw)
    cfg = make_cfg(pgs)
    assert plan.receive_path(cfg, pgs.ScoreSimConfig(**sc_kw),
                             builds[0][0], **step_kw) == route
    assert not torch.equal(final.mesh[0], final.mesh[1])
    if case.get("byz"):
        # mutated copies were rejected and charged to P4
        assert float(final.scores.invalid_deliveries.float().max()) > 0


def test_combined_loops_stack_with_cold_restart(ref):
    case = dict(byz=True, cold=True)
    sc_kw = dict(byzantine_mutation=True, sybil_ihave_spam=True,
                 sybil_iwant_spam=True)
    _, final, _, _ = run_both(ref, make_cfg, specs_for(case), 20,
                              sc_kw=sc_kw)
    assert not torch.equal(final.have[0], final.have[1])
