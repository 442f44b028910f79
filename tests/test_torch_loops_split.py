"""The port's per-edge receive loops, split form, with P3/P3b against the
JAX reference's unpadded XLA step: the P3 configuration of the
reference's ``test_gossipsub_v11_sim.py`` (one message a tick) alone,
under a fault schedule and beside byzantine mutators, for 60 ticks, so
that edges activate, run a deficit and are pruned with it.  Alone, it
grafts opportunistically every 7 ticks: at 1,024 peers its meshes
otherwise settle and prune no active edge within 60 ticks.

Every state leaf (``mesh_deliveries`` and ``mesh_failure_penalty``
among them) and the delivered words equal the reference's on every
tick.  Tolerance: exact (bf16 leaves compared by bit pattern).
"""

import pytest

from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import plan
from go_libp2p_pubsub_tpu_torch.ops import graph
from test_torch_knobs import one_thread  # noqa: F401  (autouse)
from test_torch_loops import assert_rejection, ref, run_pair  # noqa: F401

#: the reference's P3 configuration (test_gossipsub_v11_sim.py)
P3 = dict(mesh_message_deliveries_weight=-1.0,
          mesh_failure_penalty_weight=-1.0,
          mesh_message_deliveries_threshold=0.5)

SPLIT = {
    "p3": dict(sc=dict(P3, opportunistic_graft_ticks=7), per_tick=True,
               m=60),
    "p3_faults": dict(sc=P3, per_tick=True, m=60, sched={}),
    "p3_byzantine": dict(sc=dict(P3, byzantine_mutation=True), byz=0.2,
                         per_tick=True, m=60),
}


@pytest.mark.parametrize("name", sorted(SPLIT))
def test_p3_split_loops_match_reference_60_ticks(ref, name):
    case = SPLIT[name]
    cfg, sc, params, end, states = run_pair(ref, case, ticks=60)
    assert sc.track_p3
    assert plan.receive_path(cfg, sc, params) == plan.SPLIT
    assert int(pgs.mesh_degrees(end).max()) >= cfg.d
    # P3 credited mesh deliveries, and some edge was pruned while active
    # with a deficit (the sticky P3b penalty)
    in_mesh = graph.expand_bits(end.mesh, cfg.n_candidates)
    assert float(end.scores.mesh_deliveries.float()[in_mesh].max()) > 0
    assert max(float(s.scores.mesh_failure_penalty.float().max())
               for s in states) > 0
    # P3 costs score: the terms lower some edge's score
    plain = pgs.ScoreSimConfig(byzantine_mutation=sc.byzantine_mutation)
    assert bool((pgs.compute_scores(sc, params, end)
                 < pgs.compute_scores(plain, params, end)).any())
    if params.cand_byz is not None:
        assert_rejection(cfg, params, states, True)
