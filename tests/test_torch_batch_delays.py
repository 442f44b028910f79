"""Replica batching of delay-armed sims: a stack of B sims whose K-slot
delay lines are ``[B, K, ...]`` advances on ONE step a tick, B1 launched
once in its delay mode for the stack, against the JAX reference's vmapped
runners and against the port's sequential runs.

- the reference's own case (its ``tests/test_delays.py``
  ``test_delay_knobs_no_retrace_and_batched_matches_sequential``: 80
  peers, C = 8, ``DelayConfig(1, 0, 6)``, three delay-knob points through
  ``gossip_run_knob_batch``): leaf for leaf the reference's batched run,
  each replica the port's and the reference's sequential run;
- delayed stacks at 240 peers, C = 16, ``DelayConfig(3, 2, 8)`` with a
  delay seed a replica, the checker armed: scored, unscored and the IHAVE
  spam (the broken-promise line), each under fault schedules (distinct
  fault seeds and churn a replica) at knob points (each replica its own
  ``delay_base`` / ``delay_jitter``; the reference's case above and the
  telemetry tests' delayed stack run without them), leaf for leaf the
  reference's ``gossip_run_batch`` and the port's sequential runs, shown
  non-vacuous (the lines carried traffic, the replicas differ);
- the plain B1 in delay mode with a replica axis against one call a
  replica (every family ± knobs, C = 16 and C = 8 at an odd N);
- a stack of ``DelayParams`` whose ``k_slots`` differ raises a
  ``ValueError`` naming the field.

Tolerance: exact (packed words and integer counters bitwise, f32/bf16
leaves by bit pattern).
"""

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import _batch
from go_libp2p_pubsub_tpu_torch.models import delays as pdl
from go_libp2p_pubsub_tpu_torch.models import faults as pfl
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as krecv
from test_torch_batch import STACK_VARIANTS, run_both, stack_case
from test_torch_batch_knobs import fault_cfg
from test_torch_gossipsub import _assert_tree_equal
from test_torch_knobs import one_thread  # noqa: F401  (autouse)
from torch_ref import imported_reference, tree_to_numpy


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.delays as rdl
        import go_libp2p_pubsub_tpu.models.faults as rfl
        import go_libp2p_pubsub_tpu.models.invariants as riv
        r.delays, r.faults, r.invariants = rdl, rfl, riv
        yield r


# -- the reference's own case --------------------------------------------------

#: the reference's tests/test_delays.py shapes, config and points
N, T, M, C = 80, 2, 6, 8
POINTS = [{"delay_base": 1}, {"delay_base": 3, "delay_jitter": 2},
          {"delay_base": 5, "delay_jitter": 1}]


def test_reference_delay_knob_stack_matches_reference_and_sequential(ref):
    subs = np.zeros((N, T), dtype=bool)
    subs[np.arange(N), np.arange(N) % T] = True
    rng = np.random.default_rng(0)
    topic = rng.integers(0, T, M)
    origin = rng.integers(0, N // T, M) * T + topic
    tks = np.zeros(M, dtype=np.int32)
    out = {}
    for side, gs, dl, kw in (("ref", ref.gs, ref.delays, {}),
                             ("port", pgs, pdl, {"device": "cpu"})):
        cfg = gs.GossipSimConfig(
            offsets=gs.make_gossip_offsets(T, C, N, seed=1), n_topics=T,
            d=3, d_lo=2, d_hi=6, d_score=2, d_out=1, d_lazy=2,
            backoff_ticks=8)
        sc = gs.ScoreSimConfig()
        builds = [gs.make_gossip_sim(cfg, subs, topic, origin, tks,
                                     score_cfg=sc, sim_knobs=p,
                                     delays=dl.DelayConfig(1, 0, 6), **kw)
                  for p in POINTS]
        step = gs.make_gossip_step(cfg, sc, **kw)
        seq = [gs.gossip_run(p, gs.tree_copy(s), 10, step, **kw)
               for p, s in builds]
        pB = gs.stack_trees([b[0] for b in builds])
        sB = gs.stack_trees([b[1] for b in builds])
        out[side] = (seq, *gs.gossip_run_knob_batch(pB, sB, 10, step, **kw))
    seq_r, fin_r, reach_r = out["ref"]
    seq_p, fin_p, reach_p = out["port"]
    _assert_tree_equal(tree_to_numpy(fin_r), convert.state_to_numpy(fin_p),
                       "stack")
    np.testing.assert_array_equal(reach_p.numpy(), np.asarray(reach_r))
    assert reach_p.shape == (len(POINTS), M)
    for i in range(len(POINTS)):
        one = convert.state_to_numpy(_batch.index_trees(fin_p, i))
        _assert_tree_equal(convert.state_to_numpy(seq_p[i]), one,
                           f"replica {i} vs the port alone")
        _assert_tree_equal(tree_to_numpy(seq_r[i]), one,
                           f"replica {i} vs the reference alone")
    # the points differ: a longer hop delivers later
    assert not torch.equal(fin_p.have[0], fin_p.have[2])


# -- delayed stacks: families, faults, knobs, the checker ----------------------

DELAY_KW = dict(base=3, jitter=2, k_slots=8)
#: family: (score keywords or None, sybils, fault schedules, delay knobs)
FAMILIES = {
    "scored_faults_knobs": ({}, False, True, True),
    "unscored_faults_knobs": (None, False, True, True),
    "ihave_spam_faults_knobs": (dict(sybil_ihave_spam=True), True, True,
                                True),
}


def delay_specs(ref, family, n=240, t=2, m=8, B=3):
    """Each package's replica keywords: the fault tests' rings and
    messages, a delay line with its own seed a replica and, per family,
    sybils (a fifth of the peers, drawn a replica), a fault schedule and a
    delay-knob point a replica."""
    _, sybils, faults, knobs = FAMILIES[family]
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    rng = np.random.default_rng(0)
    topic = rng.integers(0, t, m)
    origin = rng.integers(0, n // t, m) * t + topic
    ticks = rng.integers(0, 10, m).astype(np.int32)
    grp = (np.arange(n) % 2).astype(np.int64)

    def specs(fl):
        dl = pdl if fl is pfl else ref.delays
        out = []
        for b in range(B):
            spec = dict(subs=subs, msg_topic=topic, msg_origin=origin,
                        msg_publish_tick=ticks, seed=b,
                        delays=dl.DelayConfig(**DELAY_KW, seed=11 + b))
            if sybils:
                spec["sybil"] = np.random.default_rng(50 + b).random(n) < 0.2
            if faults:
                spec["fault_schedule"] = fl.FaultSchedule(
                    n_peers=n, horizon=60, seed=100 + b,
                    down_intervals=[(10 + 2 * b, 5, 25)], drop_prob=0.05,
                    partition_group=grp, partition_windows=[(12, 20)])
            if knobs:
                spec["sim_knobs"] = {"delay_base": 1 + 2 * b,
                                     "delay_jitter": (b + 1) % 3}
            out.append(spec)
        return out
    return specs


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_delayed_stack_matches_reference_and_sequential(ref, family):
    sc_kw = FAMILIES[family][0]
    builds, final, _, _ = run_both(ref, fault_cfg,
                                   delay_specs(ref, family), 12,
                                   sc_kw=sc_kw, arm=True)
    # non-vacuous: the lines carry traffic, the replicas differ, and no
    # checker bit fired
    assert int(final.pay_line.ne(0).sum()) > 0
    assert not torch.equal(final.pay_line[0], final.pay_line[1])
    assert not torch.equal(final.mesh[0], final.mesh[1])
    assert (final.inv_viol == 0).all()
    if sc_kw:
        assert final.ctrl_line.shape[2] == 4   # the broken-promise row
    params = pgs.stack_trees([p for p, _ in builds])
    assert params.delays.seed.tolist() == [11, 12, 13]


# -- the plain B1 in delay mode with a replica axis ---------------------------


@pytest.mark.parametrize("name", sorted(n for n in STACK_VARIANTS
                                        if "delays" in n))
@pytest.mark.parametrize("c,n", [(16, 50), (8, 37)])
def test_plain_delayed_receive_takes_a_replica_axis(name, c, n):
    k, reps, stacked = stack_case(name, n, c, 10)
    assert k.delays and krecv.library(k, stacked=True) == \
        "receive_delays_reps"
    got = krecv.receive_update(k, **stacked)
    for b, r in enumerate(reps):
        one = krecv.receive_update_plain(k, **r)
        assert len(one) == len(got)
        for i, (x, y) in enumerate(zip(got, one)):
            assert x.shape == (3, *y.shape), (b, i)
            assert torch.equal(x[b], y), (name, b, i)


# -- the named error ------------------------------------------------------------


def test_stacked_delay_params_must_share_k_slots():
    cfg = fault_cfg(pgs)
    specs = delay_specs(None, "scored_faults_knobs")(pfl)
    sims = [pgs.make_gossip_sim(cfg, device="cpu", **dict(
        s, delays=pdl.DelayConfig(3, 2, 8 + i), sim_knobs=None))
        for i, s in enumerate(specs[:2])]
    with pytest.raises(ValueError, match="k_slots") as e:
        pgs.stack_trees([p for p, _ in sims])
    assert "delays.k_slots" in str(e.value)
    with pytest.raises(ValueError, match="pay_line"):
        pgs.stack_trees([s for _, s in sims])
