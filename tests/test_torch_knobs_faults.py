"""Knobs under fault schedules, and the fault knob ``drop_prob``, against
the JAX reference (``test_torch_knobs``' families and helpers; the
schedule of ``test_torch_telemetry_faults``: ``test_torch_faults``' churn
waves and 5% link loss, with a partition of the index halves):

- knobs at the config's own values give the faulted baked trajectory leaf
  for leaf for 30 ticks on every faulted step family, with and without
  telemetry (frames too);
- each family's non-default point with the fault knob at another rate
  than the schedule's (``drop_prob`` 0.03 over a 0.05 schedule) against
  the reference's XLA step, every state leaf every tick for 30 ticks;
- ``drop_prob`` as a knob equals a schedule built at that rate (the
  reference's ``tests/test_knobs.py`` test_drop_prob_knob_matches_
  schedule_rate), and moves the trajectory.

Tolerance: exact (bitwise, f32/bf16 leaves by bit pattern; frames as
``test_torch_telemetry`` compares them).
"""

import dataclasses

import numpy as np
import pytest

from go_libp2p_pubsub_tpu_torch.models import faults as pfl
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import telemetry as ptl
import test_torch_faults as tfaults
from test_torch_knobs import (  # noqa: F401  (ref: the module fixture)
    FAMILIES,
    _cfgs,
    _sim_inputs,
    arm_port,
    arm_ref,
    assert_runs_equal,
    build_plain,
    family_point,
    one_thread,
    ref,
    run_pair,
    run_port,
    runs_differ,
)

#: the fault knob's override of the schedule's 5% link loss
DROP_KNOB = 0.03


def with_schedule(ref, built):
    """Both packages' sims with the same fault schedule attached, as
    make_gossip_sim attaches it: churn waves, 5% link loss, the index
    halves partitioned over ticks [12, 18)."""
    (cfg_r, sc_r, p_r, s_r), (cfg_p, sc_p, p_p, s_p) = built
    n = p_p.subscribed.shape[0]
    kw = tfaults._sched_kw(n)
    kw["partition_group"] = (np.arange(n) < n // 2).astype(np.int32)
    f_r, f_p = tfaults._schedules(ref, **kw)
    p_r = p_r.replace(faults=ref.faults.compile_faults(
        f_r, cfg_r.offsets, pack_links=True))
    p_p = dataclasses.replace(p_p, faults=pfl.compile_faults(
        f_p, cfg_p.offsets, device="cpu"))
    return (cfg_r, sc_r, p_r, s_r), (cfg_p, sc_p, p_p, s_p)


@pytest.mark.parametrize("telemetry", [False, True])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_faulted_default_knobs_equal_baked_30_ticks(ref, name, telemetry):
    family = FAMILIES[name]
    _, port = with_schedule(ref, build_plain(ref, family))
    armed = arm_port(port, sim_knobs={}, px=family[2])
    tcfg = (ptl.TelemetryConfig(latency_hist=True, degree_hist=True,
                                score_hist=True) if telemetry else None)
    assert_runs_equal(run_port(armed, telemetry=tcfg),
                      run_port(port, telemetry=tcfg), name)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_faulted_point_matches_reference_30_ticks(ref, name):
    family = FAMILIES[name]
    ref_sim, port_sim = with_schedule(ref, build_plain(ref, family))
    point = dict(family_point(port_sim[0], port_sim[1] is not None),
                 drop_prob=DROP_KNOB)
    px = family[2]
    armed = arm_port(port_sim, sim_knobs=point, px=px)
    assert float(armed[2].faults.drop_prob) == float(np.float32(DROP_KNOB))
    run = run_pair(ref, arm_ref(ref, ref_sim, sim_knobs=point, px=px),
                   armed)
    assert runs_differ(run, run_port(port_sim)), "the point moved nothing"


def test_drop_prob_knob_equals_a_schedule_at_that_rate(ref):
    """A 0.5 schedule with the knob at 0.1 steps as a 0.1 schedule with
    knobs at their defaults, 8 ticks; the knob at 0.5 does not."""
    n = 256
    cfg_r, cfg_p = _cfgs(ref)
    args = _sim_inputs(n)
    sc = pgs.ScoreSimConfig()

    def sim(rate, point):
        sched = pfl.FaultSchedule(n_peers=n, horizon=10, drop_prob=rate,
                                  seed=3)
        return (cfg_p, sc, *pgs.make_gossip_sim(
            cfg_p, *args, score_cfg=sc, fault_schedule=sched,
            sim_knobs=point, device="cpu"))

    knob = run_port(sim(0.5, {"drop_prob": 0.1}), ticks=8)
    assert_runs_equal(knob, run_port(sim(0.1, {}), ticks=8), "drop_prob")
    assert runs_differ(knob, run_port(sim(0.5, {}), ticks=8))
