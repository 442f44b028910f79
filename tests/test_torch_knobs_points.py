"""Non-default knob points: the port's step against the JAX reference's XLA
step, every state leaf and the delivered words on every tick for 30
ticks, at the earlier slices' test shapes (``test_torch_knobs``' families
and helpers):

- every step family at its point (the reference's own non-default point,
  ``tests/test_knobs.py`` test_kernel_knob_parity_non_defaults, on the
  C = 8 shapes; a degree-family point on the C = 16 ones), each moving
  the trajectory;
- each of the attack tournament's ``DEFENSES`` on the IHAVE spam through
  ``sim_knobs`` and on the IWANT flood through the legacy ``score_knobs``;
- the P4 weight's rounding: at ``topic_weight`` 0.7 and a P4 weight of
  -10.9 (where the float32 product differs from the float32 rounding of
  the double product; at -13.3 the two agree) the knobbed scores are the
  float32 product, the baked ones the rounded double, both equal to the
  reference's bit for bit;
- the reference arming these tests use equals its make_gossip_sim.

Tolerance: exact (bitwise, f32/bf16 leaves by bit pattern).
"""

import dataclasses

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from test_torch_gossipsub import _assert_tree_equal
from test_torch_knobs import (  # noqa: F401  (ref: the module fixture)
    FAMILIES,
    IWANT_FLOOD,
    REF_POINT,
    _sim_inputs,
    arm_port,
    arm_ref,
    build_plain,
    family_point,
    one_thread,
    ref,
    run_pair,
    run_port,
    runs_differ,
)
import test_torch_faults as tfaults
from torch_ref import tree_to_numpy


# -- non-default points against the reference's XLA step --------------------

@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_point_matches_reference_30_ticks(ref, name):
    family = FAMILIES[name]
    ref_sim, port_sim = build_plain(ref, family)
    point = family_point(port_sim[0], port_sim[1] is not None)
    px = family[2]
    run = run_pair(ref, arm_ref(ref, ref_sim, sim_knobs=point, px=px),
                   arm_port(port_sim, sim_knobs=point, px=px))
    assert runs_differ(run, run_port(port_sim)), "the point moved nothing"


@pytest.mark.parametrize("defense", ["hardened", "reference", "tuned",
                                     "weak"])
def test_defense_points_match_reference_30_ticks(ref, defense):
    """Each tournament defense on the IHAVE-spam family through sim_knobs,
    and on the IWANT flood through the legacy score_knobs."""
    point = ref.tournament.DEFENSES[defense]
    for family, kw in ((FAMILIES["ihave_spam"], "sim_knobs"),
                       (IWANT_FLOOD, "score_knobs")):
        ref_sim, port_sim = build_plain(ref, family)
        run = run_pair(ref, arm_ref(ref, ref_sim, **{kw: point}),
                       arm_port(port_sim, **{kw: point}))
        if defense in ("hardened", "weak"):
            assert runs_differ(run, run_port(port_sim)), defense


def _rounding_sims(ref, **knob_kw):
    """A scored sim with topic_weight 0.7 and a P4 weight of -10.9 (whose
    f32 product differs from the f32 rounding of their double product),
    sybils forwarding invalid messages, built by both packages'
    make_gossip_sim."""
    n, t, m = 900, 4, 10
    offsets = ref.gs.make_gossip_offsets(t, 8, n, seed=3)
    cfg_kw = dict(tfaults.SMALL, offsets=offsets, n_topics=t)
    sc_kw = dict(topic_weight=0.7, invalid_message_deliveries_weight=-10.9)
    rng = np.random.default_rng(3)
    subs, topic, origin, ticks = _sim_inputs(n, t, m, seed=3)
    kw = dict(sybil=rng.random(n) < 0.2, msg_invalid=rng.random(m) < 0.4)
    sims = []
    for gs_mod, extra in ((ref.gs, {}), (pgs, {"device": "cpu"})):
        cfg = gs_mod.GossipSimConfig(**cfg_kw)
        sc = gs_mod.ScoreSimConfig(**sc_kw)
        sims.append((cfg, sc, *gs_mod.make_gossip_sim(
            cfg, subs, topic, origin, ticks, seed=3, score_cfg=sc,
            **kw, **knob_kw, **extra)))
    return sims


def test_p4_weight_rounds_as_a_float32_product(ref):
    """topic_weight 0.7 with a P4 weight of -10.9: the knob's c_inv is the
    f32 product, the baked one the f32 rounding of the double product.
    The port follows the reference's XLA step for 30 ticks either way, and
    its scores equal the reference's bit for bit on a state where P4 is
    live, the knobbed ones differing from the baked."""
    import jax.numpy as jnp

    assert (np.float32(0.7) * np.float32(-10.9)
            != np.float32(0.7 * -10.9))
    scores = {}
    for mode, kw in (("knobs", {"sim_knobs": {}}), ("baked", {})):
        ref_sim, port_sim = _rounding_sims(ref, **kw)
        run_pair(ref, ref_sim, port_sim)
        # the built state with every P4 counter at 1: the score is c_inv
        _, sc_r, p_r, s_r = ref_sim
        _, sc_p, p_p, s_p = port_sim
        s_r = s_r.replace(scores=s_r.scores.replace(
            invalid_deliveries=jnp.full_like(
                s_r.scores.invalid_deliveries, 1.0)))
        s_p = dataclasses.replace(s_p, scores=dataclasses.replace(
            s_p.scores, invalid_deliveries=torch.full_like(
                s_p.scores.invalid_deliveries, 1.0)))
        got = pgs.compute_scores(sc_p, p_p, s_p)
        want = np.asarray(ref.gs.compute_scores(sc_r, p_r, s_r))
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32), err_msg=mode)
        scores[mode] = got
    assert not torch.equal(scores["knobs"], scores["baked"])


def test_reference_arming_equals_its_build(ref):
    """The arming these tests give the reference (``arm_ref``) is what its
    make_gossip_sim does with the same point."""
    point = dict(REF_POINT, invalid_message_deliveries_weight=-20.0)
    built, _ = _rounding_sims(ref, sim_knobs=point)
    plain, _ = _rounding_sims(ref)
    armed = arm_ref(ref, plain, sim_knobs=point)
    _assert_tree_equal(tree_to_numpy(built[2]), tree_to_numpy(armed[2]),
                       "params")
    _assert_tree_equal(tree_to_numpy(built[3]), tree_to_numpy(armed[3]),
                       "state")


