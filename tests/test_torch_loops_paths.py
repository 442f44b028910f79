"""The receive loops beside the port's other paths: the invariant checker
armed on both forms (its carry equal to the reference's, tick by tick),
the loops against the port's own kernel path where the reference pins
the two equal, and the route itself against the reference's kernel
planner.
"""

import pytest

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import delays as pdl
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import invariants as piv
from go_libp2p_pubsub_tpu_torch.models import plan
from test_torch_gossipsub import _assert_tree_equal
from test_torch_knobs import one_thread  # noqa: F401  (autouse)
from test_torch_loops import ALL_ATTACKS, build, ref, run_pair  # noqa: F401
from test_torch_loops_split import P3

ARMED = {
    "combined": dict(byz=0.2, sc=dict(byzantine_mutation=True),
                     sched=dict(cold=True)),
    "split": dict(sc=dict(P3, byzantine_mutation=True), byz=0.2,
                  per_tick=True, m=60, sched={}),
}


@pytest.mark.parametrize("name", sorted(ARMED))
def test_armed_loops_match_reference_30_ticks(ref, name):
    """Every leaf, the checker's two scalars included, equals the
    reference's armed XLA step; a correct build sets no bit."""
    cfg, sc, params, end, _ = run_pair(ref, ARMED[name], invariants=True)
    assert plan.receive_path(cfg, sc, params) == name
    assert piv.report(end)["bits"] == 0 and int(end.inv_first) == -1


def _port_run(ref, case, ticks, *, force_split=False):
    """The port alone: its route and its states over ``ticks``
    heartbeats."""
    _, (cfg, sc, params, state) = build(ref, case)
    step = pgs.make_gossip_step(cfg, sc, device="cpu",
                                force_split=force_split)
    route = plan.receive_path(cfg, sc, params, force_split=force_split)
    out = []
    for _ in range(ticks):
        state = step(params, state)[0]
        out.append(convert.state_to_numpy(state))
    return route, out


def _assert_runs_equal(a, b, where, skip=()):
    for t, (sa, sb) in enumerate(zip(a, b)):
        _assert_tree_equal({k: v for k, v in sa.items() if k not in skip},
                           sb, f"{where} tick {t}")


def test_byzantine_with_no_mutator_equals_the_kernel_path(ref):
    """Byzantine compiled in with an all-false flag array runs the
    combined loops and equals the kernel path of the same config without
    the array (where mutation is not live), on every leaf."""
    kw = dict(sc=ALL_ATTACKS, sybil=0.2, invalid=0.3,
              zero_flags=("eclipse_sybil", "promise_break"))
    r_loops, loops = _port_run(ref, dict(
        kw, zero_flags=("byzantine", *kw["zero_flags"])), 30)
    r_kernel, kernel = _port_run(ref, kw, 30)
    assert (r_loops, r_kernel) == (plan.COMBINED, plan.KERNEL)
    _assert_runs_equal(kernel, loops, "loops vs kernel")


#: the two conditions where the reference pins its split loops to its
#: combined path (tests/test_gossipsub_sim.py): scored with lazy gossip
#: off (the two forms credit P2 alike), unscored with gossip
PINNED = {
    "scored_no_gossip": dict(c=8, cfg=dict(d_lazy=0, gossip_factor=0.0)),
    "unscored_gossip": dict(c=8, sc=None),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_force_split_equals_the_combined_trajectory(ref, name):
    """The split loops under ``force_split`` equal the kernel path and,
    scored, the combined loops (byzantine compiled in, no mutator), on
    every leaf for 30 ticks."""
    case = PINNED[name]
    r_split, split = _port_run(ref, case, 30, force_split=True)
    r_kernel, kernel = _port_run(ref, case, 30)
    assert (r_split, r_kernel) == (plan.SPLIT, plan.KERNEL)
    _assert_runs_equal(kernel, split, "split vs kernel")
    if case.get("sc", {}) is not None:
        r_comb, comb = _port_run(ref, dict(
            case, sc=dict(byzantine_mutation=True),
            zero_flags=("byzantine",)), 30)
        assert r_comb == plan.COMBINED
        # the byzantine toggle is part of the config the gates were
        # emitted under
        _assert_runs_equal(kernel, comb, "combined vs kernel",
                           skip=("gates_fp",))
    assert split[-1]["have"].any()


#: (case, whether the reference's kernel planner takes it); the port's
#: route must be "kernel" exactly there
ROUTES = {
    "scored": (dict(), True),
    "unscored": (dict(sc=None), True),
    "c8": (dict(c=8), True),
    # C = 12 is the kernel's by the ladder; B1 then refuses its shape
    "c12": (dict(c=12, cfg=dict(d=4, d_lo=3, d_hi=8, d_score=2)), True),
    "byzantine": (dict(byz=0.2, sc=dict(byzantine_mutation=True)), False),
    "byzantine_no_flags": (dict(sc=dict(byzantine_mutation=True)), True),
    "byzantine_flags_off": (dict(sc=dict(), zero_flags=("byzantine",)),
                            True),
    "p3": (dict(sc=P3), False),
    "c24": (dict(c=24), False),
    "c24_unscored": (dict(c=24, sc=None), False),
    "c32": (dict(c=32), False),
    "iwant_flood_sim_knobs": (dict(sybil=0.2, sc=dict(sybil_iwant_spam=True),
                                   knobs={}), False),
    "iwant_flood": (dict(sybil=0.2, sc=dict(sybil_iwant_spam=True)), True),
    "sim_knobs": (dict(knobs=dict(d=5, d_lo=4)), True),
    "faults": (dict(sched=dict(cold=True)), True),
    "tournament_cell": (dict(byz=0.2, sc=ALL_ATTACKS, knobs={},
                             sched=dict(cold=True),
                             zero_flags=("sybil", "eclipse_sybil")), False),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_is_kernel_where_the_reference_plans_the_kernel(ref, name):
    case, kernel = ROUTES[name]
    (cfg_r, sc_r, _, _), (cfg, sc, params, state) = build(ref, case)
    # the reference's planner judges its padded (kernel-layout) sim
    sims_r = _padded_reference_sim(ref, case)
    verdict = ref.gs._plan.plan_kernel_step(cfg_r, sc_r, *sims_r)
    assert isinstance(verdict, ref.gs._plan.ExecutionPlan) == kernel
    route = plan.receive_path(cfg, sc, params)
    assert (route == plan.KERNEL) == kernel
    if name == "c12":
        with pytest.raises(plan.SliceRefusal) as err:
            pgs.make_gossip_step(cfg, sc, device="cpu")(params, state)
        assert err.value.name == "kernel_shape"
    elif route != plan.KERNEL:
        # the loops run it
        assert pgs.make_gossip_step(cfg, sc, device="cpu")(
            params, state)[0].tick == 1


def _padded_reference_sim(ref, case):
    """The reference's sim of ``case`` built with ``pad_to_block``."""
    orig = ref.gs.make_gossip_sim

    def padded(*args, **kw):
        return orig(*args, pad_to_block=256, **kw)
    ref.gs.make_gossip_sim = padded
    try:
        (_, _, p_r, s_r), _ = build(ref, case)
    finally:
        ref.gs.make_gossip_sim = orig
    return p_r, s_r


def test_loops_refuse_telemetry_and_delays_by_name(ref):
    from go_libp2p_pubsub_tpu_torch.models import telemetry as ptl
    _, (cfg, sc, params, state) = build(
        ref, dict(byz=0.2, sc=dict(byzantine_mutation=True)))
    assert plan.receive_path(cfg, sc, params) == plan.COMBINED
    with pytest.raises(plan.SliceRefusal) as err:
        pgs.make_gossip_step(cfg, sc, device="cpu",
                             telemetry=ptl.TelemetryConfig())(params, state)
    assert err.value.name == "loops_telemetry"
    params, state = pgs.arm_delays(sc, params, state, pdl.DelayConfig())
    with pytest.raises(plan.SliceRefusal) as err:
        pgs.make_gossip_step(cfg, sc, device="cpu")(params, state)
    assert err.value.name == "loops_delays"
