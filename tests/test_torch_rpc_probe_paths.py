"""The port's RPC probe on the step's other paths, against the JAX
reference's (``probe_pair`` of ``test_torch_rpc_probe.py``, 6 ticks):

- faulted families with telemetry (the frame before the snapshot), a
  knob point and the invariant checker together (scored, unscored, the
  IHAVE spam, the full variant, paired);
- the receive loops (byzantine clean and faulted, P3 on the split loops,
  C = 24, ``force_split`` unscored): the same prologue values;
- delays (``delays_probe=True``: the probe line, the snapshot's
  ``arr_*`` arrival masks; scored, unscored, IHAVE spam, eclipse, the
  full variant, faulted, faulted with the delayed telemetry counters),
  the delayed step without the probe line raising the reference's error,
  and ``convert`` carrying the probe line both ways.

Tolerance: exact (words, bools and counters bitwise; frames as
``test_torch_telemetry`` compares them).
"""

import pytest
import torch

import test_torch_faults as tfaults
import test_torch_loops as loops
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import plan
from test_torch_delays_steps import _full, delayed
from test_torch_knobs import (  # noqa: F401  (one_thread: autouse)
    FAMILIES,
    arm_port,
    arm_ref,
    build_plain,
    family_point,
    one_thread,
)
from test_torch_knobs_faults import with_schedule
from test_torch_loops_split import P3
from test_torch_rpc_probe import DELAYS, TEL, probe_pair, ref  # noqa: F401


#: (family, knobs armed): faulted, with telemetry and the checker too
OPTION_CASES = {
    "scored": ("scored", True),
    "unscored": ("unscored", True),
    "ihave_spam": ("ihave_spam", True),
    "full": ("full", True),
    "paired": ("paired", True),
}


@pytest.mark.parametrize("name", sorted(OPTION_CASES))
def test_probe_with_telemetry_knobs_and_invariants(ref, name):
    fam, knobs = OPTION_CASES[name]
    family = FAMILIES[fam]
    ref_sim, port_sim = with_schedule(ref, build_plain(ref, family))
    if knobs:
        point = family_point(port_sim[0], port_sim[1] is not None)
        ref_sim = arm_ref(ref, ref_sim, sim_knobs=point, px=family[2])
        port_sim = arm_port(port_sim, sim_knobs=point, px=family[2])
    probe_pair(ref, ref_sim, port_sim, telemetry=TEL, invariants=True)


# -- the receive loops --------------------------------------------------------

LOOP_CASES = {
    "byzantine": (loops.COMBINED["byzantine"], False),
    "byzantine_faults": (dict(loops.COMBINED["byzantine"], sched={}),
                         False),
    "p3": (dict(sc=P3, per_tick=True), False),
    "c24": (dict(c=24), False),
    "force_split_unscored": (dict(sc=None), True),
}


@pytest.mark.parametrize("name", sorted(LOOP_CASES))
def test_probe_on_the_receive_loops(ref, name):
    case, split = LOOP_CASES[name]
    ref_sim, port_sim = loops.build(ref, case)
    route = plan.receive_path(port_sim[0], port_sim[1], port_sim[2],
                              force_split=split)
    assert route != plan.KERNEL
    probe_pair(ref, ref_sim, port_sim, force_split=split)


# -- delays: the probe line ---------------------------------------------------

DELAYED = {
    "scored": (lambda ref: tfaults._build(ref, "scored", faults=False), None),
    "unscored": (lambda ref: tfaults._build(ref, "unscored", faults=False),
                 None),
    "ihave_spam": (lambda ref: build_plain(ref, FAMILIES["ihave_spam"]),
                   None),
    "eclipse": (lambda ref: build_plain(ref, FAMILIES["eclipse"]), None),
    "full": (_full, None),
    "faults": (lambda ref: tfaults._build(ref, "scored"), None),
    "counters_faults": (lambda ref: tfaults._build(ref, "scored"), TEL),
}


@pytest.mark.parametrize("name", sorted(DELAYED))
def test_delayed_probe_matches_reference(ref, name):
    build, tel = DELAYED[name]
    extra = dict(delays_probe=True)
    if tel is not None:
        extra["delays_counters"] = True
    with delayed(ref, DELAYS, **extra):
        ref_sim, port_sim = build(ref)
    assert port_sim[3].probe_line.shape == (DELAYS["k_slots"], 3,
                                            port_sim[2].subscribed.shape[0])
    snap = probe_pair(ref, ref_sim, port_sim, telemetry=tel)
    assert {"arr_fwd", "arr_ihave", "arr_flood", "arr_graft",
            "arr_prune"} <= set(snap)
    assert snap["arr_fwd"].any()


def test_delayed_probe_needs_the_probe_line(ref):
    """A delay-armed sim built without ``delays_probe`` refuses the probe
    step with the reference's message; without the probe the line is
    carried unread."""
    with delayed(ref, DELAYS):
        (cfg_r, sc_r, p_r, s_r), (cfg_p, sc_p, p_p, s_p) = tfaults._build(
            ref, "scored", faults=False)
    msgs = []
    for fn in (lambda: ref.gs.make_gossip_step(cfg_r, sc_r, rpc_probe=True)(
                   p_r, s_r),
               lambda: pgs.make_gossip_step(cfg_p, sc_p, device="cpu",
                                            rpc_probe=True)(p_p, s_p)):
        with pytest.raises(ValueError) as err:
            fn()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == plan.MSG_DELAYS_NEED_PROBE_LINE
    with delayed(ref, DELAYS, delays_probe=True):
        _, (cfg_p, sc_p, p_p, s_p) = tfaults._build(ref, "scored",
                                                     faults=False)
    s2 = pgs.make_gossip_step(cfg_p, sc_p, device="cpu")(p_p, s_p)[0]
    assert s2.probe_line is s_p.probe_line


def test_convert_carries_the_probe_line(ref):
    """``convert`` brings the reference's delay-armed state with its probe
    line across and back, the line's words intact after a few probe
    ticks."""
    import jax

    from go_libp2p_pubsub_tpu_torch import convert
    from test_torch_gossipsub import _assert_tree_equal
    from torch_ref import tree_to_numpy

    with delayed(ref, DELAYS, delays_probe=True):
        (cfg_r, sc_r, p_r, s_r), (_, sc_p, _, _) = tfaults._build(
            ref, "scored", faults=False)
    step = jax.jit(ref.gs.make_gossip_step(cfg_r, sc_r, rpc_probe=True))
    for _ in range(5):
        s_r = step(p_r, s_r)[0]
    want = tree_to_numpy(s_r)
    assert want["probe_line"].any()
    got = convert.state_from_numpy(want, sc_p, "cpu")
    assert got.probe_line.dtype == torch.int32
    _assert_tree_equal(want, convert.state_to_numpy(got), "round trip")
