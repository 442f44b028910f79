"""The armed step with telemetry and with knobs against the JAX reference
(``test_torch_invariants_steps``' helper and families):

- with every telemetry group on (all three histograms), each family clean
  and under the faults schedule: every state leaf, the carry, the
  delivered words and every frame field equal the reference's armed XLA
  step for 30 ticks, and the port's step with the checker off (the frame
  is returned as without the checker);
- at each family's non-default knob point (``test_torch_knobs``'
  ``family_point``; the IWANT flood at the hardened defense through
  ``score_knobs``), clean, and the flagship, full and paired families also
  under the schedule with the fault knob.

Tolerance: exact (bitwise; frames as ``test_torch_telemetry`` compares
them).
"""

import pytest

from test_torch_invariants_steps import (  # noqa: F401  (ref: fixture)
    ALL_FAMILIES,
    CLEAN,
    FIRES,
    one_thread,
    ref,
    run_checked,
)
from test_torch_knobs import (
    arm_port,
    arm_ref,
    build_plain,
    family_point,
)
from test_torch_knobs_faults import DROP_KNOB, with_schedule

TEL_ALL = dict(latency_hist=True, degree_hist=True, score_hist=True,
               latency_buckets=16)
TEL_FAMILIES = ("scored", "unscored", "both_spam", "full", "paired",
                "paired_unscored")


@pytest.mark.parametrize("faulted", [False, True])
@pytest.mark.parametrize("name", TEL_FAMILIES)
def test_armed_telemetry_step_matches_reference_30_ticks(ref, name, faulted):
    sims = build_plain(ref, ALL_FAMILIES[name])
    if faulted:
        sims = with_schedule(ref, sims)
    assert run_checked(ref, *sims, tel_kw=TEL_ALL) == CLEAN


def _armed_at_point(ref, name, faulted):
    family = ALL_FAMILIES[name]
    ref_sim, port_sim = build_plain(ref, family)
    if faulted:
        ref_sim, port_sim = with_schedule(ref, (ref_sim, port_sim))
    if name == "both_spam":
        # a SimKnobs point on the IWANT flood is refused: the legacy surface
        point = ref.tournament.DEFENSES["hardened"]
        return (arm_ref(ref, ref_sim, score_knobs=point),
                arm_port(port_sim, score_knobs=point))
    point = family_point(port_sim[0], port_sim[1] is not None)
    if faulted:
        point = dict(point, drop_prob=DROP_KNOB)
    px = family[2]
    return (arm_ref(ref, ref_sim, sim_knobs=point, px=px),
            arm_port(port_sim, sim_knobs=point, px=px))


KNOB_CASES = [(name, False) for name in sorted(ALL_FAMILIES)] + [
    (name, True) for name in ("scored", "full", "paired")]


@pytest.mark.parametrize("name,faulted", KNOB_CASES)
def test_armed_knob_step_matches_reference_30_ticks(ref, name, faulted):
    sims = _armed_at_point(ref, name, faulted)
    assert sims[1][2].sim_knobs is not None or sims[1][2].score_knobs \
        is not None
    assert run_checked(ref, *sims) == FIRES.get(name, CLEAN)
