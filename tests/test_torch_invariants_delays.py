"""The armed delayed step against the JAX reference: each case of
``test_torch_delays_steps`` (scored, unscored, the attack formations, the
full variant's options, fault schedules with and without cold restart and
per-direction drops, ``delays_counters`` telemetry and the latency
histogram alone; ``DelayConfig(3, 2, 8)``) armed and stepped 30 ticks by
``make_gossip_step(..., invariants=InvariantConfig())``: every state leaf
(the delay lines and the carry too), the delivered words (from the
dequeued arrivals) and the frames equal the reference's armed XLA step on
every tick, and the port's step with the checker off; the reports equal
the reference's.  The attack cases with fanout-only attackers report the
reference's mesh-subscription bit (``test_torch_invariants_steps.FIRES``).

Tolerance: exact (bitwise; frames as ``test_torch_telemetry`` compares
them).
"""

import pytest

from test_torch_delays_steps import CASES, DELAYS, delayed
from test_torch_invariants_steps import (  # noqa: F401  (ref: fixture)
    CLEAN,
    FIRES,
    one_thread,
    ref,
    run_checked,
)


@pytest.mark.parametrize("name", sorted(CASES))
def test_armed_delayed_step_matches_reference_30_ticks(ref, name):
    build, tel_kw = CASES[name]
    counters = tel_kw is not None and tel_kw.get("counters", True)
    with delayed(ref, DELAYS, **({"delays_counters": True}
                                 if counters else {})):
        ref_sim, port_sim = build(ref)
    assert port_sim[2].delays is not None
    assert run_checked(ref, ref_sim, port_sim, tel_kw=tel_kw) == \
        FIRES.get(name, CLEAN)
