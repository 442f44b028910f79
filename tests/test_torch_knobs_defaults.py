"""Knobs at the config's own values (``sim_knobs={}``, and the legacy
``score_knobs={}`` on the IWANT flood, where a SimKnobs point is refused)
give the baked trajectory leaf for leaf: every state leaf, the delivered
words and, with telemetry (every group, all three histograms), every
frame field, on every tick for 30 ticks, on every step family of
``test_torch_knobs`` (the flagship options, unscored, the IHAVE spam,
graft flood, promise breakers, eclipse, the full variant and paired
topics without the IWANT flood, paired unscored) and the IWANT flood.
The faulted families are in ``test_torch_knobs_faults.py``.

Tolerance: exact (frames as ``test_torch_telemetry`` compares them).
"""

import pytest

from go_libp2p_pubsub_tpu_torch.models import telemetry as ptl
from test_torch_knobs import (  # noqa: F401  (ref: the module fixture)
    FAMILIES,
    IWANT_FLOOD,
    arm_port,
    assert_runs_equal,
    build_plain,
    one_thread,
    ref,
    run_port,
)


@pytest.mark.parametrize("telemetry", [False, True])
@pytest.mark.parametrize("name", sorted(FAMILIES) + ["iwant_flood"])
def test_default_knobs_equal_baked_30_ticks(ref, name, telemetry):
    family = IWANT_FLOOD if name == "iwant_flood" else FAMILIES[name]
    _, port = build_plain(ref, family)
    surface_kw = ({"score_knobs": {}} if name == "iwant_flood"
                  else {"sim_knobs": {}})
    armed = arm_port(port, px=family[2], **surface_kw)
    assert (armed[2].sim_knobs is not None
            or armed[2].score_knobs is not None)
    tcfg = (ptl.TelemetryConfig(latency_hist=True, degree_hist=True,
                                score_hist=True) if telemetry else None)
    assert_runs_equal(run_port(armed, telemetry=tcfg),
                      run_port(port, telemetry=tcfg), name)
