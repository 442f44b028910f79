"""The port's telemetry frames under fault schedules, against the JAX
reference.

Each step case of ``test_torch_telemetry.py`` (the scored flagship
options, unscored, each attack, the full variant's options, paired topics
scored and unscored) runs under ``test_torch_faults``'s schedule (churn in
staggered waves, 5% symmetric link loss) with a partition of the ring's
two index halves over ticks [12, 18), attached to both packages' sims;
the scored case also with directed (per-direction) drops.  For 30 ticks
every state leaf and every frame field equals the reference's unpadded
XLA step's, the ``faults``
group (down peers; dropped edge-ticks, halved for undirected drops) too,
and the GRAFT and PRUNE counts are those transmitted (over a live link
toward a live partner).  Tolerance as there: exact but ``score_mean``.
"""

import pytest

from test_torch_telemetry import (
    CASES,
    check_histograms,
    check_live,
    ref,  # noqa: F401 (the module-scoped reference fixture)
    run_frames_pair,
)

#: the schedule of test_torch_faults (churn, link loss), its partition
#: between the index halves
PARTITION = dict(halves=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_faulted_step_frames_match_reference_30_ticks(ref, name):  # noqa: F811
    params, frames = run_frames_pair(
        ref, name, sched=PARTITION,
        lat_buckets=16 if "unscored" in name else 5)
    check_live(frames, name, faulted=True)
    check_histograms(params, frames)
    # the partition cuts more edges on each of its ticks than link loss
    # does on any tick after it
    drop = frames.dropped_edge_ticks
    assert bool((drop[12:18] > drop[18:].max()).all()), drop


def test_directed_drop_frames_match_reference_30_ticks(ref):  # noqa: F811
    """Directed drops count each down direction (a partition cut counts
    2), as the reference counts them."""
    params, frames = run_frames_pair(ref, "scored",
                                     sched=dict(directed=True, halves=True))
    check_live(frames, "scored", faulted=True)
    check_histograms(params, frames)
    drop = frames.dropped_edge_ticks
    assert bool((drop[12:18] > drop[18:].max()).all()), drop
