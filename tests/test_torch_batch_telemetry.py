"""Telemetry over a replica stack: ``telemetry_run_batch`` advances B
stacked sims on ONE telemetry step a tick (B1 launched once with its tally
for the stack), every frame field ``[T, B]`` and every histogram ``[T, B,
L]``, against the JAX reference's ``telemetry_run_batch`` (its vmapped
step) and against the port's ``telemetry_run`` of each replica alone.

- stacks at 240 peers, C = 16, three replicas: scored with every group
  and histogram; the IHAVE spam and the IWANT flood under fault schedules
  (distinct fault seeds and churn a replica) with ``TelemetryConfig()``
  and the latency histogram; unscored at knob points with the latency
  histogram alone; delay-armed with the observer lines
  (``delays_counters``), every group, under fault schedules — the final
  stack leaf for leaf and every frame field bit for bit (the reference's
  ``tests/test_telemetry.py`` batched pins), each replica equal to its
  sequential run, the counters shown live;
- the pipelined benchmark (``pipelined.run``) at 2,000 peers as one
  batched dispatch against the reference's batched run of it (its four
  points built with ``sim_knobs``, stacked, ``telemetry_run_batch``):
  rows, histograms and each replica's digest;
- the plain B1 tally with a replica axis (``[B, 8 + L]``, the bucket masks
  ``[B, L, W]``) against one call a replica, every family ± faults ±
  knobs, C = 16 and C = 8 at an odd N;
- ``summarize_frames`` over ``[T, B]`` frames sums every axis.

Tolerance: exact (words and integer counters bitwise, f32/bf16 leaves and
f32 frame fields by bit pattern), but ``score_mean``, the mean of
non-integer f32 scores, which XLA and PyTorch sum in different orders
(``test_torch_telemetry.assert_frames_equal``: relative 1e-5).
"""

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import convert, pipelined, resident
from go_libp2p_pubsub_tpu_torch.knob_sweep import tree_digest
from go_libp2p_pubsub_tpu_torch.models import _batch
from go_libp2p_pubsub_tpu_torch.models import delays as pdl
from go_libp2p_pubsub_tpu_torch.models import faults as pfl
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import telemetry as ptl
from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as krecv
from test_torch_batch import STACK_VARIANTS, stack_case
from test_torch_batch_knobs import fault_cfg
from test_torch_gossipsub import _assert_tree_equal
from test_torch_knobs import one_thread  # noqa: F401  (autouse)
from test_torch_telemetry import assert_frames_equal
from torch_ref import imported_reference, tree_to_numpy


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.delays as rdl
        import go_libp2p_pubsub_tpu.models.faults as rfl
        import go_libp2p_pubsub_tpu.models.telemetry as rtl
        r.delays, r.faults, r.telemetry = rdl, rfl, rtl
        yield r


ALL = dict(latency_hist=True, degree_hist=True, score_hist=True,
           latency_buckets=12)
ATK = dict(sybil_ihave_spam=True, sybil_iwant_spam=True)
#: case: (score keywords or None, telemetry keywords, sybils, fault
#: schedules, knob points, delays with observer lines)
CASES = {
    "scored_all": ({}, ALL, False, False, False, False),
    "attacks_faults": (ATK, dict(latency_hist=True, latency_buckets=12),
                       True, True, False, False),
    "unscored_latency_knobs": (None, dict(
        counters=False, wire=False, mesh=False, scores=False, faults=False,
        latency_hist=True, latency_buckets=12), False, False, True, False),
    "delayed_counters_faults": ({}, ALL, False, True, False, True),
}


def case_specs(ref, case, n=240, t=2, m=8, B=3):
    """Each package's replica keywords: the fault tests' rings and
    messages, per case sybils (a fifth of the peers, drawn a replica), a
    fault schedule a replica, a knob point a replica and a delay line (its
    own seed a replica) with the observer lines."""
    _, _, sybils, faults, knobs, delays = CASES[case]
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
                        msg_publish_tick=ticks, seed=b)
            if sybils:
                spec["sybil"] = np.random.default_rng(50 + b).random(n) < 0.2
            if faults:
                spec["fault_schedule"] = fl.FaultSchedule(
                    n_peers=n, horizon=60, seed=100 + b,
                    down_intervals=[(10 + 2 * b, 5, 25)], drop_prob=0.05,
                    partition_group=grp, partition_windows=[(12, 20)])
            if knobs:
                spec["sim_knobs"] = {"d": 6 + b % 2, "gossip_factor":
                                     0.25 + 0.1 * b, "d_lazy": 2 + b}
            if delays:
                spec.update(delays=dl.DelayConfig(3, 2, 8, seed=11 + b),
                            delays_counters=True)
            out.append(spec)
        return out
    return specs


@pytest.mark.parametrize("case", sorted(CASES))
def test_telemetry_stack_matches_reference_and_sequential(ref, case):
    sc_kw, tel_kw = CASES[case][:2]
    ticks = 12
    out = {}
    for side, gs, fl, tl, kw in (
            ("ref", ref.gs, ref.faults, ref.telemetry, {}),
            ("port", pgs, pfl, ptl, {"device": "cpu"})):
        cfg = fault_cfg(gs)
        sc = None if sc_kw is None else gs.ScoreSimConfig(**sc_kw)
        builds = [gs.make_gossip_sim(cfg, score_cfg=sc, **spec, **kw)
                  for spec in case_specs(ref, case)(fl)]
        step = gs.make_gossip_step(cfg, sc,
                                   telemetry=tl.TelemetryConfig(**tel_kw),
                                   **kw)
        params = gs.stack_trees([p for p, _ in builds])
        state = gs.stack_trees([s for _, s in builds])
        final, frames = tl.telemetry_run_batch(params, state, ticks, step)
        out[side] = (builds, final, frames, step)
    builds, final, frames, step = out["port"]
    _assert_tree_equal(tree_to_numpy(out["ref"][1]),
                       convert.state_to_numpy(final), "stack")
    got = convert.frame_to_numpy(frames)
    assert got["payload_sent"].shape == (ticks, 3)
    if tel_kw.get("latency_hist"):
        assert got["latency_hist"].shape == (ticks, 3, 12)
    assert_frames_equal(got, tree_to_numpy(out["ref"][2]), case)
    for i, (p, s) in enumerate(builds):
        seq, seq_frames = ptl.telemetry_run(p, s, ticks, step)
        _assert_tree_equal(convert.state_to_numpy(seq),
                           convert.state_to_numpy(
                               _batch.index_trees(final, i)),
                           f"replica {i}")
        assert_frames_equal(
            {k_: None if v is None else np.ascontiguousarray(v[:, i])
             for k_, v in got.items()},
            convert.frame_to_numpy(seq_frames), f"{case} replica {i}")
    # non-vacuous: the groups the case turns on moved, per replica
    if tel_kw.get("counters", True):
        assert (got["payload_sent"].sum(0) > 0).all()
        assert (got["ihave_ids"].sum(0) > 0).all()
        assert (got["dup_suppressed"].sum(0) > 0).all()
    assert (got["latency_hist"].sum((0, 2)) > 0).all()
    if CASES[case][3]:
        assert (got["down_peers"].max(0) > 0).all()
    if sc_kw and tel_kw is ALL:
        assert (got["score_hist"].sum(2) > 0).all()


def test_summaries_sum_every_axis(ref):
    cfg = fault_cfg(pgs)
    specs = case_specs(ref, "scored_all")(pfl)
    params, state = pgs.stack_sims(cfg, specs, score_cfg=pgs.ScoreSimConfig(),
                                   device="cpu")
    step = pgs.make_gossip_step(cfg, pgs.ScoreSimConfig(), device="cpu",
                                telemetry=ptl.TelemetryConfig(**ALL))
    _, frames = ptl.telemetry_run_batch(params, state, 6, step)
    tot = ptl.summarize_frames(frames)
    arr = ptl.frames_to_arrays(frames)
    assert tot["payload_sent"] == int(arr["payload_sent"].sum())
    assert tot["latency_hist"] == arr["latency_hist"].sum((0, 1)).tolist()
    with pytest.raises(ValueError, match="replica stack"):
        ptl.telemetry_run_batch(*pgs.make_gossip_sim(
            cfg, **specs[0], device="cpu"), 1, step)


# -- the pipelined benchmark as one dispatch ----------------------------------


def test_pipelined_benchmark_matches_reference_batched_run(ref):
    """The reference's bench_gossipsub_pipelined at 2,000 peers (its four
    points built with their knobs, stacked, one ``telemetry_run_batch``)
    against ``pipelined.run``: every row, histogram and replica digest."""
    import jax

    from go_libp2p_pubsub_tpu.histutil import hist_percentiles

    n, t, m = 2_000, pipelined.N_TOPICS, pipelined.N_MSGS
    gs, tl = ref.gs, ref.telemetry
    rng = np.random.default_rng(0)
    topic = rng.integers(0, t, m)
    origin = rng.integers(0, n // t, m) * t + topic
    tick = np.sort(rng.integers(0, pipelined.MSG_HORIZON, m)).astype(
        np.int32)
    cfg = gs.GossipSimConfig(
        offsets=gs.make_gossip_offsets(t, pipelined.N_CAND, n, seed=7),
        n_topics=t)
    sc = gs.ScoreSimConfig()
    builds = [gs.make_gossip_sim(
        cfg, resident.subs_matrix(n, t), topic, origin, tick,
        seed=pipelined.SEED, score_cfg=sc,
        delays=ref.delays.DelayConfig(1, 0, pipelined.K_SLOTS),
        track_first_tick=False, sim_knobs=point)
        for point in pipelined.POINTS.values()]
    step = gs.make_gossip_step(cfg, sc, telemetry=tl.TelemetryConfig(
        **pipelined.TELEMETRY))
    params = gs.stack_trees([p for p, _ in builds])
    state, frames = tl.telemetry_run_batch(
        params, gs.stack_trees([s for _, s in builds]), pipelined.TICKS,
        step)
    hists = np.asarray(tl.frames_to_arrays(frames)["latency_hist"]).sum(0)
    reach = np.asarray(jax.vmap(gs.reach_counts_from_have)(params, state))
    got = pipelined.run("cpu", n)
    assert got["ok"], got["gates"]
    for i, (pid, row) in enumerate(got["rows"].items()):
        assert row["hist"] == [int(c) for c in hists[i]], pid
        assert row["latency"] == hist_percentiles(hists[i]), pid
        assert row["delivery_fraction"] == float(
            reach[i].astype(np.float64).mean()) / (n // t), pid
        assert row["digest"] == tree_digest(
            tree_to_numpy(gs.index_trees(state, i))), pid
    assert got["p99_stretch_base4"] == got["p99"]["base4"] / max(
        got["p99"]["base1"], 1)


# -- the plain B1 tally with a replica axis -----------------------------------


@pytest.mark.parametrize("name", sorted(n for n in STACK_VARIANTS
                                        if "_tel" in n))
@pytest.mark.parametrize("c,n", [(16, 50), (8, 37)])
def test_plain_tally_takes_a_replica_axis(name, c, n):
    k, reps, stacked = stack_case(name, n, c, 10)
    assert k.telemetry and krecv.library(k, stacked=True) == (
        "receive_tel_knobs_reps" if k.knobs else "receive_tel_reps")
    got = krecv.receive_update(k, **stacked)
    assert got[-1].shape == (3, len(krecv.TEL_ROWS) + k.tel_lat_buckets)
    for b, r in enumerate(reps):
        one = krecv.receive_update_plain(k, **r)
        assert len(one) == len(got)
        for i, (x, y) in enumerate(zip(got, one)):
            assert torch.equal(x[b], y), (name, b, i)
    # the replicas' tallies differ (no replica's rows reach another's)
    assert not torch.equal(got[-1][0], got[-1][1])
