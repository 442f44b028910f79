"""The port's telemetry frames against the JAX reference.

Same configs, seeds and build inputs (numpy) go to both packages, at the
earlier slices' test shapes (the ``_build`` functions of ``test_torch_faults``,
``test_torch_attacks``, ``test_torch_surface`` and ``test_torch_paired``):

- ``wire_sizes`` and ``TelemetryConfig``'s validation against the
  reference's;
- the port's telemetry step (CPU, plain kernel versions) against the
  reference's unpadded XLA step with the same ``TelemetryConfig``: every
  state leaf and every frame field for 30 ticks, with every group and all
  three histograms on, for the scored flagship options, unscored, each
  attack, the full variant's options and paired topics (scored and
  unscored); the same under a fault schedule with a partition, and once
  with directed drops, in ``test_torch_telemetry_faults.py``;
- telemetry on leaves the state trajectory as telemetry off does;
- the plain receive tally against the Pallas kernel's ``with_telemetry``
  rows (interpret mode), summed over its lanes;
- the runner ``telemetry_run_curve`` against the reference's, and each
  histogram against the population it counts.

Tolerance: exact (i32 counters and histograms, the f32 wire bytes, gauges
and fractions by bit pattern), except ``score_mean``: the mean of
non-integer f32 scores, which XLA and torch sum in different orders
(relative 1e-5, absolute 1e-6 near zero).
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_attacks as attacks
import test_torch_faults as tfaults
import test_torch_paired as paired
import test_torch_surface as surface
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import faults as pfl
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import telemetry as ptl
from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as prc
from test_torch_gossipsub import _assert_tree_equal
from test_torch_receive import BLOCK, _bits, _np, _operands
from test_torch_unscored import unscored_operands
from torch_ref import imported_reference, tree_to_numpy


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models._delivery as rdl
        import go_libp2p_pubsub_tpu.models.faults as rfl
        r.faults, r.delivery = rfl, rdl
        r.telemetry = r.gs._telemetry
        yield r


#: every group and all three histograms
ALL_GROUPS = dict(latency_hist=True, degree_hist=True, score_hist=True)

#: the step cases: (the test module whose _build makes the sims, its case)
CASES = {
    "scored": (tfaults, "scored"),
    "unscored": (tfaults, "unscored"),
    "ihave_spam": (attacks, "ihave_spam"),
    "iwant_flood": (attacks, "both_spam"),
    "graft_flood": (attacks, "graft_flood"),
    "promise_breakers": (attacks, "promise_breakers"),
    "eclipse": (attacks, "eclipse"),
    "full": (surface, "everything"),
    "paired": (paired, "everything"),
    "paired_unscored": (paired, "unscored"),
}


def build_case(ref, name, sched=None):
    """Both packages' sims of a case, with the fault schedule ``sched``
    (``test_torch_faults._sched_kw``'s keywords, ``halves`` for the
    partition by index halves, ``directed`` for per-direction drops; or
    None) attached to both as ``make_gossip_sim(fault_schedule=...)``
    attaches it."""
    mod, case = CASES[name]
    if mod is tfaults:
        built = tfaults._build(ref, case, faults=False)
    else:
        built = mod._build(ref, case)
    if sched is None:
        return built
    (cfg_r, sc_r, p_r, s_r), (cfg_p, sc_p, p_p, s_p) = built
    n = p_p.subscribed.shape[0]
    sched = dict(sched)
    directed, halves = sched.pop("directed", False), sched.pop("halves",
                                                                 False)
    kw = tfaults._sched_kw(n, **sched)
    if halves:
        # the partition by index halves: on these rings (offsets multiples
        # of the topic count) every edge joins peers of one parity, so the
        # parity partition would cut nothing
        kw["partition_group"] = (np.arange(n) < n // 2).astype(np.int32)
    if directed:
        # a per-edge rate on one view of each edge only: per direction
        dp = np.zeros((cfg_p.n_candidates, n), dtype=np.float32)
        for j, o in enumerate(cfg_p.offsets):
            if o > 0:
                dp[j] = 0.1
        kw["drop_prob"] = dp
    f_r, f_p = tfaults._schedules(ref, **kw)
    p_r = p_r.replace(faults=ref.faults.compile_faults(
        f_r, cfg_r.offsets, pack_links=True))
    p_p = dataclasses.replace(p_p, faults=pfl.compile_faults(
        f_p, cfg_p.offsets, device="cpu"))
    return (cfg_r, sc_r, p_r, s_r), (cfg_p, sc_p, p_p, s_p)


def assert_frames_equal(got: dict, want: dict, where: str):
    """Frame leaves (``convert.frame_to_numpy`` / the reference's as
    numpy): the same fields, dtypes and shapes, every value bit for bit
    but ``score_mean``."""
    assert set(got) == set(want), where
    for name, w in want.items():
        g = got[name]
        if w is None or g is None:
            assert w is None and g is None, f"{where}.{name}"
            continue
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, f"{where}.{name}"
        if name == "score_mean":
            # the mean of non-integer f32 scores: XLA and torch (and the
            # card) sum them in different orders, so the last bits differ
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{where}.{name}")
        else:
            np.testing.assert_array_equal(
                np.atleast_1d(g).view(np.uint8),
                np.atleast_1d(w).view(np.uint8), err_msg=f"{where}.{name}")


def run_frames_pair(ref, name, sched=None, lat_buckets=16, ticks=30):
    """Step both packages ``ticks`` heartbeats with telemetry, every state
    leaf and frame field equal on every tick; the port's stacked
    frames."""
    import jax

    (cfg_r, sc_r, p_r, s_r), (cfg_p, sc_p, p_p, s_p) = build_case(
        ref, name, sched)
    kw = dict(ALL_GROUPS, latency_buckets=lat_buckets)
    step_r = jax.jit(ref.gs.make_gossip_step(
        cfg_r, sc_r, telemetry=ref.telemetry.TelemetryConfig(**kw)))
    step_p = pgs.make_gossip_step(cfg_p, sc_p, device="cpu",
                                  telemetry=ptl.TelemetryConfig(**kw))
    frames = []
    for t in range(ticks):
        s_r, d_r, f_r = step_r(p_r, s_r)
        s_p, d_p, f_p = step_p(p_p, s_p)
        _assert_tree_equal(tree_to_numpy(s_r), convert.state_to_numpy(s_p),
                           f"{name} tick {t}")
        np.testing.assert_array_equal(_np(d_p), np.asarray(d_r),
                                      err_msg=f"{name} tick {t}")
        assert_frames_equal(convert.frame_to_numpy(f_p), tree_to_numpy(f_r),
                            f"{name} tick {t}")
        frames.append(f_p)
    return p_p, ptl.stack_frames(frames)


def check_live(frames, name, faulted=False):
    """Non-vacuous: the counters moved over the run, the histograms sum to
    their populations, the attacks and faults showed."""
    tot = ptl.summarize_frames(frames)
    assert tot["payload_sent"] > 0 and tot["ihave_ids"] > 0, tot
    assert tot["graft_sends"] > 0 and tot["dup_suppressed"] > 0, tot
    assert tot["bytes_control"] > 0 and tot["bytes_payload"] > 0, tot
    assert frames.latency_hist.sum() > 0
    if "unscored" not in name:
        assert bool((frames.score_hist.sum(1) > 0).all())
    if name in ("ihave_spam", "iwant_flood", "promise_breakers"):
        # adverts nobody serves: requested beyond served
        assert tot["iwant_ids_requested"] > tot["iwant_ids_served"], tot
    if faulted:
        assert int(frames.down_peers.max()) > 0
        assert int(frames.dropped_edge_ticks.max()) > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_frames_match_reference_30_ticks(ref, name):
    params, frames = run_frames_pair(
        ref, name, lat_buckets=5 if "unscored" in name else 16)
    check_live(frames, name)
    check_histograms(params, frames)
    assert int(frames.down_peers.max()) == 0


def check_histograms(params, frames):
    """Each histogram sums to the population it counts: the tick's
    delivered copies, the subscribed peers, the live candidate edges."""
    n_sub = int(params.subscribed.sum())
    assert bool((frames.mesh_deg_hist.sum(1) == n_sub).all())
    lat = frames.latency_hist.sum(1)
    assert bool((lat >= 0).all()) and int(lat.sum()) > 0
    if frames.score_hist is not None:
        live = frames.score_hist.sum(1)
        want = int(prc.graph.popcount32(
            params.cand_sub_bits & torch.where(params.subscribed, -1, 0)
        ).sum())
        assert bool((live == want).all())


def test_telemetry_leaves_the_trajectory_as_it_was(ref):
    """Telemetry only reads: with it on, the port's states and delivered
    words equal the step's without it, tick by tick (scored under a
    fault schedule, and the paired full variant)."""
    for name, sched in (("scored", dict(halves=True)), ("paired", None)):
        _, (cfg, sc, params, state) = build_case(ref, name, sched)
        off = pgs.make_gossip_step(cfg, sc, device="cpu")
        on = pgs.make_gossip_step(cfg, sc, device="cpu", telemetry=(
            ptl.TelemetryConfig(**ALL_GROUPS)))
        a = b = state
        for t in range(20):
            a, d_a = off(params, a)
            b, d_b, _ = on(params, b)
            _assert_tree_equal(convert.state_to_numpy(a),
                               convert.state_to_numpy(b), f"{name} {t}")
            assert torch.equal(d_a, d_b)


def test_telemetry_run_curve_matches_reference(ref):
    """The runners stack the frames [T, ...] once at the end: the port's
    ``telemetry_run_curve`` against the reference's, frames and counts;
    ``telemetry_run`` gives the same frames."""
    import jax

    (cfg_r, sc_r, p_r, s_r), (cfg_p, sc_p, p_p, s_p) = build_case(
        ref, "scored")
    tk = dict(ALL_GROUPS, latency_buckets=8)
    step_r = jax.jit(ref.gs.make_gossip_step(
        cfg_r, sc_r, telemetry=ref.telemetry.TelemetryConfig(**tk)))
    step_p = pgs.make_gossip_step(cfg_p, sc_p, device="cpu",
                                  telemetry=ptl.TelemetryConfig(**tk))
    m = p_p.publish_tick.shape[0]
    end_r, counts_r, fr_r = ref.telemetry.telemetry_run_curve(
        p_r, s_r, 24, step_r, m)
    end_p, counts_p, fr_p = ptl.telemetry_run_curve(p_p, s_p, 24, step_p, m)
    _assert_tree_equal(tree_to_numpy(end_r), convert.state_to_numpy(end_p),
                       "end")
    np.testing.assert_array_equal(counts_p.numpy(), np.asarray(counts_r))
    assert_frames_equal(convert.frame_to_numpy(fr_p), tree_to_numpy(fr_r),
                        "frames")
    assert fr_p.payload_sent.shape == (24,)
    assert fr_p.latency_hist.shape == (24, 8)
    end2, fr2 = ptl.telemetry_run(p_p, s_p, 24, step_p)
    assert_frames_equal(convert.frame_to_numpy(fr2),
                        convert.frame_to_numpy(fr_p), "telemetry_run")
    # the latency histogram's deliveries are the curve's counts
    assert torch.equal(fr_p.latency_hist.sum(1), counts_p.sum(1))


def test_latency_histogram_equals_the_kernel_rows(ref):
    """``latency_histogram`` (the scatter of a tick's delivered words by
    latency) equals the reference's and the step's in-kernel bucket rows,
    tick by tick."""
    import jax.numpy as jnp

    _, (cfg, sc, params, state) = build_case(ref, "scored")
    step = pgs.make_gossip_step(cfg, sc, device="cpu", telemetry=(
        ptl.TelemetryConfig(latency_hist=True, latency_buckets=6)))
    total = 0
    for _ in range(20):
        tick = state.tick
        state, delivered, frame = step(params, state)
        got = ptl.latency_histogram(delivered, params.publish_tick, tick, 6)
        want = ref.telemetry.latency_histogram(
            jnp.asarray(_np(delivered)), jnp.asarray(
                params.publish_tick.numpy()), tick, 6)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(got, frame.latency_hist)
        total += int(got.sum())
    assert total > 0


WIRE = {
    "defaults": dict(),
    # sizes that cross a varint boundary of the length prefixes
    "varint": dict(payload_data_bytes=200, msg_id_bytes=130),
    "wide_ids": dict(peer_id_bytes=300, topic_bytes=127, msg_id_bytes=1),
}


@pytest.mark.parametrize("name", sorted(WIRE))
def test_wire_sizes_match_reference(ref, name):
    want = ref.telemetry.wire_sizes(
        ref.telemetry.TelemetryConfig(**WIRE[name]))
    got = ptl.wire_sizes(ptl.TelemetryConfig(**WIRE[name]))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


CONFIG_ERRORS = {
    "wire_needs_counters": dict(counters=False),
    "bytes": dict(topic_bytes=0),
    "buckets": dict(latency_buckets=1),
    "edges_empty": dict(score_bucket_edges=()),
    "edges_order": dict(score_bucket_edges=(1.0, 0.0)),
}


@pytest.mark.parametrize("name", sorted(CONFIG_ERRORS))
def test_config_is_validated_as_the_reference_does(ref, name):
    msgs = []
    for mod in (ref.telemetry, ptl):
        with pytest.raises(ValueError) as err:
            mod.TelemetryConfig(**CONFIG_ERRORS[name])
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


#: the plain receive's tally against the Pallas kernel's: (scored,
#: faults, latency buckets, C)
TALLY = {
    "scored_attacks_faults": (True, True, 16, 16),
    "scored_attacks": (True, False, 0, 16),
    "unscored_faults": (False, True, 5, 8),
    "unscored": (False, False, 16, 8),
}


@pytest.mark.parametrize("name", sorted(TALLY))
def test_plain_tally_matches_pallas_kernel(ref, name):
    """The plain receive with telemetry (scored: both spams, so the
    attack options' reads are live) against make_receive_update(
    with_telemetry=True) in interpret mode on seeded operands: every
    output equal, the tally equal to the kernel's lane partials summed,
    the latency rows too."""
    import jax.numpy as jnp

    scored, faults, lat, c = TALLY[name]
    n, t = 1024, 4
    offsets = ref.gs.make_gossip_offsets(t, c, n, seed=3)
    cfg_kw = dict(offsets=offsets, n_topics=t,
                  **({} if c == 16 else tfaults.SMALL))
    sc_kw = dict(sybil_ihave_spam=True, sybil_iwant_spam=True)
    cfg = ref.gs.GossipSimConfig(**cfg_kw)
    sc = ref.gs.ScoreSimConfig(**sc_kw) if scored else None
    k = prc.receive_consts(pgs.GossipSimConfig(**cfg_kw),
                           pgs.ScoreSimConfig(**sc_kw) if scored else None,
                           faults=faults, telemetry=True,
                           tel_lat_buckets=lat)
    rng = np.random.default_rng(71 + 2 * scored + faults)
    if scored:
        ops = _operands(rng, 1, False, sc)
        ops["syb"] = torch.from_numpy(np.where(
            rng.random(n) < 0.2, (1 << c) - 1, 0).astype(np.int32))
        ops["iws"] = torch.from_numpy(rng.integers(
            0, 4 * 32, size=(c, n)).astype(np.int16))
    else:
        ops = unscored_operands(rng, c, n, 1)
    if faults:
        ops["alive_w"] = torch.from_numpy(np.where(
            rng.random(n) < 0.1, 0, -1).astype(np.int32))
        if scored:
            ops["flood_ok"] = torch.from_numpy(rng.integers(
                0, 1 << c, size=n).astype(np.int32))
    if lat:
        pub = torch.from_numpy(rng.integers(0, 40, 32).astype(np.int32))
        ops["lat_masks"] = ptl.latency_bucket_masks(pub, 30, lat, 1)
        ops["dlv_eff"] = torch.from_numpy(rng.integers(
            0, 1 << 32, size=(1, n), dtype=np.uint64).astype(
                np.uint32).view(np.int32))
    got = prc.receive_update(k, **ops)         # CPU tensors: plain version

    rc = ref.receive
    pln = rc.plan(n, cfg.offsets, BLOCK)

    def flat(rows, p, e):
        return jnp.concatenate([
            rc.extend_wrap(jnp.asarray(r), n, pln["n_pad"], pln[p], pln[e])
            for r in rows])

    krn = rc.make_receive_update(
        cfg, sc, n, BLOCK, jnp.bfloat16 if scored else jnp.float32, 1,
        track_promises=scored, interpret=True, with_static=False,
        with_faults=faults, with_telemetry=True, tel_lat_buckets=lat)
    head = ([jnp.asarray(_np(ops["valid"]))] if scored else []) + [
        jnp.asarray(np.array(ops["gseeds"], dtype=np.uint32))]
    if lat:
        head.append(jnp.asarray(_np(ops["lat_masks"])))
    head.append(jnp.zeros((1,), dtype=jnp.uint32))
    flats = [flat(list(_np(ops["ctrl"])), "p8", "e8"),
             flat(list(_np(ops["fresh"])), "p32", "e32"),
             flat(list(_np(ops["adv"])), "p32", "e32")]
    zero = np.zeros(n, dtype=np.uint32)
    blocked = ([_np(ops[k_]) for k_ in ("pay", "gsp", "acc")]
               if scored else [])
    blocked += [_np(ops[k_]) for k_ in ("sub_all", "cand_sub", "fanout")]
    blocked += [_np(ops["syb"]) if scored else zero, _np(ops["wa"]),
                _np(ops["bo2"]) if scored else zero]
    blocked += [_np(ops[k_]) for k_ in ("grafts", "dropped", "meshsel",
                                         "seen", "injected", "backoff")]
    if scored:
        blocked += [_np(ops[k_]) for k_ in ("fd", "inv", "bp", "tim",
                                             "iws")]
    if faults:
        blocked.append(_np(ops["alive_w"]))
        if scored:
            blocked.append(_np(ops["flood_ok"]))
    if lat:
        blocked.append(_np(ops["dlv_eff"]))
    want = krn(*head, *flats, *[jnp.asarray(b) for b in blocked])
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got[:-1], want[:-1])):
        np.testing.assert_array_equal(_bits(_np(g)), _bits(w),
                                      err_msg=f"output {i}")
    tally = got[-1]
    assert tally.dtype == torch.int32 and tally.shape == (8 + lat,)
    np.testing.assert_array_equal(
        tally.numpy(), np.asarray(want[-1]).sum(axis=1, dtype=np.int32))
    # non-vacuous: every counter row moved, and the latency rows sum to
    # the delivered acquisitions
    assert bool((tally[:8] > 0).all()), tally
    if lat:
        dlv = got[0] & ops["dlv_eff"]
        assert int(tally[8:].sum()) == int(
            prc.graph.popcount32(dlv).sum())


def test_tally_launch_count_key():
    """The telemetry variants count under their own keys."""
    cfg = pgs.GossipSimConfig(
        offsets=pgs.make_gossip_offsets(4, 8, 1024, seed=1), n_topics=4,
        **tfaults.SMALL)
    k = prc.receive_consts(cfg, None, faults=True, telemetry=True)
    assert prc.variant(k) == "unscored_faults+tel"
    with pytest.raises(ValueError, match="latency"):
        prc.receive_consts(cfg, None, tel_lat_buckets=4)
