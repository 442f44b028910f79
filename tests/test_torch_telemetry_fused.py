"""The fused window's telemetry (B2) and the host-side summaries against
the JAX reference.

On the fused tests' ring (``test_torch_fused``: N = 1024, 4 topics, the
unscored step):

- ``fused_gossip_update_plain`` with telemetry (what the port's CUDA
  kernel is held to on the card) against ``make_fused_gossip_update(
  with_telemetry=True)`` in interpret mode: every carry output, each
  tick's mesh row, and each tick's tally equal to the kernel's lane
  partials summed (the receive rows, the latency rows, the transmitted
  GRAFT and PRUNE rows), without and with fault rows and cold restart;
- ``make_fused_window(telemetry=...)`` frames against the per-tick
  telemetry step's, and ``gossip_run_frames_fused`` against the per-tick
  ``telemetry_run`` and against the reference's ``gossip_run_frames_fused``
  (its window over a ``pad_to_block=N`` sim, so its true N is N);
- ``summarize_frames`` and ``latency_hists_by_topic`` against the
  reference's on the same run, the per-topic histograms summing to the
  device histogram.

Tolerance: exact (the unscored frame has no score field to average).
"""

import dataclasses

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import faults as pfl
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import telemetry as ptl
from go_libp2p_pubsub_tpu_torch.ops import graph as pg
from go_libp2p_pubsub_tpu_torch.ops.kernels import fused as pfused
from test_torch_fused import (
    N,
    OUT_NAMES,
    T_TOPICS,
    _cfg_kw,
    _inputs,
    _port_sim,
    _u32,
    window_operands,
)
from test_torch_telemetry import ALL_GROUPS, assert_frames_equal
from torch_ref import imported_reference, tree_to_numpy


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.faults as rfl
        r.faults = rfl
        r.telemetry = r.gs._telemetry
        yield r


def _schedule_kw(cold):
    """Churn inside the windows (down at 9-13, back at 13-17), 5% link
    loss and a partition of the index halves over ticks [10, 14)."""
    rng = np.random.default_rng(7)
    victims = np.flatnonzero(rng.random(N) < 0.1)
    ivs = tuple((int(p), 9 + int(p % 4), 13 + int(p % 4)) for p in victims)
    return dict(n_peers=N, horizon=64, down_intervals=ivs, drop_prob=0.05,
                seed=11, cold_restart=cold,
                partition_group=(np.arange(N) < N // 2).astype(np.int32),
                partition_windows=((10, 14),))


#: (C, T, fault rows: None / "faults" / "cold", latency buckets)
PLAIN = {
    "c16_t8": (16, 8, None, 16),
    "c8_t4_faults": (8, 4, "faults", 5),
    "c16_t4_cold": (16, 4, "cold", 0),
}


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_fused_plain_tally_matches_pallas_kernel(ref, name):
    import jax.numpy as jnp

    c, ticks, faults, lat = PLAIN[name]
    fs = (pfl.FaultSchedule(**_schedule_kw(faults == "cold"))
          if faults else None)
    cfg, params, state = _port_sim(c, fault_schedule=fs)
    step = pgs.make_gossip_step(cfg, None, device="cpu")
    # clean: mid mesh formation (grafts and prunes); faulted: inside the
    # churn waves and the partition
    state = pgs.gossip_run(params, state, 9 if faults else 1, step,
                           device="cpu")
    ops = window_operands(cfg, params, state, ticks)
    if faults:
        ops.update(pgs.window_fault_rows(cfg, params.faults, state.tick,
                                         ticks))
    if lat:
        tk = torch.arange(state.tick, state.tick + ticks, dtype=torch.int32)
        ops.update(lat_masks=ptl.latency_bucket_masks(
            params.publish_tick, tk[:, None], lat, state.have.shape[0]),
            dlv=params.deliver_words)
    k = pfused.fused_consts(cfg, telemetry=True, tel_lat_buckets=lat)
    got = pfused.fused_gossip_update(k, **ops)     # CPU: plain version

    cfg_r = ref.gs.GossipSimConfig(offsets=cfg.offsets, n_topics=T_TOPICS,
                                   **_cfg_kw(c))
    W, hg = state.have.shape[0], cfg.history_gossip
    krn = ref.receive.make_fused_gossip_update(
        cfg_r, N, W, hg, ticks, interpret=True, stream_n=N,
        with_faults=faults is not None, cold_restart=faults == "cold",
        with_telemetry=True, tel_lat_buckets=lat)
    i32 = lambda t: jnp.asarray(t.numpy())          # noqa: E731
    u32 = lambda t: jnp.asarray(_u32(t))            # noqa: E731
    args = [jnp.asarray([ops["tick0"]], jnp.int32),
            jnp.asarray(np.array(ops["seeds"], dtype=np.uint32)),
            u32(ops["due"]), jnp.zeros((1,), jnp.uint32)]
    if lat:
        args.append(u32(ops["lat_masks"]))
    args += [u32(ops["sub_all"]), u32(ops["cand_sub"]), u32(ops["origin"])]
    if lat:
        args.append(u32(ops["dlv"]))
    args += [u32(ops["have"]), u32(ops["recent"].reshape(hg * W, N)),
             u32(ops["mesh"]), u32(ops["fanout"]), i32(ops["last_pub"]),
             i32(ops["backoff"]), u32(ops["tgt"]), u32(ops["bog"])]
    if faults:
        args += [u32(ops[k_]) for k_ in ("alive", "send_ok", "cand_alive")]
    if faults == "cold":
        args.append(u32(ops["rejoin"]))
    want = krn(*args)
    assert len(got) == len(want) == len(OUT_NAMES) + 2
    for name_, g, w in zip(OUT_NAMES + ("mesh_rows",), got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(
            g.numpy().view(w.dtype).reshape(w.shape), w, err_msg=name_)
    tally = got[-1]
    assert tally.dtype == torch.int32 and tally.shape == (ticks, 8 + lat + 2)
    np.testing.assert_array_equal(
        tally.numpy(), np.asarray(want[-1]).sum(axis=2, dtype=np.int32))
    # non-vacuous: messages moved over the window; grafts and prunes went
    # out; under faults, fewer GRAFTs and PRUNEs on the wire than chosen
    assert int(tally[:, 0].sum()) > 0 and int(tally[:, -2:].sum()) > 0
    if lat:
        assert int(tally[:, 8:8 + lat].sum()) == int(pg.popcount32(
            got[8] & ops["dlv"][None]).sum())
    if faults:
        clean = pfused.fused_gossip_update(
            k, **{k_: v for k_, v in ops.items()
                  if k_ not in pfused.FAULT_ROWS})
        assert not torch.equal(clean[-1], tally)


def _run_pair(ref, faulted, lat=8, ticks=24, tf=8):
    """The reference's and the port's fused frames over ``ticks`` ticks
    of 8-tick windows, and the port's per-tick frames."""
    (cfg_r, p_r, s_r), (cfg_p, p_p, s_p) = _sim_pair(ref, faulted)
    tk = dict(ALL_GROUPS, latency_buckets=lat)
    win_r = ref.gs.make_fused_window(
        cfg_r, None, ticks_fused=tf, receive_block=N,
        receive_interpret=True, on_refusal="raise",
        telemetry=ref.telemetry.TelemetryConfig(**tk))
    win_p = pgs.make_fused_window(cfg_p, None, ticks_fused=tf, device="cpu",
                                  telemetry=ptl.TelemetryConfig(**tk))
    step_p = pgs.make_gossip_step(cfg_p, None, device="cpu",
                                  telemetry=ptl.TelemetryConfig(**tk))
    end_r, fr_r = ref.gs.gossip_run_frames_fused(p_r, s_r, ticks, win_r)
    end_f, fr_f = pgs.gossip_run_frames_fused(p_p, s_p, ticks, win_p,
                                              device="cpu")
    end_t, fr_t = ptl.telemetry_run(p_p, s_p, ticks, step_p)
    return (end_r, fr_r), (end_f, fr_f), (end_t, fr_t), p_p


def _sim_pair(ref, faulted, seed=0, pad=True):
    """Both packages' sims; the reference's padded to N (its fused
    window's layout) or not (its XLA step's)."""
    args = _inputs(seed)
    offsets = ref.gs.make_gossip_offsets(T_TOPICS, 16, N, seed=seed)
    cfg_r = ref.gs.GossipSimConfig(offsets=offsets, n_topics=T_TOPICS)
    cfg_p = pgs.GossipSimConfig(offsets=offsets, n_topics=T_TOPICS)
    kw_r = kw_p = {}
    if faulted:
        kw = _schedule_kw(cold=True)
        kw_r = dict(fault_schedule=ref.faults.FaultSchedule(**kw))
        kw_p = dict(fault_schedule=pfl.FaultSchedule(**kw))
    ref_sim = ref.gs.make_gossip_sim(cfg_r, *args, seed=seed,
                                     pad_to_block=N if pad else None,
                                     **kw_r)
    port_sim = pgs.make_gossip_sim(cfg_p, *args, seed=seed, device="cpu",
                                   **kw_p)
    return (cfg_r, *ref_sim), (cfg_p, *port_sim)


@pytest.mark.parametrize("faulted", [False, True])
def test_frames_fused_match_per_tick_and_reference(ref, faulted):
    (end_r, fr_r), (end_f, fr_f), (end_t, fr_t), params = _run_pair(
        ref, faulted)
    want = tree_to_numpy(fr_r)
    assert_frames_equal(convert.frame_to_numpy(fr_f), want, "fused")
    assert_frames_equal(convert.frame_to_numpy(fr_t), want, "per tick")
    assert fr_f.payload_sent.shape == (24,)
    a, b = convert.state_to_numpy(end_f), convert.state_to_numpy(end_t)
    for name in ("have", "recent", "mesh", "fanout", "last_pub", "backoff"):
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
        np.testing.assert_array_equal(
            a[name], np.asarray(getattr(end_r, name)), err_msg=name)
    # non-vacuous: traffic, handshakes and deliveries in the frames; the
    # faults group live under the schedule
    tot = ptl.summarize_frames(fr_f)
    assert tot["payload_sent"] > 0 and tot["graft_sends"] > 0, tot
    assert tot["iwant_ids_requested"] > 0 and tot["prune_sends"] >= 0, tot
    assert int(fr_f.latency_hist.sum()) > 0
    assert bool((fr_f.mesh_deg_hist.sum(1)
                 == int(params.subscribed.sum())).all())
    if faulted:
        assert int(fr_f.down_peers.max()) > 0
        assert int(fr_f.dropped_edge_ticks[10:14].min()) > int(
            fr_f.dropped_edge_ticks[14:].max())


def test_summaries_match_reference(ref):
    """``summarize_frames`` (totals, the control-overhead ratio, the
    latency percentiles) and ``latency_hists_by_topic`` against the
    reference's on the same run; the per-topic histograms add up to the
    device histogram."""
    import jax

    (cfg_r, p_r, s_r), (cfg_p, p_p, s_p) = _sim_pair(ref, faulted=False,
                                                     pad=False)
    tk = dict(ALL_GROUPS, latency_buckets=6)
    step_r = jax.jit(ref.gs.make_gossip_step(
        cfg_r, None, telemetry=ref.telemetry.TelemetryConfig(**tk)))
    step_p = pgs.make_gossip_step(cfg_p, None, device="cpu",
                                  telemetry=ptl.TelemetryConfig(**tk))
    m = p_p.publish_tick.shape[0]
    _, counts_r, fr_r = ref.telemetry.telemetry_run_curve(
        p_r, s_r, 32, step_r, m)
    _, counts_p, fr_p = ptl.telemetry_run_curve(p_p, s_p, 32, step_p, m)
    got, want = ptl.summarize_frames(fr_p), ref.telemetry.summarize_frames(
        fr_r)
    assert got == want
    assert 0 < got["control_overhead_ratio"] < float("inf")
    _, topic, _, _ = _inputs(0)
    hist_p = ptl.latency_hists_by_topic(counts_p, p_p.publish_tick, topic, 6)
    hist_r = ref.telemetry.latency_hists_by_topic(
        np.asarray(counts_r), np.asarray(p_r.publish_tick), topic, 6)
    assert hist_p == hist_r and len(hist_p) == T_TOPICS
    assert np.sum(list(hist_p.values()), axis=0).tolist() == \
        got["latency_hist"]
    assert ptl.hist_percentiles([0, 0, 0]) == \
        ref.telemetry.hist_percentiles([0, 0, 0])


def test_fused_telemetry_consts_and_launch_key():
    """The window's rows go with telemetry; a fused window with telemetry
    is no longer refused."""
    cfg, params, state = _port_sim(16)
    with pytest.raises(ValueError, match="latency"):
        pfused.fused_consts(cfg, tel_lat_buckets=4)
    win = pgs.make_fused_window(
        cfg, None, ticks_fused=4, device="cpu",
        telemetry=ptl.TelemetryConfig(counters=False, wire=False))
    st, delivered, frames = win(params, state)
    assert st.tick == 4 and delivered.shape[0] == 4
    # the counters are off: zero; the mesh gauges are on
    assert int(frames.payload_sent.abs().sum()) == 0
    assert int(frames.mesh_deg_max.max()) > 0
    k = dataclasses.replace(pfused.fused_consts(cfg), telemetry=True)
    assert k.telemetry and pfused.TEL_FUSED_EXTRA == 2
