"""The port's segmented runners (``parallel/checkpoint.py``) against its
unsegmented runners and the JAX reference's segmented runners.

Each family is built by both packages from the same numpy inputs (512
peers, 4 topics, 8 messages, 10 ticks; the fused window 12 ticks): the
scored step with delays, a fault schedule and IHAVE spam; the unscored
step; the curve; a knob batch of three replicas; telemetry frames; the
fused window; FloodSub circulant and gather and its curve; RandomSub and
its curve.  The port's run segmented at two ``every`` values equals its
unsegmented run, and the reference's ``ckpt_*`` run of the same family,
leaf for leaf (state, counts, frames, reach); the reference runs one
segmentation (its own tests hold its segmentations equal).  Also: the
kill flag interrupts after the segment in flight and the same call
resumes; the fused runner refuses a segment that splits a window; the
sharded runners are refused by name.

Tolerance: exact — every leaf is compared bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import delays as pdl
from go_libp2p_pubsub_tpu_torch.models import faults as pfl
from go_libp2p_pubsub_tpu_torch.models import floodsub as pfs
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import plan
from go_libp2p_pubsub_tpu_torch.models import randomsub as prs
from go_libp2p_pubsub_tpu_torch.models import telemetry as ptl
from go_libp2p_pubsub_tpu_torch.ops import graph as pg
from go_libp2p_pubsub_tpu_torch.parallel import checkpoint as pck
from test_torch_gossipsub import _assert_tree_equal
from test_torch_knobs import one_thread  # noqa: F401  (autouse)
from test_torch_telemetry import assert_frames_equal
from torch_ref import imported_reference, tree_to_numpy

N, T, M, TICKS = 512, 4, 8, 10
#: every = 5: two equal segments; every = 3: 3 + 3 + 3 + 1
EVERIES = (5, 3)
FUSED_TICKS, FUSED_T, FUSED_EVERIES = 12, 2, (4, 6)
CPU = "cpu"


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.delays as rdl
        import go_libp2p_pubsub_tpu.models.faults as rfl
        import go_libp2p_pubsub_tpu.models.floodsub as rfs
        import go_libp2p_pubsub_tpu.models.randomsub as rrs
        import go_libp2p_pubsub_tpu.models.telemetry as rtl
        from go_libp2p_pubsub_tpu.parallel import checkpoint as rck
        r.delays, r.faults, r.fs, r.rs, r.tl, r.ck = (rdl, rfl, rfs, rrs,
                                                      rtl, rck)
        yield r


def inputs(n=N, t=T, m=M, horizon=6, seed=0):
    rng = np.random.default_rng(seed)
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    topic = rng.integers(0, t, m)
    origin = rng.integers(0, n // t, m) * t + topic
    tick0 = np.sort(rng.integers(0, horizon, m)).astype(np.int32)
    return subs, topic, origin, tick0


def schedule(fl, n=N):
    return fl.FaultSchedule(
        n_peers=n, horizon=TICKS, drop_prob=0.05, seed=5,
        down_intervals=tuple((int(p), 2, 5) for p in range(0, n, 41)))


SCORED = dict(sybil_ihave_spam=True)
KNOB_POINTS = ({}, {"d": 5, "gossip_factor": 0.4},
               {"behaviour_penalty_weight": -40.0, "backoff_ticks": 6})


def gossip_family(pkg, family):
    """``(cfg, sc, params, state, step, honest)`` of ``family`` for one
    package (``pkg``: the reference's namespace, or None for the port's
    CPU build); ``step`` is the fused window for the port's ``fused``,
    ``honest`` the knob batch's mask (else None)."""
    port = pkg is None
    gs = pgs if port else pkg.gs
    dl = pdl if port else pkg.delays
    fl = pfl if port else pkg.faults
    tl = ptl if port else pkg.tl
    subs, topic, origin, tick0 = inputs()
    cfg = gs.GossipSimConfig(
        offsets=gs.make_gossip_offsets(T, 16, N, seed=7), n_topics=T)
    dev = dict(device=CPU) if port else {}
    sc = None if family in ("unscored", "fused") else gs.ScoreSimConfig(
        **(SCORED if family in ("scored", "knob_batch") else {}))
    kw = dict(seed=3, score_cfg=sc, track_first_tick=False, **dev)
    step_kw = dict(dev)
    if family == "scored":
        kw.update(delays=dl.DelayConfig(base=2, jitter=1, k_slots=4),
                  fault_schedule=schedule(fl), sybil=np.arange(N) % 37 == 0)
    if family == "telemetry":
        kw.update(fault_schedule=schedule(fl))
        step_kw["telemetry"] = tl.TelemetryConfig(latency_hist=True,
                                                  latency_buckets=TICKS)
    if family == "knob_batch":
        builds = [gs.make_gossip_sim(
            cfg, subs, topic, origin, tick0,
            sybil=np.arange(N) % (31 + i) == 0, sim_knobs=dict(pt),
            **dict(kw, seed=i)) for i, pt in enumerate(KNOB_POINTS)]
        params = gs.stack_trees([b[0] for b in builds])
        state = gs.stack_trees([b[1] for b in builds])
        honest = np.stack([np.arange(N) % (31 + i) != 0
                           for i in range(len(KNOB_POINTS))])
        return cfg, sc, params, state, gs.make_gossip_step(
            cfg, sc, **step_kw), honest
    params, state = gs.make_gossip_sim(cfg, subs, topic, origin, tick0,
                                       **kw)
    if family == "fused" and port:
        return cfg, sc, params, state, pgs.make_fused_window(
            cfg, None, ticks_fused=FUSED_T, device=CPU), None
    return cfg, sc, params, state, gs.make_gossip_step(cfg, sc, **step_kw), \
        None


def meshless_family(pkg, family):
    """The FloodSub / RandomSub families: ``(params, state, step)``."""
    port = pkg is None
    subs, topic, origin, tick0 = inputs(n=N, t=2, m=M)
    dev = dict(device=CPU) if port else {}
    if family.startswith("flood"):
        fs = pfs if port else pkg.fs
        offs = tuple(int(o) for o in pg.make_circulant_offsets(2, 8, N,
                                                               seed=1))
        if family == "flood_circulant":
            sim = fs.make_flood_sim(None, None, subs, None, topic, origin,
                                    tick0, **dev)
            return (*sim, fs.make_circulant_flood_step(offs))
        nbrs, mask = pg.build_topic_graph(subs, 4, seed=1)
        sim = fs.make_flood_sim(nbrs, mask, subs, None, topic, origin,
                                tick0, **dev)
        if family == "flood_gather":
            return (*sim, fs.flood_step)
        return (*sim, fs.make_gather_step_core())
    rs = prs if port else pkg.rs
    offs = prs.make_randomsub_offsets(2, 16, N, seed=1)
    cfg = rs.RandomSubSimConfig(offsets=offs, n_topics=2, d=3)
    sim = rs.make_randomsub_sim(cfg, subs, topic, origin, tick0, seed=7,
                                **dev)
    return (*sim, rs.make_randomsub_step(cfg))


GOSSIP = ("scored", "unscored", "curve", "knob_batch", "telemetry",
          "fused")
MESHLESS = ("flood_circulant", "flood_gather", "flood_curve", "randomsub",
            "randomsub_curve")


def run_gossip(mod, family, built, ckc, port):
    """One package's segmented run of a gossip family: a dict of numpy
    outputs (``state`` and, by family, ``aux`` / ``reach``)."""
    cfg, sc, params, state, step, honest = built
    dev = dict(device=CPU) if port else {}
    to_np = convert.state_to_numpy if port else tree_to_numpy
    if family in ("scored", "unscored"):
        return {"state": to_np(mod.ckpt_gossip_run(params, state, TICKS,
                                                   step, ckc, **dev))}
    if family == "curve":
        s, c = mod.ckpt_gossip_run_curve(params, state, TICKS, step, ckc, M,
                                         **dev)
        return {"state": to_np(s), "aux": np.asarray(c)}
    if family == "knob_batch":
        s, reach = mod.ckpt_gossip_run_knob_batch(params, state, TICKS,
                                                  step, ckc, honest, **dev)
        return {"state": to_np(s), "reach": np.asarray(reach)}
    if family == "telemetry":
        s, fr = mod.ckpt_telemetry_run(params, state, TICKS, step, ckc,
                                       **dev)
        return {"state": to_np(s), "frames": (
            convert.frame_to_numpy(fr) if port else tree_to_numpy(fr))}
    assert family == "fused"
    if port:
        s = mod.ckpt_gossip_run_fused(params, state, FUSED_TICKS, step, ckc,
                                      **dev)
    else:
        # the reference's segmented per-tick run of the same sim (the
        # fused window equals the per-tick step: its own tests)
        s = mod.ckpt_gossip_run(params, state, FUSED_TICKS, step, ckc)
    return {"state": to_np(s)}


def unsegmented_gossip(family, built):
    cfg, sc, params, state, step, honest = built
    if family in ("scored", "unscored"):
        s = pgs.gossip_run(params, state, TICKS, step, device=CPU)
        return {"state": convert.state_to_numpy(s)}
    if family == "curve":
        s, c = pgs.gossip_run_curve(params, state, TICKS, step, M,
                                    device=CPU)
        return {"state": convert.state_to_numpy(s), "aux": c.numpy()}
    if family == "knob_batch":
        s, reach = pgs.gossip_run_knob_batch(params, state, TICKS, step,
                                             honest, device=CPU)
        return {"state": convert.state_to_numpy(s), "reach": reach.numpy()}
    if family == "telemetry":
        s, fr = ptl.telemetry_run(params, state, TICKS, step)
        return {"state": convert.state_to_numpy(s),
                "frames": convert.frame_to_numpy(fr)}
    s = pgs.gossip_run_fused(params, state, FUSED_TICKS, step, device=CPU)
    return {"state": convert.state_to_numpy(s)}


def run_meshless(mod, family, built, ckc, port):
    params, state, step = built
    dev = dict(device=CPU) if port else {}
    to_np = ((convert.flood_state_to_numpy if family.startswith("flood")
              else convert.randomsub_state_to_numpy) if port
             else tree_to_numpy)
    if family == "flood_curve":
        s, c = mod.ckpt_flood_run_curve(params, state, TICKS, step, ckc, M,
                                        **dev)
        return {"state": to_np(s), "aux": np.asarray(c)}
    if family == "randomsub_curve":
        s, c = mod.ckpt_randomsub_run_curve(params, state, TICKS, step, ckc,
                                            M, **dev)
        return {"state": to_np(s), "aux": np.asarray(c)}
    if family.startswith("flood"):
        return {"state": to_np(mod.ckpt_flood_run(params, state, TICKS, step,
                                                  ckc, **dev))}
    return {"state": to_np(mod.ckpt_randomsub_run(params, state, TICKS,
                                                  step, ckc, **dev))}


def unsegmented_meshless(family, built):
    params, state, step = built
    if family.startswith("flood"):
        to_np = convert.flood_state_to_numpy
        if family == "flood_curve":
            s, c = pfs.flood_run_curve(params, state, TICKS, step, M,
                                       device=CPU)
            return {"state": to_np(s), "aux": c.numpy()}
        return {"state": to_np(pfs.flood_run(params, state, TICKS, step,
                                             device=CPU))}
    to_np = convert.randomsub_state_to_numpy
    if family == "randomsub_curve":
        s, c = prs.randomsub_run_curve(params, state, TICKS, step, M,
                                       device=CPU)
        return {"state": to_np(s), "aux": c.numpy()}
    return {"state": to_np(prs.randomsub_run(params, state, TICKS, step,
                                             device=CPU))}


def assert_outputs_equal(want: dict, got: dict, where: str):
    assert want.keys() == got.keys(), where
    _assert_tree_equal(want["state"], got["state"], f"{where} state")
    for key in ("aux", "reach"):
        if key in want:
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{where} {key}")
    if "frames" in want:
        assert_frames_equal(got["frames"], want["frames"], where)


def _reference_outputs(ref, family, tmp):
    ckc = ref.ck.CheckpointConfig(directory=str(tmp), every=5 if family
                                  != "fused" else 4)
    if family in GOSSIP:
        return run_gossip(ref.ck, family, gossip_family(ref, family), ckc,
                          port=False)
    return run_meshless(ref.ck, family, meshless_family(ref, family), ckc,
                        port=False)


@pytest.mark.parametrize("family", GOSSIP + MESHLESS)
def test_segmented_runner_equals_unsegmented_and_reference(ref, family,
                                                           tmp_path):
    want = _reference_outputs(ref, family, tmp_path / "ref")
    if family in GOSSIP:
        base = unsegmented_gossip(family, gossip_family(None, family))
    else:
        base = unsegmented_meshless(family, meshless_family(None, family))
    assert_outputs_equal(want, base, f"{family} unsegmented")
    for every in (FUSED_EVERIES if family == "fused" else EVERIES):
        ckc = pck.CheckpointConfig(directory=str(tmp_path / f"e{every}"),
                                   every=every, keep=10)
        if family in GOSSIP:
            got = run_gossip(pck, family, gossip_family(None, family), ckc,
                             port=True)
        else:
            got = run_meshless(pck, family, meshless_family(None, family),
                               ckc, port=True)
        assert_outputs_equal(want, got, f"{family} every={every}")
        n_ticks = FUSED_TICKS if family == "fused" else TICKS
        assert len(os.listdir(ckc.directory)) == -(-n_ticks // every)
    # non-vacuous: the run moved possession
    assert np.asarray(want["state"]["have"]).any()


def test_kill_flag_interrupts_then_resumes(tmp_path):
    """With the stop flag up the engine finishes the segment in flight,
    flushes its snapshot and raises CheckpointInterrupt naming it; after
    clear_stop() the same call resumes to the uninterrupted state."""
    want = unsegmented_gossip("scored", gossip_family(None, "scored"))
    ckc = pck.CheckpointConfig(directory=str(tmp_path), every=3)
    _, _, params, state, step, _ = gossip_family(None, "scored")
    pck.request_stop()
    try:
        with pytest.raises(pck.CheckpointInterrupt) as ei:
            pck.ckpt_gossip_run(params, state, TICKS, step, ckc, device=CPU)
        assert ei.value.ticks_done == 3
        assert os.path.exists(ei.value.path)
    finally:
        pck.clear_stop()
    _, _, params, state, step, _ = gossip_family(None, "scored")
    got = pck.ckpt_gossip_run(params, state, TICKS, step, ckc, device=CPU)
    _assert_tree_equal(want["state"], convert.state_to_numpy(got), "resumed")


def test_fused_runner_refuses_a_segment_that_splits_a_window(ref, tmp_path):
    """An ``every`` that is no whole number of windows: the reference's
    ValueError, word for word; a horizon that is none: ``fused_horizon``."""
    from go_libp2p_pubsub_tpu.models import plan as rplan

    _, _, params, state, window, _ = gossip_family(None, "fused")
    with pytest.raises(ValueError) as err:
        pck.ckpt_gossip_run_fused(
            params, state, FUSED_TICKS, window,
            pck.CheckpointConfig(directory=str(tmp_path), every=3),
            device=CPU)
    assert str(err.value) == rplan.msg_ckpt_mid_window(3, FUSED_T)
    with pytest.raises(plan.SliceRefusal) as err:
        pck.ckpt_gossip_run_fused(
            params, state, 7, window,
            pck.CheckpointConfig(directory=str(tmp_path), every=2),
            device=CPU)
    assert err.value.name == "fused_horizon"
    assert not os.path.exists(tmp_path / "sim-seg000001.ckpt")


@pytest.mark.parametrize("name", ["ckpt_sharded_gossip_run",
                                  "ckpt_sharded_gossip_run_fused",
                                  "ckpt_sharded_gossip_run_knob_batch"])
def test_sharded_runners_are_refused_by_name(name):
    with pytest.raises(plan.SliceRefusal) as err:
        getattr(pck, name)(None, None, 1, None, None, None)
    assert err.value.name == "sharded_checkpoint"
    assert "A9" in str(err.value)


def test_segment_dispatch_names_the_unsegmented_runners():
    d = pck.segment_dispatch()
    assert d["gossipsub"] is pgs.gossip_run
    assert d["gossipsub-batch"] is pgs.gossip_run_batch
    assert d["floodsub"] is pfs.flood_run
    assert d["randomsub"] is prs.randomsub_run


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    _, _, params, state, step, _ = gossip_family(None, "scored")
    ckc = pck.CheckpointConfig(directory="unused", every=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pck.ckpt_gossip_run(params, state, TICKS, step, ckc)
