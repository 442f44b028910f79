"""One snapshot format for both packages, and every rejection by name.

- Snapshots cross both ways: the JAX reference's segmented run, with bf16
  score counters and a delta chain (``full_every=2``), is cut back to a
  mid-chain delta and resumed by the port; the port's snapshots likewise
  by the reference; both reach the uninterrupted state leaf for leaf.  No
  ``ml_dtypes`` on the port's side: bf16 leaves cross as their bits.
- ``config_fingerprint`` is equal across the packages for the same
  configs and differs where the reference's
  ``test_config_fingerprint_discriminates`` says it must.
- The rejections of ``tests/test_ckpt_runners.py`` on the port, with the
  reference's texts: truncated, bit-flipped, non-snapshot, fingerprint
  mismatch, layout mismatch, stale horizon, completed aux run, unusable
  delta chains (missing full, corrupt link, divergent base), the config's
  validations; the async writer and the delta chain's headers and pruning.
- ``utils/checkpoint.py``: save and load in both directions, the template
  mismatch, the legacy migrations (zero P3 leaves, the pre-gate-pipeline
  backoff and gates, the pre-ledger ``iwant_serves``), the gates
  fingerprint.

Tolerance: exact — every leaf bit for bit.
"""

import os

import numpy as np
import pytest

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import delays as pdl
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import telemetry as ptl
from go_libp2p_pubsub_tpu_torch.parallel import checkpoint as pck
from go_libp2p_pubsub_tpu_torch.utils import checkpoint as puc
from test_torch_checkpoint import (
    CPU,
    M,
    N,
    T,
    TICKS,
    gossip_family,
    inputs,
    unsegmented_gossip,
)
from test_torch_gossipsub import _assert_tree_equal
from test_torch_knobs import one_thread  # noqa: F401  (autouse)
from torch_ref import imported_reference, tree_to_numpy


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.delays as rdl
        import go_libp2p_pubsub_tpu.models.faults as rfl
        import go_libp2p_pubsub_tpu.models.telemetry as rtl
        from go_libp2p_pubsub_tpu.parallel import checkpoint as rck
        from go_libp2p_pubsub_tpu.utils import checkpoint as ruc
        r.delays, r.faults, r.tl, r.ck, r.uc = rdl, rfl, rtl, rck, ruc
        yield r


@pytest.fixture(scope="module")
def uninterrupted():
    return unsegmented_gossip("scored", gossip_family(None, "scored"))


def _ckpt(mod, tmp_path, every, **kw):
    return mod.CheckpointConfig(directory=str(tmp_path / "snaps"),
                                every=every, **kw)


def _port_run(ckc, n_ticks=TICKS):
    _, _, params, state, step, _ = gossip_family(None, "scored")
    return pck.ckpt_gossip_run(params, state, n_ticks, step, ckc, device=CPU)


# -- the format across the packages ------------------------------------------

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_snapshot_chain_resumes_in_the_other_package(ref, writer, tmp_path,
                                                       uninterrupted):
    """A segmented run at every=3 with full_every=2 (segments: full,
    delta, full, delta) by one package, its last two snapshots deleted so
    the newest is the segment-2 delta; the other package resumes from it
    (reconstructing the chain) to the uninterrupted state."""
    cfg_r, sc_r, p_r, s_r, step_r, _ = gossip_family(ref, "scored")
    cfg_p, sc_p, p_p, s_p, step_p, _ = gossip_family(None, "scored")
    fp = ref.ck.config_fingerprint(cfg_r, sc_r)
    assert pck.config_fingerprint(cfg_p, sc_p) == fp
    assert s_p.scores.first_deliveries.dtype == pgs.torch.bfloat16
    kw = dict(every=3, keep=10, full_every=2, fingerprint=fp)
    if writer == "reference":
        ref.ck.ckpt_gossip_run(p_r, s_r, TICKS, step_r,
                               _ckpt(ref.ck, tmp_path, **kw))
    else:
        pck.ckpt_gossip_run(p_p, s_p, TICKS, step_p,
                            _ckpt(pck, tmp_path, **kw), device=CPU)
    d = str(tmp_path / "snaps")
    kinds = [pck.snapshot_read(os.path.join(d, f))[0]["kind"]
             for f in sorted(os.listdir(d))]
    assert kinds == ["full", "delta", "full", "delta"]
    for seg in (3, 4):
        os.unlink(os.path.join(d, f"sim-seg{seg:06d}.ckpt"))
    if writer == "reference":
        _, _, p_p, s_p, step_p, _ = gossip_family(None, "scored")
        got = convert.state_to_numpy(pck.ckpt_gossip_run(
            p_p, s_p, TICKS, step_p, _ckpt(pck, tmp_path, **kw),
            device=CPU))
    else:
        _, _, p_r, s_r, step_r, _ = gossip_family(ref, "scored")
        got = tree_to_numpy(ref.ck.ckpt_gossip_run(
            p_r, s_r, TICKS, step_r, _ckpt(ref.ck, tmp_path, **kw)))
    _assert_tree_equal(uninterrupted["state"], got, f"{writer} -> other")


def test_keys_dtypes_and_payload_match_the_references(ref, tmp_path):
    """The same run's snapshot holds the same keys, dtypes, shapes and
    bytes in both packages (bf16 leaves as bits:bfloat16)."""
    cfg_r, sc_r, p_r, s_r, step_r, _ = gossip_family(ref, "scored")
    _, _, p_p, s_p, step_p, _ = gossip_family(None, "scored")
    ref.ck.ckpt_gossip_run(p_r, s_r, 4, step_r,
                           ref.ck.CheckpointConfig(str(tmp_path / "r")))
    pck.ckpt_gossip_run(p_p, s_p, 4, step_p,
                        pck.CheckpointConfig(str(tmp_path / "p")),
                        device=CPU)
    path = "sim-seg000001.ckpt"
    h_r, k_r = ref.ck.snapshot_read(str(tmp_path / "r" / path))
    h_p, k_p = pck.snapshot_read(str(tmp_path / "p" / path))
    assert list(k_p) == list(k_r)
    for k, want in k_r.items():
        got = k_p[k]
        assert got.shape == want.shape, k
        if want.dtype.name == "bfloat16":
            assert got.dtype == np.uint16, k
            want = want.view(np.uint16)
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    with open(tmp_path / "p" / path, "rb") as f:
        names = f.read()
    assert b"bits:bfloat16:state/scores/first_deliveries" in names
    for key in ("tick", "ticks_done", "segment", "layout", "kind"):
        assert h_p[key] == h_r[key], key


@pytest.mark.parametrize("scored", [True, False])
def test_utils_snapshots_load_in_the_other_package(ref, scored, tmp_path):
    family = "scored" if scored else "unscored"
    cfg_r, sc_r, p_r, s_r, step_r, _ = gossip_family(ref, family)
    _, _, p_p, s_p, step_p, _ = gossip_family(None, family)
    mid_r = ref.gs.gossip_run(p_r, s_r, 4, step_r)
    mid_p = pgs.gossip_run(p_p, s_p, 4, step_p, device=CPU)
    ref.uc.save_state(str(tmp_path / "r.npz"), mid_r)
    puc.save_state(str(tmp_path / "p.npz"), mid_p)
    _, _, _, tmpl_p, _, _ = gossip_family(None, family)
    _, _, _, tmpl_r, _, _ = gossip_family(ref, family)
    got_p = puc.load_state(str(tmp_path / "r.npz"), tmpl_p)
    got_r = ref.uc.load_state(str(tmp_path / "p.npz"), tmpl_r)
    want = tree_to_numpy(mid_r)
    _assert_tree_equal(want, convert.state_to_numpy(got_p), "ref -> port")
    _assert_tree_equal(want, tree_to_numpy(got_r), "port -> ref")
    assert got_p.gates_fp == mid_p.gates_fp
    # and the port's restored state continues as the uninterrupted one
    a = pgs.gossip_run(p_p, got_p, 4, step_p, device=CPU)
    _assert_tree_equal(tree_to_numpy(ref.gs.gossip_run(p_r, mid_r, 4,
                                                       step_r)),
                       convert.state_to_numpy(a), "continued")


# -- fingerprints ---------------------------------------------------------------

def _configs(gs, dl, tl):
    offsets = gs.make_gossip_offsets(T, 16, N, seed=7)
    cfg = gs.GossipSimConfig(offsets=offsets, n_topics=T)
    return [
        (cfg, gs.ScoreSimConfig()),
        (cfg, None),
        (gs.GossipSimConfig(offsets=offsets, n_topics=T, d=5),
         gs.ScoreSimConfig()),
        (cfg, gs.ScoreSimConfig(sybil_ihave_spam=True)),
        (cfg, gs.ScoreSimConfig(counter_dtype="float32",
                                mesh_message_deliveries_weight=-1.0)),
        (gs.GossipSimConfig(offsets=gs.make_gossip_offsets(
            T, 16, N, seed=7, paired=True), n_topics=T, paired_topics=True),
         gs.ScoreSimConfig(topic_score_cap=50.0)),
        (cfg, gs.ScoreSimConfig(), dl.DelayConfig(base=2, jitter=1,
                                                  k_slots=4)),
        (cfg, gs.ScoreSimConfig(), tl.TelemetryConfig()),
    ]


def test_config_fingerprint_is_equal_across_the_packages(ref):
    mine = [pck.config_fingerprint(*c)
            for c in _configs(pgs, pdl, ptl)]
    theirs = [ref.ck.config_fingerprint(*c)
              for c in _configs(ref.gs, ref.delays, ref.tl)]
    assert mine == theirs
    assert len(set(mine)) == len(mine)


def test_config_fingerprint_discriminates():
    offsets = pgs.make_gossip_offsets(T, 16, N, seed=7)
    cfg = pgs.GossipSimConfig(offsets=offsets, n_topics=T)
    sc = pgs.ScoreSimConfig()
    a = pck.config_fingerprint(cfg, sc)
    assert a == pck.config_fingerprint(cfg, sc)
    cfg2 = pgs.GossipSimConfig(offsets=cfg.offsets, n_topics=T, d=5)
    assert a != pck.config_fingerprint(cfg2, sc)
    assert a != pck.config_fingerprint(
        cfg, pgs.ScoreSimConfig(sybil_ihave_spam=True))


# -- rejections by name ----------------------------------------------------------

def _one_snapshot(tmp_path, **kw):
    ckc = _ckpt(pck, tmp_path, 5, **kw)
    _port_run(ckc)
    return os.path.join(ckc.directory, "sim-seg000002.ckpt"), ckc


def test_truncated_snapshot_rejected_by_name(tmp_path):
    path, _ = _one_snapshot(tmp_path)
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-64])
    with pytest.raises(ValueError, match="truncated snapshot"):
        pck.snapshot_read(path)


def test_bitflipped_snapshot_rejected_by_name(tmp_path):
    path, _ = _one_snapshot(tmp_path)
    blob = bytearray(open(path, "rb").read())
    blob[-100] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="CRC32 mismatch"):
        pck.snapshot_read(path)


def test_non_snapshot_file_rejected_by_name(tmp_path):
    p = tmp_path / "junk.ckpt"
    p.write_bytes(b'{"magic": "something-else"}\n')
    with pytest.raises(ValueError, match="not a checkpoint snapshot"):
        pck.snapshot_read(str(p))
    p.write_bytes(b"no header here")
    with pytest.raises(ValueError, match="no header line"):
        pck.snapshot_read(str(p))
    p.write_bytes(b"\xff\xfe\n")
    with pytest.raises(ValueError, match="unparseable header"):
        pck.snapshot_read(str(p))


def test_fingerprint_mismatch_rejected_through_runner(tmp_path):
    cfg, sc, *_ = gossip_family(None, "scored")
    fp = pck.config_fingerprint(cfg, sc)
    _, ckc = _one_snapshot(tmp_path, fingerprint=fp)
    bad = pck.CheckpointConfig(directory=ckc.directory, every=5,
                               fingerprint=fp + 1)
    with pytest.raises(ValueError, match="fingerprint"):
        _port_run(bad)


def test_layout_mismatch_rejected_by_name(tmp_path):
    """Resuming a 512-peer snapshot into a 256-peer sim names the leaf
    and the layout contract."""
    _, ckc = _one_snapshot(tmp_path)
    n2 = 256
    subs, topic, origin, tick0 = inputs(n=n2)
    cfg2 = pgs.GossipSimConfig(
        offsets=pgs.make_gossip_offsets(T, 16, n2, seed=7), n_topics=T)
    sc2 = pgs.ScoreSimConfig()
    params, state = pgs.make_gossip_sim(cfg2, subs, topic, origin, tick0,
                                        seed=3, score_cfg=sc2,
                                        track_first_tick=False, device=CPU)
    with pytest.raises(ValueError, match="peer-axis layout or sim "
                                         "configuration mismatch"):
        pck.ckpt_gossip_run(params, state, TICKS,
                            pgs.make_gossip_step(cfg2, sc2, device=CPU), ckc,
                            device=CPU)


def test_stale_horizon_rejected_by_name(tmp_path):
    _, ckc = _one_snapshot(tmp_path)
    with pytest.raises(ValueError, match="requested horizon"):
        _port_run(ckc, TICKS - 5)


def test_completed_aux_run_rejected_by_name(tmp_path):
    ckc = _ckpt(pck, tmp_path, 5)
    for attempt in range(2):
        _, _, params, state, step, _ = gossip_family(None, "curve")
        if attempt:
            with pytest.raises(ValueError, match="already complete"):
                pck.ckpt_gossip_run_curve(params, state, TICKS, step, ckc,
                                          M, device=CPU)
        else:
            pck.ckpt_gossip_run_curve(params, state, TICKS, step, ckc, M,
                                      device=CPU)


def test_missing_and_extra_leaves_rejected_by_name(tmp_path):
    path, ckc = _one_snapshot(tmp_path)
    header, by_key = pck.snapshot_read(path)
    missing = {k: v for k, v in by_key.items() if k != "state/mesh"}
    pck.snapshot_save(path, header, missing)
    with pytest.raises(ValueError, match="missing state leaf"):
        _port_run(ckc, TICKS + 5)
    extra = dict(by_key, **{"state/adv_line": np.zeros(3, np.uint32)})
    pck.snapshot_save(path, header, extra)
    with pytest.raises(ValueError, match="template lacks"):
        _port_run(ckc, TICKS + 5)


def test_unusable_delta_chain_missing_full_rejected(tmp_path):
    ckc = _ckpt(pck, tmp_path, 3, keep=10, full_every=4)
    _port_run(ckc)
    os.unlink(os.path.join(ckc.directory, "sim-seg000001.ckpt"))
    with pytest.raises(ValueError, match="unusable delta chain"):
        _port_run(ckc)


def test_unusable_delta_chain_corrupt_link_rejected(tmp_path):
    ckc = _ckpt(pck, tmp_path, 3, keep=10, full_every=4)
    _port_run(ckc)
    p2 = os.path.join(ckc.directory, "sim-seg000002.ckpt")
    blob = bytearray(open(p2, "rb").read())
    blob[-3] ^= 0x40
    open(p2, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="unusable delta chain"):
        _port_run(ckc)


def test_unusable_delta_chain_divergent_base_rejected(tmp_path):
    ckc = _ckpt(pck, tmp_path, 3, keep=10, full_every=4)
    _port_run(ckc)
    p2 = os.path.join(ckc.directory, "sim-seg000002.ckpt")
    h2, k2 = pck.snapshot_read(p2)
    key = sorted(k2)[0]
    arr = k2[key].copy()
    arr.reshape(-1).view(np.uint8)[0] ^= 1
    k2[key] = arr
    pck.snapshot_save(p2, h2, k2)
    with pytest.raises(ValueError, match="unusable delta chain"):
        _port_run(ckc)


@pytest.mark.parametrize("kw", [dict(directory=""), dict(every=-1),
                                dict(keep=0), dict(tag="a/b"),
                                dict(async_write=1), dict(full_every=0)])
def test_config_validations_keep_the_references_messages(ref, kw):
    args = dict(dict(directory="x"), **kw)
    with pytest.raises(ValueError) as want:
        ref.ck.CheckpointConfig(**args)
    with pytest.raises(ValueError) as got:
        pck.CheckpointConfig(**args)
    assert str(got.value) == str(want.value)


# -- the async writer and the delta chain ----------------------------------------

def test_async_write_bit_identity_and_kill_drain(tmp_path, uninterrupted):
    got = _port_run(_ckpt(pck, tmp_path / "a", 3, async_write=True))
    _assert_tree_equal(uninterrupted["state"], convert.state_to_numpy(got),
                       "async")
    ckc = _ckpt(pck, tmp_path / "b", 3, keep=10, full_every=3,
                async_write=True)
    pck.request_stop()
    try:
        with pytest.raises(pck.CheckpointInterrupt) as ei:
            _port_run(ckc)
        header, _ = pck.read_snapshot_chain(ckc.directory, "sim", 1)
        assert header["ticks_done"] == ei.value.ticks_done == 3
    finally:
        pck.clear_stop()
    got = _port_run(ckc)
    _assert_tree_equal(uninterrupted["state"], convert.state_to_numpy(got),
                       "resumed")


def test_async_write_failure_surfaces(tmp_path, monkeypatch):
    def boom(path, header, by_key):
        raise OSError("disk gone mid-write")
    monkeypatch.setattr(pck, "snapshot_save", boom)
    with pytest.raises(OSError, match="disk gone mid-write"):
        _port_run(_ckpt(pck, tmp_path, 3, async_write=True))


def test_delta_chain_headers_links_and_pruning(tmp_path, uninterrupted):
    """full_every=3 over 4 segments with keep=2: kinds full/delta/delta/
    full, each delta linked to the previous payload's CRC, the pruning
    floored at the governing full, the telemetry frames' aux riding the
    chain, and a resume from the mid-chain delta reconstructs it."""
    ckc = _ckpt(pck, tmp_path, 3, keep=2, full_every=3)
    got = _port_run(ckc)
    _assert_tree_equal(uninterrupted["state"], convert.state_to_numpy(got),
                       "delta")
    names = sorted(os.listdir(ckc.directory))
    assert names == [f"sim-seg{i:06d}.ckpt" for i in (1, 2, 3, 4)]
    headers = {}
    for name in names:
        h, _ = pck.snapshot_read(os.path.join(ckc.directory, name))
        headers[h["segment"]] = h
    assert [h["kind"] for h in headers.values()] == [
        "full", "delta", "delta", "full"]
    for i, h in headers.items():
        if h["kind"] == "delta":
            assert h["base_crc32"] == headers[i - 1]["payload_crc32"]
    h3, _ = pck.read_snapshot_chain(ckc.directory, "sim", 3)
    assert h3["ticks_done"] == 9
    os.unlink(os.path.join(ckc.directory, "sim-seg000004.ckpt"))
    got = _port_run(ckc)
    _assert_tree_equal(uninterrupted["state"], convert.state_to_numpy(got),
                       "resumed from the delta")
    tel = gossip_family(None, "telemetry")
    _, fr_want = ptl.telemetry_run(tel[2], tel[3], TICKS, tel[4])
    tel = gossip_family(None, "telemetry")
    _, fr = pck.ckpt_telemetry_run(
        tel[2], tel[3], TICKS, tel[4],
        _ckpt(pck, tmp_path / "tel", 3, keep=10, full_every=2,
              async_write=True), device=CPU)
    for key, want in convert.frame_to_numpy(fr_want).items():
        got_f = convert.frame_to_numpy(fr)[key]
        if want is not None:
            np.testing.assert_array_equal(got_f, want, err_msg=key)


# -- utils/checkpoint -----------------------------------------------------------------

def _utils_sim(scored=True):
    return gossip_family(None, "curve" if scored else "unscored")


@pytest.mark.parametrize("scored", [True, False])
def test_save_load_resume_is_bit_identical(scored, tmp_path):
    _, _, params, state, step, _ = _utils_sim(scored)
    mid = pgs.gossip_run(params, state, 5, step, device=CPU)
    path = str(tmp_path / "snap.npz")
    puc.save_state(path, mid)
    restored = puc.load_state(path, mid)
    _assert_tree_equal(convert.state_to_numpy(mid),
                       convert.state_to_numpy(restored), "restored")
    a = pgs.gossip_run(params, pgs.tree_copy(mid), 5, step, device=CPU)
    b = pgs.gossip_run(params, restored, 5, step, device=CPU)
    _assert_tree_equal(convert.state_to_numpy(a), convert.state_to_numpy(b),
                       "resumed")


def test_template_mismatch_rejected(tmp_path):
    _, _, _, state, _, _ = _utils_sim(True)
    path = str(tmp_path / "snap.npz")
    puc.save_state(path, state)
    _, _, _, other, _, _ = _utils_sim(False)
    with pytest.raises(ValueError):
        puc.load_state(path, other)


def test_legacy_zero_p3_leaves_load(ref, tmp_path):
    """A reference snapshot from before P3/P3b became None carries
    all-zero P3 leaves: it loads into a P3-free template; nonzero P3
    state is a config mismatch."""
    _, _, _, s_r, _, _ = gossip_family(ref, "curve")
    _, _, _, s_p, _, _ = gossip_family(None, "curve")
    z = np.zeros(np.asarray(s_r.scores.first_deliveries).shape, np.float32)
    legacy = s_r.replace(scores=s_r.scores.replace(
        mesh_deliveries=z, mesh_failure_penalty=z))
    ref.uc.save_state(str(tmp_path / "legacy.npz"), legacy)
    restored = puc.load_state(str(tmp_path / "legacy.npz"), s_p)
    assert restored.scores.mesh_deliveries is None
    bad = legacy.replace(scores=legacy.scores.replace(
        mesh_deliveries=np.full_like(z, 1.0)))
    ref.uc.save_state(str(tmp_path / "bad.npz"), bad)
    with pytest.raises(ValueError, match="lacks"):
        puc.load_state(str(tmp_path / "bad.npz"), s_p)


def _write_pre_gate_pipeline_snapshot(path, state):
    """A pre-gate-pipeline snapshot: no gates, backoff as int32 absolute
    expiry ticks."""
    by_key = puc.host_leaves(state)
    tick = int(state.tick)
    out = {}
    for k, arr in by_key.items():
        if k.startswith("gates"):
            continue
        if k.split("/")[-1].startswith("backoff"):
            arr = np.where(arr > 0, arr.astype(np.int32) + tick, 0)
        out[k] = arr
    with open(path, "wb") as f:
        f.write(puc.encode_npz(out))


def test_pre_gate_pipeline_snapshot_rejected_and_migrates(tmp_path):
    cfg, sc, params, state, step, _ = _utils_sim(True)
    mid = pgs.gossip_run(params, state, 5, step, device=CPU)
    path = str(tmp_path / "old.npz")
    _write_pre_gate_pipeline_snapshot(path, mid)
    with pytest.raises(ValueError, match="load_legacy_gossip_state"):
        puc.load_state(path, mid)
    migrated = puc.load_legacy_gossip_state(path, mid, cfg, sc, params)
    np.testing.assert_array_equal(migrated.backoff.numpy(),
                                  mid.backoff.numpy())
    for g_m, g_o in zip(migrated.gates, mid.gates):
        np.testing.assert_array_equal(g_m.numpy(), g_o.numpy())
    a = pgs.gossip_run(params, pgs.tree_copy(mid), 5, step, device=CPU)
    b = pgs.gossip_run(params, migrated, 5, step, device=CPU)
    _assert_tree_equal(convert.state_to_numpy(a), convert.state_to_numpy(b),
                       "migrated")


def test_snapshot_gates_fp_survives_roundtrip(tmp_path):
    cfg, _, _, state, _, _ = _utils_sim(True)
    path = str(tmp_path / "snap.npz")
    puc.save_state(path, state)
    subs, topic, origin, tick0 = inputs()
    _, tmpl2 = pgs.make_gossip_sim(
        cfg, subs, topic, origin, tick0, seed=3,
        score_cfg=pgs.ScoreSimConfig(gossip_threshold=-20.0),
        track_first_tick=False, device=CPU)
    with pytest.raises(ValueError, match="different"):
        puc.load_state(path, tmpl2)
    assert puc.load_state(path, state).gates_fp == state.gates_fp


def test_pre_ledger_scored_snapshot_zero_fills(tmp_path):
    _, _, params, state, step, _ = _utils_sim(True)
    mid = pgs.gossip_run(params, state, 5, step, device=CPU)
    assert int(mid.iwant_serves.abs().sum()) >= 0
    path = str(tmp_path / "snap.npz")
    puc.save_state(path, mid)
    with np.load(path) as z:
        kept = {k: z[k] for k in z.files if "iwant_serves" not in k}
    np.savez(str(tmp_path / "old.npz"), **kept)
    restored = puc.load_state(str(tmp_path / "old.npz"), mid)
    assert int(restored.iwant_serves.abs().max()) == 0
    np.testing.assert_array_equal(restored.have.numpy(), mid.have.numpy())


def test_widening_is_exact_or_refused():
    bits = np.array([0x3F80, 0x4000], dtype=np.uint16)      # 1.0, 2.0
    np.testing.assert_array_equal(puc._widen_exact(bits, "float32", "k"),
                                  np.array([1.0, 2.0], np.float32))
    np.testing.assert_array_equal(
        puc._widen_exact(np.array([1.0, 2.0], np.float32), "bfloat16", "k"),
        bits)
    with pytest.raises(ValueError, match="does not widen losslessly"):
        puc._widen_exact(np.array([1.1], np.float32), "bfloat16", "k")
    with pytest.raises(ValueError, match="does not widen losslessly"):
        puc._widen_exact(np.array([70000], np.int32), "int16", "k")


# -- ckptstat ----------------------------------------------------------------------

def _artifact(tmp_path, name, edit=None):
    import json
    with open(os.path.join(os.path.dirname(__file__), os.pardir,
                           "CKPT_r15.json")) as f:
        art = json.load(f)
    if edit:
        edit(art)
    path = tmp_path / name
    path.write_text(json.dumps(art))
    return str(path)


def _bad_digest(art):
    art["rows"][1]["digest"] = "0" * 16


def _slow(art):
    art["rows"][2]["wall_s"] = 100.0


def _no_single(art):
    art["rows"] = art["rows"][1:]


def _recompiled(art):
    art["rows"][1]["compiles"] = 3


def _no_shard_row(art):
    art["rows"] = art["rows"][:-1]


@pytest.mark.parametrize("edit,extra", [
    (None, []), (_bad_digest, []), (_slow, []), (_recompiled, []),
    (_no_single, []), (None, ["--overhead-slack", "1.2"]),
    (_no_shard_row, ["--check", "BASE"])])
def test_ckptstat_equals_the_tools_copy(edit, extra, tmp_path, capsys):
    """The port's ckptstat prints the same table and messages and exits
    with the same code as ``tools/ckptstat.py`` on the same artifact."""
    import tools.ckptstat as tck

    from go_libp2p_pubsub_tpu_torch import ckptstat
    path = _artifact(tmp_path, "a.json", edit)
    base = _artifact(tmp_path, "base.json")
    argv = [path] + [base if a == "BASE" else a for a in extra]
    out = []
    for mod in (tck, ckptstat):
        try:
            rc = mod.main(argv)
        except SystemExit as e:
            rc = e.code
        out.append((rc, capsys.readouterr()))
    (rc_t, io_t), (rc_p, io_p) = out
    assert rc_p == rc_t
    assert io_p.out == io_t.out and io_p.err == io_t.err
    assert rc_t == (0 if edit is None and not extra else
                    2 if edit is _no_single else 1)
