"""The port's trace-export pipeline (``interop/export.py``, the reading
half of ``interop/replay.py``, ``tracestat.py``, ``trace_export.py``)
against the JAX reference's.

Same configs, seeds and build inputs (numpy) go to both packages:

- every export stream (deliveries with and without churn, JOIN/LEAVE,
  GRAFT/PRUNE from a baseline, REJECT, DUPLICATE, ADD/REMOVE_PEER, the
  RPC streams), each from its own package's snapshots of the same faulted
  run, writes the reference's bytes; so do ``write_pb_trace``,
  ``write_json_trace`` and ``write_telemetry_frames``, and the paired
  streams (slot-B meshes, the slot-split IHAVE);
- the whole benchmark pipeline at 2,000 peers (not a multiple of 128)
  writes the same trace and frames bytes as the reference's XLA twin
  (``tests/torch_reference_gate.py`` ``reference_trace_export``), and the
  port's tracestat reports what ``tools/tracestat.py`` reports;
- the JAX package's ``tests/test_trace_export.py`` cases, through the
  port's modules: the pb round trip and reach, the ndjson shape, both
  sinks summarized alike, churn JOIN/LEAVE, GRAFT/PRUNE diffs, tracestat's
  exit-2 cases, per-topic percentiles, merged churn seams, REJECT at the
  exact acquisitions, DUPLICATE per tick equal to the telemetry counter
  (paired too), the 13 types of a faulted run and their replay to the
  final possession and mesh, the RPC stream's aggregates equal to the
  telemetry counters, DROP_RPC under faults, flood-publish capture, peer
  events under churn, the frames sidecar and ``--check`` gate, the paired
  probe; each tracestat report and exit code equal to
  ``tools/tracestat.py``'s on the same files.

Tolerance: exact (bytes; integer counts and percentiles).
"""

import contextlib
import dataclasses
import io
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import trace_export
from go_libp2p_pubsub_tpu_torch import tracestat as ts
from go_libp2p_pubsub_tpu_torch.interop import export as ex
from go_libp2p_pubsub_tpu_torch.interop import replay as rp
from go_libp2p_pubsub_tpu_torch.models import faults as pfl
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import telemetry as ptl
from go_libp2p_pubsub_tpu_torch.pb import trace as tr
from go_libp2p_pubsub_tpu_torch.pb.proto import read_delimited, write_delimited
from go_libp2p_pubsub_tpu_torch.pb.trace import TraceType
from test_torch_knobs import one_thread  # noqa: F401  (autouse)
from torch_ref import imported_reference

ROOT = Path(__file__).resolve().parents[1]
NS = ex.NS_PER_TICK


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.interop.export as rex
        import go_libp2p_pubsub_tpu.models.faults as rfl
        import go_libp2p_pubsub_tpu.models.telemetry as rtl
        r.export, r.faults, r.telemetry = rex, rfl, rtl
        yield r


def _bytes(events) -> bytes:
    return b"".join(write_delimited(e) for e in events)


def _rbytes(ref_events) -> bytes:
    """The reference's events as pb bytes (its own codec)."""
    from go_libp2p_pubsub_tpu.pb.proto import write_delimited as rw
    return b"".join(rw(e) for e in ref_events)


def _port_tracestat(*args) -> tuple:
    """The port's tracestat CLI in process: (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            ts.main([str(a) for a in args])
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
    return code, out.getvalue(), err.getvalue()


def _tools_tracestat(*args) -> tuple:
    """The JAX package's ``tools/tracestat.py``: (exit code, stdout,
    stderr)."""
    r = subprocess.run([sys.executable, "tools/tracestat.py",
                        *[str(a) for a in args]], capture_output=True,
                       text=True, cwd=str(ROOT))
    return r.returncode, r.stdout, r.stderr


def _both_tracestat(*args) -> tuple:
    """Both CLIs on the same arguments: the same exit code, stdout and
    stderr; the port's."""
    got, want = _port_tracestat(*args), _tools_tracestat(*args)
    assert got == want, (got, want)
    return got


def _ring_inputs(n, t, m, seed, tick_hi, paired=False):
    rng = np.random.default_rng(seed)
    subs = np.zeros((n, t), dtype=bool)
    own = np.arange(n) % t
    subs[np.arange(n), own] = True
    if paired:
        subs[np.arange(n), (own + t // 2) % t] = True
    topic = rng.integers(0, t, m)
    origin = rng.integers(0, n // t, m) * t + topic
    ticks = rng.integers(0, tick_hi, m).astype(np.int32)
    return rng, subs, topic, origin, ticks


# -- the faulted run both packages export -------------------------------------

def _faulted_build(gs_, fl_, device=None, T=16, n=200, t=2, m=10):
    """The reference test's ``faulted_run`` sim in one package: scored,
    two invalid messages from sybil origins, two down intervals, 5% link
    loss."""
    cfg = gs_.GossipSimConfig(
        offsets=gs_.make_gossip_offsets(t, 16, n, seed=4), n_topics=t)
    rng, subs, topic, origin, ticks = _ring_inputs(n, t, m, 4, 6)
    invalid = np.zeros(m, dtype=bool)
    invalid[:2] = True
    sybil = np.zeros(n, dtype=bool)
    sybil[origin[:2]] = True
    sc = gs_.ScoreSimConfig()
    sched = fl_.FaultSchedule(
        n_peers=n, horizon=T, down_intervals=((5, 3, 8), (11, 2, 12)),
        drop_prob=0.05, seed=9)
    kw = {} if device is None else dict(device=device)
    params, state = gs_.make_gossip_sim(
        cfg, subs, topic, origin, ticks, score_cfg=sc, sybil=sybil,
        msg_invalid=invalid, fault_schedule=sched, **kw)
    return dict(cfg=cfg, sc=sc, params=params, state=state, sched=sched,
                subs=subs, topic=topic, origin=origin, ticks=ticks,
                invalid=invalid, peer_topic=(np.arange(n) % t).astype(
                    np.int64), n=n, m=m, T=T)


def _faulted_port(T=16):
    r = _faulted_build(pgs, pfl, "cpu", T=T)
    cfg, sc, p, s = r["cfg"], r["sc"], r["params"], r["state"]
    out, snaps = pgs.gossip_run_acq_snapshots(
        p, pgs.tree_copy(s), T, pgs.make_gossip_step(cfg, sc, device="cpu"),
        device="cpu")
    out2, rsnaps = pgs.gossip_run_rpc_snapshots(
        p, pgs.tree_copy(s), T,
        pgs.make_gossip_step(cfg, sc, device="cpu", rpc_probe=True),
        device="cpu")
    assert torch.equal(out.have, out2.have)      # the probe only reads
    r.update(out=out, snaps=ex.host_snapshots(snaps), rsnaps=rsnaps)
    return r


@pytest.fixture(scope="module")
def faulted(ref):
    """Both packages' faulted runs: the reference's (numpy snapshots) and
    the port's (host snapshots; the probe dict as tensors)."""
    import jax

    rr = _faulted_build(ref.gs, ref.faults, T=16)
    cfg, sc, p, s = rr["cfg"], rr["sc"], rr["params"], rr["state"]
    out, snaps = ref.gs.gossip_run_acq_snapshots(
        p, ref.gs.tree_copy(s), 16, jax.jit(ref.gs.make_gossip_step(cfg, sc)))
    _, rsnaps = ref.gs.gossip_run_rpc_snapshots(
        p, ref.gs.tree_copy(s), 16,
        jax.jit(ref.gs.make_gossip_step(cfg, sc, rpc_probe=True)))
    rr.update(out=out, snaps={k: np.asarray(v) for k, v in snaps.items()},
              rsnaps={k: np.asarray(v) for k, v in rsnaps.items()})
    return rr, _faulted_port()


def _streams(mod, run, ftm):
    """Every export stream of ``mod`` (either package's export module)
    over one package's run."""
    cfg, sched, n = run["cfg"], run["sched"], run["n"]
    topic, pt = run["topic"], run["peer_topic"]
    snaps, rsnaps = run["snaps"], run["rsnaps"]
    return {
        "deliveries": lambda: mod.events_from_sim(
            ftm, topic, run["origin"], run["ticks"]),
        "deliveries_churn": lambda: mod.events_from_sim(
            ftm, topic, run["origin"], run["ticks"], fault_schedule=sched,
            peer_topic=pt),
        "churn": lambda: mod.churn_events(sched, pt),
        "mesh": lambda: mod.mesh_trace_events(snaps["mesh"], cfg.offsets,
                                              pt),
        "mesh_baseline": lambda: mod.mesh_trace_events(
            snaps["mesh"][4:], cfg.offsets, pt, start_tick=4,
            initial_mesh=snaps["mesh"][3]),
        "reject": lambda: mod.reject_events(snaps["have"], run["invalid"],
                                            topic),
        "reject_baseline": lambda: mod.reject_events(
            snaps["have"][5:], run["invalid"], topic, start_tick=5,
            initial_have=snaps["have"][4], n_true=n - 3),
        "duplicate": lambda: mod.duplicate_events(
            snaps["have"], snaps["mesh"], cfg.offsets, topic),
        "duplicate_baseline": lambda: mod.duplicate_events(
            snaps["have"][6:], snaps["mesh"][6:], cfg.offsets, topic,
            start_tick=6, initial_have=snaps["have"][5],
            initial_mesh=snaps["mesh"][5]),
        "peers": lambda: mod.peer_events(cfg.offsets, n,
                                         fault_schedule=sched),
        "rpc": lambda: mod.rpc_events(rsnaps, cfg.offsets, topic, pt),
        "rpc_window": lambda: mod.rpc_events(
            {k: v[2:6] for k, v in rsnaps.items()}, cfg.offsets, topic, pt,
            start_tick=2, n_true=n),
    }


STREAMS = sorted(_streams(ex, {k: None for k in (
    "cfg", "sched", "n", "topic", "peer_topic", "snaps", "rsnaps")}, None))


@pytest.mark.parametrize("stream", STREAMS)
def test_each_stream_writes_the_references_bytes(ref, faulted, stream):
    rr, pr = faulted
    m = pr["m"]
    ftm_r = np.asarray(ref.gs.first_tick_matrix(rr["out"], m))
    ftm_p = pgs.first_tick_matrix(pr["out"], m).numpy()
    want = _rbytes(_streams(ref.export, rr, ftm_r)[stream]())
    got = _bytes(_streams(ex, pr, ftm_p)[stream]())
    assert got == want
    if stream not in ("churn",):
        assert len(got) > 0


def _merged(mod, run, m):
    ftm = (np.asarray(run["ftm"]))
    s = _streams(mod, run, ftm)
    return mod.merge_event_streams(*(s[k]() for k in (
        "deliveries_churn", "mesh", "reject", "duplicate", "peers", "rpc")))


def test_writers_write_the_references_bytes(ref, faulted, tmp_path):
    """The merged 13-type stream through ``write_pb_trace`` and
    ``write_json_trace``, and a telemetry run's frames through
    ``write_telemetry_frames``: the reference's files byte for byte."""
    import jax

    rr, pr = faulted
    m, T = pr["m"], pr["T"]
    rr = dict(rr, ftm=ref.gs.first_tick_matrix(rr["out"], m))
    pr = dict(pr, ftm=pgs.first_tick_matrix(pr["out"], m).numpy())
    merged_r, merged_p = _merged(ref.export, rr, m), _merged(ex, pr, m)
    assert {e.type for e in merged_p} == set(TraceType.NAMES)
    files = {}
    for name, mod, evs in (("r", ref.export, merged_r), ("p", ex, merged_p)):
        mod.write_pb_trace(str(tmp_path / f"{name}.pb"), evs)
        mod.write_json_trace(str(tmp_path / f"{name}.json"), evs)
    tel = dict(latency_hist=True, latency_buckets=16)
    _, counts_r, frames_r = ref.telemetry.telemetry_run_curve(
        rr["params"], ref.gs.tree_copy(rr["state"]), T,
        jax.jit(ref.gs.make_gossip_step(
            rr["cfg"], rr["sc"],
            telemetry=ref.telemetry.TelemetryConfig(**tel))), m)
    ref.export.write_telemetry_frames(
        str(tmp_path / "r_frames.json"), frames_r,
        ref.telemetry.TelemetryConfig(**tel), counts=np.asarray(counts_r),
        publish_tick=rr["ticks"], msg_topic=rr["topic"])
    _, counts_p, frames_p = ptl.telemetry_run_curve(
        pr["params"], pgs.tree_copy(pr["state"]), T,
        pgs.make_gossip_step(pr["cfg"], pr["sc"], device="cpu",
                             telemetry=ptl.TelemetryConfig(**tel)), m)
    ex.write_telemetry_frames(
        str(tmp_path / "p_frames.json"), frames_p,
        ptl.TelemetryConfig(**tel), counts=counts_p,
        publish_tick=pr["ticks"], msg_topic=pr["topic"])
    for suffix in (".pb", ".json", "_frames.json"):
        files[suffix] = [(tmp_path / f"{k}{suffix}").read_bytes()
                         for k in ("r", "p")]
        assert files[suffix][0] == files[suffix][1], suffix
    with pytest.raises(ValueError, match="latency_hist"):
        ex.write_telemetry_frames(
            str(tmp_path / "x.json"),
            dataclasses.replace(frames_p, latency_hist=None),
            ptl.TelemetryConfig())
    with pytest.raises(ValueError, match="publish_tick"):
        ex.write_telemetry_frames(
            str(tmp_path / "x.json"), frames_p,
            ptl.TelemetryConfig(**tel), counts=counts_p)


def _paired_both(ref, T=10):
    """The reference test's paired probe run in both packages."""
    import jax

    n, t, m = 120, 4, 8
    out = []
    for gs_, dev in ((ref.gs, None), (pgs, "cpu")):
        cfg = gs_.GossipSimConfig(
            offsets=gs_.make_gossip_offsets(t, 16, n, seed=3, paired=True),
            n_topics=t, paired_topics=True)
        _, subs, topic, origin, ticks = _ring_inputs(n, t, m, 3, 4,
                                                     paired=True)
        kw = {} if dev is None else dict(device=dev)
        params, state = gs_.make_gossip_sim(cfg, subs, topic, origin,
                                            ticks, **kw)
        step = gs_.make_gossip_step(cfg, rpc_probe=True, **kw)
        step_acq = gs_.make_gossip_step(cfg, **kw)
        if dev is None:
            step, step_acq = jax.jit(step), jax.jit(step_acq)
            _, rs = gs_.gossip_run_rpc_snapshots(params, gs_.tree_copy(state),
                                                 T, step)
            _, ac = gs_.gossip_run_acq_snapshots(params, state, T, step_acq)
            rs = {k: np.asarray(v) for k, v in rs.items()}
            ac = {k: np.asarray(v) for k, v in ac.items()}
            slot_b = np.asarray(params.slot_b_words)
        else:
            _, rs = gs_.gossip_run_rpc_snapshots(
                params, gs_.tree_copy(state), T, step, device=dev)
            _, ac = gs_.gossip_run_acq_snapshots(params, state, T, step_acq,
                                                 device=dev)
            slot_b = params.slot_b_words
        own = np.arange(n) % t
        out.append(dict(cfg=cfg, rsnaps=rs, snaps=ac, slot_b=slot_b,
                        topic=topic, pt=own.astype(np.int64),
                        pt_b=((own + t // 2) % t).astype(np.int64)))
    return out


def test_paired_streams_write_the_references_bytes(ref):
    want, got = _paired_both(ref)
    for mod, run, to_bytes, res in ((ref.export, want, _rbytes, []),
                                    (ex, got, _bytes, [])):
        cfg = run["cfg"]
        res.append(to_bytes(mod.rpc_events(
            run["rsnaps"], cfg.offsets, run["topic"], run["pt"],
            peer_topic_b=run["pt_b"], slot_b_words=run["slot_b"])))
        res.append(to_bytes(mod.duplicate_events(
            run["snaps"]["have"], run["snaps"]["mesh"], cfg.offsets,
            run["topic"], mesh_b_snapshots=run["snaps"]["mesh_b"],
            slot_b_words=run["slot_b"])))
        res.append(to_bytes(mod.mesh_trace_events(
            run["snaps"]["mesh_b"], cfg.offsets, run["pt_b"])))
        run["res"] = res
    assert got["res"] == want["res"]
    assert all(got["res"])


def test_whole_pipeline_at_a_ragged_size_writes_the_references_bytes(
        tmp_path):
    """The benchmark's pipeline at 2,000 peers (100 topics, the
    benchmark's draws; 2,000 is not a multiple of 128): the port's CPU
    run writes the trace and frames bytes of the reference's XLA twin,
    and its tracestat report (with ``--check OBS_r10.json``) is
    ``tools/tracestat.py``'s."""
    from torch_reference_gate import reference_trace_export

    n = 2_000
    (tmp_path / "r").mkdir()
    want = reference_trace_export(n, str(tmp_path / "r"))
    rows = trace_export.export(trace_export.collect("cpu", n),
                               tmp_path / "p")
    assert rows["sha256"] == want["sha256"]
    assert rows["types"] == want["types"] and rows["n_types"] == 13
    assert Path(rows["trace"]).read_bytes() == Path(
        want["trace"]).read_bytes()
    assert Path(rows["frames"]).read_bytes() == Path(
        want["frames"]).read_bytes()
    assert rows["check_problems"] == []
    code, out, _ = _both_tracestat(rows["trace"], "--frames",
                                   rows["frames"], "--json")
    assert code == 0 and json.loads(out) == rows["tracestat"]
    code, _, err = _both_tracestat(rows["trace"], "--frames",
                                   rows["frames"], "--check",
                                   ROOT / "OBS_r10.json")
    assert code == 0 and "13/13" in err
    assert rows["receive_launches"] == {} and rows["peak_bytes"] is None


# -- the reference's test_trace_export.py cases, through the port -------------

def run_sim():
    n, t, m = 600, 3, 8
    cfg = pgs.GossipSimConfig(offsets=pgs.make_gossip_offsets(t, 16, n,
                                                              seed=6),
                              n_topics=t)
    _, subs, topic, origin, ticks = _ring_inputs(n, t, m, 6, 10)
    params, state = pgs.make_gossip_sim(cfg, subs, topic, origin, ticks,
                                        device="cpu")
    out = pgs.gossip_run(params, state, 30,
                         pgs.make_gossip_step(cfg, device="cpu"),
                         device="cpu")
    ft = pgs.first_tick_matrix(out, m).numpy()
    reach = pgs.reach_counts(params, out).numpy()
    return ft, topic, origin, ticks, reach


def _read_all(path):
    buf = open(path, "rb").read()
    pos, parsed = 0, []
    while pos < len(buf):
        evt, pos = read_delimited(tr.TraceEvent, buf, pos)
        parsed.append(evt)
    return parsed


def test_pb_trace_roundtrip(tmp_path):
    ft, topic, origin, ticks, reach = run_sim()
    events = ex.events_from_sim(ft, topic, origin, ticks)
    path = str(tmp_path / "trace.pb")
    ex.write_pb_trace(path, events)
    parsed = _read_all(path)
    assert len(parsed) == len(events)
    assert len(rp.load_pb_trace(path)) == len(events)
    pubs = [e for e in parsed if e.type == TraceType.PUBLISH_MESSAGE]
    assert len(pubs) == len(topic)
    for j in range(len(topic)):
        n_deliver = sum(1 for e in parsed
                        if e.type == TraceType.DELIVER_MESSAGE
                        and e.deliver_message.message_id == ex.msg_id(j))
        assert n_deliver == reach[j]
    deliver_ts = [e.timestamp for e in parsed
                  if e.type == TraceType.DELIVER_MESSAGE]
    assert deliver_ts == sorted(deliver_ts)


def test_json_trace_has_reference_shape(tmp_path):
    ft, topic, origin, ticks, _ = run_sim()
    events = ex.events_from_sim(ft, topic, origin, ticks)
    path = str(tmp_path / "trace.json")
    ex.write_json_trace(path, events)
    lines = [json.loads(line) for line in open(path)]
    assert len(lines) == len(events)
    assert {ln["type"] for ln in lines} == {
        int(TraceType.PUBLISH_MESSAGE), int(TraceType.DELIVER_MESSAGE)}
    deliver = next(ln for ln in lines
                   if ln["type"] == int(TraceType.DELIVER_MESSAGE))
    assert {"message_id", "topic"} <= set(deliver["deliver_message"])


def test_tracestat_summarizes_both_formats(tmp_path):
    """Both sinks summarize alike, and the port's tracestat reports what
    ``tools/tracestat.py`` reports on each file."""
    n, t, m = 300, 3, 6
    cfg = pgs.GossipSimConfig(offsets=pgs.make_gossip_offsets(t, 16, n,
                                                              seed=2),
                              n_topics=t)
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    rng = np.random.default_rng(2)
    topic = rng.integers(0, t, m)
    origin = rng.integers(0, n // t, m) * t + topic
    ticks = np.zeros(m, dtype=np.int32)
    params, state = pgs.make_gossip_sim(cfg, subs, topic, origin, ticks,
                                        device="cpu")
    out = pgs.gossip_run(params, state, 25,
                         pgs.make_gossip_step(cfg, device="cpu"),
                         device="cpu")
    evs = ex.events_from_sim(pgs.first_tick_matrix(out, m).numpy(), topic,
                             origin, ticks)
    pj, pp = tmp_path / "t.json", tmp_path / "t.pb"
    ex.write_json_trace(str(pj), evs)
    ex.write_pb_trace(str(pp), evs)
    outs = []
    for p in (pj, pp):
        code, text, _ = _both_tracestat(p, "--json")
        assert code == 0
        outs.append(json.loads(text))
        assert _both_tracestat(p)[0] == 0       # the text report too
    assert outs[0] == outs[1]
    assert outs[0]["messages_published"] == m
    assert outs[0]["total_deliveries"] == m * (n // t)


def test_churn_run_exports_join_leave_events(tmp_path):
    n, t, m = 600, 3, 8
    cfg = pgs.GossipSimConfig(offsets=pgs.make_gossip_offsets(t, 16, n,
                                                              seed=6),
                              n_topics=t)
    _, subs, topic, origin, ticks = _ring_inputs(n, t, m, 6, 10)
    sched = pfl.FaultSchedule(n_peers=n, horizon=30,
                              down_intervals=[(9, 2, 12), (12, 4, 30)],
                              seed=3)
    params, state = pgs.make_gossip_sim(cfg, subs, topic, origin, ticks,
                                        fault_schedule=sched, device="cpu")
    out = pgs.gossip_run(params, state, 30,
                         pgs.make_gossip_step(cfg, device="cpu"),
                         device="cpu")
    ft = pgs.first_tick_matrix(out, m).numpy()
    events = ex.events_from_sim(ft, topic, origin, ticks,
                                fault_schedule=sched,
                                peer_topic=np.arange(n) % t)
    path = str(tmp_path / "churn.pb")
    ex.write_pb_trace(path, events)
    parsed = _read_all(path)
    leaves = [e for e in parsed if e.type == TraceType.LEAVE]
    joins = [e for e in parsed if e.type == TraceType.JOIN]
    assert [(e.peer_id, e.timestamp) for e in leaves] == [
        (b"sim-9", 2 * NS), (b"sim-12", 4 * NS)]
    assert [(e.peer_id, e.timestamp) for e in joins] == [(b"sim-9", 12 * NS)]
    assert leaves[0].leave.topic == f"topic-{9 % t}"
    ts_ = [e.timestamp for e in parsed]
    assert ts_ == sorted(ts_)
    assert (ft[12] < 0).all()
    with pytest.raises(ValueError, match="peer_topic"):
        ex.events_from_sim(ft, topic, origin, ticks, fault_schedule=sched)


def test_mesh_snapshot_diff_emits_graft_prune_events(tmp_path):
    n, t, m = 600, 3, 8
    cfg = pgs.GossipSimConfig(offsets=pgs.make_gossip_offsets(t, 16, n,
                                                              seed=6),
                              n_topics=t)
    _, subs, topic, origin, ticks = _ring_inputs(n, t, m, 6, 10)
    params, state = pgs.make_gossip_sim(cfg, subs, topic, origin, ticks,
                                        device="cpu")
    init_mesh = state.mesh
    fin, snaps = pgs.gossip_run_mesh_snapshots(
        params, state, 30, pgs.make_gossip_step(cfg, device="cpu"),
        device="cpu")
    assert tuple(snaps["mesh"].shape) == (30, n)
    events = ex.mesh_trace_events(snaps["mesh"], cfg.offsets,
                                  np.arange(n) % t, initial_mesh=init_mesh)
    grafts = [e for e in events if e.type == TraceType.GRAFT]
    prunes = [e for e in events if e.type == TraceType.PRUNE]
    assert grafts and grafts[0].graft.peer_id.startswith(b"sim-")
    net = Counter()
    for e in events:
        net[e.peer_id] += 1 if e.type == TraceType.GRAFT else -1
    deg = pgs.mesh_degrees(fin).numpy()
    for p in range(n):
        assert net[b"sim-%d" % p] == deg[p]
    np.testing.assert_array_equal(
        rp.mesh_from_trace(events, cfg.offsets, n), ex.host_array(fin.mesh))
    merged = ex.merge_event_streams(
        ex.events_from_sim(pgs.first_tick_matrix(fin, m).numpy(), topic,
                           origin, ticks), events)
    pj, pp = tmp_path / "mesh.json", tmp_path / "mesh.pb"
    ex.write_json_trace(str(pj), merged)
    ex.write_pb_trace(str(pp), merged)
    outs = [json.loads(_both_tracestat(p, "--json")[1]) for p in (pj, pp)]
    assert outs[0] == outs[1]
    assert outs[0]["events"]["GRAFT"] == len(grafts)
    assert outs[0]["events"]["PRUNE"] == len(prunes)
    assert outs[0]["control"]["total_events"] == len(grafts) + len(prunes)


def test_tracestat_exit_codes_match_tools_tracestat(tmp_path):
    """Exit 2 with the path named on an empty, an unparseable (pb and
    ndjson) or an event-free file, and on an empty or histogram-free frames
    sidecar; an unreadable baseline too; the same messages as
    ``tools/tracestat.py``."""
    empty = tmp_path / "empty.json"
    empty.write_bytes(b"")
    bad_pb = tmp_path / "garbage.pb"
    bad_pb.write_bytes(b"\xff" * 16)
    bad_json = tmp_path / "garbage.json"
    bad_json.write_text('{"type": 0}\nnot json at all {{{\n')
    blank = tmp_path / "blank.json"
    blank.write_text("\n\n")
    good = tmp_path / "good.pb"
    ex.write_pb_trace(str(good), [tr.TraceEvent(
        type=TraceType.PUBLISH_MESSAGE, peer_id=b"sim-0", timestamp=0,
        publish_message=tr.PublishMessageEv(message_id=b"msg-0",
                                            topic="topic-0"))])
    nohist = tmp_path / "nohist.json"
    nohist.write_text(json.dumps({"ns_per_tick": NS}))
    cases = [((empty,), "empty trace file"), ((bad_pb,), "unparseable"),
             ((bad_json,), "unparseable"), ((blank,), "unparseable"),
             ((good, "--frames", empty), "empty frames file"),
             ((good, "--frames", nohist), "latency_hist"),
             ((good, "--check", tmp_path / "missing.json"),
              "unreadable baseline")]
    for args, msg in cases:
        code, _, err = _both_tracestat(*args)
        assert code == 2 and msg in err, (args, err)


def test_tracestat_per_topic_latency_percentiles(tmp_path):
    events = []
    for j, (tpc, lat) in enumerate((("a", 1), ("a", 1), ("b", 3),
                                    ("b", 3))):
        events.append(tr.TraceEvent(
            type=TraceType.PUBLISH_MESSAGE, peer_id=b"sim-0",
            timestamp=j * NS, publish_message=tr.PublishMessageEv(
                message_id=b"msg-%d" % j, topic=f"topic-{tpc}")))
        events.append(tr.TraceEvent(
            type=TraceType.DELIVER_MESSAGE, peer_id=b"sim-1",
            timestamp=(j + lat) * NS, deliver_message=tr.DeliverMessageEv(
                message_id=b"msg-%d" % j, topic=f"topic-{tpc}")))
    path = tmp_path / "topics.pb"
    ex.write_pb_trace(str(path), events)
    code, out, _ = _both_tracestat(path, "--json")
    assert code == 0
    by_topic = json.loads(out)["latency_by_topic_ns"]
    assert by_topic["topic-a"]["p50"] == by_topic["topic-a"]["p99"] == NS
    assert by_topic["topic-b"]["p50"] == 3 * NS
    assert by_topic["topic-a"]["count"] == 2


def test_adjacent_churn_intervals_merge_in_trace():
    sched = pfl.FaultSchedule(
        n_peers=8, horizon=40,
        down_intervals=[(2, 3, 10), (2, 10, 20), (5, 30, 40)])
    evs = ex.churn_events(sched, np.zeros(8, dtype=np.int64))
    assert [(e.type, e.peer_id, e.timestamp // NS) for e in evs] == [
        (TraceType.LEAVE, b"sim-2", 3), (TraceType.JOIN, b"sim-2", 20),
        (TraceType.LEAVE, b"sim-5", 30)]


def test_reject_events_match_invalid_acquisitions():
    n, t, m = 400, 2, 8
    cfg = pgs.GossipSimConfig(offsets=pgs.make_gossip_offsets(t, 16, n,
                                                              seed=4),
                              n_topics=t)
    _, subs, topic, origin, ticks = _ring_inputs(n, t, m, 4, 8)
    invalid = np.zeros(m, dtype=bool)
    invalid[:3] = True
    sybil = np.zeros(n, dtype=bool)
    sybil[origin[:3]] = True
    sc = pgs.ScoreSimConfig()
    params, state = pgs.make_gossip_sim(
        cfg, subs, topic, origin, ticks, score_cfg=sc, sybil=sybil,
        msg_invalid=invalid, device="cpu")
    _, snaps = pgs.gossip_run_acq_snapshots(
        params, state, 20, pgs.make_gossip_step(cfg, sc, device="cpu"),
        device="cpu")
    have = ex.host_array(snaps["have"])
    events = ex.reject_events(snaps["have"], invalid, topic)
    got = {(e.peer_id, e.reject_message.message_id, e.timestamp // NS)
           for e in events}
    want = set()
    prev = np.zeros_like(have[0])
    for k in range(have.shape[0]):
        new = have[k] & ~prev
        for mm in np.flatnonzero(invalid):
            w, b = divmod(int(mm), 32)
            for p in np.flatnonzero((new[w] >> np.uint32(b)) & 1):
                want.add((b"sim-%d" % p, b"msg-%d" % mm, k))
        prev = have[k]
    assert got == want and len(events) == len(got) > 0


def _dup_case(paired: bool):
    n, m, n_ticks = 400, 8, 20
    if paired:
        t = 4
        cfg = pgs.GossipSimConfig(
            offsets=pgs.make_gossip_offsets(t, 8, n, seed=4, paired=True),
            n_topics=t, paired_topics=True, d=3, d_lo=2, d_hi=6, d_score=2,
            d_out=1, d_lazy=0, gossip_factor=0.0)
        own = np.arange(n) % t
        second = (own + t // 2) % t
        subs = np.zeros((n, t), dtype=bool)
        subs[np.arange(n), own] = True
        subs[np.arange(n), second] = True
        rng = np.random.default_rng(4)
        topic = rng.integers(0, t, m)
        members = [np.flatnonzero((own == tau) | (second == tau))
                   for tau in range(t)]
        origin = np.array([rng.choice(members[tau]) for tau in topic])
        ticks = rng.integers(0, 8, m).astype(np.int32)
    else:
        t = 2
        cfg = pgs.GossipSimConfig(
            offsets=pgs.make_gossip_offsets(t, 16, n, seed=4), n_topics=t,
            d_lazy=0, gossip_factor=0.0)
        _, subs, topic, origin, ticks = _ring_inputs(n, t, m, 4, 8)
    return cfg, subs, topic, origin, ticks, n_ticks


@pytest.mark.parametrize("paired", [False, True], ids=["one", "paired"])
def test_duplicate_events_match_telemetry_dup_counter(paired):
    cfg, subs, topic, origin, ticks, n_ticks = _dup_case(paired)
    params, state = pgs.make_gossip_sim(cfg, subs, topic, origin, ticks,
                                        device="cpu")
    _, frames = ptl.telemetry_run(
        params, pgs.tree_copy(state), n_ticks, pgs.make_gossip_step(
            cfg, device="cpu", telemetry=ptl.TelemetryConfig(
                wire=False, scores=False)))
    dup = ptl.frames_to_arrays(frames)["dup_suppressed"]
    _, snaps = pgs.gossip_run_acq_snapshots(
        params, state, n_ticks, pgs.make_gossip_step(cfg, device="cpu"),
        device="cpu")
    kw = (dict(mesh_b_snapshots=snaps["mesh_b"],
               slot_b_words=params.slot_b_words) if paired else {})
    events = ex.duplicate_events(snaps["have"], snaps["mesh"], cfg.offsets,
                                 topic, **kw)
    per_tick = np.zeros(n_ticks, dtype=np.int64)
    for e in events:
        assert e.duplicate_message.received_from.startswith(b"sim-")
        per_tick[e.timestamp // NS] += 1
    np.testing.assert_array_equal(per_tick[1:], dup[1:])
    assert per_tick.sum() > 0
    if paired:
        with pytest.raises(ValueError, match="slot_b_words"):
            ex.duplicate_events(snaps["have"], snaps["mesh"], cfg.offsets,
                                topic, mesh_b_snapshots=snaps["mesh_b"])
        with pytest.raises(ValueError, match="mesh_b_snapshots"):
            ex.duplicate_events(snaps["have"], snaps["mesh"], cfg.offsets,
                                topic, slot_b_words=params.slot_b_words)


def _all_13(run):
    m = run["m"]
    return _merged(ex, dict(run, ftm=pgs.first_tick_matrix(
        run["out"], m).numpy()), m)


def test_full_faulted_run_exports_all_13_types_and_replays(tmp_path):
    """The acceptance pin: one faulted run exports every one of the 13
    event types; written by ``write_pb_trace`` and read back by the port's
    ``replay`` reading half, the event stream alone rebuilds the final
    possession and mesh."""
    run = _faulted_port()
    merged = _all_13(run)
    assert {TraceType.NAMES[e.type] for e in merged} == set(
        TraceType.NAMES.values())
    path = tmp_path / "full13.pb"
    ex.write_pb_trace(str(path), merged)
    evs = rp.load_pb_trace(str(path))
    assert len(evs) == len(merged)
    n, m = run["n"], run["m"]
    hw = ex.host_array(run["out"].have)
    have_sim = np.zeros((n, m), dtype=bool)
    for j in range(m):
        w, b = divmod(j, 32)
        have_sim[:, j] = (hw[w] >> np.uint32(b)) & 1
    np.testing.assert_array_equal(rp.possession_from_trace(evs, n, m),
                                  have_sim)
    np.testing.assert_array_equal(
        rp.mesh_from_trace(evs, run["cfg"].offsets, n),
        ex.host_array(run["out"].mesh))


def test_rpc_stream_aggregates_equal_telemetry_counters():
    n, t, m, T = 200, 2, 8, 14
    cfg = pgs.GossipSimConfig(offsets=pgs.make_gossip_offsets(t, 16, n,
                                                              seed=4),
                              n_topics=t)
    _, subs, topic, origin, ticks = _ring_inputs(n, t, m, 4, 6)
    params, state = pgs.make_gossip_sim(cfg, subs, topic, origin, ticks,
                                        device="cpu")
    _, frames = ptl.telemetry_run(
        params, pgs.tree_copy(state), T, pgs.make_gossip_step(
            cfg, device="cpu", telemetry=ptl.TelemetryConfig(
                wire=False, scores=False, mesh=False)))
    arrs = ptl.frames_to_arrays(frames)
    _, rsnaps = pgs.gossip_run_rpc_snapshots(
        params, pgs.tree_copy(state), T,
        pgs.make_gossip_step(cfg, device="cpu", rpc_probe=True),
        device="cpu")
    events = ex.rpc_events(rsnaps, cfg.offsets, topic,
                           (np.arange(n) % t).astype(np.int64))
    agg = {k: np.zeros(T, dtype=np.int64) for k in (
        "msgs", "ihave_rpcs", "ihave_ids", "iwant_rpcs", "iwant_ids",
        "graft", "prune")}
    n_send = n_recv = 0
    for e in events:
        if e.type == TraceType.RECV_RPC:
            n_recv += 1
            continue
        if e.type != TraceType.SEND_RPC:
            continue
        n_send += 1
        k = e.timestamp // NS
        meta = e.send_rpc.meta
        agg["msgs"][k] += len(meta.messages or ())
        c = meta.control
        if c is not None:
            for ih in (c.ihave or ()):
                agg["ihave_rpcs"][k] += 1
                agg["ihave_ids"][k] += len(ih.message_ids)
            for iw in (c.iwant or ()):
                agg["iwant_rpcs"][k] += 1
                agg["iwant_ids"][k] += len(iw.message_ids)
            agg["graft"][k] += len(c.graft or ())
            agg["prune"][k] += len(c.prune or ())
    assert n_send == n_recv > 0
    np.testing.assert_array_equal(
        agg["msgs"], arrs["payload_sent"] + arrs["iwant_ids_served"])
    for k, f in (("ihave_rpcs", "ihave_rpcs"), ("ihave_ids", "ihave_ids"),
                 ("iwant_rpcs", "iwant_rpcs"),
                 ("iwant_ids", "iwant_ids_requested"),
                 ("graft", "graft_sends"), ("prune", "prune_sends")):
        np.testing.assert_array_equal(agg[k], arrs[f], err_msg=k)


def test_rpc_stream_drop_rpc_under_faults():
    run = _faulted_port()
    events = ex.rpc_events(run["rsnaps"], run["cfg"].offsets, run["topic"],
                           run["peer_topic"])
    assert any(e.type == TraceType.DROP_RPC for e in events)
    down = {(5, k) for k in range(3, 8)} | {(11, k) for k in range(2, 12)}
    for e in events:
        assert (int(e.peer_id[4:]), e.timestamp // NS) not in down


def test_rpc_stream_captures_flood_publish():
    n, t, m, T = 200, 2, 4, 6
    cfg = pgs.GossipSimConfig(offsets=pgs.make_gossip_offsets(t, 16, n,
                                                              seed=4),
                              n_topics=t)
    sc = pgs.ScoreSimConfig(flood_publish=True)
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    origin = np.array([10, 11, 24, 37])
    topic = (origin % t).astype(np.int64)
    ticks = np.array([2, 2, 3, 3], dtype=np.int32)
    params, state = pgs.make_gossip_sim(cfg, subs, topic, origin, ticks,
                                        score_cfg=sc, device="cpu")
    _, rsnaps = pgs.gossip_run_rpc_snapshots(
        params, state, T, pgs.make_gossip_step(cfg, sc, device="cpu",
                                               rpc_probe=True),
        device="cpu")
    events = ex.rpc_events(rsnaps, cfg.offsets, topic,
                           (np.arange(n) % t).astype(np.int64))
    mid = {ex.msg_id(j): j for j in range(m)}
    for j, (o, pt) in enumerate(zip(origin, ticks)):
        sends = [e for e in events
                 if e.type == TraceType.SEND_RPC
                 and e.peer_id == b"sim-%d" % o
                 and e.timestamp // NS == int(pt)
                 and any(mid.get(mm.message_id) == j
                         for mm in (e.send_rpc.meta.messages or ()))]
        assert len(sends) > cfg.d_hi, (j, len(sends))


def test_peer_events_churn_semantics():
    n, offs = 12, (1, -1)
    sched = pfl.FaultSchedule(n_peers=n, horizon=10,
                              down_intervals=((3, 2, 5),), seed=0)
    events = ex.peer_events(offs, n, fault_schedule=sched)
    adds0 = [e for e in events
             if e.type == TraceType.ADD_PEER and e.timestamp == 0]
    assert len(adds0) == n * 2
    removes = sorted((e.timestamp // NS, int(e.peer_id[4:]),
                      int(e.remove_peer.peer_id[4:])) for e in events
                     if e.type == TraceType.REMOVE_PEER)
    assert removes == [(2, 2, 3), (2, 4, 3)]
    readds = sorted((e.timestamp // NS, int(e.peer_id[4:]),
                     int(e.add_peer.peer_id[4:])) for e in events
                    if e.type == TraceType.ADD_PEER and e.timestamp > 0)
    assert readds == [(5, 2, 3), (5, 3, 2), (5, 3, 4), (5, 4, 3)]


def test_tracestat_frames_percentiles_and_check_gate(tmp_path):
    """The frames sidecar's percentiles, 13/13 coverage, and ``--check``:
    it passes against its own report, trips on a doctored p99 and on a
    missing event type — the port's CLI and ``tools/tracestat.py`` alike."""
    run = _faulted_port()
    merged = _all_13(run)
    trace = tmp_path / "full13.pb"
    ex.write_pb_trace(str(trace), merged)
    cfg, T, m = run["cfg"], run["T"], run["m"]
    tcfg = ptl.TelemetryConfig(latency_hist=True, latency_buckets=16)
    p3, s3 = pgs.make_gossip_sim(cfg, run["subs"], run["topic"],
                                 run["origin"], run["ticks"],
                                 fault_schedule=run["sched"], device="cpu")
    _, counts, frames = ptl.telemetry_run_curve(
        p3, s3, T, pgs.make_gossip_step(cfg, device="cpu", telemetry=tcfg),
        m)
    fr = tmp_path / "frames.json"
    ex.write_telemetry_frames(str(fr), frames, tcfg, counts=counts,
                              publish_tick=run["ticks"],
                              msg_topic=run["topic"])
    code, out, _ = _both_tracestat(trace, "--frames", fr, "--json")
    assert code == 0
    rep = json.loads(out)
    assert rep["coverage"]["covered"] == 13
    assert rep["latency_ticks"]["source"] == "frames"
    assert "latency_by_topic_ticks" in rep
    base = tmp_path / "base.json"
    base.write_text(json.dumps(rep))
    assert _both_tracestat(trace, "--frames", fr, "--check", base)[0] == 0
    bad = dict(rep, latency_ticks=dict(rep["latency_ticks"], p99=-5))
    badp = tmp_path / "bad.json"
    badp.write_text(json.dumps(bad))
    code, _, err = _both_tracestat(trace, "--frames", fr, "--check", badp)
    assert code == 1 and "latency regression" in err
    part = tmp_path / "partial.pb"
    ex.write_pb_trace(str(part), [e for e in merged
                                  if e.type != TraceType.DROP_RPC])
    code, _, err = _both_tracestat(part, "--frames", fr, "--check", base)
    assert code == 1 and "DROP_RPC" in err
    report = ts.stats([str(trace)], frames_path=str(fr))
    assert report == rep
    assert ts.check_regression(report, bad)


def test_rpc_probe_paired_topics(ref):
    """Paired overlays: the probe carries the slot-B masks and the
    exporter labels each GRAFT/PRUNE with its slot's topic and splits the
    IHAVE by ``slot_b_words`` (the port's run)."""
    _, got = _paired_both(ref)
    rs = ex.host_snapshots(got["rsnaps"])
    for key in ("fwd_b", "graft_b", "prune_b", "fresh_a", "fresh_b"):
        assert key in rs
    cfg = got["cfg"]
    with pytest.raises(ValueError, match="peer_topic_b"):
        ex.rpc_events(rs, cfg.offsets, got["topic"], got["pt"])
    events = ex.rpc_events(rs, cfg.offsets, got["topic"], got["pt"],
                           peer_topic_b=got["pt_b"],
                           slot_b_words=got["slot_b"])
    sends = [e for e in events if e.type == TraceType.SEND_RPC]
    assert len(sends) == sum(e.type == TraceType.RECV_RPC
                             for e in events) > 0

    def popcnt(a):
        return int(np.unpackbits(np.ascontiguousarray(a).view(np.uint8)).sum())

    g_top, p_top = Counter(), Counter()
    for e in sends:
        c = e.send_rpc.meta.control
        if c is None:
            continue
        g_top.update(gm.topic for gm in (c.graft or ()))
        p_top.update(pm.topic for pm in (c.prune or ()))
    assert sum(g_top.values()) == popcnt(rs["graft"]) + popcnt(rs["graft_b"])
    assert sum(p_top.values()) == popcnt(rs["prune"]) + popcnt(rs["prune_b"])
    t = 4
    seen_topics = set(g_top) | set(p_top)
    assert seen_topics & {f"topic-{x}" for x in range(t // 2)}
    assert seen_topics & {f"topic-{x}" for x in range(t // 2, t)}
