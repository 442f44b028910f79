"""Rules the PyTorch port keeps: it imports nothing of JAX or the JAX
package, its device is explicit (default ``cuda``, no fallback), and
every option outside the port raises its named refusal."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch import device as pdev
from go_libp2p_pubsub_tpu_torch.models import delays as pdl
from go_libp2p_pubsub_tpu_torch.models import faults as pfl
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import invariants as piv
from go_libp2p_pubsub_tpu_torch.models import plan
from go_libp2p_pubsub_tpu_torch.models import telemetry as ptl
from go_libp2p_pubsub_tpu_torch.ops.kernels import fused as kfused

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "go_libp2p_pubsub_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "go_libp2p_pubsub_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import go_libp2p_pubsub_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'go_libp2p_pubsub_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_default_device_is_cuda_and_never_falls_back():
    assert pdev.DEFAULT_DEVICE == "cuda"
    assert pdev.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdev.resolve_device()
    cfg, sc, sim_args = _small()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pgs.make_gossip_sim(cfg, *sim_args, score_cfg=sc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pgs.make_gossip_step(cfg, sc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pgs.make_fused_window(cfg, None)
    params, state = pgs.make_gossip_sim(cfg, *sim_args, score_cfg=sc,
                                        device="cpu")
    step = pgs.make_gossip_step(cfg, sc, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pgs.gossip_run(params, state, 1, step)


def test_step_refuses_tensors_on_another_device():
    cfg, sc, sim_args = _small()
    params, state = pgs.make_gossip_sim(cfg, *sim_args, score_cfg=sc,
                                        device="cpu")
    step = pgs.make_gossip_step(cfg, sc, device="cpu")
    step(params, state)
    other = pgs.make_gossip_step(cfg, pgs.ScoreSimConfig(
        first_message_deliveries_cap=10.0), device="cpu")
    with pytest.raises(ValueError, match="different"):
        other(params, state)


def _small(n=256, t=4, c=16, m=8):
    offsets = pgs.make_gossip_offsets(t, c, n, seed=0)
    cfg = pgs.GossipSimConfig(offsets=offsets, n_topics=t)
    rng = np.random.default_rng(0)
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    topic = rng.integers(0, t, m)
    origin = rng.integers(0, n // t, m) * t + topic
    ticks = np.sort(rng.integers(0, 10, m)).astype(np.int32)
    return cfg, pgs.ScoreSimConfig(), (subs, topic, origin, ticks)


def _sim(**kw):
    cfg, sc, args = _small()
    cfg = kw.pop("cfg", cfg)
    sc = kw.pop("sc", sc)
    return pgs.make_gossip_sim(cfg, *args, score_cfg=sc, device="cpu", **kw)


def _step(**kw):
    cfg, sc, _ = _small()
    cfg = kw.pop("cfg", cfg)
    sc = kw.pop("sc", sc)
    return pgs.make_gossip_step(cfg, sc, device="cpu", **kw)


def _cfg(**kw):
    cfg, _, _ = _small()
    return pgs.GossipSimConfig(offsets=cfg.offsets, n_topics=4, **kw)


#: byzantine mutation compiled in
BYZ = pgs.ScoreSimConfig(byzantine_mutation=True)


def _loops_step(*, paired=False, knob_flood=False, telemetry=None,
                delays=None, force_split=False):
    """One step of a sim the receive loops take (byzantine mutators; with
    ``knob_flood`` a SimKnobs point on an IWANT-flood config instead),
    paired or not, with ``telemetry`` or ``delays``."""
    cfg, _, (subs, topic, origin, ticks) = _small()
    if paired:
        cfg = _cfg(paired_topics=True)
        idx = np.arange(len(subs))
        subs = subs.copy()
        subs[idx, (idx % 4 + 2) % 4] = True
    if knob_flood:
        sc = pgs.ScoreSimConfig(sybil_iwant_spam=True)
        kw = dict(sybil=np.arange(N) % 5 == 0, sim_knobs={})
    else:
        sc, kw = BYZ, dict(byzantine=np.arange(N) % 5 == 0)
    params, state = pgs.make_gossip_sim(cfg, subs, topic, origin, ticks,
                                        score_cfg=sc, device="cpu",
                                        delays=delays, **kw)
    return pgs.make_gossip_step(cfg, sc, device="cpu", telemetry=telemetry,
                                force_split=force_split)(params, state)


def _window(**kw):
    cfg, _, _ = _small()
    cfg = kw.pop("cfg", cfg)
    sc = kw.pop("sc", None)
    return pgs.make_fused_window(cfg, sc, device="cpu", **kw)


def _fused_run(n_ticks, **kw):
    params, state = _sim(sc=None, **kw)
    return pgs.gossip_run_fused(params, state, n_ticks, _window(),
                                device="cpu")


N = 256


def _stack(seeds=(1, 2), **kw):
    """Two of the small sims stacked on a replica axis (``_sim``'s
    keywords; a list value gives each replica its own)."""
    builds = [_sim(seed=s, **{k: (v[i] if isinstance(v, list) else v)
                              for k, v in kw.items()})
              for i, s in enumerate(seeds)]
    return (pgs.stack_trees([p for p, _ in builds]),
            pgs.stack_trees([s for _, s in builds]))


def _batched_step(step_kw=None, **kw):
    """One step of a replica stack of the small sim."""
    params, state = _stack(**kw)
    return _step(**(step_kw or {}))(params, state)


def _sched(**kw):
    """A schedule over the small sim's peers: churn, loss, a partition."""
    return pfl.FaultSchedule(
        n_peers=N, horizon=40, down_intervals=[(p, 2, 6) for p in
                                               range(0, N, 9)],
        drop_prob=0.05, partition_group=np.arange(N) % 2,
        partition_windows=[(8, 12)], seed=3, **kw)


REFUSED = {
    # paired overlays step per tick
    "fused_paired": [lambda: _window(cfg=_cfg(paired_topics=True))],
    # a knob-carrying sim steps per tick, as in the reference
    "fused_knobs": [lambda: _fused_run(8, sim_knobs={}),
                    lambda: _fused_run(8, sim_knobs={"d": 5, "d_lo": 4})],
    # a delay-armed sim steps per tick, as in the reference (with its
    # message and the lines' byte count), faulted or not
    "fused_delays": [
        lambda: _fused_run(8, delays=pdl.DelayConfig(2, 1, 4)),
        lambda: _fused_run(8, delays=pdl.DelayConfig(1, 0, 1),
                           fault_schedule=_sched())],
    # the split path's delay line waits for the split path
    "delays_split": [lambda: _sim(delays=pdl.DelayConfig(),
                                  delays_split=True)],
    "flood_proto": [lambda: _sim(flood_proto=np.zeros(N, bool))],
    # what the receive loops do not run yet: a paired sim off the kernel,
    # telemetry and delays on the loops
    "loops_paired": [lambda: _loops_step(paired=True),
                     lambda: _loops_step(paired=True, knob_flood=True)],
    "loops_telemetry": [
        lambda: _loops_step(telemetry=ptl.TelemetryConfig()),
        lambda: _loops_step(telemetry=ptl.TelemetryConfig(),
                            force_split=True)],
    "loops_delays": [lambda: _loops_step(delays=pdl.DelayConfig()),
                     lambda: _loops_step(delays=pdl.DelayConfig(),
                                         force_split=True)],
    # the fused window runs what the receive kernel runs
    "fused_loops": [
        lambda: _window(sc=BYZ),
        lambda: _window(sc=pgs.ScoreSimConfig(
            mesh_message_deliveries_weight=-1.0)),
        lambda: _window(cfg=pgs.GossipSimConfig(
            offsets=pgs.make_gossip_offsets(4, 20, 1024, seed=0),
            n_topics=4))],
    "shard_mesh": [lambda: _step(shard_mesh=object()),
                   lambda: _window(shard_mesh=object())],
    "pad_to_block": [lambda: _sim(pad_to_block=128)],
    "pipeline_gates": [lambda: _step(pipeline_gates=False)],
    "counter_dtype": [
        lambda: _step(sc=pgs.ScoreSimConfig(counter_dtype="float16"))],
    "fused_window": [lambda: _window(ticks_fused=0),
                     lambda: _window(ticks_fused=plan.MAX_WINDOW + 1)],
    "fused_horizon": [lambda: _fused_run(12), lambda: _fused_run(-8)],
    "fused_scored": [lambda: _window(sc=pgs.ScoreSimConfig())],
    # a sim with an active set or with direct peers steps per tick
    "fused_px": [lambda: _fused_run(8, px_candidates=14)],
    "fused_direct": [
        lambda: _fused_run(8, direct_edges=np.zeros((N, 16), bool))],
    # the launch's own error when not one block of the grid is resident
    "fused_grid": [lambda: kfused.check_launch(kfused.COOPERATIVE_TOO_LARGE)],
    # what a replica stack does not run yet
    "batched_paired": [lambda: _paired_stack_step()],
    "batched_surface": [
        lambda: _batched_step(px_candidates=14),
        lambda: _batched_step(direct_edges=np.zeros((N, 16), bool)),
        lambda: _batched_step(sc=pgs.ScoreSimConfig(flood_publish=True),
                              step_kw=dict(sc=pgs.ScoreSimConfig(
                                  flood_publish=True))),
        lambda: _batched_step(
            cfg=_cfg(binomial_gossip_sampling=False),
            step_kw=dict(cfg=_cfg(binomial_gossip_sampling=False)))],
    "batched_fused": [lambda: _window()(*_stack(sc=None))],
    # the RPC probe steps one sim (the step and its runner)
    "batched_probe": [
        lambda: _batched_step(step_kw=dict(rpc_probe=True)),
        lambda: pgs.gossip_run_rpc_snapshots(
            *_stack(), 1, _step(rpc_probe=True), device="cpu")],
    "batched_ticks": [lambda: pgs.stack_trees([
        _sim(seed=1)[1], pgs.replace(_sim(seed=2)[1], tick=5)])],
    "batched_partitions": [lambda: _stack(fault_schedule=[
        _sched(), pfl.FaultSchedule(
            n_peers=N, horizon=40, seed=4, drop_prob=0.05,
            down_intervals=[(p, 2, 6) for p in range(0, N, 9)],
            partition_group=np.arange(N) % 2,
            partition_windows=[(9, 12)])])],
    # the sharded checkpoint runners wait for the sharded step (A9)
    "sharded_checkpoint": [lambda: _ckpt().ckpt_sharded_gossip_run(
        None, None, 1, None, None, None)],
    # the sweep server: a batched dispatch over D devices (A9)
    "serve_devices": [lambda: _sweepd().SweepServer(
        n=64, t=1, m=2, ticks=4, batch=2, devices=2, device="cpu")],
}


def _ckpt():
    from go_libp2p_pubsub_tpu_torch.parallel import checkpoint
    return checkpoint


def _sweepd():
    from go_libp2p_pubsub_tpu_torch import sweepd
    return sweepd


def _paired_stack_step():
    """One step of a stack of two paired sims (both topics of each
    peer's pair subscribed)."""
    cfg, _, (subs, topic, origin, ticks) = _small()
    cfg = _cfg(paired_topics=True)
    idx = np.arange(len(subs))
    subs = subs.copy()
    subs[idx, (idx % 4 + 2) % 4] = True
    builds = [pgs.make_gossip_sim(cfg, subs, topic, origin, ticks, seed=s,
                                  device="cpu") for s in (1, 2)]
    return pgs.make_gossip_step(cfg, device="cpu")(
        pgs.stack_trees([p for p, _ in builds]),
        pgs.stack_trees([s for _, s in builds]))


def test_batch_modules_are_under_the_import_check():
    """The replica-batching modules are among the files the import rule
    reads."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"go_libp2p_pubsub_tpu_torch/models/_batch.py",
            "go_libp2p_pubsub_tpu_torch/batched_flagship.py",
            "go_libp2p_pubsub_tpu_torch/tournament.py"} <= names


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_option_outside_the_port_is_refused_by_name(name):
    assert name in plan.REFUSALS
    for trigger in REFUSED[name]:
        with pytest.raises(plan.SliceRefusal) as err:
            trigger()
        assert err.value.name == name
        assert plan.REFUSALS[name] in str(err.value)


def test_delays_and_telemetry_run_in_a_stack():
    """A replica stack of delay-armed sims and a stack stepped with
    telemetry run (the ``batched_delays`` and ``batched_telemetry``
    refusals are gone): one step for the stack, the lines ``[B, K, ...]``,
    each frame field ``[B]``, the histograms ``[B, L]``."""
    assert "batched_delays" not in plan.REFUSALS
    assert "batched_telemetry" not in plan.REFUSALS
    params, state = _stack(delays=pdl.DelayConfig(2, 1, 4))
    state = _step()(params, state)[0]
    assert state.tick == 1 and tuple(state.ctrl_line.shape[:2]) == (2, 4)
    params, state = _stack(fault_schedule=_sched())
    state, frames = ptl.telemetry_run_batch(
        params, state, 2, _step(telemetry=ptl.TelemetryConfig(
            latency_hist=True)))
    assert state.tick == 2 and frames.payload_sent.shape == (2, 2)
    assert frames.latency_hist.shape == (2, 2, 16)


def test_fault_schedules_run_on_the_step_and_the_window():
    """A faulted sim builds and steps (the ``faults`` refusal is gone),
    scored and unscored, per tick and on fused windows with cold
    restart; a schedule over another peer count raises the reference's
    ValueError."""
    params, state = _sim(fault_schedule=_sched())
    assert params.faults is not None and params.faults.cross_bits is not None
    state = pgs.gossip_run(params, state, 10, _step(), device="cpu")
    assert state.tick == 10
    params, state = _sim(sc=None, fault_schedule=_sched(cold_restart=True))
    state = pgs.gossip_run_fused(params, state, 16, _window(), device="cpu")
    assert state.tick == 16 and params.faults.cold_restart
    with pytest.raises(ValueError, match="fault_schedule.n_peers=255"):
        _sim(fault_schedule=pfl.FaultSchedule(n_peers=N - 1, horizon=40))


def test_telemetry_runs_on_the_step_and_the_window():
    """Telemetry is no longer refused: the step (scored, under faults)
    returns a frame a tick, the fused window T stacked frames (with cold
    restart); the ``telemetry`` refusal is gone."""
    assert "telemetry" not in plan.REFUSALS
    tcfg = ptl.TelemetryConfig(latency_hist=True)
    params, state = _sim(fault_schedule=_sched())
    state, _, frame = _step(telemetry=tcfg)(params, state)
    assert state.tick == 1 and frame.latency_hist.shape == (16,)
    assert int(frame.down_peers) > 0 or int(frame.dropped_edge_ticks) > 0
    params, state = _sim(sc=None, fault_schedule=_sched(cold_restart=True))
    win = _window(telemetry=tcfg)
    state, frames = pgs.gossip_run_frames_fused(params, state, 16, win,
                                                device="cpu")
    assert state.tick == 16 and frames.payload_sent.shape == (16,)


def test_knobs_run_on_the_step_and_keep_the_references_refusals():
    """Knobs are no longer refused: a knob point builds and steps, with
    faults (the fault knob too) and telemetry.  A SimKnobs point on an
    IWANT-flood config runs on the receive loops, as the reference's XLA
    step runs it, and the legacy score_knobs surface on the kernel; under
    delays the flood keeps the reference's ValueError."""
    assert "knobs" not in plan.REFUSALS
    point = {"d": 5, "d_lo": 4, "gossip_factor": 0.5,
             "graylist_threshold": -60.0}
    params, state = _sim(sim_knobs=point)
    assert params.sim_knobs is not None and params.sim_knobs.score is not None
    state = pgs.gossip_run(params, state, 5, _step(), device="cpu")
    assert state.tick == 5
    params, state = _sim(fault_schedule=_sched(),
                         sim_knobs=dict(point, drop_prob=0.02))
    state, _, frame = _step(telemetry=ptl.TelemetryConfig())(params, state)
    assert state.tick == 1 and float(params.faults.drop_prob) == float(
        np.float32(0.02))
    flood = pgs.ScoreSimConfig(sybil_ihave_spam=True, sybil_iwant_spam=True)
    sybil = np.arange(N) % 5 == 0
    params, state = _sim(sc=flood, sybil=sybil, sim_knobs={})
    assert plan.receive_path(_small()[0], flood, params) == plan.COMBINED
    state = pgs.gossip_run(params, state, 3, _step(sc=flood), device="cpu")
    assert state.tick == 3
    params, state = _sim(sc=flood, sybil=sybil, sim_knobs={},
                         delays=pdl.DelayConfig())
    with pytest.raises(ValueError) as err:
        _step(sc=flood)(params, state)
    assert str(err.value) == plan.MSG_KERNEL_DELAY_IWANT_SPAM
    params, state = _sim(sc=flood, sybil=sybil,
                         score_knobs={"behaviour_penalty_weight": -40.0})
    state = pgs.gossip_run(params, state, 3, _step(sc=flood), device="cpu")
    assert state.tick == 3


def test_invariants_run_on_the_step_and_pass_through_the_window():
    """The checker is no longer refused: an armed sim steps with it, with
    faults, knobs and telemetry.  The fused window takes no checker, as the
    reference's ``make_fused_window`` takes none, and rebuilds the state
    with ``replace`` (the reference's ``state.replace``): an armed state's
    two scalars pass through a window untouched and unchecked, and every
    other leaf equals the unarmed state's window."""
    assert "invariants" not in plan.REFUSALS
    params, state = _sim(fault_schedule=_sched(),
                         sim_knobs={"d": 5, "d_lo": 4})
    step = _step(invariants=piv.InvariantConfig(),
                 telemetry=ptl.TelemetryConfig())
    state, _, frame = step(params, piv.attach(state))
    assert state.tick == 1 and piv.report(state)["bits"] == 0
    params, state = _sim(sc=None, fault_schedule=_sched(cold_restart=True))
    forged = dict(inv_viol=torch.tensor(8, dtype=torch.int32),
                  inv_first=torch.tensor(5, dtype=torch.int32))
    armed = dataclasses.replace(piv.attach(state), **forged)
    out = pgs.gossip_run_fused(params, armed, 16, _window(), device="cpu")
    plain = pgs.gossip_run_fused(params, state, 16, _window(), device="cpu")
    assert out.inv_viol is forged["inv_viol"]
    assert out.inv_first is forged["inv_first"]
    assert plain.inv_viol is None and plain.tick == out.tick == 16
    got, want = convert.state_to_numpy(out), convert.state_to_numpy(plain)
    for name, w in want.items():
        if name in ("inv_viol", "inv_first"):
            continue
        if isinstance(w, list):
            assert all(np.array_equal(a, b) for a, b in zip(w, got[name]))
        elif w is not None and not isinstance(w, dict):
            assert np.array_equal(w, got[name]), name


def test_delays_run_on_the_step_with_faults_knobs_and_telemetry():
    """Delays are no longer refused: a delayed sim builds and steps, scored
    and unscored, with faults, telemetry and the delay knobs; the
    ``delays`` refusal is gone."""
    assert "delays" not in plan.REFUSALS
    dc = pdl.DelayConfig(base=2, jitter=1, k_slots=4)
    params, state = _sim(delays=dc, fault_schedule=_sched(),
                         sim_knobs={"d": 5, "d_lo": 4, "delay_base": 3},
                         delays_counters=True)
    assert int(params.delays.base) == 3
    step = _step(telemetry=ptl.TelemetryConfig(latency_hist=True))
    for _ in range(6):
        state, _, frame = step(params, state)
    assert state.tick == 6 and state.pay_line.shape == (4, 16, 1, N)
    params, state = _sim(sc=None, delays=dc)
    state = pgs.gossip_run(params, state, 6, _step(sc=None), device="cpu")
    assert state.tick == 6


def test_more_refusals():
    cfg, sc, (subs, topic, origin, ticks) = _small()
    with pytest.raises(plan.SliceRefusal) as err:
        pgs.make_gossip_sim(cfg, subs, topic[:0], origin[:0], ticks[:0],
                            score_cfg=sc, device="cpu")
    assert err.value.name == "no_messages"
    # more than 16 candidates run on the split loops: not refused
    wide = pgs.GossipSimConfig(
        offsets=pgs.make_gossip_offsets(4, 20, 1024, seed=0), n_topics=4)
    params, state = pgs.make_gossip_sim(
        wide, np.eye(4, dtype=bool)[np.arange(1024) % 4], topic % 4,
        origin % 4, ticks, score_cfg=sc, device="cpu")
    assert plan.receive_path(wide, sc, params) == plan.SPLIT
    assert pgs.make_gossip_step(wide, sc, device="cpu")(
        params, state)[0].tick == 1
    rng = np.random.default_rng(0)
    params, state = pgs.make_gossip_sim(
        cfg, subs, topic, origin, ticks, score_cfg=sc, device="cpu",
        app_score=rng.normal(size=len(subs)).astype(np.float32))
    with pytest.raises(plan.SliceRefusal) as err:
        pgs.compute_scores(pgs.ScoreSimConfig(app_specific_weight=2.0),
                           params, state)
    assert err.value.name == "reweighted_static"
    many = np.arange(80)
    with pytest.raises(plan.SliceRefusal) as err:
        pgs.make_gossip_step(cfg, sc, device="cpu")(*pgs.make_gossip_sim(
            cfg, subs, many % 4, many % 4, np.zeros(80, np.int32),
            score_cfg=sc, device="cpu"))
    assert err.value.name == "kernel_shape"
    # every named refusal is raised somewhere the tests reach
    assert set(plan.REFUSALS) == set(REFUSED) | {
        "no_messages", "reweighted_static", "kernel_shape"}


def test_meshless_modules_are_under_the_import_check():
    """The FloodSub and RandomSub simulators and their entry modules are
    among the files the import rule reads."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"go_libp2p_pubsub_tpu_torch/models/floodsub.py",
            "go_libp2p_pubsub_tpu_torch/models/randomsub.py",
            "go_libp2p_pubsub_tpu_torch/floodsub_flagship.py",
            "go_libp2p_pubsub_tpu_torch/randomsub_10k.py"} <= names


def _meshless_entry_points():
    from go_libp2p_pubsub_tpu_torch import floodsub_flagship, randomsub_10k
    from go_libp2p_pubsub_tpu_torch.models import floodsub as pfs
    from go_libp2p_pubsub_tpu_torch.models import randomsub as prs

    n = 60
    subs = np.ones((n, 1), dtype=bool)
    msgs = (np.array([0]), np.array([0]), np.zeros(1, np.int32))
    cfg = prs.RandomSubSimConfig(offsets=prs.make_randomsub_offsets(1, 4, n))
    fp, fst = pfs.make_flood_sim(None, None, subs, None, *msgs,
                                 device="cpu")
    rp, rst = prs.make_randomsub_sim(cfg, subs, *msgs, device="cpu")
    step = prs.make_randomsub_step(cfg)
    return {
        "make_flood_sim": lambda **k: pfs.make_flood_sim(
            None, None, subs, None, *msgs, **k),
        "make_randomsub_sim": lambda **k: prs.make_randomsub_sim(
            cfg, subs, *msgs, **k),
        "flood_run": lambda **k: pfs.flood_run(fp, fst, 1, **k),
        "flood_run_curve": lambda **k: pfs.flood_run_curve(
            fp, fst, 1, pfs.make_gather_step_core(), 1, **k),
        "randomsub_run": lambda **k: prs.randomsub_run(rp, rst, 1, step,
                                                       **k),
        "randomsub_run_curve": lambda **k: prs.randomsub_run_curve(
            rp, rst, 1, step, 1, **k),
        "floodsub_flagship.run": lambda **k: floodsub_flagship.run(
            "circulant", **k),
        "floodsub_flagship.forms": lambda **k: floodsub_flagship.forms(**k),
        "randomsub_10k.run": lambda **k: randomsub_10k.run(True, **k),
        "randomsub_10k.forms": lambda **k: randomsub_10k.forms(**k),
    }


@pytest.mark.parametrize("name", [
    "make_flood_sim", "make_randomsub_sim", "flood_run", "flood_run_curve",
    "randomsub_run", "randomsub_run_curve", "floodsub_flagship.run",
    "floodsub_flagship.forms", "randomsub_10k.run", "randomsub_10k.forms"])
def test_meshless_entry_points_default_to_cuda(name):
    """The mesh-less simulators' entry points run on the card unless the
    caller asks for the CPU, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _meshless_entry_points()[name]()


def test_trace_modules_are_under_the_import_check():
    """The trace-export modules (the probe's runners live in
    ``models/gossipsub.py``) are among the files the import rule reads."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"go_libp2p_pubsub_tpu_torch/pb/trace.py",
            "go_libp2p_pubsub_tpu_torch/artifacts.py",
            "go_libp2p_pubsub_tpu_torch/interop/export.py",
            "go_libp2p_pubsub_tpu_torch/interop/replay.py",
            "go_libp2p_pubsub_tpu_torch/tracestat.py",
            "go_libp2p_pubsub_tpu_torch/trace_export.py"} <= names


@pytest.mark.parametrize("name", ["trace_export.run", "trace_export.collect",
                                  "trace_export.probe_forms",
                                  "gossip_run_rpc_snapshots",
                                  "gossip_run_acq_snapshots",
                                  "gossip_run_mesh_snapshots"])
def test_trace_entry_points_default_to_cuda(name):
    """The trace path's entry points run on the card unless the caller
    asks for the CPU, and raise without one."""
    from go_libp2p_pubsub_tpu_torch import trace_export

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    if name.startswith("trace_export."):
        call = getattr(trace_export, name.split(".")[1])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        return
    params, state = _sim()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(pgs, name)(params, state, 1, _step(rpc_probe=True))


#: the sweep server's and checkpoints' modules (tools/ is the JAX package's
#: command-line side: the port keeps its own copies)
SLICE_19 = ("go_libp2p_pubsub_tpu_torch/sweepd.py",
            "go_libp2p_pubsub_tpu_torch/sweepd_bench.py",
            "go_libp2p_pubsub_tpu_torch/checkpoint_bench.py",
            "go_libp2p_pubsub_tpu_torch/ckptstat.py",
            "go_libp2p_pubsub_tpu_torch/parallel/checkpoint.py",
            "go_libp2p_pubsub_tpu_torch/utils/checkpoint.py",
            "go_libp2p_pubsub_tpu_torch/obs/__init__.py",
            "go_libp2p_pubsub_tpu_torch/obs/metrics.py",
            "go_libp2p_pubsub_tpu_torch/obs/spans.py",
            "go_libp2p_pubsub_tpu_torch/obs/scrape.py")


@pytest.mark.parametrize("rel", SLICE_19)
def test_sweep_and_checkpoint_modules_import_no_jax_nor_tools(rel):
    """The new modules are under the import rule, and import nothing of
    ``tools/`` either (nor ``ml_dtypes``, which the card's machine lacks:
    bf16 crosses as its bits)."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert rel in names
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        bad = [n for n in mods if _forbidden(n) or n.split(".")[0] in (
            "tools", "ml_dtypes")]
        assert not bad, f"{rel} imports {bad}"


@pytest.mark.parametrize("name", ["sweepd.SweepServer",
                                  "sweepd_bench.run_sweepd",
                                  "sweepd_bench.run_kernel",
                                  "checkpoint_bench.run",
                                  "ckpt_gossip_run"])
def test_sweep_and_checkpoint_entry_points_default_to_cuda(name):
    """The server, both benches and the segmented runners run on the card
    unless the caller asks for the CPU, and raise without one."""
    from go_libp2p_pubsub_tpu_torch import checkpoint_bench, sweepd_bench
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    calls = {
        "sweepd.SweepServer": lambda: _sweepd().SweepServer(
            n=64, t=1, m=2, ticks=4, batch=2),
        "sweepd_bench.run_sweepd": sweepd_bench.run_sweepd,
        "sweepd_bench.run_kernel": sweepd_bench.run_kernel,
        "checkpoint_bench.run": checkpoint_bench.run,
        "ckpt_gossip_run": lambda: _ckpt().ckpt_gossip_run(
            *_sim(), 1, _step(), _ckpt().CheckpointConfig("unused")),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[name]()



#: the serving slice's modules (the front end, and the port's own copies
#: of the reference's tools/loadgen.py, servestat.py and obsstat.py)
SLICE_20 = ("go_libp2p_pubsub_tpu_torch/serving/__init__.py",
            "go_libp2p_pubsub_tpu_torch/serving/buckets.py",
            "go_libp2p_pubsub_tpu_torch/serving/frontend.py",
            "go_libp2p_pubsub_tpu_torch/loadgen.py",
            "go_libp2p_pubsub_tpu_torch/servestat.py",
            "go_libp2p_pubsub_tpu_torch/obsstat.py",
            "go_libp2p_pubsub_tpu_torch/serving_bench.py",
            "go_libp2p_pubsub_tpu_torch/metrics_bench.py")


@pytest.mark.parametrize("rel", SLICE_20)
def test_serving_modules_import_no_jax_nor_tools(rel):
    """The serving slice's modules are under the import rule and import
    nothing of ``tools/`` (the reference's command-line side)."""
    test_sweep_and_checkpoint_modules_import_no_jax_nor_tools(rel)


@pytest.mark.parametrize("rel", ["go_libp2p_pubsub_tpu_torch/loadgen.py",
                                 "go_libp2p_pubsub_tpu_torch/servestat.py",
                                 "go_libp2p_pubsub_tpu_torch/obsstat.py"])
def test_client_tools_import_the_standard_library_only(rel):
    """The port's loadgen / servestat / obsstat use the stdlib only, as
    the reference's do: a client needs neither torch nor numpy."""
    import sys as _sys
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""] if node.level == 0 else ["."]
        else:
            continue
        assert all(m.split(".")[0] in _sys.stdlib_module_names
                   or m == "__future__" for m in mods), (rel, mods)


def test_the_multi_tenant_front_end_is_no_longer_refused():
    """``serve_multi`` is gone: ``sweepd --multi`` parses into a front end
    (its flags wired as the reference's), and a bucket the port refuses
    comes back as a row naming the refusal instead."""
    assert "serve_multi" not in plan.REFUSALS
    sw = _sweepd()
    ns = sw.parser().parse_args([
        "--multi", "--max-buckets", "3", "--queue-cap", "9", "--aot-dir",
        "a", "--long-ticks", "16", "--ckpt-dir", "c", "--ckpt-every", "4",
        "--peers", "64", "--topics", "1", "--msgs", "2", "--ticks", "4",
        "--batch", "2", "--seed", "5", "--device", "cpu"])
    fe = sw.make_server(ns, None)
    cfg = fe.cfg
    assert (cfg.max_buckets, cfg.queue_cap, cfg.aot_dir, cfg.long_ticks,
            cfg.ckpt_dir, cfg.ckpt_every, cfg.batch, cfg.default_shape) == (
        3, 9, "a", 16, "c", 4, 2, (64, 1, 2, 4))
    assert cfg.server_kw == {"seed": 5, "invariants": True,
                             "device": "cpu"}


@pytest.mark.parametrize("name", ["ScenarioFrontend.dispatch_ready",
                                  "serving_bench.run",
                                  "serving_bench.full_width",
                                  "metrics_bench.run",
                                  "metrics_bench.delay_parity"])
def test_serving_entry_points_default_to_cuda(name):
    """The front end's buckets, both benches and delay parity run on the
    card unless the caller asks for the CPU, and raise without one."""
    from go_libp2p_pubsub_tpu_torch import metrics_bench, serving_bench
    from go_libp2p_pubsub_tpu_torch.serving import (FrontendConfig,
                                                    ScenarioFrontend)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")

    def frontend():
        fe = ScenarioFrontend(FrontendConfig(batch=2))
        fe.admit({"id": "x", "n": 64, "t": 1, "m": 2, "ticks": 4})
        fe.dispatch_ready(force=True)
    calls = {"ScenarioFrontend.dispatch_ready": frontend,
             "serving_bench.run": serving_bench.run,
             "serving_bench.full_width": serving_bench.full_width,
             "metrics_bench.run": metrics_bench.run,
             "metrics_bench.delay_parity": metrics_bench.delay_parity}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[name]()
