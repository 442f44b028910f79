"""Rules the PyTorch port keeps: it imports nothing of JAX or the JAX
package, its device is explicit (default ``cuda``, no fallback), and
every option outside the port raises its named refusal."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import device as pdev
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import plan
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
REFUSED = {
    # paired overlays step per tick
    "fused_paired": [lambda: _window(cfg=_cfg(paired_topics=True))],
    "faults": [lambda: _sim(fault_schedule=object())],
    "telemetry": [lambda: _step(telemetry=object()),
                  lambda: _window(telemetry=object())],
    "knobs": [lambda: _sim(score_knobs={}), lambda: _sim(sim_knobs={})],
    "delays": [lambda: _sim(delays=object()),
               lambda: _sim(delays_probe=True)],
    "rpc_probe": [lambda: _step(rpc_probe=True)],
    "invariants": [lambda: _step(invariants=object())],
    "byzantine": [
        lambda: _step(sc=pgs.ScoreSimConfig(byzantine_mutation=True)),
        lambda: _sim(sc=pgs.ScoreSimConfig(byzantine_mutation=True)),
        lambda: _sim(byzantine=np.zeros(N, bool))],
    "flood_proto": [lambda: _sim(flood_proto=np.zeros(N, bool))],
    "track_p3": [
        lambda: _step(sc=pgs.ScoreSimConfig(
            mesh_message_deliveries_weight=-1.0)),
        lambda: _step(force_split=True)],
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
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_option_outside_the_port_is_refused_by_name(name):
    assert name in plan.REFUSALS
    for trigger in REFUSED[name]:
        with pytest.raises(plan.SliceRefusal) as err:
            trigger()
        assert err.value.name == name
        assert plan.REFUSALS[name] in str(err.value)


def test_more_refusals():
    cfg, sc, (subs, topic, origin, ticks) = _small()
    with pytest.raises(plan.SliceRefusal) as err:
        pgs.make_gossip_sim(cfg, subs, topic[:0], origin[:0], ticks[:0],
                            score_cfg=sc, device="cpu")
    assert err.value.name == "no_messages"
    wide = pgs.make_gossip_offsets(4, 20, 1024, seed=0)
    with pytest.raises(plan.SliceRefusal) as err:
        pgs.make_gossip_step(pgs.GossipSimConfig(offsets=wide, n_topics=4),
                             sc, device="cpu")
    assert err.value.name == "wide_candidates"
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
        "no_messages", "wide_candidates", "reweighted_static",
        "kernel_shape"}
