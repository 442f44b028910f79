"""FloodSub at the flagship's width, on both topologies, with its gates,
rates and a profile; and the card-against-CPU matrix of the mesh-less
simulators' step forms.

The configuration (``build``): 1,000,000 peers, 100 topics (peer p in
topic p mod 100), M = 32 messages drawn as the JAX package's benchmarks
draw them (``bench_suite.py`` ``_subs_matrix`` / ``_msgs`` with
``default_rng(0)``, published over the first ``horizon - 30`` ticks), the
per-peer first-delivery records on:

- ``circulant``: the flagship's ring, ``make_circulant_offsets(100, 16,
  1_000_000, seed=0)``, stepped by ``make_circulant_step_core``;
- ``gather``: ``build_topic_graph(subs, 8, seed=0)`` over the same
  subscriptions, stepped by ``make_gather_step_core``.

``run`` steps one 50 warm-up ticks, then 3 x 100 timed (the JAX package's
RandomSub-10k benchmark's tick counts), and returns heartbeats/s, the peak
device memory, the kernel launches (none: the reference leaves these
simulators to XLA, so the port runs no hand-written kernel for them), its
gate (every message published at least 30 ticks before the end reached
every subscriber of its topic), ``reach_by_hops`` at 16 hops (the
reference's readout, which counts a delivery at tick h as hop h, and the
same curve in ticks since each message's publish), summed over the
messages, and a state digest.

``forms(device)`` steps each step form of both topologies (``FORMS``:
plain; under a fault schedule of churn waves, 2% link loss and a
partition window; under it with ``TelemetryConfig()``; with it on
``DelayConfig(4, 2, 8)``; under it armed with the invariant checker) 40
ticks at 20,000 peers and returns a digest of every state leaf, each
tick's delivered words and every frame field per form: the card's run
equals the CPU's digest for digest.

    python -m go_libp2p_pubsub_tpu_torch.floodsub_flagship [--profile 20]

runs both topologies on the GPU and prints one JSON object of their rows
and a profile of ``--profile`` more ticks each (``flagship.profile_ticks``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import convert, flagship, knob_sweep
from .device import resolve_device
from .models import delays as dl
from .models import faults as fl
from .models import floodsub as fs
from .models import invariants as iv
from .models import telemetry as tl
from .ops import graph
from .ops.kernels import _build
from .ops.kernels import fused as kfused
from .ops.kernels import receive as krecv
from .ops.kernels import select as ksel

N_PEERS, N_TOPICS, N_MSGS = 1_000_000, 100, 32
RING_CAND, GATHER_DEGREE = 16, 8
WARMUP, TIMED, REPS = 50, 100, 3
#: messages are published over the first ``horizon - SETTLE`` ticks
SETTLE = 30
CORES = ("circulant", "gather")
#: the card-against-CPU matrix: its width, length and forms
FORM_PEERS, FORM_TICKS = 20_000, 40
FORMS = {
    "plain": {},
    "faults": dict(faults=True),
    "telemetry": dict(faults=True, telemetry=True),
    "delays": dict(faults=True, delays=True, telemetry=True),
    "armed": dict(faults=True, armed=True),
}
DELAYS = dict(base=4, jitter=2, k_slots=8)


def inputs(n_peers: int, n_topics: int, n_msgs: int, horizon: int,
           seed: int = 0):
    """``(subs, msg_topic, msg_origin, msg_publish_tick)`` in the JAX
    package's draw order: peer p subscribed to topic p mod T, messages
    from ``default_rng(seed)`` published over [0, horizon - SETTLE)."""
    n, t = n_peers, n_topics
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    rng = np.random.default_rng(seed)
    topic = rng.integers(0, t, n_msgs)
    origin = rng.integers(0, n // t, n_msgs) * t + topic
    tick = np.sort(rng.integers(0, horizon - SETTLE, n_msgs)).astype(np.int32)
    return subs, topic, origin, tick


def fault_schedule(fl_mod, n: int, horizon: int):
    """The forms' schedule: three churn waves (peers p = 1, 2, 3 mod 50
    down over [5, 15), [12, 22), [20, 30)), 2% link loss, the two index
    halves partitioned over [10, 25)."""
    starts = {1: 5, 2: 12, 3: 20}
    down = [(p, starts[p % 50], starts[p % 50] + 10)
            for p in range(n) if p % 50 in starts]
    return fl_mod.FaultSchedule(
        n_peers=n, horizon=horizon, down_intervals=down, drop_prob=0.02,
        partition_group=(np.arange(n) >= n // 2).astype(np.int32),
        partition_windows=((10, 25),), seed=5)


def build(core: str, device, n_peers: int = N_PEERS,
          n_topics: int = N_TOPICS, horizon: int = WARMUP + TIMED * REPS,
          form: dict | None = None):
    """``(params, state, step_core, msg_topic, subs)`` of ``core`` at
    ``n_peers``; ``form`` (a ``FORMS`` value) arms faults, delays,
    telemetry and the checker."""
    form = form or {}
    subs, topic, origin, tick = inputs(n_peers, n_topics, N_MSGS, horizon)
    kw = dict(track_first_tick=True, device=device)
    if form.get("faults"):
        kw["fault_schedule"] = fault_schedule(fl, n_peers, horizon)
    if form.get("delays"):
        kw["delays"] = dl.DelayConfig(**DELAYS)
    step_kw = dict(
        telemetry=tl.TelemetryConfig() if form.get("telemetry") else None,
        invariants=iv.InvariantConfig() if form.get("armed") else None)
    if core == "circulant":
        offs = tuple(int(o) for o in graph.make_circulant_offsets(
            n_topics, RING_CAND, n_peers, seed=0))
        if "fault_schedule" in kw:
            kw["fault_offsets"] = offs
        params, state = fs.make_flood_sim(None, None, subs, None, topic,
                                          origin, tick, **kw)
        step = fs.make_circulant_step_core(offs, **step_kw)
    else:
        nbrs, mask = graph.build_topic_graph(subs, GATHER_DEGREE, seed=0)
        params, state = fs.make_flood_sim(nbrs, mask, subs, None, topic,
                                          origin, tick, **kw)
        step = fs.make_gather_step_core(**step_kw)
    if form.get("armed"):
        state = iv.attach(state)
    return params, state, step, topic, subs


# -- what the port's kernels did during a run ---------------------------------

def reset_kernel_counts() -> set:
    """Zero the three kernels' launch counts; the libraries loaded so far."""
    krecv.launches.clear()
    ksel.launches = 0
    kfused.launches = kfused.launches_faults = kfused.launches_tel = 0
    return set(_build._LIBS)


def kernel_counts(libs0: set) -> dict:
    """The receive (B1), fused (B2) and select (B3) kernels' launches since
    ``reset_kernel_counts`` and the libraries built since."""
    return dict(receive=sum(krecv.launches.values()),
                fused=(kfused.launches + kfused.launches_faults
                       + kfused.launches_tel),
                select=ksel.launches,
                libraries_built=sorted(set(_build._LIBS) - libs0))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def timed(dev: torch.device, advance, state):
    """``advance(state, ticks) -> state`` run WARMUP ticks, then REPS x
    TIMED timed with a sync after each: ``(state, heartbeats/s, wall s,
    peak bytes)`` (peak over the whole run, None on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = advance(state, WARMUP)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(REPS):
        state = advance(state, TIMED)
        _sync(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    return state, REPS * TIMED / wall, wall, peak


def run(core: str, device=None, n_peers: int = N_PEERS,
        profile_ticks: int = 0) -> dict:
    """FloodSub's ``core`` at ``n_peers`` on ``device`` (default
    ``cuda``): rate, peak memory, launches, the gate, the hop curve; on
    the card with ``profile_ticks``, a profile of that many more ticks."""
    dev = resolve_device(device)
    params, state, step, topic, subs = build(core, dev, n_peers)
    libs0 = reset_kernel_counts()

    def advance(s, ticks):
        return fs.flood_run(params, s, ticks, lambda p, x: step(p, x)[0],
                            device=dev)

    state, hb, wall, peak = timed(dev, advance, state)
    launches = kernel_counts(libs0)
    reach = fs.reach_counts(params, state).cpu().numpy()
    want = subs.sum(0)[topic]
    # the reference's readout counts a delivery at tick h as hop h (its
    # curve assumes publishes at tick 0); beside it, hops since publish
    hops = fs.reach_by_hops(params, state, 16).cpu().numpy()
    ft = fs.first_tick_matrix(state, len(topic)).to(torch.int32)
    since = ft - params.publish_tick[None, :]
    since_pub = torch.cumsum(torch.stack(
        [((since == h) & (ft >= 0)).sum() for h in range(16)]), 0)
    # every message is published at least SETTLE ticks before the end
    gate = bool((reach == want).all())
    idle = (launches["receive"] == launches["fused"] == launches["select"]
            == 0 and not launches["libraries_built"])
    out = dict(core=core, n_peers=n_peers, n_msgs=len(topic),
               ticks=WARMUP + REPS * TIMED, heartbeats_per_s=hb,
               wall_s=wall, peak_bytes=peak, launches=launches,
               reach_min=int(reach.min()), reach_want=int(want.min()),
               reach_by_hops_16=hops.sum(0).tolist(),
               reach_by_hops_since_publish_16=since_pub.cpu().tolist(),
               digest=knob_sweep.tree_digest(convert.flood_state_to_numpy(
                   state)),
               gate=gate, ok=gate and idle)
    if profile_ticks and dev.type == "cuda":
        box = [state]

        def go():
            box[0] = advance(box[0], profile_ticks)
        out["profile"] = flagship.profile_ticks(go, profile_ticks)
    return out


def run_digest(step, params, state, ticks: int, tel: bool) -> str:
    """Step ``ticks`` ticks; the digest of every state leaf, each tick's
    delivered words and, with ``tel``, every frame field."""
    rows, frames = [], []
    for _ in range(ticks):
        out = step(params, state)
        state = out[0]
        rows.append(out[1])
        if tel:
            frames.append(out[2])
    tree = dict(state=(convert.flood_state_to_numpy(state)
                       if isinstance(state, fs.FloodState)
                       else convert.randomsub_state_to_numpy(state)),
                delivered=torch.stack(rows).cpu().numpy())
    if tel:
        tree["frames"] = convert.frame_to_numpy(tl.stack_frames(frames))
    return knob_sweep.tree_digest(tree)


def forms(device=None, n_peers: int = FORM_PEERS,
          ticks: int = FORM_TICKS) -> dict:
    """``{"<core>/<form>": digest}`` of each core in each ``FORMS`` form,
    ``ticks`` ticks at ``n_peers`` on ``device``."""
    dev = resolve_device(device)
    out = {}
    for core in CORES:
        for name, form in FORMS.items():
            params, state, step, _, _ = build(core, dev, n_peers,
                                              horizon=ticks, form=form)
            out[f"{core}/{name}"] = run_digest(
                step, params, state, ticks, bool(form.get("telemetry")))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("this run needs an NVIDIA GPU")
    rows = {core: run(core, profile_ticks=args.profile) for core in CORES}
    print(json.dumps(dict(rows=rows, device=torch.cuda.get_device_name(0),
                          card=flagship.card())))


if __name__ == "__main__":
    main()
