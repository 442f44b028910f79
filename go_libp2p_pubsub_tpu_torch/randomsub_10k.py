"""RandomSub: the JAX package's RandomSub-10k benchmark as written, the
circulant step at the flagship's width, and the card-against-CPU matrix
of both steps' forms.

- ``run(dense=True)``: ``bench_suite.py`` ``bench_randomsub_10k`` as
  written —
  10,000 peers, one topic, M = 32 messages (``default_rng(0)``, published
  over [0, 320)), C = 128 candidates (``make_randomsub_offsets(1, 128,
  10_000, seed=0)``; the dense step samples every topic member), the dense
  step (``make_randomsub_dense_step``), 50 warm-up ticks, then 3 x 100
  timed; its gate: every message reached all 10,000 peers; its metric:
  heartbeats/s.
- ``run(dense=False)``: the circulant step at full width — 1,000,000 peers,
  100 topics (peer p in topic p mod 100), C = 128
  (``make_randomsub_offsets(100, 128, 1_000_000, seed=0)``), M = 32 drawn
  the same way, the same tick counts; its gate: every message reached
  every member of its topic.

Each returns heartbeats/s, the peak device memory, the kernel launches
(none: the reference leaves RandomSub to XLA, and the dense hop is a
``torch.matmul``, as its ``jnp.dot`` is) and on the card a profile of
``profile_ticks`` more ticks (``flagship.profile_ticks``: idle share,
launches a tick).  ``forms(device)`` digests each step form
(``floodsub_flagship.FORMS``) of the circulant step at 20,000 peers and
of the dense step at ``DENSE_FORM_PEERS``, 40 ticks each.

    python -m go_libp2p_pubsub_tpu_torch.randomsub_10k [--profile 20]

runs both on the GPU and prints one JSON object.
"""

from __future__ import annotations

import argparse
import json

import torch

from . import convert, flagship, knob_sweep
from .device import resolve_device
from .floodsub_flagship import (
    DELAYS,
    FORM_PEERS,
    FORM_TICKS,
    FORMS,
    N_MSGS,
    REPS,
    TIMED,
    WARMUP,
    fault_schedule,
    inputs,
    kernel_counts,
    reset_kernel_counts,
    run_digest,
    timed,
)
from .models import delays as dl
from .models import faults as fl
from .models import invariants as iv
from .models import randomsub as rs
from .models import telemetry as tl

N_CAND = 128
DENSE_PEERS, DENSE_TOPICS = 10_000, 1
WIDE_PEERS, WIDE_TOPICS = 1_000_000, 100
#: the dense step's forms run at this width: the CPU side of the matrix
#: draws K [N, N] adjacencies a tick
DENSE_FORM_PEERS = 1_000


def build(dense: bool, device, n_peers: int, n_topics: int,
          horizon: int = WARMUP + TIMED * REPS, form: dict | None = None):
    """``(cfg, params, state, step, msg_topic, subs)``: the benchmark's
    configuration at ``n_peers`` x ``n_topics`` (C = 128, seed 0), the
    dense or the circulant step; ``form`` arms faults (the dense step: the
    scalar drop and the partitions), delays, telemetry and the checker."""
    form = form or {}
    subs, topic, origin, tick = inputs(n_peers, n_topics, N_MSGS, horizon)
    cfg = rs.RandomSubSimConfig(
        offsets=rs.make_randomsub_offsets(n_topics, N_CAND, n_peers, seed=0),
        n_topics=n_topics)
    kw = dict(dense=dense, device=device)
    if form.get("faults"):
        kw["fault_schedule"] = fault_schedule(fl, n_peers, horizon)
    if form.get("delays"):
        kw["delays"] = dl.DelayConfig(**DELAYS)
    params, state = rs.make_randomsub_sim(cfg, subs, topic, origin, tick,
                                          **kw)
    make = rs.make_randomsub_dense_step if dense else rs.make_randomsub_step
    step = make(cfg,
                telemetry=tl.TelemetryConfig() if form.get("telemetry")
                else None,
                invariants=iv.InvariantConfig() if form.get("armed")
                else None)
    if form.get("armed"):
        state = iv.attach(state)
    return cfg, params, state, step, topic, subs


def run(dense: bool, device=None, n_peers: int | None = None,
        profile_ticks: int = 0) -> dict:
    """The dense benchmark (``DENSE_PEERS``) or the circulant step
    (``WIDE_PEERS``) on ``device`` (default ``cuda``): rate, peak memory,
    launches, the reach gate, a state digest and, on the card with
    ``profile_ticks``, a profile."""
    dev = resolve_device(device)
    n = n_peers or (DENSE_PEERS if dense else WIDE_PEERS)
    t = DENSE_TOPICS if dense else WIDE_TOPICS
    _, params, state, step, topic, subs = build(dense, dev, n, t)
    libs0 = reset_kernel_counts()

    def advance(s, ticks):
        return rs.randomsub_run(params, s, ticks, step, device=dev)

    state, hb, wall, peak = timed(dev, advance, state)
    launches = kernel_counts(libs0)
    reach = rs.reach_counts(params, state).cpu().numpy()
    want = subs.sum(0)[topic]
    gate = bool((reach == want).all())
    idle = (launches["receive"] == launches["fused"] == launches["select"]
            == 0 and not launches["libraries_built"])
    out = dict(step="dense" if dense else "circulant", n_peers=n,
               n_topics=t, n_candidates=N_CAND, n_msgs=len(topic),
               ticks=WARMUP + REPS * TIMED, heartbeats_per_s=hb, wall_s=wall,
               peak_bytes=peak, launches=launches,
               reach_min=int(reach.min()), reach_want=int(want.min()),
               digest=knob_sweep.tree_digest(
                   convert.randomsub_state_to_numpy(state)),
               gate=gate, ok=gate and idle)
    if profile_ticks and dev.type == "cuda":
        box = [state]

        def go():
            box[0] = advance(box[0], profile_ticks)
        out["profile"] = flagship.profile_ticks(go, profile_ticks)
    return out


def forms(device=None, n_peers: int = FORM_PEERS,
          n_dense: int = DENSE_FORM_PEERS, ticks: int = FORM_TICKS) -> dict:
    """``{"<step>/<form>": digest}``: the circulant step at ``n_peers``
    x 100 topics and the dense step at ``n_dense`` x 2 topics (the
    same-topic mask live), each ``FORMS`` form, ``ticks`` ticks on
    ``device``."""
    dev = resolve_device(device)
    out = {}
    for dense, n, t in ((False, n_peers, WIDE_TOPICS), (True, n_dense, 2)):
        for name, form in FORMS.items():
            _, params, state, step, _, _ = build(dense, dev, n, t,
                                                 horizon=ticks, form=form)
            key = f"{'dense' if dense else 'circulant'}/{name}"
            out[key] = run_digest(step, params, state, ticks,
                                  bool(form.get("telemetry")))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("this run needs an NVIDIA GPU")
    rows = {("dense" if d else "circulant"): run(d, profile_ticks=args.profile)
            for d in (True, False)}
    print(json.dumps(dict(rows=rows, device=torch.cuda.get_device_name(0),
                          card=flagship.card())))


if __name__ == "__main__":
    main()
