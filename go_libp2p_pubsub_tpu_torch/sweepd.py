"""sweepd: the resident scenario server, the port's copy of the JAX
package's ``tools/sweepd.py``.

One process builds ONE step for a fixed simulation shape, then serves an
open-ended stream of scenario requests: parameter studies, attack
tournaments, regression sweeps.  Every request is data (a SimKnobs
protocol point, a fault rate, an attack formation, a seed); requests are
validated, batched into the fixed-shape ``gossip_run_knob_batch`` dispatch
(a partial batch padded with the reference scenario) and answered with
per-scenario delivery and invariant rows.

    python -m go_libp2p_pubsub_tpu_torch.sweepd [--peers 10000] [--topics 10]
        [--msgs 16] [--ticks 100] [--batch 6] [--seed 0] [--no-invariants]
        [--kernel] [--k-slots K] [--socket PATH] [--journal PATH]
        [--metrics-port PORT] [--device cpu]
        [--multi [--max-buckets 4] [--queue-cap 512] [--aot-dir DIR]
         [--long-ticks T --ckpt-dir DIR [--ckpt-every K]]]

Protocol: JSON lines on stdin (default) or a Unix socket (``--socket``,
one thread per connection, all sharing the one server).  One scenario
per line:

    {"id": "s1", "knobs": {"d": 8, "gossip_factor": 0.4},
     "drop_prob": 0.02, "churn": true,
     "attack": "spam", "attack_frac": 0.1, "seed": 3}

Every field but ``id`` is optional; ``knobs`` takes any liftable knob
(``models/knobs.py``); a shape-bearing field is rejected by name, as the
scenario's error row (the server keeps serving).  Control lines:
``{"cmd": "flush"}`` dispatches a partial batch, ``{"cmd": "stats"}``
emits the counters row, ``{"cmd": "metrics"}`` the observability snapshot
(``--metrics-port`` serves it over loopback HTTP: /metrics, /metrics.json,
/trace.json).  EOF flushes and exits; SIGTERM/SIGINT drain the pending
batch at the next line and exit 0.  With ``--journal PATH`` every
accepted scenario line is appended (CRC-suffixed, fsync'd) before it is
batched, and lines a killed server left there are replayed on restart.

Result rows (one JSON line per scenario):

    {"id": "s1", "ok": true, "batch": 0, "honest_delivery_fraction": 0.99,
     "delivery_fraction": 0.98, "inv_bits": 0, "inv_first": -1}

The batched server (default) runs the tournament's static config, every
attack behaviour compiled in and selected per scenario by flag arrays: its
cells carry byzantine flags and a SimKnobs point on an IWANT-flood
config, so its step takes the receive loops (``models/_receive_loops.py``)
and B3 once a selection for the whole stack.  The kernel server
(``--kernel``, batch 1) arms what the receive kernel takes (its attack
axis: clean, spam, eclipse) and runs every tick on B1, one scenario at a
time, unpadded.

``compiles`` counts the distinct step objects this server's dispatches
have used since construction: 0 before the first dispatch, 1 after, and 1
after any number of scenarios — the step is built once per shape and
every scenario is data of its params (PyTorch keeps no compile cache; the
CUDA kernels are built once per source by ``ops/kernels/_build.py``).

``--multi`` swaps the one-shape engine for the multi-tenant front end
(``serving/``): requests may carry their own shape (``n``/``t``/``m``/
``ticks``/``k_slots``) plus ``deadline_s`` and ``priority``; shapes
quantize into ``--max-buckets`` LRU-managed resident bucket servers
(``--peers``/``--topics``/``--msgs``/``--ticks`` become the default
shape), ``--aot-dir`` keeps each bucket's runner record across restarts,
``--queue-cap`` admission control rejects overloads by name, and requests
past ``--long-ticks`` run through the checkpointed runner, so a kill -9
mid-scenario resumes to the bit-identical digest.  Same line protocol,
same ``--socket`` / ``--journal`` / ``--metrics-port`` plumbing.

Refused by name: ``--devices`` (the sharded step, A9: ``serve_devices``;
with ``--kernel`` the reference's ``serve.kernel-devices``), ``--k-slots``
on the batched server (its receive loops take no delay lines:
``loops_delays``; under ``--multi`` a ``k_slots`` request's row names it),
a kernel server with a batch other than 1 (``serve.kernel-batch``),
``--multi --kernel`` (the reference's message).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .device import resolve_device
from .models import faults as _faults
from .models import gossipsub as gs
from .models import invariants as iv
from .models import knobs as kn
from .models import plan
from .models.delays import DelayConfig
from .parallel import checkpoint as ck
from .tournament import _cached_step, tournament_static_config

#: scenario attack kinds (the tournament's formation axis; "clean" is the
#: no-attack control)
ATTACK_KINDS = ("clean", "spam", "eclipse", "byzantine")


def server_capability(*, kernel: bool = False, batch: int = 1,
                      devices: int = 0) -> str | None:
    """None when the server's execution-path choice is served, else the
    refusal's text (``plan.plan_serving``)."""
    verdict = plan.plan_serving(kernel=kernel, batch=batch, devices=devices)
    return None if isinstance(verdict, plan.ExecutionPlan) \
        else verdict.message


def _kernel_attack_axis(device):
    """The kernel server's attack axis, from the step's own route: each
    tournament behaviour is armed on a tiny probe build with a SimKnobs
    point (every dispatch carries one) and kept only where
    ``kernel_capability`` says the step takes B1.  Returns ``(kinds,
    armed_sc_fields, refusals)``, ``refusals`` mapping a dropped kind (or
    behaviour) to the reason, which the unknown-attack error row
    carries."""
    n, t, m = 256, 2, 2
    offsets = gs.make_gossip_offsets(t, 16, n, seed=0)
    cfg = gs.GossipSimConfig(offsets=offsets, n_topics=t)
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    origin = np.arange(m, dtype=np.int64)
    topic = (origin % t).astype(np.int64)
    pub = np.zeros(m, dtype=np.int32)
    flags = np.zeros(n, dtype=bool)
    behaviors = (
        ("sybil_ihave_spam", dict(sybil=flags), "spam"),
        ("sybil_iwant_spam", dict(sybil=flags), None),
        ("sybil_eclipse", dict(eclipse_sybil=flags,
                               eclipse_victim=flags), "eclipse"),
        ("byzantine_mutation", dict(byzantine=flags), "byzantine"),
    )
    kinds, armed, refusals = ["clean"], {}, {}
    for field, formation, kind in behaviors:
        sc = gs.ScoreSimConfig(**{field: True})
        params, state = gs.make_gossip_sim(
            cfg, subs, topic, origin, pub, score_cfg=sc, sim_knobs={},
            track_first_tick=False, device=device, **formation)
        reason = gs.kernel_capability(cfg, sc, params, state)
        if reason is None:
            armed[field] = True
            if kind is not None:
                kinds.append(kind)
        else:
            refusals[kind if kind is not None else field] = reason
    return tuple(kinds), armed, refusals


class SweepServer:
    """The resident engine: one step, arbitrary scenarios.

    The static surface is fixed at construction (peer count, topics,
    message schedule, candidate ring, batch size, attack/victim/churn
    pools, invariant arming, execution path); everything else arrives as
    request data.  ``device`` defaults to ``cuda``."""

    def __init__(self, n: int = 10_000, t: int = 10, m: int = 16,
                 ticks: int = 100, batch: int = 6,
                 n_candidates: int = 16, seed: int = 0,
                 invariants: bool = True, kernel: bool = False,
                 attack_pool_frac: float = 0.2,
                 victim_pool_frac: float = 0.1,
                 churn_pool_frac: float = 0.1, devices: int = 0,
                 k_slots: int = 0, obs=None, device=None):
        self.device = resolve_device(device)
        self.n, self.t, self.m, self.ticks = n, t, m, ticks
        self.batch = batch
        self.kernel = kernel
        self.k_slots = k_slots
        verdict = plan.plan_serving(kernel=kernel, batch=batch,
                                    devices=devices)
        if isinstance(verdict, plan.Refusal):
            verdict.raise_()
        rng = np.random.default_rng(seed)
        offsets = gs.make_gossip_offsets(t, n_candidates, n, seed=seed)
        self._kind_refusals: dict = {}
        if kernel:
            # the kernel server's attack axis comes from the step's own
            # route: the IWANT flood under a knob point and byzantine
            # mutation take the receive loops, so they are not armed
            kinds, armed, self._kind_refusals = _kernel_attack_axis(
                self.device)
            self.cfg = gs.GossipSimConfig(offsets=offsets, n_topics=t)
            self.sc = gs.ScoreSimConfig(**armed)
            self.attack_kinds = kinds
        else:
            self.cfg, self.sc = tournament_static_config(offsets, t)
            self.attack_kinds = ATTACK_KINDS
        self.invariants = iv.InvariantConfig() if invariants else None
        self.sim_fixed_kw = {}
        if k_slots:
            # the delay line armed: delay_base / delay_jitter become
            # servable knobs, the base point the one-hop identity
            delay_cfg = DelayConfig(base=1, jitter=0, k_slots=k_slots,
                                    seed=seed)
            if not kernel:
                # every batched cell takes the receive loops, which take
                # no delay lines yet
                plan.check_loops(paired=False, telemetry=None,
                                 delays=delay_cfg)
            self.sim_fixed_kw["delays"] = delay_cfg
        self.step = _cached_step(self.cfg, self.sc, invariants,
                                 self.device)

        # fixed peer-role pools: a scenario's attack_frac selects a PREFIX
        # of the attacker pool, so formations stay data under one shape
        self.attack_pool = np.zeros(n, dtype=bool)
        self.attack_pool[: int(n * attack_pool_frac)] = True
        self.victims = np.zeros(n, dtype=bool)
        self.victims[int(n * attack_pool_frac):
                     int(n * (attack_pool_frac + victim_pool_frac))] = True
        pool = np.flatnonzero(~self.attack_pool & ~self.victims)
        # fixed message schedule from never-attacker origins, publishes
        # inside the first 60% of the horizon
        origin = pool[rng.integers(0, len(pool), m)]
        self.topic = (origin % t).astype(np.int64)
        self.origin = origin
        self.pub_tick = np.sort(
            rng.integers(0, max(1, int(ticks * 0.6)), m)).astype(np.int32)
        self.subs = np.zeros((n, t), dtype=bool)
        self.subs[np.arange(n), np.arange(n) % t] = True
        # fixed churner set; a scenario's "churn" toggles live intervals
        # against (p, 0, 0) no-ops, so every replica's table has one shape
        churners = pool[rng.random(len(pool)) < churn_pool_frac]
        lo = max(1, int(ticks * 0.3))
        self._churn_ivs = tuple(
            (int(p), min(lo + int(p % 3) * 4, ticks),
             min(lo + 8 + int(p % 3) * 4, ticks))
            for p in churners)
        self._noop_ivs = tuple((int(p), 0, 0) for p in churners)
        self._zeros = np.zeros(n, dtype=bool)
        self.members = np.arange(n) % t

        # counters
        self.served = 0
        self.batches = 0
        self.errors = 0
        self.wall_s = 0.0
        self._steps_used: set[int] = set()
        self.obs = obs
        self._mx = None
        if obs is not None:
            reg = obs.metrics
            self._mx = {
                "sweepd_served_total": lambda: self.served,
                "sweepd_batches_total": lambda: self.batches,
                "sweepd_errors_total": lambda: self.errors,
            }
            for name in self._mx:
                reg.counter(name)
            self._g_compiles = reg.gauge(
                "sweepd_compiles",
                "distinct steps this server's dispatches used (the "
                "claim: 1)")
            self._g_device = reg.gauge(
                "sweepd_device_seconds",
                "cumulative device-dispatch wall seconds")
            self._g_pending = reg.gauge(
                "sweepd_pending", "scenarios accepted, not dispatched")
        self._pending: list[dict] = []
        #: raw journal lines parallel to _pending (the accepted but
        #: undispatched scenarios a crash must not lose)
        self._pending_raw: list[str] = []
        self._journal: str | None = None
        #: the front end's hook (serving/buckets.py): a checked
        #: bucket-runner record's dispatch, substituted for the batched
        #: dispatch of a bucket loaded from an AOT directory
        self._aot_runner = None
        self._t0 = time.perf_counter()

    # -- request validation / build ------------------------------------

    def _build_kwargs(self, req: dict) -> dict:
        """make_gossip_sim keyword arguments for one validated request.
        Raises ValueError (KnobStaticFieldError too) naming the bad field;
        the caller turns it into an error row."""
        known = {"id", "cmd", "seed", "knobs", "drop_prob", "churn",
                 "attack", "attack_frac"}
        unknown = set(req) - known
        if unknown:
            raise ValueError(
                f"scenario: unknown field(s) {sorted(unknown)} — "
                f"valid fields are {sorted(known)}")
        raw_knobs = req.get("knobs") or {}
        if not isinstance(raw_knobs, dict):
            raise ValueError(
                "scenario: knobs must be a JSON object, got "
                f"{type(raw_knobs).__name__}")
        knobs = dict(raw_knobs)
        # static fields rejected up front by name; the fault split also
        # catches drop_prob nested in knobs, so the top-level default
        # below cannot clobber it
        _, _, fault_kv, delay_kv = kn.split_knob_overrides(knobs)
        if delay_kv and not self.k_slots:
            raise ValueError(
                "scenario: delay knobs (delay_base/delay_jitter) need "
                "a delay-armed server config — this server was built "
                "without a DelayConfig, so the delay-line code path "
                "is not compiled in (start sweepd with --k-slots K)")
        if "drop_prob" in req and "drop_prob" in fault_kv:
            raise ValueError(
                "scenario: drop_prob given both top-level and inside "
                "knobs — pick one")
        drop = float(fault_kv.get("drop_prob", req.get("drop_prob", 0.0)))
        if not (0.0 <= drop <= 1.0):
            raise ValueError(f"scenario: drop_prob={drop} outside "
                             "[0, 1]")
        knobs["drop_prob"] = drop
        attack = req.get("attack", "clean")
        if attack not in self.attack_kinds:
            hint = self._kind_refusals.get(attack)
            raise ValueError(
                f"scenario: unknown attack {attack!r} — this "
                f"server's kinds are {self.attack_kinds}"
                + (f" ({hint})" if hint else ""))
        frac = float(req.get("attack_frac",
                             0.0 if attack == "clean" else 0.1))
        pool_frac = self.attack_pool.mean()
        if not (0.0 <= frac <= pool_frac):
            raise ValueError(
                f"scenario: attack_frac={frac} outside [0, "
                f"{pool_frac}] (the server's attacker pool)")
        attackers = self._zeros
        if attack != "clean" and frac > 0:
            attackers = np.zeros(self.n, dtype=bool)
            attackers[: int(self.n * frac)] = True
        churn = bool(req.get("churn", False))
        # the placeholder rate only has to be nonzero so the link path
        # is built: the drop_prob knob overrides it at run time
        sched = _faults.FaultSchedule(
            n_peers=self.n, horizon=self.ticks,
            down_intervals=(self._churn_ivs if churn else self._noop_ivs),
            drop_prob=0.5, seed=int(req.get("seed", 0)))
        return dict(
            subs=self.subs, msg_topic=self.topic,
            msg_origin=self.origin, msg_publish_tick=self.pub_tick,
            seed=int(req.get("seed", 0)), track_first_tick=False,
            sybil=(attackers if attack == "spam" else self._zeros),
            eclipse_sybil=(attackers if attack == "eclipse"
                           else self._zeros),
            eclipse_victim=(self.victims if attack == "eclipse"
                            else self._zeros),
            byzantine=(None if "byzantine" not in self.attack_kinds
                       else (attackers if attack == "byzantine"
                             else self._zeros)),
            fault_schedule=sched, sim_knobs=knobs,
            **self.sim_fixed_kw)

    # -- dispatch ------------------------------------------------------

    def _dispatch(self, kwargs: list[dict], honest: np.ndarray):
        """Build, arm and run one batch: ``(reach [B, M], inv_bits [B],
        inv_first [B])`` on the host (the checker's two as None when it is
        off)."""
        dev = self.device
        builds = [gs.make_gossip_sim(self.cfg, score_cfg=self.sc,
                                     device=dev, **kw) for kw in kwargs]
        states = [b[1] for b in builds]
        if self.invariants is not None:
            states = [iv.attach(s) for s in states]
        self._steps_used.add(id(self.step))
        if self.batch == 1:
            params, state = builds[0][0], states[0]
            state = gs.gossip_run(params, state, self.ticks, self.step,
                                  device=dev)
            mask = torch.as_tensor(honest[0], device=dev)
            reach = gs.reach_counts_from_have(params, state, mask)[None]
        else:
            params = gs.stack_trees([b[0] for b in builds])
            state = gs.stack_trees(states)
            if self._aot_runner is not None:
                state, reach = self._aot_runner(params, state, honest)
            else:
                state, reach = gs.gossip_run_knob_batch(
                    params, state, self.ticks, self.step, honest,
                    device=dev)
        reach = reach.cpu().numpy()
        if self.invariants is None:
            return reach, None, None
        bits = state.inv_viol.reshape(-1).cpu().numpy().view(np.uint32)
        first = state.inv_first.reshape(-1).cpu().numpy()
        return reach, bits, first

    def submit(self, requests: list[dict]) -> list[dict]:
        """Validate and serve a list of scenario requests: one result row
        per request, in order.  An invalid request comes back as ``{"id",
        "ok": false, "error"}`` without poisoning its batch."""
        rows: list[dict | None] = [None] * len(requests)
        good: list[tuple[int, dict, dict]] = []
        for i, req in enumerate(requests):
            if not isinstance(req, dict):
                self.errors += 1
                rows[i] = {"id": i, "ok": False,
                           "error": "scenario: request must be a "
                                    f"JSON object, got "
                                    f"{type(req).__name__}"}
                continue
            try:
                good.append((i, req, self._build_kwargs(req)))
            except (ValueError, TypeError) as e:
                # wrong-typed fields in well-formed JSON ({"knobs": [1]},
                # {"seed": {}}) must not poison the batch or the server
                self.errors += 1
                rows[i] = {"id": req.get("id", i), "ok": False,
                           "error": str(e)}
        for lo in range(0, len(good), max(self.batch, 1)):
            chunk = good[lo:lo + self.batch]
            pad = self.batch - len(chunk)
            kwargs = [kw for _, _, kw in chunk]
            # a partial batch is padded with the reference scenario, so
            # the dispatch's shape never changes
            kwargs += [self._build_kwargs({})] * pad
            t0 = time.perf_counter()
            honest = np.stack(
                [~(np.asarray(kw["sybil"]) | np.asarray(kw["eclipse_sybil"])
                   | (np.asarray(kw["byzantine"])
                      if kw["byzantine"] is not None else False))
                 for kw in kwargs])
            reach, inv_bits, inv_first = self._dispatch(kwargs, honest)
            self.wall_s += time.perf_counter() - t0
            self.batches += 1
            want_all = np.array(
                [(self.members == tau).sum() for tau in self.topic],
                dtype=np.float64)
            for k, (i, req, kw) in enumerate(chunk):
                honest_row = honest[k]
                want = np.array(
                    [(honest_row & (self.members == tau)).sum()
                     for tau in self.topic], dtype=np.float64)
                row = {
                    "id": req.get("id", i), "ok": True,
                    "batch": self.batches - 1,
                    "honest_delivery_fraction":
                        round(float((reach[k] / want).mean()), 4),
                    "delivery_fraction":
                        round(float((reach[k] / want_all).mean()), 4),
                }
                if inv_bits is not None:
                    row["inv_bits"] = int(inv_bits[k])
                    row["inv_first"] = int(inv_first[k])
                rows[i] = row
                self.served += 1
        self._publish_metrics()
        return rows  # type: ignore[return-value]

    def _publish_metrics(self) -> None:
        """Mirror the counters into the registry in one atomic block."""
        if self.obs is None:
            return
        reg = self.obs.metrics
        with reg.atomic():
            for name, read in self._mx.items():
                reg.counter(name).set_total(read())
            self._g_compiles.set(self.compiles())
            self._g_device.set(round(self.wall_s, 6))
            self._g_pending.set(len(self._pending))

    # -- counters ------------------------------------------------------

    def compiles(self) -> int:
        """The distinct step objects this server's dispatches have used
        since construction: 0 before the first dispatch, then 1 for any
        number of scenarios."""
        return len(self._steps_used)

    def stats(self) -> dict:
        dev = self.wall_s
        return {
            "stats": True, "served": self.served,
            "batches": self.batches, "errors": self.errors,
            "compiles": self.compiles(),
            "configs_per_compile":
                round(self.served / max(self.compiles(), 1), 2),
            "replica_hbps": round(
                self.served * self.ticks / dev, 2) if dev else None,
            "requests_per_sec": round(
                self.served / dev, 3) if dev else None,
            "wall_s": round(time.perf_counter() - self._t0, 2),
            "device_s": round(dev, 2),
            "shape": {"n": self.n, "t": self.t, "m": self.m,
                      "ticks": self.ticks, "batch": self.batch,
                      "kernel": self.kernel,
                      "k_slots": self.k_slots,
                      "aot": self._aot_runner is not None,
                      "devices": 1},
        }

    # -- line protocol -------------------------------------------------

    def _journal_append(self, raw: str) -> None:
        if self._journal is None:
            return
        with open(self._journal, "a") as f:
            # the CRC32 suffix: a line torn by a kill mid-write is dropped
            # on replay, not served as a bad-JSON error row
            f.write(ck.journal_encode_line(raw) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def _journal_compact(self) -> None:
        """Rewrite the journal to exactly the undispatched lines,
        atomically (a crash mid-compaction must not lose scenarios)."""
        if self._journal is None:
            return
        from .artifacts import write_text_atomic
        write_text_atomic(self._journal,
                          "".join(ck.journal_encode_line(r) + "\n"
                                  for r in self._pending_raw))

    def serve_lines(self, lines, out, *, journal=None, lock=None) -> None:
        """Drive the server from an iterable of JSON lines, writing result
        rows to ``out`` (a writable file object).  Requests accumulate to
        full batches; ``{"cmd": "flush"}`` dispatches a partial batch,
        ``{"cmd": "stats"}`` emits the counters, ``{"cmd": "metrics"}``
        the registry snapshot (needs an ``obs`` bundle).  EOF flushes.
        ``lock`` (a shared ``threading.RLock``) serializes line handling
        when several connection threads drive ONE server.

        With ``journal=PATH`` every accepted scenario line is appended
        (fsync'd) to PATH before it can be batched, and the journal is
        compacted to the undispatched lines after every dispatch, so a
        killed server loses no accepted scenario; lines already in PATH
        are replayed first.  A pending stop (``checkpoint.request_stop``,
        set by the deferred SIGTERM/SIGINT handlers) drains the server at
        the next line: the pending batch is dispatched, its rows and the
        stats row are emitted, and serve_lines returns."""
        import contextlib

        lk = lock if lock is not None else contextlib.nullcontext()
        self._journal = journal

        def emit(obj):
            out.write(json.dumps(obj) + "\n")
            out.flush()

        def flush():
            if self._pending:
                reqs = list(self._pending)
                self._pending.clear()
                self._pending_raw.clear()
                rows = self.submit(reqs)
                # compact only once the dispatch completed: a crash
                # mid-submit leaves the lines journaled (replaying a
                # dispatched scenario only costs device time)
                self._journal_compact()
                for row in rows:
                    emit(row)

        def handle(raw: str, *, journal_new: bool) -> None:
            try:
                req = json.loads(raw)
            except json.JSONDecodeError as e:
                self.errors += 1
                emit({"ok": False, "error": f"bad JSON: {e}"})
                return
            if not isinstance(req, dict):
                self.errors += 1
                emit({"ok": False,
                      "error": "request must be a JSON object, got "
                               f"{type(req).__name__}"})
                return
            cmd = req.get("cmd")
            if cmd == "flush":
                flush()
            elif cmd == "stats":
                flush()
                emit(self.stats())
            elif cmd == "metrics":
                if self.obs is None:
                    emit({"ok": False,
                          "error": "metrics: this server carries no "
                                   "observability bundle (construct "
                                   "SweepServer with obs=, or drive "
                                   "it through sweepd main())"})
                else:
                    self._publish_metrics()
                    emit({"metrics": True,
                          "families": self.obs.metrics.snapshot(),
                          "spans": self.obs.spans.summary()})
            elif cmd:
                self.errors += 1
                emit({"ok": False,
                      "error": f"unknown cmd {cmd!r} "
                               "(flush/stats/metrics)"})
            else:
                self._pending.append(req)
                self._pending_raw.append(raw)
                if journal_new:
                    self._journal_append(raw)
                self._publish_metrics()
                if len(self._pending) >= self.batch:
                    flush()

        if journal is not None:
            replay, torn = ck.read_journal(journal)
            if torn:
                print(f"sweepd: dropping {torn} torn journal line(s) "
                      "(CRC mismatch — the writer died mid-append); "
                      f"replaying the {len(replay)} intact line(s)",
                      file=sys.stderr, flush=True)
            if replay:
                print(f"sweepd: replaying {len(replay)} journaled "
                      "scenario line(s) from an interrupted run",
                      file=sys.stderr, flush=True)
                with lk:
                    for raw in replay:
                        # already on disk: appending again would
                        # duplicate them
                        handle(raw, journal_new=False)
                    # a flush during the replay compacted away lines
                    # accepted after it: rewrite the journal to the
                    # surviving partial batch
                    self._journal_compact()

        for line in lines:
            line = line.strip()
            if line:
                with lk:
                    handle(line, journal_new=True)
            if ck.stop_requested():
                print("sweepd: stop requested — draining the pending "
                      "batch and exiting", file=sys.stderr, flush=True)
                break
        with lk:
            flush()
            emit(self.stats())


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m go_libp2p_pubsub_tpu_torch.sweepd",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--peers", type=int, default=10_000)
    ap.add_argument("--topics", type=int, default=10)
    ap.add_argument("--msgs", type=int, default=16)
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-invariants", action="store_true")
    ap.add_argument("--kernel", action="store_true",
                    help="the receive-kernel server (one scenario at a "
                         "time, batch 1)")
    ap.add_argument("--devices", type=int, default=0,
                    help="refused: the sharded dispatch waits for the "
                         "sharded step")
    ap.add_argument("--k-slots", type=int, default=0,
                    help="arm the K-deep delay line: delay_base / "
                         "delay_jitter become servable knobs (the "
                         "kernel server; the batched server's receive "
                         "loops refuse it)")
    ap.add_argument("--socket", metavar="PATH",
                    help="serve a Unix socket instead of stdin (a thread "
                         "per connection, one shared server)")
    ap.add_argument("--metrics-port", type=int, metavar="PORT",
                    help="serve the observability plane over loopback "
                         "HTTP (/metrics, /metrics.json, /trace.json); 0 "
                         "binds an ephemeral port (printed to stderr)")
    ap.add_argument("--journal", metavar="PATH",
                    help="fsync'd journal of accepted, undispatched "
                         "scenario lines, replayed on restart")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--multi", action="store_true",
                    help="the multi-tenant front end: requests may carry "
                         "their own shape (n/t/m/ticks/k_slots) plus "
                         "deadline_s and priority; shapes quantize into "
                         "LRU-managed resident buckets, --peers/--topics/"
                         "--msgs/--ticks become the default shape")
    ap.add_argument("--max-buckets", type=int, default=4,
                    help="resident bucket cap (LRU eviction)")
    ap.add_argument("--queue-cap", type=int, default=512,
                    help="admission-control queue depth; admissions past "
                         "it come back as explicit 'overloaded' rows")
    ap.add_argument("--aot-dir", metavar="DIR",
                    help="keep each bucket's runner record here; a "
                         "restarted server loads it instead of "
                         "registering a new runner")
    ap.add_argument("--long-ticks", type=int, default=0,
                    help="route requests with ticks >= this through the "
                         "checkpointed runner (preemption-surviving; "
                         "needs --ckpt-dir)")
    ap.add_argument("--ckpt-dir", metavar="DIR",
                    help="snapshot root for long scenarios")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="segment length for long scenarios (0 = "
                         "horizon/4)")
    return ap


#: the reference's refusal of ``--multi --kernel``
MSG_MULTI_KERNEL = ("sweepd: --multi refuses --kernel — the kernel-path "
                    "server is the sequential demonstration (batch=1, one "
                    "shape); serve it without --multi")


def make_server(ns: argparse.Namespace, obs):
    """The server ``main`` serves: the multi-tenant front end under
    ``--multi``, else the one-shape engine."""
    if ns.multi:
        from .serving import FrontendConfig, ScenarioFrontend
        server_kw = {"seed": ns.seed, "invariants": not ns.no_invariants}
        if ns.devices:
            server_kw["devices"] = ns.devices
        if ns.device is not None:
            server_kw["device"] = ns.device
        return ScenarioFrontend(FrontendConfig(
            max_buckets=ns.max_buckets, batch=ns.batch,
            queue_cap=ns.queue_cap,
            default_shape=(ns.peers, ns.topics, ns.msgs, ns.ticks),
            aot_dir=ns.aot_dir, long_ticks=ns.long_ticks,
            ckpt_dir=ns.ckpt_dir, ckpt_every=ns.ckpt_every,
            server_kw=server_kw), obs=obs)
    return SweepServer(n=ns.peers, t=ns.topics, m=ns.msgs, ticks=ns.ticks,
                       batch=(1 if ns.kernel else ns.batch), seed=ns.seed,
                       invariants=not ns.no_invariants, kernel=ns.kernel,
                       devices=ns.devices, k_slots=ns.k_slots, obs=obs,
                       device=ns.device)


def main(argv=None) -> int:
    ns = parser().parse_args(argv)
    if ns.multi and ns.kernel:
        print(MSG_MULTI_KERNEL, file=sys.stderr)
        return 2
    # deferred SIGTERM/SIGINT: the handler only sets a flag; the serve
    # loops drain the pending batch, emit its rows and exit cleanly
    prev = ck.install_kill_handlers()
    from . import obs as _obs
    obs = _obs.Observability()
    try:
        srv = make_server(ns, obs)
    except plan.SliceRefusal as e:
        ck._restore_handlers(prev)
        print(f"sweepd: {e}", file=sys.stderr)
        return 2
    except ValueError as e:
        ck._restore_handlers(prev)
        print(f"sweepd: {e}", file=sys.stderr)
        return 2
    scrape = None
    if ns.metrics_port is not None:
        scrape = obs.scrape_server(port=ns.metrics_port)
        print(f"sweepd: metrics at {scrape.url()}", file=sys.stderr,
              flush=True)
    try:
        if ns.socket:
            _serve_socket(srv, ns.socket, ns.journal)
        else:
            srv.serve_lines(sys.stdin, sys.stdout, journal=ns.journal)
    finally:
        if scrape is not None:
            scrape.close()
        ck._restore_handlers(prev)
    return 0


def _serve_socket(srv, path: str, journal) -> None:
    """A Unix socket, a thread per connection: a shared RLock serializes
    line handling inside the one server (a ``SweepServer`` or, under
    ``--multi``, a ``ScenarioFrontend``); the stop flag is polled between
    accepts (1 s timeout), so a SIGTERM with no client exits promptly."""
    import socket as sk
    import threading

    try:
        os.unlink(path)
    except FileNotFoundError:
        pass
    serve_lock = threading.RLock()
    conn_threads: list = []

    def serve_conn(conn):
        try:
            with conn, conn.makefile("r") as rf, conn.makefile("w") as wf:
                srv.serve_lines(rf, wf, journal=journal, lock=serve_lock)
        except (BrokenPipeError, ConnectionResetError) as e:
            # a client vanishing must not kill the server: its accepted
            # lines are journaled for the next client or the restart
            print(f"sweepd: client disconnected "
                  f"({e.__class__.__name__}) — server stays up",
                  file=sys.stderr, flush=True)

    with sk.socket(sk.AF_UNIX, sk.SOCK_STREAM) as server_sock:
        server_sock.bind(path)
        server_sock.listen(16)
        server_sock.settimeout(1.0)
        print(f"sweepd: listening on {path}", file=sys.stderr, flush=True)
        while not ck.stop_requested():
            try:
                conn, _ = server_sock.accept()
            except TimeoutError:
                continue
            th = threading.Thread(target=serve_conn, args=(conn,),
                                  daemon=True)
            th.start()
            conn_threads.append(th)
            conn_threads = [t for t in conn_threads if t.is_alive()]
        for th in conn_threads:
            th.join(timeout=30)
    os.unlink(path)
    print("sweepd: drained — socket removed, exiting", file=sys.stderr,
          flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
