"""The JAX package's two sweep-server benchmarks, as written, on the port's
``SweepServer``.

- ``run_sweepd()``: ``bench_suite.py`` ``bench_gossipsub_sweepd`` — one
  resident batched server (10,000 peers, 10 topics, M = 16, 60 ticks,
  batch 6, seed 0) serves 24 seed replicas of the reference scenario
  first, then 24 distinct scenarios (knob points across the degree
  family, gossip_factor, backoff, defense weights, link loss, churn and
  three attack formations).  Its gates: every row ``ok``, no invariant
  bit, ``compiles() == 1``, the sweep's wall at most twice the seed
  batch's.  Returns the benchmark's artifact (the same fields).
- ``run_kernel(shape)``: ``bench_gossipsub_sweepd_kernel`` — the kernel
  server (batch 1) serves six scenarios at 512 peers, 4 topics, M = 8, 12
  ticks (``"bench"``), and the same six at the CLI's default shape, 10,000
  peers, 10 topics, M = 16, 100 ticks (``"cli"``).  Its gates: every row
  ``ok``, ``compiles() == 1``.

``REFERENCE_ROWS`` and ``REFERENCE_KERNEL_ROWS`` are the JAX package's rows
for the same requests (``tests/torch_reference_gate.py --sweepd``: its
``tools/sweepd.SweepServer`` on the CPU, the kernel server on its
interpret-mode kernel, padded to 128); the port's rows must equal them.

    python -m go_libp2p_pubsub_tpu_torch.sweepd_bench [--device cpu]

runs all three on the GPU and prints one JSON object: the rows, their
agreement with the reference's, replica heartbeats/s and the card.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .device import resolve_device
from .sweepd import SweepServer

#: the benchmark's shape: (peers, topics, messages, ticks, batch)
SHAPE = (10_000, 10, 16, 60, 6)
#: the kernel server's shapes: (peers, topics, messages, ticks)
KERNEL_SHAPES = {"bench": (512, 4, 8, 12), "cli": (10_000, 10, 16, 100)}

SEED_REQUESTS = [{"id": f"seed{i}", "seed": i} for i in range(24)]

SWEEP_REQUESTS = [
    {"id": "ref", "seed": 0},
    {"id": "d4", "knobs": {"d": 4, "d_lo": 3, "d_hi": 8}},
    {"id": "d8", "knobs": {"d": 8, "d_lo": 6, "d_hi": 12}},
    {"id": "d10", "knobs": {"d": 10, "d_lo": 8, "d_hi": 14,
                            "d_score": 6, "d_out": 3}},
    {"id": "lazy3", "knobs": {"d_lazy": 3}},
    {"id": "lazy12", "knobs": {"d_lazy": 12}},
    {"id": "gf05", "knobs": {"gossip_factor": 0.05}},
    {"id": "gf50", "knobs": {"gossip_factor": 0.5}},
    {"id": "gf90", "knobs": {"gossip_factor": 0.9}},
    {"id": "bo5", "knobs": {"backoff_ticks": 5}},
    {"id": "bo120", "knobs": {"backoff_ticks": 120}},
    {"id": "ttl10", "knobs": {"fanout_ttl_ticks": 10}},
    {"id": "retrans1", "knobs": {"gossip_retransmission": 1}},
    {"id": "loss02", "drop_prob": 0.02},
    {"id": "loss10", "drop_prob": 0.10},
    {"id": "loss20churn", "drop_prob": 0.20, "churn": True},
    {"id": "churn", "churn": True},
    {"id": "spam", "attack": "spam", "attack_frac": 0.15},
    {"id": "spam_hard", "attack": "spam", "attack_frac": 0.15,
     "knobs": {"behaviour_penalty_weight": -40.0,
               "gossip_threshold": -2.0}},
    {"id": "eclipse", "attack": "eclipse", "attack_frac": 0.15},
    {"id": "eclipse_hard", "attack": "eclipse", "attack_frac": 0.15,
     "knobs": {"behaviour_penalty_weight": -40.0}},
    {"id": "byz", "attack": "byzantine", "attack_frac": 0.1},
    {"id": "byz_weak", "attack": "byzantine", "attack_frac": 0.1,
     "knobs": {"invalid_message_deliveries_weight": 0.0}},
    {"id": "kitchen_sink", "drop_prob": 0.05, "churn": True,
     "attack": "spam", "attack_frac": 0.1,
     "knobs": {"d": 8, "d_lo": 6, "d_hi": 12, "gossip_factor": 0.4,
               "behaviour_penalty_weight": -20.0}},
]

KERNEL_REQUESTS = [
    {"id": "ref"},
    {"id": "d5", "knobs": {"d": 5, "d_hi": 9}},
    {"id": "gf40", "knobs": {"gossip_factor": 0.4, "backoff_ticks": 6}},
    {"id": "hard", "knobs": {"behaviour_penalty_weight": -40.0,
                             "graylist_threshold": -60.0}},
    {"id": "loss", "drop_prob": 0.05, "churn": True},
    {"id": "spam", "attack": "spam", "attack_frac": 0.1},
]

#: the JAX package's rows (tests/torch_reference_gate.py --sweepd):
#: {"seed": [...], "sweep": [...]} for the batched benchmark, and the
#: kernel server's rows by shape
REFERENCE_ROWS = {'seed': [{'id': 'seed0',
           'ok': True,
           'batch': 0,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed1',
           'ok': True,
           'batch': 0,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed2',
           'ok': True,
           'batch': 0,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed3',
           'ok': True,
           'batch': 0,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed4',
           'ok': True,
           'batch': 0,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed5',
           'ok': True,
           'batch': 0,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed6',
           'ok': True,
           'batch': 1,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed7',
           'ok': True,
           'batch': 1,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed8',
           'ok': True,
           'batch': 1,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed9',
           'ok': True,
           'batch': 1,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed10',
           'ok': True,
           'batch': 1,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed11',
           'ok': True,
           'batch': 1,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed12',
           'ok': True,
           'batch': 2,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed13',
           'ok': True,
           'batch': 2,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed14',
           'ok': True,
           'batch': 2,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed15',
           'ok': True,
           'batch': 2,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed16',
           'ok': True,
           'batch': 2,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed17',
           'ok': True,
           'batch': 2,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed18',
           'ok': True,
           'batch': 3,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed19',
           'ok': True,
           'batch': 3,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed20',
           'ok': True,
           'batch': 3,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed21',
           'ok': True,
           'batch': 3,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed22',
           'ok': True,
           'batch': 3,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1},
          {'id': 'seed23',
           'ok': True,
           'batch': 3,
           'honest_delivery_fraction': 1.0,
           'delivery_fraction': 1.0,
           'inv_bits': 0,
           'inv_first': -1}],
 'sweep': [{'id': 'ref',
            'ok': True,
            'batch': 4,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 1.0,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'd4',
            'ok': True,
            'batch': 4,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 1.0,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'd8',
            'ok': True,
            'batch': 4,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 1.0,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'd10',
            'ok': True,
            'batch': 4,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 1.0,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'lazy3',
            'ok': True,
            'batch': 4,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 1.0,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'lazy12',
            'ok': True,
            'batch': 4,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 1.0,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'gf05',
            'ok': True,
            'batch': 5,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 1.0,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'gf50',
            'ok': True,
            'batch': 5,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 1.0,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'gf90',
            'ok': True,
            'batch': 5,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 1.0,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'bo5',
            'ok': True,
            'batch': 5,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 1.0,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'bo120',
            'ok': True,
            'batch': 5,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 1.0,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'ttl10',
            'ok': True,
            'batch': 5,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 1.0,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'retrans1',
            'ok': True,
            'batch': 6,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 1.0,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'loss02',
            'ok': True,
            'batch': 6,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 1.0,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'loss10',
            'ok': True,
            'batch': 6,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 1.0,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'loss20churn',
            'ok': True,
            'batch': 6,
            'honest_delivery_fraction': 0.9881,
            'delivery_fraction': 0.9881,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'churn',
            'ok': True,
            'batch': 6,
            'honest_delivery_fraction': 0.9882,
            'delivery_fraction': 0.9882,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'spam',
            'ok': True,
            'batch': 6,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 0.85,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'spam_hard',
            'ok': True,
            'batch': 7,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 0.85,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'eclipse',
            'ok': True,
            'batch': 7,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 0.85,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'eclipse_hard',
            'ok': True,
            'batch': 7,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 0.85,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'byz',
            'ok': True,
            'batch': 7,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 0.9,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'byz_weak',
            'ok': True,
            'batch': 7,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 0.9,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'kitchen_sink',
            'ok': True,
            'batch': 7,
            'honest_delivery_fraction': 0.9872,
            'delivery_fraction': 0.8884,
            'inv_bits': 0,
            'inv_first': -1}]}
REFERENCE_KERNEL_ROWS = {'bench': [{'id': 'ref',
            'ok': True,
            'batch': 0,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 1.0,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'd5',
            'ok': True,
            'batch': 1,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 1.0,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'gf40',
            'ok': True,
            'batch': 2,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 1.0,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'hard',
            'ok': True,
            'batch': 3,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 1.0,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'loss',
            'ok': True,
            'batch': 4,
            'honest_delivery_fraction': 0.9717,
            'delivery_fraction': 0.9717,
            'inv_bits': 0,
            'inv_first': -1},
           {'id': 'spam',
            'ok': True,
            'batch': 5,
            'honest_delivery_fraction': 1.0,
            'delivery_fraction': 0.9004,
            'inv_bits': 0,
            'inv_first': -1}],
 'cli': [{'id': 'ref',
          'ok': True,
          'batch': 0,
          'honest_delivery_fraction': 1.0,
          'delivery_fraction': 1.0,
          'inv_bits': 0,
          'inv_first': -1},
         {'id': 'd5',
          'ok': True,
          'batch': 1,
          'honest_delivery_fraction': 1.0,
          'delivery_fraction': 1.0,
          'inv_bits': 0,
          'inv_first': -1},
         {'id': 'gf40',
          'ok': True,
          'batch': 2,
          'honest_delivery_fraction': 1.0,
          'delivery_fraction': 1.0,
          'inv_bits': 0,
          'inv_first': -1},
         {'id': 'hard',
          'ok': True,
          'batch': 3,
          'honest_delivery_fraction': 1.0,
          'delivery_fraction': 1.0,
          'inv_bits': 0,
          'inv_first': -1},
         {'id': 'loss',
          'ok': True,
          'batch': 4,
          'honest_delivery_fraction': 0.9934,
          'delivery_fraction': 0.9934,
          'inv_bits': 0,
          'inv_first': -1},
         {'id': 'spam',
          'ok': True,
          'batch': 5,
          'honest_delivery_fraction': 1.0,
          'delivery_fraction': 0.9,
          'inv_bits': 0,
          'inv_first': -1}]}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run_sweepd(device=None, shape=SHAPE) -> dict:
    """The batched benchmark as written: its artifact, with ``seed_rows``
    beside the sweep's ``rows``.  Raises if a gate fails."""
    dev = resolve_device(device)
    n, t, m, ticks, b = shape
    srv = SweepServer(n=n, t=t, m=m, ticks=ticks, batch=b, seed=0,
                      device=dev)
    # the seed batch: 24 replicas of the reference config that differ
    # only in seed, through the same engine (it runs first)
    w0 = srv.wall_s
    seed_rows = srv.submit([dict(r) for r in SEED_REQUESTS])
    seed_wall = srv.wall_s - w0
    if not all(r["ok"] for r in seed_rows):
        raise RuntimeError(f"sweepd seed batch: {seed_rows}")
    w0 = srv.wall_s
    rows = srv.submit([dict(r) for r in SWEEP_REQUESTS])
    sweep_wall = srv.wall_s - w0
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"sweepd rows not ok: {bad}")
    viol = sum(r.get("inv_bits", 0) != 0 for r in rows)
    if viol:
        raise RuntimeError(f"sweepd: {viol} rows carry invariant bits: "
                           f"{rows}")
    compiles = srv.compiles()
    if compiles != 1:
        raise RuntimeError(f"sweepd: the engine used {compiles} steps")
    ratio = sweep_wall / seed_wall if seed_wall else None
    if ratio is not None and ratio > 2.0:
        raise RuntimeError(
            f"heterogeneous sweep {ratio:.2f}x the seed-batch wall")
    stats = srv.stats()
    return {
        "shape": stats["shape"],
        "configs_served": len(SWEEP_REQUESTS),
        "batches": stats["batches"],
        "compiles": compiles,
        "configs_per_compile": len(SWEEP_REQUESTS) / compiles,
        "sweep_wall_s": round(sweep_wall, 2),
        "seed_batch_wall_s": round(seed_wall, 2),
        "sweep_vs_seed_ratio": (round(ratio, 3)
                                if ratio is not None else None),
        "replica_hbps": round(len(SWEEP_REQUESTS) * ticks / sweep_wall, 2),
        "scenario_ids": [r["id"] for r in SWEEP_REQUESTS],
        "rows": rows,
        "seed_rows": seed_rows,
        "sweep_wall_s_unrounded": sweep_wall,
        "seed_batch_wall_s_unrounded": seed_wall,
    }


def run_kernel(device=None, shape: str = "bench") -> dict:
    """The kernel server's six scenarios at ``KERNEL_SHAPES[shape]``: its
    rows, ``compiles``, the wall seconds and replica heartbeats/s.
    Raises if a gate fails."""
    dev = resolve_device(device)
    n, t, m, ticks = KERNEL_SHAPES[shape]
    srv = SweepServer(n=n, t=t, m=m, ticks=ticks, batch=1, kernel=True,
                      seed=0, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    rows = srv.submit([dict(r) for r in KERNEL_REQUESTS])
    _sync(dev)
    dt = time.perf_counter() - t0
    if not all(r["ok"] for r in rows):
        raise RuntimeError(f"sweepd kernel rows not ok: {rows}")
    if srv.compiles() != 1:
        raise RuntimeError(f"sweepd kernel: {srv.compiles()} steps")
    return {"shape": srv.stats()["shape"], "rows": rows,
            "compiles": srv.compiles(),
            "configs_per_compile": len(KERNEL_REQUESTS) / srv.compiles(),
            "attack_kinds": list(srv.attack_kinds), "wall_s": dt,
            "replica_hbps": len(KERNEL_REQUESTS) * ticks / dt}


def rows_equal(got: list, want: list) -> bool:
    """Whether two row lists agree field for field."""
    return len(got) == len(want) and all(a == b for a, b in zip(got, want))


#: the restart check's shape (peers, topics, messages, ticks, batch) and
#: its nine scenarios (heterogeneous, so a mixed-up row would show)
RESTART_SHAPE = (2_000, 10, 16, 20, 3)
RESTART_REQUESTS = [
    {"id": "r0", "seed": 1}, {"id": "r1", "knobs": {"d": 8, "d_hi": 12}},
    {"id": "r2", "drop_prob": 0.1}, {"id": "r3", "churn": True},
    {"id": "r4", "attack": "spam", "attack_frac": 0.1},
    {"id": "r5", "attack": "eclipse", "attack_frac": 0.1},
    {"id": "r6", "attack": "byzantine", "attack_frac": 0.1},
    {"id": "r7", "knobs": {"gossip_factor": 0.5}, "seed": 2},
    {"id": "r8", "drop_prob": 0.05, "churn": True, "seed": 3},
]


class _Server:
    """``python -m go_libp2p_pubsub_tpu_torch.sweepd`` as a child process
    on a journal: lines in, JSON rows out (read by a thread)."""

    def __init__(self, device: str, journal: str, shape=RESTART_SHAPE):
        import pathlib
        import queue
        import subprocess
        import sys
        import threading

        n, t, m, ticks, b = shape
        root = pathlib.Path(__file__).resolve().parents[1]
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "go_libp2p_pubsub_tpu_torch.sweepd",
             "--peers", str(n), "--topics", str(t), "--msgs", str(m),
             "--ticks", str(ticks), "--batch", str(b), "--journal",
             journal, "--device", device],
            cwd=root, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, bufsize=1)
        self.rows: queue.Queue = queue.Queue()
        self.stderr: list[str] = []
        self.pumps = [threading.Thread(target=self._pump, args=(
            self.proc.stdout, self.rows.put), daemon=True),
            threading.Thread(target=self._pump, args=(
                self.proc.stderr, self.stderr.append), daemon=True)]
        for th in self.pumps:
            th.start()

    @staticmethod
    def _pump(stream, put):
        for line in stream:
            put(line)

    def send(self, reqs) -> None:
        for r in reqs:
            self.proc.stdin.write(json.dumps(r) + "\n")
        self.proc.stdin.flush()

    def take(self, k: int, timeout: float = 300.0) -> list[dict]:
        """The next ``k`` rows."""
        return [json.loads(self.rows.get(timeout=timeout))
                for _ in range(k)]

    def finish(self, timeout: float = 300.0) -> tuple[int, list[dict]]:
        """Wait for the exit: ``(returncode, remaining rows)``."""
        rc = self.proc.wait(timeout=timeout)
        for th in self.pumps:
            th.join(timeout=60)
        rest = []
        while not self.rows.empty():
            rest.append(json.loads(self.rows.get()))
        return rc, rest

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


def _journaled(path: str) -> int:
    from .parallel.checkpoint import read_journal
    return len(read_journal(path)[0])


def restart_check(device=None, workdir: str | None = None) -> dict:
    """The server as a user runs it, killed and restarted on its journal:

    1. an uninterrupted run of the nine scenarios (EOF flushes);
    2. a run fed five: after the first batch's rows it gets SIGTERM, then
       one more line wakes its read; it drains (the pending batch is
       dispatched, its rows and the stats row emitted) and exits 0;
    3. a restart on the same journal fed two more, SIGKILLed once both
       are journaled (a partial batch: undispatched);
    4. a restart that replays those two from the journal, then serves the
       last two and EOF.

    Every scenario's row must equal the uninterrupted run's (but for its
    ``batch`` index).  Returns the runs' exit codes, the replay count and
    ``ok``."""
    import shutil
    import signal
    import tempfile

    dev = resolve_device(device)
    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="sweepd_restart_")
    journal = os.path.join(workdir, "sweepd.journal")
    reqs = RESTART_REQUESTS
    b = RESTART_SHAPE[-1]
    servers = []

    def start(j):
        srv = _Server(dev.type, j)
        servers.append(srv)
        return srv

    try:
        srv = start(os.path.join(workdir, "uninterrupted.journal"))
        srv.send(reqs)
        srv.proc.stdin.close()
        rc_u, want = srv.finish()
        want = {r["id"]: r for r in want if "id" in r}

        def wait_journaled(k):
            deadline = time.monotonic() + 300
            while _journaled(journal) < k and time.monotonic() < deadline:
                time.sleep(0.05)

        srv = start(journal)
        srv.send(reqs[:4])
        got = srv.take(b)                      # the first batch's rows
        wait_journaled(1)                      # the fourth is pending
        time.sleep(1.0)                        # ... and the read blocked
        srv.proc.send_signal(signal.SIGTERM)
        srv.send(reqs[4:5])                    # wakes the blocked read
        rc_term, rest = srv.finish()
        got += rest
        after_term = _journaled(journal)
        # a line the drained server never read was never accepted: its
        # client sends it again (to the last run)
        served = {r.get("id") for r in got}
        resend = [r for r in reqs[:5] if r["id"] not in served]

        srv = start(journal)
        srv.send(reqs[5:7])
        wait_journaled(2)
        srv.proc.kill()
        rc_kill, rest = srv.finish()
        got += rest

        srv = start(journal)
        srv.send(resend + reqs[7:])
        srv.proc.stdin.close()
        rc_replay, rest = srv.finish()
        got += rest
        replayed = [ln for ln in srv.stderr if "replaying" in ln]
    finally:
        for srv in servers:
            srv.stop()
        if own:
            shutil.rmtree(workdir, ignore_errors=True)

    def strip(r):
        return {k: v for k, v in r.items() if k != "batch"}
    got_rows = {r["id"]: r for r in got if "id" in r}
    stats = [r for r in got if r.get("stats")]
    same = (set(got_rows) == set(want) == {r["id"] for r in reqs}
            and all(strip(got_rows[k]) == strip(want[k]) for k in want))
    ok = (same and rc_u == 0 and rc_term == 0 and rc_kill != 0
          and rc_replay == 0 and after_term == 0 and len(stats) == 2
          and any("replaying 2 journaled" in ln for ln in replayed))
    return {"ok": ok, "rows_equal": same, "exit_codes": {
        "uninterrupted": rc_u, "sigterm_drain": rc_term,
        "sigkill": rc_kill, "replay": rc_replay},
        "journaled_after_drain": after_term,
        "replay_log": [ln.strip() for ln in replayed],
        "rows": [got_rows.get(r["id"]) for r in reqs]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m go_libp2p_pubsub_tpu_torch.sweepd_bench")
    ap.add_argument("--device", default=None)
    ns = ap.parse_args(argv)
    dev = resolve_device(ns.device)
    out = {"sweepd": run_sweepd(dev)}
    out["sweepd"]["rows_equal_reference"] = rows_equal(
        out["sweepd"]["rows"], REFERENCE_ROWS.get("sweep", []))
    for shape in KERNEL_SHAPES:
        r = run_kernel(dev, shape)
        r["rows_equal_reference"] = rows_equal(
            r["rows"], REFERENCE_KERNEL_ROWS.get(shape, []))
        out[f"kernel_{shape}"] = r
    if dev.type == "cuda":
        from .flagship import card
        out["card"] = card()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
