"""The JAX package's checkpointed-execution benchmark as written, on the
port's segmented runners (``parallel/checkpoint.py``).

``bench_suite.py`` ``bench_gossipsub_checkpoint``: the scored flagship
options (``ScoreSimConfig()``) at 1,000,000 peers, 10 topics, C = 16
(offsets seed 7), M = 24 (``default_rng(0)``, published over [0, 3)),
sim seed 3, no first-tick record, 8 ticks.  Rows:

- ``single``: the uninterrupted ``gossip_run``;
- ``segmented_S2`` / ``segmented_S4``: ``ckpt_gossip_run`` with ``every``
  = 4 and 2 (a full snapshot between segments, ``keep`` 2): digest, wall
  seconds, overhead against ``single``, ``compiles``, snapshot bytes;
- ``kill_resume``: the deferred stop (``request_stop``) interrupts the run
  after its first segment (``CheckpointInterrupt``), and the same call
  resumes it from the snapshot;
- ``shard_restore`` is skipped with one device, as the reference skips it
  below two (the sharded runners wait for A9; the artifact says so).

Every row's digest (SHA-256 over the bytes of ``have``, ``mesh``,
``backoff`` and the int32 tick, first 16 hex digits) must equal
``single``'s, and ``single``'s must equal the JAX package's,
``REFERENCE_DIGEST`` (``tests/torch_reference_gate.py --checkpoint``).
The port keeps no compile cache: a row's ``compiles`` counts the distinct
step objects its segments ran plus the kernel sources
``ops/kernels/_build.py`` compiled during the row (1 when the kernels
were built beforehand).  The reference ran a cold pass before each timed
segmented pass to keep its compile out of the time; the port has no
compile to keep out, so each segmented row is one pass.

    python -m go_libp2p_pubsub_tpu_torch.checkpoint_bench [--n 1000000]
        [--out PATH] [--dir DIR]

runs it on the GPU and prints the artifact (``ckptstat`` reads it).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from .device import resolve_device
from .models import gossipsub as gs
from .ops.kernels import _build
from .parallel import checkpoint as ck

N_PEERS, N_TOPICS, N_MSGS, TICKS = 1_000_000, 10, 24, 8
#: the JAX package's single-run digest at N_PEERS
#: (tests/torch_reference_gate.py --checkpoint; CKPT_r15.json has the same)
REFERENCE_DIGEST = "5eed6722d7e8630b"


def build(device, n: int = N_PEERS):
    """``(cfg, sc, params, state)``: the benchmark's sim on ``device``."""
    t, m = N_TOPICS, N_MSGS
    rng = np.random.default_rng(0)
    cfg = gs.GossipSimConfig(
        offsets=gs.make_gossip_offsets(t, 16, n, seed=7), n_topics=t)
    sc = gs.ScoreSimConfig()
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    topic = rng.integers(0, t, m)
    origin = rng.integers(0, n // t, m) * t + topic
    pub = np.sort(rng.integers(0, 3, m)).astype(np.int32)
    params, state = gs.make_gossip_sim(cfg, subs, topic, origin, pub,
                                       seed=3, score_cfg=sc,
                                       track_first_tick=False,
                                       device=device)
    return cfg, sc, params, state


def digest(state) -> str:
    """The benchmark's digest: SHA-256 over have, mesh, backoff, tick."""
    h = hashlib.sha256()
    for leaf in (state.have, state.mesh, state.backoff):
        h.update(leaf.detach().cpu().contiguous().numpy().tobytes())
    h.update(np.int32(state.tick).tobytes())
    return h.hexdigest()[:16]


class _Steps:
    """The step, recording which step objects the segments called."""

    def __init__(self, step):
        self.step = step
        self.seen: set[int] = set()

    def __call__(self, params, state):
        self.seen.add(id(self.step))
        return self.step(params, state)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run(device=None, n: int = N_PEERS, ticks: int = TICKS,
        base_dir: str | None = None) -> dict:
    """The benchmark's rows and artifact.  Snapshots go under
    ``base_dir`` (a fresh temporary directory by default), removed at the
    end.  Raises if a row's digest differs from ``single``'s."""
    dev = resolve_device(device)
    own_dir = base_dir is None
    base_dir = base_dir or tempfile.mkdtemp(prefix="gossip_ckpt_bench_")
    cfg, sc, params, state = build(dev, n)
    step = gs.make_gossip_step(cfg, sc, device=dev)
    fp = ck.config_fingerprint(cfg, sc)

    def fresh_dir(name):
        d = os.path.join(base_dir, name)
        shutil.rmtree(d, ignore_errors=True)
        return d

    try:
        out = gs.gossip_run(params, gs.tree_copy(state), ticks, step,
                            device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        out = gs.gossip_run(params, gs.tree_copy(state), ticks, step,
                            device=dev)
        _sync(dev)
        wall_single = time.perf_counter() - t0
        ref = digest(out)
        del out
        rows = [{"id": "single", "n": n, "wall_s": round(wall_single, 3),
                 "digest": ref, "bit_identical": True,
                 "wall_s_unrounded": wall_single}]
        for segs in (2, 4):
            d = fresh_dir(f"S{segs}")
            ckc = ck.CheckpointConfig(directory=d,
                                      every=max(ticks // segs, 1),
                                      fingerprint=fp)
            tracked = _Steps(step)
            built0 = _build.compiled
            s0 = gs.tree_copy(state)
            _sync(dev)
            t0 = time.perf_counter()
            out = ck.ckpt_gossip_run(params, s0, ticks, tracked, ckc,
                                     device=dev)
            _sync(dev)
            dt = time.perf_counter() - t0
            compiles = len(tracked.seen) + (_build.compiled - built0)
            snap_bytes = sum(os.path.getsize(os.path.join(d, f))
                             for f in os.listdir(d))
            dg = digest(out)
            del out, s0
            rows.append({
                "id": f"segmented_S{segs}", "n": n, "segments": segs,
                "every": ckc.every, "wall_s": round(dt, 3),
                "overhead_x": round(dt / wall_single, 2),
                "compiles": int(compiles),
                "snapshot_bytes": int(snap_bytes),
                "digest": dg, "bit_identical": dg == ref,
                "wall_s_unrounded": dt,
            })
            shutil.rmtree(d, ignore_errors=True)
        # kill and resume: the deferred stop interrupts after the first
        # flushed segment; the same call then resumes to the end
        d = fresh_dir("kill")
        ckc = ck.CheckpointConfig(directory=d, every=max(ticks // 4, 1),
                                  fingerprint=fp)
        ck.request_stop()
        interrupted, ticks_done = False, None
        try:
            ck.ckpt_gossip_run(params, gs.tree_copy(state), ticks, step,
                               ckc, device=dev)
        except ck.CheckpointInterrupt as e:
            interrupted, ticks_done = True, e.ticks_done
        finally:
            ck.clear_stop()
        out = ck.ckpt_gossip_run(params, gs.tree_copy(state), ticks, step,
                                 ckc, device=dev)
        dg = digest(out)
        del out
        rows.append({
            "id": "kill_resume", "n": n, "every": ckc.every,
            "interrupted": interrupted,
            "resumed_from_tick": ticks_done if interrupted else None,
            "wall_s": 0.0, "digest": dg,
            "bit_identical": interrupted and dg == ref,
        })
    finally:
        if own_dir:
            shutil.rmtree(base_dir, ignore_errors=True)
    bad = [r for r in rows if not r["bit_identical"]]
    if bad:
        raise RuntimeError(f"checkpoint rows differ from single: {rows}")
    return {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "n_devices": 1,
        "hardware_queued": False,
        "shard_restore": "skipped: one device (the sharded runners and "
                         "the D->D' restore wait for A9)",
        "shape": {"n": n, "t": N_TOPICS, "m": N_MSGS, "ticks": ticks},
        "rows": rows,
    }


def snapshot_seconds(device=None, n: int = N_PEERS) -> dict:
    """Where one snapshot's host time goes: the built state's carry
    copied to the host (one packed copy), encoded as npz, its CRC32, the
    write and the fsync, each in seconds, with the payload's bytes."""
    import zlib

    from .utils.checkpoint import encode_npz, host_leaves

    dev = resolve_device(device)
    state = build(dev, n)[3]
    _sync(dev)
    t = [time.perf_counter()]
    by_key = host_leaves(state, "state")
    t.append(time.perf_counter())
    payload = encode_npz(by_key)
    t.append(time.perf_counter())
    zlib.crc32(payload)
    t.append(time.perf_counter())
    with tempfile.TemporaryDirectory() as td:
        with open(os.path.join(td, "snapshot"), "wb") as f:
            f.write(payload)
            f.flush()
            t.append(time.perf_counter())
            os.fsync(f.fileno())
        t.append(time.perf_counter())
    names = ("host_copy", "npz", "crc32", "write", "fsync")
    return dict(zip(names, (b - a for a, b in zip(t, t[1:]))),
                bytes=len(payload))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m go_libp2p_pubsub_tpu_torch.checkpoint_bench")
    ap.add_argument("--n", type=int, default=N_PEERS)
    ap.add_argument("--ticks", type=int, default=TICKS)
    ap.add_argument("--device", default=None)
    ap.add_argument("--dir", default=None,
                    help="snapshot directory (default: a temporary one)")
    ap.add_argument("--out", default=None,
                    help="also write the artifact to this path")
    ns = ap.parse_args(argv)
    art = run(ns.device, ns.n, ns.ticks, ns.dir)
    if ns.n == N_PEERS and REFERENCE_DIGEST is not None:
        art["reference_digest"] = REFERENCE_DIGEST
        art["equals_reference"] = art["rows"][0]["digest"] \
            == REFERENCE_DIGEST
    if ns.out:
        from .artifacts import write_json_atomic
        write_json_atomic(ns.out, art)
    print(json.dumps(art))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
