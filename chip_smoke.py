"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. the device: torch's name and count, nvidia-smi's name and power limit;
2. build the three CUDA sources from ``go_libp2p_pubsub_tpu_torch/csrc``
   (one nvcc per source, concurrently), printing ptxas' register and
   spill lines;
3. the select kernel against its plain version at 1,000,000 peers,
   C = 16, seeded: bit-identical; both timed with CUDA events;
4. the receive kernel against its plain version at the flagship shapes
   (N = 1,000,000, C = 16, W = 1), on seeded random operands and on the
   operands of a real tick of the 1M-peer sim: every output
   bit-identical; both timed;
5. the main path: the scored GossipSub v1.1 flagship (1,000,000 peers,
   100 topics, C = 16, M = 32, ScoreSimConfig(), seed 0) through
   make_gossip_sim / make_gossip_step / gossip_run, 100 warm-up and 300
   timed heartbeats, with the benchmark's mesh and delivery gates; the
   kernels' launch counts are reset just before and read just after;
5a. the receive kernel's attack variant against its plain version at
   N = 1,000,000, C = 16, W = 1 with all three attack options on, on
   seeded random operands (a fifth of the peers carrying the sybil word)
   and on the operands of a real tick of the 1M-peer adversarial sim
   after warm-up: every output bit-identical; both timed;
5b. the adversarial main path: the JAX package's adversarial benchmark
   configuration (the flagship with 20% sybils running IHAVE
   broken-promise spam and the IWANT flood, honest origins) through
   make_gossip_sim / make_gossip_step / gossip_run, 100 warm-up and 300
   timed heartbeats, with the benchmark's honest mesh-degree, honest
   delivery and IWANT-containment gates and the attacks live; the
   attack variant launched once per tick, counts reset just before and
   read just after;
5c. the receive kernel's full variant (the router-surface options)
   against its plain version at N = 1,000,000, C = 16, W = 1: flood
   publishing, exact-k targets, the PX trigger word and the shared-IP
   gater with the three attack options, on seeded random operands and on
   the operands of two real ticks of the 1M-peer everything-on sim
   (tick 3, where the trigger word is live, and a publishing tick after
   warm-up, there also as the main path runs it, with Bernoulli
   targets): every output bit-identical, the trigger word too; both
   timed; and exact-k alone on the flagship's options, the same two
   ways (on phase 4's operands);
5d. the everything-on main path: the flagship with topic_score_cap=50,
   20% sybils four to an address running both gossip-repair attacks,
   flood publishing, PX rotation over 14 of the 16 candidates and a
   sparse direct overlay (go_libp2p_pubsub_tpu_torch/everything.py)
   through make_gossip_sim / make_gossip_step / gossip_run, 100 warm-up
   and 300 timed heartbeats, with the adversarial path's three gates and
   every option shown live (the active set rotated, no direct edge ever
   in a mesh, some ctrl byte carrying CTRL_FLOOD during warm-up, the
   same-IP words present and some sybil's static score below 0); the
   full variant launched once per tick and no other receive variant,
   counts reset just before and read just after;
5e. exact-k on the fused path: the fused-window kernel with exact-k
   targets against its plain version at the resident shapes, one window;
   timed; then 64 heartbeats of the exact-k resident configuration
   through make_fused_window / gossip_run_fused (counts reset just
   before and read just after) against the same ticks stepped one by one
   (the unscored full variant), equal digests;
5f. the receive kernel's paired variant against its plain version at
   N = 1,000,000, C = 16, W = 1: the three attack options, PX and the
   shared-IP gater on (and, on random operands, flood publishing and
   exact-k too), on seeded random operands with odd and even edges and on
   the operands of a real tick of the 1M-peer paired everything-on sim
   after warm-up with some slot-B GRAFT and some GRAFT or PRUNE on an odd
   edge live (the first such from tick 60, where opportunistic grafting
   wakes the settled meshes; there also as the main path runs it): every
   output
   bit-identical, slot B's mesh, backoff, time in mesh and gate row too;
   both timed; then the unscored paired variant the same two ways at the
   resident shapes, its real tick the last of 64 heartbeats of an
   unscored paired resident sim through make_gossip_sim /
   make_gossip_step / gossip_run (counts reset just before and read just
   after: the unscored paired variant launched once per tick, no other
   receive variant), both slots' mean mesh degree >= Dlo;
5g. the fifth slice's main path: the JAX package's everything-on benchmark
   as written (bench_suite.py bench_gossipsub_v11_everything: paired
   topics, topic_score_cap=50, 20% sybils four to an address running both
   gossip-repair attacks, PX over 14 of the 16 candidates, the direct
   overlay; go_libp2p_pubsub_tpu_torch/everything.py ``paired=True``)
   through make_gossip_sim / make_gossip_step / gossip_run, 100 warm-up
   and 300 timed heartbeats, with the benchmark's three gates (the
   delivery gate over both residue classes of a topic), paired topics
   shown live (a slot-B mesh, slot-B time in mesh, an odd edge in some
   slot-B mesh; the honest slot-B mean degree >= Dlo, which the
   reference meets at 100,000 peers) and phase 5d's live checks (the
   active set rotated, no direct edge ever in a mesh, the same-IP words and a
   sybil static score below 0); the paired variant launched once per
   tick and no other receive variant, counts reset just before and read
   just after; then 20 more heartbeats under torch.profiler for the
   device's idle share;
5h. the receive kernel under faults against its plain version, each
   family at N = 1,000,000, C = 16, W = 1 (the flagship's scored
   options, the attack options with the IWANT flood's flood_ok word, the
   full variant, paired) and the unscored one at the resident shapes:
   on seeded random operands with a tenth of the peers down, and on the
   operands of a real tick of a 1M-peer sim under the churn benchmark's
   schedule (the benchmark's own sim for the flagship options, the
   adversarial, everything-on and paired everything-on sims with it
   attached for the others; tick 130, inside a churn wave and the
   partition, with some peer down and some edge cut; unscored, tick 30
   of the resident configuration under the same kind of schedule), each
   faulted variant launched once per tick of the run to it and no other
   receive variant: every output bit-identical; both timed;
5i. the slice's main path: the JAX package's churn benchmark as written
   (bench_suite.py bench_gossipsub_v11_churn: the flagship under 10%
   churn in three staggered waves, 2% link loss and a 30-tick half/half
   partition; go_libp2p_pubsub_tpu_torch/churn.py) through
   make_gossip_sim / make_gossip_step / gossip_run + gossip_run_curve,
   100 warm-up and 150 timed heartbeats: its three rows (heartbeats/s,
   the delivery fraction of the settled messages, the probes' median
   recovery ticks) and its two gates (fraction above 0.80, some probe
   recovered), the faults shown live (peers down, edges cut on tick
   130, the fraction below 1), the faulted receive variant launched once
   per tick and no other receive variant, counts reset just before and
   read just after; one tick's fault masks (the link draw) timed alone;
   then 20 more heartbeats under torch.profiler for the idle share;
5j. the fused-window kernel under faults and cold restart against its
   plain version at N = 1,048,576, T = 8, one window of the resident
   configuration under the churn benchmark's kind of schedule (cold
   restart on, rejoins inside the window), timed, the window's fault rows
   timed apart; then 64 heartbeats on fused windows (counts reset just
   before and read just after: the faulted fused kernel once per window,
   nothing else) against the same ticks one by one, equal digests, with
   rejoins inside the 64 ticks;
6. the unscored receive kernel against its plain version at the resident
   configuration's shapes (N = 1,048,576, C = 16, W = 1), on seeded random
   operands and on the operands of a real unscored tick: every output
   bit-identical; both timed;
7. the fused-window kernel against its plain version at N = 1,048,576,
   T = 8, on two real carries, the built state (mesh formation) and the
   state after 12 warm-up ticks: every output bit-identical; both timed
   on the second (CUDA events over back-to-back launches);
8. full-size identity: from one built state, 16 per-tick unscored steps
   and 2 fused windows give equal digests of the carry;
9. the resident main path: the unscored v1.0 configuration of the JAX
   package's resident-window benchmark (1,048,576 peers, 10 topics,
   C = 16, M = 24) through make_fused_window / gossip_run_fused, 64
   warm-up and 256 timed heartbeats (32 windows), with the mesh and
   delivery gates and the fused kernel launched once per window and no
   other kernel; then the per-tick unscored step over the same ticks
   (make_gossip_step(cfg, None) / gossip_run) for comparison, each with
   its counts reset just before and read just after;
10. one line with every main path's heartbeats/s, one JSON line with
    every kernel's numbers;
11. the last line: ``{"ok": true, "device": {...}}``.

It needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import re
import sys
import time

import torch

WARMUP, TIMED = 100, 300
RES_WARMUP, RES_TIMED = 64, 256     # the resident path, 8-tick windows
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _events_ms(run, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def eager_ms(fn, reps: int) -> float:
    """Mean time of one call issued from Python, by CUDA events over
    ``reps`` back-to-back calls after a warm-up (includes any gap the
    host leaves between launches)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
    return _events_ms(run, reps)


def device_ms(fn, reps: int) -> float:
    """Mean device time of one call: ``reps`` calls captured into one
    CUDA graph, replayed after a warm-up replay, timed by CUDA events —
    no host launch gaps."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(graph.replay, reps)
    del graph
    return ms


def max_abs_err(got, want) -> float:
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"output type/shape {g.dtype}{tuple(g.shape)} vs "
                 f"{w.dtype}{tuple(w.shape)}")
        d = (g.to(torch.float64) - w.to(torch.float64)).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def check_identical(name: str, got, want) -> float:
    """Every output bit-identical (compared as raw bits)."""
    for i, (g, w) in enumerate(zip(got, want)):
        gb = g.view(torch.int16) if g.dtype == torch.bfloat16 else g
        wb = w.view(torch.int16) if w.dtype == torch.bfloat16 else w
        if gb.dtype == torch.float32:
            gb, wb = gb.view(torch.int32), wb.view(torch.int32)
        if not torch.equal(gb, wb):
            fail(f"{name}: output {i} differs from the plain version")
    return max_abs_err(got, want)


def random_receive_operands(k, n: int, w: int, device, seed: int):
    """Seeded random receive operands (the kernel's full input space;
    the scored variant's own operands only for a scored ``k``)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    C = k.n_candidates

    def words(shape, bits=32):
        hi = torch.randint(0, 1 << 16, shape, generator=g, device=device)
        lo = torch.randint(0, 1 << 16, shape, generator=g, device=device)
        v = ((hi << 16) | lo) & ((1 << bits) - 1)
        return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)

    def ctr(hi):
        return (torch.rand((C, n), generator=g, device=device) * hi).to(
            k.counter_dtype)

    sub = torch.rand(n, generator=g, device=device) < 0.8
    ops = dict(
        gseeds=(0x9E3779B9, 0x85EBCA6B),
        ctrl=torch.randint(0, 64, (C, n), generator=g, device=device).to(
            torch.uint8),
        fresh=words((w, n)) & words((w, n)), adv=words((w, n)),
        sub_all=torch.where(sub, (1 << C) - 1, 0).to(torch.int32),
        cand_sub=words((n,), C), fanout=words((n,), C) & words((n,), C),
        wa=words((n,), C), grafts=words((n,), C) & words((n,), C),
        dropped=words((n,), C) & words((n,), C), meshsel=words((n,), C),
        seen=words((w, n)) & words((w, n)), injected=words((w, n)) & 0x0F0F,
        backoff=torch.randint(0, 61, (C, n), generator=g,
                              device=device).to(torch.int16))
    if not k.scored:
        return ops
    return dict(
        ops, valid=words((w,)), pay=words((n,), C), gsp=words((n,), C),
        acc=words((n,), C), bo2=words((n,), C), static=None,
        fd=ctr(60.0), inv=ctr(3.0), bp=ctr(3.0).to(k.bp_dtype),
        tim=torch.randint(0, 32767, (C, n), generator=g,
                          device=device).to(torch.int16),
        iws=torch.randint(0, 30001, (C, n), generator=g,
                          device=device).to(torch.int16))


def full_receive_operands(k, n: int, device, seed: int):
    """Seeded random operands of the full variant with every option on:
    the attack variant's (a fifth of the peers carrying the sybil word,
    ledgers around the flood budget) plus ctrl bytes with CTRL_FLOOD,
    sparse injected sender words and same-IP sibling words."""
    C = k.n_candidates
    ops = random_receive_operands(k, n, 1, device, seed)
    g = torch.Generator(device=device)
    g.manual_seed(seed + 2)
    ops["syb"] = torch.where(
        torch.rand(n, generator=g, device=device) < 0.2, (1 << C) - 1, 0).to(
            torch.int32)
    ops["iws"] = torch.randint(0, 4 * 32, (C, n), generator=g,
                               device=device).to(torch.int16)
    ops["ctrl"] = torch.randint(0, 128, (C, n), generator=g,
                                device=device).to(torch.uint8)
    ops["inj_send"] = (ops["fresh"] & ops["adv"]).contiguous()
    group = torch.randint(0, 6, (C, n), generator=g, device=device)
    same = torch.zeros((C, n), dtype=torch.int32, device=device)
    for c in range(C):
        same |= (group == group[c][None, :]).to(torch.int32) << c
    ops["same_ip"] = same
    return ops


def paired_receive_operands(k, ops, n: int, device, seed: int):
    """``ops`` with the paired variant's own operands added, seeded: a
    second ctrl byte with every slot-B flag, slot-B sender words and
    handshake words, the slot-B backoff and (scored) time in mesh."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    C = k.n_candidates
    w = ops["fresh"].shape[0]

    def words(shape, bits=32):
        hi = torch.randint(0, 1 << 16, shape, generator=g, device=device)
        lo = torch.randint(0, 1 << 16, shape, generator=g, device=device)
        v = ((hi << 16) | lo) & ((1 << bits) - 1)
        return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)

    out = dict(
        ops,
        ctrl2=torch.randint(0, 16, (C, n), generator=g, device=device).to(
            torch.uint8),
        fresh_b=words((w, n)) & words((w, n)), wa_b=words((n,), C),
        grafts_b=words((n,), C) & words((n,), C),
        dropped_b=words((n,), C) & words((n,), C), meshsel_b=words((n,), C),
        backoff_b=torch.randint(0, 61, (C, n), generator=g,
                                device=device).to(torch.int16))
    if k.scored:
        out.update(bo2_b=words((n,), C),
                   tim_b=torch.randint(0, 32767, (C, n), generator=g,
                                       device=device).to(torch.int16))
    return out


def fault_operands(k, ops, device, seed: int):
    """``ops`` with the faulted variant's own operands, seeded: the alive
    word 0 at a tenth of the peers and, under the IWANT flood, random
    flood_ok bits."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n = ops["sub_all"].shape[0]
    down = torch.rand(n, generator=g, device=device) < 0.1
    out = dict(ops, alive_w=torch.where(down, 0, -1).to(torch.int32))
    if k.iwant_spam:
        out["flood_ok"] = torch.randint(0, 1 << k.n_candidates, (n,),
                                        generator=g, device=device).to(
                                            torch.int32)
    return out


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel: its name with its template
    arguments (``receive_kernel<16,1,1,0,1,1>``), registers and spill
    bytes, from nvcc's ``-Xptxas -v`` report."""
    out, entry, spill = [], "?", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d+([A-Za-z_]+)I((?:L[ib]\d+E)+)EEv", line)
            entry = (f"{m.group(1)}<"
                     f"{','.join(re.findall(r'L[ib](\d+)E', m.group(2)))}>"
                     if m else line.strip())
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            out.append(f"{entry}: {line.split(':', 1)[-1].strip()}; "
                       f"{spill}")
    return out


def receive_ops(k, ops) -> int:
    """Operations the receive half needs on these operands: ~15 integer
    ops per edge, ~8 per message word over an edge whose gates are open
    (this tick's data); scored, ~60 integer/f32 ops per counter row and
    ~10 per lane-hash draw (two draws per row); unscored, ~6 per backoff
    row and one draw per row; the attack options, ~12 per edge (broken
    bit, P7 add, flood budget) and ~3 per advert word a sybil receiver
    counts; the router-surface options, ~3 per edge for the flood bit,
    ~4 per candidate pair for the same-IP sums and ~3 per candidate pair
    for the exact-k ranks; paired topics, ~8 per edge for the second ctrl
    byte and its cross-slot routing, ~20 per row for slot B's backoff and
    (scored) time in mesh and P1, and ~8 per message word over an edge
    whose slot-B forward is open (this tick's data); faults, ~2 per edge
    and message word (the heard words masked) and ~8 per peer (the
    handshake words and the flood's gate)."""
    n = ops["sub_all"].shape[0]
    W = ops["fresh"].shape[0]
    C = k.n_candidates
    open_words = 0
    for j, (o, ci) in enumerate(zip(k.offsets, k.cinv)):
        ctl = torch.roll(ops["ctrl"][ci], -o).to(torch.int32)
        ok_p = (ops["pay"] >> j) & 1 if k.scored else 1
        ok_g = ok_p & ((ops["gsp"] >> j) & 1) if k.scored else 1
        on = (ctl & ok_p & 1) | ((ctl >> 1) & ok_g & 1)
        open_words += W * int(on.sum())
        if k.paired:
            ctl2 = torch.roll(ops["ctrl2"][ci], -o).to(torch.int32)
            open_words += W * int((ctl2 & ok_p & 1).sum())
    per_row = 60 + 2 * 10 if k.scored else 6 + 10
    extra = 0
    if k.attacks:
        n_syb = int((ops["syb"] != 0).sum())
        extra = n * C * 12 + 3 * n_syb * C * W
    extra += n * C * (3 * k.flood_publish + 4 * C * k.with_same_ip
                      + 3 * C * k.exact_k + (8 + 20) * k.paired
                      + 2 * W * k.faults) + 8 * n * k.faults
    return n * C * (15 + per_row) + 8 * open_words + extra


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """The least time (ms) for the work, and what bounds it."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def capture_receive(run, krecv):
    """Run ``run()`` with receive_update wrapped; the last call's
    operands."""
    captured = []
    real = krecv.receive_update

    def capture(k_, **ops_):
        captured[:] = [ops_]            # keep the latest tick only
        return real(k_, **ops_)

    krecv.receive_update = capture
    try:
        run()
    finally:
        krecv.receive_update = real
    return captured[-1]


def digest(state) -> str:
    """sha256 of the resident carry and the tick (the JAX package's
    resident-benchmark contract, plus the carried gates)."""
    h = hashlib.sha256()
    for leaf in (state.have, state.recent, state.mesh, state.fanout,
                 state.last_pub, state.backoff, *state.gates):
        h.update(leaf.cpu().numpy().tobytes())
    h.update(str(state.tick).encode())
    return h.hexdigest()[:16]


def fused_window_ops(k, ops, select_rows: int) -> int:
    """Operations one window needs on these operands: per peer-tick ~90
    for the two fronts, handshake and ring, ~38 per candidate row
    (ctrl pack, edge read, backoff, targets draw), ~6 per message word
    per edge at most; per selection the data runs (k > 0), C lane-hash
    draws (~10 each) and C * C rank compares (~3 each); under faults
    ~16 more per peer-tick (the dead edges, the graft, fanout and send
    masks in both fronts, the handshake masks) and ~2 per message word
    per edge (the heard words masked); with cold restart ~4 per ring
    word per peer-tick (the clear in both fronts and the ring write)."""
    C = k.n_candidates
    W, n = ops["have"].shape
    T = len(ops["seeds"])
    faulted = ops.get("alive") is not None
    cold = ops.get("rejoin") is not None
    hg = ops["recent"].shape[0]
    return (n * T * (90 + 38 * C + 6 * C * W
                     + faulted * (16 + 2 * C * W) + cold * 4 * hg * W)
            + select_rows * (10 * C + 3 * C * C))


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs "
             "an NVIDIA GPU")
    import dataclasses

    import numpy as np

    from go_libp2p_pubsub_tpu_torch import (
        adversarial,
        churn,
        everything,
        flagship,
        resident,
    )
    from go_libp2p_pubsub_tpu_torch.models import faults
    from go_libp2p_pubsub_tpu_torch.models import gossipsub as pg
    from go_libp2p_pubsub_tpu_torch.ops import graph
    from go_libp2p_pubsub_tpu_torch.ops.kernels import _build
    from go_libp2p_pubsub_tpu_torch.ops.kernels import fused as kfused
    from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as krecv
    from go_libp2p_pubsub_tpu_torch.ops.kernels import select as ksel

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. the device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = flagship.card()
    print(smi)
    print(f"device: {name} x{count}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # -- 2. build the three kernels, concurrently
    t0 = time.perf_counter()
    logs = _build.build(("select", "receive", "fused"))
    for src, log in logs.items():
        for line in ptxas_summary(log):
            print(f"ptxas[{src}]: {line}")
    print(f"build: {time.perf_counter() - t0:.1f} s")

    n, C = flagship.N_PEERS, flagship.N_CAND

    # -- 3. select kernel vs plain at 1M peers, C = 16
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    hi = torch.randint(0, 1 << C, (n,), generator=g, device=dev)
    lo = torch.randint(0, 1 << C, (n,), generator=g, device=dev)
    elig = (hi & lo).to(torch.int32)
    kk = torch.randint(0, C + 3, (n,), generator=g, device=dev).to(
        torch.int32)
    seed = graph.lane_seed(7, 2, 0)
    want = ksel.select_k_bits_plain(elig, kk, C, seed, n)
    got = ksel.select_k_bits(elig, kk, C, seed, n)
    torch.cuda.synchronize()
    sel_err = check_identical("select", (got,), (want,))
    sel_ms = device_ms(lambda: ksel.select_k_bits(elig, kk, C, seed, n),
                       200)
    sel_plain_ms = device_ms(
        lambda: ksel.select_k_bits_plain(elig, kk, C, seed, n), 5)
    sel_eager_ms = eager_ms(
        lambda: ksel.select_k_bits(elig, kk, C, seed, n), 200)
    n_elig = int(graph.popcount32(elig).sum())
    sel_bytes = 3 * 4 * n                     # elig, k in; word out
    sel_ops = n_elig * (C + 10)               # rank compares + lane hash
    print(f"select: identical at N={n}, C={C}; device time: kernel "
          f"{sel_ms:.4f} ms, plain {sel_plain_ms:.3f} ms; issued from "
          f"Python: {sel_eager_ms:.4f} ms per call")

    # -- 4. receive kernel vs plain at the flagship shapes
    cfg, sc, params, state, _ = flagship.build(dev, horizon=WARMUP + TIMED)
    k = krecv.receive_consts(cfg, sc)
    ops = random_receive_operands(k, n, 1, dev, seed=11)
    err_rand = check_identical("receive (random operands)",
                               krecv.receive_update(k, **ops),
                               krecv.receive_update_plain(k, **ops))
    step = pg.make_gossip_step(cfg, sc, device=dev)
    tick_ops = capture_receive(
        lambda: pg.gossip_run(params, state, 40, step, device=dev), krecv)
    want = krecv.receive_update_plain(k, **tick_ops)
    got = krecv.receive_update(k, **tick_ops)
    torch.cuda.synchronize()
    err_tick = check_identical("receive (a real tick)", got, want)
    rcv_ms = device_ms(lambda: krecv.receive_update(k, **tick_ops), 50)
    rcv_plain_ms = device_ms(
        lambda: krecv.receive_update_plain(k, **tick_ops), 5)
    rcv_eager_ms = eager_ms(lambda: krecv.receive_update(k, **tick_ops), 50)
    rcv_bytes = krecv.operand_bytes(tick_ops, got)
    rcv_ops = receive_ops(k, tick_ops)
    # (5c) exact-k targets alone, on the same two operand sets
    k_xk = dataclasses.replace(k, exact_k=True)
    err_xk = 0.0
    for label, o in (("random operands", ops), ("a real tick", tick_ops)):
        got_xk = krecv.receive_update(k_xk, **o)
        torch.cuda.synchronize()
        err_xk = max(err_xk, check_identical(
            f"exact-k receive ({label})", got_xk,
            krecv.receive_update_plain(k_xk, **o)))
    if torch.equal(got_xk[8], got[8]):
        fail("exact-k receive: the targets equal the Bernoulli draw")
    xk_ms = device_ms(lambda: krecv.receive_update(k_xk, **tick_ops), 50)
    del got_xk, o
    print(f"receive: identical at N={n}, C={C}, W=1 (random and real "
          f"tick); device time: kernel {rcv_ms:.4f} ms, plain "
          f"{rcv_plain_ms:.3f} ms; issued from Python: {rcv_eager_ms:.4f} "
          f"ms per call; {rcv_bytes / n:.1f} B/peer")
    del want, got, ops, tick_ops, params, state, step

    # -- 5. the main path, counts reset just before and read just after
    cfg, sc, params, state, msg_tick = flagship.build(
        dev, horizon=WARMUP + TIMED)
    step = pg.make_gossip_step(cfg, sc, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    krecv.launches.clear()
    ksel.launches = 0
    state = pg.gossip_run(params, state, WARMUP, step, device=dev)
    torch.cuda.synchronize()
    sub = params.subscribed
    deg = pg.mesh_degrees(state)[sub].to(torch.float64).mean().item()
    if not deg >= cfg.d_lo:
        fail(f"mesh failed to form: mean degree {deg}")
    t0 = time.perf_counter()
    state = pg.gossip_run(params, state, TIMED, step, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"receive": krecv.launches["scored"],
                "select": ksel.launches}
    peak = torch.cuda.max_memory_allocated()
    reach = pg.reach_counts_from_have(params, state).cpu().numpy()
    settled = msg_tick < WARMUP + TIMED - 30
    want_reach = flagship.N_PEERS // flagship.N_TOPICS
    if not (reach[settled] == want_reach).all():
        fail(f"delivery gate: reach {reach[settled].tolist()} != "
             f"{want_reach}")
    if launches["receive"] != WARMUP + TIMED:
        fail(f"receive launches {launches['receive']} != ticks "
             f"{WARMUP + TIMED}")
    if launches["select"] <= 0:
        fail("the select kernel was not launched on the main path")
    if state.tick != WARMUP + TIMED:
        fail(f"state tick {state.tick}")
    hb = TIMED / dt
    print(f"main path: {n} peers x {flagship.N_TOPICS} topics, C={C}, "
          f"M={flagship.N_MSGS}: {hb:.2f} heartbeats/s "
          f"({dt * 1e3 / TIMED:.3f} ms/tick), mean mesh degree {deg:.3f}, "
          f"{int(settled.sum())} settled messages all at {want_reach} "
          f"peers, peak memory {peak} B, launches {launches} "
          f"[{name}, {smi}]")

    main_flagship = {
        "heartbeats_per_s": hb, "ms_per_tick": dt * 1e3 / TIMED,
        "peak_bytes": peak, "mean_mesh_degree": deg}
    del params, state, step

    # -- 5a. the attack variant vs plain at the adversarial shapes, all
    # three attack options on
    horizon = WARMUP + TIMED
    cfg, sc, params, state, *_ = adversarial.build(dev, horizon=horizon)
    k_a = krecv.receive_consts(cfg, sc)
    if not (k_a.track_promises and k_a.ihave_spam and k_a.iwant_spam):
        fail(f"adversarial receive consts: {k_a}")
    ops = random_receive_operands(k_a, n, 1, dev, seed=17)
    g = torch.Generator(device=dev)
    g.manual_seed(19)
    ops["syb"] = torch.where(
        torch.rand(n, generator=g, device=dev) < 0.2, (1 << C) - 1, 0).to(
            torch.int32)
    # ledgers around the flood budget (3 windows of up to 32 ids)
    ops["iws"] = torch.randint(0, 4 * 32, (C, n), generator=g,
                               device=dev).to(torch.int16)
    err_arand = check_identical("attack receive (random operands)",
                                krecv.receive_update(k_a, **ops),
                                krecv.receive_update_plain(k_a, **ops))
    step = pg.make_gossip_step(cfg, sc, device=dev)
    tick_ops = capture_receive(
        lambda: pg.gossip_run(params, state, 40, step, device=dev), krecv)
    want = krecv.receive_update_plain(k_a, **tick_ops)
    got = krecv.receive_update(k_a, **tick_ops)
    torch.cuda.synchronize()
    err_atick = check_identical("attack receive (a real tick)", got, want)
    arcv_ms = device_ms(lambda: krecv.receive_update(k_a, **tick_ops), 50)
    arcv_plain_ms = device_ms(
        lambda: krecv.receive_update_plain(k_a, **tick_ops), 5)
    arcv_bytes = krecv.operand_bytes(tick_ops, got)
    arcv_bound = bound(arcv_bytes, receive_ops(k_a, tick_ops))
    print(f"attack receive: identical at N={n}, C={C}, W=1 (random and "
          f"real tick, {int((tick_ops['syb'] != 0).sum())} sybil words); "
          f"device time: kernel {arcv_ms:.4f} ms, plain "
          f"{arcv_plain_ms:.3f} ms; {arcv_bytes / n:.1f} B/peer, bound "
          f"{arcv_bound[0]:.4f} ms ({arcv_bound[1]})")
    del want, got, ops, tick_ops, params, state, step

    # -- 5b. the adversarial main path, counts reset just before and read
    # just after
    cfg, sc, params, state, msg_topic, msg_tick, _ = adversarial.build(
        dev, horizon=horizon)
    step = pg.make_gossip_step(cfg, sc, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    krecv.launches.clear()
    ksel.launches = 0
    # warm-up tick by tick: the attacks' levels (they fade between
    # publishes, so the end state alone may not show them) and the
    # ledger's bound on every tick
    bp_max = syb_serves = serves_warm = 0
    for _ in range(WARMUP):
        state = pg.gossip_run(params, state, 1, step, device=dev)
        bp_t, syb_t = adversarial.attack_levels(params, state)
        bp_max, syb_serves = max(bp_max, bp_t), max(syb_serves, syb_t)
        serves_warm = max(serves_warm, int(state.iwant_serves.max()))
    torch.cuda.synchronize()
    deg_a = adversarial.honest_degree(params, state)
    if not deg_a >= cfg.d_lo:
        fail(f"adversarial: honest mesh failed to form: mean degree {deg_a}")
    t0 = time.perf_counter()
    state = pg.gossip_run(params, state, TIMED, step, device=dev)
    torch.cuda.synchronize()
    dt_a = time.perf_counter() - t0
    launches_adv = {"receive_attacks": krecv.launches["attacks"],
                    "receive": krecv.launches["scored"],
                    "select": ksel.launches}
    peak_a = torch.cuda.max_memory_allocated()
    gates = adversarial.gates(cfg, params, state, msg_topic, msg_tick,
                              horizon)
    bp_t, syb_t = adversarial.attack_levels(params, state)
    gates.update(behaviour_penalty_max=max(bp_max, bp_t),
                 sybil_serves_max=max(syb_serves, syb_t),
                 warmup_serves_max=serves_warm)
    if not gates["ok"] or serves_warm >= gates["serves_cap"]:
        fail(f"adversarial gates: {gates}")
    if not (gates["behaviour_penalty_max"] > 0
            and gates["sybil_serves_max"] > 0):
        fail(f"adversarial: the attacks were not live: {gates}")
    if (launches_adv["receive_attacks"] != horizon
            or launches_adv["receive"] or launches_adv["select"] <= 0):
        fail(f"adversarial launches {launches_adv}")
    if state.tick != horizon:
        fail(f"adversarial: state tick {state.tick}")
    hb_a = TIMED / dt_a
    print(f"adversarial path: {n} peers x {adversarial.N_TOPICS} topics, "
          f"20% sybils spamming IHAVEs and flooding IWANTs: {hb_a:.2f} "
          f"heartbeats/s ({dt_a * 1e3 / TIMED:.3f} ms/tick), honest mean "
          f"mesh degree {gates['honest_mean_degree']:.3f}, "
          f"{gates['settled_messages']} settled messages at every honest "
          f"member, iwant_serves max {gates['serves_max']} at the end, "
          f"{serves_warm} over the warm-up ticks (< {gates['serves_cap']}), "
          f"sybil rows max "
          f"{gates['sybil_serves_max']}, behaviour_penalty max "
          f"{gates['behaviour_penalty_max']}, peak memory {peak_a} B, "
          f"launches {launches_adv} [{name}, {smi}]")
    main_adversarial = dict(
        gates, heartbeats_per_s=hb_a, ms_per_tick=dt_a * 1e3 / TIMED,
        peak_bytes=peak_a, launches=launches_adv)
    del params, state, step

    # -- 5c. the full variant vs plain: all four router-surface options
    # and the three attack options, on random operands and on a real tick
    # of the everything-on sim (there also as the main path runs it)
    cfg, sc, params, state, _, msg_tick, _ = everything.build(
        dev, horizon=horizon)
    k_e = krecv.receive_consts(cfg, sc, px=True, same_ip=True)
    k_all = dataclasses.replace(k_e, exact_k=True)
    if not (k_all.flood_publish and k_all.with_px and k_all.with_same_ip
            and k_all.track_promises and k_all.ihave_spam
            and k_all.iwant_spam and k_e.full and not k_e.exact_k):
        fail(f"everything receive consts: {k_e}")
    ops = full_receive_operands(k_all, n, dev, seed=23)
    got = krecv.receive_update(k_all, **ops)
    torch.cuda.synchronize()
    err_full = check_identical("full receive (random operands)", got,
                               krecv.receive_update_plain(k_all, **ops))
    if len(got) != 16 or not got[-1].any():
        fail("full receive: no PX trigger word")
    step = pg.make_gossip_step(cfg, sc, device=dev)
    # two real ticks: tick 3, mesh formation (PRUNEs and PRUNE-responses
    # arrive: the trigger word is live), and the first tick after warm-up
    # on which some peer publishes (its ctrl bytes carry CTRL_FLOOD)
    box = [state]

    def run_to(tick):
        box[0] = pg.gossip_run(params, box[0], tick + 1 - box[0].tick, step,
                               device=dev)

    tick_ops = capture_receive(lambda: run_to(3), krecv)
    got = krecv.receive_update(k_all, **tick_ops)
    torch.cuda.synchronize()
    err_full = max(err_full, check_identical(
        "full receive (tick 3, all options)", got,
        krecv.receive_update_plain(k_all, **tick_ops)))
    triggers = int((got[-1] != 0).sum())
    if triggers <= 0:
        fail("full receive: no PX trigger word on tick 3")
    t_pub = int(msg_tick[msg_tick >= 30][0])
    tick_ops = capture_receive(lambda: run_to(t_pub), krecv)
    for label, k_ in (("all options", k_all), ("as the main path", k_e)):
        want = krecv.receive_update_plain(k_, **tick_ops)
        got = krecv.receive_update(k_, **tick_ops)
        torch.cuda.synchronize()
        err_full = max(err_full, check_identical(
            f"full receive (a real tick, {label})", got, want))
    full_ms = device_ms(lambda: krecv.receive_update(k_e, **tick_ops), 50)
    full_all_ms = device_ms(lambda: krecv.receive_update(k_all, **tick_ops),
                            50)
    full_plain_ms = device_ms(
        lambda: krecv.receive_update_plain(k_e, **tick_ops), 5)
    full_bytes = krecv.operand_bytes(tick_ops, got)
    full_bound = bound(full_bytes, receive_ops(k_e, tick_ops))
    flood_edges = int(((tick_ops["ctrl"] >> krecv.CTRL_FLOOD) & 1).sum())
    if flood_edges <= 0:
        fail(f"full receive: no flood edge on tick {t_pub}")
    print(f"full receive: identical at N={n}, C={C}, W=1 (random and real "
          f"ticks 3 and {t_pub}; flood, exact-k, PX, same-IP and the attack "
          f"options; {triggers} trigger words on tick 3, {flood_edges} "
          f"flood edges on tick {t_pub}); "
          f"device time: kernel {full_ms:.4f} ms as the main path runs it "
          f"(Bernoulli targets), {full_all_ms:.4f} ms with exact-k too, "
          f"plain {full_plain_ms:.3f} ms; {full_bytes / n:.1f} B/peer, bound "
          f"{full_bound[0]:.4f} ms ({full_bound[1]}); exact-k alone on the "
          f"flagship's options: identical, {xk_ms:.4f} ms")
    del want, got, ops, tick_ops, params, state, step, box

    # -- 5d. the everything-on main path, counts reset just before and
    # read just after
    cfg, sc, params, state, msg_topic, msg_tick, _ = everything.build(
        dev, horizon=horizon)
    active0 = state.active
    step = pg.make_gossip_step(cfg, sc, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0_e = torch.cuda.memory_allocated()
    krecv.launches.clear()
    ksel.launches = 0
    # warm-up tick by tick: the attacks' levels, the ledger's bound, the
    # direct edges out of every mesh and the flood bits on the ctrl bytes
    bp_max = syb_serves = serves_warm = direct_meshed = 0
    flood_bytes = torch.zeros((), dtype=torch.int64, device=dev)
    real_receive = krecv.receive_update

    def watch_flood(k_, **ops_):
        flood_bytes.add_(((ops_["ctrl"] >> krecv.CTRL_FLOOD) & 1).sum())
        return real_receive(k_, **ops_)

    krecv.receive_update = watch_flood
    try:
        for _ in range(WARMUP):
            state = pg.gossip_run(params, state, 1, step, device=dev)
            bp_t, syb_t = adversarial.attack_levels(params, state)
            bp_max, syb_serves = max(bp_max, bp_t), max(syb_serves, syb_t)
            serves_warm = max(serves_warm, int(state.iwant_serves.max()))
            direct_meshed += everything.direct_in_mesh(params, state)
    finally:
        krecv.receive_update = real_receive
    torch.cuda.synchronize()
    deg_e = adversarial.honest_degree(params, state)
    if not deg_e >= cfg.d_lo:
        fail(f"everything: honest mesh failed to form: mean degree {deg_e}")
    t0 = time.perf_counter()
    state = pg.gossip_run(params, state, TIMED, step, device=dev)
    torch.cuda.synchronize()
    dt_e = time.perf_counter() - t0
    launches_ev = {"receive_full": krecv.launches["full"],
                   "receive_attacks": krecv.launches["attacks"],
                   "receive": krecv.launches["scored"],
                   "receive_unscored": krecv.launches["unscored"],
                   "select": ksel.launches}
    peak_e = torch.cuda.max_memory_allocated()
    gates_e = adversarial.gates(cfg, params, state, msg_topic, msg_tick,
                                horizon)
    bp_t, syb_t = adversarial.attack_levels(params, state)
    live = everything.options_live(params, active0, state)
    live["direct_in_mesh"] += direct_meshed
    live["flood_ctrl_bytes_warmup"] = int(flood_bytes)
    gates_e.update(behaviour_penalty_max=max(bp_max, bp_t),
                   sybil_serves_max=max(syb_serves, syb_t),
                   warmup_serves_max=serves_warm, **live)
    if not gates_e["ok"] or serves_warm >= gates_e["serves_cap"]:
        fail(f"everything gates: {gates_e}")
    # (the attacks' levels are reported, not gated: behind shared
    # addresses P6 graylists the sybils, which mutes their adverts)
    if not (live["active_rotated"] > 0 and live["direct_in_mesh"] == 0
            and int(params.cand_direct.ne(0).sum()) > 0
            and live["flood_ctrl_bytes_warmup"] > 0
            and live["same_ip_words"] and live["sybil_static_min"] < 0):
        fail(f"everything: an option was not live: {live}")
    if (launches_ev["receive_full"] != horizon
            or launches_ev["receive_attacks"] or launches_ev["receive"]
            or launches_ev["receive_unscored"]
            or launches_ev["select"] <= 0):
        fail(f"everything launches {launches_ev}")
    if state.tick != horizon:
        fail(f"everything: state tick {state.tick}")
    hb_e = TIMED / dt_e
    print(f"everything path: {n} peers x {adversarial.N_TOPICS} topics, 20% "
          f"sybils four to an address spamming IHAVEs and flooding IWANTs, "
          f"flood publishing, PX over {everything.PX_CANDIDATES} of {C} "
          f"candidates, direct overlay: {hb_e:.2f} heartbeats/s "
          f"({dt_e * 1e3 / TIMED:.3f} ms/tick), honest mean mesh degree "
          f"{gates_e['honest_mean_degree']:.3f}, "
          f"{gates_e['settled_messages']} settled messages at every honest "
          f"member, iwant_serves max {gates_e['serves_max']} at the end, "
          f"{serves_warm} over the warm-up ticks (< {gates_e['serves_cap']}),"
          f" sybil rows max {gates_e['sybil_serves_max']}, "
          f"behaviour_penalty max {gates_e['behaviour_penalty_max']}, "
          f"options {live}, peak memory {peak_e} B ({alloc0_e} B at the "
          f"start), launches {launches_ev} "
          f"[{name}, {smi}]")
    main_everything = dict(
        gates_e, heartbeats_per_s=hb_e, ms_per_tick=dt_e * 1e3 / TIMED,
        peak_bytes=peak_e, start_bytes=alloc0_e, launches=launches_ev)
    del params, state, active0, step

    # -- 5e. exact-k on the fused path: the kernel vs plain on one window
    # of the exact-k resident configuration after 12 per-tick steps, then
    # 64 heartbeats on fused windows against the same ticks one by one
    Tw = resident.WINDOW
    cfg_x, params, state, *_ = resident.build(dev, horizon=64, exact_k=True)
    n_x = resident.N_PEERS
    k_fx = kfused.fused_consts(cfg_x)
    if not k_fx.receive.exact_k:
        fail(f"exact-k fused consts: {k_fx}")
    step_x = pg.make_gossip_step(cfg_x, None, device=dev)
    st = pg.gossip_run(params, state, 12, step_x, device=dev)
    tk = torch.arange(st.tick, st.tick + Tw, dtype=torch.int32, device=dev)
    all_c = (1 << cfg_x.n_candidates) - 1
    fops = dict(
        tick0=st.tick, seeds=kfused.window_seeds(st.tick, Tw, st.salt),
        due=graph.pack_bits(params.publish_tick[None, :] == tk[:, None]),
        sub_all=torch.where(params.subscribed, all_c, 0).to(torch.int32),
        cand_sub=params.cand_sub_bits, origin=params.origin_words,
        have=st.have, recent=st.recent, mesh=st.mesh, fanout=st.fanout,
        last_pub=st.last_pub, backoff=st.backoff, tgt=st.gates[0],
        bog=st.gates[1])
    sel_rows_x = [0]
    real_sel = kfused.select_plain

    def count_sel_x(elig, kk, c, seed):
        sel_rows_x[0] += int((kk > 0).sum())
        return real_sel(elig, kk, c, seed)

    kfused.select_plain = count_sel_x
    try:
        want = kfused.fused_gossip_update_plain(k_fx, **fops)
    finally:
        kfused.select_plain = real_sel
    got = kfused.fused_gossip_update(k_fx, **fops)
    torch.cuda.synchronize()
    err_fx = check_identical("exact-k fused window", got, want)
    fx_ms = eager_ms(lambda: kfused.fused_gossip_update(k_fx, **fops), 20)
    fx_plain_ms = eager_ms(
        lambda: kfused.fused_gossip_update_plain(k_fx, **fops), 2)
    # the targets' selections: one more per peer-tick with candidates
    fx_rows = sel_rows_x[0] + n_x * Tw
    fx_bound = bound(kfused.window_operand_bytes(fops),
                     fused_window_ops(k_fx, fops, fx_rows))
    del want, got, fops, st
    win_x = pg.make_fused_window(cfg_x, None, ticks_fused=Tw, device=dev)
    krecv.launches.clear()
    ksel.launches = kfused.launches = 0
    end_fused = pg.gossip_run_fused(params, state, 64, win_x, device=dev)
    torch.cuda.synchronize()
    counts_x = {"fused": kfused.launches,
                "receive_full": krecv.launches["full"],
                "receive_unscored": krecv.launches["unscored"],
                "select": ksel.launches}
    if counts_x != {"fused": 64 // Tw, "receive_full": 0,
                    "receive_unscored": 0, "select": 0}:
        fail(f"exact-k fused launches {counts_x}")
    d_fx = digest(end_fused)
    d_tx = digest(pg.gossip_run(params, state, 64, step_x, device=dev))
    if d_fx != d_tx or krecv.launches["full"] != 64:
        fail(f"exact-k digest: per-tick {d_tx} != fused {d_fx} "
             f"(full launches {krecv.launches['full']})")
    deg_x = pg.mesh_degrees(end_fused)[params.subscribed].to(
        torch.float64).mean().item()
    if not deg_x >= cfg_x.d_lo:
        fail(f"exact-k fused: mesh failed to form: mean degree {deg_x}")
    print(f"exact-k fused window: identical at N={n_x}, C={C}, W=1, T={Tw}; "
          f"kernel {fx_ms:.4f} ms, plain {fx_plain_ms:.3f} ms per window, "
          f"bound {fx_bound[0]:.4f} ms ({fx_bound[1]}); 64 heartbeats on "
          f"{counts_x['fused']} fused windows and one by one (the unscored "
          f"full variant, 64 launches): digest {d_fx} both, mean mesh "
          f"degree {deg_x:.3f}")
    del params, state, end_fused

    # -- 5f. the paired variant vs plain: the main path's options (the
    # three attack options, PX, the shared-IP gater) with slot B, on
    # random operands (flood publishing and exact-k on too) and on a real
    # tick of the paired everything-on sim after warm-up
    cfg, sc, params, state, _, msg_tick, _ = everything.build(
        dev, horizon=horizon, paired=True)
    k_p = krecv.receive_consts(cfg, sc, px=True, same_ip=True)
    k_pall = dataclasses.replace(k_p, flood_publish=True, exact_k=True)
    if not (k_p.paired and k_p.with_px and k_p.with_same_ip
            and k_p.track_promises and k_p.ihave_spam and k_p.iwant_spam
            and not k_p.flood_publish and not k_p.exact_k
            and 0 < k_p.odd_mask < (1 << C) - 1):
        fail(f"paired receive consts: {k_p}")
    ops = paired_receive_operands(
        k_pall, full_receive_operands(k_pall, n, dev, seed=29), n, dev,
        seed=31)
    got = krecv.receive_update(k_pall, **ops)
    torch.cuda.synchronize()
    err_paired = check_identical("paired receive (random operands)", got,
                                 krecv.receive_update_plain(k_pall, **ops))
    if len(got) != 20 or not got[2].any() or not got[-1].any():
        fail("paired receive: no slot-B mesh or no PX trigger word")
    step = pg.make_gossip_step(cfg, sc, device=dev)
    box = [state]

    def run_to(tick):
        box[0] = pg.gossip_run(params, box[0], tick + 1 - box[0].tick, step,
                               device=dev)

    # the first tick after warm-up whose operands carry a slot-B GRAFT
    # and a GRAFT or PRUNE on an odd edge: the settled meshes are quiet
    # until opportunistic grafting (tick 60) starts a wave of grafts
    t_real = sc.opportunistic_graft_ticks
    for _ in range(20):
        tick_ops = capture_receive(lambda: run_to(t_real), krecv)
        sent = (tick_ops["grafts"] | tick_ops["dropped"]
                | tick_ops["grafts_b"] | tick_ops["dropped_b"])
        graft_b_live = int((tick_ops["grafts_b"] != 0).sum())
        odd_live = int((sent & k_p.odd_mask != 0).sum())
        if graft_b_live and odd_live:
            break
        t_real += 1
    else:
        fail(f"paired receive: no slot-B GRAFT and odd-edge handshake on "
             f"ticks {sc.opportunistic_graft_ticks}-{t_real}")
    ops_all = dict(tick_ops, inj_send=tick_ops["injected"])
    for label, k_, o in (("all options", k_pall, ops_all),
                         ("as the main path", k_p, tick_ops)):
        want = krecv.receive_update_plain(k_, **o)
        got = krecv.receive_update(k_, **o)
        torch.cuda.synchronize()
        err_paired = max(err_paired, check_identical(
            f"paired receive (tick {t_real}, {label})", got, want))
    paired_ms = device_ms(lambda: krecv.receive_update(k_p, **tick_ops), 50)
    paired_plain_ms = device_ms(
        lambda: krecv.receive_update_plain(k_p, **tick_ops), 5)
    paired_bytes = krecv.operand_bytes(tick_ops, got)
    paired_bound = bound(paired_bytes, receive_ops(k_p, tick_ops))
    print(f"paired receive: identical at N={n}, C={C}, W=1 (random "
          f"operands with every option; real tick {t_real} with the main "
          f"path's options and with all: {graft_b_live} slot-B GRAFT words, "
          f"{odd_live} peers sending on an odd edge, odd mask "
          f"{k_p.odd_mask:#06x}); device time: kernel {paired_ms:.4f} ms as "
          f"the main path runs it, plain {paired_plain_ms:.3f} ms; "
          f"{paired_bytes / n:.1f} B/peer, bound {paired_bound[0]:.4f} ms "
          f"({paired_bound[1]})")
    del want, got, o, ops, ops_all, tick_ops, params, state, step, box

    # the unscored paired variant at the resident shapes: random operands,
    # then the last of 64 heartbeats of an unscored paired sim, its
    # launches counted
    n_r = resident.N_PEERS
    cfg_up, params, state, *_ = resident.build(dev, horizon=RES_WARMUP,
                                               paired=True)
    k_up = krecv.receive_consts(cfg_up, None)
    if not (k_up.paired and not k_up.scored
            and 0 < k_up.odd_mask < (1 << C) - 1):
        fail(f"unscored paired receive consts: {k_up}")
    ops = paired_receive_operands(
        k_up, random_receive_operands(k_up, n_r, 1, dev, seed=37), n_r, dev,
        seed=41)
    err_up = check_identical("unscored paired receive (random operands)",
                             krecv.receive_update(k_up, **ops),
                             krecv.receive_update_plain(k_up, **ops))
    step_up = pg.make_gossip_step(cfg_up, None, device=dev)
    box = [state]
    torch.cuda.synchronize()
    krecv.launches.clear()
    ksel.launches = 0
    tick_ops = capture_receive(lambda: box.append(pg.gossip_run(
        params, state, RES_WARMUP, step_up, device=dev)), krecv)
    torch.cuda.synchronize()
    launches_up = {"receive_paired_unscored":
                   krecv.launches["paired_unscored"],
                   "receive_unscored": krecv.launches["unscored"],
                   "receive_paired": krecv.launches["paired"],
                   "receive_full": krecv.launches["full"],
                   "select": ksel.launches}
    if (launches_up["receive_paired_unscored"] != RES_WARMUP
            or launches_up["receive_unscored"] or launches_up["receive_paired"]
            or launches_up["receive_full"] or launches_up["select"] <= 0):
        fail(f"unscored paired launches {launches_up}")
    end_up = box[-1]
    sub = params.subscribed
    deg_ua = pg.mesh_degrees(end_up)[sub].to(torch.float64).mean().item()
    deg_ub = graph.popcount32(end_up.mesh_b)[sub].to(
        torch.float64).mean().item()
    if not (deg_ua >= cfg_up.d_lo and deg_ub >= cfg_up.d_lo):
        fail(f"unscored paired: meshes failed to form: mean degrees "
             f"{deg_ua}, {deg_ub}")
    want = krecv.receive_update_plain(k_up, **tick_ops)
    got = krecv.receive_update(k_up, **tick_ops)
    torch.cuda.synchronize()
    err_up = max(err_up, check_identical(
        "unscored paired receive (a real tick)", got, want))
    up_ms = device_ms(lambda: krecv.receive_update(k_up, **tick_ops), 50)
    up_plain_ms = device_ms(
        lambda: krecv.receive_update_plain(k_up, **tick_ops), 5)
    up_bytes = krecv.operand_bytes(tick_ops, got)
    up_bound = bound(up_bytes, receive_ops(k_up, tick_ops))
    print(f"unscored paired receive: identical at N={n_r}, C={C}, W=1 "
          f"(random operands and tick {end_up.tick - 1} of {RES_WARMUP} "
          f"heartbeats, mean mesh degrees {deg_ua:.3f} and {deg_ub:.3f}, "
          f"launches {launches_up}); device time: kernel {up_ms:.4f} ms, "
          f"plain {up_plain_ms:.3f} ms; {up_bytes / n_r:.1f} B/peer, bound "
          f"{up_bound[0]:.4f} ms ({up_bound[1]})")
    del want, got, ops, tick_ops, params, state, step_up, box, end_up

    # -- 5g. the fifth slice's main path: the everything-on benchmark as
    # written
    # (paired topics), counts reset just before and read just after
    cfg, sc, params, state, msg_topic, msg_tick, _ = everything.build(
        dev, horizon=horizon, paired=True)
    active0 = state.active
    step = pg.make_gossip_step(cfg, sc, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0_p = torch.cuda.memory_allocated()
    krecv.launches.clear()
    ksel.launches = 0
    bp_max = syb_serves = serves_warm = direct_meshed = 0
    for _ in range(WARMUP):
        state = pg.gossip_run(params, state, 1, step, device=dev)
        bp_t, syb_t = adversarial.attack_levels(params, state)
        bp_max, syb_serves = max(bp_max, bp_t), max(syb_serves, syb_t)
        serves_warm = max(serves_warm, int(state.iwant_serves.max()))
        direct_meshed += everything.direct_in_mesh(params, state)
    torch.cuda.synchronize()
    deg_p = adversarial.honest_degree(params, state)
    if not deg_p >= cfg.d_lo:
        fail(f"everything paired: honest mesh failed to form: mean degree "
             f"{deg_p}")
    t0 = time.perf_counter()
    state = pg.gossip_run(params, state, TIMED, step, device=dev)
    torch.cuda.synchronize()
    dt_p = time.perf_counter() - t0
    launches_pp = {"receive_paired": krecv.launches["paired"],
                   "receive_paired_unscored":
                   krecv.launches["paired_unscored"],
                   "receive_full": krecv.launches["full"],
                   "receive_attacks": krecv.launches["attacks"],
                   "receive": krecv.launches["scored"],
                   "receive_unscored": krecv.launches["unscored"],
                   "select": ksel.launches}
    peak_p = torch.cuda.max_memory_allocated()
    gates_p = adversarial.gates(cfg, params, state, msg_topic, msg_tick,
                                horizon)
    bp_t, syb_t = adversarial.attack_levels(params, state)
    live = everything.options_live(params, active0, state, cfg)
    live["direct_in_mesh"] += direct_meshed
    gates_p.update(behaviour_penalty_max=max(bp_max, bp_t),
                   sybil_serves_max=max(syb_serves, syb_t),
                   warmup_serves_max=serves_warm, **live)
    if not gates_p["ok"] or serves_warm >= gates_p["serves_cap"]:
        fail(f"everything paired gates: {gates_p}")
    if not (live["mesh_b_peers"] > 0 and live["time_in_mesh_b_max"] > 0
            and live["odd_in_mesh_b"] > 0
            and live["honest_mean_degree_b"] >= cfg.d_lo):
        fail(f"everything paired: paired topics not live: {live}")
    if not (live["active_rotated"] > 0 and live["direct_in_mesh"] == 0
            and int(params.cand_direct.ne(0).sum()) > 0
            and live["same_ip_words"] and live["sybil_static_min"] < 0):
        fail(f"everything paired: an option was not live: {live}")
    if (launches_pp["receive_paired"] != horizon or launches_pp["select"] <= 0
            or any(v for key, v in launches_pp.items()
                   if key not in ("receive_paired", "select"))):
        fail(f"everything paired launches {launches_pp}")
    if state.tick != horizon:
        fail(f"everything paired: state tick {state.tick}")
    box = [state]

    def run_more():
        box[0] = pg.gossip_run(params, box[0], 20, step, device=dev)

    prof_p = flagship.profile_ticks(run_more, 20)
    hb_p = TIMED / dt_p
    print(f"everything paired path (the benchmark as written): {n} peers x "
          f"{adversarial.N_TOPICS} topics, two topics a peer, 20% sybils "
          f"four to an address spamming IHAVEs and flooding IWANTs, PX over "
          f"{everything.PX_CANDIDATES} of {C} candidates, direct overlay: "
          f"{hb_p:.2f} heartbeats/s ({dt_p * 1e3 / TIMED:.3f} ms/tick), "
          f"honest mean mesh degree {gates_p['honest_mean_degree']:.3f} "
          f"(slot B {live['honest_mean_degree_b']:.3f}), "
          f"{gates_p['settled_messages']} settled messages at every honest "
          f"member of both classes, iwant_serves max "
          f"{gates_p['serves_max']} at the end, {serves_warm} over the "
          f"warm-up ticks (< {gates_p['serves_cap']}), sybil rows max "
          f"{gates_p['sybil_serves_max']}, behaviour_penalty max "
          f"{gates_p['behaviour_penalty_max']}, options {live}, peak "
          f"memory {peak_p} B ({alloc0_p} B at the start), launches "
          f"{launches_pp}; 20 more heartbeats "
          f"profiled: {prof_p['wall_ms_per_tick']:.3f} ms/tick wall, "
          f"{prof_p['device_busy_ms_per_tick']:.3f} busy, idle share "
          f"{prof_p['device_idle_share']:.3f} [{name}, {smi}]")
    main_paired = dict(
        gates_p, heartbeats_per_s=hb_p, ms_per_tick=dt_p * 1e3 / TIMED,
        peak_bytes=peak_p, start_bytes=alloc0_p, launches=launches_pp,
        device_idle_share=prof_p["device_idle_share"],
        device_busy_ms_per_tick=prof_p["device_busy_ms_per_tick"],
        profile_kernels=prof_p["kernels"][:8])
    del params, state, active0, step, box

    # -- 5h. B1 under faults against its plain version, each family, on
    # seeded random operands (a tenth of the peers down) and on a real
    # tick of a 1M-peer sim under the churn benchmark's schedule: tick
    # 130, inside the third churn wave and the partition; the faulted
    # variant's launches counted over the run to it
    t_real = churn.heal_tick() - 20
    faulted = {}

    def faulted_tick(label, sim, k):
        """Run ``sim`` (cfg, sc, params, state), its compiled churn
        schedule attached, to tick ``t_real`` with the launch counts
        reset; the operands of that tick, the schedule's masks there and
        the launches of each receive variant over the run."""
        cfg_, sc_, params_, state_ = sim
        step_ = pg.make_gossip_step(cfg_, sc_, device=dev)
        krecv.launches.clear()
        ops_ = capture_receive(lambda: pg.gossip_run(
            params_, state_, t_real + 1, step_, device=dev), krecv)
        torch.cuda.synchronize()
        launched = dict(krecv.launches)
        if launched != {krecv.variant(k): t_real + 1}:
            fail(f"{label}: launches {launched}")
        fm = faults.tick_masks(params_.faults, cfg_.offsets, cfg_.cinv,
                               t_real)
        down = int((ops_["alive_w"] == 0).sum())
        cut = int(graph.popcount32(fm.alive_all & ~fm.send_ok).sum())
        if not (down > 0 and cut > 0):
            fail(f"{label}: tick {t_real} has {down} down peers and {cut} "
                 "cut edges")
        return ops_, down, cut, t_real + 1

    def faulted_check(label, k, rand_ops, tick_ops, down, cut, launched,
                      tick=t_real, k_rand=None):
        """The faulted variant ``k`` against its plain version on the
        random operands (with the options of ``k_rand`` where given) and
        the real tick's, timed on the real tick."""
        k_rand = k if k_rand is None else k_rand
        got = krecv.receive_update(k_rand, **rand_ops)
        torch.cuda.synchronize()
        err = check_identical(f"{label} (random operands)", got,
                              krecv.receive_update_plain(k_rand, **rand_ops))
        want = krecv.receive_update_plain(k, **tick_ops)
        got = krecv.receive_update(k, **tick_ops)
        torch.cuda.synchronize()
        err = max(err, check_identical(f"{label} (tick {tick})", got,
                                       want))
        ms = device_ms(lambda: krecv.receive_update(k, **tick_ops), 50)
        plain = device_ms(lambda: krecv.receive_update_plain(k, **tick_ops),
                          5)
        nbytes = krecv.operand_bytes(tick_ops, got)
        bnd = bound(nbytes, receive_ops(k, tick_ops))
        n_ = tick_ops["sub_all"].shape[0]
        print(f"{label}: identical at N={n_}, C={C}, W=1 (random operands "
              f"with a tenth of the peers down; tick {tick}: {down} down "
              f"peers, {cut} cut edges); device time: kernel {ms:.4f} ms, "
              f"plain {plain:.3f} ms; {nbytes / n_:.1f} B/peer, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}); {launched} launches to tick "
              f"{tick}")
        return dict(err=err, ms=ms, plain_ms=plain, bytes_per_peer=nbytes / n_,
                    bound=bnd, launches=launched)

    def with_schedule(sim, seed):
        cfg_, sc_, params_, state_ = sim[:4]
        sched = churn.schedule(n, np.random.default_rng(seed), churn.WARMUP,
                               churn.WARMUP + churn.TIMED)
        return cfg_, sc_, dataclasses.replace(
            params_, faults=faults.compile_faults(sched, cfg_.offsets,
                                                  device=dev)), state_

    # the scored flagship options: the churn benchmark's own sim, built
    # once for this check and the main path (5i: the step leaves its input
    # state as it was)
    churn_sim = churn.build(dev)
    k_f = krecv.receive_consts(churn_sim[0], churn_sim[1], faults=True)
    tick_ops, down, cut, nl = faulted_tick("churn", churn_sim[:4], k_f)
    faulted["receive_update_faults"] = faulted_check(
        "faulted receive", k_f,
        fault_operands(k_f, random_receive_operands(k_f, n, 1, dev, seed=43),
                       dev, 47), tick_ops, down, cut, nl)
    del tick_ops
    # the attack options (the IWANT flood's flood_ok word live)
    sim = with_schedule(adversarial.build(dev, horizon=horizon), 1)
    k_fa = krecv.receive_consts(sim[0], sim[1], faults=True)
    rand = random_receive_operands(k_fa, n, 1, dev, seed=53)
    g = torch.Generator(device=dev)
    g.manual_seed(59)
    rand["syb"] = torch.where(torch.rand(n, generator=g, device=dev) < 0.2,
                              (1 << C) - 1, 0).to(torch.int32)
    rand["iws"] = torch.randint(0, 4 * 32, (C, n), generator=g,
                                device=dev).to(torch.int16)
    tick_ops, down, cut, nl = faulted_tick("attack", sim, k_fa)
    faulted["receive_update_attacks_faults"] = faulted_check(
        "faulted attack receive", k_fa, fault_operands(k_fa, rand, dev, 61),
        tick_ops, down, cut, nl)
    del tick_ops, sim, rand
    # the full variant (flood publishing, PX, the shared-IP gater, the
    # attack options; exact-k on the random operands)
    sim = with_schedule(everything.build(dev, horizon=horizon), 2)
    k_fe = krecv.receive_consts(sim[0], sim[1], px=True, same_ip=True,
                                faults=True)
    k_fall = dataclasses.replace(k_fe, exact_k=True)
    tick_ops, down, cut, nl = faulted_tick("full", sim, k_fe)
    rand = fault_operands(k_fall, full_receive_operands(k_fall, n, dev,
                                                        seed=67), dev, 71)
    r_all = faulted_check("faulted full receive (exact-k too)", k_fall, rand,
                          tick_ops, down, cut, nl)
    r = faulted_check("faulted full receive", k_fe, rand, tick_ops, down,
                      cut, nl, k_rand=k_fall)
    r["err"] = max(r["err"], r_all["err"])
    faulted["receive_update_full_faults"] = r
    del tick_ops, sim, rand
    # the paired variant
    sim = with_schedule(everything.build(dev, horizon=horizon, paired=True),
                        3)
    k_fp = krecv.receive_consts(sim[0], sim[1], px=True, same_ip=True,
                                faults=True)
    k_fpall = dataclasses.replace(k_fp, flood_publish=True, exact_k=True)
    tick_ops, down, cut, nl = faulted_tick("paired", sim, k_fp)
    faulted["receive_update_paired_faults"] = faulted_check(
        "faulted paired receive", k_fp, fault_operands(
            k_fpall, paired_receive_operands(
                k_fpall, full_receive_operands(k_fpall, n, dev, seed=73), n,
                dev, seed=79), dev, 83), tick_ops, down, cut, nl,
        k_rand=k_fpall)
    del tick_ops, sim

    # -- 5i. the slice's main path: the churn benchmark as written, counts
    # reset just before and read just after
    cfg, sc, params, state, msg_tick, probes = churn_sim
    del churn_sim
    step = pg.make_gossip_step(cfg, sc, device=dev)
    ticks_c = churn.WARMUP + churn.TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0_c = torch.cuda.memory_allocated()
    krecv.launches.clear()
    ksel.launches = kfused.launches = kfused.launches_faults = 0
    state = pg.gossip_run(params, state, churn.WARMUP, step, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, counts_c = pg.gossip_run_curve(params, state, churn.TIMED, step,
                                          flagship.N_MSGS, device=dev)
    torch.cuda.synchronize()
    dt_c = time.perf_counter() - t0
    launches_c = dict(krecv.launches, select=ksel.launches)
    peak_c = torch.cuda.max_memory_allocated()
    rows_c = churn.readouts(params, state, counts_c, probes, cfg.n_topics)
    fp = params.faults
    down_c = max(int((~faults.alive_mask(fp, t)).sum())
                 for t in range(churn.WARMUP, ticks_c, 5))
    fm = faults.tick_masks(fp, cfg.offsets, cfg.cinv, t_real)
    cut_c = int(graph.popcount32(fm.alive_all & ~fm.send_ok).sum())
    if not rows_c["ok"]:
        fail(f"churn gates: {rows_c}")
    if not (down_c > 0 and cut_c > 0 and rows_c["delivery_fraction"] < 1):
        fail(f"churn: faults not live: {down_c} down, {cut_c} cut edges, "
             f"delivery fraction {rows_c['delivery_fraction']}")
    if (dict(krecv.launches) != {"scored_faults": ticks_c}
            or launches_c["select"] <= 0):
        fail(f"churn launches {launches_c}")
    if state.tick != ticks_c:
        fail(f"churn: state tick {state.tick}")
    link_ms = churn.link_draw_ms(cfg, params, t_real)
    box = [state]

    def run_more_c():
        box[0] = pg.gossip_run(params, box[0], 20, step, device=dev)

    prof_c = flagship.profile_ticks(run_more_c, 20)
    hb_c = churn.TIMED / dt_c
    print(f"churn path (the benchmark as written): {n} peers x "
          f"{flagship.N_TOPICS} topics, 10% churn in three waves, 2% link "
          f"loss, a half/half partition over ticks "
          f"[{churn.WARMUP + 20}, {churn.heal_tick()}): {hb_c:.2f} "
          f"heartbeats/s ({dt_c * 1e3 / churn.TIMED:.3f} ms/tick), "
          f"delivery fraction {rows_c['delivery_fraction']!r} over "
          f"{rows_c['settled_messages']} settled messages (gate > "
          f"{churn.MIN_DELIVERY_FRACTION}), probe recovery ticks "
          f"{rows_c['probe_recovery_ticks']}, median "
          f"{rows_c['recovery_ticks_median']}; up to {down_c} peers down, "
          f"{cut_c} cut edges on tick {t_real}; one tick's fault masks "
          f"(the link draw) {link_ms:.4f} ms; peak memory {peak_c} B "
          f"({alloc0_c} B at the start), launches {launches_c}; 20 more "
          f"heartbeats profiled: {prof_c['wall_ms_per_tick']:.3f} ms/tick "
          f"wall, {prof_c['device_busy_ms_per_tick']:.3f} busy, idle share "
          f"{prof_c['device_idle_share']:.3f} [{name}, {smi}]")
    main_churn = dict(
        rows_c, heartbeats_per_s=hb_c, ms_per_tick=dt_c * 1e3 / churn.TIMED,
        peak_bytes=peak_c, start_bytes=alloc0_c, launches=launches_c,
        max_down_peers=down_c, cut_edges=cut_c, link_draw_ms=link_ms,
        device_idle_share=prof_c["device_idle_share"],
        device_busy_ms_per_tick=prof_c["device_busy_ms_per_tick"],
        profile_kernels=prof_c["kernels"][:8])
    del params, state, step, box, counts_c

    # -- 5j. B2 under faults and cold restart against its plain version at
    # the resident shapes, one window from tick 24 (rejoins at 25 and 30,
    # the partition from 20); then 64 heartbeats of the resident
    # configuration under the churn benchmark's kind of schedule with cold
    # restart on fused windows and one by one (the faulted unscored
    # receive, its tick 30 also checked against its plain version)
    n_r = resident.N_PEERS
    sched_r = churn.schedule(n_r, np.random.default_rng(5), 0, RES_WARMUP,
                             cold_restart=True)
    cfg_c, params, state, *_ = resident.build(dev, horizon=RES_WARMUP,
                                              fault_schedule=sched_r)
    k_c = kfused.fused_consts(cfg_c)
    step_c = pg.make_gossip_step(cfg_c, None, device=dev)
    k_fu = krecv.receive_consts(cfg_c, None, faults=True)
    rand_u = fault_operands(k_fu, random_receive_operands(
        k_fu, n_r, 1, dev, seed=89), dev, 97)
    t_u = 30
    krecv.launches.clear()
    box = [state]
    tick_ops = capture_receive(lambda: box.append(pg.gossip_run(
        params, state, t_u + 1, step_c, device=dev)), krecv)
    fm = faults.tick_masks(params.faults, cfg_c.offsets, cfg_c.cinv, t_u)
    down = int((tick_ops["alive_w"] == 0).sum())
    cut = int(graph.popcount32(fm.alive_all & ~fm.send_ok).sum())
    faulted["receive_update_unscored_faults"] = faulted_check(
        "faulted unscored receive", k_fu, rand_u, tick_ops, down, cut,
        krecv.launches["unscored_faults"], tick=t_u)
    del tick_ops, rand_u, box
    st = pg.gossip_run(params, state, 24, step_c, device=dev)
    tk = torch.arange(st.tick, st.tick + Tw, dtype=torch.int32, device=dev)
    all_c = (1 << cfg_c.n_candidates) - 1
    rows_r = pg.window_fault_rows(cfg_c, params.faults, st.tick, Tw)
    fops = dict(
        tick0=st.tick, seeds=kfused.window_seeds(st.tick, Tw, st.salt),
        due=graph.pack_bits(params.publish_tick[None, :] == tk[:, None]),
        sub_all=torch.where(params.subscribed, all_c, 0).to(torch.int32),
        cand_sub=params.cand_sub_bits, origin=params.origin_words,
        have=st.have, recent=st.recent, mesh=st.mesh, fanout=st.fanout,
        last_pub=st.last_pub, backoff=st.backoff, tgt=st.gates[0],
        bog=st.gates[1], **rows_r)
    if not (bool(rows_r["rejoin"].any())
            and bool((rows_r["alive"] == 0).any())):
        fail("faulted fused window: no rejoin or no down peer in the window")
    sel_rows_c = [0]
    real_sel = kfused.select_plain

    def count_sel_c(elig, kk, c, seed):
        sel_rows_c[0] += int((kk > 0).sum())
        return real_sel(elig, kk, c, seed)

    kfused.select_plain = count_sel_c
    try:
        want = kfused.fused_gossip_update_plain(k_c, **fops)
    finally:
        kfused.select_plain = real_sel
    got = kfused.fused_gossip_update(k_c, **fops)
    torch.cuda.synchronize()
    err_fc = check_identical("faulted fused window (cold restart)", got, want)
    fc_ms = eager_ms(lambda: kfused.fused_gossip_update(k_c, **fops), 20)
    fc_plain_ms = eager_ms(
        lambda: kfused.fused_gossip_update_plain(k_c, **fops), 2)
    rows_ms = eager_ms(lambda: pg.window_fault_rows(
        cfg_c, params.faults, st.tick, Tw), 20)
    # exact-k targets add one selection per peer-tick; Bernoulli targets
    # (this window's) are in the per-row count already
    fc_rows = sel_rows_c[0] + k_c.receive.exact_k * n_r * Tw
    fc_bound = bound(kfused.window_operand_bytes(fops),
                     fused_window_ops(k_c, fops, fc_rows))
    print(f"faulted fused window (cold restart): identical at N={n_r}, "
          f"C={C}, W=1, T={Tw} from tick {st.tick} "
          f"({int((rows_r['alive'] == 0).sum())} down peer-ticks, "
          f"{int((rows_r['rejoin'] != 0).sum())} rejoins); kernel "
          f"{fc_ms:.4f} ms, plain {fc_plain_ms:.3f} ms per window, the "
          f"window's fault rows (T link draws, on the device) "
          f"{rows_ms:.4f} ms; operands "
          f"{kfused.window_operand_bytes(fops) / n_r:.1f} B/peer, bound "
          f"{fc_bound[0]:.4f} ms ({fc_bound[1]})")
    del want, got, fops, st, rows_r
    win_c = pg.make_fused_window(cfg_c, None, ticks_fused=Tw, device=dev)
    krecv.launches.clear()
    ksel.launches = kfused.launches = kfused.launches_faults = 0
    end_fused = pg.gossip_run_fused(params, state, RES_WARMUP, win_c,
                                    device=dev)
    torch.cuda.synchronize()
    counts_fc = {"fused_faults": kfused.launches_faults,
                 "fused": kfused.launches, "select": ksel.launches,
                 "receive": krecv.launches.total()}
    if counts_fc != {"fused_faults": RES_WARMUP // Tw, "fused": 0,
                     "select": 0, "receive": 0}:
        fail(f"faulted fused launches {counts_fc}")
    d_fc = digest(end_fused)
    end_tick = pg.gossip_run(params, state, RES_WARMUP, step_c, device=dev)
    d_tc = digest(end_tick)
    rejoins = sum(int(faults.rejoined_mask(params.faults, t).sum())
                  for t in range(RES_WARMUP))
    if d_fc != d_tc or rejoins <= 0:
        fail(f"faulted fused digest: per-tick {d_tc} != fused {d_fc} "
             f"({rejoins} rejoins)")
    deg_fc = pg.mesh_degrees(end_fused)[params.subscribed].to(
        torch.float64).mean().item()
    print(f"faulted resident (cold restart): {RES_WARMUP} heartbeats on "
          f"{counts_fc['fused_faults']} fused windows and one by one: digest "
          f"{d_fc} both, {rejoins} rejoins, mean mesh degree {deg_fc:.3f}")
    del params, state, end_fused, end_tick

    # -- 6. the unscored receive kernel vs plain at the resident shapes
    n_r = resident.N_PEERS
    cfg_r, params, state, msg_topic, _ = resident.build(dev)
    k_u = krecv.receive_consts(cfg_r, None)
    ops = random_receive_operands(k_u, n_r, 1, dev, seed=13)
    err_urand = check_identical("unscored receive (random operands)",
                                krecv.receive_update(k_u, **ops),
                                krecv.receive_update_plain(k_u, **ops))
    step_u = pg.make_gossip_step(cfg_r, None, device=dev)
    tick_ops = capture_receive(
        lambda: pg.gossip_run(params, state, 12, step_u, device=dev), krecv)
    want = krecv.receive_update_plain(k_u, **tick_ops)
    got = krecv.receive_update(k_u, **tick_ops)
    torch.cuda.synchronize()
    err_utick = check_identical("unscored receive (a real tick)", got, want)
    urcv_ms = device_ms(lambda: krecv.receive_update(k_u, **tick_ops), 50)
    urcv_plain_ms = device_ms(
        lambda: krecv.receive_update_plain(k_u, **tick_ops), 5)
    urcv_bytes = krecv.operand_bytes(tick_ops, got)
    urcv_bound = bound(urcv_bytes, receive_ops(k_u, tick_ops))
    print(f"unscored receive: identical at N={n_r}, C={C}, W=1 (random "
          f"and real tick); device time: kernel {urcv_ms:.4f} ms, plain "
          f"{urcv_plain_ms:.3f} ms; {urcv_bytes / n_r:.1f} B/peer")
    del want, got, ops, tick_ops

    # -- 7. the fused-window kernel vs plain, N = 1M, T = 8, on two real
    # carries: the built state (mesh formation: grafts and prunes run)
    # and the state after warm-up (12 per-tick steps), where it is timed
    k_f = kfused.fused_consts(cfg_r)
    all_c = (1 << cfg_r.n_candidates) - 1
    real_sel = kfused.select_plain
    err_fused = 0.0
    for st in (state, pg.gossip_run(params, state, 12, step_u, device=dev)):
        tk = torch.arange(st.tick, st.tick + Tw, dtype=torch.int32,
                          device=dev)
        fops = dict(
            tick0=st.tick, seeds=kfused.window_seeds(st.tick, Tw, st.salt),
            due=graph.pack_bits(params.publish_tick[None, :] == tk[:, None]),
            sub_all=torch.where(params.subscribed, all_c, 0).to(torch.int32),
            cand_sub=params.cand_sub_bits, origin=params.origin_words,
            have=st.have, recent=st.recent, mesh=st.mesh, fanout=st.fanout,
            last_pub=st.last_pub, backoff=st.backoff, tgt=st.gates[0],
            bog=st.gates[1])
        sel_rows = [0]

        def count_sel(elig, kk, c, seed):
            sel_rows[0] += int((kk > 0).sum())
            return real_sel(elig, kk, c, seed)

        kfused.select_plain = count_sel
        try:
            want = kfused.fused_gossip_update_plain(k_f, **fops)
        finally:
            kfused.select_plain = real_sel
        got = kfused.fused_gossip_update(k_f, **fops)
        torch.cuda.synchronize()
        err_fused = max(err_fused, check_identical(
            f"fused window from tick {st.tick}", got, want))
        print(f"fused window: identical at N={n_r}, C={C}, W=1, T={Tw} "
              f"from tick {st.tick} ({sel_rows[0]} selection rows)")
    # a cooperative launch is timed by CUDA events over back-to-back
    # launches (no CUDA-graph capture)
    fused_ms = eager_ms(lambda: kfused.fused_gossip_update(k_f, **fops), 20)
    fused_plain_ms = eager_ms(
        lambda: kfused.fused_gossip_update_plain(k_f, **fops), 2)
    fused_bytes = kfused.window_operand_bytes(fops)
    fused_bound = bound(fused_bytes,
                        fused_window_ops(k_f, fops, sel_rows[0]))
    print(f"fused window from tick {st.tick}: kernel {fused_ms:.4f} ms, "
          f"plain {fused_plain_ms:.3f} ms per window; operands "
          f"{fused_bytes / n_r:.1f} B/peer, bound {fused_bound[0]:.4f} ms "
          f"({fused_bound[1]}); the kernel's stage, apart: "
          f"{kfused.stage_bytes(k_f, fops) / n_r:.1f} B/peer")
    del want, got, fops, st

    # -- 8. full-size identity: 16 per-tick steps vs 2 fused windows
    win = pg.make_fused_window(cfg_r, None, ticks_fused=Tw, device=dev)
    d_tick = digest(pg.gossip_run(params, state, 2 * Tw, step_u,
                                  device=dev))
    d_fused = digest(pg.gossip_run_fused(params, state, 2 * Tw, win,
                                         device=dev))
    if d_tick != d_fused:
        fail(f"digest: per-tick {d_tick} != fused {d_fused}")
    print(f"identity: {2 * Tw} per-tick ticks and 2 fused windows at "
          f"N={n_r}: digest {d_fused} both")
    del params, state

    # -- 9. the resident main path, then the per-tick path, each with its
    # counts reset just before and read just after
    horizon = RES_WARMUP + RES_TIMED
    paths = {}
    for path in ("fused", "per_tick"):
        cfg_r, params, state, msg_topic, msg_tick = resident.build(
            dev, horizon=horizon)
        if path == "fused":
            win = pg.make_fused_window(cfg_r, None, ticks_fused=Tw,
                                       device=dev)

            def run_n(st, n_ticks):
                return pg.gossip_run_fused(params, st, n_ticks, win,
                                           device=dev)
        else:
            step_u = pg.make_gossip_step(cfg_r, None, device=dev)

            def run_n(st, n_ticks):
                return pg.gossip_run(params, st, n_ticks, step_u,
                                     device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        krecv.launches.clear()
        ksel.launches = kfused.launches = 0
        state = run_n(state, RES_WARMUP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = run_n(state, RES_TIMED)
        torch.cuda.synchronize()
        dt_r = time.perf_counter() - t0
        counts = {"receive": krecv.launches["scored"],
                  "receive_unscored": krecv.launches["unscored"],
                  "select": ksel.launches, "fused": kfused.launches}
        peak_r = torch.cuda.max_memory_allocated()
        sub = params.subscribed
        deg_r = pg.mesh_degrees(state)[sub].to(torch.float64).mean().item()
        if not deg_r >= cfg_r.d_lo:
            fail(f"{path}: mesh failed to form: mean degree {deg_r}")
        reach, members = resident.topic_reach(params, state, msg_topic,
                                              resident.N_TOPICS)
        settled = msg_tick < horizon - 30
        if not (reach[settled] == members[settled]).all():
            fail(f"{path}: delivery gate: reach {reach[settled].tolist()} "
                 f"!= members {members[settled].tolist()}")
        if state.tick != horizon:
            fail(f"{path}: state tick {state.tick}")
        if path == "fused":
            want_counts = {"receive": 0, "receive_unscored": 0, "select": 0,
                           "fused": horizon // Tw}
            if counts != want_counts:
                fail(f"fused path launches {counts} != {want_counts}")
        elif (counts["receive_unscored"] != horizon or counts["fused"]
              or counts["receive"] or counts["select"] != 3 * horizon):
            fail(f"per-tick path launches {counts}")
        paths[path] = dict(
            heartbeats_per_s=RES_TIMED / dt_r,
            ms_per_tick=dt_r * 1e3 / RES_TIMED, peak_bytes=peak_r,
            mean_mesh_degree=deg_r, launches=counts,
            settled_messages=int(settled.sum()))
        print(f"resident {path}: {n_r} peers x {resident.N_TOPICS} topics, "
              f"C={C}, M={resident.N_MSGS}: {RES_TIMED / dt_r:.2f} "
              f"heartbeats/s ({dt_r * 1e3 / RES_TIMED:.3f} ms/tick), mean "
              f"mesh degree {deg_r:.3f}, {int(settled.sum())} settled "
              f"messages each at all {members[settled].tolist()} members, "
              f"peak memory {peak_r} B, launches {counts}")
        del params, state

    # -- 10. the numbers
    print(f"heartbeats/s [{name}, {smi}]: flagship scored per-tick "
          f"{hb:.2f}; adversarial scored per-tick {hb_a:.2f}; "
          f"everything-on scored per-tick {hb_e:.2f}; everything-on paired "
          f"(the benchmark as written) per-tick {hb_p:.2f}; churn (the "
          f"benchmark as written) scored per-tick {hb_c:.2f}; resident "
          f"unscored "
          f"fused "
          f"{paths['fused']['heartbeats_per_s']:.2f}, per-tick "
          f"{paths['per_tick']['heartbeats_per_s']:.2f}")
    print(f"churn rows [{name}, {smi}]: heartbeats/s {hb_c!r}; delivery "
          f"fraction {main_churn['delivery_fraction']!r} (gate > "
          f"{churn.MIN_DELIVERY_FRACTION}); partition recovery ticks, "
          f"median {main_churn['recovery_ticks_median']!r} of "
          f"{main_churn['probes_recovered']} recovered probes")
    rcv_bound = bound(rcv_bytes, rcv_ops)
    sel_bound = bound(sel_bytes, sel_ops)
    kernels = [
        dict(name="receive_update", route="cuda",
             source="go_libp2p_pubsub_tpu_torch/csrc/receive.cu",
             replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:293",
             launches=launches["receive"],
             max_abs_err=max(err_rand, err_tick), ms=rcv_ms,
             plain_ms=rcv_plain_ms, bound_ms=rcv_bound[0],
             bound_by=rcv_bound[1], library_ms=None),
        dict(name="receive_update_attacks", route="cuda",
             source="go_libp2p_pubsub_tpu_torch/csrc/receive.cu",
             replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:293",
             launches=launches_adv["receive_attacks"],
             max_abs_err=max(err_arand, err_atick), ms=arcv_ms,
             plain_ms=arcv_plain_ms, bound_ms=arcv_bound[0],
             bound_by=arcv_bound[1], library_ms=None),
        dict(name="receive_update_full", route="cuda",
             source="go_libp2p_pubsub_tpu_torch/csrc/receive.cu",
             replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:293",
             launches=launches_ev["receive_full"],
             max_abs_err=max(err_full, err_xk), ms=full_ms,
             plain_ms=full_plain_ms, bound_ms=full_bound[0],
             bound_by=full_bound[1], library_ms=None),
        dict(name="receive_update_paired", route="cuda",
             source="go_libp2p_pubsub_tpu_torch/csrc/receive.cu",
             replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:293",
             launches=launches_pp["receive_paired"],
             max_abs_err=err_paired, ms=paired_ms, plain_ms=paired_plain_ms,
             bound_ms=paired_bound[0], bound_by=paired_bound[1],
             library_ms=None),
        dict(name="receive_update_paired_unscored", route="cuda",
             source="go_libp2p_pubsub_tpu_torch/csrc/receive.cu",
             replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:293",
             launches=launches_up["receive_paired_unscored"],
             max_abs_err=err_up, ms=up_ms, plain_ms=up_plain_ms,
             bound_ms=up_bound[0], bound_by=up_bound[1], library_ms=None),
        dict(name="receive_update_unscored", route="cuda",
             source="go_libp2p_pubsub_tpu_torch/csrc/receive.cu",
             replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:293",
             launches=paths["per_tick"]["launches"]["receive_unscored"],
             max_abs_err=max(err_urand, err_utick), ms=urcv_ms,
             plain_ms=urcv_plain_ms, bound_ms=urcv_bound[0],
             bound_by=urcv_bound[1], library_ms=None),
        dict(name="select_k_bits", route="cuda",
             source="go_libp2p_pubsub_tpu_torch/csrc/select.cu",
             replaces="go_libp2p_pubsub_tpu/ops/pallas/select.py:39",
             launches=launches["select"], max_abs_err=sel_err,
             ms=sel_ms, plain_ms=sel_plain_ms, bound_ms=sel_bound[0],
             bound_by=sel_bound[1], library_ms=None),
        dict(name="fused_gossip_update", route="cuda",
             source="go_libp2p_pubsub_tpu_torch/csrc/fused.cu",
             replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:1662",
             launches=paths["fused"]["launches"]["fused"],
             max_abs_err=err_fused, ms=fused_ms, plain_ms=fused_plain_ms,
             bound_ms=fused_bound[0], bound_by=fused_bound[1],
             library_ms=None),
        dict(name="fused_gossip_update_exact_k", route="cuda",
             source="go_libp2p_pubsub_tpu_torch/csrc/fused.cu",
             replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:1662",
             launches=counts_x["fused"], max_abs_err=err_fx, ms=fx_ms,
             plain_ms=fx_plain_ms, bound_ms=fx_bound[0],
             bound_by=fx_bound[1], library_ms=None)]
    # the faulted variants: the churn path's launches for the flagship
    # options, else those of the run to the checked tick
    for kname, r in faulted.items():
        kernels.append(dict(
            name=kname, route="cuda",
            source="go_libp2p_pubsub_tpu_torch/csrc/receive.cu",
            replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:293",
            launches=(launches_c["scored_faults"]
                      if kname == "receive_update_faults"
                      else r["launches"]),
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=None))
    kernels.append(dict(
        name="fused_gossip_update_faults", route="cuda",
        source="go_libp2p_pubsub_tpu_torch/csrc/fused.cu",
        replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:1662",
        launches=counts_fc["fused_faults"], max_abs_err=err_fc, ms=fc_ms,
        plain_ms=fc_plain_ms, bound_ms=fc_bound[0], bound_by=fc_bound[1],
        library_ms=None))
    print(json.dumps({"main_path": {
        "flagship": main_flagship, "adversarial": main_adversarial,
        "everything": main_everything, "everything_paired": main_paired,
        "churn": main_churn, "resident": paths, "card": smi,
        "faulted_receive": {
            kname: {key: v for key, v in r.items() if key != "bound"}
            for kname, r in faulted.items()},
        "resident_cold_restart": dict(
            digest=d_fc, rejoins=rejoins, launches=counts_fc,
            fault_rows_ms=rows_ms, mean_mesh_degree=deg_fc),
        "eager_ms": {"receive": rcv_eager_ms, "select": sel_eager_ms},
        "full_receive_ms": {"main_path": full_ms, "all_options": full_all_ms,
                            "exact_k_alone": xk_ms},
        "seconds": time.perf_counter() - t_start}}))
    print(json.dumps({"kernels": kernels}))
    # -- 11. the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
