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
    counts."""
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
    per_row = 60 + 2 * 10 if k.scored else 6 + 10
    extra = 0
    if k.attacks:
        n_syb = int((ops["syb"] != 0).sum())
        extra = n * C * 12 + 3 * n_syb * C * W
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
    draws (~10 each) and C * C rank compares (~3 each)."""
    C = k.n_candidates
    W, n = ops["have"].shape
    T = len(ops["seeds"])
    return (n * T * (90 + 38 * C + 6 * C * W)
            + select_rows * (10 * C + 3 * C * C))


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs "
             "an NVIDIA GPU")
    from go_libp2p_pubsub_tpu_torch import adversarial, flagship, resident
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
    krecv.launches = 0
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
    launches = {"receive": krecv.launches, "select": ksel.launches}
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
    krecv.launches = krecv.launches_attacks = 0
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
    launches_adv = {"receive_attacks": krecv.launches_attacks,
                    "receive": krecv.launches, "select": ksel.launches}
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
    Tw = resident.WINDOW
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
        krecv.launches = krecv.launches_unscored = 0
        ksel.launches = kfused.launches = 0
        state = run_n(state, RES_WARMUP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = run_n(state, RES_TIMED)
        torch.cuda.synchronize()
        dt_r = time.perf_counter() - t0
        counts = {"receive": krecv.launches,
                  "receive_unscored": krecv.launches_unscored,
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
          f"{hb:.2f}; adversarial scored per-tick {hb_a:.2f}; resident "
          f"unscored fused "
          f"{paths['fused']['heartbeats_per_s']:.2f}, per-tick "
          f"{paths['per_tick']['heartbeats_per_s']:.2f}")
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
             library_ms=None)]
    print(json.dumps({"main_path": {
        "flagship": main_flagship, "adversarial": main_adversarial,
        "resident": paths, "card": smi,
        "eager_ms": {"receive": rcv_eager_ms, "select": sel_eager_ms},
        "seconds": time.perf_counter() - t_start}}))
    print(json.dumps({"kernels": kernels}))
    # -- 11. the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
