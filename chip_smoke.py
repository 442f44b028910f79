"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. the device: torch's name and count, nvidia-smi's name and power limit;
2. build both CUDA kernels from ``go_libp2p_pubsub_tpu_torch/csrc``
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
6. one JSON line with every kernel's numbers;
7. the last line: ``{"ok": true, "device": {...}}``.

It needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import time

import torch

WARMUP, TIMED = 100, 300
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
    """Seeded random receive operands (the kernel's full input space)."""
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
    return dict(
        valid=words((w,)), gseeds=(0x9E3779B9, 0x85EBCA6B),
        ctrl=torch.randint(0, 64, (C, n), generator=g, device=device).to(
            torch.uint8),
        fresh=words((w, n)) & words((w, n)), adv=words((w, n)),
        pay=words((n,), C), gsp=words((n,), C), acc=words((n,), C),
        sub_all=torch.where(sub, (1 << C) - 1, 0).to(torch.int32),
        cand_sub=words((n,), C), fanout=words((n,), C) & words((n,), C),
        wa=words((n,), C), bo2=words((n,), C),
        grafts=words((n,), C) & words((n,), C),
        dropped=words((n,), C) & words((n,), C), meshsel=words((n,), C),
        seen=words((w, n)) & words((w, n)), injected=words((w, n)) & 0x0F0F,
        backoff=torch.randint(0, 61, (C, n), generator=g,
                              device=device).to(torch.int16),
        static=None, fd=ctr(60.0), inv=ctr(3.0),
        bp=ctr(3.0).to(k.bp_dtype),
        tim=torch.randint(0, 32767, (C, n), generator=g,
                          device=device).to(torch.int16),
        iws=torch.randint(0, 30001, (C, n), generator=g,
                          device=device).to(torch.int16))


def receive_ops(k, ops) -> int:
    """Operations the receive half needs on these operands: ~15 integer
    ops per edge, ~8 per message word over an edge whose gates are open
    (this tick's data), ~60 integer/f32 ops per counter row and ~10 per
    lane-hash draw (two draws per row)."""
    n = ops["pay"].shape[0]
    W = ops["fresh"].shape[0]
    C = k.n_candidates
    open_words = 0
    for j, (o, ci) in enumerate(zip(k.offsets, k.cinv)):
        ctl = torch.roll(ops["ctrl"][ci], -o).to(torch.int32)
        ok_p = (ops["pay"] >> j) & 1
        ok_g = ok_p & ((ops["gsp"] >> j) & 1)
        on = (ctl & ok_p & 1) | ((ctl >> 1) & ok_g & 1)
        open_words += W * int(on.sum())
    return n * C * (15 + 60 + 2 * 10) + 8 * open_words


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs "
             "an NVIDIA GPU")
    from go_libp2p_pubsub_tpu_torch import flagship
    from go_libp2p_pubsub_tpu_torch.models import gossipsub as pg
    from go_libp2p_pubsub_tpu_torch.ops import graph
    from go_libp2p_pubsub_tpu_torch.ops.kernels import _build
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

    # -- 2. build both kernels, concurrently
    t0 = time.perf_counter()
    logs = _build.build(("select", "receive"))
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{src}]: {line.strip()}")
    print(f"build: {time.perf_counter() - t0:.1f} s")

    n, C = flagship.N_PEERS, flagship.N_CAND
    kernels = {}

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
    captured = []
    real = krecv.receive_update

    def capture(k_, **ops_):
        captured[:] = [ops_]            # keep the latest tick only
        return real(k_, **ops_)

    krecv.receive_update = capture
    try:
        st = state
        for _ in range(40):
            st = step(params, st)[0]
    finally:
        krecv.receive_update = real
    tick_ops = captured[-1]
    del captured, st
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

    # -- 6. the kernels line
    kernels["receive"] = dict(
        name="receive_update", route="cuda",
        source="go_libp2p_pubsub_tpu_torch/csrc/receive.cu",
        replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:293",
        launches=launches["receive"], max_abs_err=max(err_rand, err_tick),
        ms=rcv_ms, plain_ms=rcv_plain_ms,
        bound_ms=max(rcv_bytes / HBM_BYTES_PER_S,
                     rcv_ops / F32_OPS_PER_S) * 1e3,
        bound_by=("bytes" if rcv_bytes / HBM_BYTES_PER_S
                  >= rcv_ops / F32_OPS_PER_S else "operations"),
        library_ms=None)
    kernels["select"] = dict(
        name="select_k_bits", route="cuda",
        source="go_libp2p_pubsub_tpu_torch/csrc/select.cu",
        replaces="go_libp2p_pubsub_tpu/ops/pallas/select.py:39",
        launches=launches["select"], max_abs_err=sel_err,
        ms=sel_ms, plain_ms=sel_plain_ms,
        bound_ms=max(sel_bytes / HBM_BYTES_PER_S,
                     sel_ops / F32_OPS_PER_S) * 1e3,
        bound_by=("bytes" if sel_bytes / HBM_BYTES_PER_S
                  >= sel_ops / F32_OPS_PER_S else "operations"),
        library_ms=None)
    print(json.dumps({"main_path": {
        "heartbeats_per_s": hb, "ms_per_tick": dt * 1e3 / TIMED,
        "peak_bytes": peak, "mean_mesh_degree": deg, "card": smi,
        "eager_ms": {"receive": rcv_eager_ms, "select": sel_eager_ms},
        "seconds": time.perf_counter() - t_start}}))
    print(json.dumps({"kernels": list(kernels.values())}))
    # -- 7. the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
