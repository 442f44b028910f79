"""Compare builds of the receive kernel on one GPU, in one process.

    python -m go_libp2p_pubsub_tpu_torch.kernel_ab SRC.cu [SRC.cu ...] [--reps 3]

Each source is a variant of ``csrc/receive.cu`` with the same C interface
(``gossip_receive_update`` and ``struct ReceiveArgs`` of this tree's
wrapper, whose head an older source's struct matches), next to the
headers it includes (since the telemetry slice, ``receive_body.cuh``).
Each is built with the port's nvcc flags, all concurrently (its ptxas
summary printed), then the receive
operands of the last tick of 40 of the 1M-peer adversarial, flagship,
everything-on and paired everything-on sims and of tick 130 of the churn
benchmark's sim (inside a churn wave and the partition) are captured (the
everything-on tick only for the sources that have the full variant,
``receive_kernel_full``, the paired one only for those with
``receive_kernel_paired``, the churn tick only for those with
``receive_kernel_faults``), every build is checked
bit-identical to the plain version on them, and the builds are timed in
turns (``chip_smoke.device_ms``: CUDA
events over a CUDA-graph replay of 50 launches), ``--reps`` times each.
Then the knob sweep's ``gf40`` point (``knob_sweep.py``) on the 1M-peer
flagship: this tree's knob variant (``csrc/receive_knobs.cu``) on tick 40
of the armed sim, timed in turns beside each build's twin without knobs on
the same operands.  Then the pipelined benchmark's ``base4j2`` point
(``pipelined.py``) at 1,000,000 peers: this tree's delay variant
(``csrc/receive_delays.cu``, ``scored+delays+knobs``) on tick 40 of the
armed sim, timed in turns beside its delay-free twin (``scored+knobs``) on
tick 40 of the same sim without delays.  Prints one JSON line with the
card and every build's times.

    python -m go_libp2p_pubsub_tpu_torch.kernel_ab --ptxas A.cu B.cu [...]

builds any sources (``select.cu``, ``fused.cu`` too) and stops after
their ptxas lines, with the first source's lines that each other source
lacks and the lines it adds: a parent's source first, the change's after
it.  ``--ptxas --parent DIR`` (no sources) compares every source of this
tree's ``csrc`` that DIR also holds (a parent's ``csrc``) with the
parent's, all built concurrently.

    python -m go_libp2p_pubsub_tpu_torch.kernel_ab --fused A.cu B.cu [...]

builds variants of ``csrc/fused.cu`` (this tree's C interface, headers
beside each) concurrently, prints each one's ptxas lines and build
seconds, and times them in turns on ``chip_smoke.py`` phase 7's two real
carries at 1,048,576 peers, T = 8 (the built state, mesh formation, and
the state after 12 per-tick steps): CUDA events over 20 back-to-back
launches, ``--reps`` times each.  Whether each build's outputs equal the
plain version's is printed beside its times, and not required: a variant
that skips part of the window (to split its time) gives other outputs.

    python -m go_libp2p_pubsub_tpu_torch.kernel_ab --parent DIR [--reps 3]
        [--only LABEL,...]

times every kernel of the parent's ``csrc`` (DIR, with its headers: e.g.
``git archive HEAD~1 go_libp2p_pubsub_tpu_torch/csrc`` unpacked under the
git-ignored ``build/``) against this tree's, in turns, on one card: each
source that both hold and the wrapper loads (the five receive libraries,
``select.cu``, ``fused.cu``) is built in both versions, concurrently;
each receive family on its real 1M-peer tick (the flagship, exact-k alone
on the flagship's tick, adversarial, everything-on, paired everything-on,
churn tick 130, the flagship stepped with telemetry, the knob sweep's
``gf40`` point, the pipelined ``base4j2`` point, the resident unscored
configuration), select on ``chip_smoke.py`` phase 3's seeded operands and
on every call of a flagship tick, and the fused window (clean, exact-k,
faulted with cold restart, telemetry clean and faulted with cold restart)
at the resident shapes; each
version checked bit-identical to the plain version first.  Prints one
JSON line with the card and every time by version.  ``--only`` keeps the
named receive families (``flagship``, ``flagship_exact_k``,
``adversarial``, ``everything``, ``everything_paired``, ``churn``,
``telemetry``, ``gf40_knobs``, ``base4j2_delays``,
``resident_unscored``) and ``select`` and ``fused`` (all their calls),
and builds no sim for the others, so that a comparison can be split
across runs of a bounded length.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import adversarial, churn, everything, flagship, knob_sweep
from .models import gossipsub as gs
from .ops.kernels import _build
from .ops.kernels import receive as krecv

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--fused", action="store_true",
                    help="the sources are variants of csrc/fused.cu")
    ap.add_argument("--only", default=None,
                    help="comma-separated labels (--parent only)")
    args = ap.parse_args()
    only = None if args.only is None else set(args.only.split(","))
    if only is not None and only - set(LABEL_LIBRARY):
        raise SystemExit(
            f"unknown labels: {sorted(only - set(LABEL_LIBRARY))}")
    if not torch.cuda.is_available():
        raise SystemExit("the comparison needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    out_dir = _build.BUILD_DIR / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.parent is not None and args.ptxas:
        ptxas_against_parent(cs, args.parent, out_dir)
        return
    if args.fused:
        print(json.dumps(fused_variants(cs, args.sources, out_dir,
                                        args.reps)))
        return
    if args.parent is not None:
        print(json.dumps(against_parent(cs, args.parent, out_dir,
                                        args.reps, only)))
        return
    # one nvcc per source, all at once
    procs = {src: (out_dir / f"libreceive{i}.so", subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
         str(out_dir / f"libreceive{i}.so"), src], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
        for i, src in enumerate(args.sources)}
    libs, lines = {}, {}
    for src, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {src} failed:\n{log}")
        lines[src] = cs.ptxas_summary(log)
        for line in lines[src]:
            print(f"ptxas[{src}]: {line}")
        libs[src] = ctypes.CDLL(str(lib))
    if args.ptxas:
        first, *others = args.sources
        for src in others:
            old, new = set(lines[first]), set(lines[src])
            print(f"{src}: {len(new)} lines; of {first}'s {len(old)}, "
                  f"{len(old - new)} missing; {len(new - old)} added")
            for line in sorted(old - new):
                print(f"  missing: {line}")
        return
    dev = torch.device("cuda")
    times = {}
    has = {name: {src for src in libs if name in Path(src).read_text()}
           for name in ("receive_kernel_full", "receive_kernel_paired",
                        "receive_kernel_faults")}
    all_libs = dict(libs)
    # each sim stepped ``run`` ticks: its last tick's operands
    for label, build, run in (
            ("adversarial", adversarial.build, 40),
            ("flagship", flagship.build, 40),
            ("everything", everything.build, 40),
            ("everything_paired",
             lambda dev, horizon: everything.build(dev, horizon=horizon,
                                                   paired=True), 40),
            ("churn", lambda dev, horizon: churn.build(dev),
             churn.heal_tick() - 19)):
        cfg, sc, params, state = build(dev, horizon=400)[:4]
        k = krecv.receive_consts(cfg, sc, px=state.active is not None,
                                 same_ip=params.cand_same_ip is not None,
                                 faults=params.faults is not None)
        need = ("receive_kernel_faults" if k.faults else
                "receive_kernel_paired" if k.paired else
                "receive_kernel_full" if k.full else None)
        libs = {src: lib for src, lib in all_libs.items()
                if need is None or src in has[need]}
        step = gs.make_gossip_step(cfg, sc, device=dev)
        ops = cs.capture_receive(
            lambda: gs.gossip_run(params, state, run, step, device=dev), krecv)
        want = krecv.receive_update_plain(k, **ops)
        for src, lib in libs.items():
            _build._LIBS["receive"] = lib
            cs.check_identical(f"{label} {src}", krecv.receive_update(k, **ops),
                               want)
        times[label] = {src: [] for src in libs}
        for rep in range(args.reps):
            for src in (list(libs) if rep % 2 == 0 else list(libs)[::-1]):
                _build._LIBS["receive"] = libs[src]
                times[label][src].append(cs.device_ms(
                    lambda: krecv.receive_update(k, **ops), 50))
        del params, state, step, ops, want
    # a knob point's tick: the knob variant beside each build's twin
    cfg, sc, params, state = knob_sweep.arm(
        flagship.build(dev, horizon=400), knob_sweep.FLAGSHIP_POINTS["gf40"])[:4]
    k_kn = krecv.receive_consts(cfg, sc, knobs=True)
    k_tw = krecv.receive_consts(cfg, sc)
    step = gs.make_gossip_step(cfg, sc, device=dev)
    ops = cs.capture_receive(
        lambda: gs.gossip_run(params, state, 40, step, device=dev), krecv)
    ops_tw = {key: v for key, v in ops.items() if key != "knobs"}
    cs.check_identical("flagship gf40 knobs", krecv.receive_update(k_kn, **ops),
                       krecv.receive_update_plain(k_kn, **ops))
    knob_times = {"knobs": [], **{src: [] for src in all_libs}}
    for rep in range(args.reps):
        order = ["knobs", *all_libs]
        for src in (order if rep % 2 == 0 else order[::-1]):
            if src == "knobs":
                knob_times[src].append(cs.device_ms(
                    lambda: krecv.receive_update(k_kn, **ops), 50))
            else:
                _build._LIBS["receive"] = all_libs[src]
                knob_times[src].append(cs.device_ms(
                    lambda: krecv.receive_update(k_tw, **ops_tw), 50))
    _build._LIBS.pop("receive")
    del params, state, step, ops, ops_tw
    print(json.dumps({"card": flagship.card(), "receive_ms": times,
                      "gf40_knobs_ms": knob_times,
                      "base4j2_delays_ms": delayed_tick_ms(cs, dev,
                                                           args.reps)}))


def ptxas_against_parent(cs, parent: Path, out_dir: Path) -> None:
    """Build every source of this tree's csrc that ``parent`` also holds,
    both versions concurrently; print, per source, how many of the
    parent's ptxas lines the tree's build lacks and adds (and each such
    line)."""
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu")
                   if (parent / p.name).exists())
    procs = {}
    for name in names:
        for tag, src in (("parent", parent), ("tree", _build.CSRC)):
            procs[(tag, name)] = subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                 str(out_dir / f"lib{name}_{tag}.so"), str(src / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {key} failed:\n{log}")
        lines[key] = set(cs.ptxas_summary(log))
    for name in names:
        old, new = lines[("parent", name)], lines[("tree", name)]
        print(f"{name}.cu: {len(new)} lines; of the parent's {len(old)}, "
              f"{len(old - new)} missing; {len(new - old)} added")
        for line in sorted(old - new):
            print(f"  missing: {line}")
        for line in sorted(new - old):
            print(f"  added: {line}")


#: the library each ``--only`` label times
LABEL_LIBRARY = {
    "flagship": "receive", "flagship_exact_k": "receive",
    "adversarial": "receive", "everything": "receive",
    "everything_paired": "receive", "churn": "receive",
    "resident_unscored": "receive", "telemetry": "receive_tel",
    "gf40_knobs": "receive_knobs", "base4j2_delays": "receive_delays",
    "select": "select", "fused": "fused"}


def build_versions(cs, parent: Path, out_dir: Path, only=None) -> dict:
    """Build each wrapper-loaded source that ``parent`` also holds (and
    that a label in ``only`` times, where given), the parent's and this
    tree's (the tree's reused where ``_build`` has it already),
    concurrently; print their ptxas lines.  Returns {source name:
    {"parent": CDLL, "tree": CDLL}}."""
    wanted = (None if only is None else
              {LABEL_LIBRARY[label] for label in only})
    names = [name for name in ("select", "fused", *krecv.SOURCES)
             if (parent / f"{name}.cu").exists()
             and (wanted is None or name in wanted)]
    procs = {}
    libs = {name: {} for name in names}
    for name in names:
        for tag, src in (("parent", parent), ("tree", _build.CSRC)):
            if tag == "tree" and _build.lib_path(name).exists():
                libs[name][tag] = ctypes.CDLL(str(_build.lib_path(name)))
                continue
            lib = out_dir / f"lib{name}_{tag}.so"
            procs[(name, tag)] = (lib, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                 str(src / f"{name}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    for (name, tag), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {tag} {name}.cu failed:\n{log}")
        for line in cs.ptxas_summary(log):
            print(f"ptxas[{tag} {name}]: {line}")
        libs[name][tag] = ctypes.CDLL(str(lib))
    return {name: dict(sorted(v.items())) for name, v in libs.items()}


def in_turns(libs: dict, name: str, fn, reps: int, timer) -> dict:
    """Time ``fn`` with each version of library ``name`` loaded, in turns
    (parent, tree, tree, parent, ...)."""
    out = {tag: [] for tag in libs[name]}
    for rep in range(reps):
        order = list(libs[name]) if rep % 2 == 0 else list(libs[name])[::-1]
        for tag in order:
            _build._LIBS[name] = libs[name][tag]
            out[tag].append(timer(fn))
    _build._LIBS.pop(name)
    return out


def each_version(libs: dict, name: str, fn) -> None:
    """Run ``fn`` once with each version of library ``name`` loaded."""
    for lib in libs[name].values():
        _build._LIBS[name] = lib
        fn()
    _build._LIBS.pop(name)


def receive_ticks(cs, dev, only=None):
    """(label, consts, operands) of each receive family's real tick (of
    the labels in ``only``, where given)."""
    from .models import telemetry as tl

    def kept(*labels):
        return only is None or bool(set(labels) & only)

    for label, build, run, kw in (
            ("flagship", flagship.build, 40, {}),
            ("adversarial", adversarial.build, 40, {}),
            ("everything", everything.build, 40, {}),
            ("everything_paired",
             lambda dev, horizon: everything.build(dev, horizon=horizon,
                                                   paired=True), 40, {}),
            ("churn", lambda dev, horizon: churn.build(dev),
             churn.heal_tick() - 19, {}),
            ("telemetry", flagship.build, 40,
             dict(telemetry=tl.TelemetryConfig(latency_hist=True,
                                               latency_buckets=16)))):
        twins = ((label, "flagship_exact_k") if label == "flagship"
                 else (label,))
        if not kept(*twins):
            continue
        cfg, sc, params, state = build(dev, horizon=400)[:4]
        tel = kw.get("telemetry")
        k = krecv.receive_consts(
            cfg, sc, px=state.active is not None,
            same_ip=params.cand_same_ip is not None,
            faults=params.faults is not None, telemetry=tel is not None,
            tel_lat_buckets=16 if tel is not None else 0)
        step = gs.make_gossip_step(cfg, sc, device=dev, **kw)
        ops = cs.capture_receive(
            lambda: gs.gossip_run(params, state, run, step, device=dev),
            krecv)
        if kept(label):
            yield label, k, ops
        if label == "flagship" and kept("flagship_exact_k"):
            yield ("flagship_exact_k", dataclasses.replace(k, exact_k=True),
                   ops)
        del params, state, step, ops
    if kept("gf40_knobs"):
        yield from _knob_tick(cs, dev)
    if kept("base4j2_delays"):
        yield from _delay_tick(cs, dev)
    if kept("resident_unscored"):
        yield from _unscored_tick(cs, dev)


def _knob_tick(cs, dev):
    """The knob sweep's ``gf40`` point: tick 40 of the armed flagship."""
    cfg, sc, params, state = knob_sweep.arm(
        flagship.build(dev, horizon=400),
        knob_sweep.FLAGSHIP_POINTS["gf40"])[:4]
    step = gs.make_gossip_step(cfg, sc, device=dev)
    yield ("gf40_knobs", krecv.receive_consts(cfg, sc, knobs=True),
           cs.capture_receive(
               lambda: gs.gossip_run(params, state, 40, step, device=dev),
               krecv))


def _delay_tick(cs, dev):
    """The pipelined ``base4j2`` point at 1M peers: tick 41's receive."""
    from . import pipelined

    cfg, sc, params, state = pipelined.arm(
        pipelined.build(dev, pipelined.FULL_WIDTH),
        pipelined.POINTS["base4j2"])
    step = gs.make_gossip_step(cfg, sc, device=dev)
    yield ("base4j2_delays",
           krecv.receive_consts(cfg, sc, knobs=True, delays=True),
           cs.capture_receive(
               lambda: gs.gossip_run(params, state, 41, step, device=dev),
               krecv))


def _unscored_tick(cs, dev):
    """The resident configuration per tick, unscored: tick 12's receive."""
    from . import resident

    cfg, params, state, *_ = resident.build(dev)
    step = gs.make_gossip_step(cfg, None, device=dev)
    yield ("resident_unscored", krecv.receive_consts(cfg, None),
           cs.capture_receive(
               lambda: gs.gossip_run(params, state, 12, step, device=dev),
               krecv))


def select_operands(cs, dev):
    """(label, args) of the select calls timed: phase 3's seeded
    operands, then every call of tick 41 of the flagship."""
    from .ops import graph
    from .ops.kernels import select as ksel

    n, C = flagship.N_PEERS, flagship.N_CAND
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    hi = torch.randint(0, 1 << C, (n,), generator=g, device=dev)
    lo = torch.randint(0, 1 << C, (n,), generator=g, device=dev)
    kk = torch.randint(0, C + 3, (n,), generator=g, device=dev)
    yield "seeded", ((hi & lo).to(torch.int32), kk.to(torch.int32), C,
                     graph.lane_seed(7, 2, 0), n)
    cfg, sc, params, state = flagship.build(dev, horizon=400)[:4]
    step = gs.make_gossip_step(cfg, sc, device=dev)
    state = gs.gossip_run(params, state, 40, step, device=dev)
    calls = cs.capture_calls(lambda: step(params, state), ksel,
                             "select_k_bits")
    for i, (args, kwargs) in enumerate(calls):
        yield f"flagship_tick41_call{i}", args


def fused_windows(cs, dev):
    """(label, consts, operands) of the fused windows timed, at the
    resident shapes as chip_smoke.py checks them: clean from tick 12,
    exact-k from tick 12, faulted with cold restart from tick 24, with
    telemetry (L = 16) clean from tick 1 and faulted with cold restart
    from tick 24."""
    from . import resident
    from .models import telemetry as tl
    from .ops import graph
    from .ops.kernels import fused as kfused

    Tw = resident.WINDOW
    sched = churn.schedule(resident.N_PEERS, np.random.default_rng(5), 0,
                           cs.RES_WARMUP, cold_restart=True)
    for label, kw, tick, tel in (
            ("clean", {}, 12, False), ("exact_k", dict(exact_k=True), 12,
                                       False),
            ("faulted_cold", dict(fault_schedule=sched), 24, False),
            ("telemetry", {}, 1, True),
            ("telemetry_faulted_cold", dict(fault_schedule=sched), 24,
             True)):
        cfg, params, state, *_ = resident.build(dev, horizon=cs.RES_WARMUP,
                                                **kw)
        k = kfused.fused_consts(cfg, telemetry=tel,
                                tel_lat_buckets=16 if tel else 0)
        step = gs.make_gossip_step(cfg, None, device=dev)
        st = gs.gossip_run(params, state, tick, step, device=dev)
        tk = torch.arange(st.tick, st.tick + Tw, dtype=torch.int32,
                          device=dev)
        all_c = (1 << cfg.n_candidates) - 1
        fops = dict(
            tick0=st.tick, seeds=kfused.window_seeds(st.tick, Tw, st.salt),
            due=graph.pack_bits(params.publish_tick[None, :] == tk[:, None]),
            sub_all=torch.where(params.subscribed, all_c, 0).to(torch.int32),
            cand_sub=params.cand_sub_bits, origin=params.origin_words,
            have=st.have, recent=st.recent, mesh=st.mesh, fanout=st.fanout,
            last_pub=st.last_pub, backoff=st.backoff, tgt=st.gates[0],
            bog=st.gates[1])
        if params.faults is not None:
            fops.update(gs.window_fault_rows(cfg, params.faults, st.tick, Tw))
        if tel:
            fops.update(lat_masks=tl.latency_bucket_masks(
                params.publish_tick, tk[:, None], 16, st.have.shape[0]),
                dlv=params.deliver_words)
        yield label, k, fops
        del params, state, step, st, fops


def against_parent(cs, parent: Path, out_dir: Path, reps: int,
                   only=None) -> dict:
    """Every kernel of the parent's csrc against this tree's, in turns,
    or those of the labels in ``only`` (module docstring)."""
    from .ops.kernels import fused as kfused
    from .ops.kernels import select as ksel

    dev = torch.device("cuda")
    libs = build_versions(cs, parent, out_dir, only)
    out = {"card": flagship.card(), "receive_ms": {}, "select_ms": {},
           "fused_ms": {}}
    for label, k, ops in (receive_ticks(cs, dev, only)
                          if set(krecv.SOURCES) & set(libs) else ()):
        name = krecv.library(k)
        if name not in libs:
            continue
        want = krecv.receive_update_plain(k, **ops)
        each_version(libs, name, lambda: cs.check_identical(
            f"{label} receive", krecv.receive_update(k, **ops), want))
        out["receive_ms"][label] = in_turns(
            libs, name, lambda: krecv.receive_update(k, **ops), reps,
            lambda fn: cs.device_ms(fn, 50))
        print(f"receive {label}: {out['receive_ms'][label]}", flush=True)
        del want, ops
    if "select" in libs and (only is None or "select" in only):
        for label, args in select_operands(cs, dev):
            want = ksel.select_k_bits_plain(*args)
            each_version(libs, "select", lambda: cs.check_identical(
                f"select {label}", (ksel.select_k_bits(*args),), (want,)))
            out["select_ms"][label] = in_turns(
                libs, "select", lambda: ksel.select_k_bits(*args), reps,
                lambda fn: cs.device_ms(fn, 200))
            print(f"select {label}: {out['select_ms'][label]}", flush=True)
    if "fused" in libs and (only is None or "fused" in only):
        for label, k, fops in fused_windows(cs, dev):
            want = kfused.fused_gossip_update_plain(k, **fops)
            each_version(libs, "fused", lambda: cs.check_identical(
                f"fused {label}", kfused.fused_gossip_update(k, **fops),
                want))
            # a cooperative launch: CUDA events over back-to-back launches
            out["fused_ms"][label] = in_turns(
                libs, "fused", lambda: kfused.fused_gossip_update(k, **fops),
                reps, lambda fn: cs.eager_ms(fn, 20))
            print(f"fused {label}: {out['fused_ms'][label]}", flush=True)
            del want
    return out


def fused_variants(cs, sources: list[str], out_dir: Path,
                   reps: int) -> dict:
    """Variants of csrc/fused.cu timed in turns on phase 7's two carries
    (module docstring)."""
    import time

    from . import resident
    from .ops import graph
    from .ops.kernels import fused as kfused

    procs = {}
    for i, src in enumerate(sources):
        lib = out_dir / f"libfused{i}.so"
        procs[src] = (lib, time.perf_counter(), subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, build_s = {}, {}
    for src, (lib, t0, proc) in procs.items():
        log, _ = proc.communicate()
        build_s[src] = round(time.perf_counter() - t0, 1)
        if proc.returncode:
            raise SystemExit(f"nvcc {src} failed:\n{log}")
        for line in cs.ptxas_summary(log):
            if "<16,1," in line:
                print(f"ptxas[{src}]: {line}")
        libs[src] = ctypes.CDLL(str(lib))
    print(f"build seconds: {build_s}", flush=True)
    dev = torch.device("cuda")
    cfg, params, state, *_ = resident.build(dev)
    step = gs.make_gossip_step(cfg, None, device=dev)
    k = kfused.fused_consts(cfg)
    Tw = resident.WINDOW
    all_c = (1 << cfg.n_candidates) - 1
    out = {"card": flagship.card(), "build_s": build_s, "ms": {},
           "identical": {}}
    for label, st in (("formation", state),
                      ("warm12", gs.gossip_run(params, state, 12, step,
                                               device=dev))):
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
        want = kfused.fused_gossip_update_plain(k, **fops)
        out["identical"][label] = {}
        for src, lib in libs.items():
            _build._LIBS["fused"] = lib
            got = kfused.fused_gossip_update(k, **fops)
            out["identical"][label][src] = all(
                torch.equal(g, w) for g, w in zip(got, want))
        out["ms"][label] = in_turns({"fused": libs}, "fused",
                                    lambda: kfused.fused_gossip_update(
                                        k, **fops),
                                    reps, lambda fn: cs.eager_ms(fn, 20))
        print(f"fused {label}: {out['ms'][label]}", flush=True)
        del want, got, fops
    return out


def delayed_tick_ms(cs, dev, reps: int) -> dict:
    """The pipelined ``base4j2`` point at 1M peers: this tree's delay
    variant on tick 40 of the armed sim against its plain version, then
    timed in turns with the delay-free twin on tick 40 of the same sim
    without delays."""
    from . import pipelined

    point = pipelined.POINTS["base4j2"]
    sim = pipelined.arm(pipelined.build(dev, pipelined.FULL_WIDTH), point)
    cfg, sc, params, state = sim
    step = gs.make_gossip_step(cfg, sc, device=dev)
    k_d = krecv.receive_consts(cfg, sc, knobs=True, delays=True)
    ops_d = cs.capture_receive(
        lambda: gs.gossip_run(params, state, 41, step, device=dev), krecv)
    cs.check_identical("base4j2 delays", krecv.receive_update(k_d, **ops_d),
                       krecv.receive_update_plain(k_d, **ops_d))
    params_t = dataclasses.replace(params, delays=None)
    state_t = dataclasses.replace(state, pay_line=None, ctrl_line=None)
    k_t = krecv.receive_consts(cfg, sc, knobs=True)
    ops_t = cs.capture_receive(
        lambda: gs.gossip_run(params_t, state_t, 41, step, device=dev), krecv)
    out = {"delays": [], "twin": []}
    for rep in range(reps):
        order = ["delays", "twin"] if rep % 2 == 0 else ["twin", "delays"]
        for label in order:
            k_, o_ = (k_d, ops_d) if label == "delays" else (k_t, ops_t)
            out[label].append(cs.device_ms(
                lambda: krecv.receive_update(k_, **o_), 50))
    return out


if __name__ == "__main__":
    main()
