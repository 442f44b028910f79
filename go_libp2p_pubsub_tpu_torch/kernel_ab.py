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
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the comparison needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    out_dir = _build.BUILD_DIR / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.parent is not None:
        ptxas_against_parent(cs, args.parent, out_dir)
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
