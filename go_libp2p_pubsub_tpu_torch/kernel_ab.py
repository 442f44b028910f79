"""Compare builds of the receive kernel on one GPU, in one process.

    python -m go_libp2p_pubsub_tpu_torch.kernel_ab SRC.cu [SRC.cu ...] [--reps 3]

Each source is a variant of ``csrc/receive.cu`` with the same C interface
(``gossip_receive_update`` and ``struct ReceiveArgs`` of this tree's
wrapper), next to the headers it includes.  Each is built with the
port's nvcc flags (its ptxas summary printed), then the receive
operands of tick 40 of the 1M-peer adversarial, flagship, everything-on
and paired everything-on sims are captured (the everything-on tick only
for the sources that have the full variant, ``receive_kernel_full``, the
paired one only for those with ``receive_kernel_paired``), every build is
checked
bit-identical to the plain version on them, and the builds are timed in
turns (``chip_smoke.device_ms``: CUDA
events over a CUDA-graph replay of 50 launches), ``--reps`` times each.
Prints one JSON line with the card and every build's times.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from . import adversarial, everything, flagship
from .models import gossipsub as gs
from .ops.kernels import _build
from .ops.kernels import receive as krecv

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the comparison needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    out_dir = _build.BUILD_DIR / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for i, src in enumerate(args.sources):
        lib = out_dir / f"libreceive{i}.so"
        r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                            str(lib), src], capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"nvcc {src} failed:\n{r.stdout}{r.stderr}")
        for line in cs.ptxas_summary(r.stdout + r.stderr):
            print(f"ptxas[{src}]: {line}")
        libs[src] = ctypes.CDLL(str(lib))
    dev = torch.device("cuda")
    times = {}
    has = {name: {src for src in libs if name in Path(src).read_text()}
           for name in ("receive_kernel_full", "receive_kernel_paired")}
    for label, build in (
            ("adversarial", adversarial.build), ("flagship", flagship.build),
            ("everything", everything.build),
            ("everything_paired",
             lambda dev, horizon: everything.build(dev, horizon=horizon,
                                                   paired=True))):
        cfg, sc, params, state = build(dev, horizon=400)[:4]
        k = krecv.receive_consts(cfg, sc, px=state.active is not None,
                                 same_ip=params.cand_same_ip is not None)
        if k.full or k.paired:
            need = "receive_kernel_paired" if k.paired else \
                "receive_kernel_full"
            libs = {src: lib for src, lib in libs.items()
                    if src in has[need]}
        step = gs.make_gossip_step(cfg, sc, device=dev)
        ops = cs.capture_receive(
            lambda: gs.gossip_run(params, state, 40, step, device=dev), krecv)
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
    _build._LIBS.pop("receive")
    print(json.dumps({"card": flagship.card(), "receive_ms": times}))


if __name__ == "__main__":
    main()
