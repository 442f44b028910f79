"""Compare the scored flagship main path of two checkouts of the port on
one GPU, in one call.

    python -m go_libp2p_pubsub_tpu_torch.ab --trees OLD NEW [--pairs 3]

Each ``--trees`` entry is a directory holding a ``go_libp2p_pubsub_tpu_torch``
package (a checkout, or ``git archive`` of one unpacked).  The runs
alternate OLD NEW NEW OLD OLD NEW ... (``--pairs`` of each), one process
per run so each imports its own tree and builds its own kernels.  A run
is what ``chip_smoke.py`` times on the main path: the 1M-peer flagship,
``--warmup`` heartbeats, then ``--ticks`` timed by wall clock ending in
``torch.cuda.synchronize()``, gated on the mean mesh degree.  Prints
one JSON line per run and, last, the card and every run's heartbeats/s
by tree.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def time_tree(tree: str, warmup: int, ticks: int) -> dict:
    """One timed run of the flagship of the package under ``tree`` (in a
    process that has not imported the package yet: ``main`` runs this
    file by its path, whose directory it replaces with ``tree``)."""
    root = Path(tree).resolve()
    sys.path[0] = str(root)
    import torch
    from go_libp2p_pubsub_tpu_torch import flagship
    from go_libp2p_pubsub_tpu_torch.models import gossipsub as pg

    if not Path(flagship.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {flagship.__file__}, not from {root}")

    dev = torch.device("cuda")
    cfg, sc, params, state, _ = flagship.build(dev, horizon=warmup + ticks)
    step = pg.make_gossip_step(cfg, sc, device=dev)
    state = pg.gossip_run(params, state, warmup, step, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = pg.gossip_run(params, state, ticks, step, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    deg = pg.mesh_degrees(state)[params.subscribed].to(
        torch.float64).mean().item()
    if not deg >= cfg.d_lo or state.tick != warmup + ticks:
        raise SystemExit(f"{tree}: mesh degree {deg}, tick {state.tick}")
    return {"tree": tree, "heartbeats_per_s": ticks / dt, "ms_per_tick": dt * 1e3 / ticks,
            "mean_mesh_degree": deg}


def order(trees: list[str], pairs: int) -> list[str]:
    """OLD NEW NEW OLD OLD NEW ...: ``pairs`` runs of each tree."""
    old, new = trees
    seq = []
    for i in range(pairs):
        seq += [old, new] if i % 2 == 0 else [new, old]
    return seq


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--one", metavar="TREE",
                    help="time one run of TREE in this process")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_tree(args.one, args.warmup, args.ticks)))
        return
    runs = []
    for tree in order(args.trees, args.pairs):
        out = subprocess.run(
            [sys.executable, __file__, "--one", tree, "--warmup",
             str(args.warmup), "--ticks", str(args.ticks)],
            capture_output=True, text=True, timeout=600, check=True)
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "heartbeats_per_s": {
        tree: [r["heartbeats_per_s"] for r in runs if r["tree"] == tree]
        for tree in args.trees}}))


if __name__ == "__main__":
    main()
