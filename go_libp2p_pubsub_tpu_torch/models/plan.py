"""Named refusals: every option of ``make_gossip_sim`` /
``make_gossip_step`` / ``make_fused_window`` that the port does not run
raises one of these, never a silent fallback.

The port runs the scored GossipSub v1.1 heartbeat (with its attack
formations: IHAVE broken-promise spam, the IWANT flood, graft flood,
promise breakers, eclipse) and the unscored v1.0 heartbeat on its
receive kernel (unpadded, pipelined gates, Bernoulli gossip targets, one
topic per peer), and the unscored heartbeat T ticks per launch on the
fused-window kernel.  Each refusal has a stable name
(``SliceRefusal.name``) and its own message; tests match on the name.
"""

from __future__ import annotations

#: the longest fused window: its lane seeds ride the launch's argument
#: block (4 u32 per tick)
MAX_WINDOW = 64

REFUSALS: dict[str, str] = {
    "paired": "paired-topic overlays (paired_topics=True) are not "
              "ported yet",
    "faults": "fault schedules (churn, link loss, partitions) are not "
              "ported yet",
    "telemetry": "telemetry frames are not ported yet",
    "knobs": "traced parameter knobs (score_knobs / sim_knobs) are not "
             "ported yet",
    "delays": "event-driven delays (DelayConfig and its delay lines) are "
              "not ported yet",
    "rpc_probe": "the per-RPC probe snapshot is not ported yet",
    "invariants": "the in-step invariant checker is not ported yet",
    "byzantine": "byzantine payload mutation (byzantine_mutation, "
                 "byzantine) is not ported: the JAX package's kernel path "
                 "refuses it too (it needs per-edge receive loops)",
    "px": "PX candidate rotation (px_candidates) is not ported yet",
    "direct_peers": "direct peers (direct_edges) are not ported yet",
    "flood_publish": "flood publishing (flood_publish=True) is not "
                     "ported yet",
    "flood_proto": "mixed-protocol overlays (flood_proto) are not "
                   "ported yet",
    "exact_k": "exact-k gossip sampling (binomial_gossip_sampling=False) "
               "is not ported yet",
    "shared_ip": "shared peer addresses (the same-IP gater grouping) are "
                 "not ported yet",
    "track_p3": "P3/P3b mesh-delivery bookkeeping (track_p3, "
                "force_split) is not ported yet",
    "shard_mesh": "multi-device sharding (shard_mesh) is not ported yet",
    "pad_to_block": "the port runs unpadded: pad_to_block exists only "
                    "for the TPU kernel's tile alignment",
    "pipeline_gates": "the port always carries pipelined gates "
                      "(pipeline_gates=False is not ported)",
    "wide_candidates": "the receive kernel takes at most 16 candidates",
    "kernel_shape": "the receive kernel is built for C in {8, 16} "
                    "candidates and W in {1, 2} message words (M <= 64)",
    "no_messages": "a sim without messages (W = 0) has no payload "
                   "stream for the receive kernel",
    "counter_dtype": "counter_dtype must be 'bfloat16' or 'float32'",
    "reweighted_static": "the baked static P5+P6 score term was built "
                         "under other weights than this score config",
    "fused_window": f"the fused window runs 1 to {MAX_WINDOW} ticks per "
                    "launch",
    "fused_horizon": "the run's horizon is not a whole number of fused "
                     "windows",
    "fused_scored": "the fused window runs the unscored (v1.0) step only: "
                    "scored sims step per tick",
    "fused_grid": "the fused kernel cannot keep one block resident on "
                  "the device, so its cooperative launch cannot run",
}


class SliceRefusal(NotImplementedError):
    """An option outside the port, refused by name."""

    def __init__(self, name: str):
        self.name = name
        super().__init__(f"{name}: {REFUSALS[name]}")


def refuse(name: str):
    raise SliceRefusal(name)


def check_kernel_config(cfg, sc) -> None:
    """Refuse a static config the step and receive kernel do not run
    (``sc`` None is the unscored v1.0 step)."""
    if cfg.paired_topics:
        refuse("paired")
    if not cfg.binomial_gossip_sampling:
        refuse("exact_k")
    if cfg.n_candidates > 16:
        refuse("wide_candidates")
    if sc is None:
        return
    if sc.track_p3:
        refuse("track_p3")
    if sc.flood_publish:
        refuse("flood_publish")
    if sc.byzantine_mutation:
        refuse("byzantine")
    if sc.counter_dtype not in ("bfloat16", "float32"):
        refuse("counter_dtype")


def check_step_options(*, force_split, pipeline_gates, shard_mesh,
                       telemetry, rpc_probe, invariants) -> None:
    if force_split:
        refuse("track_p3")
    if not pipeline_gates:
        refuse("pipeline_gates")
    if shard_mesh is not None:
        refuse("shard_mesh")
    if telemetry is not None:
        refuse("telemetry")
    if rpc_probe:
        refuse("rpc_probe")
    if invariants is not None:
        refuse("invariants")


def check_sim_options(*, flood_proto, px_candidates, direct_edges,
                      pad_to_block, fault_schedule, byzantine, score_knobs,
                      sim_knobs, delays, delays_split, delays_counters,
                      delays_probe) -> None:
    if pad_to_block is not None:
        refuse("pad_to_block")
    if flood_proto is not None:
        refuse("flood_proto")
    if byzantine is not None:
        refuse("byzantine")
    if px_candidates is not None:
        refuse("px")
    if direct_edges is not None:
        refuse("direct_peers")
    if fault_schedule is not None:
        refuse("faults")
    if score_knobs is not None or sim_knobs is not None:
        refuse("knobs")
    if (delays is not None or delays_split or delays_counters
            or delays_probe):
        refuse("delays")


def check_fused_window(cfg, sc, ticks: int, *, telemetry=None,
                       shard_mesh=None) -> None:
    """Refuse a fused window the port does not run (static config).

    Faults, delays, knobs, PX and direct peers are refused by the same
    names when the sim is built (``check_sim_options``), so no window
    ever sees them; the window refuses the rest here."""
    if not 1 <= int(ticks) <= MAX_WINDOW:
        refuse("fused_window")
    check_kernel_config(cfg, sc)
    if sc is not None:
        refuse("fused_scored")
    if telemetry is not None:
        refuse("telemetry")
    if shard_mesh is not None:
        refuse("shard_mesh")


def check_fused_horizon(n_ticks: int, ticks: int) -> int:
    """The number of windows in ``n_ticks``, or the named refusal."""
    if n_ticks < 0 or n_ticks % ticks:
        refuse("fused_horizon")
    return n_ticks // ticks
