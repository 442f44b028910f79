"""Named refusals: every option of ``make_gossip_sim`` /
``make_gossip_step`` / ``make_fused_window`` that the port does not run
raises one of these, never a silent fallback.

The port runs the scored GossipSub v1.1 heartbeat (with its attack
formations: IHAVE broken-promise spam, the IWANT flood, graft flood,
promise breakers, eclipse) and the unscored v1.0 heartbeat on its
receive kernel (unpadded, pipelined gates, one topic per peer or, with
``paired_topics``, two), with the router surface: flood publishing,
direct peers, Bernoulli or exact-k gossip targets, PX candidate rotation
and the shared-IP gater; and the unscored heartbeat T ticks per launch
on the fused-window kernel (Bernoulli or exact-k targets; one topic per
peer, no PX, no direct peers).  Each
refusal has a stable name (``SliceRefusal.name``) and its own message;
tests match on the name.
"""

from __future__ import annotations

#: the longest fused window: its lane seeds ride the launch's argument
#: block (4 u32 per tick)
MAX_WINDOW = 64

REFUSALS: dict[str, str] = {
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
    "flood_proto": "mixed-protocol overlays (flood_proto) are not "
                   "ported yet",
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
    "fused_px": "the fused window does not run PX candidate rotation "
                "(a state with an active set): such sims step per tick",
    "fused_direct": "the fused window does not run direct peers "
                    "(cand_direct): such sims step per tick",
    "fused_paired": "the fused window does not run paired-topic overlays "
                    "(paired_topics=True): such sims step per tick (the "
                    "slot-B mesh/backoff carry doubles the resident "
                    "working set)",
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
    if cfg.n_candidates > 16:
        refuse("wide_candidates")
    if sc is None:
        return
    if sc.track_p3:
        refuse("track_p3")
    if sc.byzantine_mutation:
        refuse("byzantine")
    if sc.counter_dtype not in ("bfloat16", "float32"):
        refuse("counter_dtype")


#: the reference's message for a paired step off its combined path
MSG_PAIRED_COMBINED = ("paired_topics needs the combined path "
                       "(C<=16, no track_p3/force_split)")


def check_paired_step(cfg, sc, force_split: bool) -> None:
    """A paired step runs on the combined (kernel) path only: the
    reference's ``ValueError``, raised before any named refusal."""
    if cfg.paired_topics and (cfg.n_candidates > 16 or force_split
                              or (sc is not None and sc.track_p3)):
        raise ValueError(MSG_PAIRED_COMBINED)


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


def check_sim_options(*, flood_proto, pad_to_block, fault_schedule,
                      byzantine, score_knobs, sim_knobs, delays,
                      delays_split, delays_counters, delays_probe) -> None:
    if pad_to_block is not None:
        refuse("pad_to_block")
    if flood_proto is not None:
        refuse("flood_proto")
    if byzantine is not None:
        refuse("byzantine")
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

    Faults, delays and knobs are refused by the same names when the sim
    is built (``check_sim_options``), so no window ever sees them; the
    window refuses the rest here, and PX and direct peers when it is
    handed their params or state (``check_fused_operands``)."""
    if not 1 <= int(ticks) <= MAX_WINDOW:
        refuse("fused_window")
    check_kernel_config(cfg, sc)
    if sc is not None:
        refuse("fused_scored")
    if cfg.paired_topics:
        refuse("fused_paired")
    if telemetry is not None:
        refuse("telemetry")
    if shard_mesh is not None:
        refuse("shard_mesh")


def check_fused_operands(params, state) -> None:
    """Refuse a sim the fused window does not run: one with an active
    set (PX) or with direct peers."""
    if state.active is not None:
        refuse("fused_px")
    if params.cand_direct is not None:
        refuse("fused_direct")


def check_fused_horizon(n_ticks: int, ticks: int) -> int:
    """The number of windows in ``n_ticks``, or the named refusal."""
    if n_ticks < 0 or n_ticks % ticks:
        refuse("fused_horizon")
    return n_ticks // ticks
