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
peer, no PX, no direct peers).  Both run under fault schedules (churn,
link loss, partitions, cold restart) and with telemetry frames (the
per-tick step, faulted or not, on every receive variant; the fused
window with its per-tick frames).  Traced knobs (``score_knobs`` /
``sim_knobs``, ``models/knobs.py``, the fault knob ``drop_prob`` too)
run on the per-tick step, on every receive variant, with or without
faults and telemetry; a knob-carrying sim is refused by the fused window
(``fused_knobs``), as the reference refuses it.  Event-driven delays
(``delays``, ``models/delays.py``, the delay knobs too) run on the
per-tick step, on the flagship, attack, full and unscored receive
variants, with or without knobs, faults and telemetry; the fused window
refuses a delay-armed sim (``fused_delays``, with the reference's message
and its byte count of the lines), the split path's delay line is refused
as ``delays_split`` and the delayed probe line as ``rpc_probe``.  The
invariant checker (``invariants``, ``models/invariants.py``) runs on the
per-tick step, every family, with all of these; the fused window takes
no checker, as in the reference, and carries an armed state's two
scalars through unchanged.  What the receive kernel refuses in the
reference (byzantine payload mutation, P3/P3b with ``force_split``, 17 to
32 candidates, a SimKnobs point on an IWANT-flood config) runs on the
per-edge receive loops (``models/_receive_loops.py``): ``receive_path``
is the one place the route is chosen, by the reference's own ladder;
the loops take no paired topics, telemetry or delays yet
(``loops_paired``, ``loops_telemetry``, ``loops_delays``).  The
mesh-less simulators (``models/floodsub.py``, ``models/randomsub.py``)
refuse cold-restart schedules when the sim is built, by the names
``flood.cold-restart`` and ``randomsub.cold-restart``
(``MeshlessRefusal``, a ``ValueError`` with the reference's message).  Each
refusal has a stable name (``SliceRefusal.name``) and its own message;
tests match on the name.  The reference's own errors are raised with its
messages (``MSG_PAIRED_COMBINED``, ``MSG_KERNEL_KNOB_IWANT_SPAM``,
``MSG_KERNEL_DELAY_IWANT_SPAM``, ``MSG_DELAYS_PAIRED``,
``MSG_DELAYS_NEED_LINES``, ``MSG_DELAYS_NEED_COUNTER_LINES``).
"""

from __future__ import annotations

#: the longest fused window: its lane seeds ride the launch's argument
#: block (4 u32 per tick)
MAX_WINDOW = 64

REFUSALS: dict[str, str] = {
    "delays_split": "the split path's gossip-class delay line "
                    "(delays_split=True) is not ported: the receive loops "
                    "take no delays (loops_delays)",
    "rpc_probe": "the per-RPC probe snapshot is not ported yet",
    "flood_proto": "mixed-protocol overlays (flood_proto) are not "
                   "ported yet",
    "shard_mesh": "multi-device sharding (shard_mesh) is not ported yet",
    "pad_to_block": "the port runs unpadded: pad_to_block exists only "
                    "for the TPU kernel's tile alignment",
    "pipeline_gates": "the port always carries pipelined gates "
                      "(pipeline_gates=False is not ported)",
    "kernel_shape": "the receive kernel is built for C in {8, 16} "
                    "candidates and W in {1, 2} message words (M <= 64)",
    "loops_paired": "paired topics run on the receive kernel only: a "
                    "paired sim the kernel refuses (byzantine mutation, "
                    "a SimKnobs point on an IWANT-flood config) would need "
                    "the per-edge receive loops, which take one topic a "
                    "peer",
    "loops_telemetry": "the per-edge receive loops (byzantine, P3/P3b, "
                       "force_split, C > 16, a SimKnobs point on an "
                       "IWANT-flood config) keep no telemetry tally yet",
    "loops_delays": "the per-edge receive loops (byzantine, P3/P3b, "
                    "force_split, C > 16, a SimKnobs point on an "
                    "IWANT-flood config) take no delay lines yet",
    "no_messages": "a sim without messages (W = 0) has no payload "
                   "stream for the receive kernel",
    "counter_dtype": "counter_dtype must be 'bfloat16' or 'float32'",
    "reweighted_static": "the baked static P5+P6 score term was built "
                         "under other weights than this score config",
    "fused_window": f"the fused window runs 1 to {MAX_WINDOW} ticks per "
                    "launch",
    "fused_horizon": "the run's horizon is not a whole number of fused "
                     "windows",
    "fused_loops": "the fused window runs what the receive kernel runs: "
                   "byzantine mutation, P3/P3b and more than 16 "
                   "candidates step per tick on the receive loops",
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
    "fused_knobs": "the fused window does not run knob-carrying sims "
                   "(sim_knobs): such sims step per tick (the degree-family "
                   "knobs are consumed in the step's prologue, which the "
                   "fused window elides)",
    # the message goes on with the lines' byte count (msg_fused_delays)
    "fused_delays": "kernel_ticks_fused: delay-armed sims stay per-tick",
    "batched_ticks": "a replica stack moves in lockstep on one host tick: "
                     "stacked states must share their tick (the "
                     "reference carries a tick per replica)",
    "batched_paired": "paired-topic sims are not batched yet",
    "batched_fused": "the fused window takes one sim: a replica stack "
                     "steps per tick (the reference has no batched fused "
                     "runner)",
    "batched_partitions": "stacked fault schedules must share their "
                          "partition windows: the port decides a "
                          "window's activity on the host tick",
    "batched_surface": "the router surface (PX candidate rotation, direct "
                       "peers, flood publishing, exact-k gossip targets, "
                       "shared addresses) is not batched yet",
}


class SliceRefusal(NotImplementedError):
    """An option outside the port, refused by name."""

    def __init__(self, name: str, message: str | None = None):
        self.name = name
        super().__init__(f"{name}: {message or REFUSALS[name]}")


def refuse(name: str, message: str | None = None):
    """Raise the named refusal (``message``: a longer form of its
    REFUSALS text, which it starts with)."""
    raise SliceRefusal(name, message)


def check_kernel_config(cfg, sc) -> None:
    """Refuse a static score config the step does not run (``sc`` None
    is the unscored v1.0 step)."""
    if sc is not None and sc.counter_dtype not in ("bfloat16", "float32"):
        refuse("counter_dtype")


#: the three routes of the per-tick receive half
KERNEL, COMBINED, SPLIT = "kernel", "combined", "split"


def receive_path(cfg, sc, params, *, force_split: bool = False) -> str:
    """The route of one step's receive half: ``"kernel"`` (B1),
    ``"combined"`` or ``"split"`` (the per-edge receive loops), by the
    reference's ladder — its kernel planner (``plan_kernel_step``)
    refuses C > 16, P3/P3b (``track_p3``), live byzantine mutation
    (``byzantine_mutation`` with the flag array ``params.cand_byz``) and
    a SimKnobs point on an IWANT-flood config, and ``force_split`` pins
    the split loops; off the kernel the combined loop runs where C <= 16
    without P3/P3b or ``force_split`` (its ``combined`` test), else the
    split loops.  Plain Python on static config and on which params
    exist: no host sync, and never a kernel's failure."""
    live_byz = (sc is not None and sc.byzantine_mutation
                and params.cand_byz is not None)
    knob_flood = (sc is not None and sc.sybil_iwant_spam
                  and params.sim_knobs is not None)
    track_p3 = sc is not None and sc.track_p3
    if not (force_split or cfg.n_candidates > 16 or track_p3 or live_byz
            or knob_flood):
        return KERNEL
    if cfg.n_candidates <= 16 and not track_p3 and not force_split:
        return COMBINED
    return SPLIT


def check_batched(cfg, sc, params, state) -> None:
    """Refuse what a replica stack does not run yet, by name (a stacked
    sim's route is the single sim's: ``receive_path``; delays and
    telemetry run in a stack)."""
    if cfg.paired_topics:
        refuse("batched_paired")
    if (not cfg.binomial_gossip_sampling or params.cand_direct is not None
            or params.cand_same_ip is not None or state.active is not None
            or (sc is not None and sc.flood_publish)):
        refuse("batched_surface")


def check_loops(*, paired: bool, telemetry, delays) -> None:
    """Refuse what the receive loops do not run yet, by name."""
    if paired:
        refuse("loops_paired")
    if telemetry is not None:
        refuse("loops_telemetry")
    if delays is not None:
        refuse("loops_delays")


#: the reference's message for a paired step off its combined path
MSG_PAIRED_COMBINED = ("paired_topics needs the combined path "
                       "(C<=16, no track_p3/force_split)")

#: the reference's message for a SimKnobs point on an IWANT-flood config:
#: its kernel step bakes gossip_retransmission into the flood's serve
#: budget (the legacy score_knobs surface carries no such knob and runs)
MSG_KERNEL_KNOB_IWANT_SPAM = (
    "sim_knobs: gossip_retransmission stays XLA-only on the pallas "
    "step (the in-kernel IWANT serve budget bakes it) — run "
    "iwant-spam knob sweeps on the XLA path, or drop sybil_iwant_spam "
    "from the config")


#: the reference's message for delays on an IWANT-flood config: its kernel
#: step's flood budget reads the partner advert views the delayed kernel
#: does not stream
MSG_KERNEL_DELAY_IWANT_SPAM = (
    "delays: sybil_iwant_spam stays XLA-only on the pallas step under "
    "delays (the in-kernel flood budget needs the partner advert "
    "views the delayed kernel does not stream) — run iwant-spam delay "
    "sweeps on the XLA path")

#: the reference's delay messages (its step closure and sim build)
MSG_DELAYS_PAIRED = (
    "delays: paired-topic mode is not delay-supported (per-slot delay "
    "lines and delayed cross-slot control routing are not modeled); "
    "run delays on a single-topic-per-peer config")

MSG_DELAYS_NEED_LINES = (
    "delay-armed params need delay-line state: build (params, state) "
    "together through make_gossip_sim(..., delays=DelayConfig(...))")

MSG_DELAYS_NEED_COUNTER_LINES = (
    "delay-armed telemetry counters need the advert + gossip observer "
    "delay lines: build the sim with make_gossip_sim(..., "
    "delays=DelayConfig(...), delays_counters=True)")


# -- the mesh-less simulators (refused when the sim is built) ----------------

MSG_FLOOD_COLD_RESTART = (
    "cold_restart: the floodsub simulator refuses cold-restart "
    "schedules (a cold rejoiner has no IHAVE/IWANT repair path to "
    "recover through) — run it on the gossipsub simulator")

MSG_RANDOMSUB_COLD_RESTART = (
    "cold_restart: the randomsub simulator refuses cold-restart "
    "schedules (a cold rejoiner has no IHAVE/IWANT repair path to "
    "recover through) — run it on the gossipsub simulator")

#: the mesh-less simulators' refusals by name, with the reference's
#: messages (its planner's ``plan_circulant`` names)
MESHLESS_REFUSALS: dict[str, str] = {
    "flood.cold-restart": MSG_FLOOD_COLD_RESTART,
    "randomsub.cold-restart": MSG_RANDOMSUB_COLD_RESTART,
}


class MeshlessRefusal(ValueError):
    """A mesh-less sim build the reference refuses: a ``ValueError``
    whose text is the reference's message, with a stable ``name``."""

    def __init__(self, name: str):
        self.name = name
        super().__init__(MESHLESS_REFUSALS[name])


def check_meshless_faults(sim: str, schedule) -> None:
    """``sim`` ("flood" or "randomsub") refuses a cold-restart schedule
    (no gossip repair would bring a cold rejoiner back)."""
    if schedule is not None and schedule.cold_restart:
        raise MeshlessRefusal(f"{sim}.cold-restart")


def msg_fused_delays(extra_bytes: int) -> str:
    """The reference's fused-window refusal of a delay-armed sim, with the
    byte count of its delay lines."""
    return (REFUSALS["fused_delays"] + " — the K-slot "
            f"delay lines add {int(extra_bytes)} bytes of resident "
            "carry and the dequeue runs in the XLA prologue between "
            "kernel ticks")


def check_paired_step(cfg, sc, force_split: bool) -> None:
    """A paired step runs on the combined (kernel) path only: the
    reference's ``ValueError``, raised before any named refusal."""
    if cfg.paired_topics and (cfg.n_candidates > 16 or force_split
                              or (sc is not None and sc.track_p3)):
        raise ValueError(MSG_PAIRED_COMBINED)


def check_step_options(*, pipeline_gates, shard_mesh, rpc_probe) -> None:
    if not pipeline_gates:
        refuse("pipeline_gates")
    if shard_mesh is not None:
        refuse("shard_mesh")
    if rpc_probe:
        refuse("rpc_probe")


def check_sim_options(*, flood_proto, pad_to_block, delays, delays_split,
                      delays_counters, delays_probe) -> None:
    if pad_to_block is not None:
        refuse("pad_to_block")
    if flood_proto is not None:
        refuse("flood_proto")
    # without a DelayConfig these raise the reference's ValueErrors where
    # the sim is built
    if delays is not None and delays_split:
        refuse("delays_split")
    if delays is not None and delays_probe:
        refuse("rpc_probe")


def check_fused_window(cfg, sc, ticks: int, *, shard_mesh=None) -> None:
    """Refuse a fused window the port does not run (static config).

    A faulted sim runs (its per-tick fault rows ride the launch), and so
    does a window with telemetry (its per-tick rows ride the launch); the
    window refuses the rest here (a byzantine config by its static
    toggle: the window is built before its flag arrays are seen), and
    delays, knobs, PX and direct peers when it is handed their params or
    state (``check_fused_operands``)."""
    if not 1 <= int(ticks) <= MAX_WINDOW:
        refuse("fused_window")
    check_kernel_config(cfg, sc)
    if cfg.n_candidates > 16 or (sc is not None and (
            sc.track_p3 or sc.byzantine_mutation)):
        # the reference's fused planner refuses what its kernel planner
        # refuses, before the scored refusal
        refuse("fused_loops")
    if sc is not None:
        refuse("fused_scored")
    if cfg.paired_topics:
        refuse("fused_paired")
    if shard_mesh is not None:
        refuse("shard_mesh")


def check_fused_operands(params, state) -> None:
    """Refuse a sim the fused window does not run: a delay-armed one
    (the reference's message, with its lines' byte count), one carrying
    SimKnobs, one with an active set (PX) or with direct peers, a
    replica stack (its salt a [B] tensor)."""
    if not isinstance(state.salt, int):
        refuse("batched_fused")
    if params.delays is not None:
        extra = sum(line.numel() * line.element_size() for line in (
            state.pay_line, state.ctrl_line, state.gsp_line,
            state.adv_line) if line is not None)
        refuse("fused_delays", msg_fused_delays(extra))
    if params.sim_knobs is not None:
        refuse("fused_knobs")
    if state.active is not None:
        refuse("fused_px")
    if params.cand_direct is not None:
        refuse("fused_direct")


def check_fused_horizon(n_ticks: int, ticks: int) -> int:
    """The number of windows in ``n_ticks``, or the named refusal."""
    if n_ticks < 0 or n_ticks % ticks:
        refuse("fused_horizon")
    return n_ticks // ticks
