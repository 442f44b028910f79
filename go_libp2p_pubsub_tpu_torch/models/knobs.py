"""Config as data: the ``SimKnobs`` scalars of the step.

Counterpart of ``go_libp2p_pubsub_tpu/models/knobs.py``.  Every numeric
``GossipSimConfig`` field whose value does not shape an array can ride
the sim params as a 0-d device tensor instead of a constant baked into
the step, so one built step serves any protocol point:

- the degree family ``d / d_lo / d_hi / d_score / d_out / d_lazy``
  (popcount compares and selection counts: int32),
- ``gossip_factor`` (the emitGossip coverage fraction, float32),
- ``gossip_retransmission`` (the IWANT serve-budget multiplier),
- ``backoff_ticks`` / ``fanout_ttl_ticks`` (tick-count compares),
- the ``ScoreKnobs`` defense sub-tree (``models/gossipsub.py``), folded
  in as ``score``,
- the fault schedule's link-drop rate ``drop_prob``, which overrides the
  compiled ``FaultParams.drop_prob`` leaf (``make_gossip_sim``) and is
  not carried on ``SimKnobs``.

Shape-bearing and mode-selecting fields stay static and are rejected by
name (``KnobStaticFieldError``, ``STATIC_KNOB_REASONS``).  The delay
knobs ``delay_base`` / ``delay_jitter`` override the compiled
``DelayParams`` leaves (``models/delays.py``, ``make_gossip_sim``) and are
not carried on ``SimKnobs`` either.

Knobs at the config's own values give the baked trajectory bit for bit
(integer compares and float32 products are value-equal), with one
exception the reference shares: the P4 weight's product with a
``topic_weight`` other than 1 rounds once in float32 as a knob and once
in double, then float32, when baked.

Validation is host-side and eager: the ordering invariants of
``GossipSimConfig`` apply to every knob point, with the bad field named;
the messages are the reference's.  No value of a knob is ever read back
on the host by the step: every consumer takes the tensors as they are.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = [
    "SIM_KNOB_FIELDS",
    "FAULT_KNOB_FIELDS",
    "DELAY_KNOB_FIELDS",
    "STATIC_KNOB_REASONS",
    "KnobStaticFieldError",
    "SimKnobs",
    "split_knob_overrides",
    "make_sim_knobs",
    "knob_values",
]


#: the liftable GossipSimConfig scalar surface, in SimKnobs field order;
#: integer-valued fields ride as int32 tensors, gossip_factor as float32
SIM_KNOB_FIELDS = (
    "d", "d_lo", "d_hi", "d_score", "d_out", "d_lazy",
    "gossip_factor", "gossip_retransmission",
    "backoff_ticks", "fanout_ttl_ticks",
)

#: fault-schedule knobs: overrides of the compiled FaultParams leaves
#: (make_gossip_sim), not carried on SimKnobs
FAULT_KNOB_FIELDS = ("drop_prob",)

#: delay-line knobs: overrides of the compiled DelayParams base and
#: jitter (make_gossip_sim), not carried on SimKnobs
DELAY_KNOB_FIELDS = ("delay_base", "delay_jitter")

#: shape-bearing or mode-selecting fields, rejected by name with the
#: reason they must stay static (the reference's table, word for word)
STATIC_KNOB_REASONS = {
    "offsets": "the circulant topology: ring offsets are baked into "
               "every edge-transfer roll and the kernel DMA plan",
    "n_topics": "the residue-class layout: membership, deliver masks "
                "and offset moduli are built from it",
    "history_length": "the mcache expiry divisor is baked with the "
                      "ring layout (serve-ledger ceil-div)",
    "history_gossip": "shapes the [Hg, W, N] recent ring",
    "paired_topics": "selects the two-mesh compiled step",
    "px_rotation": "selects the PX rotation epilogue code path",
    "binomial_gossip_sampling": "selects the sampling backend "
                                "(Bernoulli vs rank-compare code path)",
    "max_ihave_length": "a build-time static invariant, never run-time",
    "max_ihave_messages": "a build-time static invariant, never "
                          "run-time",
    "k_slots": "shapes the [K, ...] delay-line state carried through "
               "the scan (models/delays.py) — sweep delay_base / "
               "delay_jitter instead, within the compiled depth",
    "delay_k_slots": "shapes the [K, ...] delay-line state carried "
                     "through the scan (models/delays.py) — sweep "
                     "delay_base / delay_jitter instead, within the "
                     "compiled depth",
    "latency_buckets": "shapes the telemetry latency histogram output",
    "degree_buckets": "shapes the telemetry degree histogram output",
    "score_bucket_edges": "shapes the telemetry score histogram output",
}


class KnobStaticFieldError(ValueError):
    """A shape-bearing (or mode-selecting) config field was passed as a
    knob.  The message names the field and why it must stay static."""


@dataclass(frozen=True)
class SimKnobs:
    """One protocol point's knob values: each leaf a 0-d tensor on the
    sim's device (int32, gossip_factor float32); ``score`` the
    ``ScoreKnobs`` defense sub-tree on a scored sim, else None.  Build
    with ``make_sim_knobs``; fields left unspecified take the config's
    own values."""

    d: torch.Tensor
    d_lo: torch.Tensor
    d_hi: torch.Tensor
    d_score: torch.Tensor
    d_out: torch.Tensor
    d_lazy: torch.Tensor
    gossip_factor: torch.Tensor
    gossip_retransmission: torch.Tensor
    backoff_ticks: torch.Tensor
    fanout_ttl_ticks: torch.Tensor
    score: object = None


def split_knob_overrides(overrides: dict, score_fields=None) -> tuple:
    """Partition a raw knob dict into (protocol, score, fault, delay)
    override dicts, rejecting static fields by name and unknown fields
    with the full valid-knob list.  ``score_fields`` defaults to
    gossipsub's SCORE_KNOB_FIELDS."""
    if score_fields is None:
        from . import gossipsub as _gs
        score_fields = _gs.SCORE_KNOB_FIELDS
    proto, score, fault, delay = {}, {}, {}, {}
    for key, val in dict(overrides).items():
        if key in STATIC_KNOB_REASONS:
            raise KnobStaticFieldError(
                f"sim_knobs: {key!r} is a static (shape-bearing) "
                f"config field and cannot be swept as a knob — "
                f"{STATIC_KNOB_REASONS[key]}.  Recompile with a new "
                "config to change it.")
        if key in SIM_KNOB_FIELDS:
            proto[key] = val
        elif key in score_fields:
            score[key] = val
        elif key in FAULT_KNOB_FIELDS:
            fault[key] = val
        elif key in DELAY_KNOB_FIELDS:
            delay[key] = val
        else:
            all_knobs = (SIM_KNOB_FIELDS + tuple(score_fields)
                         + FAULT_KNOB_FIELDS + DELAY_KNOB_FIELDS)
            raise ValueError(
                f"sim_knobs: unknown knob {key!r} — sweepable knobs "
                f"are {all_knobs}")
    return proto, score, fault, delay


def _validate_point(vals: dict, n_candidates: int,
                    px_candidates: int | None = None) -> None:
    """The GossipSimConfig ordering invariants, applied to a resolved
    knob point (host floats and ints), naming the bad field(s)."""
    d, d_lo, d_hi = vals["d"], vals["d_lo"], vals["d_hi"]
    if not (d_lo <= d <= d_hi):
        raise ValueError(
            f"sim_knobs: need d_lo <= d <= d_hi (got {d_lo}, {d}, "
            f"{d_hi}; gossipsub.go:33-35)")
    if vals["d_score"] > d:
        raise ValueError(
            f"sim_knobs: need d_score <= d (got {vals['d_score']} > "
            f"{d})")
    if vals["d_out"] >= d_lo or vals["d_out"] > d // 2:
        raise ValueError(
            f"sim_knobs: need d_out < d_lo and d_out <= d/2 (got "
            f"d_out={vals['d_out']}; gossipsub.go:266-272)")
    ceiling = n_candidates if px_candidates is None else px_candidates
    if d_hi >= ceiling:
        name = "px_candidates" if px_candidates is not None else "C"
        raise ValueError(
            f"sim_knobs: need d_hi < {name}={ceiling} (got d_hi={d_hi}) "
            "— the selection space cannot satisfy the degree bound")
    if not (1 <= vals["backoff_ticks"] <= 32767):
        raise ValueError(
            f"sim_knobs: backoff_ticks={vals['backoff_ticks']} must "
            "fit int16 remaining-tick storage (1..32767)")
    if vals["gossip_retransmission"] < 1:
        raise ValueError(
            f"sim_knobs: gossip_retransmission="
            f"{vals['gossip_retransmission']} must be >= 1")
    if vals["fanout_ttl_ticks"] < 1:
        raise ValueError(
            f"sim_knobs: fanout_ttl_ticks={vals['fanout_ttl_ticks']} "
            "must be >= 1")
    if vals["d_lazy"] < 0:
        raise ValueError(
            f"sim_knobs: d_lazy={vals['d_lazy']} must be >= 0")
    if not (0.0 <= vals["gossip_factor"] <= 1.0):
        raise ValueError(
            f"sim_knobs: gossip_factor={vals['gossip_factor']} "
            "outside [0, 1]")


def knob_values(cfg, overrides: dict | None = None) -> dict:
    """The resolved host-side values of a knob point over ``cfg``
    (override where given, config default otherwise)."""
    overrides = overrides or {}
    out = {}
    for f in SIM_KNOB_FIELDS:
        v = overrides.get(f, getattr(cfg, f))
        out[f] = float(v) if f == "gossip_factor" else int(v)
    return out


def make_sim_knobs(cfg, score_cfg=None, overrides: dict | None = None,
                   px_candidates: int | None = None, *,
                   device) -> SimKnobs:
    """A validated SimKnobs point over ``cfg`` on ``device``.

    ``overrides`` may mix protocol knobs (SIM_KNOB_FIELDS) and ScoreKnobs
    defense fields (folded into the ``score`` sub-tree; they need
    ``score_cfg``).  Static fields raise KnobStaticFieldError by name;
    every resolved point passes the config's own ordering invariants.
    On a scored sim the score sub-tree is always armed (defaults: the
    score config's values)."""
    from . import gossipsub as _gs

    proto, score_kv, fault, delay = split_knob_overrides(
        overrides or {}, _gs.SCORE_KNOB_FIELDS)
    if fault or delay:
        raise ValueError(
            "sim_knobs: fault/delay knobs (drop_prob, delay_base, "
            "delay_jitter) are applied to the compiled FaultParams/"
            "DelayParams by make_gossip_sim — pass them through its "
            "sim_knobs dict, not make_sim_knobs directly")
    vals = knob_values(cfg, proto)
    _validate_point(vals, cfg.n_candidates, px_candidates)
    if score_kv and score_cfg is None:
        raise ValueError(
            "sim_knobs: score-parameter knobs "
            f"{sorted(score_kv)} require score_cfg")
    score = None
    if score_cfg is not None:
        score = _gs.make_score_knobs(score_cfg, score_kv, "sim_knobs",
                                     device=device)

    def leaf(f):
        dtype = torch.float32 if f == "gossip_factor" else torch.int32
        return torch.tensor(vals[f], dtype=dtype, device=device)

    return SimKnobs(score=score, **{f: leaf(f) for f in SIM_KNOB_FIELDS})
