"""Carry sim params and state across from the JAX package, and back.

The reference's ``GossipParams`` / ``GossipState`` arrive as dicts of
numpy arrays, leaf by leaf (field name -> array, ``None`` for absent
leaves — the v1.1 params, ``scores`` and ``iwant_serves`` of an unscored
sim, the attack formations' params of a sim without them, the same-IP
sibling words, direct edges and PX active set of a sim without them, the
slot-B words, mesh, backoff and time in mesh of an unpaired one —
``scores`` a nested dict, ``gates`` a sequence of words: seven scored,
two unscored, one more paired).
This module never imports the reference; the caller flattens it.

- uint32 leaves are viewed as int32 (same bits);
- bf16 leaves arrive as their raw 16-bit patterns (uint16/int16) or as
  float32, and are cast exactly (a float32 value that is not a bf16
  value raises);
- ``key`` (uint32 [2]) becomes the salt, its last word;
- ``tick`` becomes a host int;
- ``faults`` (a nested dict, or None) becomes ``FaultParams``: its
  ``seed`` a host int, the partition windows ``part_start`` /
  ``part_end`` host tuples, the flags ``cold_restart`` and
  ``directed_drops`` as they are (a ``drop_prob`` knob's override is the
  leaf itself);
- ``score_knobs`` and ``sim_knobs`` (nested dicts of 0-d leaves, or
  None; ``sim_knobs["score"]`` a nested dict or None) become
  ``ScoreKnobs`` and ``SimKnobs`` of 0-d tensors, leaf by leaf;
- ``delays`` (a nested dict, or None) becomes ``DelayParams``: ``base``,
  ``jitter`` and ``seed`` 0-d int32 tensors (the seed's u32 bits),
  ``k_slots`` a host int; the state's delay lines (``pay_line``,
  ``ctrl_line``, ``gsp_line``, ``adv_line``, ``probe_line``) are words
  like the rest;
- the invariant checker's carry: ``inv_viol`` (uint32 []) is a word like
  the rest, ``inv_first`` (int32 []) as it is; both None on an unarmed
  state;
- the mesh-less simulators (``FloodParams`` / ``FloodState``,
  ``RandomSubParams`` / ``RandomSubState``): words as above, the gather
  table ``nbrs`` int32, the fault leaves ``cross_rows`` / ``cross_nk`` /
  ``group`` as they are, a randomsub ``key`` as its salt;
- the byzantine mutators ``byzantine`` (bool [N]) and ``cand_byz`` (a
  word like the rest), and the P3/P3b counters ``mesh_deliveries`` and
  ``mesh_failure_penalty`` (counter dtype, under ``scores``), None where
  the sim has none.

A replica stack (the reference's ``stack_trees`` output, every leaf with
a leading ``[B]``) converts both ways too: ``key`` [B, 2] becomes the
stack's salt tensor (int64 [B] of its last words) and back, ``tick`` [B]
the one host tick (replicas at different ticks raise ``batched_ticks``),
the fault ``seed`` [B] an int64 tensor, the partition windows [B, P]
the one host tuple (replicas that differ raise ``batched_partitions``).

The reverse functions give uint32 words back as uint32 and bf16 leaves
as their raw uint16 patterns, so two trees compare bit for bit;
``frame_to_numpy`` gives a telemetry frame (one tick's, or frames stacked
by a runner) as the same dict of numpy leaves as the reference's frame.
``TelemetryConfig`` needs no conversion: both packages take the same
keyword arguments.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models import plan
from .models.delays import DelayParams
from .models.faults import FaultParams
from .models.floodsub import FloodParams, FloodState
from .models.randomsub import RandomSubParams, RandomSubState
from .models.knobs import SIM_KNOB_FIELDS, SimKnobs
from .models.telemetry import TelemetryFrame
from .models.gossipsub import (
    SCORE_KNOB_FIELDS,
    GossipParams,
    GossipState,
    ScoreKnobs,
    ScoreSimConfig,
    ScoreState,
)
from .ops.kernels.receive import DTYPES

PARAM_WORDS = ("cand_sub_bits", "origin_words", "deliver_words",
               "invalid_words", "cand_victim_bits", "cand_same_ip",
               "cand_direct", "slot_b_words", "cand_byz")
PARAM_TENSORS = ("subscribed", *PARAM_WORDS, "publish_tick",
                 "cand_app_score", "cand_colo_excess", "cand_static_score",
                 "cand_sybil", "sybil", "promise_break", "eclipse_sybil",
                 "eclipse_victim", "byzantine")
STATE_WORDS = ("mesh", "fanout", "have", "recent", "active", "mesh_b",
               "pay_line", "ctrl_line", "gsp_line", "adv_line", "probe_line",
               "inv_viol")
STATE_TENSORS = (*STATE_WORDS, "last_pub", "backoff", "first_tick",
                 "iwant_serves", "backoff_b", "inv_first")
#: the mesh-less simulators' forms of the partition crossings
MESHLESS_FAULT_TENSORS = ("cross_rows", "cross_nk", "group")
#: FloodParams / RandomSubParams and their states' tensors (words: u32)
FLOOD_PARAM_TENSORS = ("nbrs", "nbr_mask", "fwd_words", "deliver_words",
                       "origin_words", "publish_tick")
RANDOMSUB_PARAM_TENSORS = ("subscribed", "cand_subscribed", "send_prob",
                           "origin_words", "deliver_words", "publish_tick")
MESHLESS_WORDS = ("fwd_words", "deliver_words", "origin_words", "have",
                  "fresh", "src_ring", "inv_viol")
FLOOD_STATE_TENSORS = ("have", "first_tick", "inv_viol", "inv_first",
                       "src_ring")
RANDOMSUB_STATE_TENSORS = ("have", "fresh", *FLOOD_STATE_TENSORS[1:])
SCORE_TENSORS = ("time_in_mesh", "first_deliveries", "invalid_deliveries",
                 "behaviour_penalty", "time_in_mesh_b", "mesh_deliveries",
                 "mesh_failure_penalty")


def _tensor(a: np.ndarray, device, dtype: torch.dtype | None = None
            ) -> torch.Tensor:
    a = np.array(a)      # a writable copy: torch keeps no view of it
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if dtype == torch.bfloat16:
        if a.dtype in (np.uint16, np.int16):
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(device)
        t = torch.from_numpy(a.astype(np.float32, copy=False))
        b = t.to(torch.bfloat16)
        if not torch.equal(b.to(torch.float32), t):
            raise ValueError("float32 leaf is not exactly bf16")
        return b.to(device)
    t = torch.from_numpy(a)
    return t.to(device) if dtype is None else t.to(device, dtype)


def _array(t: torch.Tensor, word: bool = False) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    a = t.numpy()
    return a.view(np.uint32) if word else a


def faults_from_numpy(f: dict | None, device) -> FaultParams | None:
    """The port's FaultParams from the reference's leaves (None: no
    schedule)."""
    if f is None:
        return None
    seed = np.asarray(f["seed"]).astype(np.uint32)
    part = {}
    for name in ("part_start", "part_end"):
        v = None if f[name] is None else np.asarray(f[name])
        if v is not None and seed.ndim:
            # a stack's windows: one host tuple for every replica
            if not (v == v[:1]).all():
                plan.refuse("batched_partitions")
            v = v[0]
        part[name] = None if v is None else tuple(int(x) for x in v)
    return FaultParams(
        down_start=_tensor(f["down_start"], device),
        down_end=_tensor(f["down_end"], device),
        seed=(torch.from_numpy(seed.astype(np.int64)).to(device)
              if seed.ndim else int(seed)),
        drop_prob=(None if f["drop_prob"] is None
                   else _tensor(np.asarray(f["drop_prob"], np.float32),
                                device)),
        cross_bits=(None if f["cross_bits"] is None
                    else _tensor(f["cross_bits"], device)),
        cold_restart=bool(f["cold_restart"]),
        directed_drops=bool(f["directed_drops"]), **part,
        **{name: (None if f.get(name) is None else _tensor(f[name], device))
           for name in MESHLESS_FAULT_TENSORS})


def faults_to_numpy(fp: FaultParams | None) -> dict | None:
    """FaultParams as the reference's leaves (None: no schedule)."""
    if fp is None:
        return None
    stacked = isinstance(fp.seed, torch.Tensor)
    part = {}
    for name in ("part_start", "part_end"):
        v = getattr(fp, name)
        v = None if v is None else np.asarray(v, dtype=np.int32)
        if v is not None and stacked:
            v = np.tile(v, (fp.seed.shape[0], 1))
        part[name] = v
    seed = (fp.seed.detach().cpu().numpy() if stacked
            else np.asarray(fp.seed))
    return dict(
        down_start=_array(fp.down_start), down_end=_array(fp.down_end),
        seed=seed.astype(np.uint32),
        drop_prob=None if fp.drop_prob is None else _array(fp.drop_prob),
        cross_bits=(None if fp.cross_bits is None
                    else _array(fp.cross_bits, True)),
        cold_restart=fp.cold_restart, directed_drops=fp.directed_drops,
        **part,
        **{name: (None if getattr(fp, name) is None
                  else _array(getattr(fp, name)))
           for name in MESHLESS_FAULT_TENSORS})


def score_knobs_from_numpy(d: dict | None, device) -> ScoreKnobs | None:
    if d is None:
        return None
    return ScoreKnobs(**{f: _tensor(d[f], device) for f in SCORE_KNOB_FIELDS})


def sim_knobs_from_numpy(d: dict | None, device) -> SimKnobs | None:
    if d is None:
        return None
    return SimKnobs(score=score_knobs_from_numpy(d["score"], device),
                    **{f: _tensor(d[f], device) for f in SIM_KNOB_FIELDS})


def delays_from_numpy(d: dict | None, device) -> DelayParams | None:
    """The port's DelayParams from the reference's leaves (None: no
    delays)."""
    if d is None:
        return None
    return DelayParams(
        base=_tensor(np.asarray(d["base"], np.int32), device),
        jitter=_tensor(np.asarray(d["jitter"], np.int32), device),
        seed=_tensor(np.asarray(d["seed"], np.uint32), device),
        k_slots=int(d["k_slots"]))


def delays_to_numpy(dp: DelayParams | None) -> dict | None:
    """DelayParams as the reference's leaves (None: no delays)."""
    if dp is None:
        return None
    return dict(base=_array(dp.base), jitter=_array(dp.jitter),
                seed=_array(dp.seed, True), k_slots=dp.k_slots)


def params_from_numpy(d: dict, device) -> GossipParams:
    """The port's GossipParams from the reference's leaves."""
    kw = {name: (None if d[name] is None else _tensor(d[name], device))
          for name in PARAM_TENSORS}
    weights = d["static_score_weights"]
    return GossipParams(
        **kw, static_score_weights=(None if weights is None
                                    else tuple(weights)),
        static_score_zero=bool(d["static_score_zero"]),
        faults=faults_from_numpy(d.get("faults"), device),
        score_knobs=score_knobs_from_numpy(d.get("score_knobs"), device),
        sim_knobs=sim_knobs_from_numpy(d.get("sim_knobs"), device),
        delays=delays_from_numpy(d.get("delays"), device))


def state_from_numpy(d: dict, sc: ScoreSimConfig | None,
                     device) -> GossipState:
    """The port's GossipState from the reference's leaves; ``sc`` gives
    the counter storage dtypes (None: an unscored state)."""
    kw = {name: (None if d.get(name) is None else _tensor(d[name], device))
          for name in STATE_TENSORS}
    s = d["scores"]
    if (sc is None) != (s is None):
        raise ValueError("scores leaves present iff a ScoreSimConfig is "
                         "given")
    scores = None
    if sc is not None:
        cdt, bdt = DTYPES[sc.counter_dtype], DTYPES[sc.bp_dtype]
        p3 = {name: (None if s[name] is None
                     else _tensor(s[name], device, cdt))
              for name in ("mesh_deliveries", "mesh_failure_penalty")}
        scores = ScoreState(
            time_in_mesh=_tensor(s["time_in_mesh"], device),
            first_deliveries=_tensor(s["first_deliveries"], device, cdt),
            invalid_deliveries=_tensor(s["invalid_deliveries"], device,
                                       cdt),
            behaviour_penalty=_tensor(s["behaviour_penalty"], device, bdt),
            time_in_mesh_b=(None if s["time_in_mesh_b"] is None
                            else _tensor(s["time_in_mesh_b"], device)), **p3)
    key = np.asarray(d["key"]).astype(np.uint32)
    tick = np.asarray(d["tick"]).reshape(-1)
    if (tick != tick[0]).any():
        plan.refuse("batched_ticks")
    salt = (torch.from_numpy(key[:, -1].astype(np.int64)).to(device)
            if key.ndim == 2 else int(key[-1]))
    return GossipState(
        **kw, scores=scores,
        gates=tuple(_tensor(g, device) for g in d["gates"]),
        gates_fp=int(d["gates_fp"]), salt=salt, tick=int(tick[0]))


def score_knobs_to_numpy(kn: ScoreKnobs | None) -> dict | None:
    return (None if kn is None
            else {f: _array(getattr(kn, f)) for f in SCORE_KNOB_FIELDS})


def sim_knobs_to_numpy(kn: SimKnobs | None) -> dict | None:
    if kn is None:
        return None
    out = {f: _array(getattr(kn, f)) for f in SIM_KNOB_FIELDS}
    out["score"] = score_knobs_to_numpy(kn.score)
    return out


def params_to_numpy(p: GossipParams) -> dict:
    out = {name: (None if getattr(p, name) is None
                  else _array(getattr(p, name), name in PARAM_WORDS))
           for name in PARAM_TENSORS}
    out.update(static_score_weights=p.static_score_weights,
               static_score_zero=p.static_score_zero,
               faults=faults_to_numpy(p.faults),
               score_knobs=score_knobs_to_numpy(p.score_knobs),
               sim_knobs=sim_knobs_to_numpy(p.sim_knobs),
               delays=delays_to_numpy(p.delays))
    return out


def state_to_numpy(s: GossipState) -> dict:
    out = {name: (None if getattr(s, name) is None
                  else _array(getattr(s, name), name in STATE_WORDS))
           for name in STATE_TENSORS}
    out["scores"] = (None if s.scores is None else
                     {name: (None if getattr(s.scores, name) is None
                             else _array(getattr(s.scores, name)))
                      for name in SCORE_TENSORS})
    out["gates"] = [_array(g, True) for g in s.gates]
    if isinstance(s.salt, torch.Tensor):
        salt = s.salt.detach().cpu().numpy().astype(np.uint32)
        key = np.stack([np.zeros_like(salt), salt], -1)
        tick = np.full(salt.shape, s.tick, dtype=np.int32)
    else:
        key = np.array([0, s.salt], dtype=np.uint32)
        tick = np.int32(s.tick)
    out.update(gates_fp=s.gates_fp, key=key, tick=tick)
    return out


# -- the mesh-less simulators ---------------------------------------------------

def _leaves_from(d: dict, names, device) -> dict:
    return {name: (None if d.get(name) is None else _tensor(d[name], device))
            for name in names}


def _leaves_to(obj, names) -> dict:
    return {name: (None if getattr(obj, name) is None
                   else _array(getattr(obj, name), name in MESHLESS_WORDS))
            for name in names}


def _tick_from(d: dict) -> int:
    return int(np.asarray(d["tick"]).reshape(-1)[0])


def flood_params_from_numpy(d: dict, device) -> FloodParams:
    """The port's FloodParams from the reference's leaves."""
    return FloodParams(**_leaves_from(d, FLOOD_PARAM_TENSORS, device),
                       faults=faults_from_numpy(d.get("faults"), device),
                       delays=delays_from_numpy(d.get("delays"), device))


def flood_params_to_numpy(p: FloodParams) -> dict:
    return dict(_leaves_to(p, FLOOD_PARAM_TENSORS),
                faults=faults_to_numpy(p.faults),
                delays=delays_to_numpy(p.delays))


def flood_state_from_numpy(d: dict, device) -> FloodState:
    """The port's FloodState from the reference's leaves (``tick`` a
    host int)."""
    return FloodState(**_leaves_from(d, FLOOD_STATE_TENSORS, device),
                      tick=_tick_from(d))


def flood_state_to_numpy(s: FloodState) -> dict:
    return dict(_leaves_to(s, FLOOD_STATE_TENSORS), tick=np.int32(s.tick))


def randomsub_params_from_numpy(d: dict, device) -> RandomSubParams:
    """The port's RandomSubParams from the reference's leaves."""
    return RandomSubParams(
        **_leaves_from(d, RANDOMSUB_PARAM_TENSORS, device),
        faults=faults_from_numpy(d.get("faults"), device),
        delays=delays_from_numpy(d.get("delays"), device))


def randomsub_params_to_numpy(p: RandomSubParams) -> dict:
    return dict(_leaves_to(p, RANDOMSUB_PARAM_TENSORS),
                faults=faults_to_numpy(p.faults),
                delays=delays_to_numpy(p.delays))


def randomsub_state_from_numpy(d: dict, device) -> RandomSubState:
    """The port's RandomSubState from the reference's leaves: the PRNG
    key (uint32 [2]) becomes the salt, its last word."""
    key = np.asarray(d["key"]).astype(np.uint32)
    return RandomSubState(**_leaves_from(d, RANDOMSUB_STATE_TENSORS, device),
                          salt=int(key[-1]), tick=_tick_from(d))


def randomsub_state_to_numpy(s: RandomSubState) -> dict:
    """The reference's leaves, the salt as the key ``[0, salt]``
    (``PRNGKey(seed)`` for a seed below 2^32)."""
    return dict(_leaves_to(s, RANDOMSUB_STATE_TENSORS),
                key=np.array([0, s.salt], dtype=np.uint32),
                tick=np.int32(s.tick))


def frame_to_numpy(frame: TelemetryFrame) -> dict:
    """A telemetry frame as {field: numpy array} (int32 / float32, with
    whatever leading axes a runner stacked; ``None`` for a histogram
    group that is off), leaf for leaf with the reference's frame."""
    return {f.name: (None if getattr(frame, f.name) is None
                     else _array(getattr(frame, f.name)))
            for f in dataclasses.fields(frame)}
