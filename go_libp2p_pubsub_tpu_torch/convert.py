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
- ``tick`` becomes a host int.

The reverse functions give uint32 words back as uint32 and bf16 leaves
as their raw uint16 patterns, so two trees compare bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.gossipsub import (
    GossipParams,
    GossipState,
    ScoreSimConfig,
    ScoreState,
)
from .ops.kernels.receive import DTYPES

PARAM_WORDS = ("cand_sub_bits", "origin_words", "deliver_words",
               "invalid_words", "cand_victim_bits", "cand_same_ip",
               "cand_direct", "slot_b_words")
PARAM_TENSORS = ("subscribed", *PARAM_WORDS, "publish_tick",
                 "cand_app_score", "cand_colo_excess", "cand_static_score",
                 "cand_sybil", "sybil", "promise_break", "eclipse_sybil",
                 "eclipse_victim")
STATE_WORDS = ("mesh", "fanout", "have", "recent", "active", "mesh_b")
STATE_TENSORS = (*STATE_WORDS, "last_pub", "backoff", "first_tick",
                 "iwant_serves", "backoff_b")
SCORE_TENSORS = ("time_in_mesh", "first_deliveries", "invalid_deliveries",
                 "behaviour_penalty", "time_in_mesh_b")


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


def params_from_numpy(d: dict, device) -> GossipParams:
    """The port's GossipParams from the reference's leaves."""
    kw = {name: (None if d[name] is None else _tensor(d[name], device))
          for name in PARAM_TENSORS}
    weights = d["static_score_weights"]
    return GossipParams(
        **kw, static_score_weights=(None if weights is None
                                    else tuple(weights)),
        static_score_zero=bool(d["static_score_zero"]))


def state_from_numpy(d: dict, sc: ScoreSimConfig | None,
                     device) -> GossipState:
    """The port's GossipState from the reference's leaves; ``sc`` gives
    the counter storage dtypes (None: an unscored state)."""
    kw = {name: (None if d[name] is None else _tensor(d[name], device))
          for name in STATE_TENSORS}
    s = d["scores"]
    if (sc is None) != (s is None):
        raise ValueError("scores leaves present iff a ScoreSimConfig is "
                         "given")
    scores = None
    if sc is not None:
        cdt, bdt = DTYPES[sc.counter_dtype], DTYPES[sc.bp_dtype]
        scores = ScoreState(
            time_in_mesh=_tensor(s["time_in_mesh"], device),
            first_deliveries=_tensor(s["first_deliveries"], device, cdt),
            invalid_deliveries=_tensor(s["invalid_deliveries"], device,
                                       cdt),
            behaviour_penalty=_tensor(s["behaviour_penalty"], device, bdt),
            time_in_mesh_b=(None if s["time_in_mesh_b"] is None
                            else _tensor(s["time_in_mesh_b"], device)))
    key = np.asarray(d["key"]).astype(np.uint32)
    return GossipState(
        **kw, scores=scores,
        gates=tuple(_tensor(g, device) for g in d["gates"]),
        gates_fp=int(d["gates_fp"]), salt=int(key[-1]),
        tick=int(np.asarray(d["tick"])))


def params_to_numpy(p: GossipParams) -> dict:
    out = {name: (None if getattr(p, name) is None
                  else _array(getattr(p, name), name in PARAM_WORDS))
           for name in PARAM_TENSORS}
    out.update(static_score_weights=p.static_score_weights,
               static_score_zero=p.static_score_zero)
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
    out.update(gates_fp=s.gates_fp,
               key=np.array([0, s.salt], dtype=np.uint32),
               tick=np.int32(s.tick))
    return out
