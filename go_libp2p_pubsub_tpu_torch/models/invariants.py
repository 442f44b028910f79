"""The in-step invariant checker: every run proves the router's safety
properties on every tick.

Counterpart of ``go_libp2p_pubsub_tpu/models/invariants.py``.  The
properties are those a correct GossipSub router keeps ("Verification of
GossipSub in ACL2s"): score soundness, mesh membership, no delivery at a
down peer.  Each is a cheap reduction over values the step already
computed (the start-of-tick possession, the new state, the tick's
delivered words and fault masks), so the state trajectory with the
checker on is bit-identical to the one with it off, and the checker adds
no kernel and no host sync: the bits stay on the device.

- ``InvariantConfig`` is the step's static option; ``None`` (the
  default) builds the step without it.
- The results ride the state as two 0-d int32 tensors: ``inv_viol``,
  the cumulative violation mask (a u32 word held as int32, bits 0-6),
  and ``inv_first``, the first tick with a violation (-1 while clean).
  A state is built without them; ``attach(state)`` arms it, and a step
  with the checker refuses an unarmed state (``require_armed``).
- ``report(state)`` reads them on the host, once, at the end of a run.

Violation bits (stable):

====  =====================  ==============================================
bit   name                   property (must never hold)
====  =====================  ==============================================
0     delivery-down          a copy was delivered at a down peer
1     delivery-invalid       a validation-failing id entered the
                             delivered set
2     possession-regression  a possession word lost a bit outside a
                             cold-restart rejoin clear
3     mesh-subscription      a mesh bit points at an unsubscribed
                             candidate edge (or an unsubscribed peer
                             holds mesh state)
4     mesh-backoff           an honest peer holds a mesh edge under its
                             own backoff (graft-flood and eclipse sybils,
                             which bypass backoff, are exempt)
5     score-p1-off-mesh      a time-in-mesh counter is nonzero on a
                             non-mesh edge
6     score-range            a score counter left its sound range (P2
                             above its cap plus one bf16 rounding step,
                             or a decaying counter negative)
====  =====================  ==============================================

The gossipsub step checks all three groups (``models/gossipsub.py``
``make_gossip_step(invariants=)``); the floodsub and randomsub routers'
delivery subset is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

# -- violation bit assignments (stable) ------------------------------------

DELIVERY_DOWN = 0
DELIVERY_INVALID = 1
POSSESSION_REGRESSION = 2
MESH_SUB = 3
MESH_BACKOFF = 4
SCORE_P1_OFF_MESH = 5
SCORE_RANGE = 6

VIOLATION_NAMES = (
    "delivery-down",
    "delivery-invalid",
    "possession-regression",
    "mesh-subscription",
    "mesh-backoff",
    "score-p1-off-mesh",
    "score-range",
)

#: bf16 counter storage rounds to 8 significand bits; a stored value
#: provably <= cap in f32 may read back up to one ULP above it.  The
#: range check allows that single rounding step and nothing more.
_CAP_SLACK = 1.0 + 2.0 ** -7


@dataclass(frozen=True)
class InvariantConfig:
    """The checker's static option, one toggle a group:

    - ``delivery``: bits 0-2 — down-peer delivery, invalid-id delivery,
      possession monotonicity (cold-restart aware);
    - ``mesh``: bits 3-4 — mesh-membership soundness;
    - ``scores``: bits 5-6 — score-counter soundness (scored sims only).
    """

    delivery: bool = True
    mesh: bool = True
    scores: bool = True


# --------------------------------------------------------------------------
# The carry
# --------------------------------------------------------------------------


def attach(state):
    """``state`` armed for the checker: ``inv_viol`` 0 and ``inv_first``
    -1, 0-d int32 tensors on the state's device (a replica stack's: [B],
    one carry a replica).  Any simulator's state: the GossipSub state's
    mesh words [N] or the mesh-less states' possession words [W, N] give
    the shape."""
    dev = state.have.device
    mesh = getattr(state, "mesh", None)
    shape = mesh.shape[:-1] if mesh is not None else state.have.shape[:-2]
    return replace(state,
                   inv_viol=torch.zeros(shape, dtype=torch.int32, device=dev),
                   inv_first=torch.full(shape, -1, dtype=torch.int32,
                                        device=dev))


def require_armed(state, sim: str) -> None:
    """A step with the checker on an unarmed state would have nowhere to
    record a violation: the reference's ValueError."""
    if getattr(state, "inv_viol", None) is None:
        raise ValueError(
            f"invariant checking needs an armed state: pass the {sim} "
            "state through models.invariants.attach(state) before "
            "stepping (InvariantConfig was given but inv_viol is None)")


def fold(inv_viol, inv_first, bits, tick: int):
    """One tick's violation ``bits`` into the carry, on the device:
    ``(inv_viol | bits, first violating tick)``."""
    first = torch.where((inv_first < 0) & (bits != 0), tick, inv_first)
    return inv_viol | bits, first


def report(state) -> dict:
    """The armed state's carry on the host (the run's one sync):
    ``{"violations": [names...], "bits": int, "first_tick": int}``."""
    viol = np.asarray(state.inv_viol.detach().cpu()).astype(np.int64)
    bits = int(viol.reshape(-1)[0]) & 0xFFFFFFFF
    names = [n for i, n in enumerate(VIOLATION_NAMES) if bits >> i & 1]
    first = np.asarray(state.inv_first.detach().cpu()).reshape(-1)
    return {"violations": names, "bits": bits,
            "first_tick": (int(first[0]) if first.size == 1
                           else [int(x) for x in first])}


def report_batch(state) -> list:
    """A replica stack's carries on the host: ``report``'s dict for each
    replica, in replica order (one sync)."""
    viol = state.inv_viol.detach().cpu().reshape(-1).tolist()
    first = state.inv_first.detach().cpu().reshape(-1).tolist()
    out = []
    for v, f in zip(viol, first):
        bits = int(v) & 0xFFFFFFFF
        out.append({"violations": [n for i, n in enumerate(VIOLATION_NAMES)
                                   if bits >> i & 1],
                    "bits": bits, "first_tick": int(f)})
    return out


# --------------------------------------------------------------------------
# The checks (reductions on the device; shapes as the step's, peer axis last)
# --------------------------------------------------------------------------


#: per device: a False scalar, the bit values 1 << b, and per C the mesh
#: row masks 1 << c (made once, so a tick copies nothing to the device)
_CONSTS: dict = {}


def _consts(dev: torch.device) -> dict:
    if dev not in _CONSTS:
        _CONSTS[dev] = dict(
            false=torch.zeros((), dtype=torch.bool, device=dev),
            bit=1 << torch.arange(len(VIOLATION_NAMES), dtype=torch.int32,
                                  device=dev))
    return _CONSTS[dev]


def _any(x: torch.Tensor, batched: bool) -> torch.Tensor:
    """``x.any()``, per replica for a stack (bool [B])."""
    return x.flatten(1).any(1) if batched else x.any()


def _pack(conds: list, first: int, like: torch.Tensor,
          batched: bool = False) -> torch.Tensor:
    """0-d int32 with bit ``first + i`` set where the 0-d bool ``conds[i]``
    holds (None: the check is off), in four launches; a stack's [B], from
    [B] conditions."""
    k = _consts(like.device)
    shape = like.shape[:1] if batched else ()
    if all(c is None for c in conds):
        return torch.zeros(shape, dtype=torch.int32, device=like.device)
    held = torch.stack([k["false"].expand(shape) if c is None else c
                        for c in conds], -1)
    return (held.to(torch.int32) * k["bit"][first:first + len(conds)]).sum(
        -1, dtype=torch.int32)


def delivery_violations(icfg: InvariantConfig, have_old, have_new,
                        delivered_now, *, alive_w=None, invalid_words=None,
                        allowed_clear_w=None) -> torch.Tensor:
    """Bits 0-2 over the possession words (int32 [W, N]).

    ``alive_w``: int32 [N], all ones iff the peer is alive (None: no
    faults, the down-delivery check is off); ``invalid_words``: int32
    [W], the validation-failure mask (None: unscored, the invalid-delivery
    check is off); ``allowed_clear_w``: int32 [N], all ones at the peers
    whose possession was cleared by a cold-restart rejoin this tick —
    a lost bit anywhere else is a violation."""
    bt = have_new.dim() == 3
    if not icfg.delivery:
        return _pack([None], 0, have_new, bt)
    down = invalid = None
    if alive_w is not None:
        down = _any(delivered_now & alive_w[..., None, :].bitwise_not(), bt)
    if invalid_words is not None:
        invalid = _any(delivered_now & invalid_words[..., None], bt)
    shrink = have_old & ~have_new
    if allowed_clear_w is not None:
        shrink = shrink & ~allowed_clear_w[..., None, :]
    return _pack([down, invalid, _any(shrink, bt)], DELIVERY_DOWN,
                 have_new, bt)


def wrap_step_delivery(core, icfg: InvariantConfig, sim: str):
    """The ``delivery``-group checks (bits 0 and 2, the mesh-less
    simulators' subset) folded around a floodsub or randomsub step core:
    a pure readout, the wrapped core's trajectory is the bare one's.
    ``sim`` names the simulator in ``require_armed``'s message."""
    from . import faults as _faults

    def core_inv(params, state):
        require_armed(state, sim)
        aw = None
        if params.faults is not None:
            aw = _faults.alive_word(
                _faults.alive_mask(params.faults, state.tick))
        out = core(params, state)
        bits = delivery_violations(icfg, state.have, out[0].have, out[1],
                                   alive_w=aw)
        viol, first = fold(state.inv_viol, state.inv_first, bits,
                           state.tick)
        return (replace(out[0], inv_viol=viol, inv_first=first), *out[1:])
    return core_inv


def in_mesh_rows(mesh: torch.Tensor, C: int) -> torch.Tensor:
    """bool [C, N]: row c = bit c of the packed words (``expand_bits``
    in one [C, N] pass fewer: the words ANDed with each row's bit)."""
    k = _consts(mesh.device)
    if C not in k:
        k[C] = 1 << torch.arange(C, dtype=torch.int32,
                                 device=mesh.device)[:, None]
    return (mesh[..., None, :] & k[C]) != 0


def gossip_mesh_violations(icfg: InvariantConfig, C: int, *, mesh_new,
                           backoff_new, cand_sub_bits, sub_all,
                           honest_all=None, mesh_b_new=None,
                           backoff_b_new=None, in_mesh=None,
                           in_mesh_b=None) -> torch.Tensor:
    """Bits 3-4 over the packed mesh words (int32 [N]) and the backoff
    ticks (int16 [C, N]); paired, slot B's too.

    ``honest_all``: int32 [N], all C bits at the peers not running a
    backoff-bypassing attack (graft-flood and eclipse sybils hold mesh
    edges inside their own backoff: the partner accepted); None: every
    peer honest.  ``in_mesh`` / ``in_mesh_b``: the mesh words as rows
    (``in_mesh_rows``), where the caller has them already."""
    bt = mesh_new.dim() == 2
    if not icfg.mesh:
        return _pack([None], MESH_SUB, mesh_new, bt)
    ok_edges = cand_sub_bits & sub_all
    stray = mesh_new & ~ok_edges
    if mesh_b_new is not None:
        stray = stray | (mesh_b_new & ~ok_edges)

    def clash(mesh, rows, backoff):
        # the reference packs the backoff rows and ANDs the words; the
        # same edges, without the [C, N] int64 packing pass
        if honest_all is not None:
            rows = in_mesh_rows(mesh & honest_all, C)
        elif rows is None:
            rows = in_mesh_rows(mesh, C)
        return _any((backoff > 0) & rows, bt)

    clashed = clash(mesh_new, in_mesh, backoff_new)
    if mesh_b_new is not None:
        clashed = clashed | clash(mesh_b_new, in_mesh_b, backoff_b_new)
    return _pack([_any(stray, bt), clashed], MESH_SUB, mesh_new, bt)


def _bf16_floor(x: float) -> float:
    """The largest bfloat16 value at or below the f32 ``x``."""
    bits = int(np.float32(x).view(np.uint32))
    low = bits & 0xFFFF0000
    if bits & 0x80000000 and low != bits:
        low += 0x10000          # a negative value truncated toward zero
    return float(np.uint32(low).view(np.float32))


def _above(x: torch.Tensor, cap32: float) -> torch.Tensor:
    """``x.to(f32) > cap32`` for bf16 or f32 counters, without an f32
    copy: a bf16 counter is above the f32 ``cap32`` iff it is above the
    largest bf16 value at or below it, which the comparison reads exactly
    (torch rounds a scalar to the tensor's dtype first)."""
    if x.dtype == torch.bfloat16:
        return x > _bf16_floor(cap32)
    return x > cap32


def gossip_score_violations(icfg: InvariantConfig, sc, scores_new, *,
                            mesh_new, mesh_b_new=None, in_mesh=None,
                            in_mesh_b=None) -> torch.Tensor:
    """Bits 5-6 over the [C, N] score counters (scored sims only).

    The P2 cap check holds the counters, as f32, against ``cap ·
    _CAP_SLACK`` rounded to f32, as the reference does (``_above``): a
    bf16 counter one rounding step above the cap gives the same bit in
    both.  The sign checks read the stored counters (a sign is the same
    in f32).  ``in_mesh`` / ``in_mesh_b`` as ``gossip_mesh_violations``
    takes them."""
    s = scores_new
    bt = mesh_new.dim() == 2
    if not icfg.scores or s is None:
        return _pack([None], SCORE_P1_OFF_MESH, mesh_new, bt)
    C = s.time_in_mesh.shape[-2]
    if in_mesh is None:
        in_mesh = in_mesh_rows(mesh_new, C)
    # (a & ~b on bools is a > b)
    p1_stray = _any(torch.gt(s.time_in_mesh > 0, in_mesh), bt)
    if s.time_in_mesh_b is not None:
        if in_mesh_b is None:
            in_mesh_b = in_mesh_rows(mesh_b_new, C)
        p1_stray = p1_stray | _any(torch.gt(s.time_in_mesh_b > 0,
                                            in_mesh_b), bt)
    cap = float(np.float32(sc.first_message_deliveries_cap * _CAP_SLACK))
    fd = s.first_deliveries
    bad = (_any(_above(fd, cap), bt) | _any(fd < 0, bt)
           | _any(s.invalid_deliveries < 0, bt)
           | _any(s.behaviour_penalty < 0, bt))
    return _pack([p1_stray, bad], SCORE_P1_OFF_MESH, mesh_new, bt)
