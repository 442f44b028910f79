"""The per-edge receive loops: the heartbeat's receive half where the
receive kernel does not run it, in plain PyTorch on the step's device.

Counterpart of the reference's XLA receive half
(``go_libp2p_pubsub_tpu/models/gossipsub.py``, ``make_gossip_step``'s
step from its broken-promise words to the score epilogue), which its own
kernel planner leaves to XLA (``plan_kernel_step``): byzantine payload
mutation, P3/P3b bookkeeping and ``force_split``, more than 16
candidates, a SimKnobs point on an IWANT-flood config.  The reference
has no kernel for them, so neither has the port: its form is this
module.  ``models/plan.py`` ``receive_path`` picks the form, by the
reference's ladder.

Both forms read the step's prologue (publish injection, fanout, the
eager and advert words, the maintenance selections) and return what the
receive kernel returns, so the step's epilogue runs on either:

- **combined** (C <= 16, no P3/P3b, no ``force_split``; reference
  :3714-3865): one transfer a receiving edge carries the eager forwards,
  the flood publishes and the lazy gossip, each gated at its sender by
  the receiver's payload (and gossip) gate, which rides to the sender in
  one pair transfer;
- **split** (reference :3866-3990): the eager transfer first, gated by
  the receiver's payload gate, then the gossip transfer against what the
  eager one delivered, gated by payload and gossip; a gossip edge is not
  credited for a message an eager edge delivered in the same tick, and
  P3 counts the first-time copies of valid messages a mesh edge carried
  (``md_new``).

The reference writes its loops one edge at a time; here each transfer is
one gather of the [C, W, N] send words to their receivers (row j at peer
p is what candidate p + o_j sent p), and every per-edge count is the
same integer popcount, so the counters' float arithmetic sees the values
the reference's does, in its order.  ``jax.lax.optimization_barrier`` on
the reference's news word changes no value and has no counterpart.

Then (reference section numbers in the comments): new possession, the
handshake with backoff (4), the counter updates with the always-on serve
ledger and P3/P3b, and decay (5).  The step rotates PX (4b) and emits
the next tick's gates (``compute_gates``) from the new state.  Byzantine
mutation: every copy a mutator relays or serves reaches its receiver's
validator corrupted and is rejected — never acquired, charged to the
edge's P4 — so an honest copy from another edge can still land.
"""

from __future__ import annotations

import torch

from ..ops import graph
from ..ops.graph import expand_bits, popcount32, shr
from ..ops.kernels.receive import _f32


def _rows(bits: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """bool [C, 1, N]: row j is bit ``order[j]`` of the packed ``bits``
    ([N]; ``order`` int32 [C, 1]); a replica stack's [B, C, 1, N]."""
    return (((bits[..., None, :] >> order) & 1) != 0)[..., None, :]


def _arrive(words_of, geo) -> torch.Tensor:
    """int32 [C, W, N]: row j at peer p holds what candidate p + o_j sent
    p over its bit cinv[j]; ``words_of(order)`` builds the send words with
    row j taken from the sender's bit ``order[j]`` (a replica stack's
    [B, C, W, N], each replica's ring its own)."""
    sent = words_of(geo.cinv)
    return torch.gather(sent, -1, geo.index[:, None, :].expand(sent.shape))


def _or_rows(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over the candidate axis ([..., C, W, N] -> [..., W,
    N])."""
    while x.shape[-3] > 1:
        half = x.shape[-3] // 2
        top = x[..., :half, :, :] | x[..., half:2 * half, :, :]
        x = (top if x.shape[-3] % 2 == 0
             else torch.cat([top, x[..., 2 * half:, :, :]], -3))
    return x[..., 0, :, :]


def _news(got, seen, byz):
    """(news, accepted): the ids new to the receiver, and of those the
    ones it acquires — a mutator's copies are rejected (``byz``, bool
    [C, 1, N]: the row's sender mutates; None: no mutators)."""
    news = got & ~seen[..., None, :, :]
    return news, (news if byz is None else torch.where(byz, 0, news))


def _counts(news, accepted, valid):
    """Per edge, int32 [C, N]: valid ids acquired (P2) and the rest of
    the news, invalid or rejected (P4)."""
    v = valid[..., None, :, None]
    fd = popcount32(accepted & v).sum(-2, dtype=torch.int32)
    return fd, popcount32(news).sum(-2, dtype=torch.int32) - fd


def receive(cfg, sc, params, state, *, split: bool, geo, fm, sub_all, sel,
            injected, fresh, adv, seen, targets, withhold, out_bits,
            flood_bits, payload_bits, gossip_bits, accept_bits,
            valid) -> dict:
    """One tick's receive half on the loops.

    ``geo`` is the ring's ``EdgeGeometry``, ``fm`` the tick's fault masks
    (or None), ``sel`` slot A's maintenance selections; the words are the
    step's
    prologue's (targets, out_bits and flood_bits already silenced for
    eclipse attackers and masked by ``send_ok``; scored: the start-of-tick
    payload, gossip and accept gate words with direct peers let through,
    ``valid`` the per-word validity masks).  Returns ``acq`` [W, N] (the
    new acquisitions), ``mesh``, ``backoff``, ``px_rot`` (the PRUNEs and
    PRUNE-responses received) and, scored, ``scores`` (a dict of the
    counters) and ``iwant_serves``."""
    from .gossipsub import _lead, transfer_bits  # (gossipsub imports this)

    def transfer(bits, pair):
        return transfer_bits(bits, cfg, pair, geo)

    C = cfg.n_candidates
    scored = sc is not None
    byz = None
    if scored and sc.byzantine_mutation and params.cand_byz is not None:
        byz = _rows(params.cand_byz, geo.bit)
    # (a down receiver's word, against [..., C, W, N] arrivals)
    alive_w = None if fm is None else fm.alive_w[..., None, None, :]

    def words(bits, w):
        return lambda order: torch.where(_rows(bits, order),
                                         w[..., None, :, :], 0)

    # broken promises: a withholding peer's IHAVE claims ids the receiver
    # lacks (reference :3510-3530)
    cheat_src = (torch.where(withhold, targets, 0)
                 if withhold is not None else None)
    lack_all = None
    if cheat_src is not None:
        lack = (~seen != 0).any(-2)
        if fm is not None:
            lack = lack & fm.alive
        lack_all = torch.where(lack, graph.i32((1 << C) - 1), 0)

    fd_add = iv_add = md_new = broken = None
    if not split:
        # -- 2+3 combined (:3714-3865): the receiver's payload and
        # payload-and-gossip gates ride to the sender in one pair transfer
        send_gsp = (targets if withhold is None
                    else torch.where(withhold, 0, targets))
        send_cheat, send_fwd, send_flood = cheat_src, out_bits, flood_bits
        if scored:
            gate = transfer(
                payload_bits | ((payload_bits & gossip_bits) << 16), True)
            send_fwd = out_bits & gate
            send_gsp = send_gsp & shr(gate, 16)
            if send_cheat is not None:
                send_cheat = send_cheat & shr(gate, 16)
            if flood_bits is not None:
                send_flood = flood_bits & gate

        def sent(order):
            out = words(send_fwd, fresh)(order)
            if send_flood is not None:
                out = out | words(send_flood, injected)(order)
            return out | words(send_gsp, adv)(order)
        got = _arrive(sent, geo)
        if alive_w is not None:
            got = got & alive_w               # a down peer hears nothing
        news, accepted = _news(got, seen, byz)
        heard = _or_rows(accepted)
        if scored:
            fd_add, iv_add = _counts(news, accepted, valid)
        if send_cheat is not None:
            broken = transfer(send_cheat, False) & lack_all
    else:
        # -- 2. the eager transfer with per-edge provenance (:3866-3913)
        def eager(order):
            out = words(out_bits, fresh)(order)
            if flood_bits is not None:
                out = out | words(flood_bits, injected)(order)
            return out
        got = _arrive(eager, geo)
        if scored:
            got = torch.where(_rows(payload_bits, geo.bit), got, 0)
        if alive_w is not None:
            got = got & alive_w
        news, accepted = _news(got, seen, byz)
        mesh_heard = _or_rows(accepted)
        if scored:
            fd_add, iv_add = _counts(news, accepted, valid)
            if sc.track_p3:
                # P3: first-time copies of valid messages over the edge,
                # duplicates included, a mutator's excepted
                ok = got if byz is None else torch.where(byz, 0, got)
                md_new = popcount32(
                    ok & valid[..., None, :, None]
                    & ~state.have[..., None, :, :]).sum(-2,
                                                        dtype=torch.int32)
        # -- 3. the gossip transfer (:3915-3988), against what the eager
        # transfer delivered
        send_gsp = (targets if withhold is None
                    else torch.where(withhold, 0, targets))
        got = _arrive(words(send_gsp, adv), geo)
        gate_g = None
        if scored:
            gate_g = payload_bits & gossip_bits
            got = torch.where(_rows(gate_g, geo.bit), got, 0)
        if alive_w is not None:
            got = got & alive_w
        news, accepted = _news(got, seen | mesh_heard, byz)
        heard = mesh_heard | _or_rows(accepted)
        if scored:
            fd_g, iv_g = _counts(news, accepted, valid)
            fd_add, iv_add = fd_add + fd_g, iv_add + iv_g
        if cheat_src is not None:
            broken = transfer(cheat_src, False) & lack_all
            if gate_g is not None:
                broken = broken & gate_g
    acq = torch.where(sub_all[..., None, :] != 0, heard, 0) | injected

    # -- 4. the handshake (:4008-4145): GRAFT, PRUNE and the "no PRUNE
    # would come back" word A, as sent (under faults only over a live
    # link), then resolved at the receiver
    grafts, dropped, a_sent = sel["grafts"], sel["dropped"], sel["a_sent"]
    if fm is not None:
        grafts_tx, dropped_tx = grafts & fm.send_ok, dropped & fm.send_ok
        a_sent = a_sent & fm.send_ok
    else:
        grafts_tx, dropped_tx = grafts, dropped
    if C <= 16:
        hs = transfer(grafts_tx | (dropped_tx << 16), True)
        graft_recv, prune_recv = hs & 0xFFFF, shr(hs, 16)
    else:
        graft_recv = transfer(grafts_tx, False)
        prune_recv = transfer(dropped_tx, False)
    a_recv = transfer(a_sent, False)
    if fm is not None:
        # a down peer processes no inbound control
        graft_recv = graft_recv & fm.alive_all
        prune_recv = prune_recv & fm.alive_all
        a_recv = a_recv & fm.alive_all
    if scored:
        # graylisted peers' control is dropped outright
        graft_recv = graft_recv & accept_bits
        prune_recv = prune_recv & accept_bits
    violation = graft_recv & sel["backoff_bits2"]
    retract = grafts & ~a_recv
    # the retraction last: where accept and retract meet (graft flood)
    # the PRUNE response wins
    mesh = ((sel["mesh_sel"] | (graft_recv & sel["would_accept"]))
            & ~prune_recv) & ~retract
    bo_trig = dropped | prune_recv | retract

    # -- 5. backoff as remaining ticks: a trigger restarts the clock at
    # B - 1, else it counts down to 0
    skn = params.sim_knobs
    restart = (cfg.backoff_ticks - 1 if skn is None
               else (_lead(skn.backoff_ticks, 2) - 1).to(torch.int16))
    bo = state.backoff
    backoff = torch.where(expand_bits(bo_trig, C), restart,
                          (bo - 1).clamp(min=0)).to(torch.int16)
    out = dict(acq=acq, mesh=mesh, backoff=backoff,
               px_rot=prune_recv | retract)
    if not scored:
        return out
    out.update(_counters(cfg, sc, params, state, fm=fm, geo=geo, adv=adv,
                         mesh=mesh, fd_add=fd_add, iv_add=iv_add,
                         md_new=md_new, violation=violation, broken=broken))
    return out


def _counters(cfg, sc, params, state, *, fm, geo, adv, mesh, fd_add,
              iv_add, md_new, violation, broken) -> dict:
    """The score epilogue (reference :4171-4307): the serve ledger, the
    P2/P3/P3b/P4/P7 updates in f32, decay, the counter dtype's write."""
    from .gossipsub import _lead
    C = cfg.n_candidates
    s0 = state.scores
    f32 = torch.float32
    cdt = s0.first_deliveries.dtype
    fd_stack, iv_stack = fd_add.to(f32), iv_add.to(f32)
    # the gossip-repair serve ledger, always on: pulls over an edge are
    # its news counts; IWANT-flooding sybils re-request the partner's
    # whole advert window until the budget is spent
    s32 = state.iwant_serves.to(torch.int32)
    pulls = fd_add + iv_add
    if sc.sybil_iwant_spam and params.sybil is not None:
        adv_count = popcount32(adv).sum(-2, dtype=torch.int32)
        partner_adv = adv_count[..., geo.index]                # [C, N]
        skn = params.sim_knobs
        retrans = (cfg.gossip_retransmission if skn is None
                   else _lead(skn.gossip_retransmission, 2))
        flood = torch.where((s32 < retrans * partner_adv)
                            & (partner_adv > 0), partner_adv, 0)
        if fm is not None:
            # no flood over a faulted edge
            flood = torch.where(expand_bits(fm.flood_ok, C), flood, 0)
        pulls = torch.where(params.sybil[..., None, :], flood, pulls)
    H = cfg.history_length
    decayed = s32 - torch.div(s32 + (H - 1), H, rounding_mode="floor")
    iws = (decayed + pulls).clamp(0, 30000).to(torch.int16)

    f = _f32
    in_mesh_after = expand_bits(mesh, C)
    fd = (s0.first_deliveries.to(f32) + fd_stack).clamp(
        max=f(sc.first_message_deliveries_cap))
    inv = s0.invalid_deliveries.to(f32) + iv_stack
    out = {}
    if sc.track_p3:
        in_mesh_before = expand_bits(state.mesh, C)
        md = (s0.mesh_deliveries.to(f32)
              + md_new.to(f32) * in_mesh_before.to(f32)).clamp(
                  max=f(sc.mesh_message_deliveries_cap))
        # P3b: an edge pruned while active with a delivery deficit keeps
        # the deficit² as a sticky penalty (score.go Prune)
        removed = in_mesh_before & ~in_mesh_after
        was_active = (s0.time_in_mesh.to(f32)
                      > sc.mesh_message_deliveries_activation)
        deficit = (f(sc.mesh_message_deliveries_threshold) - md).clamp(
            min=0.0)
        mfp = s0.mesh_failure_penalty.to(f32) + torch.where(
            removed & was_active, deficit * deficit, 0.0)
    # P7: backoff violations and broken promises
    bp = s0.behaviour_penalty.to(f32) + expand_bits(violation, C).to(f32)
    if broken is not None:
        bp = bp + expand_bits(broken, C).to(f32)

    def dk(x, decay, dtype=cdt):
        x = x * f(decay)
        return torch.where(x < f(sc.decay_to_zero), 0.0, x).to(dtype)

    if sc.track_p3:
        out.update(mesh_deliveries=dk(md, sc.mesh_message_deliveries_decay),
                   mesh_failure_penalty=dk(mfp,
                                           sc.mesh_failure_penalty_decay))
    tim = torch.where(in_mesh_after,
                      (s0.time_in_mesh.to(torch.int32) + 1).clamp(max=32766),
                      0).to(torch.int16)
    out.update(
        time_in_mesh=tim,
        first_deliveries=dk(fd, sc.first_message_deliveries_decay),
        invalid_deliveries=dk(inv, sc.invalid_message_deliveries_decay),
        behaviour_penalty=dk(bp, sc.behaviour_penalty_decay,
                             s0.behaviour_penalty.dtype))
    return dict(scores=out, iwant_serves=iws)
