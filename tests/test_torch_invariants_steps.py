"""The armed step on every per-tick family against the JAX reference.

Both packages' sims are built by the earlier slices' builders
(``test_torch_knobs``' families: scored, unscored, the four attack
formations and the IWANT flood, the full variant's options, paired scored
and unscored; 900 to 1,024 peers), armed with ``attach`` and stepped 30
ticks by ``make_gossip_step(..., invariants=InvariantConfig())``: every
state leaf, the two carry scalars too, and the delivered words equal the
reference's XLA step with the checker on, on every tick; every leaf but
the two scalars equals the port's step with the checker off; the report
equals the reference's and is clean.  Each family runs clean and under
``test_torch_knobs_faults``' schedule (churn waves, 5% link loss, the
index halves partitioned), and the cold-restart case stays clean only
through the rejoin exemption.  Telemetry, knobs and delays are in
``test_torch_invariants_options.py``.

Tolerance: exact (packed words and integer counters bitwise, f32/bf16
leaves by bit pattern).
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_attacks as attacks
import test_torch_faults as tfaults
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import invariants as piv
from go_libp2p_pubsub_tpu_torch.models import telemetry as ptl
from test_torch_gossipsub import _assert_tree_equal
from test_torch_knobs import (  # noqa: F401  (one_thread: autouse)
    FAMILIES,
    IWANT_FLOOD,
    build_plain,
    one_thread,
)
from test_torch_knobs_faults import with_schedule
from test_torch_receive import _np
from test_torch_telemetry import assert_frames_equal
from torch_ref import imported_reference, tree_to_numpy

#: every per-tick family: the knob tests' and the IWANT flood
ALL_FAMILIES = dict(FAMILIES, both_spam=IWANT_FLOOD)
CLEAN = {"bits": 0, "first_tick": -1, "violations": []}
#: the attack builders leave 5% of the peers fanout-only, attackers among
#: them: an unsubscribed attacker grafts and its partners accept, so mesh
#: edges point at unsubscribed candidates from tick 0 — the reference
#: reports the same (its bypass mask exempts bit 4 only); with every peer
#: subscribed the two attacks run clean (``test_backoff_bypassing_...``)
FIRES = {name: {"bits": 1 << piv.MESH_SUB, "first_tick": 0,
                "violations": ["mesh-subscription"]}
         for name in ("graft_flood", "eclipse")}


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.delays as rdl
        import go_libp2p_pubsub_tpu.models.faults as rfl
        import go_libp2p_pubsub_tpu.models.invariants as riv
        import go_libp2p_pubsub_tpu.models.knobs as rkn
        import go_libp2p_pubsub_tpu.models.telemetry as rtl
        import go_libp2p_pubsub_tpu.models.tournament as rtn
        r.delays, r.faults, r.iv, r.knobs = rdl, rfl, riv, rkn
        r.telemetry, r.tournament = rtl, rtn
        yield r


def run_checked(ref, ref_sim, port_sim, tel_kw=None, ticks=30, icfg=None,
                watch=None):
    """Step the reference's armed XLA step, the port's armed step and the
    port's step without the checker ``ticks`` heartbeats: every leaf of the
    armed runs (the carry too), the delivered words and, with ``tel_kw``,
    the frames equal on every tick; the checker-off run equal to the armed
    one on every leaf it carries.  ``watch(tick, before, after, delivered)``
    sees each armed port tick.  Returns both reports."""
    import jax

    cfg_r, sc_r, p_r, s_r = ref_sim
    cfg_p, sc_p, p_p, s_p = port_sim
    kw = dict(icfg or {})
    tcfg_r = tcfg_p = None
    if tel_kw is not None:
        tcfg_r = ref.telemetry.TelemetryConfig(**tel_kw)
        tcfg_p = ptl.TelemetryConfig(**tel_kw)
    _assert_tree_equal(tree_to_numpy(p_r), convert.params_to_numpy(p_p),
                       "params")
    step_r = jax.jit(ref.gs.make_gossip_step(
        cfg_r, sc_r, telemetry=tcfg_r,
        invariants=ref.iv.InvariantConfig(**kw)))
    step_on = pgs.make_gossip_step(cfg_p, sc_p, device="cpu",
                                   telemetry=tcfg_p,
                                   invariants=piv.InvariantConfig(**kw))
    step_off = pgs.make_gossip_step(cfg_p, sc_p, device="cpu",
                                    telemetry=tcfg_p)
    s_r, s_on, s_off = ref.iv.attach(s_r), piv.attach(s_p), s_p
    for t in range(ticks):
        before = s_on
        s_r, d_r, *f_r = step_r(p_r, s_r)
        s_on, d_on, *f_on = step_on(p_p, s_on)
        s_off, d_off, *f_off = step_off(p_p, s_off)
        on = convert.state_to_numpy(s_on)
        want = tree_to_numpy(s_r)
        assert want["inv_viol"] is not None and on["inv_first"] is not None
        _assert_tree_equal(want, on, f"tick {t}")
        _assert_tree_equal(convert.state_to_numpy(s_off), on,
                           f"off tick {t}")
        np.testing.assert_array_equal(_np(d_on), np.asarray(d_r),
                                      err_msg=f"tick {t}")
        np.testing.assert_array_equal(_np(d_on), _np(d_off),
                                      err_msg=f"off tick {t}")
        if f_on:
            assert_frames_equal(convert.frame_to_numpy(f_on[0]),
                                tree_to_numpy(f_r[0]), f"tick {t}")
            assert_frames_equal(convert.frame_to_numpy(f_on[0]),
                                convert.frame_to_numpy(f_off[0]),
                                f"off tick {t}")
        if watch is not None:
            watch(t, before, s_on, d_on)
    got, exp = piv.report(s_on), ref.iv.report(s_r)
    assert got == exp
    return got


@pytest.mark.parametrize("faulted", [False, True])
@pytest.mark.parametrize("name", sorted(ALL_FAMILIES))
def test_armed_family_matches_reference_30_ticks(ref, name, faulted):
    sims = build_plain(ref, ALL_FAMILIES[name])
    if faulted:
        sims = with_schedule(ref, sims)
    assert run_checked(ref, *sims) == FIRES.get(name, CLEAN)


@pytest.mark.parametrize("name", ["cold_restart", "cold_restart_unscored"])
def test_cold_restart_is_clean_only_through_the_rejoin_exemption(ref, name):
    """Peers rejoining cold lose what they held: the armed run is clean,
    and the possession check without the rejoiners' exemption (``rejoin_w``
    left out) fires bit 2 on a rejoin tick of the same run."""
    ref_sim, port_sim = tfaults._build(ref, name)
    fp = port_sim[2].faults
    assert fp.cold_restart
    fired = []

    def watch(t, before, after, delivered):
        bits = piv.delivery_violations(piv.InvariantConfig(), before.have,
                                       after.have, delivered,
                                       alive_w=None)
        if int(bits):
            fired.append((t, int(bits)))

    assert run_checked(ref, ref_sim, port_sim, watch=watch) == CLEAN
    assert fired, "no rejoiner lost a bit: the exemption was not needed"
    assert all(b == 1 << piv.POSSESSION_REGRESSION for _, b in fired)


def subscribed_attack(ref, name):
    """Both packages' sims of ``test_torch_attacks``' case with every peer
    subscribed to its topic (as the reference's own attack test builds
    them)."""
    real = attacks._inputs

    def inputs(case, seed=0):
        (subs, *rest), kw = real(case, seed)
        subs = np.zeros_like(subs)
        subs[np.arange(len(subs)), np.arange(len(subs)) % attacks.T] = True
        return (subs, *rest), kw

    attacks._inputs = inputs
    try:
        return attacks._build(ref, name)
    finally:
        attacks._inputs = real


@pytest.mark.parametrize("name", ["graft_flood", "eclipse"])
def test_backoff_bypassing_attacks_stay_clean(ref, name):
    """Graft-flood and eclipse sybils may hold mesh edges inside their own
    backoff (the partner accepted): the bypass mask exempts them and the
    armed run is clean.  Graft flood: the backoff check without the mask
    fires on some tick of the same run (eclipse: no sybil edge sits in
    backoff within the 30 ticks, and the unmasked check stays quiet)."""
    ref_sim, port_sim = subscribed_attack(ref, name)
    cfg, _, p, _ = port_sim
    assert bool(p.subscribed.all())
    C = cfg.n_candidates
    fired = []

    def watch(t, before, after, delivered):
        bits = piv.gossip_mesh_violations(
            piv.InvariantConfig(), C, mesh_new=after.mesh,
            backoff_new=after.backoff, cand_sub_bits=p.cand_sub_bits,
            sub_all=torch.where(p.subscribed, (1 << C) - 1, 0).to(
                torch.int32))
        if int(bits):
            fired.append((t, int(bits)))

    assert run_checked(ref, ref_sim, port_sim, watch=watch) == CLEAN
    if name == "graft_flood":
        assert fired, "no sybil held an edge in backoff: the mask was idle"
    assert all(b == 1 << piv.MESH_BACKOFF for _, b in fired)
    att = p.sybil if name == "graft_flood" else p.eclipse_sybil
    assert bool(att.any())


def test_eclipse_sybil_edge_in_backoff_is_exempt(ref):
    """Seeded: one eclipse sybil's mesh edge forced inside its backoff in
    both packages (the gates refreshed).  The armed run is clean because
    the bypass mask exempts the sybil, and the backoff check on the same
    state without the mask fires MESH_BACKOFF on tick 0."""
    (cfg_r, sc_r, p_r, s_r), (cfg, sc, p, s_p) = subscribed_attack(
        ref, "eclipse")
    assert bool(p.subscribed.all())
    C = cfg.n_candidates
    syb = int(np.flatnonzero(_np(p.eclipse_sybil))[0])
    mesh, backoff = s_p.mesh.clone(), s_p.backoff.clone()
    mesh[syb] |= 1
    backoff[0, syb] = 50
    s_p = pgs.refresh_gates(cfg, sc, p, dataclasses.replace(
        s_p, mesh=mesh, backoff=backoff))
    s_r = ref.gs.refresh_gates(cfg_r, sc_r, p_r, s_r.replace(
        mesh=ref.gs.jnp.asarray(mesh.numpy().view(np.uint32)),
        backoff=ref.gs.jnp.asarray(backoff.numpy())))
    fired = []

    def watch(t, before, after, delivered):
        bits = piv.gossip_mesh_violations(
            piv.InvariantConfig(), C, mesh_new=after.mesh,
            backoff_new=after.backoff, cand_sub_bits=p.cand_sub_bits,
            sub_all=torch.where(p.subscribed, (1 << C) - 1, 0).to(
                torch.int32))
        if int(bits):
            fired.append((t, int(bits)))

    assert run_checked(ref, (cfg_r, sc_r, p_r, s_r), (cfg, sc, p, s_p),
                       ticks=3, watch=watch) == CLEAN
    assert fired and fired[0] == (0, 1 << piv.MESH_BACKOFF), fired
