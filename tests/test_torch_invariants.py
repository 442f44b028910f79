"""The port's invariant checker (``models/invariants.py``) against the JAX
reference's (``go_libp2p_pubsub_tpu/models/invariants.py``).

- the tables (bit numbers, names, the cap slack, the config's groups);
- each check function on seeded words, one defect at a time and every
  group toggle, the bits equal to the reference's: delivery (down peer,
  invalid id, possession shrink with and without the rejoin exemption),
  mesh (stray edge, backoff clash with and without the bypass mask, slot
  B's), scores (P1 off mesh, slot B's P1, each counter below zero, the P2
  cap at the bf16 rounding edge for bf16 and f32 storage), and the cap
  comparison on stored counters equal to the f32 one at every edge;
- ``attach``, ``fold`` and ``report``; ``require_armed``'s message, and the
  armed step's refusal of an unarmed state;
- the reference's two seeded defects (``tests/test_invariants.py``
  ``test_seeded_mesh_defect_fires``, ``test_seeded_broken_step_fires_
  delivery_bits``) trip the same bits on the same tick in the port, with
  each group toggled off too;
- the reference's padded sim (``pad_to_block=128``, its kernel step in
  interpret mode, armed) equals its unpadded one at a multiple of 128
  peers, and the port's armed unpadded run: the ground for building the
  invariants benchmark unpadded at 1,024,000 = 125 · 8192 peers.

Tolerance: exact (integer bits and ticks; states bitwise).
"""

import dataclasses

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import faults as pfl
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import invariants as piv
from test_torch_gossipsub import _assert_tree_equal
from test_torch_knobs import one_thread  # noqa: F401  (autouse)
from torch_ref import imported_reference, tree_to_numpy


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.faults as rfl
        import go_libp2p_pubsub_tpu.models.invariants as riv
        r.faults, r.iv = rfl, riv
        yield r


def _u32(a):
    return np.asarray(a, dtype=np.uint32)


def _t(a):
    """uint32 words -> the port's int32 tensor of the same bits."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    import jax.numpy as jnp
    return None if a is None else jnp.asarray(a)


def test_tables_match_reference(ref):
    assert piv.VIOLATION_NAMES == ref.iv.VIOLATION_NAMES
    for name in ("DELIVERY_DOWN", "DELIVERY_INVALID",
                 "POSSESSION_REGRESSION", "MESH_SUB", "MESH_BACKOFF",
                 "SCORE_P1_OFF_MESH", "SCORE_RANGE"):
        assert getattr(piv, name) == getattr(ref.iv, name)
    assert piv._CAP_SLACK == ref.iv._CAP_SLACK
    port = [(f.name, f.default) for f in
            dataclasses.fields(piv.InvariantConfig)]
    want = [(f.name, f.default) for f in
            dataclasses.fields(ref.iv.InvariantConfig)]
    assert port == want


GROUPS = [dict(), dict(delivery=False), dict(mesh=False), dict(scores=False)]


def _both(ref, kw):
    return piv.InvariantConfig(**kw), ref.iv.InvariantConfig(**kw)


# -- delivery ------------------------------------------------------------------

W_, N_ = 2, 96


def _delivery_words(defect, seed):
    rng = np.random.default_rng(seed)
    old = _u32(rng.integers(0, 1 << 32, (W_, N_), dtype=np.uint64))
    new = old | _u32(rng.integers(0, 1 << 32, (W_, N_), dtype=np.uint64))
    alive = np.where(rng.random(N_) < 0.8, 0xFFFFFFFF, 0).astype(np.uint32)
    invalid = _u32([0x0000F0F0, 0x80000001])
    delivered = (new & ~old) & alive[None] & ~invalid[:, None]
    clear = np.zeros(N_, np.uint32)
    up = np.flatnonzero((alive != 0) & (old[0] != 0))
    if defect == "down":
        delivered[1, np.flatnonzero(alive == 0)[0]] |= 4
    elif defect == "invalid":
        delivered[1, up[0]] |= 1
    elif defect == "shrink":
        low = int(old[0, up[0]]) & -int(old[0, up[0]])
        new[0, up[0]] &= np.uint32(~low & 0xFFFFFFFF)
    elif defect == "rejoin":
        # the peer rejoined cold: its words were cleared
        clear[up[0]] = 0xFFFFFFFF
        new[:, up[0]] = 0
    return dict(old=old, new=new, delivered=delivered, alive=alive,
                invalid=invalid, clear=clear)


@pytest.mark.parametrize("group", range(len(GROUPS)))
@pytest.mark.parametrize("defect", ["none", "down", "invalid", "shrink",
                                    "rejoin"])
@pytest.mark.parametrize("opts", ["all", "bare"])
def test_delivery_bits_match_reference(ref, defect, group, opts):
    w = _delivery_words(defect, seed=len(defect))
    p_cfg, r_cfg = _both(ref, GROUPS[group])
    kw = dict(alive_w=w["alive"], invalid_words=w["invalid"],
              allowed_clear_w=w["clear"]) if opts == "all" else {}
    got = piv.delivery_violations(
        p_cfg, _t(w["old"]), _t(w["new"]), _t(w["delivered"]),
        **{k: _t(v) for k, v in kw.items()})
    want = ref.iv.delivery_violations(
        r_cfg, _j(w["old"]), _j(w["new"]), _j(w["delivered"]),
        **{k: _j(v) for k, v in kw.items()})
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == int(want)
    if defect == "none" or not GROUPS[group].get("delivery", True):
        assert int(got) == 0
    elif opts == "all":
        bit = dict(down=piv.DELIVERY_DOWN, invalid=piv.DELIVERY_INVALID,
                   shrink=piv.POSSESSION_REGRESSION).get(defect)
        assert int(got) == (0 if bit is None else 1 << bit)


# -- mesh ----------------------------------------------------------------------

def _mesh_words(defect, c, seed, paired):
    rng = np.random.default_rng(seed)
    n = N_
    cand_sub = _u32(rng.integers(0, 1 << c, n))
    sub = rng.random(n) < 0.9
    sub_all = np.where(sub, (1 << c) - 1, 0).astype(np.uint32)
    ok = cand_sub & sub_all
    mesh = ok & _u32(rng.integers(0, 1 << c, n))
    backoff = np.where(rng.random((c, n)) < 0.3,
                       rng.integers(1, 9, (c, n)), 0).astype(np.int16)
    bits = ((mesh[None] >> np.arange(c, dtype=np.uint32)[:, None]) & 1) != 0
    backoff[bits] = 0                                # no clash yet
    attacker = rng.random(n) < 0.2
    honest = np.where(attacker, 0, (1 << c) - 1).astype(np.uint32)
    mesh_b = backoff_b = None
    if paired:
        mesh_b = ok & ~mesh & _u32(rng.integers(0, 1 << c, n))
        backoff_b = np.zeros((c, n), np.int16)
    side = "b" if defect.endswith("_b") else "a"
    kind = defect.removesuffix("_b")
    tgt_mesh, tgt_bo = (mesh, backoff) if side == "a" else (mesh_b,
                                                            backoff_b)
    if kind == "stray":
        p = int(np.flatnonzero(ok != (1 << c) - 1)[0])
        free = int((~ok[p]) & ((1 << c) - 1))
        tgt_mesh[p] |= free & -free
    elif kind in ("clash", "clash_attacker"):
        want = attacker if kind == "clash_attacker" else ~attacker
        p = int(np.flatnonzero(want & (ok != 0))[0])
        e = (int(ok[p]) & -int(ok[p])).bit_length() - 1
        tgt_mesh[p] |= 1 << e
        tgt_bo[e, p] = 3
    return dict(mesh=mesh, backoff=backoff, cand_sub=cand_sub,
                sub_all=sub_all, honest=honest, mesh_b=mesh_b,
                backoff_b=backoff_b)


MESH_DEFECTS = ["none", "stray", "clash", "clash_attacker", "stray_b",
                "clash_b", "clash_attacker_b"]


@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("defect", MESH_DEFECTS)
@pytest.mark.parametrize("bypass", [False, True])
@pytest.mark.parametrize("group", [0, 2])
def test_mesh_bits_match_reference(ref, c, defect, bypass, group):
    paired = defect.endswith("_b")
    w = _mesh_words(defect, c, seed=c + len(defect), paired=paired)
    p_cfg, r_cfg = _both(ref, GROUPS[group])
    keys = ("mesh_new", "backoff_new", "cand_sub_bits", "sub_all",
            "honest_all", "mesh_b_new", "backoff_b_new")
    vals = (w["mesh"], w["backoff"], w["cand_sub"], w["sub_all"],
            w["honest"] if bypass else None, w["mesh_b"], w["backoff_b"])
    got = piv.gossip_mesh_violations(
        p_cfg, c, **{k: None if v is None else _t(v)
                     for k, v in zip(keys, vals)})
    want = ref.iv.gossip_mesh_violations(
        r_cfg, c, **{k: _j(v) for k, v in zip(keys, vals)})
    assert int(got) == int(want)
    kind = defect.removesuffix("_b")
    expect = {"none": 0, "stray": 1 << piv.MESH_SUB,
              "clash": 1 << piv.MESH_BACKOFF,
              "clash_attacker": 0 if bypass else 1 << piv.MESH_BACKOFF}[kind]
    assert int(got) == (expect if group == 0 else 0)


# -- scores --------------------------------------------------------------------

def _score_state(mod, dtype, cdt_name, arrays):
    """A ScoreState of ``mod`` (the port's or the reference's) from numpy
    counters (f32 values, stored in ``cdt_name``)."""
    if mod is pgs:
        cdt = torch.bfloat16 if cdt_name == "bfloat16" else torch.float32
        f = {k: (None if v is None else
                 torch.from_numpy(v).to(cdt) if v.dtype == np.float32
                 else torch.from_numpy(v)) for k, v in arrays.items()}
        return pgs.ScoreState(**f)
    import jax.numpy as jnp
    cdt = jnp.bfloat16 if cdt_name == "bfloat16" else jnp.float32
    f = {k: (None if v is None else
             jnp.asarray(v).astype(cdt) if v.dtype == np.float32
             else jnp.asarray(v)) for k, v in arrays.items()}
    z = jnp.zeros_like(f["first_deliveries"])
    return mod.ScoreState(mesh_deliveries=z, mesh_failure_penalty=z, **f)


SCORE_DEFECTS = ["none", "p1_stray", "p1_stray_b", "fd_neg", "inv_neg",
                 "bp_neg", "cap_step", "cap_over"]


@pytest.mark.parametrize("cap", [64.0, 100.0])
@pytest.mark.parametrize("cdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("defect", SCORE_DEFECTS)
def test_score_bits_match_reference(ref, cap, cdt, defect):
    """P2 at one bf16 rounding step above the cap (64.5 for cap 64, which
    is cap · (1 + 2**-7) exactly; 100.5 for cap 100) is inside the slack;
    the next value up (65, 101) is out, in both packages."""
    c, n = 8, N_
    rng = np.random.default_rng(len(defect))
    mesh = _u32(rng.integers(0, 1 << c, n))
    mesh_b = _u32(rng.integers(0, 1 << c, n)) & ~mesh
    in_mesh = ((mesh[None] >> np.arange(c, dtype=np.uint32)[:, None])
               & 1) != 0
    in_b = ((mesh_b[None] >> np.arange(c, dtype=np.uint32)[:, None])
            & 1) != 0
    tim = np.where(in_mesh, rng.integers(1, 50, (c, n)), 0).astype(np.int16)
    tim_b = np.where(in_b, rng.integers(1, 50, (c, n)), 0).astype(np.int16)
    fd = rng.integers(0, int(cap), (c, n)).astype(np.float32)
    inv = (rng.integers(0, 8, (c, n)) * 0.5).astype(np.float32)
    bp = (rng.integers(0, 8, (c, n)) * 0.25).astype(np.float32)
    step = {64.0: 64.5, 100.0: 100.5}[cap]
    over = {64.0: 65.0, 100.0: 101.0}[cap]
    if defect == "p1_stray":
        tim[np.argwhere(~in_mesh)[0][0], np.argwhere(~in_mesh)[0][1]] = 3
    elif defect == "p1_stray_b":
        i, j = np.argwhere(~in_b)[0]
        tim_b[i, j] = 3
    elif defect == "fd_neg":
        fd[2, 9] = -1.0
    elif defect == "inv_neg":
        inv[1, 3] = -0.5
    elif defect == "bp_neg":
        bp[0, 4] = -0.25
    elif defect == "cap_step":
        fd[3, 11] = step
    elif defect == "cap_over":
        fd[3, 11] = over
    arrays = dict(time_in_mesh=tim, first_deliveries=fd,
                  invalid_deliveries=inv, behaviour_penalty=bp,
                  time_in_mesh_b=tim_b)
    sc_p = pgs.ScoreSimConfig(first_message_deliveries_cap=cap,
                              counter_dtype=cdt)
    sc_r = ref.gs.ScoreSimConfig(first_message_deliveries_cap=cap,
                                 counter_dtype=cdt)
    got = piv.gossip_score_violations(
        piv.InvariantConfig(), sc_p, _score_state(pgs, None, cdt, arrays),
        mesh_new=_t(mesh), mesh_b_new=_t(mesh_b))
    want = ref.iv.gossip_score_violations(
        ref.iv.InvariantConfig(), sc_r,
        _score_state(ref.gs, None, cdt, arrays), mesh_new=_j(mesh),
        mesh_b_new=_j(mesh_b))
    assert int(got) == int(want)
    expect = {"none": 0, "cap_step": 0,
              "p1_stray": 1 << piv.SCORE_P1_OFF_MESH,
              "p1_stray_b": 1 << piv.SCORE_P1_OFF_MESH}.get(
        defect, 1 << piv.SCORE_RANGE)
    assert int(got) == expect
    off = piv.gossip_score_violations(
        piv.InvariantConfig(scores=False), sc_p,
        _score_state(pgs, None, cdt, arrays), mesh_new=_t(mesh),
        mesh_b_new=_t(mesh_b))
    assert int(off) == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cap_comparison_reads_the_counters_as_float32(dtype):
    """The P2 cap comparison on stored counters (``_above``, no f32 copy)
    equals comparing their f32 values, thresholds of either sign, at and
    around each counter value (torch alone rounds the threshold to a bf16
    tensor's dtype: 101 > 100.78125 reads False there)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(0, 80, 4096).astype(np.float32)).to(
        dtype)
    xs = x.to(torch.float32).numpy()
    caps = np.concatenate([xs[:64], np.nextafter(xs[:64], np.inf),
                           np.nextafter(xs[:64], -np.inf),
                           rng.normal(0, 80, 64), [100.78125, 64.5, 0.0]]
                          ).astype(np.float32)
    for cap in caps:
        want = x.to(torch.float32) > float(cap)
        assert torch.equal(piv._above(x, float(cap)), want), cap
    assert not bool(torch.tensor([101.0], dtype=torch.bfloat16)
                    > 100.78125)


# -- the carry -----------------------------------------------------------------

def _small_sim(ref, n=240, t=2, m=8, seed=0, sched=None, subs=None,
               origin=None):
    """The reference test's ``build`` (n 240, 2 topics, C = 16, scored),
    for both packages."""
    offsets = ref.gs.make_gossip_offsets(t, 16, n, seed=1)
    if subs is None:
        subs = np.zeros((n, t), dtype=bool)
        subs[np.arange(n), np.arange(n) % t] = True
    rng = np.random.default_rng(seed)
    topic = rng.integers(0, t, m)
    if origin is None:
        origin = rng.integers(0, n // t, m) * t + topic
    ticks = rng.integers(0, 10, m).astype(np.int32)
    sims = []
    for mod, extra in ((ref.gs, {}), (pgs, {"device": "cpu"})):
        cfg = mod.GossipSimConfig(offsets=offsets, n_topics=t)
        sc = mod.ScoreSimConfig()
        kw = dict(extra)
        if sched is not None:
            kw["fault_schedule"] = sched[mod is pgs]
        sims.append((cfg, sc, *mod.make_gossip_sim(
            cfg, subs, topic, origin, ticks, seed=seed, score_cfg=sc,
            **kw)))
    return sims


def test_attach_fold_report_match_reference(ref):
    import jax.numpy as jnp

    sim_r, sim_p = _small_sim(ref)
    s_p = piv.attach(sim_p[3])
    s_r = ref.iv.attach(sim_r[3])
    assert s_p.inv_viol.dtype == torch.int32 and s_p.inv_viol.shape == ()
    assert int(s_p.inv_viol) == 0 and int(s_p.inv_first) == -1
    _assert_tree_equal(tree_to_numpy(s_r), convert.state_to_numpy(s_p),
                       "armed")
    assert piv.report(s_p) == ref.iv.report(s_r)
    # a sequence of ticks' bits, folded in both packages
    v_p, f_p = s_p.inv_viol, s_p.inv_first
    v_r, f_r = s_r.inv_viol, s_r.inv_first
    for tick, bits in ((0, 0), (1, 0), (2, 8), (3, 0), (4, 65), (5, 2)):
        v_p, f_p = piv.fold(v_p, f_p, torch.tensor(bits, dtype=torch.int32),
                            tick)
        v_r, f_r = ref.iv.fold(v_r, f_r, jnp.uint32(bits), tick)
        assert (int(v_p), int(f_p)) == (int(v_r), int(f_r))
    rep = piv.report(dataclasses.replace(s_p, inv_viol=v_p, inv_first=f_p))
    assert rep == ref.iv.report(s_r.replace(inv_viol=v_r, inv_first=f_r))
    assert rep == {"violations": ["delivery-down", "delivery-invalid",
                                  "mesh-subscription", "score-range"],
                   "bits": 75, "first_tick": 2}
    # bit 31 reads back unsigned, as the reference's u32 does
    top = dataclasses.replace(
        s_p, inv_viol=torch.tensor(-(1 << 31), dtype=torch.int32))
    assert piv.report(top)["bits"] == 1 << 31
    # convert carries the two scalars both ways, u32 unsigned
    back = convert.state_from_numpy(convert.state_to_numpy(top),
                                    sim_p[1], "cpu")
    assert int(back.inv_viol) == -(1 << 31)
    assert convert.state_to_numpy(top)["inv_viol"] == np.uint32(1 << 31)


def test_unarmed_state_raises_the_reference_error(ref):
    sim_r, sim_p = _small_sim(ref)
    msgs = []
    for fn in (lambda: ref.iv.require_armed(sim_r[3], "gossipsub"),
               lambda: piv.require_armed(sim_p[3], "gossipsub")):
        with pytest.raises(ValueError) as err:
            fn()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    cfg, sc, p, s = sim_p
    step = pgs.make_gossip_step(cfg, sc, device="cpu",
                                invariants=piv.InvariantConfig())
    with pytest.raises(ValueError) as err:
        step(p, s)
    assert str(err.value) == msgs[0]


def test_armed_state_without_the_checker_keeps_its_carry(ref):
    """A step built without the checker carries an armed state's two
    scalars through unchanged, as the reference's does."""
    sim_r, sim_p = _small_sim(ref)
    cfg, sc, p, s = sim_p
    s = dataclasses.replace(
        piv.attach(s), inv_viol=torch.tensor(8, dtype=torch.int32),
        inv_first=torch.tensor(3, dtype=torch.int32))
    out = pgs.gossip_run(p, s, 4, pgs.make_gossip_step(cfg, sc,
                                                       device="cpu"),
                         device="cpu")
    assert (int(out.inv_viol), int(out.inv_first)) == (8, 3)


# -- the reference's seeded defects ----------------------------------------------

def _forged_mesh_sims(ref):
    """tests/test_invariants.py test_seeded_mesh_defect_fires: peer 7
    subscribes nothing, and the peer whose candidate 0 is 7 holds a forged
    mesh bit to it; the gates refreshed."""
    n = 240
    subs = np.zeros((n, 2), dtype=bool)
    subs[np.arange(n), np.arange(n) % 2] = True
    subs[7] = False
    rng = np.random.default_rng(0)
    topic = rng.integers(0, 2, 8)
    origin = rng.integers(0, n // 2, 8) * 2 + topic
    origin = np.where(origin == 7, (origin + 2) % n, origin)
    topic = (origin % 2).astype(topic.dtype)
    ticks = rng.integers(0, 5, 8).astype(np.int32)
    offsets = ref.gs.make_gossip_offsets(2, 16, n, seed=1)
    victim = (7 - int(offsets[0])) % n
    mesh = np.zeros(n, dtype=np.uint32)
    mesh[victim] = 1
    sims = []
    for mod, extra in ((ref.gs, {}), (pgs, {"device": "cpu"})):
        cfg = mod.GossipSimConfig(offsets=offsets, n_topics=2)
        sc = mod.ScoreSimConfig()
        p, s = mod.make_gossip_sim(cfg, subs, topic, origin, ticks,
                                   score_cfg=sc, **extra)
        if mod is pgs:
            s = dataclasses.replace(s, mesh=_t(mesh))
        else:
            s = s.replace(mesh=_j(mesh))
        sims.append((cfg, sc, p, mod.refresh_gates(cfg, sc, p, s)))
    return sims


@pytest.mark.parametrize("group", range(len(GROUPS)))
def test_seeded_mesh_defect_fires_as_in_reference(ref, group):
    import jax

    sim_r, sim_p = _forged_mesh_sims(ref)
    p_cfg, r_cfg = _both(ref, GROUPS[group])
    out_r = ref.gs.gossip_run(sim_r[2], ref.iv.attach(sim_r[3]), 3,
                              jax.jit(ref.gs.make_gossip_step(
                                  sim_r[0], sim_r[1], invariants=r_cfg)))
    out_p = pgs.gossip_run(sim_p[2], piv.attach(sim_p[3]), 3,
                           pgs.make_gossip_step(sim_p[0], sim_p[1],
                                                device="cpu",
                                                invariants=p_cfg),
                           device="cpu")
    rep = piv.report(out_p)
    assert rep == ref.iv.report(out_r)
    _assert_tree_equal(tree_to_numpy(out_r), convert.state_to_numpy(out_p),
                       "end state")
    if GROUPS[group].get("mesh", True):
        assert "mesh-subscription" in rep["violations"]
        assert rep["first_tick"] == 0
    else:
        assert "mesh-subscription" not in rep["violations"]


def test_seeded_broken_step_fires_delivery_bits_as_in_reference(ref):
    """tests/test_invariants.py test_seeded_broken_step_fires_delivery_
    bits: a step wrapper delivers a copy at down peer 5 and, from tick 3,
    drops every origin's own copy; the delivery bits fold as in-step."""
    import jax.numpy as jnp

    n = 240
    sched_kw = dict(n_peers=n, horizon=40, down_intervals=[(5, 0, 30)])
    sim_r, sim_p = _small_sim(ref, sched=(
        ref.faults.FaultSchedule(**sched_kw),
        pfl.FaultSchedule(**sched_kw)))

    def broken_ref(params, state, base, icfg):
        s2, delivered = base(params, state)
        bad = np.zeros((delivered.shape[0], n), dtype=np.uint32)
        bad[0, 5] = 1
        delivered = delivered | jnp.asarray(bad)
        drop = jnp.where(state.tick >= 3, params.origin_words & state.have,
                         jnp.uint32(0))
        s2 = s2.replace(have=s2.have & ~drop)
        aw = ref.faults.alive_word(ref.faults.alive_mask(params.faults,
                                                         state.tick))
        bits = ref.iv.delivery_violations(
            icfg, state.have, s2.have, delivered, alive_w=aw,
            invalid_words=params.invalid_words)
        viol, first = ref.iv.fold(state.inv_viol, state.inv_first, bits,
                                  state.tick)
        return s2.replace(inv_viol=viol, inv_first=first), delivered

    def broken_port(params, state, base, icfg):
        s2, delivered = base(params, state)
        bad = torch.zeros_like(delivered)
        bad[0, 5] = 1
        delivered = delivered | bad
        drop = (params.origin_words & state.have if state.tick >= 3
                else torch.zeros_like(state.have))
        s2 = dataclasses.replace(s2, have=s2.have & ~drop)
        aw = pfl.alive_word(pfl.alive_mask(params.faults, state.tick))
        bits = piv.delivery_violations(
            icfg, state.have, s2.have, delivered, alive_w=aw,
            invalid_words=params.invalid_words)
        viol, first = piv.fold(state.inv_viol, state.inv_first, bits,
                               state.tick)
        return (dataclasses.replace(s2, inv_viol=viol, inv_first=first),
                delivered)

    import jax

    base_r = jax.jit(ref.gs.make_gossip_step(sim_r[0], sim_r[1]))
    base_p = pgs.make_gossip_step(sim_p[0], sim_p[1], device="cpu")
    s_r, s_p = ref.iv.attach(sim_r[3]), piv.attach(sim_p[3])
    for _ in range(14):
        s_r = broken_ref(sim_r[2], s_r, base_r, ref.iv.InvariantConfig())[0]
        s_p = broken_port(sim_p[2], s_p, base_p, piv.InvariantConfig())[0]
    rep = piv.report(s_p)
    assert rep == ref.iv.report(s_r)
    assert "delivery-down" in rep["violations"]
    assert "possession-regression" in rep["violations"]
    assert rep["first_tick"] >= 0


def test_padded_reference_equals_unpadded_and_the_port(ref):
    """At 512 peers (a multiple of 128) the reference's sim built with
    ``pad_to_block=128`` and stepped armed on its kernel path (interpret
    mode, ``receive_block=128``) equals its unpadded XLA run and the port's
    armed unpadded run, state and report, for 8 ticks under a cold-restart
    schedule (the reference's ``test_invariants_kernel_path_interpret``)."""
    import jax

    n, t, m = 512, 2, 8
    offsets = ref.gs.make_gossip_offsets(t, 16, n, seed=1)
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    rng = np.random.default_rng(0)
    topic = rng.integers(0, t, m)
    origin = rng.integers(0, n // t, m) * t + topic
    ticks = rng.integers(0, 5, m).astype(np.int32)
    sched_kw = dict(n_peers=n, horizon=20, down_intervals=[(3, 1, 6)],
                    cold_restart=True)
    args = (subs, topic, origin, ticks)
    cfg_r = ref.gs.GossipSimConfig(offsets=offsets, n_topics=t)
    sc_r = ref.gs.ScoreSimConfig()
    icfg = ref.iv.InvariantConfig()
    runs = {}
    for pad in (128, None):
        p, s = ref.gs.make_gossip_sim(
            cfg_r, *args, score_cfg=sc_r, pad_to_block=pad,
            fault_schedule=ref.faults.FaultSchedule(**sched_kw))
        kw = (dict(receive_block=128, receive_interpret=True) if pad
              else {})
        step = ref.gs.make_gossip_step(cfg_r, sc_r, invariants=icfg, **kw)
        out = ref.gs.gossip_run(p, ref.iv.attach(s), 8,
                                step if pad else jax.jit(step))
        runs[pad] = (p, out)
    (p_pad, s_pad), (p_un, s_un) = runs[128], runs[None]
    assert p_pad.n_true == n and p_un.n_true is None
    _assert_tree_equal(tree_to_numpy(s_un), tree_to_numpy(s_pad), "padded")
    cfg_p = pgs.GossipSimConfig(offsets=offsets, n_topics=t)
    sc_p = pgs.ScoreSimConfig()
    p, s = pgs.make_gossip_sim(cfg_p, *args, score_cfg=sc_p, device="cpu",
                               fault_schedule=pfl.FaultSchedule(**sched_kw))
    out = pgs.gossip_run(p, piv.attach(s), 8, pgs.make_gossip_step(
        cfg_p, sc_p, device="cpu", invariants=piv.InvariantConfig()),
        device="cpu")
    _assert_tree_equal(tree_to_numpy(s_pad), convert.state_to_numpy(out),
                       "port")
    assert piv.report(out) == ref.iv.report(s_pad) == {
        "violations": [], "bits": 0, "first_tick": -1}


def _trim(tree: dict, n: int, n_pad: int) -> dict:
    """A padded sim's leaves cut to the true peers: every axis of the
    padded ring length keeps its first ``n`` lanes."""
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out[name] = _trim(v, n, n_pad)
        elif isinstance(v, list):
            out[name] = [g[..., :n] if g.shape[-1] == n_pad else g
                         for g in v]
        elif isinstance(v, np.ndarray) and v.ndim and v.shape[-1] == n_pad:
            out[name] = v[..., :n]
        else:
            out[name] = v
    return out


def test_padded_reference_at_a_ragged_size_equals_unpadded_and_the_port(
        ref):
    """At 1,000 peers (not a multiple of 128: the reference pads to 1,024)
    the trace-export benchmark's sim — scored, two invalid messages from
    sybil origins, down intervals and 2% link loss — built with
    ``pad_to_block=128`` and stepped on the reference's kernel path
    (``receive_block=128``, interpret mode) for 6 ticks equals, on the
    true peers and leaf for leaf, its unpadded XLA run and the port's
    unpadded run: the ground for running the benchmark unpadded."""
    import jax

    n, t, m = 1_000, 20, 16
    offsets = ref.gs.make_gossip_offsets(t, 16, n, seed=0)
    rng = np.random.default_rng(0)
    topic = rng.integers(0, t, m)
    origin = rng.integers(0, n // t, m) * t + topic
    ticks = np.sort(rng.integers(0, 4, m)).astype(np.int32)
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    invalid = np.zeros(m, dtype=bool)
    invalid[:2] = True
    sybil = np.zeros(n, dtype=bool)
    sybil[origin[:2]] = True
    victims = np.flatnonzero(rng.random(n) < 0.02)
    sched_kw = dict(n_peers=n, horizon=6, drop_prob=0.02, seed=1,
                    down_intervals=[(int(p), 1 + int(p % 2), 4 + int(p % 2))
                                    for p in victims])
    args = (subs, topic, origin, ticks)
    kw = dict(sybil=sybil, msg_invalid=invalid)
    cfg_r = ref.gs.GossipSimConfig(offsets=offsets, n_topics=t)
    sc_r = ref.gs.ScoreSimConfig()
    runs = {}
    for pad in (128, None):
        p, s = ref.gs.make_gossip_sim(
            cfg_r, *args, score_cfg=sc_r, pad_to_block=pad, **kw,
            fault_schedule=ref.faults.FaultSchedule(**sched_kw))
        step = (ref.gs.make_gossip_step(cfg_r, sc_r, receive_block=128,
                                        receive_interpret=True) if pad
                else jax.jit(ref.gs.make_gossip_step(
                    cfg_r, sc_r, use_pallas_receive=False)))
        runs[pad] = (p, ref.gs.gossip_run(p, s, 6, step))
    (p_pad, s_pad), (p_un, s_un) = runs[128], runs[None]
    n_pad = int(np.asarray(s_pad.mesh).shape[-1])
    assert p_pad.n_true == n and n_pad == 1_024 and p_un.n_true is None
    want = tree_to_numpy(s_un)
    _assert_tree_equal(want, _trim(tree_to_numpy(s_pad), n, n_pad),
                       "padded")
    cfg_p = pgs.GossipSimConfig(offsets=offsets, n_topics=t)
    sc_p = pgs.ScoreSimConfig()
    p, s = pgs.make_gossip_sim(cfg_p, *args, score_cfg=sc_p, device="cpu",
                               fault_schedule=pfl.FaultSchedule(**sched_kw),
                               **kw)
    out = pgs.gossip_run(p, s, 6, pgs.make_gossip_step(cfg_p, sc_p,
                                                       device="cpu"),
                         device="cpu")
    _assert_tree_equal(want, convert.state_to_numpy(out), "port")
    assert (np.asarray(s_un.have) != 0).any()
