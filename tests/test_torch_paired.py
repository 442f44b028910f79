"""The port's paired-topic overlays against the JAX reference: every peer
subscribed to its residue class r and to r + T/2, one mesh, backoff and
P1 per topic slot, the scores summed under TopicScoreCap.

Same config, same seeded inputs (numpy), handed to both packages, at the
shapes of the reference's own paired kernel tests
(``tests/test_pallas_receive.py`` ``_build_paired``: T = 4, C = 8, 928
peers) and one C = 16 case: the sims must build leaf-identical (the
slot-B words, the slot-B mesh, backoff and time in mesh, the eighth or
third gate row), the conversion must round-trip them, and the port's
step (CPU, plain kernel versions) must match the reference's unpadded
XLA step on EVERY state leaf, tick by tick, for 30 ticks, scored,
unscored, under both gossip-repair attacks and with every option of the
full variant.  The plain paired receive must equal the reference's
Pallas kernel in interpret mode on seeded random operands.  Tolerance:
exact (packed words and integer counters bitwise, f32/bf16 leaves by bit
pattern; no exception).
"""

import dataclasses

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import plan
from go_libp2p_pubsub_tpu_torch.ops import graph as pg
from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as prc
from test_torch_gossipsub import _assert_tree_equal
from test_torch_receive import BLOCK, N, _bits, _np, _operands
from test_torch_surface import _sibling_words
from test_torch_unscored import unscored_operands
from torch_ref import imported_reference, tree_to_numpy

T = 4
SMALL = dict(d=3, d_lo=2, d_hi=6, d_score=2, d_out=1, d_lazy=2,
             gossip_factor=0.25, backoff_ticks=8)


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        yield r


#: the reference's _build_paired options; m = 40 messages give W = 2
CASES = {
    "scored": dict(),
    "unscored": dict(score=False),
    "spam": dict(sybil_frac=0.15, sc=dict(sybil_ihave_spam=True,
                                           sybil_iwant_spam=True)),
    # every option of the full variant at once
    "everything": dict(sybil_frac=0.15, invalid_frac=0.25, px=7,
                       direct=True, shared_ip=True,
                       sc=dict(sybil_ihave_spam=True, sybil_iwant_spam=True,
                               flood_publish=True)),
    "scored_c16": dict(c=16),
}


def _inputs(ref, case, m, seed=2):
    """(cfg kwargs, sim args, sim kwargs, score kwargs) of a case, in the
    reference test's draw order."""
    n, c = 928, case.get("c", 8)
    rng = np.random.default_rng(seed)
    offsets = ref.gs.make_gossip_offsets(T, c, n, seed=seed, paired=True)
    cfg_kw = dict(SMALL if c == 8 else {}, offsets=offsets, n_topics=T,
                  paired_topics=True)
    own = np.arange(n) % T
    second = (own + T // 2) % T
    subs = np.zeros((n, T), dtype=bool)
    subs[np.arange(n), own] = True
    subs[np.arange(n), second] = True
    topic = rng.integers(0, T, m)
    members = [np.flatnonzero((own == tau) | (second == tau))
               for tau in range(T)]
    origin = np.array([rng.choice(members[tau]) for tau in topic])
    ticks = np.sort(rng.integers(0, 12, m)).astype(np.int32)
    kw = {}
    if case.get("score", True):
        sybil = rng.random(n) < case.get("sybil_frac", 0.0)
        kw = dict(sybil=sybil,
                  msg_invalid=rng.random(m) < case.get("invalid_frac", 0.0),
                  app_score=rng.normal(0, 0.1, n).astype(np.float32))
        if case.get("shared_ip"):
            ip = np.arange(n)
            sid = np.flatnonzero(sybil)
            ip[sid] = n + np.arange(len(sid)) // 2
            kw["peer_ip"] = ip
    if case.get("direct"):
        cinv0 = offsets.index(-offsets[0])
        f = (np.arange(n) % 29) == 0
        de = np.zeros((n, c), dtype=bool)
        for c_ in (0, cinv0):
            de[:, c_] = f | np.roll(f, -int(offsets[c_]))
        kw["direct_edges"] = de
    if case.get("px") is not None:
        kw["px_candidates"] = case["px"]
    sc_kw = dict(topic_score_cap=25.0, **case.get("sc", {}))
    return cfg_kw, (subs, topic, origin, ticks), kw, sc_kw


def _build(ref, name, m=10, seed=2):
    case = CASES[name]
    cfg_kw, args, kw, sc_kw = _inputs(ref, case, m, seed)
    cfg_r = ref.gs.GossipSimConfig(**cfg_kw)
    cfg_p = pgs.GossipSimConfig(**cfg_kw)
    scored = case.get("score", True)
    sc_r = ref.gs.ScoreSimConfig(**sc_kw) if scored else None
    sc_p = pgs.ScoreSimConfig(**sc_kw) if scored else None
    ref_sim = ref.gs.make_gossip_sim(cfg_r, *args, seed=seed,
                                     score_cfg=sc_r, **kw)
    port_sim = pgs.make_gossip_sim(cfg_p, *args, seed=seed, score_cfg=sc_p,
                                   device="cpu", **kw)
    return (cfg_r, sc_r, *ref_sim), (cfg_p, sc_p, *port_sim)


def _odd_bits(cfg) -> int:
    """Candidate bits whose offset is an odd multiple of T/2."""
    return sum(1 << c for c, o in enumerate(cfg.offsets)
               if o % cfg.n_topics)


@pytest.mark.parametrize("name", ["scored", "unscored", "everything"])
def test_sim_build_matches_reference(ref, name):
    (_, sc_r, p_r, s_r), (_, _, p_p, s_p) = _build(ref, name)
    p_np, s_np = tree_to_numpy(p_r), tree_to_numpy(s_r)
    _assert_tree_equal(p_np, convert.params_to_numpy(p_p), "params")
    _assert_tree_equal(s_np, convert.state_to_numpy(s_p), "state")
    assert p_np["slot_b_words"] is not None
    assert s_np["mesh_b"] is not None and s_np["backoff_b"] is not None
    assert len(s_p.gates) == (8 if sc_r is not None else 3)
    assert (s_p.scores is None) == (sc_r is None)
    if sc_r is not None:
        assert s_np["scores"]["time_in_mesh_b"] is not None
    # both slots' messages are delivered at every subscribed peer
    assert bool((p_p.deliver_words & p_p.slot_b_words).any())
    assert bool((p_p.deliver_words & ~p_p.slot_b_words).any())


@pytest.mark.parametrize("name", ["unscored", "everything"])
def test_convert_round_trips_the_paired_fields(ref, name):
    (_, _, p_r, s_r), (_, sc_p, p_p, s_p) = _build(ref, name, seed=4)
    p_np, s_np = tree_to_numpy(p_r), tree_to_numpy(s_r)
    p2 = convert.params_from_numpy(p_np, "cpu")
    s2 = convert.state_from_numpy(s_np, sc_p, "cpu")
    _assert_tree_equal(p_np, convert.params_to_numpy(p2), "params")
    _assert_tree_equal(s_np, convert.state_to_numpy(s2), "state")
    assert torch.equal(p2.slot_b_words, p_p.slot_b_words)
    assert torch.equal(s2.mesh_b, s_p.mesh_b)
    assert torch.equal(s2.backoff_b, s_p.backoff_b)
    if sc_p is not None:
        assert torch.equal(s2.scores.time_in_mesh_b,
                           s_p.scores.time_in_mesh_b)


STEP_CASES = [(name, m) for name in ("scored", "unscored", "spam",
                                     "everything") for m in (10, 40)]
STEP_CASES.append(("scored_c16", 10))


@pytest.mark.parametrize("name,m", STEP_CASES)
def test_step_matches_reference_30_ticks(ref, name, m):
    import jax

    (cfg_r, sc_r, p_r, s_r), (cfg_p, sc_p, p_p, s_p) = _build(ref, name, m)
    assert p_p.origin_words.shape[0] == (m + 31) // 32
    step_r = jax.jit(ref.gs.make_gossip_step(cfg_r, sc_r))
    step_p = pgs.make_gossip_step(cfg_p, sc_p, device="cpu")
    odd = _odd_bits(cfg_p)
    grafted_b = odd_meshed = 0
    for t in range(30):
        mesh_b0 = s_p.mesh_b
        s_r, d_r = step_r(p_r, s_r)
        s_p, d_p = step_p(p_p, s_p)
        _assert_tree_equal(tree_to_numpy(s_r), convert.state_to_numpy(s_p),
                           f"tick {t}")
        np.testing.assert_array_equal(d_p.numpy().view(np.uint32),
                                      np.asarray(d_r), err_msg=f"tick {t}")
        grafted_b += int(((s_p.mesh_b & ~mesh_b0) != 0).sum())
        odd_meshed += int((((s_p.mesh | s_p.mesh_b) & odd) != 0).sum())
    # non-vacuous: both meshes formed, slot B grafted, the cross-slot
    # routing carried odd edges into meshes, messages moved
    assert odd > 0 and grafted_b > 0 and odd_meshed > 0
    assert int(pgs.mesh_degrees(s_p).max()) >= cfg_p.d
    assert int(pg.popcount32(s_p.mesh_b).max()) >= cfg_p.d
    assert np.asarray(s_r.have).any()
    if sc_p is not None:
        assert int(s_p.scores.time_in_mesh_b.max()) > 0
    if name == "everything":
        assert p_p.cand_direct.any() and p_p.cand_same_ip is not None
        assert not ((s_p.mesh | s_p.mesh_b) & p_p.cand_direct).any()


def test_reference_paired_checks_hold_on_the_port():
    """tests/test_gossipsub_paired.py's checks, on the port alone: every
    topic reaches both its residue classes, two bounded and distinct
    meshes, P1 on both, and a mesh edge in my slot X appears in the
    partner's matching slot (the cross-slot handshake routing)."""
    n, t, c, m = 600, 4, 8, 12
    cfg = pgs.GossipSimConfig(
        offsets=pgs.make_gossip_offsets(t, c, n, seed=2, paired=True),
        n_topics=t, paired_topics=True, d=3, d_lo=2, d_hi=6, d_score=2,
        d_out=1, d_lazy=2)
    rng = np.random.default_rng(2)
    own = np.arange(n) % t
    second = (own + t // 2) % t
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), own] = True
    subs[np.arange(n), second] = True
    topic = rng.integers(0, t, m)
    members = [np.flatnonzero((own == tau) | (second == tau))
               for tau in range(t)]
    origin = np.array([rng.choice(members[tau]) for tau in topic])
    ticks = np.sort(rng.integers(0, 10, m)).astype(np.int32)
    sc = pgs.ScoreSimConfig()
    params, state = pgs.make_gossip_sim(cfg, subs, topic, origin, ticks,
                                        score_cfg=sc, device="cpu")
    out = pgs.gossip_run(params, state, 40,
                         pgs.make_gossip_step(cfg, sc, device="cpu"),
                         device="cpu")
    assert (pgs.reach_counts(params, out).numpy() == n // 2).all()
    deg_a = pgs.mesh_degrees(out).double().mean().item()
    deg_b = pg.popcount32(out.mesh_b).double().mean().item()
    assert cfg.d_lo <= deg_a <= cfg.d_hi and cfg.d_lo <= deg_b <= cfg.d_hi
    mesh_a, mesh_b = out.mesh.numpy(), out.mesh_b.numpy()
    assert (mesh_a != mesh_b).mean() > 0.5
    assert int(out.scores.time_in_mesh.max()) > 5
    assert int(out.scores.time_in_mesh_b.max()) > 5
    agree = total = odd_edges = 0
    for c_, o in enumerate(cfg.offsets):
        even = (o % t) == 0
        odd_edges += int(not even)
        for mine_w, partner_w in ((mesh_a, mesh_a if even else mesh_b),
                                  (mesh_b, mesh_b if even else mesh_a)):
            mine = (mine_w >> c_) & 1
            partner = (np.roll(partner_w, -o) >> cfg.cinv[c_]) & 1
            agree += int((mine & partner).sum())
            total += int(mine.sum())
    assert odd_edges > 0 and total > 0
    assert agree / total > 0.95, agree / total


#: the plain paired receive against the Pallas kernel: scored alone, with
#: every other option of the full variant, and unscored (PX, exact-k)
RECEIVE = {
    "scored": dict(),
    "all_options": dict(flood_publish=True, exact_k=True, with_px=True,
                        with_same_ip=True, track_promises=True,
                        ihave_spam=True, iwant_spam=True),
    "unscored": dict(score=False),
    "unscored_options": dict(score=False, exact_k=True, with_px=True),
}


def _paired_operands(rng, ops, c, n, w_words, scored):
    """The paired variant's own operands beside ``ops``: a second ctrl
    byte with every slot-B flag, slot-B sender words and handshake
    words, the slot-B backoff and (scored) time in mesh."""
    def words(shape, bits=32):
        a = rng.integers(0, 1 << bits, size=shape, dtype=np.uint64)
        return torch.from_numpy(a.astype(np.uint32).view(np.int32))

    def sparse(shape, bits=32):
        return words(shape, bits) & words(shape, bits)

    out = dict(
        ctrl2=torch.from_numpy(rng.integers(0, 16, size=(c, n)).astype(
            np.uint8)),
        fresh_b=sparse((w_words, n)), wa_b=words((n,), c),
        grafts_b=sparse((n,), c), dropped_b=sparse((n,), c),
        meshsel_b=words((n,), c),
        backoff_b=torch.from_numpy(rng.integers(0, 61, size=(c, n)).astype(
            np.int16)))
    if scored:
        tim_b = rng.integers(0, 60, size=(c, n))
        tim_b[:, 40:80] = 32760 + rng.integers(0, 7, size=(c, 40))
        out.update(bo2_b=words((n,), c),
                   tim_b=torch.from_numpy(tim_b.astype(np.int16)))
    return dict(ops, **out)


@pytest.mark.parametrize("option,w_words", [
    ("scored", 1), ("all_options", 1), ("all_options", 2), ("unscored", 2),
    ("unscored_options", 1)])
def test_paired_receive_plain_matches_pallas_kernel(ref, option, w_words):
    import jax.numpy as jnp

    fl = dict(RECEIVE[option])
    scored = fl.pop("score", True)
    c = 16 if scored else 8
    offsets = ref.gs.make_gossip_offsets(T, c, N, seed=3, paired=True)
    cfg_kw = dict(offsets=offsets, n_topics=T, paired_topics=True,
                  binomial_gossip_sampling=not fl.get("exact_k", False),
                  d_lazy=2, **({k_: v for k_, v in SMALL.items()
                                if k_ not in ("d_lazy", "gossip_factor",
                                              "backoff_ticks")}
                               if c == 8 else {}))
    sc_kw = dict(topic_score_cap=25.0,
                 flood_publish=fl.get("flood_publish", False),
                 sybil_ihave_spam=fl.get("ihave_spam", False),
                 sybil_iwant_spam=fl.get("iwant_spam", False))
    cfg = ref.gs.GossipSimConfig(**cfg_kw)
    sc = ref.gs.ScoreSimConfig(**sc_kw) if scored else None
    k = prc.receive_consts(
        pgs.GossipSimConfig(**cfg_kw),
        pgs.ScoreSimConfig(**sc_kw) if scored else None,
        promise_break=fl.get("track_promises", False),
        px=fl.get("with_px", False), same_ip=fl.get("with_same_ip", False))
    assert k.paired and k.odd_mask == _odd_bits(cfg) and k.odd_mask
    rng = np.random.default_rng(500 + 10 * w_words + len(option))
    if scored:
        ops = _operands(rng, w_words, False, sc)
    else:
        ops = unscored_operands(rng, c, N, w_words)
    ops = _paired_operands(rng, ops, c, N, w_words, scored)
    if k.flood_publish:
        ops["ctrl"] = torch.from_numpy(
            rng.integers(0, 128, size=(c, N)).astype(np.uint8))
        ops["inj_send"] = (ops["fresh"] & ops["adv"]).contiguous()
    if k.with_same_ip:
        ops["same_ip"] = _sibling_words(rng)
    if k.attacks:
        ops["syb"] = torch.from_numpy(np.where(
            rng.random(N) < 0.2, (1 << c) - 1, 0).astype(np.int32))
        ops["iws"] = torch.from_numpy(rng.integers(
            0, 4 * 32 * w_words, size=(c, N)).astype(np.int16))
    got = prc.receive_update(k, **ops)        # CPU tensors: plain version

    rc = ref.receive
    pln = rc.plan(N, cfg.offsets, BLOCK)

    def flat(rows, p, e):
        return jnp.concatenate([
            rc.extend_wrap(jnp.asarray(r), N, pln["n_pad"], pln[p], pln[e])
            for r in rows])

    krn = rc.make_receive_update(
        cfg, sc, N, BLOCK, jnp.bfloat16 if scored else jnp.float32,
        w_words, track_promises=k.track_promises, interpret=True,
        with_static=False, with_px=k.with_px, with_same_ip=k.with_same_ip)
    head = ([jnp.asarray(_np(ops["valid"]))] if scored else []) + [
        jnp.asarray(np.array(ops["gseeds"], dtype=np.uint32)),
        jnp.zeros((1,), dtype=jnp.uint32)]
    flats = [flat(list(_np(ops["ctrl"])), "p8", "e8"),
             flat(list(_np(ops["ctrl2"])), "p8", "e8"),
             flat(list(_np(ops["fresh"])), "p32", "e32"),
             flat(list(_np(ops["fresh_b"])), "p32", "e32"),
             flat(list(_np(ops["adv"])), "p32", "e32")]
    if k.flood_publish:
        flats.append(flat(list(_np(ops["inj_send"])), "p32", "e32"))
    zero = np.zeros(N, dtype=np.uint32)
    syb = _np(ops["syb"]) if k.attacks else zero
    blocked = ([_np(ops[k_]) for k_ in ("pay", "gsp", "acc")]
               if scored else [])
    blocked += [_np(ops[k_]) for k_ in ("sub_all", "cand_sub", "fanout")]
    blocked += [syb, _np(ops["wa"]), _np(ops["bo2"]) if scored else zero]
    blocked += [_np(ops[k_]) for k_ in ("grafts", "dropped", "meshsel")]
    blocked += [_np(ops["wa_b"]), _np(ops["bo2_b"]) if scored else zero]
    blocked += [_np(ops[k_]) for k_ in ("grafts_b", "dropped_b",
                                         "meshsel_b", "seen", "injected",
                                         "backoff", "backoff_b")]
    if scored:
        blocked += [_np(ops[k_]) for k_ in ("fd", "inv", "bp", "tim",
                                             "tim_b", "iws")]
    if k.with_same_ip:
        blocked.append(_np(ops["same_ip"]))
    want = krn(*head, *flats, *[jnp.asarray(b) for b in blocked])
    names = ["acq", "mesh", "mesh_b", "backoff", "backoff_b"]
    names += ([f"gate{i}" for i in range(8)] if scored
              else ["g_targets", "g_backoff", "g_backoff_b"])
    if scored:
        names += ["fd", "inv", "bp", "tim", "tim_b", "iws"]
    if k.with_px:
        names.append("px_rot")
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(_bits(_np(g)), _bits(w), err_msg=name)
    # non-vacuous: the slot-B handshake moved the slot-B mesh, the slot-B
    # forward delivered, and the odd edges routed control across slots
    assert not torch.equal(got[2], ops["meshsel_b"])
    plain = dict(ops, ctrl2=torch.zeros_like(ops["ctrl2"]))
    assert not torch.equal(prc.receive_update(k, **plain)[0], got[0])
    same_slot = prc.receive_update(dataclasses.replace(k, odd_mask=0), **ops)
    assert not torch.equal(same_slot[1], got[1])


def _tiny_paired(c=16, **cfg_kw):
    n = 256
    cfg = pgs.GossipSimConfig(
        offsets=pgs.make_gossip_offsets(T, c, n, paired=True), n_topics=T,
        paired_topics=True, **cfg_kw)
    own = np.arange(n) % T
    subs = np.zeros((n, T), dtype=bool)
    subs[np.arange(n), own] = True
    subs[np.arange(n), (own + T // 2) % T] = True
    z = np.zeros(4, dtype=np.int64)
    return cfg, subs, (z, z, z.astype(np.int32))


def _validation_subs(case):
    cfg, subs, msgs = _tiny_paired()
    if case == "foreign_topic":
        subs[3, (3 + 1) % T] = True           # neither of peer 3's pair
    elif case == "half_pair":
        subs[5, (5 + T // 2) % T] = False     # only its own class
    else:                                      # the origin's pair lacks it
        msgs = (np.array([1, 1, 1, 1]), np.zeros(4, np.int64), msgs[2])
    return cfg, subs, msgs


@pytest.mark.parametrize("case,match", [
    ("foreign_topic", "may only subscribe"),
    ("half_pair", "both topics of the pair"),
    ("origin", "origin must subscribe")])
def test_paired_inputs_are_validated_as_the_reference_does(ref, case,
                                                           match):
    cfg, subs, msgs = _validation_subs(case)
    with pytest.raises(ValueError, match=match) as mine:
        pgs.make_gossip_sim(cfg, subs, *msgs, device="cpu")
    cfg_r = ref.gs.GossipSimConfig(offsets=cfg.offsets, n_topics=T,
                                   paired_topics=True)
    with pytest.raises(ValueError) as theirs:
        ref.gs.make_gossip_sim(cfg_r, subs, *msgs)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("case", ["wide", "track_p3", "force_split"])
def test_paired_step_needs_the_combined_path(ref, case):
    """The reference's ValueError, before any named refusal; a sim with
    more than 16 candidates is refused by name when it is built."""
    c = 20 if case == "wide" else 16
    cfg, subs, msgs = _tiny_paired(c=c)
    sc = pgs.ScoreSimConfig(
        mesh_message_deliveries_weight=-1.0 if case == "track_p3" else 0.0)
    with pytest.raises(ValueError) as mine:
        pgs.make_gossip_step(cfg, sc, device="cpu",
                             force_split=case == "force_split")
    cfg_r = ref.gs.GossipSimConfig(offsets=cfg.offsets, n_topics=T,
                                   paired_topics=True)
    sc_r = ref.gs.ScoreSimConfig(
        mesh_message_deliveries_weight=sc.mesh_message_deliveries_weight)
    with pytest.raises(ValueError) as theirs:
        ref.gs.make_gossip_step(cfg_r, sc_r,
                                force_split=case == "force_split")
    assert str(mine.value) == str(theirs.value) == plan.MSG_PAIRED_COMBINED
    if case == "wide":
        with pytest.raises(plan.SliceRefusal) as err:
            pgs.make_gossip_sim(cfg, subs, *msgs, device="cpu")
        assert err.value.name == "wide_candidates"


def test_fused_window_refuses_a_paired_sim():
    cfg, subs, msgs = _tiny_paired()
    params, state = pgs.make_gossip_sim(cfg, subs, *msgs, device="cpu")
    assert len(state.gates) == 3 and state.mesh_b is not None
    with pytest.raises(plan.SliceRefusal) as err:
        pgs.make_fused_window(cfg, None, device="cpu")
    assert err.value.name == "fused_paired"
    # the per-tick step runs it
    end = pgs.gossip_run(params, state, 2,
                         pgs.make_gossip_step(cfg, None, device="cpu"),
                         device="cpu")
    assert end.tick == 2 and len(end.gates) == 3
