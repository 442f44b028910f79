"""The port's adversarial scored GossipSub v1.1 heartbeat against the JAX
reference: IHAVE broken-promise spam, the IWANT flood, both at once,
stealthy promise breakers, graft flood and eclipse.

Same config, same seeded inputs (numpy), handed to both packages: the
sims must build leaf-identical, the conversion must round-trip the
attack fields, and the port's step (CPU, plain kernel versions) must
match the reference's unpadded XLA step on EVERY state leaf, tick by
tick, for 30 ticks.  The plain receive with each attack option must
equal the reference's Pallas kernel in interpret mode on seeded random
operands.  Tolerance: exact (f32/bf16 leaves compared by bit pattern).
"""

import dataclasses

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import adversarial, convert
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import plan
from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as prc
from test_torch_gossipsub import _assert_tree_equal
from test_torch_receive import BLOCK, C, NAMES, _bits, _np, _operands
from torch_ref import imported_reference, tree_to_numpy

N, T = 1024, 4
SMALL = dict(d=3, d_lo=2, d_hi=6, d_score=2, d_out=1, d_lazy=2)


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        yield r


CASES = {
    # IHAVE broken-promise spam beside invalid traffic
    "ihave_spam": dict(sybil=0.2, invalid=0.3,
                       sc=dict(sybil_ihave_spam=True)),
    # both gossip-repair attacks at once (the adversarial benchmark's)
    "both_spam": dict(sybil=0.2, invalid=0.3,
                      sc=dict(sybil_ihave_spam=True, sybil_iwant_spam=True)),
    "iwant_spam": dict(sybil=0.2, sc=dict(sybil_iwant_spam=True)),
    # both attacks at C = 8
    "both_spam_c8": dict(c=8, cfg=SMALL, sybil=0.2, invalid=0.3,
                         sc=dict(sybil_ihave_spam=True,
                                 sybil_iwant_spam=True)),
    # unflagged peers that withhold what they advertise
    "promise_breakers": dict(breakers=0.1),
    "graft_flood": dict(sybil=0.15, sc=dict(sybil_graft_flood=True)),
    "eclipse": dict(eclipse=True, cfg=dict(backoff_ticks=4),
                    sc=dict(sybil_eclipse=True)),
}
# the cases whose P7 must charge broken promises or backoff violations
PENALISED = ("ihave_spam", "both_spam", "both_spam_c8", "promise_breakers",
             "graft_flood", "eclipse")
FLOODED = ("both_spam", "iwant_spam", "both_spam_c8")


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    m = 32
    subs = np.zeros((N, T), dtype=bool)
    subs[np.arange(N), np.arange(N) % T] = True
    subs[rng.random(N) < 0.05] = False          # some fanout-only peers
    kw = {}
    pool = np.ones(N, dtype=bool)
    if case.get("eclipse"):
        es = np.zeros(N, dtype=bool)
        es[:200] = True
        ev = np.zeros(N, dtype=bool)
        ev[200:280] = True
        kw.update(eclipse_sybil=es, eclipse_victim=ev)
        pool = ~es & ~ev
    ids = np.flatnonzero(pool)
    origin = ids[rng.integers(0, len(ids), m)]
    topic = origin % T
    ticks = np.sort(rng.integers(0, 24, m)).astype(np.int32)
    if case.get("invalid"):
        kw["msg_invalid"] = rng.random(m) < case["invalid"]
    if case.get("sybil"):
        kw["sybil"] = rng.random(N) < case["sybil"]
    if case.get("breakers"):
        kw["promise_break"] = rng.random(N) < case["breakers"]
    return (subs, topic, origin, ticks), kw


def _build(ref, name, seed=0):
    case = CASES[name]
    (subs, topic, origin, ticks), kw = _inputs(case, seed)
    c = case.get("c", 16)
    offsets = ref.gs.make_gossip_offsets(T, c, N, seed=seed)
    cfg_kw, sc_kw = case.get("cfg", {}), case.get("sc", {})
    cfg_r = ref.gs.GossipSimConfig(offsets=offsets, n_topics=T, **cfg_kw)
    sc_r = ref.gs.ScoreSimConfig(**sc_kw)
    cfg_p = pgs.GossipSimConfig(offsets=offsets, n_topics=T, **cfg_kw)
    sc_p = pgs.ScoreSimConfig(**sc_kw)
    ref_sim = ref.gs.make_gossip_sim(cfg_r, subs, topic, origin, ticks,
                                     seed=seed, score_cfg=sc_r, **kw)
    port_sim = pgs.make_gossip_sim(cfg_p, subs, topic, origin, ticks,
                                   seed=seed, score_cfg=sc_p, device="cpu",
                                   **kw)
    return (cfg_r, sc_r, *ref_sim), (cfg_p, sc_p, *port_sim)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sim_build_matches_reference(ref, name):
    (_, _, p_r, s_r), (_, _, p_p, s_p) = _build(ref, name)
    _assert_tree_equal(tree_to_numpy(p_r), convert.params_to_numpy(p_p),
                       "params")
    _assert_tree_equal(tree_to_numpy(s_r), convert.state_to_numpy(s_p),
                       "state")


@pytest.mark.parametrize("name", ["promise_breakers", "eclipse"])
def test_convert_round_trips_the_attack_fields(ref, name):
    (_, _, p_r, _), (_, _, p_p, _) = _build(ref, name, seed=4)
    p_np = tree_to_numpy(p_r)
    p2 = convert.params_from_numpy(p_np, "cpu")
    _assert_tree_equal(p_np, convert.params_to_numpy(p2), "params")
    fields = (("promise_break",) if name == "promise_breakers" else
              ("eclipse_sybil", "eclipse_victim", "cand_victim_bits"))
    for f in fields:
        assert p_np[f] is not None
        assert torch.equal(getattr(p2, f), getattr(p_p, f)), f


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_matches_reference_30_ticks(ref, name):
    import jax

    (cfg_r, sc_r, p_r, s_r), (cfg_p, sc_p, p_p, s_p) = _build(ref, name)
    step_r = jax.jit(ref.gs.make_gossip_step(cfg_r, sc_r))
    step_p = pgs.make_gossip_step(cfg_p, sc_p, device="cpu")
    bp_max = syb_serves = takeover = 0.0
    for t in range(30):
        s_r, d_r = step_r(p_r, s_r)
        s_p, d_p = step_p(p_p, s_p)
        _assert_tree_equal(tree_to_numpy(s_r), convert.state_to_numpy(s_p),
                           f"tick {t}")
        np.testing.assert_array_equal(d_p.numpy().view(np.uint32),
                                      np.asarray(d_r), err_msg=f"tick {t}")
        bp_max = max(bp_max,
                     float(s_p.scores.behaviour_penalty.float().max()))
        if p_p.sybil.any():
            syb_serves = max(syb_serves,
                             int(s_p.iwant_serves[:, p_p.sybil].max()))
        if p_p.eclipse_sybil is not None:
            takeover = max(takeover,
                           pgs.eclipse_takeover(s_p, p_p, cfg_p))
    # the readouts agree with the reference's
    np.testing.assert_array_equal(
        pgs.iwant_serve_level(s_p, cfg_p).numpy(),
        np.asarray(ref.gs.iwant_serve_level(s_r, cfg_r)))
    if name == "eclipse":
        assert pgs.eclipse_takeover(s_p, p_p, cfg_p) == pytest.approx(
            ref.gs.eclipse_takeover(s_r, p_r, cfg_r), abs=0)
        # non-vacuous: the attackers sat in the victims' meshes
        assert takeover > 0
    # non-vacuous: meshes formed, messages moved, the attacks were live
    assert np.asarray(s_r.have).any()
    assert int(pgs.mesh_degrees(s_p).max()) >= cfg_p.d
    if name in PENALISED:
        assert bp_max > 0
    if name in FLOODED:
        assert syb_serves > 0


FLAGS = {
    "track_promises": dict(track_promises=True),
    "ihave_spam": dict(ihave_spam=True),
    "iwant_spam": dict(iwant_spam=True),
    "all": dict(track_promises=True, ihave_spam=True, iwant_spam=True),
}


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("w_words", [1, 2])
def test_attack_receive_plain_matches_pallas_kernel(ref, flags, w_words):
    import jax.numpy as jnp

    fl = FLAGS[flags]
    offsets = ref.gs.make_gossip_offsets(T, C, N, seed=3)
    sc_kw = dict(sybil_ihave_spam=fl.get("ihave_spam", False),
                 sybil_iwant_spam=fl.get("iwant_spam", False))
    cfg = ref.gs.GossipSimConfig(offsets=offsets, n_topics=T)
    sc = ref.gs.ScoreSimConfig(**sc_kw)
    k = dataclasses.replace(
        prc.receive_consts(pgs.GossipSimConfig(offsets=offsets, n_topics=T),
                           pgs.ScoreSimConfig()),
        **{**dict(track_promises=False, ihave_spam=False, iwant_spam=False),
           **fl})
    assert k.attacks
    rng = np.random.default_rng(100 + 10 * w_words + len(flags))
    ops = _operands(rng, w_words, False, sc)
    # a fifth of the peers carry the sybil word; low ledgers, so the
    # IWANT flood's budget is open on some edges and spent on others
    ops["syb"] = torch.from_numpy(np.where(
        rng.random(N) < 0.2, (1 << C) - 1, 0).astype(np.int32))
    ops["iws"] = torch.from_numpy(rng.integers(
        0, 4 * 32 * w_words, size=(C, N)).astype(np.int16))
    got = prc.receive_update(k, **ops)        # CPU tensors: plain version

    rc = ref.receive
    pln = rc.plan(N, cfg.offsets, BLOCK)

    def flat(rows, p, e):
        return jnp.concatenate([
            rc.extend_wrap(jnp.asarray(r), N, pln["n_pad"], pln[p], pln[e])
            for r in rows])

    krn = rc.make_receive_update(cfg, sc, N, BLOCK, jnp.bfloat16, w_words,
                                 track_promises=k.track_promises,
                                 interpret=True, with_static=False)
    head = [jnp.asarray(_np(ops["valid"])),
            jnp.asarray(np.array(ops["gseeds"], dtype=np.uint32)),
            jnp.zeros((1,), dtype=jnp.uint32)]
    flats = [flat(list(_np(ops["ctrl"])), "p8", "e8"),
             flat(list(_np(ops["fresh"])), "p32", "e32"),
             flat(list(_np(ops["adv"])), "p32", "e32")]
    blocked = [_np(ops[k_]) for k_ in (
        "pay", "gsp", "acc", "sub_all", "cand_sub", "fanout", "syb", "wa",
        "bo2", "grafts", "dropped", "meshsel", "seen", "injected",
        "backoff", "fd", "inv", "bp", "tim", "iws")]
    want = krn(*head, *flats, *[jnp.asarray(b) for b in blocked])
    assert len(got) == len(want) == len(NAMES)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(_bits(_np(g)), _bits(w), err_msg=name)
    # non-vacuous: each option changed what it owns
    base = prc.receive_update(
        dataclasses.replace(k, track_promises=False, ihave_spam=False,
                            iwant_spam=False),
        **{name: v for name, v in ops.items() if name != "syb"})
    if k.track_promises:
        assert not torch.equal(got[12], base[12])       # bp
    if k.ihave_spam:
        assert not torch.equal(got[8], base[8])         # targets
    if k.iwant_spam:
        assert not torch.equal(got[14], base[14])       # iws


def test_adversarial_build_follows_the_benchmark_draws(ref):
    """The benchmark's draw order: messages, then honest origins from the
    same generator; sybils from default_rng(7)."""
    n, t, horizon = 20_000, 100, 400
    sybil, topic, origin, tick = adversarial.draws(n, t, horizon)
    rng = np.random.default_rng(0)
    want_syb = np.random.default_rng(7).random(n) < 0.2
    w_topic = rng.integers(0, t, 32)
    rng.integers(0, n // t, 32)
    w_tick = np.sort(rng.integers(0, horizon, 32)).astype(np.int32)
    honest = np.flatnonzero(~want_syb)
    pick = honest[rng.integers(0, len(honest), 32)]
    np.testing.assert_array_equal(sybil, want_syb)
    np.testing.assert_array_equal(origin, pick)
    np.testing.assert_array_equal(topic, (pick % t).astype(w_topic.dtype))
    np.testing.assert_array_equal(tick, w_tick)
    assert not sybil[origin].any()
    # a short run at a small size: the gates' readouts, the attacks live
    cfg, sc, params, state, m_topic, m_tick, syb = adversarial.build(
        "cpu", n_peers=n, horizon=10)
    assert sc.sybil_ihave_spam and sc.sybil_iwant_spam
    assert torch.equal(params.sybil, torch.from_numpy(want_syb))
    step = pgs.make_gossip_step(cfg, sc, device="cpu")
    state = pgs.gossip_run(params, state, 12, step, device="cpu")
    out = adversarial.gates(cfg, params, state, m_topic, m_tick, 12)
    assert out["serves_cap"] == 4 * 32
    assert out["containment_ok"] and out["degree_ok"], out
    bp_max, syb_serves = adversarial.attack_levels(params, state)
    assert bp_max > 0 and syb_serves > 0


VALIDATION = {
    "promise_break requires score_cfg": dict(
        sc=None, promise_break=np.zeros(N, bool)),
    "eclipse_sybil/eclipse_victim require": dict(
        sc=None, eclipse_sybil=np.zeros(N, bool),
        eclipse_victim=np.zeros(N, bool)),
    "need BOTH": dict(eclipse_sybil=np.zeros(N, bool)),
    "disjoint": dict(eclipse_sybil=np.ones(N, bool),
                     eclipse_victim=np.arange(N) == 3),
}


@pytest.mark.parametrize("match", sorted(VALIDATION))
def test_attack_inputs_are_validated_as_the_reference_does(match):
    kw = dict(VALIDATION[match])
    sc = kw.pop("sc", pgs.ScoreSimConfig(sybil_eclipse=True))
    (subs, topic, origin, ticks), _ = _inputs({})
    cfg = pgs.GossipSimConfig(offsets=pgs.make_gossip_offsets(T, 16, N),
                              n_topics=T)
    with pytest.raises(ValueError, match=match):
        pgs.make_gossip_sim(cfg, subs, topic, origin, ticks, score_cfg=sc,
                            device="cpu", **kw)


def test_byzantine_mutation_is_refused_by_name():
    (subs, topic, origin, ticks), _ = _inputs({})
    cfg = pgs.GossipSimConfig(offsets=pgs.make_gossip_offsets(T, 16, N),
                              n_topics=T)
    for sc, kw in ((pgs.ScoreSimConfig(byzantine_mutation=True), {}),
                   (pgs.ScoreSimConfig(), {"byzantine": np.zeros(N, bool)})):
        with pytest.raises(plan.SliceRefusal) as err:
            pgs.make_gossip_sim(cfg, subs, topic, origin, ticks,
                                score_cfg=sc, device="cpu", **kw)
        assert err.value.name == "byzantine"
        assert "kernel path refuses it too" in str(err.value)
