"""The port's single-topic router surface against the JAX reference: PX
candidate rotation, direct peers, flood publishing, exact-k gossip
targets and the shared-IP gater, each alone and all together under both
gossip-repair attacks.

Same config, same seeded inputs (numpy), handed to both packages: the
sims must build leaf-identical (the same-IP sibling words, the direct
word, the initial active set), the conversion must round-trip them, and
the port's step (CPU, plain kernel versions) must match the reference's
unpadded XLA step on EVERY state leaf, tick by tick, for 30 ticks.  The
plain receive with each option must equal the reference's Pallas kernel
in interpret mode on seeded random operands.  Tolerance: exact (packed
words and integer counters bitwise, f32/bf16 leaves by bit pattern; no
exception).
"""

import dataclasses

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import convert, everything
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.ops import graph as pg
from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as prc
from test_torch_gossipsub import _assert_tree_equal
from test_torch_receive import BLOCK, C, N, NAMES, _bits, _np, _operands
from test_torch_unscored import unscored_operands
from torch_ref import imported_reference, tree_to_numpy

T, M = 4, 8
SMALL = dict(d=3, d_lo=2, d_hi=6, d_score=2, d_out=1, d_lazy=2,
             gossip_factor=0.25, backoff_ticks=8)


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        yield r


CASES = {
    "px_scored": dict(px=7),
    "px_unscored": dict(px=7, score=False),
    "flood_publish": dict(sc=dict(flood_publish=True)),
    # n a multiple of 29: the overlay predicate tiles the ring
    "direct": dict(n=928, direct=True),
    "direct_unscored": dict(n=928, direct=True, score=False),
    "exact_k_scored": dict(exact_k=True),
    "exact_k_unscored": dict(exact_k=True, score=False),
    # arithmetic offsets, so that IP siblings are co-candidates of common
    # victims; invalid spam puts the gater under real pressure
    "shared_ip_gater": dict(gater_topology=True),
    # all five, the sybils two to an address, under both attacks
    "everything": dict(n=928, m=12, px=7, direct=True, exact_k=True,
                       shared_ip=True, sybil=0.15, invalid=0.25,
                       sc=dict(flood_publish=True, sybil_ihave_spam=True,
                               sybil_iwant_spam=True, topic_score_cap=25.0)),
}


def _gater_inputs():
    n, t = 640, 2
    offsets = tuple(2 * k for k in range(1, 9)) + tuple(
        -2 * k for k in range(1, 9))
    rng = np.random.default_rng(3)
    idx = np.arange(n)
    subs = np.zeros((n, t), dtype=bool)
    subs[idx, idx % t] = True
    spam = np.zeros(n, dtype=bool)
    spam[0:120:12] = True
    ip = np.arange(n)
    ip[2:122:12] = ip[0:120:12]          # clean twins share spammer IPs
    m = 12
    sp_ids = np.flatnonzero(spam)
    origin = np.concatenate([sp_ids, rng.integers(0, n, m - len(sp_ids))])
    topic = (origin % t).astype(np.int64)
    invalid = np.array([True] * len(sp_ids) + [False] * (m - len(sp_ids)))
    ticks = np.sort(rng.integers(0, 8, m)).astype(np.int32)
    return (offsets, t, (subs, topic, origin, ticks),
            dict(sybil=spam, msg_invalid=invalid, peer_ip=ip),
            dict(ip_colocation_factor_weight=0.0))


def _inputs(ref, case, seed=3):
    """(offsets, n_topics, sim args, sim kwargs, score kwargs, cfg
    kwargs) of a case."""
    cfg_kw = dict(SMALL, binomial_gossip_sampling=not case.get("exact_k"))
    if case.get("gater_topology"):
        offsets, t, args, kw, sc_kw = _gater_inputs()
        return offsets, t, args, kw, sc_kw, cfg_kw
    n, m, c = case.get("n", 900), case.get("m", M), 8
    rng = np.random.default_rng(seed)
    offsets = ref.gs.make_gossip_offsets(T, c, n, seed=seed)
    idx = np.arange(n)
    subs = np.zeros((n, T), dtype=bool)
    subs[idx, idx % T] = True
    topic = rng.integers(0, T, m)
    origin = rng.integers(0, n // T, m) * T + topic
    ticks = np.sort(rng.integers(0, 12, m)).astype(np.int32)
    kw = {}
    if case.get("score", True):
        sybil = rng.random(n) < case.get("sybil", 0.0)
        kw = dict(sybil=sybil,
                  msg_invalid=rng.random(m) < case.get("invalid", 0.0),
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
    return offsets, T, (subs, topic, origin, ticks), kw, case.get("sc", {}), \
        cfg_kw


def _build(ref, name, seed=3):
    case = CASES[name]
    offsets, t, args, kw, sc_kw, cfg_kw = _inputs(ref, case, seed)
    cfg_r = ref.gs.GossipSimConfig(offsets=offsets, n_topics=t, **cfg_kw)
    cfg_p = pgs.GossipSimConfig(offsets=offsets, n_topics=t, **cfg_kw)
    scored = case.get("score", True)
    sc_r = ref.gs.ScoreSimConfig(**sc_kw) if scored else None
    sc_p = pgs.ScoreSimConfig(**sc_kw) if scored else None
    ref_sim = ref.gs.make_gossip_sim(cfg_r, *args, seed=seed,
                                     score_cfg=sc_r, **kw)
    port_sim = pgs.make_gossip_sim(cfg_p, *args, seed=seed, score_cfg=sc_p,
                                   device="cpu", **kw)
    return (cfg_r, sc_r, *ref_sim), (cfg_p, sc_p, *port_sim)


# the leaves each case must carry
FIELDS = {
    "px_scored": ("active",), "px_unscored": ("active",),
    "direct": ("cand_direct",), "direct_unscored": ("cand_direct",),
    "shared_ip_gater": ("cand_same_ip",),
    "everything": ("active", "cand_direct", "cand_same_ip"),
}


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_sim_build_matches_reference(ref, name):
    (_, _, p_r, s_r), (_, _, p_p, s_p) = _build(ref, name)
    p_np, s_np = tree_to_numpy(p_r), tree_to_numpy(s_r)
    _assert_tree_equal(p_np, convert.params_to_numpy(p_p), "params")
    _assert_tree_equal(s_np, convert.state_to_numpy(s_p), "state")
    for f in FIELDS[name]:
        assert {**p_np, **s_np}[f] is not None, f
    if "active" in FIELDS[name]:
        # px_candidates of the C candidates, pinned direct peers on top
        held = pg.popcount32(s_p.active)
        extra = (0 if p_p.cand_direct is None
                 else pg.popcount32(p_p.cand_direct))
        assert int(held.min()) >= 7 and bool((held <= 7 + extra).all())


@pytest.mark.parametrize("name", ["px_unscored", "direct",
                                  "shared_ip_gater", "everything"])
def test_convert_round_trips_the_surface_fields(ref, name):
    (_, _, p_r, s_r), (_, sc_p, p_p, s_p) = _build(ref, name, seed=4)
    p_np, s_np = tree_to_numpy(p_r), tree_to_numpy(s_r)
    p2 = convert.params_from_numpy(p_np, "cpu")
    s2 = convert.state_from_numpy(s_np, sc_p, "cpu")
    _assert_tree_equal(p_np, convert.params_to_numpy(p2), "params")
    _assert_tree_equal(s_np, convert.state_to_numpy(s2), "state")
    for f in FIELDS[name]:
        mine, back = ((s_p, s2) if f == "active" else (p_p, p2))
        assert torch.equal(getattr(back, f), getattr(mine, f)), f


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_matches_reference_30_ticks(ref, name):
    import jax

    (cfg_r, sc_r, p_r, s_r), (cfg_p, sc_p, p_p, s_p) = _build(ref, name)
    step_r = jax.jit(ref.gs.make_gossip_step(cfg_r, sc_r))
    step_p = pgs.make_gossip_step(cfg_p, sc_p, device="cpu")
    s0 = s_p
    flooded = direct_meshed = syb_serves = 0
    inv_max = bp_max = 0.0
    for t in range(30):
        if sc_p is not None and sc_p.flood_publish:
            # own publishes due this tick go to every candidate above the
            # publish threshold
            due = (p_p.publish_tick == s_p.tick)
            inj = p_p.origin_words & pg.pack_bits(due[None, :])[0][:, None]
            flooded += int(((inj & ~s_p.have) != 0).any(0).sum())
        s_r, d_r = step_r(p_r, s_r)
        s_p, d_p = step_p(p_p, s_p)
        _assert_tree_equal(tree_to_numpy(s_r), convert.state_to_numpy(s_p),
                           f"tick {t}")
        np.testing.assert_array_equal(d_p.numpy().view(np.uint32),
                                      np.asarray(d_r), err_msg=f"tick {t}")
        if p_p.cand_direct is not None:
            direct_meshed += everything.direct_in_mesh(p_p, s_p)
        if sc_p is not None:
            inv_max = max(inv_max, float(
                s_p.scores.invalid_deliveries.float().max()))
            bp_max = max(bp_max, float(
                s_p.scores.behaviour_penalty.float().max()))
            if p_p.sybil.any():
                syb_serves = max(syb_serves, int(
                    s_p.iwant_serves[:, p_p.sybil].max()))
    # non-vacuous: meshes formed, messages moved, each option was live
    case = CASES[name]
    assert int(pgs.mesh_degrees(s_p).max()) >= cfg_p.d
    assert np.asarray(s_r.have).any()
    if case.get("px") is not None:
        assert (s_p.active != s0.active).any()
    if case.get("direct"):
        assert p_p.cand_direct.any() and direct_meshed == 0
    if case.get("sc", {}).get("flood_publish"):
        assert flooded > 0
    if case.get("exact_k"):
        assert not cfg_p.binomial_gossip_sampling
    if name in ("shared_ip_gater", "everything"):
        assert p_p.cand_same_ip is not None and inv_max > 0
    if name == "everything":
        assert bp_max > 0 and syb_serves > 0


def test_flood_publish_changes_the_trajectory(ref):
    """Flood publishing is live at this size: the same sim without it
    delivers later somewhere."""
    offsets, t, args, kw, sc_kw, cfg_kw = _inputs(
        ref, CASES["flood_publish"])
    cfg = pgs.GossipSimConfig(offsets=offsets, n_topics=t, **cfg_kw)
    ends = []
    for flood in (True, False):
        sc = pgs.ScoreSimConfig(flood_publish=flood)
        params, state = pgs.make_gossip_sim(cfg, *args, seed=3, score_cfg=sc,
                                            device="cpu", **kw)
        ends.append(pgs.gossip_run(
            params, state, 14, pgs.make_gossip_step(cfg, sc, device="cpu"),
            device="cpu"))
    assert not torch.equal(ends[0].first_tick, ends[1].first_tick)


OPTIONS = {
    "flood": dict(flood_publish=True),
    "exact_k": dict(exact_k=True),
    "px": dict(with_px=True),
    "same_ip": dict(with_same_ip=True),
    "all": dict(flood_publish=True, exact_k=True, with_px=True,
                with_same_ip=True, track_promises=True, ihave_spam=True,
                iwant_spam=True),
}


def _sibling_words(rng):
    """Symmetric same-IP relations among each peer's candidates: bit c
    of row cc = candidates c and cc share an address (reflexive)."""
    group = rng.integers(0, 6, size=(C, N))
    same = np.zeros((C, N), dtype=np.uint32)
    for cc in range(C):
        same |= (group == group[cc][None, :]).astype(np.uint32) << cc
    return torch.from_numpy(same.view(np.int32))


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("w_words", [1, 2])
def test_full_receive_plain_matches_pallas_kernel(ref, option, w_words):
    import jax.numpy as jnp

    fl = OPTIONS[option]
    offsets = ref.gs.make_gossip_offsets(T, C, N, seed=3)
    # Dlazy = 2, so that k < |eligible| at many peers
    cfg_kw = dict(binomial_gossip_sampling=not fl.get("exact_k", False),
                  d_lazy=2)
    sc_kw = dict(flood_publish=fl.get("flood_publish", False),
                 sybil_ihave_spam=fl.get("ihave_spam", False),
                 sybil_iwant_spam=fl.get("iwant_spam", False))
    cfg = ref.gs.GossipSimConfig(offsets=offsets, n_topics=T, **cfg_kw)
    sc = ref.gs.ScoreSimConfig(**sc_kw)
    k = prc.receive_consts(
        pgs.GossipSimConfig(offsets=offsets, n_topics=T, **cfg_kw),
        pgs.ScoreSimConfig(**sc_kw), promise_break=fl.get("track_promises",
                                                          False),
        px=fl.get("with_px", False), same_ip=fl.get("with_same_ip", False))
    assert k.full and k == dataclasses.replace(
        prc.receive_consts(pgs.GossipSimConfig(offsets=offsets, n_topics=T,
                                               d_lazy=2),
                           pgs.ScoreSimConfig()), **fl)
    rng = np.random.default_rng(300 + 10 * w_words + len(option))
    ops = _operands(rng, w_words, False, sc)
    if k.flood_publish:
        ops["ctrl"] = torch.from_numpy(
            rng.integers(0, 128, size=(C, N)).astype(np.uint8))
        a = rng.integers(0, 1 << 32, size=(2, w_words, N), dtype=np.uint64)
        ops["inj_send"] = torch.from_numpy(
            (a[0] & a[1]).astype(np.uint32).view(np.int32))
    if k.with_same_ip:
        ops["same_ip"] = _sibling_words(rng)
    if k.attacks:
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
                                 interpret=True, with_static=False,
                                 with_px=k.with_px,
                                 with_same_ip=k.with_same_ip)
    head = [jnp.asarray(_np(ops["valid"])),
            jnp.asarray(np.array(ops["gseeds"], dtype=np.uint32)),
            jnp.zeros((1,), dtype=jnp.uint32)]
    flats = [flat(list(_np(ops["ctrl"])), "p8", "e8"),
             flat(list(_np(ops["fresh"])), "p32", "e32"),
             flat(list(_np(ops["adv"])), "p32", "e32")]
    if k.flood_publish:
        flats.append(flat(list(_np(ops["inj_send"])), "p32", "e32"))
    syb = _np(ops["syb"]) if k.attacks else np.zeros(N, dtype=np.uint32)
    blocked = [_np(ops[k_]) for k_ in (
        "pay", "gsp", "acc", "sub_all", "cand_sub", "fanout")] + [syb] + [
        _np(ops[k_]) for k_ in (
            "wa", "bo2", "grafts", "dropped", "meshsel", "seen", "injected",
            "backoff", "fd", "inv", "bp", "tim", "iws")]
    if k.with_same_ip:
        blocked.append(_np(ops["same_ip"]))
    want = krn(*head, *flats, *[jnp.asarray(b) for b in blocked])
    names = NAMES + (("px_rot",) if k.with_px else ())
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(_bits(_np(g)), _bits(w), err_msg=name)
    # non-vacuous: each option changed what it owns
    plain_ops = {name: v for name, v in ops.items()
                 if name not in ("inj_send", "same_ip")}
    base = prc.receive_update(
        dataclasses.replace(k, flood_publish=False, exact_k=False,
                            with_px=False, with_same_ip=False), **plain_ops)
    if k.flood_publish:
        assert not torch.equal(got[0], base[0])         # acquisitions
    if k.exact_k:
        assert not torch.equal(got[8], base[8])         # targets
    if k.with_px:
        assert got[-1].any() and len(base) == len(NAMES)
    if k.with_same_ip:
        assert not torch.equal(got[7], base[7])         # payload gate


@pytest.mark.parametrize("c,w_words", [(8, 1), (16, 2)])
def test_full_unscored_receive_plain_matches_pallas_kernel(ref, c, w_words):
    """Exact-k targets and the PX trigger word on the unscored kernel."""
    import jax.numpy as jnp

    kw = dict(binomial_gossip_sampling=False,
              **({k_: v for k_, v in SMALL.items()
                  if k_ not in ("gossip_factor", "backoff_ticks")}
                 if c == 8 else {}))
    offsets = ref.gs.make_gossip_offsets(T, c, N, seed=3)
    cfg = ref.gs.GossipSimConfig(offsets=offsets, n_topics=T, **kw)
    k = prc.receive_consts(
        pgs.GossipSimConfig(offsets=offsets, n_topics=T, **kw), None,
        px=True)
    assert k.full and not k.scored
    ops = unscored_operands(np.random.default_rng(40 + c + w_words), c, N,
                            w_words)
    got = prc.receive_update(k, **ops)       # CPU tensors: plain version

    rc = ref.receive
    pln = rc.plan(N, cfg.offsets, BLOCK)

    def flat(rows, p, e):
        return jnp.concatenate([
            rc.extend_wrap(jnp.asarray(r), N, pln["n_pad"], pln[p],
                           pln[e]) for r in rows])

    krn = rc.make_receive_update(cfg, None, N, BLOCK, jnp.float32, w_words,
                                 interpret=True, with_px=True)
    flats = [flat(list(_np(ops["ctrl"])), "p8", "e8"),
             flat(list(_np(ops["fresh"])), "p32", "e32"),
             flat(list(_np(ops["adv"])), "p32", "e32")]
    zero = np.zeros(N, dtype=np.uint32)       # sybil word, bo2: scored only
    blocked = [_np(ops[n_]) for n_ in ("sub_all", "cand_sub", "fanout")]
    blocked += [zero, _np(ops["wa"]), zero]
    blocked += [_np(ops[n_]) for n_ in ("grafts", "dropped", "meshsel",
                                         "seen", "injected", "backoff")]
    want = krn(jnp.asarray(np.array(ops["gseeds"], dtype=np.uint32)),
               jnp.zeros((1,), jnp.uint32), *flats,
               *[jnp.asarray(b) for b in blocked])
    names = ("acq", "mesh", "backoff", "g_targets", "g_backoff", "px_rot")
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)
    # exactly k targets wherever enough candidates are eligible
    elig = ops["cand_sub"] & ~got[1] & ~ops["fanout"] & ops["sub_all"]
    n_el = pg.popcount32(elig)
    n_go = torch.clamp((k.gossip_factor * n_el.float()).to(torch.int32),
                       min=k.d_lazy)
    assert torch.equal(pg.popcount32(got[3]), torch.minimum(n_go, n_el))
    assert got[5].any()


def _small_sim(**kw):
    n = 256
    cfg = pgs.GossipSimConfig(offsets=pgs.make_gossip_offsets(T, 16, n),
                              n_topics=T)
    subs = np.zeros((n, T), dtype=bool)
    subs[np.arange(n), np.arange(n) % T] = True
    z = np.zeros(4, dtype=np.int64)
    return cfg, lambda: pgs.make_gossip_sim(
        cfg, subs, z, z, z.astype(np.int32), device="cpu", **kw)


def _asymmetric():
    de = np.zeros((256, 16), dtype=bool)
    de[5, 0] = True                       # the far end does not pin it
    return de


VALIDATION = {
    "direct_shape": ("direct_edges must be bool",
                     dict(direct_edges=np.zeros((256, 8), dtype=bool))),
    "direct_symmetry": ("direct_edges must be symmetric",
                        dict(direct_edges=_asymmetric())),
    # Dhi = 12 < px_candidates <= C = 16
    "px_at_dhi": ("need Dhi < px_candidates <= C", dict(px_candidates=12)),
    "px_above_c": ("need Dhi < px_candidates <= C", dict(px_candidates=17)),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_surface_inputs_are_validated_as_the_reference_does(ref, case):
    match, kw = VALIDATION[case]
    cfg, build = _small_sim(**kw)
    with pytest.raises(ValueError, match=match) as mine:
        build()
    cfg_r = ref.gs.GossipSimConfig(offsets=cfg.offsets, n_topics=T)
    subs = np.zeros((256, T), dtype=bool)
    subs[np.arange(256), np.arange(256) % T] = True
    z = np.zeros(4, dtype=np.int64)
    with pytest.raises(ValueError) as theirs:
        ref.gs.make_gossip_sim(cfg_r, subs, z, z, z.astype(np.int32), **kw)
    assert str(mine.value) == str(theirs.value)


def test_same_ip_words_need_a_score_config():
    cfg, _ = _small_sim()
    with pytest.raises(ValueError, match="need a score config"):
        prc.receive_consts(cfg, None, same_ip=True)


def test_everything_build_follows_the_benchmark_draws():
    """The benchmark's draw order (messages, then honest origins from
    the same generator; sybils from default_rng(7)), its direct overlay
    and its sybil addresses, at a small size; a short run shows every
    option live and the gates' readouts."""
    from go_libp2p_pubsub_tpu_torch import adversarial

    n, t = 20_180, 100                    # a multiple of 1009
    cfg, sc, params, state, m_topic, m_tick, syb = everything.build(
        "cpu", n_peers=n, horizon=10)
    want_syb = np.random.default_rng(7).random(n) < 0.2
    rng = np.random.default_rng(0)
    rng.integers(0, t, 32)
    rng.integers(0, n // t, 32)
    w_tick = np.sort(rng.integers(0, 10, 32)).astype(np.int32)
    honest = np.flatnonzero(~want_syb)
    pick = honest[rng.integers(0, len(honest), 32)]
    np.testing.assert_array_equal(syb, want_syb)
    np.testing.assert_array_equal(m_tick, w_tick)
    np.testing.assert_array_equal(m_topic, pick % t)
    assert (sc.flood_publish and sc.sybil_ihave_spam and sc.sybil_iwant_spam
            and sc.topic_score_cap == 50.0)
    # the overlay: pinned peers on candidate 0 and its inverse, both ends
    de, ip = everything.overlay(cfg.offsets, cfg.cinv, n, want_syb)
    pinned = (np.arange(n) % 1009) == 0
    assert de[pinned][:, [0, cfg.cinv[0]]].all()
    assert de.sum() == 4 * pinned.sum() and not de[:, 1].any()
    direct = params.cand_direct.numpy().view(np.uint32)
    np.testing.assert_array_equal(direct != 0, de.any(1))
    # the sybils four to an address, above every honest address
    sid = np.flatnonzero(want_syb)
    np.testing.assert_array_equal(ip[sid], n + np.arange(len(sid)) // 4)
    np.testing.assert_array_equal(ip[~want_syb], np.arange(n)[~want_syb])
    assert params.cand_same_ip is not None
    assert int(pg.popcount32(state.active).min()) >= 14
    step = pgs.make_gossip_step(cfg, sc, device="cpu")
    end = pgs.gossip_run(params, state, 12, step, device="cpu")
    live = everything.options_live(params, state.active, end)
    assert live["active_rotated"] > 0 and live["direct_in_mesh"] == 0
    assert live["same_ip_words"] and live["sybil_static_min"] < 0
    out = adversarial.gates(cfg, params, end, m_topic, m_tick, 12)
    assert out["containment_ok"] and out["degree_ok"], out
