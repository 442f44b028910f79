"""The port's scored GossipSub v1.1 heartbeat against the JAX reference.

Same config, same seeded inputs (numpy), handed to both packages: the
sims must build leaf-identical, the conversion must round-trip, and the
port's step (CPU, plain kernel versions) must match the reference's
unpadded XLA step — which the reference pins equal to its receive-kernel
path — on EVERY state leaf, tick by tick, for 30 ticks.  Tolerance:
exact (f32/bf16 leaves compared by bit pattern).
"""

import dataclasses

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import _delivery as pdl
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from torch_ref import imported_reference, tree_to_numpy

N, T, C = 1024, 4, 16


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        yield r


CASES = {
    # the flagship protocol defaults, M=32 (W=1) and M=40 (W=2)
    "w1": dict(m=32),
    "w2": dict(m=40),
    # P5 app scores (nonzero static term), invalid messages (P4 + the
    # RED gater) and invalid-forwarding sybils
    "app_invalid": dict(m=32, app=True, invalid=0.3, sybil=0.3),
    # opportunistic grafting inside the window (every 7 ticks)
    "og": dict(m=40, sc=dict(opportunistic_graft_ticks=7)),
    # f32 counter storage; and bf16 counters beside an f32 behaviour
    # penalty (its slow decay keeps it out of bf16, bp_dtype)
    "f32_counters": dict(m=32, invalid=0.2, sybil=0.2,
                         sc=dict(counter_dtype="float32")),
    "bp_f32": dict(m=32, sc=dict(behaviour_penalty_decay=0.99)),
}


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    m = case["m"]
    subs = np.zeros((N, T), dtype=bool)
    subs[np.arange(N), np.arange(N) % T] = True
    subs[rng.random(N) < 0.05] = False          # some fanout-only peers
    topic = rng.integers(0, T, m)
    origin = rng.integers(0, N // T, m) * T + topic
    ticks = np.sort(rng.integers(0, 24, m)).astype(np.int32)
    kw = {}
    if case.get("app"):
        kw["app_score"] = rng.normal(0, 0.5, N).astype(np.float32)
    if case.get("invalid"):
        kw["msg_invalid"] = rng.random(m) < case["invalid"]
    if case.get("sybil"):
        kw["sybil"] = rng.random(N) < case["sybil"]
    return (subs, topic, origin, ticks), kw, case.get("sc", {})


def _build(ref, name, seed=0):
    case = CASES[name]
    (subs, topic, origin, ticks), kw, sc_kw = _inputs(case, seed)
    offsets = ref.gs.make_gossip_offsets(T, C, N, seed=seed)
    assert offsets == pgs.make_gossip_offsets(T, C, N, seed=seed)
    cfg_r = ref.gs.GossipSimConfig(offsets=offsets, n_topics=T)
    sc_r = ref.gs.ScoreSimConfig(**sc_kw)
    cfg_p = pgs.GossipSimConfig(offsets=offsets, n_topics=T)
    sc_p = pgs.ScoreSimConfig(**sc_kw)
    ref_sim = ref.gs.make_gossip_sim(cfg_r, subs, topic, origin, ticks,
                                     seed=seed, score_cfg=sc_r, **kw)
    port_sim = pgs.make_gossip_sim(cfg_p, subs, topic, origin, ticks,
                                   seed=seed, score_cfg=sc_p, device="cpu",
                                   **kw)
    return (cfg_r, sc_r, *ref_sim), (cfg_p, sc_p, *port_sim)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_tree_equal(want: dict, got: dict, where: str):
    """Every non-None reference leaf equals the port's, bit for bit."""
    for name, w in want.items():
        if w is None or name in ("key",):
            continue
        g = got[name]
        if isinstance(w, dict):
            _assert_tree_equal(w, g, f"{where}.{name}")
        elif isinstance(w, list):
            assert len(w) == len(g), f"{where}.{name}"
            for i, (wi, gi) in enumerate(zip(w, g)):
                np.testing.assert_array_equal(
                    _bits(gi), _bits(wi), err_msg=f"{where}.{name}[{i}]")
        elif isinstance(w, np.ndarray):
            assert w.dtype == np.asarray(g).dtype, f"{where}.{name}"
            np.testing.assert_array_equal(_bits(g), _bits(w),
                                          err_msg=f"{where}.{name}")
        else:
            assert w == g, f"{where}.{name}: {w} != {g}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_sim_build_matches_reference(ref, name):
    (_, _, p_r, s_r), (_, _, p_p, s_p) = _build(ref, name)
    _assert_tree_equal(tree_to_numpy(p_r), convert.params_to_numpy(p_p),
                       "params")
    want = tree_to_numpy(s_r)
    _assert_tree_equal(want, convert.state_to_numpy(s_p), "state")
    import jax
    assert s_p.salt == int(np.asarray(jax.random.key_data(s_r.key))[-1])


@pytest.mark.parametrize("name", ["w1", "app_invalid"])
def test_convert_round_trip(ref, name):
    (_, sc_r, p_r, s_r), (_, sc_p, p_p, s_p) = _build(ref, name, seed=5)
    p_np, s_np = tree_to_numpy(p_r), tree_to_numpy(s_r)
    p2 = convert.params_from_numpy(p_np, "cpu")
    s2 = convert.state_from_numpy(s_np, sc_p, "cpu")
    _assert_tree_equal(p_np, convert.params_to_numpy(p2), "params")
    _assert_tree_equal(s_np, convert.state_to_numpy(s2), "state")
    assert s2.salt == s_p.salt == 5 and s2.tick == 0
    # the port's own trees round-trip too, and bf16 may arrive as f32
    s3 = convert.state_from_numpy(convert.state_to_numpy(s_p), sc_p, "cpu")
    _assert_tree_equal(convert.state_to_numpy(s_p),
                       convert.state_to_numpy(s3), "state")

    def as_f32(v):
        if v is None or v.dtype != np.uint16:
            return v
        return (v.astype(np.uint32) << 16).view(np.float32)

    f32 = dict(s_np, scores={k: as_f32(v)
                             for k, v in s_np["scores"].items()})
    s4 = convert.state_from_numpy(f32, sc_p, "cpu")
    _assert_tree_equal(s_np, convert.state_to_numpy(s4), "state")


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_matches_reference_30_ticks(ref, name):
    import jax

    (cfg_r, sc_r, p_r, s_r), (cfg_p, sc_p, p_p, s_p) = _build(ref, name)
    step_r = jax.jit(ref.gs.make_gossip_step(cfg_r, sc_r))
    step_p = pgs.make_gossip_step(cfg_p, sc_p, device="cpu")
    over = grafted = 0
    inv_max = 0.0
    for t in range(30):
        s_r, d_r = step_r(p_r, s_r)
        s_p, d_p = step_p(p_p, s_p)
        want = tree_to_numpy(s_r)
        _assert_tree_equal(want, convert.state_to_numpy(s_p), f"tick {t}")
        np.testing.assert_array_equal(d_p.numpy().view(np.uint32),
                                      np.asarray(d_r), err_msg=f"tick {t}")
        deg = pgs.mesh_degrees(s_p)
        over += int((deg > cfg_p.d_hi).sum())
        grafted = max(grafted, int(deg.max()))
        inv_max = max(inv_max,
                      float(s_p.scores.invalid_deliveries.float().max()))
    # non-vacuous: meshes formed, messages moved, the scores are live
    assert grafted >= cfg_p.d
    assert np.asarray(s_r.have).any()
    assert float(s_p.scores.first_deliveries.float().max()) > 0
    np.testing.assert_array_equal(
        pgs.reach_counts_from_have(p_p, s_p).numpy(),
        np.asarray(ref.gs.reach_counts_from_have(p_r, s_r)))
    np.testing.assert_array_equal(
        pgs.reach_counts(p_p, s_p).numpy(),
        np.asarray(ref.gs.reach_counts(p_r, s_r)))
    np.testing.assert_array_equal(pgs.mesh_degrees(s_p).numpy(),
                                  np.asarray(ref.gs.mesh_degrees(s_r)))
    assert over > 0              # the score-ranked prune path ran
    if name == "app_invalid":
        assert inv_max > 0


def test_gossip_run_matches_stepping(ref):
    (_, _, _, _), (cfg_p, sc_p, p_p, s_p) = _build(ref, "w1")
    step = pgs.make_gossip_step(cfg_p, sc_p, device="cpu")
    s_a = pgs.gossip_run(p_p, s_p, 12, step, device="cpu")
    s_b = s_p
    for _ in range(12):
        s_b = step(p_p, s_b)[0]
    _assert_tree_equal(convert.state_to_numpy(s_b),
                       convert.state_to_numpy(s_a), "run")
    assert s_a.tick == 12


def test_delivery_readouts_match_reference(ref):
    import jax.numpy as jnp
    from go_libp2p_pubsub_tpu.models import _delivery as rdl

    rng = np.random.default_rng(2)
    ft = rng.integers(-1, 40, size=(2, 32, 300)).astype(np.int16)
    dn = rng.integers(0, 1 << 32, size=(2, 300), dtype=np.uint64).astype(
        np.uint32)
    got = pdl.update_first_tick(torch.from_numpy(ft),
                                torch.from_numpy(dn.view(np.int32)), 40000)
    want = rdl.update_first_tick(jnp.asarray(ft), jnp.asarray(dn),
                                 jnp.int32(40000))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        pdl.first_tick_to_matrix(torch.from_numpy(ft), 40).numpy(),
        np.asarray(rdl.first_tick_to_matrix(jnp.asarray(ft), 40)))
    np.testing.assert_array_equal(
        pdl.reach_counts_from_first_tick(torch.from_numpy(ft), 40).numpy(),
        np.asarray(rdl.reach_counts_from_first_tick(jnp.asarray(ft), 40)))
    assert pdl.update_first_tick(None, torch.from_numpy(dn.view(np.int32)),
                                 3) is None


def test_config_fields_match_reference(ref):
    for mine, theirs in ((pgs.GossipSimConfig, ref.gs.GossipSimConfig),
                         (pgs.ScoreSimConfig, ref.gs.ScoreSimConfig)):
        fm = [(f.name, f.default) for f in dataclasses.fields(mine)]
        ft = [(f.name, f.default) for f in dataclasses.fields(theirs)]
        assert fm == ft
    offsets = ref.gs.make_gossip_offsets(T, C, N, seed=1)
    a = pgs.GossipSimConfig(offsets=offsets, n_topics=T)
    b = ref.gs.GossipSimConfig(offsets=offsets, n_topics=T)
    assert (a.cinv, a.outbound_mask) == (b.cinv, b.outbound_mask)
    for kw in ({}, {"behaviour_penalty_decay": 0.999},
               {"counter_dtype": "float32"}):
        assert (pgs.ScoreSimConfig(**kw).bp_dtype
                == ref.gs.ScoreSimConfig(**kw).bp_dtype)
    assert (pgs.gates_fingerprint(a, pgs.ScoreSimConfig())
            == ref.gs.gates_fingerprint(b, ref.gs.ScoreSimConfig()))
    with pytest.raises(ValueError, match="closed under negation"):
        pgs.GossipSimConfig(offsets=(4, 8, -4), n_topics=T)
    with pytest.raises(ValueError, match="graylist"):
        pgs.ScoreSimConfig(gossip_threshold=-100.0).validate()
