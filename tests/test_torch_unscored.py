"""The port's unscored GossipSub v1.0 heartbeat against the JAX reference.

Same config, same seeded inputs (numpy), handed to both packages
(``score_cfg=None`` on both sides): the sims must build leaf-identical,
the conversion must round-trip, the port's step (CPU, plain kernel
versions) must match the reference's unpadded XLA unscored step on EVERY
state leaf, tick by tick, for 30 ticks, and the port's unscored
``receive_update_plain`` must match the reference's Pallas receive
kernel built unscored (interpret mode).  Tolerance: exact (the unscored
state is integer words and i16 backoff; compared bitwise).
"""

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.ops import graph as pg
from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as prc
from torch_ref import imported_reference, tree_to_numpy

N, T, C = 1024, 4, 16
BLOCK = 128


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        yield r


def _inputs(m, seed=0):
    rng = np.random.default_rng(seed)
    subs = np.zeros((N, T), dtype=bool)
    subs[np.arange(N), np.arange(N) % T] = True
    subs[rng.random(N) < 0.05] = False          # some fanout-only peers
    topic = rng.integers(0, T, m)
    origin = rng.integers(0, N // T, m) * T + topic
    ticks = np.sort(rng.integers(0, 24, m)).astype(np.int32)
    return subs, topic, origin, ticks


def _build(ref, m, seed=0):
    args = _inputs(m, seed)
    offsets = ref.gs.make_gossip_offsets(T, C, N, seed=seed)
    cfg_r = ref.gs.GossipSimConfig(offsets=offsets, n_topics=T)
    cfg_p = pgs.GossipSimConfig(offsets=offsets, n_topics=T)
    ref_sim = ref.gs.make_gossip_sim(cfg_r, *args, seed=seed)
    port_sim = pgs.make_gossip_sim(cfg_p, *args, seed=seed, device="cpu")
    return (cfg_r, *ref_sim), (cfg_p, *port_sim)


def _assert_tree_equal(want: dict, got: dict, where: str):
    """Every reference leaf equals the port's bit for bit; a None
    reference leaf is None in the port too."""
    for name, w in want.items():
        if name == "key":
            continue
        g = got[name]
        if w is None:
            assert g is None, f"{where}.{name}: {g} is not None"
        elif isinstance(w, list):
            assert len(w) == len(g), f"{where}.{name}"
            for i, (wi, gi) in enumerate(zip(w, g)):
                np.testing.assert_array_equal(gi, wi,
                                              err_msg=f"{where}.{name}[{i}]")
        elif isinstance(w, np.ndarray):
            assert w.dtype == np.asarray(g).dtype, f"{where}.{name}"
            np.testing.assert_array_equal(g, w, err_msg=f"{where}.{name}")
        else:
            assert w == g, f"{where}.{name}: {w} != {g}"


M_CASES = {"w1": 24, "w2": 40}


@pytest.mark.parametrize("name", sorted(M_CASES))
def test_unscored_sim_build_matches_reference(ref, name):
    (_, p_r, s_r), (_, p_p, s_p) = _build(ref, M_CASES[name])
    want_p = {k: v for k, v in tree_to_numpy(p_r).items()
              if k in convert.params_to_numpy(p_p)}
    _assert_tree_equal(want_p, convert.params_to_numpy(p_p), "params")
    want = tree_to_numpy(s_r)
    got = convert.state_to_numpy(s_p)
    _assert_tree_equal({k: want[k] for k in got}, got, "state")
    assert s_p.scores is None and s_p.iwant_serves is None
    assert len(s_p.gates) == 2


def test_unscored_convert_round_trip(ref):
    (_, p_r, s_r), (_, p_p, s_p) = _build(ref, 24, seed=5)
    p_np, s_np = tree_to_numpy(p_r), tree_to_numpy(s_r)
    p2 = convert.params_from_numpy(p_np, "cpu")
    s2 = convert.state_from_numpy(s_np, None, "cpu")
    got_p = convert.params_to_numpy(p2)
    _assert_tree_equal({k: p_np[k] for k in got_p}, got_p, "params")
    got_s = convert.state_to_numpy(s2)
    _assert_tree_equal({k: s_np[k] for k in got_s}, got_s, "state")
    assert s2.salt == s_p.salt == 5 and s2.tick == 0
    s3 = convert.state_from_numpy(convert.state_to_numpy(s_p), None, "cpu")
    _assert_tree_equal(convert.state_to_numpy(s_p),
                       convert.state_to_numpy(s3), "state")
    with pytest.raises(ValueError, match="scores"):
        convert.state_from_numpy(s_np, pgs.ScoreSimConfig(), "cpu")


@pytest.mark.parametrize("name", sorted(M_CASES))
def test_unscored_step_matches_reference_30_ticks(ref, name):
    import jax

    (cfg_r, p_r, s_r), (cfg_p, p_p, s_p) = _build(ref, M_CASES[name])
    step_r = jax.jit(ref.gs.make_gossip_step(cfg_r, None))
    step_p = pgs.make_gossip_step(cfg_p, None, device="cpu")
    over = 0
    for t in range(30):
        s_r, d_r = step_r(p_r, s_r)
        s_p, d_p = step_p(p_p, s_p)
        want = tree_to_numpy(s_r)
        got = convert.state_to_numpy(s_p)
        _assert_tree_equal({k: want[k] for k in got}, got, f"tick {t}")
        np.testing.assert_array_equal(d_p.numpy().view(np.uint32),
                                      np.asarray(d_r), err_msg=f"tick {t}")
        over += int((pgs.mesh_degrees(s_p) > cfg_p.d_hi).sum())
    # non-vacuous: meshes formed, messages moved, the v1.0 prune ran
    assert int(pgs.mesh_degrees(s_p).max()) >= cfg_p.d
    assert np.asarray(s_r.have).any()
    assert over > 0
    np.testing.assert_array_equal(
        pgs.reach_counts(p_p, s_p).numpy(),
        np.asarray(ref.gs.reach_counts(p_r, s_r)))


def test_unscored_gates_fingerprint_matches_reference(ref):
    offsets = ref.gs.make_gossip_offsets(T, C, N, seed=1)
    a = pgs.GossipSimConfig(offsets=offsets, n_topics=T)
    b = ref.gs.GossipSimConfig(offsets=offsets, n_topics=T)
    assert pgs.gates_fingerprint(a, None) == ref.gs.gates_fingerprint(
        b, None)
    assert pgs.gates_fingerprint(a, None) != pgs.gates_fingerprint(
        a, pgs.ScoreSimConfig())


def test_scored_state_is_refused_by_the_unscored_step(ref):
    (cfg_p, p_p, s_p) = _build(ref, 24)[1]
    scored = pgs.make_gossip_step(cfg_p, pgs.ScoreSimConfig(), device="cpu")
    with pytest.raises(ValueError, match="gate words"):
        scored(p_p, s_p)
    with pytest.raises(ValueError, match="score_cfg"):
        pgs.make_gossip_sim(cfg_p, *_inputs(24), device="cpu",
                            sybil=np.zeros(N, bool))


# -- the unscored receive kernel: plain version vs the Pallas kernel


def _words(rng, shape, bits=32):
    a = rng.integers(0, 1 << bits, size=shape, dtype=np.uint64)
    return torch.from_numpy(a.astype(np.uint32).view(np.int32))


def _sparse(rng, shape):
    a = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    return torch.from_numpy((a & b).astype(np.uint32).view(np.int32))


def unscored_operands(rng, c, n, w_words):
    """Seeded operands of the unscored receive kernel (torch, int32-held
    words), covering its whole input space."""
    sub = rng.random(n) < 0.8
    all_c = (1 << c) - 1
    return dict(
        gseeds=(int(rng.integers(0, 1 << 32)), int(rng.integers(0, 1 << 32))),
        ctrl=torch.from_numpy(rng.integers(0, 64, size=(c, n)).astype(
            np.uint8)),
        fresh=_sparse(rng, (w_words, n)), adv=_words(rng, (w_words, n)),
        sub_all=torch.from_numpy(np.where(sub, all_c, 0).astype(np.int32)),
        cand_sub=_words(rng, (n,), c), fanout=_sparse(rng, (n,)) & all_c,
        wa=_words(rng, (n,), c), grafts=_sparse(rng, (n,)) & all_c,
        dropped=_sparse(rng, (n,)) & all_c, meshsel=_words(rng, (n,), c),
        seen=_sparse(rng, (w_words, n)),
        injected=_sparse(rng, (w_words, n)) & 0x0F0F,
        backoff=torch.from_numpy(rng.integers(0, 61, size=(c, n)).astype(
            np.int16)))


def _np(t):
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 else t.numpy()


@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("w_words", [1, 2])
def test_unscored_receive_plain_matches_pallas_kernel(ref, c, w_words):
    import jax.numpy as jnp

    small = dict(d=3, d_lo=2, d_hi=6, d_score=2, d_out=1, d_lazy=2)
    offsets = ref.gs.make_gossip_offsets(T, c, N, seed=3)
    kw = small if c == 8 else {}
    cfg = ref.gs.GossipSimConfig(offsets=offsets, n_topics=T, **kw)
    k = prc.receive_consts(
        pgs.GossipSimConfig(offsets=offsets, n_topics=T, **kw), None)
    assert not k.scored
    ops = unscored_operands(np.random.default_rng(20 + c + w_words), c, N,
                            w_words)
    got = prc.receive_update(k, **ops)       # CPU tensors: plain version

    rc = ref.receive
    pln = rc.plan(N, cfg.offsets, BLOCK)

    def flat(rows, p, e):
        return jnp.concatenate([
            rc.extend_wrap(jnp.asarray(r), N, pln["n_pad"], pln[p],
                           pln[e]) for r in rows])

    krn = rc.make_receive_update(cfg, None, N, BLOCK, jnp.float32, w_words,
                                 interpret=True)
    flats = [flat(list(_np(ops["ctrl"])), "p8", "e8"),
             flat(list(_np(ops["fresh"])), "p32", "e32"),
             flat(list(_np(ops["adv"])), "p32", "e32")]
    syb = np.zeros(N, dtype=np.uint32)
    bo2 = np.zeros(N, dtype=np.uint32)        # read only by scored configs
    blocked = [_np(ops[n_]) for n_ in ("sub_all", "cand_sub", "fanout")]
    blocked += [syb, _np(ops["wa"]), bo2]
    blocked += [_np(ops[n_]) for n_ in ("grafts", "dropped", "meshsel",
                                         "seen", "injected", "backoff")]
    want = krn(jnp.asarray(np.array(ops["gseeds"], dtype=np.uint32)),
               jnp.zeros((1,), jnp.uint32), *flats,
               *[jnp.asarray(b) for b in blocked])
    names = ("acq", "mesh", "backoff", "g_targets", "g_backoff")
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)
    # non-vacuous: the handshake moved and targets were drawn
    assert (got[1] != ops["meshsel"]).any()
    assert int(pg.popcount32(got[3]).sum()) > 0
    assert int(pg.popcount32(got[0]).sum()) > 0
