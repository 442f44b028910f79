"""Card-only tests of the port: each CUDA kernel against its plain
PyTorch version at a small size (the receive kernel scored, unscored,
with its attack options and paired, the select kernel, the fused-window
kernel with Bernoulli and exact-k targets), and the scored step (plain,
under every attack formation at once, and with each router-surface
option — flood publishing, exact-k targets, PX rotation, the shared-IP
gater, direct peers — alone and all together, scored and unscored), the
paired step (alone and with everything on, scored and unscored) and the
unscored fused window on the card against the CPU; each receive variant
and the fused window under a fault schedule (churn, link loss, a
partition; the window also with cold restart); each receive family and
the fused window with telemetry (clean and faulted: each tick's frame and
state, the card against the CPU; the fused kernel's per-tick mesh and
tally rows against its plain version); and four whole runs at 100,000
peers (everything-on single-topic and paired for 400 ticks, the churn
benchmark for its 250, the telemetry benchmark's flagship for 100 with
its frames), the card against the CPU by a digest of every state leaf
(and frame field) every 25th tick, and two knob points of the knob sweep
at 100,000 peers for 100 ticks the same way; each receive family's knob
variant (clean and faulted, with and without telemetry) at a non-default
point, card against CPU, and the knob step's host syncs; each delayed
variant on a real tick of its delayed sim against its plain version, each
delayed family's step (clean, at a knob point, under faults, with
telemetry) card against CPU, and the pipelined benchmark's base4j2 point
at 100,000 peers card against CPU every 12th tick; each family's step
with the invariant checker on (clean, under faults, with telemetry, at a
knob point; the delayed families) card against CPU with the carry, the
checker's host syncs (none added), and the invariants benchmark's armed
flagship at 100,000 peers card against CPU every 10th tick; the select
kernel at C = 32 on a real tick of the C = 32 split loops, and the receive
loops' two forms (the tournament's byzantine cell, the P3/P3b flagship)
at 100,000 peers card against CPU every 25th tick.  Exact: every output
bit for bit, but
a frame's ``score_mean``: the mean of non-integer f32 scores, which the
card and the CPU sum in different orders (relative 1e-5).

They skip without a card; on the card run
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``
(``tests/conftest.py`` imports JAX, which the port's machine need not
have).
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import (
    churn,
    convert,
    everything,
    invariants_flagship,
    knob_sweep,
    loops_flagship,
    pipelined,
    telemetry_flagship,
)
from go_libp2p_pubsub_tpu_torch.models import delays as pdl
from go_libp2p_pubsub_tpu_torch.models import faults as pfl
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import invariants as piv
from go_libp2p_pubsub_tpu_torch.models import telemetry as ptl
from go_libp2p_pubsub_tpu_torch.ops import graph as pg
from go_libp2p_pubsub_tpu_torch.ops.kernels import fused as pfused
from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as prc
from go_libp2p_pubsub_tpu_torch.ops.kernels import select as psel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")
    return torch.device("cuda")


def _words(rng, shape, bits=32):
    a = rng.integers(0, 1 << bits, size=shape, dtype=np.uint64)
    return torch.from_numpy(a.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("c", [8, 16, 32])
def test_select_kernel_matches_plain(cuda, c):
    rng = np.random.default_rng(c)
    n = 50_000
    elig = _words(rng, (n,), c)
    k = torch.from_numpy(rng.integers(0, c + 3, n).astype(np.int32))
    seed = pg.lane_seed(5, 4, 77)
    want = psel.select_k_bits_plain(elig, k, c, seed, n)
    before = psel.launches
    got = psel.select_k_bits(elig.to(cuda), k.to(cuda), c, seed, n)
    torch.cuda.synchronize()
    assert psel.launches == before + 1
    assert torch.equal(got.cpu(), want)


def test_select_kernel_at_c32_on_a_real_tick(cuda):
    """B3's C = 32 instantiation against its plain version on every call
    of a real tick of the C = 32 split loops (bit 31 an edge)."""
    cfg, sc, params, state, _ = loops_flagship.build("wide", "cpu",
                                                     n_peers=20_000,
                                                     horizon=30)
    step = pgs.make_gossip_step(cfg, sc, device="cpu")
    state = pgs.gossip_run(params, state, 8, step, device="cpu")
    calls = []
    real = psel.select_k_bits

    def capture(*args):
        calls.append(args)
        return real(*args)
    psel.select_k_bits = capture
    try:
        step(params, state)
    finally:
        psel.select_k_bits = real
    assert calls and all(a[2] == 32 for a in calls)
    assert any(bool(((a[0] >> 31) & 1).any()) for a in calls)
    for elig, k, c, seed, stride in calls:
        got = psel.select_k_bits(elig.to(cuda), k.to(cuda), c, seed, stride)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(),
                           psel.select_k_bits_plain(elig, k, c, seed, stride))


RECEIVE_CASES = {
    "w1": (1, 16, {}), "w2": (2, 16, {}),
    "c8": (1, 8, {}),
    "f32_counters": (1, 16, dict(counter_dtype="float32")),
    "bp_f32": (2, 16, dict(behaviour_penalty_decay=0.99)),
}


@pytest.mark.parametrize("case", sorted(RECEIVE_CASES))
def test_receive_kernel_matches_plain_on_a_real_tick(cuda, case):
    w_words, c, sc_kw = RECEIVE_CASES[case]
    n, t = 4096, 4
    offsets = pgs.make_gossip_offsets(t, c, n, seed=1)
    small = dict(d=3, d_lo=2, d_hi=6, d_score=2, d_out=1, d_lazy=2)
    cfg = pgs.GossipSimConfig(offsets=offsets, n_topics=t,
                              **(small if c == 8 else {}))
    sc = pgs.ScoreSimConfig(**sc_kw)
    rng = np.random.default_rng(w_words)
    m = 32 * w_words
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    topic = rng.integers(0, t, m)
    origin = rng.integers(0, n // t, m) * t + topic
    ticks = np.sort(rng.integers(0, 20, m)).astype(np.int32)
    sim = pgs.make_gossip_sim(
        cfg, subs, topic, origin, ticks, score_cfg=sc, device="cpu",
        app_score=rng.normal(0, 0.5, n).astype(np.float32),
        msg_invalid=rng.random(m) < 0.3, sybil=rng.random(n) < 0.2)
    params, state = sim
    step = pgs.make_gossip_step(cfg, sc, device="cpu")
    captured = []
    real = prc.receive_update

    def capture(k, **ops):
        captured.append((k, ops))
        return real(k, **ops)

    prc.receive_update = capture
    try:
        for _ in range(15):
            state = step(params, state)[0]
    finally:
        prc.receive_update = real
    k, ops = captured[-1]
    want = prc.receive_update_plain(k, **ops)
    ops_g = {name: (v.to(cuda) if isinstance(v, torch.Tensor) else v)
             for name, v in ops.items()}
    got = prc.receive_update(k, **ops_g)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), w), f"output {i}"


def test_step_on_the_card_matches_the_cpu(cuda):
    n, t, c, m = 8192, 8, 16, 40
    offsets = pgs.make_gossip_offsets(t, c, n, seed=2)
    cfg = pgs.GossipSimConfig(offsets=offsets, n_topics=t)
    sc = pgs.ScoreSimConfig(opportunistic_graft_ticks=9)
    rng = np.random.default_rng(3)
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    topic = rng.integers(0, t, m)
    origin = rng.integers(0, n // t, m) * t + topic
    ticks = np.sort(rng.integers(0, 20, m)).astype(np.int32)
    args = (cfg, subs, topic, origin, ticks)
    p_c, s_c = pgs.make_gossip_sim(*args, score_cfg=sc, device="cpu")
    p_g, s_g = pgs.make_gossip_sim(*args, score_cfg=sc, device=cuda)
    step_c = pgs.make_gossip_step(cfg, sc, device="cpu")
    step_g = pgs.make_gossip_step(cfg, sc, device=cuda)
    r0, s0 = prc.launches["scored"], psel.launches
    for tick in range(25):
        s_c = step_c(p_c, s_c)[0]
        s_g = step_g(p_g, s_g)[0]
        a, b = convert.state_to_numpy(s_c), convert.state_to_numpy(s_g)
        for name in ("mesh", "fanout", "backoff", "have", "recent",
                     "first_tick", "iwant_serves"):
            np.testing.assert_array_equal(a[name], b[name],
                                          err_msg=f"{tick} {name}")
        for name in a["scores"]:
            np.testing.assert_array_equal(a["scores"][name],
                                          b["scores"][name],
                                          err_msg=f"{tick} {name}")
        for i, (x, y) in enumerate(zip(a["gates"], b["gates"])):
            np.testing.assert_array_equal(x, y, err_msg=f"{tick} gate {i}")
    assert prc.launches["scored"] - r0 == 25
    assert psel.launches - s0 >= 50


SMALL = dict(d=3, d_lo=2, d_hi=6, d_score=2, d_out=1, d_lazy=2)


def _unscored_sim(c, w_words, n=4096, t=4, seed=1, **cfg_kw):
    offsets = pgs.make_gossip_offsets(t, c, n, seed=seed)
    cfg = pgs.GossipSimConfig(offsets=offsets, n_topics=t,
                              **{**(SMALL if c == 8 else {}), **cfg_kw})
    rng = np.random.default_rng(seed + w_words)
    m = 32 * w_words - 4
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    subs[rng.random(n) < 0.05] = False
    topic = rng.integers(0, t, m)
    origin = rng.integers(0, n // t, m) * t + topic
    ticks = np.sort(rng.integers(0, 20, m)).astype(np.int32)
    return (cfg, *pgs.make_gossip_sim(cfg, subs, topic, origin, ticks,
                                      seed=seed, device="cpu"))


def _to(ops, dev):
    return {name: (v.to(dev) if isinstance(v, torch.Tensor) else v)
            for name, v in ops.items()}


@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("w_words", [1, 2])
def test_unscored_receive_kernel_matches_plain_on_a_real_tick(cuda, c,
                                                              w_words):
    cfg, params, state = _unscored_sim(c, w_words)
    step = pgs.make_gossip_step(cfg, None, device="cpu")
    captured = []
    real = prc.receive_update

    def capture(k, **ops):
        captured.append((k, ops))
        return real(k, **ops)

    prc.receive_update = capture
    try:
        for _ in range(6):
            state = step(params, state)[0]
    finally:
        prc.receive_update = real
    before = prc.launches["unscored"]
    for k, ops in (captured[1], captured[-1]):
        want = prc.receive_update_plain(k, **ops)
        got = prc.receive_update(k, **_to(ops, cuda))
        torch.cuda.synchronize()
        assert len(got) == 5
        for i, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g.cpu(), w), f"output {i}"
    assert prc.launches["unscored"] == before + 2


def _fused_kernel_against_plain(cuda, c, w_words, **cfg_kw):
    cfg, params, state = _unscored_sim(c, w_words, **cfg_kw)
    state = pgs.make_gossip_step(cfg, None, device="cpu")(params, state)[0]
    T = 8
    tk = torch.arange(state.tick, state.tick + T, dtype=torch.int32)
    all_c = (1 << c) - 1
    ops = dict(
        tick0=state.tick, seeds=pfused.window_seeds(state.tick, T,
                                                    state.salt),
        due=pg.pack_bits(params.publish_tick[None, :] == tk[:, None]),
        sub_all=torch.where(params.subscribed, all_c, 0).to(torch.int32),
        cand_sub=params.cand_sub_bits, origin=params.origin_words,
        have=state.have, recent=state.recent, mesh=state.mesh,
        fanout=state.fanout, last_pub=state.last_pub,
        backoff=state.backoff, tgt=state.gates[0], bog=state.gates[1])
    k = pfused.fused_consts(cfg)
    want = pfused.fused_gossip_update_plain(k, **ops)
    before = pfused.launches
    ops_g = _to(ops, cuda)
    got = pfused.fused_gossip_update(k, **ops_g)
    torch.cuda.synchronize()
    assert pfused.launches == before + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), w), f"output {i}"
    # the inputs are not modified
    for name in ("have", "recent", "mesh", "backoff"):
        assert torch.equal(ops_g[name].cpu(), ops[name]), name
    return k, got


@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("w_words", [1, 2])
def test_fused_kernel_matches_plain(cuda, c, w_words):
    _fused_kernel_against_plain(cuda, c, w_words)


@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("w_words", [1, 2])
def test_fused_kernel_exact_k_matches_plain(cuda, c, w_words):
    k, got = _fused_kernel_against_plain(cuda, c, w_words,
                                         binomial_gossip_sampling=False)
    assert k.receive.exact_k and int(pg.popcount32(got[6]).sum()) > 0


def test_fused_window_on_the_card_matches_the_cpu(cuda):
    cfg, p_c, s_c = _unscored_sim(16, 1, n=8192, t=8, seed=3)
    p_g = pgs.GossipParams(**{
        f: (v.to(cuda) if isinstance(v, torch.Tensor) else v)
        for f, v in vars(p_c).items()})
    s_g = convert.state_from_numpy(convert.state_to_numpy(s_c), None, cuda)
    win_c = pgs.make_fused_window(cfg, None, ticks_fused=8, device="cpu")
    win_g = pgs.make_fused_window(cfg, None, ticks_fused=8, device=cuda)
    r0, s0, f0 = prc.launches["unscored"], psel.launches, pfused.launches
    s_c = pgs.gossip_run_fused(p_c, s_c, 32, win_c, device="cpu")
    s_g = pgs.gossip_run_fused(p_g, s_g, 32, win_g, device=cuda)
    a, b = convert.state_to_numpy(s_c), convert.state_to_numpy(s_g)
    for name in ("mesh", "fanout", "last_pub", "backoff", "have", "recent",
                 "first_tick"):
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    for i, (x, y) in enumerate(zip(a["gates"], b["gates"])):
        np.testing.assert_array_equal(x, y, err_msg=f"gate {i}")
    assert pfused.launches - f0 == 4
    assert (prc.launches["unscored"], psel.launches) == (r0, s0)


ATTACK_FLAGS = {
    "track_promises": dict(track_promises=True),
    "ihave_spam": dict(ihave_spam=True),
    "iwant_spam": dict(iwant_spam=True),
    "all": dict(track_promises=True, ihave_spam=True, iwant_spam=True),
}


def _attack_sim(c, w_words, n=4096, t=4, seed=5, device="cpu"):
    """Every attack formation at once: IHAVE and IWANT spam, graft flood
    and eclipse, promise breakers, invalid messages."""
    offsets = pgs.make_gossip_offsets(t, c, n, seed=seed)
    cfg = pgs.GossipSimConfig(offsets=offsets, n_topics=t, backoff_ticks=6,
                              **(SMALL if c == 8 else {}))
    sc = pgs.ScoreSimConfig(sybil_ihave_spam=True, sybil_iwant_spam=True,
                            sybil_graft_flood=True, sybil_eclipse=True)
    rng = np.random.default_rng(seed + w_words)
    m = 32 * w_words - 2
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    es = np.zeros(n, dtype=bool)
    es[: n // 10] = True
    ev = np.zeros(n, dtype=bool)
    ev[n // 10: n // 5] = True
    origin = rng.integers(n // 5, n, m)
    ticks = np.sort(rng.integers(0, 20, m)).astype(np.int32)
    sim = pgs.make_gossip_sim(
        cfg, subs, origin % t, origin, ticks, score_cfg=sc, device=device,
        msg_invalid=rng.random(m) < 0.2, sybil=rng.random(n) < 0.2,
        promise_break=rng.random(n) < 0.1, eclipse_sybil=es,
        eclipse_victim=ev)
    return (cfg, sc, *sim)


@pytest.mark.parametrize("flags", sorted(ATTACK_FLAGS))
@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("w_words", [1, 2])
def test_attack_receive_kernel_matches_plain_on_a_real_tick(cuda, flags, c,
                                                            w_words):
    cfg, sc, params, state = _attack_sim(c, w_words)
    step = pgs.make_gossip_step(cfg, sc, device="cpu")
    captured = []
    real = prc.receive_update

    def capture(k, **ops):
        captured.append((k, ops))
        return real(k, **ops)

    prc.receive_update = capture
    try:
        for _ in range(12):
            state = step(params, state)[0]
    finally:
        prc.receive_update = real
    k, ops = captured[-1]
    off = dict(track_promises=False, ihave_spam=False, iwant_spam=False)
    k = dataclasses.replace(k, **{**off, **ATTACK_FLAGS[flags]})
    assert int(ops["syb"].ne(0).sum()) > 0
    want = prc.receive_update_plain(k, **ops)
    before = prc.launches["attacks"]
    got = prc.receive_update(k, **_to(ops, cuda))
    torch.cuda.synchronize()
    assert prc.launches["attacks"] == before + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), w), f"output {i}"


def test_attack_step_on_the_card_matches_the_cpu(cuda):
    cfg, sc, p_c, s_c = _attack_sim(16, 1, n=8192, t=8)
    _, _, p_g, s_g = _attack_sim(16, 1, n=8192, t=8, device=cuda)
    step_c = pgs.make_gossip_step(cfg, sc, device="cpu")
    step_g = pgs.make_gossip_step(cfg, sc, device=cuda)
    r0, a0 = prc.launches["scored"], prc.launches["attacks"]
    for tick in range(20):
        s_c = step_c(p_c, s_c)[0]
        s_g = step_g(p_g, s_g)[0]
        a, b = convert.state_to_numpy(s_c), convert.state_to_numpy(s_g)
        for name in ("mesh", "fanout", "backoff", "have", "recent",
                     "iwant_serves"):
            np.testing.assert_array_equal(a[name], b[name],
                                          err_msg=f"{tick} {name}")
        for name in a["scores"]:
            np.testing.assert_array_equal(a["scores"][name],
                                          b["scores"][name],
                                          err_msg=f"{tick} {name}")
        for i, (x, y) in enumerate(zip(a["gates"], b["gates"])):
            np.testing.assert_array_equal(x, y, err_msg=f"{tick} gate {i}")
    assert (prc.launches["attacks"] - a0,
            prc.launches["scored"] - r0) == (20, 0)
    assert float(s_g.scores.behaviour_penalty.float().max()) > 0
    assert pgs.eclipse_takeover(s_g, p_g, cfg) > 0


SURFACE = {
    "flood": dict(sc=dict(flood_publish=True)),
    "exact_k": dict(exact_k=True),
    "exact_k_unscored": dict(exact_k=True, score=False),
    "px": dict(px=True),
    "px_unscored": dict(px=True, score=False),
    "same_ip": dict(shared_ip=True),
    "direct": dict(direct=True),
    "all": dict(exact_k=True, px=True, shared_ip=True, direct=True,
                sc=dict(flood_publish=True, sybil_ihave_spam=True,
                        sybil_iwant_spam=True, topic_score_cap=50.0)),
}


def _surface_sim(option, c, w_words, device, n=4060, t=4, seed=6):
    """A sim with the named router-surface option (n a multiple of 29:
    the direct overlay tiles the ring)."""
    case = SURFACE[option]
    offsets = pgs.make_gossip_offsets(t, c, n, seed=seed)
    cfg = pgs.GossipSimConfig(
        offsets=offsets, n_topics=t, backoff_ticks=6,
        binomial_gossip_sampling=not case.get("exact_k"),
        **(SMALL if c == 8 else {}))
    scored = case.get("score", True)
    sc = pgs.ScoreSimConfig(**case.get("sc", {})) if scored else None
    rng = np.random.default_rng(seed + w_words)
    m = 32 * w_words - 2
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    sybil = rng.random(n) < 0.2
    origin = np.flatnonzero(~sybil)[rng.integers(0, (~sybil).sum(), m)]
    ticks = np.sort(rng.integers(0, 16, m)).astype(np.int32)
    kw = {}
    if scored:
        kw = dict(sybil=sybil, msg_invalid=rng.random(m) < 0.25,
                  app_score=rng.normal(0, 0.1, n).astype(np.float32))
        if case.get("shared_ip"):
            ip = np.arange(n)
            sid = np.flatnonzero(sybil)
            ip[sid] = n + np.arange(len(sid)) // 4
            kw["peer_ip"] = ip
    if case.get("direct"):
        f = (np.arange(n) % 29) == 0
        de = np.zeros((n, c), dtype=bool)
        for c_ in (0, cfg.cinv[0]):
            de[:, c_] = f | np.roll(f, -int(offsets[c_]))
        kw["direct_edges"] = de
    if case.get("px"):
        kw["px_candidates"] = cfg.d_hi + 1
    return (cfg, sc, *pgs.make_gossip_sim(
        cfg, subs, origin % t, origin, ticks, seed=seed, score_cfg=sc,
        device=device, **kw))


@pytest.mark.parametrize("option", sorted(SURFACE))
@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("w_words", [1, 2])
def test_surface_step_on_the_card_matches_the_cpu(cuda, option, c, w_words):
    cfg, sc, p_c, s_c = _surface_sim(option, c, w_words, "cpu")
    _, _, p_g, s_g = _surface_sim(option, c, w_words, cuda)
    step_c = pgs.make_gossip_step(cfg, sc, device="cpu")
    step_g = pgs.make_gossip_step(cfg, sc, device=cuda)
    active0 = s_c.active
    before = _launch_counts()[:4]
    for tick in range(20):
        s_c = step_c(p_c, s_c)[0]
        s_g = step_g(p_g, s_g)[0]
        a, b = convert.state_to_numpy(s_c), convert.state_to_numpy(s_g)
        for name in ("mesh", "fanout", "backoff", "have", "recent",
                     "iwant_serves", "active"):
            if a[name] is None:
                assert b[name] is None, name
                continue
            np.testing.assert_array_equal(a[name], b[name],
                                          err_msg=f"{tick} {name}")
        for name in a["scores"] or ():
            np.testing.assert_array_equal(a["scores"][name],
                                          b["scores"][name],
                                          err_msg=f"{tick} {name}")
        for i, (x, y) in enumerate(zip(a["gates"], b["gates"])):
            np.testing.assert_array_equal(x, y, err_msg=f"{tick} gate {i}")
    after = _launch_counts()[:4]
    moved = tuple(y - x for x, y in zip(before, after))
    # direct peers ride the gate words: no kernel option of their own
    assert moved == ((20, 0, 0, 0) if option == "direct" else (0, 0, 0, 20))
    assert int(pg.popcount32(s_g.have).sum()) > 0
    if active0 is not None:
        assert (s_g.active.cpu() != active0).any()
    if p_g.cand_direct is not None:
        assert not (s_g.mesh & p_g.cand_direct).any()


PAIRED = {
    "alone": dict(),
    "unscored": dict(score=False),
    # every option of the full variant, scored; unscored, PX, direct
    # peers and exact-k
    "everything": dict(px=True, shared_ip=True, direct=True,
                       sc=dict(flood_publish=True, sybil_ihave_spam=True,
                               sybil_iwant_spam=True, topic_score_cap=50.0)),
    "everything_unscored": dict(score=False, px=True, direct=True,
                                exact_k=True),
}


def _paired_sim(option, c, w_words, device, n=4060, t=4, seed=8):
    """A paired-topic sim with the named options (n a multiple of 29:
    the direct overlay tiles the ring)."""
    case = PAIRED[option]
    offsets = pgs.make_gossip_offsets(t, c, n, seed=seed, paired=True)
    cfg = pgs.GossipSimConfig(
        offsets=offsets, n_topics=t, paired_topics=True, backoff_ticks=6,
        binomial_gossip_sampling=not case.get("exact_k"),
        **(SMALL if c == 8 else {}))
    scored = case.get("score", True)
    sc = pgs.ScoreSimConfig(**case.get("sc", {})) if scored else None
    rng = np.random.default_rng(seed + w_words)
    m = 32 * w_words - 2
    own = np.arange(n) % t
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), own] = True
    subs[np.arange(n), (own + t // 2) % t] = True
    sybil = rng.random(n) < 0.2
    origin = np.flatnonzero(~sybil)[rng.integers(0, (~sybil).sum(), m)]
    ticks = np.sort(rng.integers(0, 16, m)).astype(np.int32)
    kw = {}
    if scored:
        kw = dict(sybil=sybil, msg_invalid=rng.random(m) < 0.25,
                  app_score=rng.normal(0, 0.1, n).astype(np.float32))
        if case.get("shared_ip"):
            ip = np.arange(n)
            sid = np.flatnonzero(sybil)
            ip[sid] = n + np.arange(len(sid)) // 4
            kw["peer_ip"] = ip
    if case.get("direct"):
        f = (np.arange(n) % 29) == 0
        de = np.zeros((n, c), dtype=bool)
        for c_ in (0, cfg.cinv[0]):
            de[:, c_] = f | np.roll(f, -int(offsets[c_]))
        kw["direct_edges"] = de
    if case.get("px"):
        kw["px_candidates"] = cfg.d_hi + 1
    return (cfg, sc, *pgs.make_gossip_sim(
        cfg, subs, origin % t, origin, ticks, seed=seed, score_cfg=sc,
        device=device, **kw))


def _launch_counts():
    return tuple(prc.launches[v] for v in (
        "scored", "attacks", "unscored", "full", "paired", "paired_unscored"))


@pytest.mark.parametrize("option", sorted(PAIRED))
@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("w_words", [1, 2])
def test_paired_step_on_the_card_matches_the_cpu(cuda, option, c, w_words):
    cfg, sc, p_c, s_c = _paired_sim(option, c, w_words, "cpu")
    _, _, p_g, s_g = _paired_sim(option, c, w_words, cuda)
    step_c = pgs.make_gossip_step(cfg, sc, device="cpu")
    step_g = pgs.make_gossip_step(cfg, sc, device=cuda)
    before = _launch_counts()
    for tick in range(20):
        s_c = step_c(p_c, s_c)[0]
        s_g = step_g(p_g, s_g)[0]
        a, b = convert.state_to_numpy(s_c), convert.state_to_numpy(s_g)
        for name in ("mesh", "mesh_b", "fanout", "backoff", "backoff_b",
                     "have", "recent", "iwant_serves", "active"):
            if a[name] is None:
                assert b[name] is None, name
                continue
            np.testing.assert_array_equal(a[name], b[name],
                                          err_msg=f"{tick} {name}")
        for name, v in (a["scores"] or {}).items():
            if v is not None:
                np.testing.assert_array_equal(v, b["scores"][name],
                                              err_msg=f"{tick} {name}")
        assert len(a["gates"]) == (8 if sc is not None else 3)
        for i, (x, y) in enumerate(zip(a["gates"], b["gates"])):
            np.testing.assert_array_equal(x, y, err_msg=f"{tick} gate {i}")
    moved = tuple(y - x for x, y in zip(before, _launch_counts()))
    assert moved == ((0, 0, 0, 0, 20, 0) if sc is not None
                     else (0, 0, 0, 0, 0, 20))
    assert bool(s_g.mesh_b.any()) and int(pg.popcount32(s_g.have).sum()) > 0


@pytest.mark.parametrize("option", ["everything", "everything_unscored"])
@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("w_words", [1, 2])
def test_paired_receive_kernel_matches_plain_on_random_operands(
        cuda, option, c, w_words):
    """The operands of a real paired tick with every handshake word, both
    ctrl bytes and the slot-B sender words redrawn at random."""
    cfg, sc, params, state = _paired_sim(option, c, w_words, "cpu")
    step = pgs.make_gossip_step(cfg, sc, device="cpu")
    captured = []
    real = prc.receive_update

    def capture(k, **ops):
        captured.append((k, ops))
        return real(k, **ops)

    prc.receive_update = capture
    try:
        for _ in range(6):
            state = step(params, state)[0]
    finally:
        prc.receive_update = real
    k, ops = captured[-1]
    assert k.paired and k.odd_mask
    rng = np.random.default_rng(70 + c + w_words)
    n = ops["sub_all"].shape[0]
    for name in ("wa", "grafts", "dropped", "meshsel", "wa_b", "grafts_b",
                 "dropped_b", "meshsel_b", "fanout"):
        ops[name] = _words(rng, (n,), c)
    ops["fresh_b"] = _words(rng, (w_words, n)) & _words(rng, (w_words, n))
    ops["ctrl"] = torch.from_numpy(
        rng.integers(0, 128, size=(c, n)).astype(np.uint8))
    ops["ctrl2"] = torch.from_numpy(
        rng.integers(0, 16, size=(c, n)).astype(np.uint8))
    ops["backoff_b"] = torch.from_numpy(
        rng.integers(0, 7, size=(c, n)).astype(np.int16))
    if sc is not None:
        for name in ("bo2", "bo2_b", "acc", "pay"):
            ops[name] = _words(rng, (n,), c)
        ops["tim_b"] = torch.from_numpy(
            rng.integers(0, 32767, size=(c, n)).astype(np.int16))
    want = prc.receive_update_plain(k, **ops)
    before = _launch_counts()
    got = prc.receive_update(k, **_to(ops, cuda))
    torch.cuda.synchronize()
    assert sum(_launch_counts()) == sum(before) + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), w), f"output {i}"


def _sched(n, cold=False):
    """Churn waves over ticks 2-12, 5% link loss, a half/half partition
    over ticks [8, 14)."""
    rng = np.random.default_rng(n)
    victims = np.flatnonzero(rng.random(n) < 0.1)
    return pfl.FaultSchedule(
        n_peers=n, horizon=64,
        down_intervals=[(int(p), 2 + int(p % 3), 9 + int(p % 3))
                        for p in victims],
        drop_prob=0.05, partition_group=(np.arange(n) < n // 2).astype(int),
        partition_windows=[(8, 14)], seed=11, cold_restart=cold)


def _faulted(sim, device, cold=False):
    """``sim`` (cfg, sc, params, state) under ``_sched``, compiled as
    ``make_gossip_sim(fault_schedule=...)`` compiles it."""
    cfg, sc, params, state = sim
    n = params.subscribed.shape[0]
    fp = pfl.compile_faults(_sched(n, cold), cfg.offsets, device=device)
    return cfg, sc, dataclasses.replace(params, faults=fp), state


#: each receive family under faults: its sim, and its kernel variant
FAULTED = {
    "scored": (lambda c, w, d: _surface_sim("direct", c, w, d),
               "scored_faults"),
    "unscored": (lambda c, w, d: (lambda s: (s[0], None, *s[1:]))(
        _unscored_sim(c, w, n=4060)), "unscored_faults"),
    "attack": (lambda c, w, d: _attack_sim(c, w, device=d),
               "attacks_faults"),
    "full": (lambda c, w, d: _surface_sim("all", c, w, d),
             "full_faults"),
    "full_unscored": (lambda c, w, d: _surface_sim("px_unscored", c, w, d),
                      "full_faults"),
    "paired": (lambda c, w, d: _paired_sim("everything", c, w, d),
               "paired_faults"),
    "paired_unscored": (
        lambda c, w, d: _paired_sim("everything_unscored", c, w, d),
        "paired_unscored_faults"),
}


def _state_digest(state) -> str:
    """sha256 of every state leaf (bit patterns) and the tick."""
    h = hashlib.sha256()
    d = convert.state_to_numpy(state)
    for name in sorted(d):
        v = d[name]
        if isinstance(v, dict):
            v = [v[k] for k in sorted(v) if v[k] is not None]
        elif not isinstance(v, list):
            v = [v]
        for leaf in v:
            if leaf is not None:
                h.update(name.encode() + np.ascontiguousarray(
                    np.asarray(leaf)).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("family", sorted(FAULTED))
@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("w_words", [1, 2])
def test_faulted_step_on_the_card_matches_the_cpu(cuda, family, c,
                                                  w_words):
    build, variant = FAULTED[family]
    if family == "unscored":
        cfg, sc, p_c, s_c = _faulted(build(c, w_words, "cpu"), "cpu")
        p_g = pgs.GossipParams(**{
            f: (v.to(cuda) if isinstance(v, torch.Tensor) else v)
            for f, v in vars(p_c).items()})
        p_g.faults = pfl.compile_faults(_sched(4060), cfg.offsets,
                                        device=cuda)
        s_g = convert.state_from_numpy(convert.state_to_numpy(s_c), None,
                                       cuda)
    else:
        cfg, sc, p_c, s_c = _faulted(build(c, w_words, "cpu"), "cpu")
        _, _, p_g, s_g = _faulted(build(c, w_words, cuda), cuda)
    step_c = pgs.make_gossip_step(cfg, sc, device="cpu")
    step_g = pgs.make_gossip_step(cfg, sc, device=cuda)
    before = prc.launches[variant]
    for tick in range(20):
        s_c = step_c(p_c, s_c)[0]
        s_g = step_g(p_g, s_g)[0]
        assert _state_digest(s_c) == _state_digest(s_g), tick
    assert prc.launches[variant] - before == 20
    assert not bool(pfl.alive_mask(p_g.faults, 5).all())
    assert int(pg.popcount32(s_g.have).sum()) > 0


@pytest.mark.parametrize("cold", [False, True])
@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("w_words", [1, 2])
def test_faulted_fused_kernel_matches_plain(cuda, cold, c, w_words):
    cfg, params, state = _unscored_sim(c, w_words)
    fp = pfl.compile_faults(_sched(4096, cold), cfg.offsets, device="cpu")
    params = dataclasses.replace(params, faults=fp)
    step = pgs.make_gossip_step(cfg, None, device="cpu")
    state = pgs.gossip_run(params, state, 5, step, device="cpu")
    T = 8
    tk = torch.arange(state.tick, state.tick + T, dtype=torch.int32)
    all_c = (1 << c) - 1
    ops = dict(
        tick0=state.tick, seeds=pfused.window_seeds(state.tick, T,
                                                    state.salt),
        due=pg.pack_bits(params.publish_tick[None, :] == tk[:, None]),
        sub_all=torch.where(params.subscribed, all_c, 0).to(torch.int32),
        cand_sub=params.cand_sub_bits, origin=params.origin_words,
        have=state.have, recent=state.recent, mesh=state.mesh,
        fanout=state.fanout, last_pub=state.last_pub,
        backoff=state.backoff, tgt=state.gates[0], bog=state.gates[1],
        **pgs.window_fault_rows(cfg, fp, state.tick, T))
    assert ("rejoin" in ops) == cold
    k = pfused.fused_consts(cfg)
    want = pfused.fused_gossip_update_plain(k, **ops)
    before = pfused.launches_faults
    got = pfused.fused_gossip_update(k, **_to(ops, cuda))
    torch.cuda.synchronize()
    assert pfused.launches_faults == before + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), w), f"output {i}"
    if cold:
        assert bool(ops["rejoin"].any())


def _frame_digest(frame) -> str:
    """sha256 of every frame field but ``score_mean`` (bit patterns)."""
    h = hashlib.sha256()
    for name, v in sorted(convert.frame_to_numpy(frame).items()):
        if v is not None and name != "score_mean":
            h.update(name.encode() + np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def _assert_score_mean_close(f_c, f_g, where):
    # the mean of non-integer f32 scores: the card and the CPU sum them
    # in different orders
    np.testing.assert_allclose(f_g.score_mean.cpu().numpy(),
                               f_c.score_mean.numpy(), rtol=1e-5,
                               atol=1e-6, err_msg=where)


def _whole_run(build, ticks, cuda, telemetry=None):
    """Step the sim ``build(device)`` makes on the card and on the CPU
    for ``ticks`` heartbeats; the digests of both every 25th tick (with
    ``telemetry``, of the frames too)."""
    cfg, sc, p_c, s_c = build("cpu")[:4]
    _, _, p_g, s_g = build(cuda)[:4]
    step_c = pgs.make_gossip_step(cfg, sc, device="cpu", telemetry=telemetry)
    step_g = pgs.make_gossip_step(cfg, sc, device=cuda, telemetry=telemetry)
    out = []
    for tick in range(1, ticks + 1):
        s_c, _, *f_c = step_c(p_c, s_c)
        s_g, _, *f_g = step_g(p_g, s_g)
        if tick % 25 == 0:
            d_c, d_g = _state_digest(s_c), _state_digest(s_g)
            if telemetry is not None:
                d_c += _frame_digest(f_c[0])
                d_g += _frame_digest(f_g[0])
                _assert_score_mean_close(f_c[0], f_g[0], f"tick {tick}")
            out.append((tick, d_c, d_g))
    return out


WHOLE_RUNS = {
    "everything": (lambda d: everything.build(d, n_peers=100_000), 400),
    "everything_paired": (
        lambda d: everything.build(d, n_peers=100_000, paired=True), 400),
    "churn": (lambda d: churn.build(d, n_peers=100_000),
              churn.WARMUP + churn.TIMED),
    # the telemetry benchmark's flagship with TelemetryConfig() at its
    # defaults, frames in the digest
    "telemetry": (lambda d: telemetry_flagship.build(d, n_peers=100_000),
                  100),
    # the knob sweep's d8 point on the flagship and its hardened defense
    # on the IHAVE-spam configuration
    "knobs_d8": (lambda d: knob_sweep.flagship_sim(
        d, n_peers=100_000, sim_knobs=knob_sweep.FLAGSHIP_POINTS["d8"]),
        100),
    "knobs_hardened": (lambda d: knob_sweep.defense_sim(
        d, n_peers=100_000,
        sim_knobs=knob_sweep.DEFENSE_POINTS["hardened"]), 100),
    # the receive loops: combined (the tournament's byzantine cell at the
    # flagship's widths) and split (P3/P3b, one message a tick)
    "loops_byzantine": (lambda d: loops_flagship.build(
        "byzantine", d, n_peers=100_000, horizon=100), 100),
    "loops_p3": (lambda d: loops_flagship.build(
        "p3", d, n_peers=100_000, horizon=50), 50),
}


@pytest.mark.parametrize("path", sorted(WHOLE_RUNS))
def test_whole_run_on_the_card_matches_the_cpu(cuda, path):
    """The card's trajectory against the plain versions' on the CPU at
    100,000 peers (the CPU run equals the reference's XLA step, which
    tests/test_torch_*.py hold at small sizes): equal state digests at
    every 25th tick (the telemetry run: and frame digests)."""
    build, ticks = WHOLE_RUNS[path]
    digests = _whole_run(build, ticks, cuda, telemetry=(
        ptl.TelemetryConfig() if path == "telemetry" else None))
    assert len(digests) == ticks // 25
    for tick, d_c, d_g in digests:
        assert d_c == d_g, f"{path} tick {tick}"


def _knob_point(cfg, sc) -> dict:
    """A non-default knob point for the small sims: the degree family,
    gossip_factor, d_lazy and backoff_ticks off their defaults (within
    the PX ceiling Dhi + 1) and, scored, the defense knobs; only the
    defense knobs where the IWANT flood refuses a SimKnobs point."""
    if cfg.n_candidates == 8:
        point = {"d": 4, "d_hi": 5, "gossip_factor": 0.5,
                 "backoff_ticks": 5, "d_lazy": 3}
    else:
        point = {"d": 8, "d_lo": 6, "d_hi": 12, "d_lazy": 4,
                 "gossip_factor": 0.4, "backoff_ticks": 4}
    defense = {"graylist_threshold": -60.0, "behaviour_penalty_weight": -40.0,
               "invalid_message_deliveries_weight": -20.0,
               "gossip_threshold": -5.0}
    if sc is None:
        return dict(sim_knobs=point)
    if sc.sybil_iwant_spam:
        return dict(score_knobs=defense)
    return dict(sim_knobs=dict(point, **defense))


def _armed(sim, device):
    """``sim`` armed at ``_knob_point`` on ``device``."""
    cfg, sc, params, state = sim
    px = cfg.d_hi + 1 if state.active is not None else None
    params = pgs.knob_params(cfg, sc, params, px_candidates=px,
                             **_knob_point(cfg, sc))
    return cfg, sc, params, pgs.refresh_gates(cfg, sc, params, state)


@pytest.mark.parametrize("family", sorted(FAULTED))
@pytest.mark.parametrize("faulted", [False, True])
@pytest.mark.parametrize("tel", [False, True])
@pytest.mark.parametrize("c,w_words", [(8, 2), (16, 1)])
def test_knob_step_on_the_card_matches_the_cpu(cuda, family, faulted, tel,
                                               c, w_words):
    """Each receive family's knob variant (clean and under ``_sched``,
    with and without telemetry) at a non-default point on the card
    against its plain version on the CPU: every state leaf (and frame
    field) for 20 ticks, the variant launched once a tick."""
    build, variant = FAULTED[family]
    variant = ((variant if faulted else variant[:-len("_faults")])
               + ("+tel" if tel else "") + "+knobs")
    sim_c = build(c, w_words, "cpu")
    if family == "unscored":
        cfg, sc, p_c, s_c = sim_c
        p_g = pgs.GossipParams(**{
            f: (v.to(cuda) if isinstance(v, torch.Tensor) else v)
            for f, v in vars(p_c).items()})
        s_g = convert.state_from_numpy(convert.state_to_numpy(s_c), None,
                                       cuda)
        sim_g = (cfg, sc, p_g, s_g)
    else:
        sim_g = build(c, w_words, cuda)
    if faulted:
        sim_c, sim_g = _faulted(sim_c, "cpu"), _faulted(sim_g, cuda)
    cfg, sc, p_c, s_c = _armed(sim_c, "cpu")
    _, _, p_g, s_g = _armed(sim_g, cuda)
    tcfg = TEL_ALL if tel else None
    step_c = pgs.make_gossip_step(cfg, sc, device="cpu", telemetry=tcfg)
    step_g = pgs.make_gossip_step(cfg, sc, device=cuda, telemetry=tcfg)
    before = prc.launches[variant]
    for tick in range(20):
        s_c, _, *f_c = step_c(p_c, s_c)
        s_g, _, *f_g = step_g(p_g, s_g)
        assert _state_digest(s_c) == _state_digest(s_g), tick
        if tel:
            assert _frame_digest(f_c[0]) == _frame_digest(f_g[0]), tick
            _assert_score_mean_close(f_c[0], f_g[0], f"tick {tick}")
    assert prc.launches[variant] - before == 20


def test_knob_step_adds_no_host_sync(cuda):
    """The knob step on the card syncs with the host as often as the
    baked step does (the scored step's prune ``nonzero``), counted as
    ``torch.cuda.set_sync_debug_mode("warn")`` warnings."""
    import warnings

    sims = {"baked": _surface_sim("direct", 16, 1, cuda)}
    sims["knobs"] = _armed(sims["baked"], cuda)
    counts = {}
    for label, (cfg, sc, p, s) in sims.items():
        step = pgs.make_gossip_step(cfg, sc, device=cuda)
        s = step(p, s)[0]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                step(p, s)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        counts[label] = len(caught)
    assert counts["knobs"] == counts["baked"], counts


#: the telemetry tests' groups: every group, all three histograms
TEL_ALL = ptl.TelemetryConfig(latency_hist=True, degree_hist=True,
                              score_hist=True, latency_buckets=16)


@pytest.mark.parametrize("family", sorted(FAULTED))
@pytest.mark.parametrize("faulted", [False, True])
@pytest.mark.parametrize("c,w_words", [(8, 2), (16, 1)])
def test_telemetry_step_on_the_card_matches_the_cpu(cuda, family, faulted,
                                                    c, w_words):
    """Each receive family's telemetry variant (clean and under
    ``_sched``) on the card against the CPU: every state leaf and every
    frame field for 20 ticks, the variant launched once a tick."""
    build, variant = FAULTED[family]
    variant = (variant if faulted else variant[:-len("_faults")]) + "+tel"
    sim_c = build(c, w_words, "cpu")
    if family == "unscored":
        cfg, sc, p_c, s_c = sim_c
        p_g = pgs.GossipParams(**{
            f: (v.to(cuda) if isinstance(v, torch.Tensor) else v)
            for f, v in vars(p_c).items()})
        s_g = convert.state_from_numpy(convert.state_to_numpy(s_c), None,
                                       cuda)
        sim_g = (cfg, sc, p_g, s_g)
    else:
        sim_g = build(c, w_words, cuda)
    if faulted:
        sim_c, sim_g = _faulted(sim_c, "cpu"), _faulted(sim_g, cuda)
    cfg, sc, p_c, s_c = sim_c
    _, _, p_g, s_g = sim_g
    step_c = pgs.make_gossip_step(cfg, sc, device="cpu", telemetry=TEL_ALL)
    step_g = pgs.make_gossip_step(cfg, sc, device=cuda, telemetry=TEL_ALL)
    before = prc.launches[variant]
    payload = 0
    for tick in range(20):
        s_c, _, f_c = step_c(p_c, s_c)
        s_g, _, f_g = step_g(p_g, s_g)
        assert _state_digest(s_c) == _state_digest(s_g), tick
        assert _frame_digest(f_c) == _frame_digest(f_g), tick
        _assert_score_mean_close(f_c, f_g, f"tick {tick}")
        payload += int(f_g.payload_sent)
    assert prc.launches[variant] - before == 20
    assert payload > 0


@pytest.mark.parametrize("cold", [None, False, True])
@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("w_words", [1, 2])
def test_telemetry_fused_kernel_matches_plain(cuda, cold, c, w_words):
    """The fused kernel with telemetry (clean, faulted, cold restart)
    against its plain version: the carry, each tick's acquisitions, mesh
    row and tally; then 16 heartbeats on windows against the per-tick
    telemetry step, frames field by field."""
    cfg, params, state = _unscored_sim(c, w_words)
    if cold is not None:
        params = dataclasses.replace(params, faults=pfl.compile_faults(
            _sched(4096, cold), cfg.offsets, device="cpu"))
    step = pgs.make_gossip_step(cfg, None, device="cpu")
    state = pgs.gossip_run(params, state, 5, step, device="cpu")
    T, L = 8, 16
    tk = torch.arange(state.tick, state.tick + T, dtype=torch.int32)
    all_c = (1 << c) - 1
    ops = dict(
        tick0=state.tick, seeds=pfused.window_seeds(state.tick, T,
                                                    state.salt),
        due=pg.pack_bits(params.publish_tick[None, :] == tk[:, None]),
        sub_all=torch.where(params.subscribed, all_c, 0).to(torch.int32),
        cand_sub=params.cand_sub_bits, origin=params.origin_words,
        have=state.have, recent=state.recent, mesh=state.mesh,
        fanout=state.fanout, last_pub=state.last_pub,
        backoff=state.backoff, tgt=state.gates[0], bog=state.gates[1],
        lat_masks=ptl.latency_bucket_masks(params.publish_tick, tk[:, None],
                                           L, w_words),
        dlv=params.deliver_words,
        **pgs.window_fault_rows(cfg, params.faults, state.tick, T))
    k = pfused.fused_consts(cfg, telemetry=True, tel_lat_buckets=L)
    want = pfused.fused_gossip_update_plain(k, **ops)
    before = pfused.launches_tel
    got = pfused.fused_gossip_update(k, **_to(ops, cuda))
    torch.cuda.synchronize()
    assert pfused.launches_tel == before + 1
    assert len(got) == len(want) == 11
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), w), f"output {i}"
    win = pgs.make_fused_window(cfg, None, ticks_fused=T, device=cuda,
                                telemetry=TEL_ALL)
    step_g = pgs.make_gossip_step(cfg, None, device=cuda, telemetry=TEL_ALL)
    p_g = dataclasses.replace(params, **{
        f: v.to(cuda) for f, v in vars(params).items()
        if isinstance(v, torch.Tensor)})
    if params.faults is not None:
        p_g.faults = pfl.compile_faults(_sched(4096, cold), cfg.offsets,
                                        device=cuda)
    s_g = convert.state_from_numpy(convert.state_to_numpy(state), None, cuda)
    end_f, fr_f = pgs.gossip_run_frames_fused(p_g, s_g, 16, win, device=cuda)
    end_t, fr_t = ptl.telemetry_run(p_g, s_g, 16, step_g)
    assert _state_digest(end_f) == _state_digest(end_t)
    assert _frame_digest(fr_f) == _frame_digest(fr_t)
    assert int(fr_f.payload_sent.sum()) > 0


# -- delays -------------------------------------------------------------------

#: each receive family the delay mode serves: its sim (the IWANT flood off:
#: the delay mode refuses it) and its kernel variant
DELAYED = {
    "scored": (lambda c, w: _surface_sim("direct", c, w, "cpu"),
               "scored+delays"),
    "unscored": (lambda c, w: (lambda s: (s[0], None, *s[1:]))(
        _unscored_sim(c, w, n=4060)), "unscored+delays"),
    "attack": (lambda c, w: _attack_sim(c, w), "attacks+delays"),
    "full": (lambda c, w: _surface_sim("all", c, w, "cpu"), "full+delays"),
    "full_unscored": (lambda c, w: _surface_sim("px_unscored", c, w, "cpu"),
                      "full+delays"),
}
DELAYS = pdl.DelayConfig(base=3, jitter=2, k_slots=8)


def _delayed(family, c, w_words, mode, counters=False, device="cuda"):
    """The family's sim on the CPU with ``DELAYS`` armed (and, ``mode``
    ``knobs``, at ``_knob_point``; ``faults``, under ``_sched``), and its
    copy on ``device``."""
    cfg, sc, params, state = DELAYED[family][0](c, w_words)
    if sc is not None and sc.sybil_iwant_spam:
        sc = dataclasses.replace(sc, sybil_iwant_spam=False)
    params, state = pgs.arm_delays(sc, params, state, DELAYS,
                                   delays_counters=counters)
    sim = (cfg, sc, params, pgs.refresh_gates(cfg, sc, params, state))
    if mode == "knobs":
        sim = _armed(sim, "cpu")
    if mode == "faults":
        sim = _faulted(sim, "cpu")
    cfg, sc, params, state = sim
    gpu = (cfg, sc, convert.params_from_numpy(
        convert.params_to_numpy(params), device), convert.state_from_numpy(
        convert.state_to_numpy(state), sc, device))
    return sim, gpu


@pytest.mark.parametrize("family", sorted(DELAYED))
@pytest.mark.parametrize("knobs", [False, True])
@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("w_words", [1, 2])
def test_delayed_receive_kernel_matches_plain_on_a_real_tick(
        cuda, family, knobs, c, w_words):
    """Each delayed variant on the operands of tick 12 of its delayed sim
    (arrivals and retractions in flight) against its plain version."""
    (cfg, sc, params, state), _ = _delayed(
        family, c, w_words, "knobs" if knobs else "plain", device=cuda)
    step = pgs.make_gossip_step(cfg, sc, device="cpu")
    captured = []
    real = prc.receive_update

    def capture(k, **ops):
        captured[:] = [(k, ops)]
        return real(k, **ops)

    prc.receive_update = capture
    try:
        for _ in range(13):
            state = step(params, state)[0]
    finally:
        prc.receive_update = real
    k, ops = captured[-1]
    assert k.delays and k.knobs == knobs and int(ops["arr"].ne(0).sum()) > 0
    want = prc.receive_update_plain(k, **ops)
    before = prc.launches[prc.variant(k)]
    got = prc.receive_update(k, **_to(ops, cuda))
    torch.cuda.synchronize()
    assert prc.launches[prc.variant(k)] - before == 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), w), f"output {i}"


@pytest.mark.parametrize("family", sorted(DELAYED))
@pytest.mark.parametrize("mode", ["plain", "knobs", "faults", "telemetry"])
@pytest.mark.parametrize("c,w_words", [(8, 2), (16, 1)])
def test_delayed_step_on_the_card_matches_the_cpu(cuda, family, mode, c,
                                                  w_words):
    """Each family's delayed step on the card against the CPU for 20 ticks
    (clean, armed at a knob point, under ``_sched``, and with every
    telemetry group on the observer lines): every state leaf (and frame
    field), the delayed variant launched once a tick."""
    tel = mode == "telemetry"
    (cfg, sc, p_c, s_c), (_, _, p_g, s_g) = _delayed(
        family, c, w_words, mode, counters=tel, device=cuda)
    tcfg = TEL_ALL if tel else None
    step_c = pgs.make_gossip_step(cfg, sc, device="cpu", telemetry=tcfg)
    step_g = pgs.make_gossip_step(cfg, sc, device=cuda, telemetry=tcfg)
    variant = DELAYED[family][1] + ("+knobs" if mode == "knobs" else "")
    before = prc.launches[variant]
    for tick in range(20):
        s_c, _, *f_c = step_c(p_c, s_c)
        s_g, _, *f_g = step_g(p_g, s_g)
        assert _state_digest(s_c) == _state_digest(s_g), tick
        if tel:
            assert _frame_digest(f_c[0]) == _frame_digest(f_g[0]), tick
            _assert_score_mean_close(f_c[0], f_g[0], f"tick {tick}")
    assert prc.launches[variant] - before == 20
    assert bool(s_g.pay_line.any())


def test_pipelined_whole_run_on_the_card_matches_the_cpu(cuda):
    """The pipelined benchmark's base4j2 point at 100,000 peers, 48 ticks
    from build with its telemetry: the card against the CPU (which equals
    the reference's XLA step: tests/torch_reference_gate.py --pipelined
    --port) by the digest of every state leaf and frame field every 12th
    tick."""
    point = pipelined.POINTS["base4j2"]
    tcfg = ptl.TelemetryConfig(**pipelined.TELEMETRY)
    runs = {}
    for dev in ("cpu", cuda):
        cfg, sc, params, state = pipelined.arm(
            pipelined.build(dev, pipelined.N_PEERS), point)
        step = pgs.make_gossip_step(cfg, sc, device=dev, telemetry=tcfg)
        out = []
        for tick in range(1, pipelined.TICKS + 1):
            state, _, frame = step(params, state)
            if tick % 12 == 0:
                out.append(_state_digest(state) + _frame_digest(frame))
        runs[str(dev)] = out
    assert len(runs["cpu"]) == pipelined.TICKS // 12
    assert runs["cpu"] == runs[str(cuda)]


# -- the invariant checker ------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAULTED))
@pytest.mark.parametrize("mode", ["clean", "faults", "telemetry", "knobs"])
@pytest.mark.parametrize("c,w_words", [(8, 2), (16, 1)])
def test_armed_step_on_the_card_matches_the_cpu(cuda, family, mode, c,
                                                w_words):
    """Each receive family's step with the invariant checker on (clean,
    under ``_sched``, with every telemetry group, at ``_knob_point``) on
    the card against the CPU for 20 ticks: every state leaf, the two carry
    scalars too (and every frame field); the report clean."""
    build = FAULTED[family][0]
    sim_c = build(c, w_words, "cpu")
    cfg, sc, p, s = sim_c
    sim_g = (cfg, sc, convert.params_from_numpy(convert.params_to_numpy(p),
                                                cuda),
             convert.state_from_numpy(convert.state_to_numpy(s), sc, cuda))
    if mode == "faults":
        sim_c, sim_g = _faulted(sim_c, "cpu"), _faulted(sim_g, cuda)
    if mode == "knobs":
        sim_c, sim_g = _armed(sim_c, "cpu"), _armed(sim_g, cuda)
    cfg, sc, p_c, s_c = sim_c
    _, _, p_g, s_g = sim_g
    tcfg = TEL_ALL if mode == "telemetry" else None
    icfg = piv.InvariantConfig()
    step_c = pgs.make_gossip_step(cfg, sc, device="cpu", telemetry=tcfg,
                                  invariants=icfg)
    step_g = pgs.make_gossip_step(cfg, sc, device=cuda, telemetry=tcfg,
                                  invariants=icfg)
    s_c, s_g = piv.attach(s_c), piv.attach(s_g)
    for tick in range(20):
        s_c, _, *f_c = step_c(p_c, s_c)
        s_g, _, *f_g = step_g(p_g, s_g)
        assert _state_digest(s_c) == _state_digest(s_g), tick
        if tcfg is not None:
            assert _frame_digest(f_c[0]) == _frame_digest(f_g[0]), tick
            _assert_score_mean_close(f_c[0], f_g[0], f"tick {tick}")
    assert piv.report(s_g) == piv.report(s_c)
    assert piv.report(s_g)["bits"] == 0


@pytest.mark.parametrize("family", sorted(DELAYED))
@pytest.mark.parametrize("c,w_words", [(8, 2), (16, 1)])
def test_armed_delayed_step_on_the_card_matches_the_cpu(cuda, family, c,
                                                        w_words):
    """Each delayed family's step with the checker on, card against CPU
    for 20 ticks: every state leaf and the carry."""
    (cfg, sc, p_c, s_c), (_, _, p_g, s_g) = _delayed(family, c, w_words,
                                                     "plain", device=cuda)
    icfg = piv.InvariantConfig()
    step_c = pgs.make_gossip_step(cfg, sc, device="cpu", invariants=icfg)
    step_g = pgs.make_gossip_step(cfg, sc, device=cuda, invariants=icfg)
    s_c, s_g = piv.attach(s_c), piv.attach(s_g)
    for tick in range(20):
        s_c = step_c(p_c, s_c)[0]
        s_g = step_g(p_g, s_g)[0]
        assert _state_digest(s_c) == _state_digest(s_g), tick
    assert piv.report(s_g) == piv.report(s_c)
    assert bool(s_g.pay_line.any())


@pytest.mark.parametrize("family", ["scored", "full", "paired",
                                    "paired_unscored"])
def test_invariant_checker_adds_no_host_sync(cuda, family):
    """The armed step on the card syncs with the host as often as the step
    without the checker (the scored step's prune ``nonzero`` per topic
    slot), counted as ``torch.cuda.set_sync_debug_mode("warn")`` warnings,
    under faults so the alive word and the rejoin clear are read too."""
    import warnings

    cfg, sc, p, s = _faulted(FAULTED[family][0](16, 1, cuda), cuda,
                             cold=True)
    counts = {}
    for label, icfg in (("off", None), ("on", piv.InvariantConfig())):
        step = pgs.make_gossip_step(cfg, sc, device=cuda, invariants=icfg)
        s0 = piv.attach(s) if icfg is not None else s
        s0 = pgs.gossip_run(p, s0, 10, step, device=cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                step(p, s0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        counts[label] = len(caught)
    assert counts["on"] == counts["off"], counts


def test_invariants_whole_run_on_the_card_matches_the_cpu(cuda):
    """The invariants benchmark's armed flagship at 100,000 peers for its
    200 ticks (the CPU run equals the reference's XLA step:
    tests/torch_reference_gate.py --invariants --port): the card against
    the CPU by the digest of every state leaf, the carry too, every 10th
    tick; the report clean."""
    runs = {}
    for dev in ("cpu", cuda):
        cfg, sc, params, state, _ = invariants_flagship.build(
            dev, n_peers=100_000)
        step = pgs.make_gossip_step(cfg, sc, device=dev,
                                    invariants=piv.InvariantConfig())
        state = piv.attach(state)
        out = []
        for tick in range(1, invariants_flagship.WARMUP
                          + invariants_flagship.TICKS + 1):
            state = step(params, state)[0]
            if tick % 10 == 0:
                out.append(_state_digest(state))
        runs[str(dev)] = (out, piv.report(state))
    assert len(runs["cpu"][0]) == 20
    assert runs["cpu"] == runs[str(cuda)]
    assert runs["cpu"][1]["bits"] == 0


# -- the receive and select kernels at the edges of their tiles

#: the receive kernel's tile (csrc/receive_body.cuh RECEIVE_THREADS)
TILE = prc.RECEIVE_TILE
#: peer counts at the tile's edges: one peer, a tile less one, one tile,
#: one more, and three tiles and 37 (N % 8 = 5: no [C, N] row past the
#: first starts 16-byte aligned; the last tile is ragged, and each edge's
#: ctrl window wraps past N in the middle of some tile)
EDGE_NS = (1, TILE - 1, TILE, TILE + 1, 3 * TILE + 37)
#: the edge cases' C = 8 config (a name of its own: the sim functions
#: above read ``SMALL`` and pass their own ``backoff_ticks``)
EDGE_SMALL = dict(d=3, d_lo=2, d_hi=6, d_score=2, d_out=1, d_lazy=2,
                  gossip_factor=0.25, backoff_ticks=8)
#: family: (C, W, scored, score config, receive_consts options, with a
#: static score term)
EDGE_FAMILIES = {
    "scored": (16, 1, True, {}, {}, True),
    "scored_f32": (16, 2, True, dict(counter_dtype="float32"), {}, False),
    "unscored": (8, 2, False, None, {}, False),
    "attacks": (16, 1, True, dict(sybil_ihave_spam=True,
                                  sybil_iwant_spam=True), {}, False),
    "full": (16, 1, True, dict(sybil_ihave_spam=True, sybil_iwant_spam=True,
                               flood_publish=True),
             dict(px=True, same_ip=True, exact_k=True), False),
    "paired": (16, 1, True, dict(topic_score_cap=25.0, flood_publish=True),
               dict(px=True, same_ip=True, exact_k=True), False),
    "paired_unscored": (8, 2, False, None, dict(px=True, exact_k=True),
                        False),
    "faulted": (16, 1, True, dict(sybil_iwant_spam=True),
                dict(faults=True), False),
    "paired_faulted": (16, 1, True, {}, dict(px=True, faults=True), False),
    "telemetry": (16, 1, True, {}, dict(telemetry=True, tel_lat_buckets=5),
                  False),
    "full_telemetry": (16, 2, True, dict(sybil_iwant_spam=True,
                                         flood_publish=True),
                       dict(px=True, same_ip=True, faults=True,
                            telemetry=True, tel_lat_buckets=3), False),
    "knobs": (16, 1, True, dict(sybil_ihave_spam=True), dict(knobs=True),
              False),
    "delayed": (16, 1, True, dict(sybil_ihave_spam=True),
                dict(delays=True), False),
    "delayed_unscored": (8, 2, False, None, dict(delays=True, knobs=True),
                         False),
}


def tile_edge_case(family: str, n: int, seed: int = 0):
    """A family's receive consts at ``n`` peers (random offsets in [0, n))
    and its seeded operands on the CPU, every option of the family live."""
    c, w, scored, sc_kw, opts, static = EDGE_FAMILIES[family]
    opts = dict(opts)
    exact = opts.pop("exact_k", False)
    paired = family.startswith("paired")
    cfg = pgs.GossipSimConfig(
        offsets=pgs.make_gossip_offsets(4, c, 4096, seed=3, paired=paired),
        n_topics=4, paired_topics=paired, binomial_gossip_sampling=not exact,
        **(EDGE_SMALL if c == 8 else {}))
    sc = pgs.ScoreSimConfig(**sc_kw) if scored else None
    k = prc.receive_consts(cfg, sc, **opts)
    rng = np.random.default_rng(seed)
    k = dataclasses.replace(k, offsets=tuple(
        int(o) for o in rng.integers(0, n, size=c)))
    full = (1 << c) - 1

    def sparse(shape, bits=32):
        return _words(rng, shape, bits) & _words(rng, shape, bits)

    def ints(hi, shape, dtype):
        return torch.from_numpy(rng.integers(0, hi, size=shape).astype(dtype))

    ops = dict(
        gseeds=tuple(int(g) for g in rng.integers(0, 1 << 32, size=2)),
        ctrl=ints(128 if k.flood_publish else 64, (c, n), np.uint8),
        fresh=sparse((w, n)), adv=_words(rng, (w, n)),
        sub_all=torch.from_numpy(np.where(rng.random(n) < 0.8, full, 0)
                                 .astype(np.int32)),
        cand_sub=_words(rng, (n,), c), fanout=sparse((n,), c),
        wa=_words(rng, (n,), c), grafts=sparse((n,), c),
        dropped=sparse((n,), c), meshsel=_words(rng, (n,), c),
        seen=sparse((w, n)), injected=sparse((w, n)) & 0x0F0F,
        backoff=ints(61, (c, n), np.int16))
    if scored:
        ctr = k.counter_dtype
        ops.update(
            valid=_words(rng, (w,)), pay=_words(rng, (n,), c),
            gsp=_words(rng, (n,), c), acc=_words(rng, (n,), c),
            bo2=_words(rng, (n,), c),
            static=(torch.from_numpy(rng.normal(0, 1, (c, n)).astype(
                np.float32)) if static else None),
            fd=torch.from_numpy(rng.random((c, n)) * 60).float().to(ctr),
            inv=torch.from_numpy(rng.random((c, n)) * 3).float().to(ctr),
            bp=torch.from_numpy(rng.random((c, n)) * 3).float().to(
                k.bp_dtype),
            tim=ints(32767, (c, n), np.int16),
            iws=ints(4 * 32 * w if k.attacks else 30001, (c, n), np.int16))
    if k.attacks:
        ops["syb"] = torch.from_numpy(np.where(rng.random(n) < 0.2, full, 0)
                                      .astype(np.int32))
    if k.flood_publish:
        ops["inj_send"] = (ops["fresh"] & ops["adv"]).contiguous()
    if k.with_same_ip:
        group = rng.integers(0, 6, size=(c, n))
        same = np.zeros((c, n), dtype=np.uint32)
        for cc in range(c):
            same |= (group == group[cc][None, :]).astype(np.uint32) << cc
        ops["same_ip"] = torch.from_numpy(same.view(np.int32))
    if paired:
        ops.update(ctrl2=ints(16, (c, n), np.uint8), fresh_b=sparse((w, n)),
                   wa_b=_words(rng, (n,), c), grafts_b=sparse((n,), c),
                   dropped_b=sparse((n,), c), meshsel_b=_words(rng, (n,), c),
                   backoff_b=ints(61, (c, n), np.int16))
        if scored:
            ops.update(bo2_b=_words(rng, (n,), c),
                       tim_b=ints(32767, (c, n), np.int16))
    if k.faults:
        ops["alive_w"] = torch.from_numpy(np.where(rng.random(n) < 0.1, 0, -1)
                                          .astype(np.int32))
        if k.iwant_spam:
            ops["flood_ok"] = _words(rng, (n,), c)
    if k.tel_lat_buckets:
        pub = torch.from_numpy(rng.integers(0, 40, 32 * w).astype(np.int32))
        ops["lat_masks"] = ptl.latency_bucket_masks(pub, 30,
                                                    k.tel_lat_buckets, w)
        ops["dlv_eff"] = _words(rng, (w, n))
    if k.knobs:
        knobs = (0.4, 3.0, 13.0, -10.9, -40.0, -60.0, -5.0)
        ops["knobs"] = torch.tensor(knobs[:7 if scored else 3],
                                    dtype=torch.float32)
    if k.delays:
        ops = {key: v for key, v in ops.items()
               if key not in prc.SENDER_OPERANDS}
        ops.update(arr=sparse((c * w, n)), graft_arr=sparse((n,), c),
                   prune_arr=sparse((n,), c), retract=sparse((n,), c))
        if k.track_promises:
            ops["cheat_arr"] = sparse((n,), c)
    return k, ops


def _identical(got, want):
    """Every output equal, floats by bit pattern."""
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.cpu()
        if g.dtype in (torch.bfloat16, torch.float32):
            bits = torch.int16 if g.dtype == torch.bfloat16 else torch.int32
            g, w = g.view(bits), w.view(bits)
        assert torch.equal(g, w), f"output {i} differs"
    assert len(got) == len(want)


@pytest.mark.parametrize("n", EDGE_NS)
@pytest.mark.parametrize("family", sorted(EDGE_FAMILIES))
def test_receive_kernel_at_tile_edges(cuda, family, n):
    """Each family of the receive kernel against its plain version at the
    tile's edges (seeded operands, every output bit for bit)."""
    k, ops = tile_edge_case(family, n)
    want = prc.receive_update(k, **ops)
    got = prc.receive_update(k, **_to(ops, cuda))
    torch.cuda.synchronize()
    _identical(got, want)


@pytest.mark.parametrize("lead", [0, 1, 3])
@pytest.mark.parametrize("n", [1, 3, 5, 127, 4 * 128 + 2])
@pytest.mark.parametrize("c", [8, 16])
def test_select_kernel_at_tile_edges(cuda, c, n, lead):
    """The select kernel against its plain version at counts off its
    four-peer quads (N % 4 != 0) and on operands ``lead`` words past a
    16-byte boundary (which the wrapper copies to an aligned buffer),
    with k from -1 to C + 2."""
    rng = np.random.default_rng(n + c)
    elig = _words(rng, (lead + n,), c)
    kk = torch.from_numpy(rng.integers(-1, c + 3, size=lead + n).astype(
        np.int32))
    seed = pg.lane_seed(5, 2, 1)
    want = psel.select_k_bits(elig[lead:], kk[lead:], c, seed, n)
    got = psel.select_k_bits(elig.to(cuda)[lead:], kk.to(cuda)[lead:], c,
                             seed, n)
    assert torch.equal(got.cpu(), want)


def _to_misaligned(ops, dev):
    """``ops`` on ``dev``, each tensor a view one element past the start
    of its allocation (off every 16-byte boundary)."""
    out = {}
    for name, v in ops.items():
        if isinstance(v, torch.Tensor):
            buf = torch.empty(v.numel() + 1, dtype=v.dtype, device=dev)
            buf[1:].copy_(v.flatten())
            v = buf[1:].view(v.shape)
        out[name] = v
    return out


@pytest.mark.parametrize("family", ["scored", "paired", "delayed",
                                    "full_telemetry"])
def test_receive_kernel_on_misaligned_operands(cuda, family):
    """Receive operands that start off a 16-byte boundary (the wrapper
    copies each staged one to an aligned buffer; the others are read in
    place) against the plain version, at the ragged, wrapping peer
    count."""
    k, ops = tile_edge_case(family, EDGE_NS[-1], seed=1)
    want = prc.receive_update(k, **ops)
    got = prc.receive_update(k, **_to_misaligned(ops, cuda))
    torch.cuda.synchronize()
    _identical(got, want)


# -- the fused window at the edges of its peer ranges ---------------------------

#: (C, W, N, offsets) of the fused-window edge cases: N off the kernel's
#: 4-peer groups, N below one block's 512 threads' groups (every block
#: ragged), offsets +-1..+-8 (most senders of every group wrap at N), W = 2
#: at C = 8 and C = 16, the largest N a smoke phase runs (1,048,576, the
#: front in shared memory) and W = 2 there (the front in device memory)
FUSED_EDGES = {
    "ragged": (16, 1, 4094, None),
    "ragged_w2": (8, 2, 4093, None),
    "below_block": (16, 1, 1001, None),
    "tiny": (8, 1, 37, None),
    "wrap": (16, 1, 4096, tuple(s * k for k in range(1, 9)
                                for s in (1, -1))),
    "w2_c8": (8, 2, 4096, None),
    "w2_c16": (16, 2, 4096, None),
    "largest": (16, 1, 1 << 20, None),
    "largest_w2": (16, 2, 1 << 20, None),
}
FUSED_VARIANTS = ("clean", "exact_k", "faulted", "cold", "telemetry",
                  "telemetry_cold")


def fused_edge_case(case: str, variant: str, seed: int = 0, ticks: int = 8):
    """(consts, operands) of a fused window at ``FUSED_EDGES[case]`` with
    seeded operands: C-bit masks (mesh degrees on both sides of Dlo and
    Dhi, so the graft and prune draws run), a few publishers due in the
    window, backoffs in [0, 60], the fault rows' alive and rejoin words
    all-ones or zero as ``window_fault_rows`` makes them."""
    c, w, n, offsets = FUSED_EDGES[case]
    if offsets is None:
        offsets = pg.make_circulant_offsets(1, c, max(n, 2 * c + 3),
                                            seed=seed)
        offsets = tuple(int(o) for o in offsets)
    cfg = pgs.GossipSimConfig(
        offsets=offsets[:c], n_topics=1,
        binomial_gossip_sampling=variant != "exact_k",
        **(EDGE_SMALL if c == 8 else {}))
    rng = np.random.default_rng(seed + n)
    all_c = (1 << c) - 1

    def masks(p=0.5, shape=(n,)):
        bits = rng.random(shape + (c,)) < p
        return torch.from_numpy((bits * (1 << np.arange(c))).sum(-1)
                                .astype(np.int32))

    def sparse_words(shape, p):
        return torch.where(torch.from_numpy(rng.random(shape) < p),
                           _words(rng, shape), 0)

    hg, tick0 = cfg.history_gossip, 40
    ops = dict(
        tick0=tick0, seeds=pfused.window_seeds(tick0, ticks, seed),
        due=sparse_words((ticks, w), 0.3),
        sub_all=torch.where(torch.from_numpy(rng.random(n) < 0.9), all_c,
                            0).to(torch.int32),
        cand_sub=masks(0.9), origin=sparse_words((w, n), 0.01),
        have=_words(rng, (w, n)), recent=_words(rng, (hg, w, n)),
        mesh=masks(float(rng.uniform(0.1, 0.6))), fanout=masks(0.3),
        last_pub=torch.from_numpy(rng.integers(tick0 - 70, tick0 + 1, n)
                                  .astype(np.int32)),
        backoff=torch.from_numpy(rng.integers(0, 61, (c, n))
                                 .astype(np.int16)),
        tgt=masks(0.4), bog=masks(0.2))
    if variant in ("faulted", "cold", "telemetry_cold"):
        def all_or_none(p):
            return torch.where(torch.from_numpy(rng.random((ticks, n)) < p),
                               -1, 0).to(torch.int32)
        ops.update(alive=all_or_none(0.9), send_ok=_words(rng, (ticks, n)),
                   cand_alive=masks(0.9, (ticks, n)))
        if variant != "faulted":
            ops["rejoin"] = all_or_none(0.05)
    tel = variant.startswith("telemetry")
    if tel:
        ops.update(lat_masks=_words(rng, (ticks, 16, w)),
                   dlv=_words(rng, (w, n)))
    return pfused.fused_consts(cfg, telemetry=tel,
                               tel_lat_buckets=16 if tel else 0), ops


def _fused_launches():
    return pfused.launches + pfused.launches_faults + pfused.launches_tel


@pytest.mark.parametrize("variant", FUSED_VARIANTS)
@pytest.mark.parametrize("case", sorted(FUSED_EDGES))
def test_fused_kernel_at_range_edges(cuda, case, variant):
    """Each variant of the fused kernel against its plain version at
    ``FUSED_EDGES`` (the plain version on the card at 1M peers), every
    output bit for bit, one launch; the front where ``launch_plan`` puts
    it, and the card's launch configuration equal to that plan."""
    k, ops = fused_edge_case(case, variant)
    c, w, n, _ = FUSED_EDGES[case]
    ops_g = _to(ops, cuda)
    want = pfused.fused_gossip_update_plain(
        k, **(ops_g if n > 100_000 else ops))
    before = _fused_launches()
    got = pfused.fused_gossip_update(k, **ops_g)
    torch.cuda.synchronize()
    assert _fused_launches() == before + 1
    assert len(got) == len(want)
    for i, (g, x) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), x.cpu()), f"output {i}"
    faults = ops.get("alive") is not None
    cfg = pfused.launch_config(k, n, w, faults, ops.get("rejoin") is not None)
    tel_rows = (len(prc.TEL_ROWS) + k.tel_lat_buckets
                + pfused.TEL_FUSED_EXTRA) if k.telemetry else 0
    plan = pfused.launch_plan(
        w, n, tel_rows,
        sms=torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert cfg == {**{key: plan[key] for key in (
        "blocks", "threads", "peers", "smem_bytes")},
        "front": "device" if plan["front_global"] else "shared"}
    assert (cfg["front"] == "device") == (case == "largest_w2")


@pytest.mark.parametrize("variant", ["clean", "telemetry_cold"])
def test_fused_kernel_on_misaligned_operands(cuda, variant):
    """Fused operands that start off a 16-byte boundary (every row moves
    a word a peer) against the plain version, at a ragged N."""
    k, ops = fused_edge_case("ragged", variant, seed=1)
    want = pfused.fused_gossip_update_plain(k, **ops)
    got = pfused.fused_gossip_update(k, **_to_misaligned(ops, cuda))
    torch.cuda.synchronize()
    for i, (g, x) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), x), f"output {i}"


# -- replica batching: B1 and B3 with a replica axis --------------------------


@pytest.mark.parametrize("c", [16, 32])
@pytest.mark.parametrize("n", [4_000, 4_002, 4_099])
def test_batched_select_kernel_matches_plain(cuda, c, n):
    """One launch over a [B, N] stack with [B] seeds against the plain
    version and against one launch a replica (N = 2 mod 4 and odd: quads
    straddle replicas)."""
    rng = np.random.default_rng(n + c)
    B = 5
    elig = _words(rng, (B, n), c)
    k = torch.from_numpy(rng.integers(0, c + 3, (B, n)).astype(np.int32))
    seeds = pg.lane_seed(9, 2, torch.tensor([1, 2, 3, 0xFFFFFFF0, 77],
                                            dtype=torch.int64))
    want = psel.select_k_bits_plain(elig, k, c, seeds, n)
    before = psel.launches
    got = psel.select_k_bits(elig.to(cuda), k.to(cuda), c, seeds.to(cuda),
                             n)
    torch.cuda.synchronize()
    assert psel.launches == before + 1
    assert torch.equal(got.cpu(), want)
    for b in range(B):
        one = psel.select_k_bits(elig[b].to(cuda), k[b].to(cuda), c,
                                 int(seeds[b]) & 0xFFFFFFFF, n)
        assert torch.equal(one.cpu(), want[b]), b


@pytest.mark.parametrize("name", ["scored", "unscored", "attack",
                                  "unscored_faults", "scored_knobs",
                                  "attack_faults_knobs"])
@pytest.mark.parametrize("n", [1_000, 1_003])
@pytest.mark.parametrize("c", [8, 16])
def test_batched_receive_kernel_matches_plain(cuda, name, n, c):
    """One launch of B1 over three replicas whose operands differ (seeds,
    knob vectors, alive words), against the plain version on the stack
    and against one launch a replica (at C = 8 and an odd N a replica's
    ctrl rows start off a 16-byte boundary)."""
    from test_torch_batch import PLAIN_VARIANTS, _receive_ops

    scored, sc_kw, kw = PLAIN_VARIANTS[name]
    cfg = pgs.GossipSimConfig(offsets=pgs.make_gossip_offsets(
        2, c, n - n % 2, seed=3), n_topics=2, **(SMALL if c == 8 else {}))
    k = prc.receive_consts(cfg, pgs.ScoreSimConfig(**sc_kw)
                           if scored else None,
                           faults=kw.get("faults", False),
                           knobs=kw.get("knobs", False))
    reps = [_receive_ops(k, n, 20 + b, **kw) for b in range(3)]
    stacked = {}
    for key, v in reps[0].items():
        if key == "gseeds":
            stacked[key] = tuple(torch.tensor([r[key][i] for r in reps],
                                              dtype=torch.int64)
                                 for i in range(2))
        elif isinstance(v, torch.Tensor):
            stacked[key] = torch.stack([r[key] for r in reps])
        else:
            stacked[key] = v
    want = prc.receive_update_plain(k, **stacked)

    def to(ops):
        return {key: (tuple(x.to(cuda) for x in v) if key == "gseeds"
                      and isinstance(v[0], torch.Tensor)
                      else v.to(cuda) if isinstance(v, torch.Tensor) else v)
                for key, v in ops.items()}
    before = sum(prc.launches.values())
    got = prc.receive_update(k, **to(stacked))
    torch.cuda.synchronize()
    assert sum(prc.launches.values()) == before + 1
    for i, (g, x) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), x), f"output {i}"
    for b, r in enumerate(reps):
        one = prc.receive_update(k, **to(r))
        for i, (g, x) in enumerate(zip(one, want)):
            assert torch.equal(g.cpu(), x[b]), (b, i)


@pytest.mark.parametrize("scored", [True, False])
def test_batched_step_on_the_card_matches_the_cpu(cuda, scored):
    """A stack of three replicas, 20 ticks on one step a tick: the card's
    final stack equals the CPU's leaf for leaf, B1 launched once a tick."""
    from test_torch_batch import replica_specs

    make_cfg, specs = replica_specs(n=3_002, t=2, seeds=(1, 2, 3))
    cfg = make_cfg(pgs)
    sc = pgs.ScoreSimConfig() if scored else None
    out = {}
    for dev in (cuda, torch.device("cpu")):
        params, state = pgs.stack_sims(cfg, specs, score_cfg=sc,
                                       device=dev)
        step = pgs.make_gossip_step(cfg, sc, device=dev)
        before = sum(prc.launches.values())
        out[dev.type] = pgs.gossip_run_batch(params, state, 20, step,
                                             device=dev)
        if dev == cuda:
            assert sum(prc.launches.values()) == before + 20
    assert _state_digest(out["cuda"]) == _state_digest(out["cpu"])


def _to_card(ops, cuda):
    return {key: (tuple(x.to(cuda) for x in v) if key == "gseeds"
                  and isinstance(v[0], torch.Tensor)
                  else v.to(cuda) if isinstance(v, torch.Tensor) else v)
            for key, v in ops.items()}


#: ``test_torch_batch.STACK_VARIANTS``' families (named here, so that
#: collection imports nothing more)
STACK_NAMES = (
    "scored_delays", "unscored_delays", "attack_delays",
    "scored_delays_knobs", "unscored_delays_knobs", "attack_delays_knobs",
    "scored_tel", "unscored_tel", "attack_tel", "scored_faults_tel",
    "unscored_faults_tel", "attack_faults_tel", "scored_tel_knobs",
    "unscored_faults_tel_knobs", "attack_tel_knobs",
    "attack_faults_tel_knobs")


@pytest.mark.parametrize("name", STACK_NAMES)
@pytest.mark.parametrize("n", [1_000, 1_003])
@pytest.mark.parametrize("c", [8, 16])
def test_batched_delay_and_telemetry_receive_matches_plain(cuda, name, n,
                                                           c):
    """B1's delay mode and telemetry tally over three replicas whose
    operands differ (words, seeds, knob vectors, bucket masks) in one
    launch of their stack kernel, against the plain version on the stack
    and against one launch a replica: every output, the [B, 8 + L] tally
    too (at C = 8 and an odd N a replica's arrival rows start off a
    16-byte boundary of the stack)."""
    from test_torch_batch import STACK_VARIANTS, stack_case

    assert set(STACK_NAMES) == set(STACK_VARIANTS)
    k, reps, stacked = stack_case(name, n, c, 40)
    want = prc.receive_update_plain(k, **stacked)
    before = sum(prc.launches.values())
    got = prc.receive_update(k, **_to_card(stacked, cuda))
    torch.cuda.synchronize()
    assert sum(prc.launches.values()) == before + 1
    for i, (g, x) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), x), f"output {i}"
    for b, r in enumerate(reps):
        one = prc.receive_update(k, **_to_card(r, cuda))
        for i, (g, x) in enumerate(zip(one, want)):
            assert torch.equal(g.cpu(), x[b]), (b, i)


@pytest.mark.parametrize("case", ["delays_scored_faults_knobs",
                                  "delays_attacks", "delays_unscored",
                                  "tel_scored_faults", "tel_attacks_knobs",
                                  "tel_delays_counters"])
def test_batched_delay_and_telemetry_step_on_the_card_matches_the_cpu(
        cuda, case):
    """A stack of three replicas, 20 ticks on one step a tick: delay-armed
    (a delay seed a replica; with knobs a delay point a replica) or with
    telemetry (every group and histogram), under fault schedules where the
    case says; the card's final stack equals the CPU's leaf for leaf, and
    every frame field (``[T, B]``) the CPU's, B1 launched once a tick in
    its stack variant."""
    from test_torch_batch import replica_specs

    make_cfg, specs = replica_specs(n=3_002, t=2, seeds=(1, 2, 3))
    cfg = make_cfg(pgs)
    n = 3_002
    sc = None if "unscored" in case else pgs.ScoreSimConfig(
        **(dict(sybil_ihave_spam=True) if "attacks" in case else {}))
    tcfg = (ptl.TelemetryConfig(latency_hist=True, degree_hist=True,
                                score_hist=sc is not None, latency_buckets=12)
            if case.startswith("tel") else None)
    grp = np.arange(n) % 2

    def extra(b):
        e = {}
        if "attacks" in case:
            e["sybil"] = np.random.default_rng(b).random(n) < 0.2
        if "faults" in case:
            e["fault_schedule"] = pfl.FaultSchedule(
                n_peers=n, horizon=40, seed=20 + b, drop_prob=0.03,
                down_intervals=[(p, 3, 9) for p in range(b, n, 37)],
                partition_group=grp, partition_windows=[(6, 10)])
        if "knobs" in case:
            e["sim_knobs"] = {"gossip_factor": 0.2 + 0.1 * b}
        if "delays" in case:
            e["delays"] = pdl.DelayConfig(3, 2, 8, seed=5 + b)
            if "knobs" in case:
                e["sim_knobs"].update(delay_base=1 + b, delay_jitter=b)
            if tcfg is not None:
                e["delays_counters"] = True
        return e
    out = {}
    for dev in (cuda, torch.device("cpu")):
        params, state = pgs.stack_sims(
            cfg, [dict(s, **extra(b)) for b, s in enumerate(specs)],
            score_cfg=sc, device=dev)
        step = pgs.make_gossip_step(cfg, sc, device=dev, telemetry=tcfg)
        before = sum(prc.launches.values())
        if tcfg is None:
            fin, frames = pgs.gossip_run_batch(params, state, 20, step,
                                               device=dev), None
        else:
            fin, frames = ptl.telemetry_run_batch(params, state, 20, step)
        if dev == cuda:
            assert sum(prc.launches.values()) == before + 20
        out[dev.type] = (fin, frames)
    assert _state_digest(out["cuda"][0]) == _state_digest(out["cpu"][0])
    if tcfg is not None:
        got = convert.frame_to_numpy(out["cuda"][1])
        want = convert.frame_to_numpy(out["cpu"][1])
        assert got["payload_sent"].shape == (20, 3)
        for name, w in want.items():
            if w is None:
                assert got[name] is None, name
            elif name == "score_mean":
                # the card and the CPU sum non-integer f32 scores in
                # different orders
                np.testing.assert_allclose(got[name], w, rtol=1e-5,
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(got[name], w, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("sim", ["floodsub", "randomsub"])
def test_meshless_forms_on_the_card_match_the_cpu(cuda, sim):
    """The mesh-less simulators (no hand-written kernel: the reference
    leaves them to XLA): each step form (plain, faulted, with telemetry,
    delayed, armed) of the FloodSub circulant and gather cores and of the
    RandomSub circulant step at 20,000 peers and dense step at 1,000, 40
    ticks, the card's digest of every state leaf, delivered word and frame
    field equal to the CPU's; no kernel launched and no library built."""
    from go_libp2p_pubsub_tpu_torch import floodsub_flagship, randomsub_10k

    mod = floodsub_flagship if sim == "floodsub" else randomsub_10k
    libs0 = floodsub_flagship.reset_kernel_counts()
    card = mod.forms(cuda)
    counts = floodsub_flagship.kernel_counts(libs0)
    assert card == mod.forms(torch.device("cpu"))
    assert counts == dict(receive=0, fused=0, select=0, libraries_built=[])
