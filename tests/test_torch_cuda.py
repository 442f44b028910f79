"""Card-only tests of the port: each CUDA kernel against its plain
PyTorch version at a small size (the receive kernel scored, unscored and
with its attack options, the select kernel, the fused-window kernel),
and the scored step (plain and under every attack formation at once)
and the unscored fused window on the card against the CPU.  Exact: every output
bit for bit.

They skip without a card; on the card run
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``
(``tests/conftest.py`` imports JAX, which the port's machine need not
have).
"""

import dataclasses

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
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
    r0, s0 = prc.launches, psel.launches
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
    assert prc.launches - r0 == 25
    assert psel.launches - s0 >= 50


SMALL = dict(d=3, d_lo=2, d_hi=6, d_score=2, d_out=1, d_lazy=2)


def _unscored_sim(c, w_words, n=4096, t=4, seed=1):
    offsets = pgs.make_gossip_offsets(t, c, n, seed=seed)
    cfg = pgs.GossipSimConfig(offsets=offsets, n_topics=t,
                              **(SMALL if c == 8 else {}))
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
    before = prc.launches_unscored
    for k, ops in (captured[1], captured[-1]):
        want = prc.receive_update_plain(k, **ops)
        got = prc.receive_update(k, **_to(ops, cuda))
        torch.cuda.synchronize()
        assert len(got) == 5
        for i, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g.cpu(), w), f"output {i}"
    assert prc.launches_unscored == before + 2


@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("w_words", [1, 2])
def test_fused_kernel_matches_plain(cuda, c, w_words):
    cfg, params, state = _unscored_sim(c, w_words)
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


def test_fused_window_on_the_card_matches_the_cpu(cuda):
    cfg, p_c, s_c = _unscored_sim(16, 1, n=8192, t=8, seed=3)
    p_g = pgs.GossipParams(**{
        f: (v.to(cuda) if isinstance(v, torch.Tensor) else v)
        for f, v in vars(p_c).items()})
    s_g = convert.state_from_numpy(convert.state_to_numpy(s_c), None, cuda)
    win_c = pgs.make_fused_window(cfg, None, ticks_fused=8, device="cpu")
    win_g = pgs.make_fused_window(cfg, None, ticks_fused=8, device=cuda)
    r0, s0, f0 = prc.launches_unscored, psel.launches, pfused.launches
    s_c = pgs.gossip_run_fused(p_c, s_c, 32, win_c, device="cpu")
    s_g = pgs.gossip_run_fused(p_g, s_g, 32, win_g, device=cuda)
    a, b = convert.state_to_numpy(s_c), convert.state_to_numpy(s_g)
    for name in ("mesh", "fanout", "last_pub", "backoff", "have", "recent",
                 "first_tick"):
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    for i, (x, y) in enumerate(zip(a["gates"], b["gates"])):
        np.testing.assert_array_equal(x, y, err_msg=f"gate {i}")
    assert pfused.launches - f0 == 4
    assert (prc.launches_unscored, psel.launches) == (r0, s0)


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
    before = prc.launches_attacks
    got = prc.receive_update(k, **_to(ops, cuda))
    torch.cuda.synchronize()
    assert prc.launches_attacks == before + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.cpu(), w), f"output {i}"


def test_attack_step_on_the_card_matches_the_cpu(cuda):
    cfg, sc, p_c, s_c = _attack_sim(16, 1, n=8192, t=8)
    _, _, p_g, s_g = _attack_sim(16, 1, n=8192, t=8, device=cuda)
    step_c = pgs.make_gossip_step(cfg, sc, device="cpu")
    step_g = pgs.make_gossip_step(cfg, sc, device=cuda)
    r0, a0 = prc.launches, prc.launches_attacks
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
    assert (prc.launches_attacks - a0, prc.launches - r0) == (20, 0)
    assert float(s_g.scores.behaviour_penalty.float().max()) > 0
    assert pgs.eclipse_takeover(s_g, p_g, cfg) > 0
