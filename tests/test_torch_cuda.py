"""Card-only tests of the port: each CUDA kernel against its plain
PyTorch version at a small size, and the step on the card against the
step on the CPU.  Exact: every output bit for bit.

They skip without a card; on the card run
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``
(``tests/conftest.py`` imports JAX, which the port's machine need not
have).
"""

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.ops import graph as pg
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
