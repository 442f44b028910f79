"""The port's fused window (B2) against the JAX reference.

The fused window runs T ticks of the unscored (v1.0) step in one launch.
Same seeded inputs (numpy) go to both packages, on the smallest ring the
reference's single-device fused kernel takes (N = 1024, 4 topics):

- ``fused_gossip_update_plain`` (what the port's CUDA kernel is held to
  on the card) against ``make_fused_gossip_update`` in interpret mode on
  the same operands — a real carry mid mesh formation — for T in {4, 8}
  and C in {8, 16}, on every output;
- the port's ``make_fused_window`` against the reference's (built with
  ``pad_to_block=1024``, so its n_true equals its padded N), state and
  delivered words;
- the port's fused runners against its per-tick runners;
- the named refusals.

Tolerance: exact (integer words, i16 backoff, i32 ticks; bitwise).
"""

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import plan
from go_libp2p_pubsub_tpu_torch.ops import graph as pg
from go_libp2p_pubsub_tpu_torch.ops.kernels import fused as pfused
from torch_ref import imported_reference, tree_to_numpy

N, T_TOPICS, M = 1024, 4, 40
SMALL = dict(d=3, d_lo=2, d_hi=6, d_score=2, d_out=1, d_lazy=2)


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        yield r


def _cfg_kw(c):
    return SMALL if c == 8 else {}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    subs = np.zeros((N, T_TOPICS), dtype=bool)
    subs[np.arange(N), np.arange(N) % T_TOPICS] = True
    subs[rng.random(N) < 0.05] = False          # some fanout-only peers
    topic = rng.integers(0, T_TOPICS, M)
    origin = rng.integers(0, N // T_TOPICS, M) * T_TOPICS + topic
    ticks = np.sort(rng.integers(0, 24, M)).astype(np.int32)
    return subs, topic, origin, ticks


def _port_sim(c, seed=0):
    offsets = pgs.make_gossip_offsets(T_TOPICS, c, N, seed=seed)
    cfg = pgs.GossipSimConfig(offsets=offsets, n_topics=T_TOPICS,
                              **_cfg_kw(c))
    return (cfg, *pgs.make_gossip_sim(cfg, *_inputs(seed), seed=seed,
                                      device="cpu"))


def window_operands(cfg, params, state, ticks):
    """The fused kernel's operands for the window starting at
    ``state``."""
    tick0 = state.tick
    tk = torch.arange(tick0, tick0 + ticks, dtype=torch.int32)
    all_c = (1 << cfg.n_candidates) - 1
    return dict(
        tick0=tick0, seeds=pfused.window_seeds(tick0, ticks, state.salt),
        due=pg.pack_bits(params.publish_tick[None, :] == tk[:, None]),
        sub_all=torch.where(params.subscribed, all_c, 0).to(torch.int32),
        cand_sub=params.cand_sub_bits, origin=params.origin_words,
        have=state.have, recent=state.recent, mesh=state.mesh,
        fanout=state.fanout, last_pub=state.last_pub,
        backoff=state.backoff, tgt=state.gates[0], bog=state.gates[1])


def _u32(t):
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 else t.numpy()


OUT_NAMES = ("have", "recent", "mesh", "fanout", "last_pub", "backoff",
             "tgt", "bog", "acq")


@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("ticks", [4, 8])
def test_fused_plain_matches_pallas_kernel(ref, c, ticks):
    import jax.numpy as jnp

    cfg, params, state = _port_sim(c)
    step = pgs.make_gossip_step(cfg, None, device="cpu")
    state = step(params, state)[0]  # mid mesh formation: grafts + prunes
    ops = window_operands(cfg, params, state, ticks)
    k = pfused.fused_consts(cfg)
    got = pfused.fused_gossip_update(k, **ops)     # CPU: plain version

    cfg_r = ref.gs.GossipSimConfig(offsets=cfg.offsets, n_topics=T_TOPICS,
                                   **_cfg_kw(c))
    W, hg = state.have.shape[0], cfg.history_gossip
    krn = ref.receive.make_fused_gossip_update(cfg_r, N, W, hg, ticks,
                                               interpret=True, stream_n=N)
    i32 = lambda t: jnp.asarray(t.numpy())          # noqa: E731
    u32 = lambda t: jnp.asarray(_u32(t))            # noqa: E731
    want = krn(jnp.asarray([ops["tick0"]], jnp.int32),
               jnp.asarray(np.array(ops["seeds"], dtype=np.uint32)),
               u32(ops["due"]), jnp.zeros((1,), jnp.uint32),
               u32(ops["sub_all"]), u32(ops["cand_sub"]), u32(ops["origin"]),
               u32(ops["have"]), u32(ops["recent"].reshape(hg * W, N)),
               u32(ops["mesh"]), u32(ops["fanout"]), i32(ops["last_pub"]),
               i32(ops["backoff"]), u32(ops["tgt"]), u32(ops["bog"]))
    assert len(got) == len(want) == len(OUT_NAMES)
    for name, g, w in zip(OUT_NAMES, got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(
            g.numpy().view(w.dtype).reshape(w.shape), w, err_msg=name)
    # non-vacuous: messages moved, the mesh changed, targets were drawn
    assert int(pg.popcount32(got[8]).sum()) > 0
    assert (got[2] != ops["mesh"]).any()
    assert int(pg.popcount32(got[6]).sum()) > 0


@pytest.mark.parametrize("c", [8, 16])
def test_window_bytes_count_the_functions_operands(ref, c):
    cfg, params, state = _port_sim(c)
    ops = window_operands(cfg, params, state, 8)
    W, hg = state.have.shape[0], cfg.history_gossip
    carry = ref.receive.fused_carry_bytes(c, W, hg)
    static = (8 + 4 * W) * N + 4 * 8 * W        # sub_all, cand_sub, origin; due
    assert pfused.window_operand_bytes(ops) == (
        N * (2 * carry + 4 * 8 * W) + static)
    # the stage: ctrl bytes, fresh and advert words, written and read a tick
    k = pfused.fused_consts(cfg)
    assert pfused.stage_bytes(k, ops) == 2 * 8 * N * (c + 8 * W)


def _sim_pair(ref, seed=0):
    args = _inputs(seed)
    offsets = ref.gs.make_gossip_offsets(T_TOPICS, 16, N, seed=seed)
    cfg_r = ref.gs.GossipSimConfig(offsets=offsets, n_topics=T_TOPICS)
    cfg_p = pgs.GossipSimConfig(offsets=offsets, n_topics=T_TOPICS)
    ref_sim = ref.gs.make_gossip_sim(cfg_r, *args, seed=seed,
                                     pad_to_block=N)
    port_sim = pgs.make_gossip_sim(cfg_p, *args, seed=seed, device="cpu")
    return (cfg_r, *ref_sim), (cfg_p, *port_sim)


def test_fused_window_matches_reference_window(ref):
    (cfg_r, p_r, s_r), (cfg_p, p_p, s_p) = _sim_pair(ref)
    assert p_r.n_true == p_r.subscribed.shape[0] == N
    win_r = ref.gs.make_fused_window(cfg_r, None, ticks_fused=8,
                                     receive_block=N, receive_interpret=True,
                                     on_refusal="raise")
    win_p = pgs.make_fused_window(cfg_p, None, ticks_fused=8, device="cpu")
    for w in range(2):
        s_r, d_r = win_r(p_r, s_r)
        s_p, d_p = win_p(p_p, s_p)
        want = tree_to_numpy(s_r)
        got = convert.state_to_numpy(s_p)
        for name in ("have", "recent", "mesh", "fanout", "last_pub",
                     "backoff", "first_tick"):
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=f"window {w} {name}")
        for i, (g, wg) in enumerate(zip(got["gates"], want["gates"])):
            np.testing.assert_array_equal(g, wg, err_msg=f"gate {i}")
        assert got["tick"] == int(want["tick"]) == 8 * (w + 1)
        np.testing.assert_array_equal(_u32(d_p), np.asarray(d_r),
                                      err_msg=f"window {w} delivered")
    assert int(pgs.mesh_degrees(s_p).max()) >= cfg_p.d
    assert np.asarray(s_r.have).any()


def _states_equal(a, b):
    x, y = convert.state_to_numpy(a), convert.state_to_numpy(b)
    for name in ("have", "recent", "mesh", "fanout", "last_pub", "backoff",
                 "first_tick"):
        np.testing.assert_array_equal(x[name], y[name], err_msg=name)
    for i, (g, h) in enumerate(zip(x["gates"], y["gates"])):
        np.testing.assert_array_equal(g, h, err_msg=f"gate {i}")
    assert a.tick == b.tick


@pytest.mark.parametrize("ticks_fused", [4, 8])
def test_gossip_run_fused_matches_gossip_run(ticks_fused):
    cfg, params, state = _port_sim(16, seed=2)
    step = pgs.make_gossip_step(cfg, None, device="cpu")
    win = pgs.make_fused_window(cfg, None, ticks_fused=ticks_fused,
                                device="cpu")
    a = pgs.gossip_run(params, state, 24, step, device="cpu")
    b = pgs.gossip_run_fused(params, state, 24, win, device="cpu")
    _states_equal(a, b)
    assert b.tick == 24 and int(pg.popcount32(b.have).sum()) > 0


def test_gossip_run_curve_fused_matches_gossip_run_curve():
    cfg, params, state = _port_sim(8, seed=4)
    step = pgs.make_gossip_step(cfg, None, device="cpu")
    win = pgs.make_fused_window(cfg, None, ticks_fused=8, device="cpu")
    a, ca = pgs.gossip_run_curve(params, state, 32, step, M, device="cpu")
    b, cb = pgs.gossip_run_curve_fused(params, state, 32, win, M,
                                       device="cpu")
    _states_equal(a, b)
    assert ca.shape == cb.shape == (32, M)
    assert torch.equal(ca, cb)
    # the per-tick counts add up to the first-delivery records
    assert int(ca.sum()) > 0
    np.testing.assert_array_equal(
        ca.sum(0).numpy(), pgs.reach_counts(params, b).numpy())


def test_fused_refusals_by_name():
    cfg, params, state = _port_sim(16)
    win = pgs.make_fused_window(cfg, None, ticks_fused=8, device="cpu")
    with pytest.raises(plan.SliceRefusal) as err:
        pgs.gossip_run_fused(params, state, 12, win, device="cpu")
    assert err.value.name == "fused_horizon"
    with pytest.raises(plan.SliceRefusal) as err:
        pgs.gossip_run_curve_fused(params, state, 4, win, M, device="cpu")
    assert err.value.name == "fused_horizon"
    for ticks in (0, -1, plan.MAX_WINDOW + 1):
        with pytest.raises(plan.SliceRefusal) as err:
            pgs.make_fused_window(cfg, None, ticks_fused=ticks,
                                  device="cpu")
        assert err.value.name == "fused_window"
    with pytest.raises(plan.SliceRefusal) as err:
        pgs.make_fused_window(cfg, pgs.ScoreSimConfig(), device="cpu")
    assert err.value.name == "fused_scored"
    # a scored sim's state cannot enter an unscored window
    p_s, s_s = pgs.make_gossip_sim(cfg, *_inputs(), device="cpu",
                                   score_cfg=pgs.ScoreSimConfig())
    with pytest.raises(ValueError, match="gate words"):
        win(p_s, s_s)
    assert pgs.gossip_run_fused(params, state, 0, win,
                                device="cpu").tick == 0
