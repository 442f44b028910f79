"""The RandomSub simulator of the port against the JAX reference.

Both packages build the same sim (1,200 peers, 3 topics, 40 messages over
two words, run seed 7) and step it 30 ticks: the circulant step (C = 16)
and the dense step, each in the forms of ``test_torch_floodsub.FORMS``
(plain, pure churn, a full fault schedule, telemetry, delays, armed).
Every state leaf (``have``, ``fresh``, ``first_tick``, ``src_ring``, the
checker's two scalars), the delivered words and every frame field equal
the reference's jitted step on every tick; the dense hop's ``cnt > 0.5``
reads exact counts, so it matches bit for bit too.  Also: the
reference's own dissemination cases on the port, ``send_prob``, the salt,
the refusals, the conversion, and on all four forms the identity delay
line and telemetry leaving the trajectory as it is.

Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import faults as pfl
from go_libp2p_pubsub_tpu_torch.models import plan
from go_libp2p_pubsub_tpu_torch.models import randomsub as prs
from test_torch_floodsub import (  # noqa: F401  (ref, one_thread: fixtures)
    CPU,
    FORMS,
    N,
    T,
    form_kwargs,
    inputs,
    one_thread,
    ref,
    run_pair,
    step_kwargs,
)
from test_torch_gossipsub import _assert_tree_equal
from torch_ref import tree_to_numpy

SEED = 7


def rsub_sims(ref, dense, form, n=N, t=T, c=16):
    subs, topic, origin, tick = inputs(n, t)
    offs = prs.make_randomsub_offsets(t, c, n, seed=1)
    assert offs == ref.rs.make_randomsub_offsets(t, c, n, seed=1)
    cfg_r = ref.rs.RandomSubSimConfig(offsets=offs, n_topics=t, d=3)
    cfg_p = prs.RandomSubSimConfig(offsets=offs, n_topics=t, d=3)
    kr, kp = form_kwargs(ref, form, n)
    sr, sp = step_kwargs(ref, form)
    sim_r = ref.rs.make_randomsub_sim(cfg_r, subs, topic, origin, tick,
                                      seed=SEED, dense=dense, **kr)
    sim_p = prs.make_randomsub_sim(cfg_p, subs, topic, origin, tick,
                                   seed=SEED, dense=dense, **kp, device=CPU)
    if dense:
        return (sim_r, sim_p, ref.rs.make_randomsub_dense_step(cfg_r, **sr),
                prs.make_randomsub_dense_step(cfg_p, **sp))
    return (sim_r, sim_p, ref.rs.make_randomsub_step(cfg_r, **sr),
            prs.make_randomsub_step(cfg_p, **sp))


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("dense", [False, True], ids=["circulant", "dense"])
def test_randomsub_step_matches_reference_30_ticks(ref, dense, form):
    sim_r, sim_p, step_r, step_p = rsub_sims(ref, dense, form)
    s_p, sent = run_pair(ref, sim_r, sim_p, step_r, step_p,
                         convert.randomsub_state_to_numpy,
                         convert.randomsub_params_to_numpy,
                         armed=FORMS[form].get("inv", False))
    assert int(prs.reach_counts(sim_p[0], s_p).sum()) > 0
    assert (sent > 0) == FORMS[form].get("tel", False)


def _build(n=2000, t=1, c=64, m=8, seed=0, dense=False):
    """The reference test module's builder, on the port."""
    cfg = prs.RandomSubSimConfig(
        offsets=prs.make_randomsub_offsets(t, c, n, seed=seed), n_topics=t)
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    rng = np.random.default_rng(seed)
    topic = rng.integers(0, t, m)
    origin = rng.integers(0, n // t, m) * t + topic
    params, state = prs.make_randomsub_sim(
        cfg, subs, topic, origin, np.zeros(m, np.int32), seed=seed,
        dense=dense, device=CPU)
    return cfg, params, state


def test_full_dissemination_and_sqrt_spread():
    cfg, params, state = _build()
    out = prs.randomsub_run(params, state, 12, prs.make_randomsub_step(cfg),
                            device=CPU)
    assert (prs.reach_counts(params, out).numpy() == 2000).all()
    curve = prs.reach_by_hops(params, out, 6).numpy()
    assert (curve[:, 3] > 0.9 * 2000).all(), curve[:, 3]


def test_send_prob_follows_sqrt_scaling():
    cfg, params, _ = _build(n=2000, c=64)
    k = max(cfg.d, int(np.ceil(np.sqrt(2000))))
    pool = params.cand_subscribed.numpy().sum(0)
    np.testing.assert_allclose(params.send_prob.numpy(),
                               np.minimum(1.0, k / np.maximum(pool, 1)),
                               rtol=1e-6)
    cfg2, params2, _ = _build(n=60, c=16)       # ceil(sqrt(60)) = 8 > D
    pool2 = params2.cand_subscribed.numpy().sum(0)
    np.testing.assert_allclose(params2.send_prob.numpy(),
                               np.minimum(1.0, 8 / np.maximum(pool2, 1)),
                               rtol=1e-6)


def test_topics_stay_isolated_on_both_steps():
    for dense in (False, True):
        cfg, params, state = _build(n=1500, t=3, c=12 if dense else 48,
                                    m=6, seed=2, dense=dense)
        step = (prs.make_randomsub_dense_step(cfg) if dense
                else prs.make_randomsub_step(cfg))
        out = prs.randomsub_run(params, state, 12, step, device=CPU)
        assert (prs.reach_counts(params, out).numpy() == 500).all()
    k = max(cfg.d, int(np.ceil(np.sqrt(500))))
    np.testing.assert_allclose(params.send_prob.numpy(), min(1.0, k / 499),
                               rtol=1e-6)


def test_unsubscribed_peers_are_never_delivered():
    n = 1200
    cfg = prs.RandomSubSimConfig(
        offsets=prs.make_randomsub_offsets(1, 64, n, seed=1))
    subs = np.ones((n, 1), dtype=bool)
    subs[::4] = False
    params, state = prs.make_randomsub_sim(
        cfg, subs, np.array([0]), np.array([5]), np.zeros(1, np.int32),
        seed=1, device=CPU)
    out = prs.randomsub_run(params, state, 15, prs.make_randomsub_step(cfg),
                            device=CPU)
    ft = prs.first_tick_matrix(out, 1).numpy()[:, 0]
    assert (ft[~subs[:, 0]] < 0).all() and (ft[subs[:, 0]] >= 0).all()


def test_offline_peer_and_curves_match_reference(ref):
    """The reference's offline-peer cases (circulant C = 12, dense) on
    both packages: the down origin publishes nothing, the down peer hears
    nothing, and the per-tick counts, reach and hop curves are equal."""
    n, m = 120, 4
    offs = prs.make_randomsub_offsets(1, 12, n, seed=2)
    subs = np.ones((n, 1), dtype=bool)
    msgs = (np.zeros(m, np.int64), np.array([3, 10, 20, 30]),
            np.zeros(m, np.int32))
    kw = dict(n_peers=n, horizon=40, down_intervals=[(3, 0, 40)], seed=1)
    for dense in (False, True):
        cfg_r = ref.rs.RandomSubSimConfig(offsets=offs)
        cfg_p = prs.RandomSubSimConfig(offsets=offs)
        p_r, s_r = ref.rs.make_randomsub_sim(
            cfg_r, subs, *msgs, dense=dense,
            fault_schedule=ref.faults.FaultSchedule(**kw))
        p_p, s_p = prs.make_randomsub_sim(
            cfg_p, subs, *msgs, dense=dense,
            fault_schedule=pfl.FaultSchedule(**kw), device=CPU)
        mk_r = (ref.rs.make_randomsub_dense_step if dense
                else ref.rs.make_randomsub_step)
        mk_p = (prs.make_randomsub_dense_step if dense
                else prs.make_randomsub_step)
        s_r, c_r = ref.rs.randomsub_run_curve(p_r, s_r, 40, mk_r(cfg_r), m)
        s_p, c_p = prs.randomsub_run_curve(p_p, s_p, 40, mk_p(cfg_p), m,
                                           device=CPU)
        np.testing.assert_array_equal(c_p.numpy(), np.asarray(c_r))
        for got, want in [
                (prs.reach_counts(p_p, s_p), ref.rs.reach_counts(p_r, s_r)),
                (prs.reach_by_hops(p_p, s_p, 8),
                 ref.rs.reach_by_hops(p_r, s_r, 8))]:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (prs.first_tick_matrix(s_p, m).numpy()[3] < 0).all()
        assert int(prs.reach_counts(p_p, s_p)[0]) == 0


def test_salt_is_the_reference_keys_last_word(ref):
    import jax

    _, _, st = _build(n=60, c=16, seed=0)
    for seed in (0, 7, 2 ** 31 - 1):
        key = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
        assert key.tolist() == [0, seed]
        got = convert.randomsub_state_from_numpy(
            dict(convert.randomsub_state_to_numpy(st), key=key), CPU)
        assert got.salt == seed
        np.testing.assert_array_equal(
            convert.randomsub_state_to_numpy(got)["key"], key)
    sim_r, sim_p, _, _ = rsub_sims(ref, False, "armed", n=300)
    s = convert.randomsub_state_from_numpy(tree_to_numpy(sim_r[1]), CPU)
    assert s.salt == SEED == sim_p[1].salt
    _assert_tree_equal(tree_to_numpy(sim_r[1]),
                       convert.randomsub_state_to_numpy(s), "state")
    p = convert.randomsub_params_from_numpy(tree_to_numpy(sim_r[0]), CPU)
    _assert_tree_equal(tree_to_numpy(sim_r[0]),
                       convert.randomsub_params_to_numpy(p), "params")


def test_cold_restart_is_refused_by_message_and_name(ref):
    n = 60
    cfg = prs.RandomSubSimConfig(offsets=prs.make_randomsub_offsets(1, 8, n))
    subs = np.ones((n, 1), dtype=bool)
    sched = pfl.FaultSchedule(n_peers=n, horizon=5,
                              down_intervals=[(1, 0, 2)], cold_restart=True)
    for dense in (False, True):
        with pytest.raises(ValueError) as e:
            prs.make_randomsub_sim(cfg, subs, np.array([0]), np.array([0]),
                                   np.zeros(1, np.int32), dense=dense,
                                   fault_schedule=sched, device=CPU)
        assert isinstance(e.value, plan.MeshlessRefusal)
        assert e.value.name == "randomsub.cold-restart"
        assert str(e.value) == ref.plan.MSG_RANDOMSUB_COLD_RESTART
        refusal = ref.plan.plan_circulant(
            "randomsub-dense" if dense else "randomsub-circulant",
            faults=sched)
        assert (refusal.code, refusal.message) == (e.value.name,
                                                   str(e.value))


def test_config_and_build_validations_keep_the_references_messages():
    for offs, msg in [((), "distinct and non-empty"),
                      ((3, 3, -3), "distinct and non-empty"),
                      ((3, 6), "closed under negation"),
                      ((2, -2), "multiples of n_topics")]:
        with pytest.raises(ValueError, match=msg):
            prs.RandomSubSimConfig(offsets=offs, n_topics=3)
    n = 60
    cfg = prs.RandomSubSimConfig(offsets=(3, -3), n_topics=3)
    subs = np.zeros((n, 3), dtype=bool)
    subs[np.arange(n), np.arange(n) % 3] = True
    one = (np.array([0]), np.array([0]), np.zeros(1, np.int32))
    with pytest.raises(ValueError, match="subs topic dim"):
        prs.make_randomsub_sim(cfg, subs[:, :2], *one, device=CPU)
    bad = subs.copy()
    bad[0, 1] = True
    with pytest.raises(ValueError, match=r"topic \(p mod T\)"):
        prs.make_randomsub_sim(cfg, bad, *one, device=CPU)
    with pytest.raises(ValueError, match="residue class"):
        prs.make_randomsub_sim(cfg, subs, np.array([1]), np.array([0]),
                               np.zeros(1, np.int32), device=CPU)
    with pytest.raises(ValueError, match="sim peer count 60"):
        prs.make_randomsub_sim(cfg, subs, *one, device=CPU,
                               fault_schedule=pfl.FaultSchedule(
                                   n_peers=59, horizon=5))
    per_edge = np.full((2, n), 0.5, dtype=np.float32)
    with pytest.raises(ValueError, match="circulant"):
        prs.make_randomsub_sim(cfg, subs, *one, dense=True, device=CPU,
                               fault_schedule=pfl.FaultSchedule(
                                   n_peers=n, horizon=5,
                                   drop_prob=per_edge))


@pytest.mark.parametrize("sim", ["flood-circulant", "flood-gather",
                                 "randomsub-circulant", "randomsub-dense"])
def test_identity_delays_and_telemetry_keep_the_trajectory(sim):
    """``DelayConfig(1, 0, 1)`` is the undelayed step and telemetry only
    reads: under the full fault schedule every state leaf but the ring and
    every frame field equal the plain step's, tick by tick (the
    reference's identity and telemetry-on pins)."""
    from go_libp2p_pubsub_tpu_torch.models import delays as pdl
    from go_libp2p_pubsub_tpu_torch.models import floodsub as pfs
    from go_libp2p_pubsub_tpu_torch.models import telemetry as ptl
    from go_libp2p_pubsub_tpu_torch.ops import graph as pg
    from test_torch_floodsub import schedule

    n, t = 600, 3
    subs, topic, origin, tick = inputs(n, t)
    sched = schedule(pfl, n, "full")
    tcfg = ptl.TelemetryConfig(latency_hist=True)
    kind, form = sim.split("-")
    offs = prs.make_randomsub_offsets(t, 8, n, seed=1)

    def build(delays):
        kw = dict(fault_schedule=sched, delays=delays, device=CPU)
        if kind == "flood":
            nbrs = mask = None
            if form == "gather":
                nbrs, mask = pg.build_topic_graph(subs, 4, seed=1,
                                                  max_degree=4)
            else:
                kw["fault_offsets"] = offs
            p, s = pfs.make_flood_sim(nbrs, mask, subs, None, topic,
                                      origin, tick, **kw)
            make = (pfs.make_gather_step_core if form == "gather"
                    else lambda **k: pfs.make_circulant_step_core(offs, **k))
        else:
            cfg = prs.RandomSubSimConfig(offsets=offs, n_topics=t, d=3)
            p, s = prs.make_randomsub_sim(cfg, subs, topic, origin, tick,
                                          seed=SEED, dense=form == "dense",
                                          **kw)
            mk = (prs.make_randomsub_dense_step if form == "dense"
                  else prs.make_randomsub_step)
            make = (lambda **k: mk(cfg, **k))
        return p, s, make

    runs = {}
    for name, delays, tel in (("plain", None, False), ("tel", None, True),
                              ("ident", pdl.DelayConfig(1, 0, 1), True)):
        p, s, make = build(delays)
        step = make(telemetry=tcfg if tel else None)
        out = []
        for _ in range(20):
            s, d, *f = step(p, s)
            out.append((s, d, f))
        runs[name] = out
    for t_ in range(20):
        base = runs["plain"][t_]
        for name in ("tel", "ident"):
            s, d, f = runs[name][t_]
            assert torch.equal(d, base[1]), (name, t_)
            assert torch.equal(s.have, base[0].have), (name, t_)
            assert torch.equal(s.first_tick, base[0].first_tick), (name, t_)
            if kind == "randomsub":
                assert torch.equal(s.fresh, base[0].fresh), (name, t_)
        got = convert.frame_to_numpy(runs["ident"][t_][2][0])
        want = convert.frame_to_numpy(runs["tel"][t_][2][0])
        for key, w in want.items():
            np.testing.assert_array_equal(got[key], w, err_msg=key)
