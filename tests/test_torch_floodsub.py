"""The FloodSub simulator of the port against the JAX reference.

Both packages build the same sim from the same numpy inputs (1,200 peers,
3 topics, 40 messages over two words) and step it 30 ticks: the circulant
core and the gather core, each plain, under pure churn, under a full fault
schedule (churn, 5% link loss, a partition window), with telemetry, on
event-driven delays and armed with the invariant checker.  Every state
leaf (``have``, ``first_tick``, ``src_ring``, the checker's two scalars),
the delivered words and every telemetry frame field equal the reference's
jitted step on every tick.  Also: the graph helpers, the unpacked and
gather fault forms, the reference's own semantic cases on the port, the
refusals and the conversion.

Tolerance: exact (every leaf is an integer; the frames' f32 byte
estimates are integer multiples of the frame size).
"""

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import delays as pdl
from go_libp2p_pubsub_tpu_torch.models import faults as pfl
from go_libp2p_pubsub_tpu_torch.models import floodsub as pfs
from go_libp2p_pubsub_tpu_torch.models import invariants as piv
from go_libp2p_pubsub_tpu_torch.models import plan
from go_libp2p_pubsub_tpu_torch.models import telemetry as ptl
from go_libp2p_pubsub_tpu_torch.ops import graph as pg
from test_torch_gossipsub import _assert_tree_equal
from test_torch_knobs import one_thread  # noqa: F401  (autouse)
from test_torch_telemetry import assert_frames_equal
from torch_ref import imported_reference, tree_to_numpy

N, T, M, TICKS = 1200, 3, 40, 30
CPU = "cpu"

#: the step forms every sim is held in: a fault schedule ("churn": down
#: intervals only, "full": with link loss and a partition window),
#: telemetry, delays, the invariant checker
FORMS = {
    "plain": {},
    "churn": dict(sched="churn"),
    "faults": dict(sched="full"),
    "telemetry": dict(sched="full", tel=True),
    "delays": dict(delays=True, tel=True),
    "armed": dict(sched="full", delays=True, tel=True, inv=True),
}
TEL = dict(latency_hist=True, latency_buckets=12)
DELAYS = dict(base=2, jitter=2, k_slots=5, seed=7)


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.delays as rdl
        import go_libp2p_pubsub_tpu.models.faults as rfl
        import go_libp2p_pubsub_tpu.models.floodsub as rfs
        import go_libp2p_pubsub_tpu.models.invariants as riv
        import go_libp2p_pubsub_tpu.models.plan as rplan
        import go_libp2p_pubsub_tpu.models.randomsub as rrs
        import go_libp2p_pubsub_tpu.models.telemetry as rtl
        import go_libp2p_pubsub_tpu.models._delivery as rdv
        r.delays, r.faults, r.fs, r.iv = rdl, rfl, rfs, riv
        r.plan, r.rs, r.telemetry, r.delivery = rplan, rrs, rtl, rdv
        yield r


# -- shared builders (test_torch_randomsub.py uses them too) -----------------

def inputs(n=N, t=T, m=M, seed=0, horizon=12):
    """Subscriptions (peer p in topic p mod t) and a message table drawn
    as the JAX package's benchmarks draw it."""
    idx = np.arange(n)
    subs = np.zeros((n, t), dtype=bool)
    subs[idx, idx % t] = True
    rng = np.random.default_rng(seed)
    topic = rng.integers(0, t, m)
    origin = rng.integers(0, n // t, m) * t + topic
    tick = np.sort(rng.integers(0, horizon, m)).astype(np.int32)
    return subs, topic, origin, tick


def schedule(fl, n, kind, ticks=TICKS):
    """Churn waves (every 37th peer down over [2, 9), every 53rd over
    [12, 20)) and, ``kind="full"``, 5% link loss and the parity halves
    partitioned over [8, 16)."""
    down = [(p, 2, 9) for p in range(5, n, 37)]
    down += [(p, 12, 20) for p in range(11, n, 53)]
    kw = dict(n_peers=n, horizon=ticks, down_intervals=down, seed=3)
    if kind == "full":
        kw.update(drop_prob=0.05,
                  partition_group=(np.arange(n) % 2).astype(np.int32),
                  partition_windows=((8, 16),))
    return fl.FaultSchedule(**kw)


def form_kwargs(ref, form, n, ticks=TICKS):
    """The sim-build keywords of ``form`` for (the reference, the
    port)."""
    f = FORMS[form]
    kr, kp = {}, {}
    if "sched" in f:
        kr["fault_schedule"] = schedule(ref.faults, n, f["sched"], ticks)
        kp["fault_schedule"] = schedule(pfl, n, f["sched"], ticks)
    if f.get("delays"):
        kr["delays"] = ref.delays.DelayConfig(**DELAYS)
        kp["delays"] = pdl.DelayConfig(**DELAYS)
    return kr, kp


def step_kwargs(ref, form):
    """The step-factory keywords of ``form`` for (the reference, the
    port)."""
    f = FORMS[form]
    kr, kp = {}, {}
    if f.get("tel"):
        kr["telemetry"] = ref.telemetry.TelemetryConfig(**TEL)
        kp["telemetry"] = ptl.TelemetryConfig(**TEL)
    if f.get("inv"):
        kr["invariants"] = ref.iv.InvariantConfig()
        kp["invariants"] = piv.InvariantConfig()
    return kr, kp


def run_pair(ref, ref_sim, port_sim, ref_step, port_step, state_np,
             params_np, ticks=TICKS, armed=False):
    """Step the reference's jitted step and the port's ``ticks`` ticks:
    the params, every state leaf, the delivered words and the frame equal
    on every tick.  Returns the port's last state and both packages'
    frames' payload totals."""
    import jax

    p_r, s_r = ref_sim
    p_p, s_p = port_sim
    _assert_tree_equal(tree_to_numpy(p_r), params_np(p_p), "params")
    if armed:
        s_r, s_p = ref.iv.attach(s_r), piv.attach(s_p)
    _assert_tree_equal(tree_to_numpy(s_r), state_np(s_p), "start")
    jstep = jax.jit(ref_step)
    sent = 0
    for t in range(ticks):
        s_r, d_r, *f_r = jstep(p_r, s_r)
        s_p, d_p, *f_p = port_step(p_p, s_p)
        _assert_tree_equal(tree_to_numpy(s_r), state_np(s_p), f"tick {t}")
        np.testing.assert_array_equal(
            d_p.numpy().view(np.uint32), np.asarray(d_r),
            err_msg=f"delivered, tick {t}")
        assert len(f_p) == len(f_r)
        if f_p:
            got = convert.frame_to_numpy(f_p[0])
            assert_frames_equal(got, tree_to_numpy(f_r[0]), f"tick {t}")
            sent += int(got["payload_sent"])
    if armed:
        assert piv.report(s_p) == ref.iv.report(s_r)
    return s_p, sent


def flood_sims(ref, core, form, n=N, t=T):
    """Both packages' flood sims of ``core`` ("circulant" or "gather")
    in ``form``, and their step cores."""
    subs, topic, origin, tick = inputs(n, t)
    offs = tuple(int(o) for o in pg.make_circulant_offsets(t, 8, n, seed=1))
    kr, kp = form_kwargs(ref, form, n)
    sr, sp = step_kwargs(ref, form)
    if core == "circulant":
        nbrs = mask = None
        kr["fault_offsets"] = kp["fault_offsets"] = offs
        step_r = ref.fs.make_circulant_step_core(offs, **sr)
        step_p = pfs.make_circulant_step_core(offs, **sp)
    else:
        # a partition needs a table without sentinel slots (the
        # reference's crossing mask indexes the group by the table)
        full = "sched" in FORMS[form] and FORMS[form]["sched"] == "full"
        nbrs, mask = pg.build_topic_graph(subs, 4, seed=1,
                                          max_degree=4 if full else None)
        step_r = ref.fs.make_gather_step_core(**sr)
        step_p = pfs.make_gather_step_core(**sp)
    sim_r = ref.fs.make_flood_sim(nbrs, mask, subs, None, topic, origin,
                                  tick, **kr)
    sim_p = pfs.make_flood_sim(nbrs, mask, subs, None, topic, origin, tick,
                               **kp, device=CPU)
    return sim_r, sim_p, step_r, step_p


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("core", ["circulant", "gather"])
def test_flood_core_matches_reference_30_ticks(ref, core, form):
    sim_r, sim_p, step_r, step_p = flood_sims(ref, core, form)
    s_p, sent = run_pair(ref, sim_r, sim_p, step_r, step_p,
                         convert.flood_state_to_numpy,
                         convert.flood_params_to_numpy,
                         armed=FORMS[form].get("inv", False))
    reach = pfs.reach_counts(sim_p[0], s_p)
    assert int(reach.sum()) > 0
    assert (sent > 0) == FORMS[form].get("tel", False)


# -- the graph helpers ---------------------------------------------------------

def test_graph_builders_and_hops_match_reference(ref):
    import jax.numpy as jnp

    subs, *_ = inputs(300, 3)
    for got, want in [
            (pg.build_random_graph(300, 5, seed=2),
             ref.graph.build_random_graph(300, 5, seed=2)),
            (pg.build_random_graph(300, 5, seed=2, max_degree=6),
             ref.graph.build_random_graph(300, 5, seed=2, max_degree=6)),
            (pg.build_topic_graph(subs, 4, seed=3),
             ref.graph.build_topic_graph(subs, 4, seed=3)),
            (pg.build_topic_graph(np.zeros((9, 2), bool), 4),
             ref.graph.build_topic_graph(np.zeros((9, 2), bool), 4))]:
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    nbrs, mask = pg.build_topic_graph(subs, 4, seed=3)
    assert (~mask).any()                 # sentinel slots read zero
    rng = np.random.default_rng(4)
    words = rng.integers(0, 1 << 32, (2, 300), dtype=np.uint64).astype(
        np.uint32)
    tw = torch.from_numpy(words.view(np.int32))
    got = pg.propagate_pm(tw, torch.from_numpy(nbrs), torch.from_numpy(mask))
    want = ref.graph.propagate_pm(jnp.asarray(words), nbrs, mask)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    got = pg.propagate(tw.T.contiguous(), torch.from_numpy(nbrs),
                       torch.from_numpy(mask))
    want = ref.graph.propagate(jnp.asarray(words.T), nbrs, mask)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    offs = pg.make_circulant_offsets(3, 8, 300, seed=1)
    got = pg.propagate_circulant(tw, offs)
    want = ref.graph.propagate_circulant(jnp.asarray(words),
                                        tuple(int(o) for o in offs))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        pg.popcount_words(tw).numpy(),
        np.asarray(ref.graph.popcount_words(jnp.asarray(words))).astype(
            np.int32))


def test_lane_uniform_int32_lanes_equal_the_reference_field(ref):
    """A host-seeded 2-D field whose lanes stay below 2^31 is hashed from
    int32 lanes: the reference's values, here and where int64 lanes take
    over (a stride past 2^31 / rows)."""
    import jax.numpy as jnp

    for shape, stride in [((5, 77), None), ((128, 1000), None),
                          ((3, 10), 2 ** 30 + 7)]:
        got = pg.lane_uniform(shape, 9, 1, 0xDEADBEEF, stride=stride)
        want = ref.graph.lane_uniform(shape, jnp.int32(9), 1,
                                      jnp.uint32(0xDEADBEEF), stride=stride)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the reference's own semantic cases on the port ----------------------------

def _line(n):
    nbrs = np.full((n, 2), n, dtype=np.int32)
    for i in range(n):
        if i > 0:
            nbrs[i, 0] = i - 1
        if i < n - 1:
            nbrs[i, 1] = i + 1
    return nbrs, nbrs != n


def _first(state, m=1):
    return pfs.first_tick_matrix(state, m).numpy()


def test_line_hop_timing_blocking_and_relays():
    n = 8
    nbrs, mask = _line(n)
    subs = np.ones((n, 1), dtype=bool)
    one = (np.array([0]), np.array([0]), np.array([0]))
    p, s = pfs.make_flood_sim(nbrs, mask, subs, None, *one, device=CPU)
    np.testing.assert_array_equal(_first(pfs.flood_run(p, s, n,
                                                       device=CPU))[:, 0],
                                  np.arange(n))
    subs[2, 0] = False            # a non-subscriber stops the flood
    p, s = pfs.make_flood_sim(nbrs, mask, subs, None, *one, device=CPU)
    ft = _first(pfs.flood_run(p, s, n + 2, device=CPU))[:, 0]
    assert ft[1] == 1 and (ft[2:] == -1).all()
    relays = np.zeros((n, 1), dtype=bool)
    relays[2, 0] = True           # a relay forwards without delivering
    p, s = pfs.make_flood_sim(nbrs, mask, subs, relays, *one, device=CPU)
    ft = _first(pfs.flood_run(p, s, n + 2, device=CPU))[:, 0]
    assert ft[2] == -1 and ft[3] == 3 and ft[4] == 4


def test_multi_topic_reach_and_hops_match_reference(ref):
    n, t, m = 50, 4, 16
    nbrs, mask = pg.build_random_graph(n, 5, seed=1)
    rng = np.random.default_rng(2)
    subs = rng.random((n, t)) < 0.7
    args = (subs, None, rng.integers(0, t, m), rng.integers(0, n, m),
            rng.integers(0, 3, m))
    p_r, s_r = ref.fs.make_flood_sim(nbrs, mask, *args)
    p_p, s_p = pfs.make_flood_sim(nbrs, mask, *args, device=CPU)
    s_r, c_r = ref.fs.flood_run_curve(p_r, s_r, 30,
                                      ref.fs.make_gather_step_core(), m)
    s_p, c_p = pfs.flood_run_curve(p_p, s_p, 30,
                                   pfs.make_gather_step_core(), m,
                                   device=CPU)
    np.testing.assert_array_equal(c_p.numpy(), np.asarray(c_r))
    for got, want in [
            (pfs.reach_counts(p_p, s_p), ref.fs.reach_counts(p_r, s_r)),
            (pfs.reach_by_hops(p_p, s_p, 30),
             ref.fs.reach_by_hops(p_r, s_r, 30)),
            (pfs.first_tick_matrix(s_p, m),
             ref.fs.first_tick_matrix(s_r, m))]:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    counts = pfs.reach_counts(p_p, s_p).numpy()
    curve = pfs.reach_by_hops(p_p, s_p, 30).numpy()
    np.testing.assert_array_equal(curve[:, -1], counts)
    assert (np.diff(curve, axis=1) >= 0).all()


def test_circulant_core_equals_gather_core_on_the_same_ring():
    n, t = 600, 3
    idx = np.arange(n)
    offs = pg.make_circulant_offsets(t, 6, n, seed=5)
    nbrs = np.stack([(idx + o) % n for o in offs], 1).astype(np.int32)
    subs = np.zeros((n, t), dtype=bool)
    subs[idx, idx % t] = True
    msgs = (np.array([0, 1, 2, 0]), np.array([0, 1, 2, 300]),
            np.array([0, 0, 2, 1]))
    sched = pfl.FaultSchedule(
        n_peers=n, horizon=25, down_intervals=[(3, 2, 9), (50, 0, 25)],
        partition_group=(idx % 2).astype(np.int32),
        partition_windows=((4, 8),), seed=1)
    p_g, s_g = pfs.make_flood_sim(nbrs, np.ones_like(nbrs, bool), subs,
                                  None, *msgs, fault_schedule=sched,
                                  device=CPU)
    p_c, s_c = pfs.make_flood_sim(None, None, subs, None, *msgs,
                                  fault_schedule=sched, fault_offsets=offs,
                                  device=CPU)
    out_g = pfs.flood_run(p_g, s_g, 25, device=CPU)
    out_c = pfs.flood_run(p_c, s_c, 25, pfs.make_circulant_flood_step(offs),
                          device=CPU)
    assert torch.equal(out_g.first_tick, out_c.first_tick)
    ft = _first(out_c, 4)
    assert (ft[50] < 0).all()                      # down the whole run
    assert not ((ft[3] >= 2) & (ft[3] < 9)).any()  # down over [2, 9)


def test_offline_peer_delivers_nothing_on_both_cores():
    n, m = 120, 4
    offs = tuple(int(o) for o in pg.make_circulant_offsets(1, 6, n, seed=2))
    nbrs = np.stack([(np.arange(n) + o) % n for o in offs], 1)
    subs = np.ones((n, 1), dtype=bool)
    msgs = (np.zeros(m, np.int64), np.array([3, 10, 20, 30]),
            np.zeros(m, np.int32))
    sched = pfl.FaultSchedule(n_peers=n, horizon=30,
                              down_intervals=[(3, 0, 30)], seed=1)
    for table in (None, nbrs):
        p, s = pfs.make_flood_sim(
            table, None if table is None else np.ones_like(table, bool),
            subs, None, *msgs, fault_schedule=sched,
            fault_offsets=None if table is not None else offs, device=CPU)
        step = (pfs.flood_step if table is not None
                else pfs.make_circulant_flood_step(offs))
        out = pfs.flood_run(p, s, 30, step, device=CPU)
        assert (_first(out, m)[3] < 0).all()
        reach = pfs.reach_counts(p, out).numpy()
        assert reach[0] == 0 and (reach[1:] == n - 1).all()


# -- faults: the unpacked and gather forms -------------------------------------

def _np_leaves(fp):
    return convert.faults_to_numpy(fp)


def test_unpacked_circulant_faults_match_reference(ref):
    import jax.numpy as jnp

    n = 300
    offs = tuple(int(o) for o in pg.make_circulant_offsets(1, 40, n, seed=4))
    idx = {o: i for i, o in enumerate(offs)}
    cinv = tuple(idx[-o] for o in offs)
    grp = (np.arange(n) % 3).astype(np.int32)
    rng = np.random.default_rng(5)
    asym = rng.random((len(offs), n)).astype(np.float32) * 0.3
    for dp in (0.1, asym):
        kw = dict(n_peers=n, horizon=20, down_intervals=[(4, 1, 6)],
                  drop_prob=dp, partition_group=grp,
                  partition_windows=((3, 9),), seed=11)
        fr = ref.faults.compile_faults(ref.faults.FaultSchedule(**kw), offs,
                                       pack_links=False)
        fp = pfl.compile_faults(pfl.FaultSchedule(**kw), offs, device=CPU)
        assert fp.cross_rows is not None and fp.cross_bits is None
        _assert_tree_equal(tree_to_numpy(fr), _np_leaves(fp), "faults")
        for tick in (0, 4, 12):
            want = ref.faults.link_ok_rows(fr, offs, cinv, jnp.int32(tick))
            got = pfl.link_ok_rows(fp, offs, cinv, tick)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="pack_links needs C <= 32"):
        pfl.compile_faults(pfl.FaultSchedule(n_peers=n, horizon=5), offs,
                           device=CPU, pack_links=True)
    churn = pfl.compile_faults(
        pfl.FaultSchedule(n_peers=n, horizon=5, down_intervals=[(1, 0, 2)]),
        offs, device=CPU)
    assert pfl.link_ok_rows(churn, offs, cinv, 1) is None


def test_gather_and_dense_faults_match_reference(ref):
    n = 200
    subs, *_ = inputs(n, 2)
    nbrs, mask = pg.build_topic_graph(subs, 4, seed=2, max_degree=4)
    kw = dict(n_peers=n, horizon=20, down_intervals=[(4, 1, 6)],
              drop_prob=0.2, partition_group=(np.arange(n) % 2).astype(
                  np.int32), partition_windows=((3, 9),), seed=11)
    fr = ref.faults.compile_faults_gather(ref.faults.FaultSchedule(**kw),
                                          nbrs, mask)
    fp = pfl.compile_faults_gather(pfl.FaultSchedule(**kw), nbrs, mask,
                                   device=CPU)
    _assert_tree_equal(tree_to_numpy(fr), _np_leaves(fp), "gather")
    fr_d = ref.faults.compile_faults_dense(ref.faults.FaultSchedule(**kw))
    fp_d = pfl.compile_faults_dense(pfl.FaultSchedule(**kw), device=CPU)
    _assert_tree_equal(tree_to_numpy(fr_d), _np_leaves(fp_d), "dense")
    tn = torch.from_numpy(nbrs)
    for tick in (-2, 0, 5, 12):
        np.testing.assert_array_equal(
            pfl.link_ok_gather(fp, tn, tick).numpy(),
            np.asarray(ref.faults.link_ok_gather(fr, nbrs, tick)))
        np.testing.assert_array_equal(
            pfl.link_ok_dense(fp_d, n, tick).numpy(),
            np.asarray(ref.faults.link_ok_dense(fr_d, n, tick)))
    per_edge = np.full((4, n), 0.5, dtype=np.float32)
    for compile_ in (lambda s: pfl.compile_faults_dense(s, device=CPU),
                     lambda s: pfl.compile_faults_gather(s, nbrs, mask,
                                                         device=CPU)):
        with pytest.raises(ValueError, match="circulant"):
            compile_(pfl.FaultSchedule(n_peers=n, horizon=5,
                                       drop_prob=per_edge))
    with pytest.raises(ValueError, match="rows but the schedule"):
        pfl.compile_faults_gather(pfl.FaultSchedule(n_peers=n + 1,
                                                    horizon=5),
                                  nbrs, mask, device=CPU)


def test_pair_uniform_wraps_in_uint32_near_a_million_peers(ref):
    """``lo * span + hi`` passes 2^32 at a million peers: the port's lane
    wraps as the reference's uint32 does (no [N, N] table is built)."""
    import jax.numpy as jnp

    span = 1_000_000
    lo = np.array([999_990, 999_998, 4_295, 4_294, 123_456, 0],
                  dtype=np.int64)
    hi = np.array([999_999, 999_999, 967_296, 967_295, 654_321, 7],
                  dtype=np.int64)
    assert (lo * span + hi > 2 ** 32).sum() >= 3
    for tick in (0, 17, -3):
        got = pfl._pair_uniform(torch.from_numpy(lo), torch.from_numpy(hi),
                                span, tick, 0xC0FFEE)
        want = ref.faults._pair_uniform(
            jnp.asarray(lo.astype(np.uint32)),
            jnp.asarray(hi.astype(np.uint32)), span, tick,
            np.uint32(0xC0FFEE))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- refusals and validation ---------------------------------------------------

def test_cold_restart_is_refused_by_message_and_name(ref):
    subs, topic, origin, tick = inputs(60, 1, 2)
    sched = pfl.FaultSchedule(n_peers=60, horizon=5,
                              down_intervals=[(1, 0, 2)], cold_restart=True)
    offs = tuple(int(o) for o in pg.make_circulant_offsets(1, 4, 60))
    with pytest.raises(ValueError) as e:
        pfs.make_flood_sim(None, None, subs, None, topic, origin, tick,
                           fault_schedule=sched, fault_offsets=offs,
                           device=CPU)
    assert isinstance(e.value, plan.MeshlessRefusal)
    assert e.value.name == "flood.cold-restart"
    assert str(e.value) == ref.plan.MSG_FLOOD_COLD_RESTART
    refusal = ref.plan.plan_circulant("flood-circulant", faults=sched)
    assert (refusal.code, refusal.message) == (e.value.name, str(e.value))


def test_build_validations_keep_the_references_messages():
    subs, topic, origin, tick = inputs(60, 1, 2)
    with pytest.raises(ValueError, match="fault_schedule.n_peers=61 != "
                                         "sim peer count 60"):
        pfs.make_flood_sim(None, None, subs, None, topic, origin, tick,
                           fault_schedule=pfl.FaultSchedule(n_peers=61,
                                                            horizon=5),
                           device=CPU)
    with pytest.raises(ValueError, match="needs fault_offsets"):
        pfs.make_flood_sim(None, None, subs, None, topic, origin, tick,
                           fault_schedule=pfl.FaultSchedule(n_peers=60,
                                                            horizon=5),
                           device=CPU)


def test_unarmed_state_is_refused_by_the_checker():
    subs, topic, origin, tick = inputs(60, 1, 2)
    offs = pg.make_circulant_offsets(1, 4, 60)
    p, s = pfs.make_flood_sim(None, None, subs, None, topic, origin, tick,
                              device=CPU)
    core = pfs.make_circulant_step_core(offs,
                                        invariants=piv.InvariantConfig())
    with pytest.raises(ValueError, match=r"floodsub \(circulant\) state "
                                         "through models.invariants.attach"):
        core(p, s)
    out, _ = pfs.flood_run_curve(p, piv.attach(s), 10, core, 2, device=CPU)
    assert piv.report(out)["bits"] == 0


def test_conversion_round_trips_the_references_trees(ref):
    sim_r, sim_p, _, _ = flood_sims(ref, "gather", "armed", n=300)
    p_r, s_r = sim_r
    s_r = ref.iv.attach(s_r)
    p = convert.flood_params_from_numpy(tree_to_numpy(p_r), CPU)
    s = convert.flood_state_from_numpy(tree_to_numpy(s_r), CPU)
    _assert_tree_equal(tree_to_numpy(p_r), convert.flood_params_to_numpy(p),
                       "params")
    _assert_tree_equal(tree_to_numpy(s_r), convert.flood_state_to_numpy(s),
                       "state")
    assert s.tick == 0 and s.src_ring.shape == (DELAYS["k_slots"], 2, 300)
