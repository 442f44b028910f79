"""The port's fault schedules (churn, link loss, partitions, cold restart)
against the JAX reference.

Same schedules and seeded inputs (numpy) go to both packages, at the
shapes of the reference's own fault tests (``tests/test_pallas_receive.py``
``_sched``: 900 peers, 4 topics, staggered churn waves, 5% symmetric
link loss and a half/half partition over ticks [12, 18); one C = 16
case at 1,024 peers):

- ``compile_faults`` leaf for leaf, for every form of drop rate, a
  partition and cold restart; the schedule's validation naming the field;
- the port's step (CPU, plain kernel versions) against the reference's
  unpadded XLA step on every state leaf for 30 ticks: scored, unscored,
  the IWANT flood, paired topics, cold restart, directed drops; each
  shown non-vacuous (a clean run of the same seed differs);
- a schedule without faults equal to no schedule, bit for bit;
- the plain receive under faults against the reference's Pallas kernel
  (``with_faults``, interpret mode), and the plain fused window under
  faults and cold restart against its Pallas fused kernel and against
  T per-tick steps;
- the degradation and recovery readouts.

Tolerance: exact (packed words and integer counters bitwise, f32/bf16
leaves by bit pattern; no exception).
"""

import dataclasses

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import _delivery as pdl
from go_libp2p_pubsub_tpu_torch.models import faults as pfl
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.ops import graph as pg
from go_libp2p_pubsub_tpu_torch.ops.kernels import fused as pfused
from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as prc
from test_torch_fused import OUT_NAMES, window_operands
from test_torch_gossipsub import _assert_tree_equal
from test_torch_receive import BLOCK, _bits, _np, _operands
from test_torch_unscored import unscored_operands
from torch_ref import imported_reference, tree_to_numpy

N, T = 900, 4
SMALL = dict(d=3, d_lo=2, d_hi=6, d_score=2, d_out=1, d_lazy=2,
             gossip_factor=0.25, backoff_ticks=8)


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models._delivery as rdl
        import go_libp2p_pubsub_tpu.models.faults as rfl
        r.faults, r.delivery = rfl, rdl
        yield r


def _sched_kw(n, seed=5, horizon=40, drop=0.05, partition=True,
              churn_frac=0.1, cold=False):
    """``tests/test_pallas_receive.py`` ``_sched``'s schedule: staggered
    churn waves over ticks 3-13, symmetric link loss, one mid-run
    half/half partition."""
    rng = np.random.default_rng(seed)
    victims = np.flatnonzero(rng.random(n) < churn_frac)
    ivs = tuple((int(p), 3 + int(p % 4), 10 + int(p % 4)) for p in victims)
    kw = dict(n_peers=n, horizon=horizon, down_intervals=ivs,
              drop_prob=drop, seed=seed ^ 0x9E37, cold_restart=cold)
    if partition:
        kw.update(partition_group=(np.arange(n) % 2).astype(np.int32),
                  partition_windows=((12, 18),))
    return kw


def _schedules(ref, **kw):
    """The same schedule for both packages."""
    return ref.faults.FaultSchedule(**kw), pfl.FaultSchedule(**kw)


#: the step cases: score, sybil fraction, score toggles, paired, C
STEP = {
    "scored": dict(),
    "unscored": dict(score=False),
    "iwant_flood": dict(sybil_frac=0.2, invalid_frac=0.3,
                        sc=dict(sybil_ihave_spam=True, sybil_iwant_spam=True),
                        sched=dict(partition=False)),
    "paired": dict(paired=True, sybil_frac=0.15,
                   sc=dict(sybil_ihave_spam=True, topic_score_cap=25.0)),
    "paired_unscored": dict(paired=True, score=False),
    "cold_restart": dict(sched=dict(cold=True)),
    "cold_restart_unscored": dict(score=False, sched=dict(cold=True)),
    "c16": dict(n=1024, c=16),
    "directed": dict(directed=True),
}


def _build(ref, name, faults=True, seed=3, m=10, n=None, empty=False):
    """Both packages' sims of a case: under the case's schedule, none
    (``faults`` False) or one without faults (``empty``)."""
    case = STEP[name]
    n, c = n or case.get("n", N), case.get("c", 8)
    paired = case.get("paired", False)
    rng = np.random.default_rng(seed)
    offsets = ref.gs.make_gossip_offsets(T, c, n, seed=seed, paired=paired)
    cfg_kw = dict(SMALL if c == 8 else {}, offsets=offsets, n_topics=T,
                  paired_topics=paired)
    idx = np.arange(n)
    subs = np.zeros((n, T), dtype=bool)
    subs[idx, idx % T] = True
    if paired:
        subs[idx, (idx % T + T // 2) % T] = True
    topic = rng.integers(0, T, m)
    origin = rng.integers(0, n // T, m) * T + topic
    ticks = np.sort(rng.integers(0, 12, m)).astype(np.int32)
    kw = {}
    scored = case.get("score", True)
    if scored:
        kw = dict(sybil=rng.random(n) < case.get("sybil_frac", 0.0),
                  msg_invalid=rng.random(m) < case.get("invalid_frac", 0.0),
                  app_score=rng.normal(0, 0.1, n).astype(np.float32))
    sched_kw = _sched_kw(n, **case.get("sched", {}))
    if case.get("directed"):
        # a per-edge rate on one view of each edge only: per direction
        dp = np.zeros((c, n), dtype=np.float32)
        for j, o in enumerate(offsets):
            if o > 0:
                dp[j] = 0.1
        sched_kw["drop_prob"] = dp
    cfg_r = ref.gs.GossipSimConfig(**cfg_kw)
    cfg_p = pgs.GossipSimConfig(**cfg_kw)
    sc_r = ref.gs.ScoreSimConfig(**case.get("sc", {})) if scored else None
    sc_p = pgs.ScoreSimConfig(**case.get("sc", {})) if scored else None
    f_r = f_p = None
    if empty:
        f_r, f_p = _schedules(ref, n_peers=n, horizon=40)
    elif faults:
        f_r, f_p = _schedules(ref, **sched_kw)
    args = (subs, topic, origin, ticks)
    ref_sim = ref.gs.make_gossip_sim(cfg_r, *args, seed=seed, score_cfg=sc_r,
                                     fault_schedule=f_r, **kw)
    port_sim = pgs.make_gossip_sim(cfg_p, *args, seed=seed, score_cfg=sc_p,
                                   fault_schedule=f_p, device="cpu", **kw)
    return (cfg_r, sc_r, *ref_sim), (cfg_p, sc_p, *port_sim)


# -- the compiled schedule ---------------------------------------------------

COMPILE = {
    "scalar": dict(drop_prob=0.05),
    "symmetric": dict(drop_prob="symmetric"),
    "asymmetric": dict(drop_prob="asymmetric"),
    "partition": dict(drop_prob=0.0, partition_group="halves",
                      partition_windows=((4, 9), (12, 18))),
    "cold_restart": dict(cold_restart=True),
}


@pytest.mark.parametrize("name", sorted(COMPILE))
def test_compile_faults_matches_reference(ref, name):
    n, c = 120, 8
    offsets = tuple(int(o) for o in ref.gs.make_gossip_offsets(
        T, c, n, seed=1))
    kw = dict(_sched_kw(n, partition=False), **COMPILE[name])
    rng = np.random.default_rng(4)
    if kw["drop_prob"] in ("symmetric", "asymmetric"):
        dp = rng.uniform(0, 0.3, (c, n)).astype(np.float32)
        if kw["drop_prob"] == "symmetric":
            # each edge's rate on both of its views
            idx = {o: i for i, o in enumerate(offsets)}
            for j, o in enumerate(offsets):
                if o > 0:
                    dp[idx[-o]] = np.roll(dp[j], o)
        kw["drop_prob"] = dp
    if kw.get("partition_group") == "halves":
        kw["partition_group"] = (np.arange(n) < n // 2).astype(np.int64)
    s_r, s_p = _schedules(ref, **kw)
    want = tree_to_numpy(ref.faults.compile_faults(s_r, offsets,
                                                   pack_links=True))
    fp = pfl.compile_faults(s_p, offsets, device="cpu")
    _assert_tree_equal(want, convert.faults_to_numpy(fp), name)
    assert fp.directed_drops == (name == "asymmetric")
    assert fp.cold_restart == (name == "cold_restart")
    # the per-tick masks agree on every tick of the horizon
    cinv = tuple(offsets.index(-o) for o in offsets)
    fr = ref.faults.compile_faults(s_r, offsets, pack_links=True)
    for tick in range(0, 40, 3):
        np.testing.assert_array_equal(
            pfl.alive_mask(fp, tick).numpy(),
            np.asarray(ref.faults.alive_mask(fr, tick)))
        np.testing.assert_array_equal(
            pfl.rejoined_mask(fp, tick).numpy(),
            np.asarray(ref.faults.rejoined_mask(fr, tick)))
        want_l = ref.faults.link_ok_bits(fr, offsets, cinv,
                                         np.int32(tick))
        got_l = pfl.link_ok_bits(fp, offsets, cinv, tick)
        if want_l is None:
            assert got_l is None
        else:
            np.testing.assert_array_equal(_np(got_l), np.asarray(want_l))


#: the reference's validation cases (``tests/test_faults.py``), each
#: naming the field it rejects
VALIDATION = [
    (dict(down_intervals=[(20, 0, 5)]), "down_intervals"),
    (dict(down_intervals=[(0, 5, 3)]), "down_intervals"),
    (dict(down_intervals=[(0, 0, 200)]), "down_intervals"),
    (dict(down_intervals=[(0, 0, 6), (0, 4, 9)]), "down_intervals"),
    (dict(drop_prob=1.5), "drop_prob"),
    (dict(drop_prob=-0.1), "drop_prob"),
    (dict(drop_prob=np.full((3,), 0.1)), "drop_prob"),
    (dict(partition_windows=[(0, 5)]), "partition_group"),
    (dict(partition_windows=[(5, 3)],
          partition_group=np.zeros(20, np.int64)), "partition_windows"),
    (dict(partition_windows=[(0, 200)],
          partition_group=np.zeros(20, np.int64)), "partition_windows"),
    (dict(partition_windows=[(0, 6), (4, 9)],
          partition_group=np.zeros(20, np.int64)), "partition_windows"),
    (dict(partition_windows=[(0, 5)],
          partition_group=np.zeros(7, np.int64)), "partition_group"),
    (dict(partition_windows=[(0, 5)],
          partition_group=-np.ones(20, np.int64)), "partition_group"),
]


@pytest.mark.parametrize("kw,field", VALIDATION)
def test_schedule_validation_names_the_field(ref, kw, field):
    for mod in (ref.faults, pfl):
        with pytest.raises(ValueError, match=field):
            mod.FaultSchedule(n_peers=20, horizon=100, **kw)
    # a no-op interval (start == end) is valid padding, not a down tick
    s = pfl.FaultSchedule(n_peers=20, horizon=100,
                          down_intervals=[(3, 7, 7)])
    fp = pfl.compile_faults(s, (4, -4), device="cpu")
    assert bool(pfl.alive_mask(fp, 7).all())


def test_schedule_peer_count_must_match_the_sim(ref):
    (cfg_r, sc_r, *_), (cfg_p, sc_p, *_) = _build(ref, "scored",
                                                  faults=False)
    bad = dict(_sched_kw(N + 4))
    f_r, f_p = _schedules(ref, **bad)
    rng = np.random.default_rng(3)
    subs = np.zeros((N, T), dtype=bool)
    subs[np.arange(N), np.arange(N) % T] = True
    topic = rng.integers(0, T, 4)
    args = (subs, topic, topic, np.zeros(4, np.int32))
    msgs = []
    for gs_mod, cfg, sc, f in ((ref.gs, cfg_r, sc_r, f_r),
                               (pgs, cfg_p, sc_p, f_p)):
        kw = {} if gs_mod is ref.gs else {"device": "cpu"}
        with pytest.raises(ValueError, match="fault_schedule.n_peers") as e:
            gs_mod.make_gossip_sim(cfg, *args, score_cfg=sc,
                                   fault_schedule=f, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -- the step against the reference's XLA step -------------------------------

def _run_pair(ref, name, ticks=30, faults=True, check=True):
    """Step both packages ``ticks`` heartbeats, asserting every state
    leaf equal on every tick (``check`` False: the port alone); the
    port's end state, its delivered words over the run and the serve
    ledger's largest entry over the run."""
    import jax

    (cfg_r, sc_r, p_r, s_r), (cfg_p, sc_p, p_p, s_p) = _build(ref, name,
                                                              faults)
    if check:
        _assert_tree_equal(tree_to_numpy(p_r), convert.params_to_numpy(p_p),
                           "params")
        step_r = jax.jit(ref.gs.make_gossip_step(cfg_r, sc_r))
    step_p = pgs.make_gossip_step(cfg_p, sc_p, device="cpu")
    delivered = []
    serves = 0
    for t in range(ticks):
        s_p, d_p = step_p(p_p, s_p)
        if check:
            s_r, d_r = step_r(p_r, s_r)
            _assert_tree_equal(tree_to_numpy(s_r),
                               convert.state_to_numpy(s_p),
                               f"{name} tick {t}")
            np.testing.assert_array_equal(_np(d_p), np.asarray(d_r),
                                          err_msg=f"{name} tick {t}")
        delivered.append(d_p)
        if s_p.iwant_serves is not None:
            serves = max(serves, int(s_p.iwant_serves.max()))
    return cfg_p, p_p, s_p, torch.stack(delivered), serves


@pytest.mark.parametrize("name", sorted(STEP))
def test_faulted_step_matches_reference_30_ticks(ref, name):
    cfg, params, end, delivered, serves = _run_pair(ref, name)
    fp = params.faults
    # non-vacuous: peers were down, links were cut, meshes formed and
    # messages moved, and a clean run of the same seed differs
    assert not bool(pfl.alive_mask(fp, 6).all())
    assert bool(pfl.link_ok_bits(fp, cfg.offsets, cfg.cinv, 14).ne(
        (1 << cfg.n_candidates) - 1).any())
    assert int(pgs.mesh_degrees(end).max()) >= cfg.d
    assert bool(end.have.any())
    _, _, clean, clean_d, _ = _run_pair(ref, name, faults=False,
                                        check=False)
    assert not (torch.equal(clean.mesh, end.mesh)
                and torch.equal(clean_d, delivered))
    if STEP[name].get("sc", {}).get("sybil_iwant_spam"):
        assert serves > 0
    if STEP[name].get("paired"):
        assert int(pg.popcount32(end.mesh_b).max()) >= cfg.d


def test_cold_restart_clears_the_rejoiners(ref):
    """Peers back up at ticks 10-13 come back cold: what they held
    before going down is cleared and only what is still inside their
    partners' IHAVE windows comes back, so the cold run's possession at
    the rejoiners differs from the warm run's."""
    cfg, params, cold, *_ = _run_pair(ref, "cold_restart", ticks=14)
    _, _, warm, *_ = _run_pair(ref, "scored", ticks=14, check=False)
    rej = torch.stack([pfl.rejoined_mask(params.faults, t)
                       for t in range(10, 14)]).any(0)
    assert bool(rej.any())
    assert not torch.equal(cold.have[:, rej], warm.have[:, rej])


@pytest.mark.parametrize("name", ["scored", "paired_unscored"])
def test_zero_fault_schedule_equals_no_schedule(ref, name):
    _, (cfg, sc, p_n, s_n) = _build(ref, name, faults=False)
    _, (_, _, p_e, s_e) = _build(ref, name, empty=True)
    assert p_e.faults is not None and p_e.faults.drop_prob is None
    step = pgs.make_gossip_step(cfg, sc, device="cpu")
    for t in range(30):
        s_n, d_n = step(p_n, s_n)
        s_e, d_e = step(p_e, s_e)
        _assert_tree_equal(convert.state_to_numpy(s_n),
                           convert.state_to_numpy(s_e), f"tick {t}")
        assert torch.equal(d_n, d_e)
    assert bool(s_e.have.any())


# -- the kernels' plain versions against the Pallas kernels ------------------

@pytest.mark.parametrize("scored", [True, False])
def test_faulted_receive_plain_matches_pallas_kernel(ref, scored):
    """The plain receive under faults (scored: with both spams, so the
    flood_ok word is live) against make_receive_update(with_faults=True)
    in interpret mode, on seeded operands with a tenth of the peers
    down."""
    import jax.numpy as jnp

    n, c = 1024, 16 if scored else 8
    offsets = ref.gs.make_gossip_offsets(T, c, n, seed=3)
    cfg_kw = dict(offsets=offsets, n_topics=T, **({} if scored else SMALL))
    sc_kw = dict(sybil_ihave_spam=True, sybil_iwant_spam=True)
    cfg = ref.gs.GossipSimConfig(**cfg_kw)
    sc = ref.gs.ScoreSimConfig(**sc_kw) if scored else None
    k = prc.receive_consts(pgs.GossipSimConfig(**cfg_kw),
                           pgs.ScoreSimConfig(**sc_kw) if scored else None,
                           faults=True)
    rng = np.random.default_rng(61 + scored)
    if scored:
        ops = _operands(rng, 1, False, sc)
        ops["syb"] = torch.from_numpy(np.where(
            rng.random(n) < 0.2, (1 << c) - 1, 0).astype(np.int32))
        ops["iws"] = torch.from_numpy(rng.integers(
            0, 4 * 32, size=(c, n)).astype(np.int16))
        ops["flood_ok"] = torch.from_numpy(rng.integers(
            0, 1 << c, size=n).astype(np.int32))
    else:
        ops = unscored_operands(rng, c, n, 1)
    down = rng.random(n) < 0.1
    ops["alive_w"] = torch.from_numpy(np.where(down, 0, -1).astype(np.int32))
    got = prc.receive_update(k, **ops)         # CPU tensors: plain version

    rc = ref.receive
    pln = rc.plan(n, cfg.offsets, BLOCK)

    def flat(rows, p, e):
        return jnp.concatenate([
            rc.extend_wrap(jnp.asarray(r), n, pln["n_pad"], pln[p], pln[e])
            for r in rows])

    krn = rc.make_receive_update(
        cfg, sc, n, BLOCK, jnp.bfloat16 if scored else jnp.float32, 1,
        track_promises=scored, interpret=True, with_static=False,
        with_faults=True)
    head = ([jnp.asarray(_np(ops["valid"]))] if scored else []) + [
        jnp.asarray(np.array(ops["gseeds"], dtype=np.uint32)),
        jnp.zeros((1,), dtype=jnp.uint32)]
    flats = [flat(list(_np(ops["ctrl"])), "p8", "e8"),
             flat(list(_np(ops["fresh"])), "p32", "e32"),
             flat(list(_np(ops["adv"])), "p32", "e32")]
    zero = np.zeros(n, dtype=np.uint32)
    blocked = ([_np(ops[k_]) for k_ in ("pay", "gsp", "acc")]
               if scored else [])
    blocked += [_np(ops[k_]) for k_ in ("sub_all", "cand_sub", "fanout")]
    blocked += [_np(ops["syb"]) if scored else zero, _np(ops["wa"]),
                _np(ops["bo2"]) if scored else zero]
    blocked += [_np(ops[k_]) for k_ in ("grafts", "dropped", "meshsel",
                                         "seen", "injected", "backoff")]
    if scored:
        blocked += [_np(ops[k_]) for k_ in ("fd", "inv", "bp", "tim",
                                             "iws")]
    blocked.append(_np(ops["alive_w"]))
    if scored:
        blocked.append(_np(ops["flood_ok"]))
    want = krn(*head, *flats, *[jnp.asarray(b) for b in blocked])
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_bits(_np(g)), _bits(w),
                                      err_msg=f"output {i}")
    # non-vacuous: the down peers heard nothing, and without the alive
    # word the outputs differ
    dn = torch.from_numpy(down)
    assert not bool((got[0][:, dn] & ~ops["injected"][:, dn]).any())
    clean = prc.receive_update(
        dataclasses.replace(k, faults=False),
        **{k_: v for k_, v in ops.items()
           if k_ not in ("alive_w", "flood_ok")})
    assert not torch.equal(clean[0], got[0])
    if scored:
        assert not torch.equal(clean[-1], got[-1])    # the serve ledger


def _fused_faulted_operands(ref, cold, ticks=4):
    """A port sim under the reference test schedule (cold restart or
    not), stepped to tick 9 (inside the churn waves), and the window's
    operands from there with its fault rows."""
    _, (cfg, _, params, state) = _build(
        ref, "cold_restart_unscored" if cold else "unscored", n=1024)
    step = pgs.make_gossip_step(cfg, None, device="cpu")
    state = pgs.gossip_run(params, state, 9, step, device="cpu")
    ops = window_operands(cfg, params, state, ticks)
    fp = params.faults
    masks = [pfl.tick_masks(fp, cfg.offsets, cfg.cinv, state.tick + t)
             for t in range(ticks)]
    ops.update(alive=torch.stack([m.alive_w for m in masks]),
               send_ok=torch.stack([m.send_ok for m in masks]),
               cand_alive=torch.stack([m.cand_alive for m in masks]))
    if cold:
        ops["rejoin"] = torch.stack([
            pfl.alive_word(pfl.rejoined_mask(fp, state.tick + t))
            for t in range(ticks)])
    return cfg, params, state, step, ops


@pytest.mark.parametrize("cold", [False, True])
def test_faulted_fused_plain_matches_pallas_kernel_and_ticks(ref, cold):
    import jax.numpy as jnp

    cfg, params, state, step, ops = _fused_faulted_operands(ref, cold)
    ticks = len(ops["seeds"])
    k = pfused.fused_consts(cfg)
    got = pfused.fused_gossip_update(k, **ops)    # CPU: plain version
    cfg_r = ref.gs.GossipSimConfig(offsets=cfg.offsets, n_topics=T, **SMALL)
    W, hg = state.have.shape[0], cfg.history_gossip
    n = state.have.shape[1]
    krn = ref.receive.make_fused_gossip_update(
        cfg_r, n, W, hg, ticks, interpret=True, stream_n=n,
        with_faults=True, cold_restart=cold)
    u32 = lambda t: jnp.asarray(_np(t))            # noqa: E731
    args = [jnp.asarray([ops["tick0"]], jnp.int32),
            jnp.asarray(np.array(ops["seeds"], dtype=np.uint32)),
            u32(ops["due"]), jnp.zeros((1,), jnp.uint32),
            u32(ops["sub_all"]), u32(ops["cand_sub"]), u32(ops["origin"]),
            u32(ops["have"]), u32(ops["recent"].reshape(hg * W, n)),
            u32(ops["mesh"]), u32(ops["fanout"]),
            jnp.asarray(ops["last_pub"].numpy()),
            jnp.asarray(ops["backoff"].numpy()), u32(ops["tgt"]),
            u32(ops["bog"]), u32(ops["alive"]), u32(ops["send_ok"]),
            u32(ops["cand_alive"])]
    if cold:
        args.append(u32(ops["rejoin"]))
    want = krn(*args)
    assert len(got) == len(want) == len(OUT_NAMES)
    for name, g, w in zip(OUT_NAMES, got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(
            g.numpy().view(w.dtype).reshape(w.shape), w, err_msg=name)
    # T per-tick steps give the same carry and acquisitions
    s = state
    for t in range(ticks):
        s, d = step(params, s)
        assert torch.equal(d, got[8][t] & params.deliver_words), t
    for name, g in zip(("have", "recent", "mesh", "fanout", "last_pub",
                        "backoff"), got):
        assert torch.equal(getattr(s, name), g), name
    assert torch.equal(s.gates[0], got[6]) and torch.equal(s.gates[1], got[7])
    # non-vacuous: peers were down in the window (and some rejoined)
    assert not bool((ops["alive"] == -1).all())
    if cold:
        assert bool(ops["rejoin"].any())
    clean = pfused.fused_gossip_update(
        k, **{k_: v for k_, v in ops.items()
              if k_ not in pfused.FAULT_ROWS})
    assert not torch.equal(clean[2], got[2])


@pytest.mark.parametrize("cold", [False, True])
def test_faulted_fused_window_runs_match_per_tick_runs(ref, cold):
    _, (cfg, _, params, state) = _build(
        ref, "cold_restart_unscored" if cold else "unscored")
    step = pgs.make_gossip_step(cfg, None, device="cpu")
    win = pgs.make_fused_window(cfg, None, ticks_fused=4, device="cpu")
    s_t, c_t = pgs.gossip_run_curve(params, state, 24, step, 10,
                                    device="cpu")
    s_f, c_f = pgs.gossip_run_curve_fused(params, state, 24, win, 10,
                                          device="cpu")
    _assert_tree_equal(convert.state_to_numpy(s_t),
                       convert.state_to_numpy(s_f), "window")
    assert torch.equal(c_t, c_f) and int(c_t.sum()) > 0


# -- readouts ----------------------------------------------------------------

def test_delivery_readouts_match_reference(ref):
    import jax.numpy as jnp

    counts = np.zeros((10, 3), np.int32)
    counts[2, 0] = 100          # full before heal: recovery 0
    counts[7, 1] = 100          # recovers 3 ticks after heal
    counts[3, 2] = 50           # stuck at 50%: never
    got = pdl.recovery_ticks(torch.from_numpy(counts), 4, 100.0, frac=0.99)
    assert got.tolist() == [0, 3, -1]
    rng = np.random.default_rng(8)
    counts = rng.integers(0, 40, size=(30, 7)).astype(np.int32)
    want_n = rng.integers(200, 900, size=7).astype(np.float32)
    for heal, frac in ((0, 0.99), (11, 0.5), (20, 0.9)):
        np.testing.assert_array_equal(
            pdl.recovery_ticks(torch.from_numpy(counts), heal,
                               torch.from_numpy(want_n), frac=frac).numpy(),
            np.asarray(ref.delivery.recovery_ticks(
                jnp.asarray(counts), heal, jnp.asarray(want_n), frac=frac)))
    np.testing.assert_array_equal(
        pdl.delivery_fraction_curve(torch.from_numpy(counts),
                                    torch.from_numpy(want_n)).numpy()
        .view(np.uint32),
        np.asarray(ref.delivery.delivery_fraction_curve(
            jnp.asarray(counts), jnp.asarray(want_n))).view(np.uint32))


def test_convert_round_trips_the_fault_params(ref):
    (_, _, p_r, _), (_, _, p_p, _) = _build(ref, "cold_restart")
    p_np = tree_to_numpy(p_r)
    p2 = convert.params_from_numpy(p_np, "cpu")
    _assert_tree_equal(p_np, convert.params_to_numpy(p2), "params")
    assert p2.faults.part_start == p_p.faults.part_start == (12,)
    assert p2.faults.cold_restart and p2.faults.seed == p_p.faults.seed


def test_churn_build_is_the_benchmark_in_its_draw_order(ref):
    """``churn.build`` makes the sim bench_suite.py's
    ``bench_gossipsub_v11_churn`` makes (its lines, with the reference's
    modules: ``torch_reference_gate.reference_churn_sim``), leaf for
    leaf, at 20,000 peers."""
    from go_libp2p_pubsub_tpu_torch import churn
    from torch_reference_gate import reference_churn_sim

    n = 20_000
    (_, _, p_r, s_r, sched, probe, heal, warmup,
     ticks) = reference_churn_sim(ref, n)
    _, _, p_p, s_p, tick, probes = churn.build("cpu", n_peers=n)
    assert (warmup, ticks, heal) == (churn.WARMUP, churn.TIMED,
                                     churn.heal_tick())
    np.testing.assert_array_equal(probes, probe)
    np.testing.assert_array_equal(tick, np.asarray(p_r.publish_tick))
    _assert_tree_equal(tree_to_numpy(p_r), convert.params_to_numpy(p_p),
                       "params")
    _assert_tree_equal(tree_to_numpy(s_r), convert.state_to_numpy(s_p),
                       "state")
    assert p_p.faults.part_start == (churn.WARMUP + 20,)
    assert int(p_p.faults.down_start.shape[1]) == 1
    assert len(sched.down_intervals) == int(
        (p_p.faults.down_end > 0).sum())
