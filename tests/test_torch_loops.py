"""The port's per-edge receive loops, combined form, against the JAX
reference's unpadded XLA step: byzantine payload mutation (alone, under
cold restart, beside every attack behaviour, with the router surface, at
C = 8) and the IWANT flood at a SimKnobs point, which the reference's
kernel planner refuses and its XLA step runs.

Same config, same seeded inputs (numpy), handed to both packages: the
sims build leaf-identical, and the port's step (CPU) matches the
reference's on EVERY state leaf and the delivered words, tick by tick,
for 30 ticks.  Tolerance: exact (f32/bf16 leaves compared by bit
pattern).  The builders here serve ``test_torch_loops_split.py`` and
``test_torch_loops_paths.py`` too.
"""

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import faults as pfl
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import invariants as piv
from go_libp2p_pubsub_tpu_torch.models import plan
from go_libp2p_pubsub_tpu_torch.ops import graph
from test_torch_gossipsub import _assert_tree_equal
from test_torch_knobs import one_thread  # noqa: F401  (autouse)
from test_torch_receive import _np
from torch_ref import imported_reference, tree_to_numpy

N, T = 1024, 4
SMALL = dict(d=3, d_lo=2, d_hi=6, d_score=2, d_out=1, d_lazy=2)
#: every attack behaviour compiled in, each formation armed by its flags
ALL_ATTACKS = dict(sybil_ihave_spam=True, sybil_iwant_spam=True,
                   sybil_graft_flood=True, sybil_eclipse=True,
                   byzantine_mutation=True)


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.faults as rfl
        import go_libp2p_pubsub_tpu.models.invariants as riv
        r.faults, r.invariants = rfl, riv
        yield r


def sched_kw(n, cold=False, seed=5):
    """Churn waves over ticks 3-13, link loss, one half/half partition
    (``test_torch_faults.py``'s schedule)."""
    rng = np.random.default_rng(seed)
    victims = np.flatnonzero(rng.random(n) < 0.1)
    ivs = tuple((int(p), 3 + int(p % 4), 10 + int(p % 4)) for p in victims)
    return dict(n_peers=n, horizon=60, down_intervals=ivs, drop_prob=0.05,
                seed=seed ^ 0x9E37, cold_restart=cold,
                partition_group=(np.arange(n) % 2).astype(np.int32),
                partition_windows=((12, 18),))


def build(ref, case, seed=0):
    """Both packages' (cfg, sc, params, state) of a case dict:

    ``n``, ``c``, ``m`` (1024, 16, 32), ``cfg`` / ``sc`` keyword dicts
    (``sc`` None: unscored), flag fractions ``byz``, ``sybil``,
    ``breakers``, ``invalid`` and ``eclipse`` (a formation of 200
    attackers and 80 victims), ``zero_flags`` (the named formations'
    flag arrays passed all-false), ``sched`` (a fault schedule's keyword
    overrides), ``knobs`` (sim_knobs), ``direct`` / ``px`` / ``ip`` (the
    router surface), ``per_tick`` (one message published a tick).
    Origins are drawn from the peers outside every formation."""
    n, c, m = case.get("n", N), case.get("c", 16), case.get("m", 32)
    rng = np.random.default_rng(seed)
    subs = np.zeros((n, T), dtype=bool)
    subs[np.arange(n), np.arange(n) % T] = True
    kw = {}
    pool = np.ones(n, dtype=bool)
    for name in ("byz", "sybil", "breakers"):
        if case.get(name):
            flags = rng.random(n) < case[name]
            kw[{"byz": "byzantine", "sybil": "sybil",
                "breakers": "promise_break"}[name]] = flags
            pool &= ~flags
    if case.get("eclipse"):
        es, ev = np.zeros(n, bool), np.zeros(n, bool)
        es[:200], ev[200:280] = True, True
        kw.update(eclipse_sybil=es, eclipse_victim=ev)
        pool &= ~es & ~ev
    for name in case.get("zero_flags", ()):
        kw.setdefault(name, np.zeros(n, dtype=bool))
    if "eclipse_sybil" in kw:
        kw.setdefault("eclipse_victim", np.zeros(n, dtype=bool))
    ids = np.flatnonzero(pool)
    origin = ids[rng.integers(0, len(ids), m)]
    topic = origin % T
    ticks = (np.arange(m, dtype=np.int32) if case.get("per_tick")
             else np.sort(rng.integers(0, 24, m)).astype(np.int32))
    if case.get("invalid"):
        kw["msg_invalid"] = rng.random(m) < case["invalid"]
    if case.get("ip"):
        # one peer in 32 shares its neighbour's address
        ip = np.arange(n)
        ip[1::32] -= 1
        kw["peer_ip"] = ip
    offsets = ref.gs.make_gossip_offsets(T, c, n, seed=seed)
    if case.get("direct"):
        de = np.zeros((n, c), dtype=bool)
        for j, o in enumerate(offsets):
            if o > 0:
                hit = rng.random(n) < case["direct"]
                de[:, j] |= hit
                de[:, offsets.index(-o)] |= np.roll(hit, o)
        kw["direct_edges"] = de
    if case.get("px"):
        kw["px_candidates"] = case["px"]
    if case.get("knobs") is not None:
        kw["sim_knobs"] = dict(case["knobs"])
    cfg_kw = dict(SMALL if c == 8 else {}, **case.get("cfg", {}))
    cfg_r = ref.gs.GossipSimConfig(offsets=offsets, n_topics=T, **cfg_kw)
    cfg_p = pgs.GossipSimConfig(offsets=offsets, n_topics=T, **cfg_kw)
    sc_kw = case.get("sc", {})
    sc_r = None if sc_kw is None else ref.gs.ScoreSimConfig(**sc_kw)
    sc_p = None if sc_kw is None else pgs.ScoreSimConfig(**sc_kw)
    f_r = f_p = None
    if case.get("sched") is not None:
        s_kw = sched_kw(n, **case["sched"])
        f_r = ref.faults.FaultSchedule(**s_kw)
        f_p = pfl.FaultSchedule(**s_kw)
    args = (subs, topic, origin, ticks)
    p_r, s_r = ref.gs.make_gossip_sim(cfg_r, *args, seed=seed, score_cfg=sc_r,
                                      fault_schedule=f_r, **kw)
    p_p, s_p = pgs.make_gossip_sim(cfg_p, *args, seed=seed, score_cfg=sc_p,
                                   fault_schedule=f_p, device="cpu", **kw)
    return (cfg_r, sc_r, p_r, s_r), (cfg_p, sc_p, p_p, s_p)


def run_pair(ref, case, ticks=30, invariants=False, seed=0):
    """Step both packages ``ticks`` heartbeats (``case["force_split"]``
    passed to both), asserting every state leaf and the delivered words
    equal on every tick; returns the port's (cfg, sc, params, end state)
    and its states over the run."""
    import jax

    (cfg_r, sc_r, p_r, s_r), (cfg_p, sc_p, p_p, s_p) = build(ref, case,
                                                             seed)
    _assert_tree_equal(tree_to_numpy(p_r), convert.params_to_numpy(p_p),
                       "params")
    _assert_tree_equal(tree_to_numpy(s_r), convert.state_to_numpy(s_p),
                       "state")
    split = case.get("force_split", False)
    icfg_r = icfg_p = None
    if invariants:
        icfg_r, icfg_p = ref.invariants.InvariantConfig(), \
            piv.InvariantConfig()
        s_r, s_p = ref.invariants.attach(s_r), piv.attach(s_p)
    step_r = jax.jit(ref.gs.make_gossip_step(cfg_r, sc_r, force_split=split,
                                             invariants=icfg_r))
    step_p = pgs.make_gossip_step(cfg_p, sc_p, device="cpu",
                                  force_split=split, invariants=icfg_p)
    states = []
    for t in range(ticks):
        s_r, d_r = step_r(p_r, s_r)
        s_p, d_p = step_p(p_p, s_p)
        _assert_tree_equal(tree_to_numpy(s_r), convert.state_to_numpy(s_p),
                           f"tick {t}")
        np.testing.assert_array_equal(_np(d_p), np.asarray(d_r),
                                      err_msg=f"tick {t}")
        states.append(s_p)
    return cfg_p, sc_p, p_p, s_p, states


def assert_rejection(cfg, params, states, clean_elsewhere: bool):
    """Byzantine rejection at work: P4 on some edge from a mutator and,
    where no message is invalid, on no other edge, over the run."""
    from_byz = graph.expand_bits(params.cand_byz, cfg.n_candidates)
    on_byz = other = 0.0
    for s in states:
        inv = s.scores.invalid_deliveries.float()
        on_byz = max(on_byz, float(inv[from_byz].max()))
        if (~from_byz).any():
            other = max(other, float(inv[~from_byz].max()))
    assert on_byz > 0
    if clean_elsewhere:
        assert other == 0.0


COMBINED = {
    # the reference's byzantine formation, scaled: 20% mutators
    "byzantine": dict(byz=0.2, sc=dict(byzantine_mutation=True)),
    "byzantine_cold_restart": dict(byz=0.2, sc=dict(byzantine_mutation=True),
                                   sched=dict(cold=True)),
    # every attack behaviour compiled in, one formation armed at a time
    "all_attacks_spam": dict(sybil=0.2, invalid=0.3, sc=ALL_ATTACKS,
                             zero_flags=("byzantine", "eclipse_sybil",
                                         "promise_break")),
    "all_attacks_eclipse": dict(eclipse=True, sc=ALL_ATTACKS,
                                cfg=dict(backoff_ticks=4),
                                zero_flags=("byzantine", "sybil",
                                            "promise_break")),
    "all_attacks_byzantine": dict(byz=0.2, sc=ALL_ATTACKS,
                                  zero_flags=("sybil", "eclipse_sybil",
                                              "promise_break")),
    "all_attacks_breakers": dict(breakers=0.1, sc=ALL_ATTACKS,
                                 zero_flags=("byzantine", "sybil",
                                             "eclipse_sybil")),
    # formerly refused by the port: a SimKnobs point on an IWANT flood
    "iwant_flood_knobs": dict(sybil=0.2, sc=dict(sybil_ihave_spam=True,
                                                  sybil_iwant_spam=True),
                              knobs=dict(gossip_retransmission=2, d=5,
                                         d_lo=4, graylist_threshold=-60.0)),
    # the router surface: flood publishing, direct peers, exact-k, PX,
    # the shared-IP gater
    "byzantine_surface": dict(byz=0.2, sc=dict(byzantine_mutation=True,
                                               flood_publish=True),
                              cfg=dict(binomial_gossip_sampling=False),
                              direct=0.05, px=14, ip=True),
    "byzantine_c8": dict(c=8, byz=0.2, sc=dict(byzantine_mutation=True)),
}


@pytest.mark.parametrize("name", sorted(COMBINED))
def test_combined_loops_match_reference_30_ticks(ref, name):
    case = COMBINED[name]
    cfg, sc, params, end, states = run_pair(ref, case)
    assert plan.receive_path(cfg, sc, params) == plan.COMBINED
    # non-vacuous: meshes formed and messages moved
    assert int(pgs.mesh_degrees(end).max()) >= cfg.d
    assert bool(end.have.any())
    if params.cand_byz is not None and bool(params.cand_byz.any()):
        assert_rejection(cfg, params, states, not case.get("invalid"))
    if name == "iwant_flood_knobs":
        assert int(end.iwant_serves[:, params.sybil].max()) > 0
    if name == "all_attacks_eclipse":
        assert max(pgs.eclipse_takeover(s, params, cfg) for s in states) > 0
    if name == "byzantine_surface":
        assert params.cand_direct is not None and end.active is not None
        assert params.cand_same_ip is not None


def test_unscored_c16_stays_on_the_kernel(ref):
    """The unscored step at C = 16 is the kernel's: its route says so and
    it still equals the reference."""
    case = dict(sc=None)
    cfg, sc, params, end, _ = run_pair(ref, case)
    assert plan.receive_path(cfg, sc, params) == plan.KERNEL
    assert int(pgs.mesh_degrees(end).max()) >= cfg.d


def test_byzantine_convert_round_trips(ref):
    (_, _, p_r, _), (_, _, p_p, _) = build(ref, COMBINED["byzantine"], 4)
    p_np = tree_to_numpy(p_r)
    assert p_np["byzantine"] is not None and p_np["cand_byz"] is not None
    p2 = convert.params_from_numpy(p_np, "cpu")
    _assert_tree_equal(p_np, convert.params_to_numpy(p2), "params")
    for f in ("byzantine", "cand_byz"):
        assert torch.equal(getattr(p2, f), getattr(p_p, f)), f


def test_byzantine_needs_a_score_config(ref):
    (subs, topic, origin, ticks) = (
        np.eye(T, dtype=bool)[np.arange(N) % T], np.array([0]),
        np.array([0]), np.array([0], np.int32))
    cfg = pgs.GossipSimConfig(offsets=pgs.make_gossip_offsets(T, 16, N),
                              n_topics=T)
    cfg_r = ref.gs.GossipSimConfig(offsets=cfg.offsets, n_topics=T)
    bz = np.zeros(N, dtype=bool)
    with pytest.raises(ValueError) as mine:
        pgs.make_gossip_sim(cfg, subs, topic, origin, ticks, byzantine=bz,
                            device="cpu")
    with pytest.raises(ValueError) as theirs:
        ref.gs.make_gossip_sim(cfg_r, subs, topic, origin, ticks,
                               byzantine=bz)
    assert str(mine.value) == str(theirs.value)
