"""The port's traced knobs (``models/knobs.py``, ``ScoreKnobs``, the fault
knob ``drop_prob``) against the JAX reference.

Same configs, seeds and build inputs (numpy) go to both packages, at the
earlier slices' test shapes (the ``_build`` functions of
``test_torch_faults``, ``test_torch_attacks``, ``test_torch_surface`` and
``test_torch_paired``; 900 to 1,024 peers, 30 ticks):

- the knob module: ``split_knob_overrides``, ``make_sim_knobs``,
  ``knob_values`` and the ordering checks raise the reference's error
  types and messages (every static field, an unknown knob, each ordering
  violation with the PX ceiling, one surface only, the fault knob's three
  misuses); the delay knobs without a DelayConfig raise the reference's
  error (with one: ``test_torch_delays.py``);
- each knob field alone moves the trajectory within the 30 ticks
  (``gossip_retransmission`` has no consumer without the IWANT flood, and
  is shown to move nothing);
- arming a built sim (``knob_sweep.arm``) equals building it with
  ``sim_knobs``; ``convert`` carries the knob leaves; the knob step adds no
  host sync.

Knobs at the config's own values are in ``test_torch_knobs_defaults.py``,
non-default points against the reference's XLA step in
``test_torch_knobs_points.py``, the same under fault schedules (the fault
knob too) in ``test_torch_knobs_faults.py``, and B1's plain version with
knobs against the Pallas kernel ``with_knobs`` (interpret mode) in
``test_torch_knobs_kernel.py``; they share this module's families and
helpers.

Tolerance: exact (packed words and integer counters bitwise, f32/bf16
leaves by bit pattern; frames as ``test_torch_telemetry`` compares them).
"""

import numpy as np
import pytest
import torch

import test_torch_attacks as attacks
import test_torch_faults as tfaults
import test_torch_paired as paired
import test_torch_surface as surface
from go_libp2p_pubsub_tpu_torch import convert, knob_sweep
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import knobs as pkn
from test_torch_gossipsub import _assert_tree_equal
from test_torch_receive import _np
from test_torch_telemetry import assert_frames_equal
from torch_ref import imported_reference, tree_to_numpy


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These tests step small sims (about a thousand peers) on the CPU,
    where PyTorch's intra-op threads cost more than they give, and many
    under parallel test workers: one thread, restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.faults as rfl
        import go_libp2p_pubsub_tpu.models.knobs as rkn
        import go_libp2p_pubsub_tpu.models.tournament as rtn
        r.faults, r.knobs, r.tournament = rfl, rkn, rtn
        yield r


# -- the families ------------------------------------------------------------

#: the full variant's options and paired topics without the IWANT flood
#: (a SimKnobs point on a flood config is refused, as in the reference)
FULL = dict(n=928, m=12, px=7, direct=True, exact_k=True, shared_ip=True,
            sybil=0.15, invalid=0.25,
            sc=dict(flood_publish=True, sybil_ihave_spam=True,
                    topic_score_cap=25.0))
PAIRED = dict(sybil_frac=0.15, invalid_frac=0.25, px=7, direct=True,
              shared_ip=True, sc=dict(sybil_ihave_spam=True,
                                      flood_publish=True))

#: the step families: (builder module, its case name or own case dict,
#: px_candidates)
FAMILIES = {
    "scored": (tfaults, "scored", None),
    "unscored": (tfaults, "unscored", None),
    "ihave_spam": (attacks, "ihave_spam", None),
    "graft_flood": (attacks, "graft_flood", None),
    "promise_breakers": (attacks, "promise_breakers", None),
    "eclipse": (attacks, "eclipse", None),
    "full": (surface, FULL, 7),
    "paired": (paired, PAIRED, 7),
    "paired_unscored": (paired, "unscored", None),
}
#: the IWANT flood (both spams): knobs ride the legacy score_knobs surface
IWANT_FLOOD = (attacks, "both_spam", None)

#: the reference's non-default point (tests/test_knobs.py
#: test_kernel_knob_parity_non_defaults), on the C = 8 shapes (Dlo 2, D 3,
#: Dhi 6)
REF_POINT = {"d": 4, "d_hi": 5, "gossip_factor": 0.5, "backoff_ticks": 5,
             "d_lazy": 3, "graylist_threshold": -60.0,
             "behaviour_penalty_weight": -20.0}
#: a degree-family point on the C = 16 shapes (Dlo 5, D 6, Dhi 12)
C16_POINT = {"d": 8, "d_lo": 6, "d_hi": 12, "d_score": 5, "d_out": 3,
             "d_lazy": 4, "gossip_factor": 0.4, "backoff_ticks": 6,
             "fanout_ttl_ticks": 5, "graylist_threshold": -60.0,
             "behaviour_penalty_weight": -40.0}
SCORE_FIELDS = set(pgs.SCORE_KNOB_FIELDS)


def family_point(cfg, scored: bool) -> dict:
    """The family's non-default point: the reference's on the C = 8
    shapes, the degree-family one on C = 16 (defense fields scored
    only)."""
    point = REF_POINT if cfg.n_candidates == 8 else C16_POINT
    return {k: v for k, v in point.items()
            if scored or k not in SCORE_FIELDS}


def build_plain(ref, family):
    """Both packages' sims of a family, built without knobs."""
    mod, case, _ = family
    if isinstance(case, str):
        return (mod._build(ref, case, faults=False) if mod is tfaults
                else mod._build(ref, case))
    if mod is surface:
        offsets, t, args, kw, sc_kw, cfg_kw = surface._inputs(ref, case)
        cfg_kw = dict(cfg_kw, offsets=offsets, n_topics=t)
        seed = 3
    else:
        cfg_kw, args, kw, sc_kw = paired._inputs(ref, case, 10)
        seed = 2
    cfg_r = ref.gs.GossipSimConfig(**cfg_kw)
    cfg_p = pgs.GossipSimConfig(**cfg_kw)
    sc_r = ref.gs.ScoreSimConfig(**sc_kw)
    sc_p = pgs.ScoreSimConfig(**sc_kw)
    ref_sim = ref.gs.make_gossip_sim(cfg_r, *args, seed=seed, score_cfg=sc_r,
                                     **kw)
    port_sim = pgs.make_gossip_sim(cfg_p, *args, seed=seed, score_cfg=sc_p,
                                   device="cpu", **kw)
    return (cfg_r, sc_r, *ref_sim), (cfg_p, sc_p, *port_sim)


def arm_ref(ref, sim, *, sim_knobs=None, score_knobs=None, px=None):
    """The reference's sim armed as its make_gossip_sim arms it: the knob
    leaf (``drop_prob``: the faults leaf) and tick 0's gates recomputed."""
    import jax
    import jax.numpy as jnp

    cfg, sc, p, s = sim
    if score_knobs is not None:
        p = p.replace(score_knobs=ref.gs.ScoreKnobs(**{
            f: jnp.float32(score_knobs.get(f, getattr(sc, f)))
            for f in ref.gs.SCORE_KNOB_FIELDS}))
    if sim_knobs is not None:
        proto, score, fault, _ = ref.knobs.split_knob_overrides(sim_knobs)
        p = p.replace(sim_knobs=ref.knobs.make_sim_knobs(
            cfg, sc, {**proto, **score}, px_candidates=px))
        if fault:
            p = p.replace(faults=p.faults.replace(
                drop_prob=jnp.float32(fault["drop_prob"])))
    s = s.replace(gates=ref.gs.compute_gates(
        cfg, sc, p, s, jax.random.key_data(s.key)[-1]))
    return cfg, sc, p, s


def arm_port(sim, *, sim_knobs=None, score_knobs=None, px=None):
    cfg, sc, p, s = sim
    p = pgs.knob_params(cfg, sc, p, sim_knobs=sim_knobs,
                        score_knobs=score_knobs, px_candidates=px)
    return cfg, sc, p, pgs.refresh_gates(cfg, sc, p, s)


def run_port(sim, ticks=30, telemetry=None):
    """The port's step ``ticks`` times: each tick's state as numpy, its
    delivered words and (with telemetry) frame."""
    cfg, sc, p, s = sim
    step = pgs.make_gossip_step(cfg, sc, device="cpu", telemetry=telemetry)
    out = []
    for _ in range(ticks):
        s, d, *fr = step(p, s)
        out.append((convert.state_to_numpy(s), d,
                    convert.frame_to_numpy(fr[0]) if fr else None))
    return out


def assert_runs_equal(a, b, where):
    for t, ((sa, da, fa), (sb, db, fb)) in enumerate(zip(a, b)):
        _assert_tree_equal(sa, sb, f"{where} tick {t}")
        assert torch.equal(da, db), f"{where} tick {t}"
        if fa is not None:
            assert_frames_equal(fa, fb, f"{where} tick {t}")


def runs_differ(a, b) -> bool:
    """Some tick's mesh, possession, backoff, gates or scores differ."""
    for (sa, _, _), (sb, _, _) in zip(a, b):
        for name in ("mesh", "have", "backoff", "fanout", "mesh_b",
                     "backoff_b"):
            if sa[name] is not None and not np.array_equal(sa[name],
                                                           sb[name]):
                return True
        if any(not np.array_equal(x, y)
               for x, y in zip(sa["gates"], sb["gates"])):
            return True
        if sa["scores"] is not None and any(
                v is not None and not np.array_equal(v, sb["scores"][k])
                for k, v in sa["scores"].items()):
            return True
    return False


def run_pair(ref, ref_sim, port_sim, ticks=30):
    """Step both packages, every state leaf and the delivered words equal
    on every tick; the port's run."""
    import jax

    cfg_r, sc_r, p_r, s_r = ref_sim
    _assert_tree_equal(tree_to_numpy(p_r),
                       convert.params_to_numpy(port_sim[2]), "params")
    _assert_tree_equal(tree_to_numpy(s_r),
                       convert.state_to_numpy(port_sim[3]), "state")
    step_r = jax.jit(ref.gs.make_gossip_step(cfg_r, sc_r))
    run = run_port(port_sim, ticks)
    for t, (s_np, d_p, _) in enumerate(run):
        s_r, d_r = step_r(p_r, s_r)
        _assert_tree_equal(tree_to_numpy(s_r), s_np, f"tick {t}")
        np.testing.assert_array_equal(_np(d_p), np.asarray(d_r),
                                      err_msg=f"tick {t}")
    return run


# -- the knob module ---------------------------------------------------------

def _both_raise(ref, fn_ref, fn_port, exc=ValueError, exc_port=None):
    """Both calls raise (``exc``; the port's ``exc_port`` where given); the
    same message."""
    msgs = []
    for fn, e in ((fn_ref, exc), (fn_port, exc_port or exc)):
        with pytest.raises(e) as err:
            fn()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    return msgs[0]


def _cfgs(ref, c=8, **kw):
    offsets = ref.gs.make_gossip_offsets(4, c, 256, seed=1)
    cfg_kw = dict(offsets=offsets, n_topics=4,
                  **(tfaults.SMALL if c == 8 else {}), **kw)
    return ref.gs.GossipSimConfig(**cfg_kw), pgs.GossipSimConfig(**cfg_kw)


def test_knob_tables_match_reference(ref):
    assert pkn.SIM_KNOB_FIELDS == ref.knobs.SIM_KNOB_FIELDS
    assert pkn.FAULT_KNOB_FIELDS == ref.knobs.FAULT_KNOB_FIELDS
    assert pkn.DELAY_KNOB_FIELDS == ref.knobs.DELAY_KNOB_FIELDS
    assert pkn.STATIC_KNOB_REASONS == ref.knobs.STATIC_KNOB_REASONS
    assert pgs.SCORE_KNOB_FIELDS == ref.gs.SCORE_KNOB_FIELDS


@pytest.mark.parametrize("field", sorted(pkn.STATIC_KNOB_REASONS))
def test_static_fields_are_rejected_by_name(ref, field):
    cfg_r, cfg_p = _cfgs(ref)
    msg = _both_raise(
        ref, lambda: ref.knobs.split_knob_overrides({field: 1}),
        lambda: pkn.split_knob_overrides({field: 1}),
        ref.knobs.KnobStaticFieldError, pkn.KnobStaticFieldError)
    assert repr(field) in msg
    with pytest.raises(pkn.KnobStaticFieldError, match=field):
        pkn.make_sim_knobs(cfg_p, None, {field: 1}, device="cpu")


def test_split_and_values_match_reference(ref):
    point = dict(REF_POINT, drop_prob=0.1, delay_base=2, d_score=1)
    got = pkn.split_knob_overrides(point)
    assert got == ref.knobs.split_knob_overrides(point)
    cfg_r, cfg_p = _cfgs(ref)
    assert pkn.knob_values(cfg_p, got[0]) == ref.knobs.knob_values(
        cfg_r, got[0])
    msg = _both_raise(ref, lambda: ref.knobs.split_knob_overrides({"x": 1}),
                      lambda: pkn.split_knob_overrides({"x": 1}))
    for f in pkn.SIM_KNOB_FIELDS + pgs.SCORE_KNOB_FIELDS:
        assert repr(f) in msg


@pytest.mark.parametrize("sc_on", [False, True])
def test_make_sim_knobs_leaves_match_reference(ref, sc_on):
    cfg_r, cfg_p = _cfgs(ref)
    point = {k: v for k, v in REF_POINT.items()
             if sc_on or k not in SCORE_FIELDS}
    want = ref.knobs.make_sim_knobs(
        cfg_r, ref.gs.ScoreSimConfig() if sc_on else None, point)
    got = pkn.make_sim_knobs(cfg_p, pgs.ScoreSimConfig() if sc_on else None,
                             point, device="cpu")
    _assert_tree_equal(tree_to_numpy(want), convert.sim_knobs_to_numpy(got),
                       "sim_knobs")
    assert (got.score is None) == (not sc_on)


#: ordering violations: (overrides, px_candidates, score config on)
ORDERING = {
    "d_lo_above_d": ({"d_lo": 4}, None, False),
    "d_above_d_hi": ({"d": 7}, None, False),
    "d_score_above_d": ({"d_score": 4}, None, False),
    "d_out_at_d_lo": ({"d_out": 2}, None, False),
    "d_out_above_half_d": ({"d": 4, "d_lo": 4, "d_out": 3}, None, False),
    "d_hi_at_c": ({"d_hi": 8}, None, False),
    "d_hi_at_px": ({"d_hi": 7}, 7, False),
    "backoff_zero": ({"backoff_ticks": 0}, None, False),
    "backoff_int16": ({"backoff_ticks": 40000}, None, False),
    "retransmission": ({"gossip_retransmission": 0}, None, False),
    "fanout_ttl": ({"fanout_ttl_ticks": 0}, None, False),
    "d_lazy": ({"d_lazy": -1}, None, False),
    "gossip_factor": ({"gossip_factor": 1.5}, None, False),
    "p4_weight_sign": ({"invalid_message_deliveries_weight": 1.0}, None,
                       True),
    "p7_weight_sign": ({"behaviour_penalty_weight": 0.5}, None, True),
    "thresholds": ({"gossip_threshold": -60.0}, None, True),
    "gossip_threshold_sign": ({"gossip_threshold": 1.0}, None, True),
    "score_knobs_need_sc": ({"graylist_threshold": -90.0}, None, False),
}


@pytest.mark.parametrize("name", sorted(ORDERING))
def test_ordering_violations_match_reference(ref, name):
    over, px, sc_on = ORDERING[name]
    cfg_r, cfg_p = _cfgs(ref)
    msg = _both_raise(
        ref, lambda: ref.knobs.make_sim_knobs(
            cfg_r, ref.gs.ScoreSimConfig() if sc_on else None, over,
            px_candidates=px),
        lambda: pkn.make_sim_knobs(
            cfg_p, pgs.ScoreSimConfig() if sc_on else None, over,
            px_candidates=px, device="cpu"))
    assert msg.startswith("sim_knobs: ")


def test_px_ceiling_on_the_everything_on_configuration(ref):
    """``everything.py``'s configuration (C = 16, PX over 14): d_hi 14
    meets the PX ceiling; both packages name px_candidates."""
    from go_libp2p_pubsub_tpu_torch import everything

    offsets = ref.gs.make_gossip_offsets(100, 16, 100_000, seed=0)
    kw = dict(offsets=offsets, n_topics=100)
    msg = _both_raise(
        ref, lambda: ref.knobs.make_sim_knobs(
            ref.gs.GossipSimConfig(**kw), ref.gs.ScoreSimConfig(),
            {"d_hi": everything.PX_CANDIDATES},
            px_candidates=everything.PX_CANDIDATES),
        lambda: pkn.make_sim_knobs(
            pgs.GossipSimConfig(**kw), pgs.ScoreSimConfig(),
            {"d_hi": everything.PX_CANDIDATES},
            px_candidates=everything.PX_CANDIDATES, device="cpu"))
    assert "px_candidates=14" in msg


def _sim_inputs(n=256, t=4, m=8, seed=0):
    rng = np.random.default_rng(seed)
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    topic = rng.integers(0, t, m)
    origin = rng.integers(0, n // t, m) * t + topic
    ticks = np.sort(rng.integers(0, 10, m)).astype(np.int32)
    return subs, topic, origin, ticks


#: make_gossip_sim's knob misuses: (kwargs, the schedule's drop_prob or
#: None for no schedule)
MISUSE = {
    "one_surface": (dict(sim_knobs={}, score_knobs={"gossip_threshold":
                                                    -5.0}), None),
    "score_knobs_unknown": (dict(score_knobs={"d": 3}), None),
    "score_knobs_sign": (dict(score_knobs={"behaviour_penalty_weight":
                                           1.0}), None),
    "drop_prob_no_schedule": (dict(sim_knobs={"drop_prob": 0.1}), None),
    "drop_prob_per_edge": (dict(sim_knobs={"drop_prob": 0.1}), "per_edge"),
    "drop_prob_zero_schedule": (dict(sim_knobs={"drop_prob": 0.1}), 0.0),
    "drop_prob_range": (dict(sim_knobs={"drop_prob": 1.5}), 0.05),
}


@pytest.mark.parametrize("name", sorted(MISUSE))
def test_make_gossip_sim_misuse_matches_reference(ref, name):
    kw, drop = MISUSE[name]
    n = 256
    cfg_r, cfg_p = _cfgs(ref)
    args = _sim_inputs(n)
    f_r = f_p = None
    if drop is not None:
        if drop == "per_edge":
            drop = np.full((8, n), 0.05, dtype=np.float32)
        sk = dict(n_peers=n, horizon=20, drop_prob=drop, seed=1)
        f_r, f_p = tfaults._schedules(ref, **sk)
    _both_raise(
        ref, lambda: ref.gs.make_gossip_sim(
            cfg_r, *args, score_cfg=ref.gs.ScoreSimConfig(),
            fault_schedule=f_r, **kw),
        lambda: pgs.make_gossip_sim(
            cfg_p, *args, score_cfg=pgs.ScoreSimConfig(),
            fault_schedule=f_p, device="cpu", **kw))


def test_delay_knobs_keep_the_delays_refusal(ref):
    """The delay knobs without a DelayConfig: the reference's ValueError
    and message (the port's ``delays`` refusal of the knobs is gone with
    the delays port)."""
    cfg_r, cfg_p = _cfgs(ref)
    args = _sim_inputs()
    for point in ({"delay_base": 2}, {"delay_jitter": 1, "d": 3}):
        msg = _both_raise(
            ref, lambda: ref.gs.make_gossip_sim(cfg_r, *args,
                                                sim_knobs=point),
            lambda: pgs.make_gossip_sim(cfg_p, *args, sim_knobs=point,
                                        device="cpu"))
        assert "DelayConfig" in msg


#: each knob field alone, on a family where its consumer is live within
#: the 30 ticks (C = 16, Dlo 5, D 6, Dhi 12, Dscore 4, Dout 2, Dlazy 6):
#: the IHAVE spam for the degree, gossip and tick knobs; the graft flood,
#: whose over-full meshes prune, for Dout, Dscore and the graylist; the
#: shared-IP gater case (invalid spam from its sybil origins; C = 16 at
#: D 3) for the P4 weight
FIELD_POINTS = {
    "d": ("ihave_spam", 9), "d_lo": ("ihave_spam", 6),
    "d_hi": ("ihave_spam", 7), "d_lazy": ("ihave_spam", 1),
    "gossip_factor": ("ihave_spam", 1.0),
    "backoff_ticks": ("ihave_spam", 3),
    "fanout_ttl_ticks": ("ihave_spam", 1),
    "gossip_retransmission": ("ihave_spam", 1),
    "behaviour_penalty_weight": ("ihave_spam", -200.0),
    "gossip_threshold": ("ihave_spam", -0.5),
    "d_score": ("graft_flood", 1), "d_out": ("graft_flood", 0),
    "graylist_threshold": ("graft_flood", -55.0),
    "invalid_message_deliveries_weight": ("gater", -200.0),
}
GATER = (surface, "shared_ip_gater", None)


#: each family's baked run, shared by its fields' tests
_BASE_RUNS = {}


@pytest.mark.parametrize("field", sorted(FIELD_POINTS))
def test_each_knob_field_moves_the_trajectory(ref, field):
    name, value = FIELD_POINTS[field]
    _, port = build_plain(ref, GATER if name == "gater" else FAMILIES[name])
    if name not in _BASE_RUNS:
        _BASE_RUNS[name] = run_port(port)
    armed = arm_port(port, sim_knobs={field: value})
    moved = runs_differ(run_port(armed), _BASE_RUNS[name])
    # gossip_retransmission's only consumer is the IWANT flood's serve
    # budget, and a knob point on a flood config is refused
    assert moved == (field != "gossip_retransmission"), field


# -- arming, conversion, host syncs ------------------------------------------

@pytest.mark.parametrize("kind", sorted(knob_sweep.SWEEPS))
def test_arming_equals_building_with_the_point(kind):
    """``knob_sweep.arm`` on a sim built without knobs gives the params and
    state its builder makes with ``sim_knobs=point``, every point."""
    builder, points, _ = knob_sweep.SWEEPS[kind]
    kw = dict(n_peers=2_000)
    base = builder("cpu", **kw)
    for name, point in points.items():
        if point is None:
            continue
        armed = knob_sweep.arm(base, point)
        built = builder("cpu", sim_knobs=point, **kw)
        assert armed[2].sim_knobs is not None
        _assert_tree_equal(convert.params_to_numpy(built[2]),
                           convert.params_to_numpy(armed[2]), name)
        _assert_tree_equal(convert.state_to_numpy(built[3]),
                           convert.state_to_numpy(armed[3]), name)


@pytest.mark.parametrize("surface_kw", ["sim_knobs", "score_knobs",
                                        "drop_prob"])
def test_convert_carries_the_knob_leaves(ref, surface_kw):
    point = {"sim_knobs": REF_POINT,
             "score_knobs": {"gossip_threshold": -5.0},
             "drop_prob": {"drop_prob": 0.03, "d": 4, "d_hi": 5}}[surface_kw]
    kw = {"score_knobs" if surface_kw == "score_knobs" else "sim_knobs":
          point}
    n = 256
    cfg_r, cfg_p = _cfgs(ref)
    args = _sim_inputs(n)
    f_r, f_p = tfaults._schedules(ref, n_peers=n, horizon=20,
                                  drop_prob=0.05, seed=1)
    p_r, _ = ref.gs.make_gossip_sim(cfg_r, *args,
                                    score_cfg=ref.gs.ScoreSimConfig(),
                                    fault_schedule=f_r, **kw)
    p_p, _ = pgs.make_gossip_sim(cfg_p, *args, score_cfg=pgs.ScoreSimConfig(),
                                 fault_schedule=f_p, device="cpu", **kw)
    p_np = tree_to_numpy(p_r)
    _assert_tree_equal(p_np, convert.params_to_numpy(p_p), "params")
    p2 = convert.params_from_numpy(p_np, "cpu")
    _assert_tree_equal(p_np, convert.params_to_numpy(p2), "params")
    if surface_kw == "drop_prob":
        assert float(p2.faults.drop_prob) == float(np.float32(0.03))
    held = p2.score_knobs if surface_kw == "score_knobs" else p2.sim_knobs
    assert held is not None


class _SyncCounter:
    """Counts the host reads of tensor values: ``item``, ``tolist``,
    ``bool``/``int``/``float``/index conversions and ``nonzero``."""

    NAMES = ("item", "tolist", "__bool__", "__int__", "__float__",
             "__index__", "nonzero")

    def __init__(self, monkeypatch):
        self.count = 0
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._wrap(orig))
        monkeypatch.setattr(torch, "nonzero", self._wrap(torch.nonzero))

    def _wrap(self, fn):
        def counted(*a, **kw):
            self.count += 1
            return fn(*a, **kw)
        return counted


@pytest.mark.parametrize("name", ["scored", "unscored", "paired"])
def test_the_knob_step_adds_no_host_sync(ref, name, monkeypatch):
    """One step with knobs reads tensor values on the host as often as
    without: once per topic slot scored (the prune's ``nonzero``), never
    unscored."""
    family = FAMILIES[name]
    _, port = build_plain(ref, family)
    point = family_point(port[0], port[1] is not None)
    armed = arm_port(port, sim_knobs=point, px=family[2])
    counts = []
    for cfg, sc, p, s in (port, armed):
        step = pgs.make_gossip_step(cfg, sc, device="cpu")
        s = step(p, s)[0]              # build-time work out of the count
        counter = _SyncCounter(monkeypatch)
        step(p, s)
        counts.append(counter.count)
        monkeypatch.undo()
    slots = 2 if port[0].paired_topics else 1
    assert counts[0] == counts[1] == (slots if port[1] is not None else 0)
