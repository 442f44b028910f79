"""The port's delayed step against the JAX reference's XLA step.

Each case's sims are built by the earlier slices' test builders
(``test_torch_faults``, ``test_torch_attacks``, ``test_torch_surface``:
900 to 1,024 peers) with ``delays=DelayConfig(3, 2, 8)`` added to both
packages' ``make_gossip_sim`` (``delayed``), and stepped 30 ticks; every
state leaf (the delay lines too), the delivered words and, with
telemetry, every frame field equal on every tick:

- scored, unscored, IHAVE spam (four ctrl rows), promise breakers, graft
  flood, eclipse, the full variant's options (flood publishing, exact-k,
  PX, the shared-IP gater, direct peers, the IHAVE spam), a fault schedule
  (churn, link loss and a partition; with cold restart; with per-direction
  drops), ``delays_counters`` telemetry (every group; the counters read at
  arrival from the observer lines) and the latency histogram alone,
  unscored; each shown non-vacuous (the lines carried traffic and
  retractions rode them, and the run departs from the one-hop run);
- ``DelayConfig(1, 0, 1)`` equal to the step without delays on every leaf
  both carry, scored and unscored;
- scored with opportunistic grafting every 7 ticks for 60 ticks, shown
  non-vacuous against the same sim grafting every 60 ticks.

Tolerance: exact (packed words and integer counters bitwise, f32/bf16
leaves by bit pattern; frames as ``test_torch_telemetry`` compares them).
"""

import contextlib
import functools

import numpy as np
import pytest

import test_torch_attacks as attacks
import test_torch_faults as tfaults
import test_torch_surface as surface
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import delays as pdl
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import telemetry as ptl
from test_torch_gossipsub import _assert_tree_equal
from test_torch_knobs import FULL, one_thread  # noqa: F401  (autouse)
from test_torch_receive import _np
from test_torch_telemetry import assert_frames_equal
from torch_ref import imported_reference, tree_to_numpy

DELAYS = dict(base=3, jitter=2, k_slots=8)


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.delays as rdl
        import go_libp2p_pubsub_tpu.models.faults as rfl
        import go_libp2p_pubsub_tpu.models.telemetry as rtl
        r.delays, r.faults, r.telemetry = rdl, rfl, rtl
        yield r


@contextlib.contextmanager
def delayed(ref, dkw=None, **extra):
    """Both packages' ``make_gossip_sim`` with ``delays`` (and ``extra``
    keywords) added, for the builders of the earlier slices' tests."""
    real_r, real_p = ref.gs.make_gossip_sim, pgs.make_gossip_sim
    if dkw is not None:
        extra = dict(extra, delays=ref.delays.DelayConfig(**dkw))
        extra_p = dict(extra, delays=pdl.DelayConfig(**dkw))
    else:
        extra_p = dict(extra)
    ref.gs.make_gossip_sim = functools.partial(real_r, **extra)
    pgs.make_gossip_sim = functools.partial(real_p, **extra_p)
    try:
        yield
    finally:
        ref.gs.make_gossip_sim, pgs.make_gossip_sim = real_r, real_p


def _full(ref):
    offsets, t, args, kw, sc_kw, cfg_kw = surface._inputs(ref, FULL)
    cfg_kw = dict(cfg_kw, offsets=offsets, n_topics=t)
    sims = []
    for gs_ in (ref.gs, pgs):
        cfg = gs_.GossipSimConfig(**cfg_kw)
        sc = gs_.ScoreSimConfig(**sc_kw)
        extra = {} if gs_ is ref.gs else dict(device="cpu")
        sims.append((cfg, sc, *gs_.make_gossip_sim(cfg, *args, seed=3,
                                                   score_cfg=sc, **kw,
                                                   **extra)))
    return tuple(sims)


#: the cases: (builder of both packages' sims, telemetry keywords or None)
CASES = {
    "scored": (lambda ref: tfaults._build(ref, "scored", faults=False), None),
    "unscored": (lambda ref: tfaults._build(ref, "unscored", faults=False),
                 None),
    "ihave_spam": (lambda ref: attacks._build(ref, "ihave_spam"), None),
    "promise_breakers": (lambda ref: attacks._build(ref, "promise_breakers"),
                         None),
    "graft_flood": (lambda ref: attacks._build(ref, "graft_flood"), None),
    "eclipse": (lambda ref: attacks._build(ref, "eclipse"), None),
    "full": (_full, None),
    "faults": (lambda ref: tfaults._build(ref, "scored"), None),
    "faults_cold_restart": (lambda ref: tfaults._build(ref, "cold_restart"),
                            None),
    "faults_directed": (lambda ref: tfaults._build(ref, "directed"), None),
    "counters": (lambda ref: tfaults._build(ref, "scored", faults=False),
                 dict(latency_hist=True, degree_hist=True, score_hist=True,
                      latency_buckets=16)),
    "counters_faults": (lambda ref: tfaults._build(ref, "scored"),
                        dict(latency_hist=True, latency_buckets=16)),
    "latency_unscored": (lambda ref: tfaults._build(ref, "unscored",
                                                    faults=False),
                         dict(counters=False, wire=False, latency_hist=True,
                              latency_buckets=16)),
}


def _run(ref, ref_sim, port_sim, tel_kw=None, ticks=30, check=True):
    """Step both packages ``ticks`` heartbeats, asserting every state leaf,
    the delivered words and the frames equal on every tick (``check``
    False: the port alone); the port's states as numpy."""
    import jax

    cfg_p, sc_p, p_p, s_p = port_sim
    tcfg_p = None if tel_kw is None else ptl.TelemetryConfig(**tel_kw)
    if check:
        cfg_r, sc_r, p_r, s_r = ref_sim
        tcfg_r = (None if tel_kw is None
                  else ref.telemetry.TelemetryConfig(**tel_kw))
        _assert_tree_equal(tree_to_numpy(p_r), convert.params_to_numpy(p_p),
                           "params")
        step_r = jax.jit(ref.gs.make_gossip_step(cfg_r, sc_r,
                                                 telemetry=tcfg_r))
    step_p = pgs.make_gossip_step(cfg_p, sc_p, device="cpu",
                                  telemetry=tcfg_p)
    states = []
    for t in range(ticks):
        s_p, d_p, *f_p = step_p(p_p, s_p)
        s_np = convert.state_to_numpy(s_p)
        states.append(s_np)
        if not check:
            continue
        s_r, d_r, *f_r = step_r(p_r, s_r)
        _assert_tree_equal(tree_to_numpy(s_r), s_np, f"tick {t}")
        np.testing.assert_array_equal(_np(d_p), np.asarray(d_r),
                                      err_msg=f"tick {t}")
        if f_p:
            assert_frames_equal(convert.frame_to_numpy(f_p[0]),
                                tree_to_numpy(f_r[0]), f"tick {t}")
    return states


@pytest.mark.parametrize("name", sorted(CASES))
def test_delayed_step_matches_reference(ref, name):
    build, tel_kw = CASES[name]
    counters = tel_kw is not None and tel_kw.get("counters", True)
    with delayed(ref, DELAYS, **({"delays_counters": True}
                                 if counters else {})):
        ref_sim, port_sim = build(ref)
    run = _run(ref, ref_sim, port_sim, tel_kw)
    # non-vacuous: payload and control rode the lines, retractions too,
    # and the trajectory departs from the one-hop run
    assert any(s["pay_line"].any() for s in run)
    assert any(s["ctrl_line"][:, 0].any() for s in run)
    if name != "eclipse":
        # (the eclipse run rejects no GRAFT over an edge drawn past 1)
        assert any(s["ctrl_line"][:, 2].any() for s in run)
    if name in ("ihave_spam", "promise_breakers"):
        assert any(s["ctrl_line"][:, 3].any() for s in run)
    plain = _run(ref, None, build(ref)[1], check=False)
    assert any(not np.array_equal(a["have"], b["have"])
               or not np.array_equal(a["mesh"], b["mesh"])
               for a, b in zip(run, plain))


@pytest.mark.parametrize("name", ["scored", "unscored"])
def test_one_slot_one_hop_equals_the_step_without_delays(ref, name):
    """DelayConfig(1, 0, 1): every leaf both runs carry equal, every tick
    (the reference's own pin, on the port)."""
    build = CASES[name][0]
    with delayed(ref, dict(base=1, jitter=0, k_slots=1)):
        _, delayed_sim = build(ref)
    _, plain_sim = build(ref)
    a = _run(ref, None, delayed_sim, check=False)
    b = _run(ref, None, plain_sim, check=False)
    for t, (sa, sb) in enumerate(zip(a, b)):
        assert not sa["pay_line"].any()
        _assert_tree_equal(sb, sa, f"tick {t}")


#: opportunistic grafting every 7 ticks, its threshold above the median
#: scores the delayed meshes reach, so it selects
OG = dict(opportunistic_graft_ticks=7, opportunistic_graft_threshold=5.0)


def test_delayed_opportunistic_graft_matches_reference_60_ticks(
        ref, monkeypatch):
    """The scored delayed step with opportunistic grafting every 7 ticks
    against the reference's XLA step for 60 ticks, every leaf every tick;
    not vacuous: against the same delayed sim grafting every 60 ticks (at
    tick 0 only) the mesh is equal through tick 6 and departs from tick 7
    on."""
    runs = {}
    for every in (7, 60):
        monkeypatch.setitem(tfaults.STEP, "og", dict(
            sc=dict(OG, opportunistic_graft_ticks=every)))
        with delayed(ref, DELAYS):
            ref_sim, port_sim = tfaults._build(ref, "og", faults=False)
        runs[every] = _run(ref, ref_sim, port_sim, ticks=60,
                           check=every == 7)
    differs = [not np.array_equal(a["mesh"], b["mesh"])
               for a, b in zip(runs[7], runs[60])]
    assert not any(differs[:7]) and any(differs[7:])
