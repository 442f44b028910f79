"""The port's event-driven delays (``models/delays.py``, the delay lines in
the sim, the delay knobs) against the JAX reference, and its refusals.

Same configs, seeds and build inputs (numpy) go to both packages:

- ``DelayConfig`` and ``validate_point``: the reference's error types and
  messages, the bad field named;
- ``edge_delays``, ``slot_select_words`` and ``line_dequeue`` against the
  reference's on the same seeded inputs, bit-identical; K = 1 passes
  through; ``enqueue_dequeue`` equals the reference's enqueue then
  dequeue; the pair transfer of all-open gates equals the reference's
  shortcut word (the step computes it without a branch);
- ``compile_delays`` and the built lines leaf for leaf, ``convert`` both
  ways; the delay knobs armed on built params (``knob_params``,
  ``pipelined.arm``) equal the sim built with them, and the reference's;
- each named refusal and the reference's errors: paired topics (build and
  step), the IWANT flood on the kernel step, the fused window
  (``fused_delays``, with the lines' byte count), ``delays_split``
  (``delays_probe`` builds the probe line), the ``delays_*`` flags and the
  delay knobs without a DelayConfig, params without lines, telemetry
  counters without the observer lines;
- a delayed step reads tensor values on the host as often as one without
  (once per tick scored, never unscored);
- the pipelined benchmark's rows and gates at 3,000 peers on the CPU.

The stepped trajectories against the reference's XLA step are in
``test_torch_delays_steps.py``, the plain delayed B1 against the Pallas
kernel in ``test_torch_delays_kernel.py``.

Tolerance: exact (integer words and delays bitwise).
"""

import dataclasses

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import convert, pipelined
from go_libp2p_pubsub_tpu_torch.models import delays as pdl
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import plan
from go_libp2p_pubsub_tpu_torch.models import telemetry as ptl
from test_torch_gossipsub import _assert_tree_equal
from test_torch_knobs import (  # noqa: F401  (one_thread: autouse)
    _SyncCounter,
    _both_raise,
    _cfgs,
    _sim_inputs,
    one_thread,
)
from torch_ref import imported_reference, tree_to_numpy


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.delays as rdl
        import go_libp2p_pubsub_tpu.models.faults as rfl
        import go_libp2p_pubsub_tpu.models.plan as rpl
        r.delays, r.faults, r.plan = rdl, rfl, rpl
        yield r


# -- the module ---------------------------------------------------------------

#: DelayConfig arguments each package refuses, and a valid one
BAD_CONFIGS = [dict(base=0), dict(jitter=-1), dict(k_slots=0),
               dict(base=3, jitter=2, k_slots=4)]
BAD_POINTS = [dict(base=0), dict(jitter=-2), dict(base=5, jitter=4)]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=str)
def test_delay_config_validation_matches_reference(ref, kw):
    msg = _both_raise(ref, lambda: ref.delays.DelayConfig(**kw),
                      lambda: pdl.DelayConfig(**kw))
    assert next(iter(kw)) in msg or "k_slots" in msg


@pytest.mark.parametrize("kw", BAD_POINTS, ids=str)
def test_validate_point_matches_reference(ref, kw):
    dc = dict(base=2, jitter=1, k_slots=8)
    msg = _both_raise(ref, lambda: ref.delays.DelayConfig(
        **dc).validate_point(**kw), lambda: pdl.DelayConfig(
        **dc).validate_point(**kw))
    assert "delay" in msg
    pdl.DelayConfig(**dc).validate_point(base=4, jitter=4)


DRAWS = [dict(base=1, jitter=0, k_slots=1), dict(base=3, jitter=2, k_slots=8),
         dict(base=1, jitter=7, k_slots=8, seed=0xDEADBEEF),
         dict(base=4, jitter=2, k_slots=8, seed=12345)]


@pytest.mark.parametrize("kw", DRAWS, ids=str)
def test_edge_delays_and_slots_match_reference(ref, kw):
    import jax.numpy as jnp

    dp_r = ref.delays.compile_delays(ref.delays.DelayConfig(**kw))
    dp_p = pdl.compile_delays(pdl.DelayConfig(**kw), "cpu")
    _assert_tree_equal(tree_to_numpy(dp_r), convert.delays_to_numpy(dp_p),
                       "delays")
    shape, stride = (16, 301), 300
    for tick in (0, 1, 17, 1 << 20):
        d_r = np.asarray(ref.delays.edge_delays(dp_r, shape, tick,
                                                stride=stride))
        d_p = pdl.edge_delays(dp_p, shape, tick, stride=stride)
        np.testing.assert_array_equal(d_p.numpy(), d_r)
        assert d_p.min() >= 1 and d_p.max() <= kw["k_slots"]
        if kw["jitter"]:
            assert len(np.unique(d_r)) > 1
        sel_r = ref.delays.slot_select_words(jnp.asarray(d_r), tick,
                                             kw["k_slots"])
        sel_p = pdl.slot_select_words(d_p, tick, kw["k_slots"])
        sel_all = pdl.slot_words((tick + d_p - 1) % kw["k_slots"],
                                 kw["k_slots"])
        for s, (s_r, s_p) in enumerate(zip(sel_r, sel_p)):
            np.testing.assert_array_equal(s_p.numpy().view(np.uint32),
                                          np.asarray(s_r))
            assert torch.equal(sel_all[s], s_p)
        now_r = ref.delays.arrive_now(dp_r, shape, tick, 2, stride=stride)
        np.testing.assert_array_equal(
            pdl.arrive_now(dp_p, shape, tick, 2, stride=stride).numpy(),
            np.asarray(now_r))


@pytest.mark.parametrize("k_slots", [1, 3, 8])
def test_line_dequeue_and_enqueue_match_reference(ref, k_slots):
    import jax.numpy as jnp

    rng = np.random.default_rng(k_slots)
    line = rng.integers(0, 1 << 32, size=(k_slots, 4, 2, 50),
                        dtype=np.uint64).astype(np.uint32)
    words = rng.integers(0, 1 << 32, size=(4, 2, 50),
                         dtype=np.uint64).astype(np.uint32)
    slot = rng.integers(0, k_slots, size=(4, 50))
    line_t = torch.from_numpy(line.view(np.int32))
    for tick in (0, 5, 13):
        arr_r, cl_r = ref.delays.line_dequeue(jnp.asarray(line), tick)
        arr_p, cl_p = pdl.line_dequeue(line_t, tick)
        np.testing.assert_array_equal(arr_p.numpy().view(np.uint32),
                                      np.asarray(arr_r))
        np.testing.assert_array_equal(cl_p.numpy().view(np.uint32),
                                      np.asarray(cl_r))
        # enqueue then dequeue, as the reference's step does it
        masks = [np.where(slot == s, 0xFFFFFFFF, 0).astype(np.uint32)
                 for s in range(k_slots)]
        full = line | np.stack([words & m[:, None, :] for m in masks])
        arr_r, cl_r = ref.delays.line_dequeue(jnp.asarray(full), tick)
        sel = torch.from_numpy(np.stack(masks).view(np.int32))
        w_t = torch.from_numpy(words.view(np.int32))
        arr_p, cl_p = pdl.enqueue_dequeue(
            line_t, lambda out: torch.bitwise_and(
                w_t[None], sel[:, :, None, :], out=out), tick)
        np.testing.assert_array_equal(arr_p.numpy().view(np.uint32),
                                      np.asarray(arr_r))
        np.testing.assert_array_equal(cl_p.numpy().view(np.uint32),
                                      np.asarray(cl_r))
    assert np.array_equal(line_t.numpy().view(np.uint32), line)  # unchanged
    if k_slots == 1:
        # K = 1: this tick's words come straight out, the line stays empty
        arr, nxt = pdl.enqueue_dequeue(
            torch.zeros_like(line_t),
            lambda out: out.copy_(torch.from_numpy(words.view(np.int32))),
            0)
        assert torch.equal(arr, torch.from_numpy(words.view(np.int32)))
        assert not nxt.any()


def test_transfer_bits_and_the_open_gate_word_match_reference(ref):
    """The port computes the gates' pair transfer every tick; where every
    gate is open the reference takes a shortcut word, which it equals."""
    import jax.numpy as jnp

    cfg_r, cfg_p = _cfgs(ref, c=16)
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 1 << 32, size=256, dtype=np.uint64).astype(
        np.uint32)
    for pair, mask in ((False, 0xFFFF), (True, 0xFFFFFFFF)):
        b = bits & np.uint32(mask)
        want = ref.gs.transfer_bits(jnp.asarray(b), cfg_r, pair=pair)
        got = pgs.transfer_bits(torch.from_numpy(b.view(np.int32)), cfg_p,
                                pair=pair)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))
    all_c = (1 << 16) - 1
    open_word = np.uint32(all_c | (all_c << 16)).view(np.int32)
    gates = torch.full((256,), int(open_word), dtype=torch.int32)
    assert torch.equal(pgs.transfer_bits(gates, cfg_p, pair=True), gates)


# -- the sim: build, conversion, knobs -----------------------------------------

SIMS = {"scored": dict(score=True), "unscored": dict(score=False),
        "counters": dict(score=True, counters=True),
        "breakers": dict(score=True, breakers=True)}


def _build_both(ref, name, dkw=None, **extra):
    case = SIMS[name]
    cfg_r, cfg_p = _cfgs(ref, c=16)
    args = _sim_inputs()
    kw = dict(extra)
    if case.get("breakers"):
        kw["promise_break"] = np.arange(256) % 7 == 0
    if case.get("counters"):
        kw["delays_counters"] = True
    dkw = dkw or dict(base=3, jitter=2, k_slots=8, seed=9)
    sc_r = ref.gs.ScoreSimConfig() if case["score"] else None
    sc_p = pgs.ScoreSimConfig() if case["score"] else None
    sim_r = ref.gs.make_gossip_sim(cfg_r, *args, score_cfg=sc_r,
                                   delays=ref.delays.DelayConfig(**dkw), **kw)
    sim_p = pgs.make_gossip_sim(cfg_p, *args, score_cfg=sc_p, device="cpu",
                                delays=pdl.DelayConfig(**dkw), **kw)
    return (cfg_r, sc_r, *sim_r), (cfg_p, sc_p, *sim_p)


@pytest.mark.parametrize("name", sorted(SIMS))
def test_delayed_sim_build_and_convert_match_reference(ref, name):
    (_, _, p_r, s_r), (_, _, p_p, s_p) = _build_both(ref, name)
    p_np, s_np = tree_to_numpy(p_r), tree_to_numpy(s_r)
    _assert_tree_equal(p_np, convert.params_to_numpy(p_p), "params")
    _assert_tree_equal(s_np, convert.state_to_numpy(s_p), "state")
    assert s_p.ctrl_line.shape[1] == (4 if name == "breakers" else 3)
    assert (s_p.gsp_line is not None) == (name == "counters")
    p2 = convert.params_from_numpy(p_np, "cpu")
    s2 = convert.state_from_numpy(s_np, pgs.ScoreSimConfig()
                                  if name != "unscored" else None, "cpu")
    _assert_tree_equal(p_np, convert.params_to_numpy(p2), "params")
    _assert_tree_equal(s_np, convert.state_to_numpy(s2), "state")
    assert p2.delays.k_slots == 8 and int(p2.delays.seed) == 9


@pytest.mark.parametrize("point", [{"delay_base": 2},
                                   {"delay_jitter": 4, "d": 5},
                                   {"delay_base": 1, "delay_jitter": 0}],
                         ids=str)
def test_delay_knobs_armed_equal_built_and_the_reference(ref, point):
    dkw = dict(base=3, jitter=2, k_slots=8)
    (_, _, p_r, _), (cfg_p, sc_p, p_p, s_p) = _build_both(
        ref, "scored", dkw, sim_knobs=point)
    _assert_tree_equal(tree_to_numpy(p_r), convert.params_to_numpy(p_p),
                       "params")
    assert int(p_p.delays.base) == point.get("delay_base", 3)
    (_, _, _, _), (_, _, p0, s0) = _build_both(ref, "scored", dkw)
    armed = pgs.knob_params(cfg_p, sc_p, p0, sim_knobs=point,
                            delays=pdl.DelayConfig(**dkw))
    _assert_tree_equal(convert.params_to_numpy(p_p),
                       convert.params_to_numpy(armed), "armed")
    # without the DelayConfig, the built values are read back
    armed2 = pgs.knob_params(cfg_p, sc_p, p0, sim_knobs=point)
    _assert_tree_equal(convert.params_to_numpy(p_p),
                       convert.params_to_numpy(armed2), "armed")
    with pytest.raises(ValueError, match="delay knobs: base"):
        pgs.knob_params(cfg_p, sc_p, p0, sim_knobs={"delay_base": 8,
                                                    "delay_jitter": 1})


def test_pipelined_arming_equals_building_with_the_point():
    sim = pipelined.build("cpu", 2_000)
    for pid, point in pipelined.POINTS.items():
        armed = pipelined.arm(sim, point)
        built = pipelined.build("cpu", 2_000, sim_knobs=point)
        _assert_tree_equal(convert.params_to_numpy(built[2]),
                           convert.params_to_numpy(armed[2]), pid)
        _assert_tree_equal(convert.state_to_numpy(built[3]),
                           convert.state_to_numpy(armed[3]), pid)


def test_pipelined_benchmark_rows_and_gates_at_3000_peers():
    out = pipelined.run("cpu", 3_000)
    rows = out["rows"]
    assert out["ok"] and out["gates"]["ok"], out["gates"]
    assert list(rows) == list(pipelined.POINTS)
    for pid, row in rows.items():
        assert sum(row["hist"]) == row["latency"]["count"] > 0, pid
        assert 0.0 < row["delivery_fraction"] <= 1.0
    # delay stretches latency: base4's p99 past base1's, jitter past base4
    p99 = out["p99"]
    assert p99["base1"] < p99["base2"] < p99["base4"] <= p99["base4j2"]
    assert out["p99_stretch_base4"] == p99["base4"] / max(p99["base1"], 1)
    assert len({r["digest"] for r in rows.values()}) == len(rows)
    # the one batched dispatch against the points run one after another
    check = pipelined.cross_check(out, pipelined.run_sequential("cpu",
                                                                3_000))
    assert check["ok"] and all(check["rows"].values()), check


# -- refusals and the reference's errors --------------------------------------

def test_paired_topics_raise_the_references_error(ref):
    cfg_r, cfg_p = _cfgs(ref, c=16, paired_topics=True)
    n = 256
    subs = np.zeros((n, 4), dtype=bool)
    subs[np.arange(n), np.arange(n) % 4] = True
    subs[np.arange(n), (np.arange(n) % 4 + 2) % 4] = True
    args = (subs, np.array([0]), np.array([0]), np.array([1], np.int32))
    msg = _both_raise(ref, lambda: ref.gs.make_gossip_sim(
        cfg_r, *args, delays=ref.delays.DelayConfig()),
        lambda: pgs.make_gossip_sim(cfg_p, *args, device="cpu",
                                    delays=pdl.DelayConfig()),
        NotImplementedError)
    assert msg == ref.plan.MSG_DELAYS_PAIRED == plan.MSG_DELAYS_PAIRED
    params, state = pgs.make_gossip_sim(cfg_p, *args, device="cpu")
    params = dataclasses.replace(params, delays=pdl.compile_delays(
        pdl.DelayConfig(), "cpu"))
    with pytest.raises(NotImplementedError) as err:
        pgs.make_gossip_step(cfg_p, None, device="cpu")(params, state)
    assert str(err.value) == plan.MSG_DELAYS_PAIRED


def test_the_iwant_flood_raises_the_references_kernel_error(ref):
    flood = dict(sybil_ihave_spam=True, sybil_iwant_spam=True)
    cfg_r, cfg_p = _cfgs(ref, c=16)
    args = _sim_inputs()
    sybil = np.arange(256) % 5 == 0
    params, state = pgs.make_gossip_sim(
        cfg_p, *args, score_cfg=pgs.ScoreSimConfig(**flood), sybil=sybil,
        device="cpu", delays=pdl.DelayConfig(2, 1, 4))
    with pytest.raises(ValueError) as err:
        pgs.make_gossip_step(cfg_p, pgs.ScoreSimConfig(**flood),
                             device="cpu")(params, state)
    assert str(err.value) == ref.plan.MSG_KERNEL_DELAY_IWANT_SPAM
    assert plan.MSG_KERNEL_DELAY_IWANT_SPAM == (
        ref.plan.MSG_KERNEL_DELAY_IWANT_SPAM)


def test_the_fused_window_refuses_a_delayed_sim_with_the_references_message(
        ref):
    cfg_r, cfg_p = _cfgs(ref, c=16)
    args = _sim_inputs()
    params, state = pgs.make_gossip_sim(cfg_p, *args, device="cpu",
                                        delays=pdl.DelayConfig(2, 1, 4),
                                        delays_counters=True)
    win = pgs.make_fused_window(cfg_p, None, ticks_fused=4, device="cpu")
    with pytest.raises(plan.SliceRefusal) as err:
        pgs.gossip_run_fused(params, state, 8, win, device="cpu")
    assert err.value.name == "fused_delays"
    lines = (state.pay_line, state.ctrl_line, state.gsp_line, state.adv_line)
    extra = sum(x.numel() * 4 for x in lines)
    assert str(err.value) == (f"fused_delays: "
                              f"{ref.plan.msg_fused_delays(extra)}")


def _small_sim():
    offsets = pgs.make_gossip_offsets(4, 16, 256, seed=0)
    return (pgs.GossipSimConfig(offsets=offsets, n_topics=4),
            pgs.ScoreSimConfig(), _sim_inputs())


def test_split_and_probe_lines_are_refused_by_name():
    """The split path's delay line is refused by name; the probe line is
    built (int32 [K, 3, N], empty) since the RPC probe runs delayed."""
    cfg, sc, args = _small_sim()
    with pytest.raises(plan.SliceRefusal) as err:
        pgs.make_gossip_sim(cfg, *args, score_cfg=sc, device="cpu",
                            delays=pdl.DelayConfig(), delays_split=True)
    assert err.value.name == "delays_split"
    dc = pdl.DelayConfig()
    _, state = pgs.make_gossip_sim(cfg, *args, score_cfg=sc, device="cpu",
                                   delays=dc, delays_probe=True)
    n = args[0].shape[0]
    assert state.probe_line.shape == (dc.k_slots, 3, n)
    assert state.probe_line.dtype == torch.int32
    assert not state.probe_line.any()


@pytest.mark.parametrize("flag", ["delays_split", "delays_counters",
                                  "delays_probe"])
def test_delay_flags_without_a_config_raise_the_references_error(ref, flag):
    cfg_r, cfg_p = _cfgs(ref, c=16)
    args = _sim_inputs()
    msg = _both_raise(ref, lambda: ref.gs.make_gossip_sim(
        cfg_r, *args, **{flag: True}), lambda: pgs.make_gossip_sim(
        cfg_p, *args, device="cpu", **{flag: True}))
    assert flag in msg


def test_delay_knobs_without_a_config_raise_the_references_error(ref):
    cfg_r, cfg_p = _cfgs(ref, c=16)
    args = _sim_inputs()
    msg = _both_raise(ref, lambda: ref.gs.make_gossip_sim(
        cfg_r, *args, sim_knobs={"delay_jitter": 1}),
        lambda: pgs.make_gossip_sim(cfg_p, *args, device="cpu",
                                    sim_knobs={"delay_jitter": 1}))
    assert "DelayConfig" in msg


def test_missing_lines_raise_the_references_errors(ref):
    cfg_r, cfg_p = _cfgs(ref, c=16)
    args = _sim_inputs()
    sc = pgs.ScoreSimConfig()
    params, state = pgs.make_gossip_sim(cfg_p, *args, score_cfg=sc,
                                        device="cpu",
                                        delays=pdl.DelayConfig(2, 0, 2))
    with pytest.raises(ValueError) as err:
        pgs.make_gossip_step(cfg_p, sc, device="cpu")(
            params, dataclasses.replace(state, pay_line=None))
    assert str(err.value) == ref.plan.MSG_DELAYS_NEED_LINES
    step = pgs.make_gossip_step(cfg_p, sc, device="cpu",
                                telemetry=ptl.TelemetryConfig())
    with pytest.raises(ValueError) as err:
        step(params, state)
    assert str(err.value) == ref.plan.MSG_DELAYS_NEED_COUNTER_LINES
    # the latency histogram alone needs no observer line
    step = pgs.make_gossip_step(cfg_p, sc, device="cpu",
                                telemetry=ptl.TelemetryConfig(
                                    counters=False, wire=False,
                                    latency_hist=True))
    assert step(params, state)[0].tick == 1


@pytest.mark.parametrize("name", ["scored", "unscored"])
def test_the_delayed_step_adds_no_host_sync(ref, name, monkeypatch):
    """A delayed step reads tensor values on the host as often as one
    without: once (the prune's ``nonzero``) scored, never unscored."""
    counts = []
    for dkw in (None, dict(base=3, jitter=2, k_slots=8)):
        cfg, sc, args = _small_sim()
        if name == "unscored":
            sc = None
        params, state = pgs.make_gossip_sim(
            cfg, *args, score_cfg=sc, device="cpu",
            delays=None if dkw is None else pdl.DelayConfig(**dkw))
        step = pgs.make_gossip_step(cfg, sc, device="cpu")
        state = step(params, state)[0]
        counter = _SyncCounter(monkeypatch)
        step(params, state)
        counts.append(counter.count)
        monkeypatch.undo()
    assert counts[0] == counts[1] == (1 if name == "scored" else 0)
