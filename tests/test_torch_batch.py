"""Replica batching: B stacked sims of one static config through ONE step
a tick, against the JAX reference's vmapped runners and against the
port's own sequential runs.

The reference's shapes (its ``_replica_specs``: 300 peers, 3 topics,
C = 16, 8 messages, mesh seeds 1-3), the same seeded inputs (numpy)
handed to both packages: the port's stacked final state equals the
reference's ``gossip_run_batch`` output leaf for leaf, and each replica
equals the port's ``gossip_run`` of that replica alone.  Tolerance: exact
(f32/bf16 leaves compared by bit pattern).  Also here: the curve batch,
a copied carry, a permutation of the replicas, a ring of N = 2 mod 4
peers (B3's quads straddle replicas), the plain B1 and B3 with a replica
axis, ``stack_trees``' and ``stack_sims``' named errors, the conversion of
stacked trees, every batched refusal by name, and a stack grafting
opportunistically after tick 0.
"""

import hashlib

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.models import _batch
from go_libp2p_pubsub_tpu_torch.models import faults as pfl
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import invariants as piv
from go_libp2p_pubsub_tpu_torch.models import plan
from go_libp2p_pubsub_tpu_torch.models import telemetry as ptel
from go_libp2p_pubsub_tpu_torch.models.delays import DelayConfig
from go_libp2p_pubsub_tpu_torch.ops import graph
from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as krecv
from go_libp2p_pubsub_tpu_torch.ops.kernels import select as kselect
from test_torch_gossipsub import _assert_tree_equal
from test_torch_knobs import one_thread  # noqa: F401  (autouse)
from torch_ref import imported_reference, tree_to_numpy


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.faults as rfl
        import go_libp2p_pubsub_tpu.models.invariants as riv
        r.faults, r.invariants = rfl, riv
        yield r


def replica_specs(n=300, t=3, c=16, n_msgs=8, seeds=(1, 2, 3)):
    """The reference's ``_replica_specs``: (make_cfg, specs), make_cfg
    taking either package's gossipsub module."""
    subs = np.zeros((n, t), dtype=bool)
    subs[np.arange(n), np.arange(n) % t] = True
    rng = np.random.default_rng(1)
    topic = rng.integers(0, t, n_msgs)
    origin = rng.integers(0, n // t, n_msgs) * t + topic
    ticks = np.zeros(n_msgs, dtype=np.int32)
    specs = [dict(subs=subs, msg_topic=topic, msg_origin=origin,
                  msg_publish_tick=ticks, seed=s) for s in seeds]

    def make_cfg(gs):
        return gs.GossipSimConfig(
            offsets=gs.make_gossip_offsets(t, c, n, seed=1), n_topics=t)
    return make_cfg, specs


def run_both(ref, make_cfg, specs_of, ticks, *, sc_kw=None, step_kw=None,
             arm=False, honest=None):
    """The same stack run by both packages: the reference's batched
    runner (``gossip_run_knob_batch`` where ``honest`` is given, else
    ``gossip_run_batch``) and the port's, the final stacks compared leaf
    for leaf; then each of the port's replicas against its own
    sequential run.  ``specs_of(faults_module)`` gives the replicas'
    make_gossip_sim keywords.  Returns the port's (builds, final stack,
    reach or None, step)."""
    out = {}
    for side in ("ref", "port"):
        if side == "ref":
            gs, fl, iv, kw = ref.gs, ref.faults, ref.invariants, {}
        else:
            gs, fl, iv, kw = pgs, pfl, piv, {"device": "cpu"}
        cfg = make_cfg(gs)
        sc = None if sc_kw is None else gs.ScoreSimConfig(**sc_kw)
        builds = [gs.make_gossip_sim(cfg, score_cfg=sc, **spec, **kw)
                  for spec in specs_of(fl)]
        params = gs.stack_trees([p for p, _ in builds])
        state = gs.stack_trees([iv.attach(s) if arm else s
                                for _, s in builds])
        step = gs.make_gossip_step(
            cfg, sc, **(step_kw or {}),
            **({"invariants": iv.InvariantConfig()} if arm else {}), **kw)
        reach = None
        if honest is None:
            final = gs.gossip_run_batch(params, state, ticks, step, **kw)
        else:
            final, reach = gs.gossip_run_knob_batch(
                params, state, ticks, step, honest(len(builds)), **kw)
        out[side] = (builds, final, reach, step)
    builds, final, reach, step = out["port"]
    _assert_tree_equal(tree_to_numpy(out["ref"][1]),
                       convert.state_to_numpy(final), "stack")
    if reach is not None:
        np.testing.assert_array_equal(reach.numpy(),
                                      np.asarray(out["ref"][2]))
    for i, (p, s) in enumerate(builds):
        seq = pgs.gossip_run(p, piv.attach(s) if arm else s, ticks, step,
                             device="cpu")
        _assert_tree_equal(convert.state_to_numpy(seq),
                           convert.state_to_numpy(
                               _batch.index_trees(final, i)),
                           f"replica {i}")
    return builds, final, reach, step


def fingerprint(tree) -> str:
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif x is not None:
            h.update(np.ascontiguousarray(np.asarray(x)).tobytes())
    walk(convert.state_to_numpy(tree))
    return h.hexdigest()


@pytest.mark.parametrize("scored", [True, False], ids=["scored", "unscored"])
def test_batch_matches_reference_and_sequential(ref, scored):
    make_cfg, specs = replica_specs()
    builds, final, _, _ = run_both(ref, make_cfg, lambda fl: specs, 20,
                                   sc_kw={} if scored else None)
    # non-vacuous: the replicas differ, and every message travelled
    assert not torch.equal(final.mesh[0], final.mesh[1])
    params = pgs.stack_trees([p for p, _ in builds])
    assert (pgs.reach_counts_from_have(params, final) == 100).all()


def test_batch_grafts_opportunistically_after_tick_0(ref):
    """The scored stack, armed, with opportunistic grafting every 7 ticks
    (threshold 5) for 80 ticks: leaf for leaf the reference's
    ``gossip_run_batch`` and the port's sequential runs; non-vacuous, the
    meshes differ from the same stack at the default 60-tick cadence."""
    make_cfg, specs = replica_specs()
    og = dict(opportunistic_graft_ticks=7,
              opportunistic_graft_threshold=5.0)
    _, final, _, _ = run_both(ref, make_cfg, lambda fl: specs, 80,
                              sc_kw=og, arm=True)
    cfg = make_cfg(pgs)
    sc = pgs.ScoreSimConfig(opportunistic_graft_threshold=5.0)
    params, state = pgs.stack_sims(cfg, specs, score_cfg=sc, device="cpu")
    slow = pgs.gossip_run_batch(params, piv.attach(state), 80,
                                pgs.make_gossip_step(
                                    cfg, sc, device="cpu",
                                    invariants=piv.InvariantConfig()),
                                device="cpu")
    for i in range(len(specs)):
        assert not torch.equal(final.mesh[i], slow.mesh[i]), i
    assert (final.inv_viol == 0).all() and (slow.inv_viol == 0).all()


def test_batch_on_a_ring_of_n_2_mod_4(ref):
    """302 peers: B3's four-peer quads straddle the replicas' rows."""
    make_cfg, specs = replica_specs(n=302, t=2, seeds=(4, 5, 6))
    run_both(ref, make_cfg, lambda fl: specs, 15, sc_kw={})


def test_curve_batch_matches_reference_and_sequential(ref):
    make_cfg, specs = replica_specs()
    counts = {}
    for side, gs, kw in (("ref", ref.gs, {}), ("port", pgs,
                                               {"device": "cpu"})):
        cfg = make_cfg(gs)
        step = gs.make_gossip_step(cfg, **kw)
        params, state = gs.stack_sims(cfg, specs, **kw)
        _, c = gs.gossip_run_curve_batch(params, state, 25, step, 8, **kw)
        counts[side] = np.asarray(c)
    assert counts["port"].shape == (25, len(specs), 8)
    np.testing.assert_array_equal(counts["port"], counts["ref"])
    cfg = make_cfg(pgs)
    step = pgs.make_gossip_step(cfg, device="cpu")
    for i, spec in enumerate(specs):
        p, s = pgs.make_gossip_sim(cfg, **spec, device="cpu")
        _, c = pgs.gossip_run_curve(p, s, 25, step, 8, device="cpu")
        np.testing.assert_array_equal(counts["port"][:, i, :], c.numpy())


def test_copied_carry_same_fingerprint():
    """A batch run from a copied carry ends where one from the original
    does (PyTorch has no donation: the copy is what a caller reusing a
    state passes)."""
    make_cfg, specs = replica_specs()
    cfg = make_cfg(pgs)
    step = pgs.make_gossip_step(cfg, device="cpu")
    params, state = pgs.stack_sims(cfg, specs, device="cpu")
    keep = pgs.tree_copy(state)
    assert keep.mesh.data_ptr() != state.mesh.data_ptr()
    before = fingerprint(state)
    out_a = pgs.gossip_run_batch(params, state, 15, step, device="cpu")
    out_b = pgs.gossip_run_batch(params, keep, 15, step, device="cpu")
    assert fingerprint(out_a) == fingerprint(out_b)
    assert fingerprint(state) == before


def test_replica_permutation_follows_the_replicas():
    """Replicas (1, 2, 3) and (3, 1, 2): each final replica follows its
    seed, so no replica reads another's salt, row or lane."""
    make_cfg, specs = replica_specs()
    cfg = make_cfg(pgs)
    sc = pgs.ScoreSimConfig()
    step = pgs.make_gossip_step(cfg, sc, device="cpu")
    perm = [2, 0, 1]
    outs = []
    for order in (specs, [specs[i] for i in perm]):
        params, state = pgs.stack_sims(cfg, order, score_cfg=sc,
                                       device="cpu")
        outs.append(pgs.gossip_run_batch(params, state, 15, step,
                                         device="cpu"))
    for j, i in enumerate(perm):
        _assert_tree_equal(
            convert.state_to_numpy(_batch.index_trees(outs[0], i)),
            convert.state_to_numpy(_batch.index_trees(outs[1], j)),
            f"replica {i} at {j}")


def test_stacked_trees_convert_both_ways(ref):
    make_cfg, specs = replica_specs()
    cfg_r = make_cfg(ref.gs)
    sc_r = ref.gs.ScoreSimConfig()
    p_r, s_r = ref.gs.stack_sims(cfg_r, specs, score_cfg=sc_r)
    p_p, s_p = pgs.stack_sims(make_cfg(pgs), specs,
                              score_cfg=pgs.ScoreSimConfig(), device="cpu")
    _assert_tree_equal(tree_to_numpy(p_r), convert.params_to_numpy(p_p),
                       "params")
    _assert_tree_equal(tree_to_numpy(s_r), convert.state_to_numpy(s_p),
                       "state")
    back = convert.state_from_numpy(tree_to_numpy(s_r),
                                    pgs.ScoreSimConfig(), "cpu")
    assert torch.equal(back.salt, s_p.salt) and back.tick == 0
    _assert_tree_equal(convert.state_to_numpy(back),
                       convert.state_to_numpy(s_p), "round trip")
    pb = convert.params_from_numpy(tree_to_numpy(p_r), "cpu")
    _assert_tree_equal(convert.params_to_numpy(pb),
                       convert.params_to_numpy(p_p), "params round trip")


# -- the plain kernels with a replica axis ----------------------------------


@pytest.mark.parametrize("c", [8, 16, 32])
@pytest.mark.parametrize("n", [40, 42, 37])
def test_plain_select_takes_a_replica_axis(c, n):
    g = torch.Generator().manual_seed(c * 100 + n)
    B = 3
    elig = torch.randint(0, 1 << 30, (B, n), generator=g).to(torch.int32)
    if c < 32:
        elig &= (1 << c) - 1
    kk = torch.randint(-1, c + 2, (B, n), generator=g).to(torch.int32)
    salt = torch.tensor([7, 0xFFFFFFF0, 123456789], dtype=torch.int64)
    seeds = graph.lane_seed(11, 3, salt)
    got = kselect.select_k_bits(elig, kk, c, seeds, n)
    assert got.shape == (B, n)
    for b in range(B):
        one = kselect.select_k_bits_plain(elig[b], kk[b], c,
                                          graph.lane_seed(11, 3,
                                                          int(salt[b])), n)
        assert torch.equal(got[b], one), b


def _receive_ops(k, n, seed, *, attack=False, faults=False, knobs=False):
    """Seeded random operands of ``k``'s receive variant at ``n`` peers
    (W = 1): the sender streams, or in delay mode the arrivals and the
    resolved control words; with telemetry's latency rows the bucket masks
    and deliver words."""
    g = torch.Generator().manual_seed(seed)
    C = k.n_candidates

    def words(shape, bits=32):
        v = torch.randint(0, 1 << 31, shape, generator=g) & ((1 << bits) - 1)
        return v.to(torch.int32)

    ops = dict(
        gseeds=(seed * 7919 & graph.MASK32, seed * 104729 & graph.MASK32),
        ctrl=torch.randint(0, 64, (C, n), generator=g).to(torch.uint8),
        fresh=words((1, n)), adv=words((1, n)),
        sub_all=torch.where(torch.rand(n, generator=g) < 0.8,
                            (1 << C) - 1, 0).to(torch.int32),
        cand_sub=words((n,), C), fanout=words((n,), C) & words((n,), C),
        wa=words((n,), C), grafts=words((n,), C) & words((n,), C),
        dropped=words((n,), C) & words((n,), C), meshsel=words((n,), C),
        seen=words((1, n)), injected=words((1, n)) & 0x0F0F,
        backoff=torch.randint(0, 61, (C, n), generator=g).to(torch.int16))
    if k.scored:
        ops.update(
            valid=words((1,)), pay=words((n,), C), gsp=words((n,), C),
            acc=words((n,), C), bo2=words((n,), C), static=None,
            fd=(torch.rand((C, n), generator=g) * 60).to(k.counter_dtype),
            inv=(torch.rand((C, n), generator=g) * 3).to(k.counter_dtype),
            bp=(torch.rand((C, n), generator=g) * 3).to(k.bp_dtype),
            tim=torch.randint(0, 200, (C, n), generator=g).to(torch.int16),
            iws=torch.randint(0, 300, (C, n), generator=g).to(torch.int16))
    if attack:
        ops["syb"] = torch.where(torch.rand(n, generator=g) < 0.2,
                                 (1 << C) - 1, 0).to(torch.int32)
    if faults:
        ops["alive_w"] = torch.where(torch.rand(n, generator=g) < 0.1, 0,
                                     -1).to(torch.int32)
        if k.iwant_spam:
            ops["flood_ok"] = words((n,), C)
    if knobs:
        v = [0.2 + seed % 5 * 0.1, 2.0 + seed % 3, 5.0 + seed % 7]
        if k.scored:
            v += [-5.0 - seed % 4, -10.0 - seed % 3, -70.0, -8.0]
        ops["knobs"] = torch.tensor(v, dtype=torch.float32)
    if k.delays:
        for name in krecv.SENDER_OPERANDS:
            ops.pop(name, None)
        ops.update(arr=words((C, n)) & words((C, n)),
                   graft_arr=words((n,), C) & words((n,), C),
                   prune_arr=words((n,), C) & words((n,), C),
                   retract=words((n,), C) & words((n,), C))
        if k.track_promises:
            ops["cheat_arr"] = words((n,), C) & words((n,), C)
    if k.tel_lat_buckets:
        ops.update(lat_masks=words((k.tel_lat_buckets, 1)),
                   dlv_eff=words((1, n)))
    return ops


#: the delay mode's and the telemetry tally's families on a stack: (scored,
#: the ScoreSimConfig's attack keywords, receive_consts' keywords, the
#: operands' keywords)
IHAVE = dict(sybil_ihave_spam=True)
ATK2 = dict(sybil_ihave_spam=True, sybil_iwant_spam=True)
STACK_VARIANTS = {
    "scored_delays": (True, {}, dict(delays=True), {}),
    "unscored_delays": (False, {}, dict(delays=True), {}),
    "attack_delays": (True, IHAVE, dict(delays=True), dict(attack=True)),
    "scored_delays_knobs": (True, {}, dict(delays=True, knobs=True),
                            dict(knobs=True)),
    "unscored_delays_knobs": (False, {}, dict(delays=True, knobs=True),
                              dict(knobs=True)),
    "attack_delays_knobs": (True, IHAVE, dict(delays=True, knobs=True),
                            dict(attack=True, knobs=True)),
    "scored_tel": (True, {}, dict(telemetry=True, tel_lat_buckets=5), {}),
    "unscored_tel": (False, {}, dict(telemetry=True, tel_lat_buckets=5), {}),
    "attack_tel": (True, ATK2, dict(telemetry=True, tel_lat_buckets=5),
                   dict(attack=True)),
    "scored_faults_tel": (True, {}, dict(telemetry=True, faults=True,
                                         tel_lat_buckets=5),
                          dict(faults=True)),
    "unscored_faults_tel": (False, {}, dict(telemetry=True, faults=True),
                            dict(faults=True)),
    "attack_faults_tel": (True, ATK2, dict(telemetry=True, faults=True,
                                           tel_lat_buckets=16),
                          dict(attack=True, faults=True)),
    "scored_tel_knobs": (True, {}, dict(telemetry=True, knobs=True,
                                        tel_lat_buckets=5),
                         dict(knobs=True)),
    "unscored_faults_tel_knobs": (False, {}, dict(
        telemetry=True, faults=True, knobs=True, tel_lat_buckets=5),
        dict(faults=True, knobs=True)),
    "attack_tel_knobs": (True, ATK2, dict(telemetry=True, knobs=True),
                         dict(attack=True, knobs=True)),
    "attack_faults_tel_knobs": (True, ATK2, dict(
        telemetry=True, faults=True, knobs=True, tel_lat_buckets=5),
        dict(attack=True, faults=True, knobs=True)),
}


def stack_case(name, n, c, seed, reps=3, cfg_kw=None):
    """``(k, reps' operands, the stack)`` of a ``STACK_VARIANTS`` family at
    ``n`` peers and C = ``c`` (C = 8: a degree family that fits): each
    replica's operands from its own seed (distinct seeds, words, knob
    vectors and bucket masks, so a mix-up shows), stacked [B, ...] with
    ``gseeds`` two [B] tensors."""
    scored, sc_kw, k_kw, o_kw = STACK_VARIANTS[name]
    if cfg_kw is None and c == 8:
        cfg_kw = dict(d=3, d_lo=2, d_hi=6, d_score=2, d_out=1, d_lazy=2)
    cfg = pgs.GossipSimConfig(offsets=pgs.make_gossip_offsets(
        2, c, n - n % 2, seed=3), n_topics=2, **(cfg_kw or {}))
    k = krecv.receive_consts(cfg, pgs.ScoreSimConfig(**sc_kw)
                             if scored else None, **k_kw)
    ops = [_receive_ops(k, n, seed + 17 * b, **o_kw) for b in range(reps)]
    return k, ops, stack_ops(ops)


def stack_ops(reps):
    """Replicas' receive operands stacked [B, ...], ``gseeds`` two [B]
    int64 tensors."""
    stacked = {}
    for key, v in reps[0].items():
        if key == "gseeds":
            stacked[key] = tuple(torch.tensor([r[key][i] for r in reps],
                                              dtype=torch.int64)
                                 for i in range(2))
        elif isinstance(v, torch.Tensor):
            stacked[key] = torch.stack([r[key] for r in reps])
        else:
            stacked[key] = v
    return stacked


PLAIN_VARIANTS = {
    "scored": (True, {}, {}),
    "unscored": (False, {}, {}),
    "attack": (True, dict(sybil_ihave_spam=True, sybil_iwant_spam=True),
               dict(attack=True)),
    "unscored_faults": (False, {}, dict(faults=True)),
    "scored_knobs": (True, {}, dict(knobs=True)),
    "attack_faults_knobs": (True, dict(sybil_ihave_spam=True,
                                       sybil_iwant_spam=True),
                            dict(attack=True, faults=True, knobs=True)),
}


@pytest.mark.parametrize("name", sorted(PLAIN_VARIANTS))
def test_plain_receive_takes_a_replica_axis(name):
    scored, sc_kw, kw = PLAIN_VARIANTS[name]
    n = 50
    cfg = pgs.GossipSimConfig(offsets=pgs.make_gossip_offsets(2, 16, n,
                                                              seed=3),
                              n_topics=2)
    k = krecv.receive_consts(cfg, pgs.ScoreSimConfig(**sc_kw)
                             if scored else None,
                             faults=kw.get("faults", False),
                             knobs=kw.get("knobs", False))
    reps = [_receive_ops(k, n, 10 + b, **kw) for b in range(3)]
    stacked = {}
    for key, v in reps[0].items():
        if key == "gseeds":
            stacked[key] = tuple(torch.tensor([r[key][i] for r in reps],
                                              dtype=torch.int64)
                                 for i in range(2))
        elif isinstance(v, torch.Tensor):
            stacked[key] = torch.stack([r[key] for r in reps])
        else:
            stacked[key] = v
    got = krecv.receive_update(k, **stacked)
    for b, r in enumerate(reps):
        one = krecv.receive_update_plain(k, **r)
        assert len(one) == len(got)
        for i, (x, y) in enumerate(zip(got, one)):
            assert x.shape == (3, *y.shape), (b, i)
            assert torch.equal(x[b], y), (name, b, i)


# -- the named errors and refusals ------------------------------------------


def test_stack_trees_names_the_first_mismatch():
    make_cfg, specs = replica_specs(seeds=(1, 2))
    cfg = make_cfg(pgs)
    p_plain, s_plain = pgs.make_gossip_sim(cfg, **specs[0], device="cpu")
    p_sc, s_sc = pgs.make_gossip_sim(cfg, **specs[1], device="cpu",
                                     score_cfg=pgs.ScoreSimConfig())
    with pytest.raises(ValueError, match="structure") as e:
        pgs.stack_trees([s_plain, s_sc])
    assert "scores" in str(e.value)
    with pytest.raises(ValueError, match="replica 1 has field"):
        pgs.stack_trees([p_plain, p_sc])
    make_cfg2, specs2 = replica_specs(n=303)
    _, s_big = pgs.make_gossip_sim(make_cfg2(pgs), **specs2[0],
                                   device="cpu")
    with pytest.raises(ValueError, match="'mesh' has shape"):
        pgs.stack_trees([s_plain, s_big])
    _, s_f32 = pgs.make_gossip_sim(
        cfg, **specs[1], device="cpu",
        score_cfg=pgs.ScoreSimConfig(counter_dtype="float32"))
    with pytest.raises(ValueError, match="dtype"):
        pgs.stack_trees([s_sc, s_f32])
    odd = pgs.replace(s_sc, gates_fp=s_sc.gates_fp + 1)
    with pytest.raises(ValueError, match="static .*'gates_fp'"):
        pgs.stack_trees([s_sc, odd])
    with pytest.raises(ValueError, match="at least one"):
        pgs.stack_trees([])


@pytest.mark.parametrize("key,a,b", [
    ("score_cfg", None, "scored"), ("track_first_tick", True, False),
    ("px_candidates", None, 14)])
def test_stack_sims_refuses_differing_static_config(key, a, b):
    make_cfg, specs = replica_specs(seeds=(1, 2))
    if b == "scored":
        b = pgs.ScoreSimConfig()
    specs = [dict(specs[0], **{key: a}), dict(specs[1], **{key: b})]
    with pytest.raises(ValueError, match=f"static config '{key}'"):
        pgs.stack_sims(make_cfg(pgs), specs, device="cpu")


def _stack(make_cfg, specs, step_kw=None, **sim_kw):
    cfg = make_cfg(pgs)
    sc = sim_kw.pop("score_cfg", None)
    params, state = pgs.stack_sims(cfg, specs, score_cfg=sc, device="cpu",
                                   **sim_kw)
    return cfg, sc, params, state


def test_batched_refusals_by_name():
    make_cfg, specs = replica_specs(seeds=(1, 2))
    cfg = make_cfg(pgs)
    sims = [pgs.make_gossip_sim(cfg, **s, device="cpu") for s in specs]
    later = pgs.replace(sims[1][1], tick=3)
    with pytest.raises(plan.SliceRefusal, match="batched_ticks") as e:
        pgs.stack_trees([sims[0][1], later])
    assert e.value.name == "batched_ticks"

    # a delay-armed stack and a stack with telemetry now step (their
    # refusals are gone): one step for the stack, the lines [B, K, ...] and
    # the frame's fields [B]
    assert "batched_delays" not in plan.REFUSALS
    assert "batched_telemetry" not in plan.REFUSALS
    cfg, sc, params, state = _stack(make_cfg, specs,
                                    delays=DelayConfig(1, 1, 4))
    state = pgs.make_gossip_step(cfg, sc, device="cpu")(params, state)[0]
    assert state.tick == 1 and state.pay_line.shape[:2] == (2, 4)

    cfg, sc, params, state = _stack(make_cfg, specs)
    tstep = pgs.make_gossip_step(cfg, sc, device="cpu",
                                 telemetry=ptel.TelemetryConfig())
    state, _, frame = tstep(params, state)
    assert state.tick == 1 and frame.payload_sent.shape == (2,)
    window = pgs.make_fused_window(cfg, ticks_fused=4, device="cpu")
    with pytest.raises(plan.SliceRefusal, match="batched_fused"):
        window(params, state)

    cfg, sc, params, state = _stack(make_cfg, specs, px_candidates=14)
    with pytest.raises(plan.SliceRefusal, match="batched_surface"):
        pgs.make_gossip_step(cfg, sc, device="cpu")(params, state)

    n, t = 240, 2
    pcfg = pgs.GossipSimConfig(
        offsets=pgs.make_gossip_offsets(t, 16, n, seed=1, paired=True),
        n_topics=t, paired_topics=True)
    subs = np.ones((n, t), dtype=bool)
    pspecs = [dict(subs=subs, msg_topic=np.array([0]),
                   msg_origin=np.array([0]),
                   msg_publish_tick=np.array([0], np.int32), seed=s)
              for s in (1, 2)]
    params, state = pgs.stack_sims(pcfg, pspecs, device="cpu")
    with pytest.raises(plan.SliceRefusal, match="batched_paired"):
        pgs.make_gossip_step(pcfg, device="cpu")(params, state)

    grp = np.arange(300) % 2
    scheds = [pfl.FaultSchedule(n_peers=300, horizon=40, seed=s,
                                partition_group=grp,
                                partition_windows=[(5 + s, 9)])
              for s in (1, 2)]
    with pytest.raises(plan.SliceRefusal, match="batched_partitions"):
        pgs.stack_sims(cfg, [dict(s, fault_schedule=f)
                             for s, f in zip(specs, scheds)], device="cpu")


def test_batched_runners_take_a_stack():
    make_cfg, specs = replica_specs(seeds=(1,))
    cfg = make_cfg(pgs)
    params, state = pgs.make_gossip_sim(cfg, **specs[0], device="cpu")
    step = pgs.make_gossip_step(cfg, device="cpu")
    with pytest.raises(ValueError, match="replica stack"):
        pgs.gossip_run_batch(params, state, 1, step, device="cpu")


@pytest.mark.parametrize("option,refusal", [
    ("paired", "batched_paired"), ("full", "batched_surface")])
def test_receive_wrapper_refuses_what_a_stack_does_not_run(option,
                                                          refusal):
    """B1's stack kernels are the flagship and attack options' (with and
    without faults and knobs, in delay mode, with the telemetry tally):
    the wrapper refuses a stack of the other variants by name before any
    launch."""
    n = 50
    paired = option == "paired"
    cfg = pgs.GossipSimConfig(offsets=pgs.make_gossip_offsets(
        2, 16, n, seed=3, paired=paired), n_topics=2, paired_topics=paired)
    k = krecv.receive_consts(cfg, pgs.ScoreSimConfig(),
                             **({} if paired else {"px": True}))
    ops = _receive_ops(k, n, 5)
    stacked = {key: (tuple(torch.tensor([v_, v_]) for v_ in v)
                     if key == "gseeds" else
                     torch.stack([v, v]) if isinstance(v, torch.Tensor)
                     else v) for key, v in ops.items()}
    with pytest.raises(plan.SliceRefusal) as e:
        krecv.receive_update(k, **stacked)
    assert e.value.name == refusal
