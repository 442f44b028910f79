"""The port's attack × defense tournament against the JAX reference's: the
grid drawn in the reference's order, and the whole grid run at a small
size (1,024 peers, 4 topics, 8 messages, 40 ticks) — the port's cells
one after another on the CPU, the reference's as its one batched
dispatch — with the report equal key for key and each cell's final
state equal leaf for leaf, bit for bit.
"""

import numpy as np
import pytest

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch import tournament as ptn
from test_torch_gossipsub import _assert_tree_equal
from test_torch_knobs import one_thread  # noqa: F401  (autouse)
from torch_ref import imported_reference, tree_to_numpy

N, T, M, TICKS = 1024, 4, 8, 40


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.invariants as riv
        import go_libp2p_pubsub_tpu.models.tournament as rtn
        r.tournament, r.invariants = rtn, riv
        yield r


def test_grid_is_drawn_as_the_reference_draws_it(ref):
    rt = ref.tournament
    assert ptn.ATTACKS == rt.ATTACKS and ptn.DEFENSES == rt.DEFENSES
    assert ptn.TUNED_DEFENSE == rt.TUNED_DEFENSE
    mine = ptn.tournament_grid(N, T, M, TICKS, seed=3)
    theirs = rt.tournament_grid(N, T, M, TICKS, seed=3)
    assert mine[1] == theirs[1]
    for key, want in theirs[2].items():
        np.testing.assert_array_equal(mine[2][key], want, err_msg=key)
    for b_mine, b_ref in zip(mine[0], theirs[0]):
        assert b_mine.keys() == b_ref.keys()
        for key, want in b_ref.items():
            got = b_mine[key]
            if key == "fault_schedule":
                assert got.down_intervals == want.down_intervals
                assert (got.cold_restart, got.seed, got.horizon) == (
                    want.cold_restart, want.seed, want.horizon)
            elif isinstance(want, np.ndarray):
                np.testing.assert_array_equal(got, want, err_msg=key)
            else:
                assert got == want, key
    offsets = ref.gs.make_gossip_offsets(T, 16, N, seed=3)
    cfg, sc = ptn.tournament_static_config(offsets, T)
    cfg_r, sc_r = rt.tournament_static_config(offsets, T)
    assert cfg.offsets == cfg_r.offsets
    assert all(getattr(sc, f) == getattr(sc_r, f) for f in (
        "sybil_ihave_spam", "sybil_iwant_spam", "sybil_eclipse",
        "sybil_graft_flood", "byzantine_mutation"))


def _reference_cells(ref):
    """The reference's report and each cell's final state, as its
    run_tournament makes them (one batched dispatch)."""
    rt, gs = ref.tournament, ref.gs
    report = rt.run_tournament(N, T, M, TICKS, seed=0)
    offsets = gs.make_gossip_offsets(T, 16, N, seed=0)
    cfg, sc = rt.tournament_static_config(offsets, T)
    builds, _, ctx = rt.tournament_grid(N, T, M, TICKS, seed=0)
    pairs = [gs.make_gossip_sim(cfg, score_cfg=sc, **b) for b in builds]
    params = gs.stack_trees([p[0] for p in pairs])
    state = gs.stack_trees([ref.invariants.attach(p[1]) for p in pairs])
    honest = np.broadcast_to(~ctx["attackers"], (len(builds), N)).copy()
    state, _ = gs.gossip_run_tournament(params, state, TICKS,
                                        rt._cached_step(cfg, sc, True),
                                        honest)
    return report, [tree_to_numpy(gs.index_trees(state, b))
                    for b in range(len(builds))]


def test_run_tournament_equals_the_references(ref):
    want, ref_states = _reference_cells(ref)
    cells = []
    got = ptn.run_tournament(N, T, M, TICKS, seed=0, device="cpu",
                             cells=cells)
    assert got == want
    assert len(cells) == len(ref_states) == 20
    for (row, (_, st), s_ref) in zip(got["rows"], cells, ref_states):
        _assert_tree_equal(s_ref, convert.state_to_numpy(st),
                           f"{row['attack']} x {row['defense']}")
    # non-vacuous: the attacks bit, and the checker found nothing
    assert got["invariant_violations"] == 0
    rows = {(r["attack"], r["defense"]): r for r in got["rows"]}
    assert rows[("eclipse", "reference")]["eclipse_takeover"] > 0
    assert min(r["delivery_fraction"] for r in got["rows"]) > 0
    byz = next(st for (r, (_, st)) in zip(got["rows"], cells)
               if r["attack"] == "byzantine")
    assert float(byz.scores.invalid_deliveries.float().max()) > 0


#: tune_defense at a small size: two coordinates × two values, three
#: attacks
TUNE_SPACE = {"behaviour_penalty_weight": (-5.0, -20.0),
              "graylist_threshold": (-80.0, -65.0)}
TUNE_ATTACKS = ("clean", "eclipse", "cold_restart")


def test_tune_defense_equals_the_references(ref):
    want = ref.tournament.tune_defense(N, T, M, TICKS, space=TUNE_SPACE,
                                       attacks=TUNE_ATTACKS)
    got = ptn.tune_defense(N, T, M, TICKS, space=TUNE_SPACE,
                           attacks=TUNE_ATTACKS, device="cpu")
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    assert len(got["history"]) == len(TUNE_SPACE)


@pytest.mark.parametrize("cells", [2, 6])
def test_batched_step_launches_do_not_grow_with_cells(cells, monkeypatch):
    """The grid's step on a stack of ``cells`` cells calls select_k_bits
    (B3) as often a tick as on one cell, and the receive half runs once
    a tick (the loops here: no receive kernel call at all)."""
    from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
    from go_libp2p_pubsub_tpu_torch.models import invariants as piv
    from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as krecv
    from go_libp2p_pubsub_tpu_torch.ops.kernels import select as kselect

    n = 256
    offsets = pgs.make_gossip_offsets(T, 16, n, seed=0)
    cfg, sc = ptn.tournament_static_config(offsets, T)
    builds, _, _ = ptn.tournament_grid(n, T, M, 40, seed=0)
    builds = builds[:cells]
    pairs = [pgs.make_gossip_sim(cfg, score_cfg=sc, device="cpu", **b)
             for b in builds]
    counts = {"select": 0, "receive": 0}
    orig_sel, orig_recv = kselect.select_k_bits, krecv.receive_update

    def sel(*a, **k):
        counts["select"] += 1
        return orig_sel(*a, **k)

    def recv(*a, **k):
        counts["receive"] += 1
        return orig_recv(*a, **k)
    monkeypatch.setattr(kselect, "select_k_bits", sel)
    monkeypatch.setattr(krecv, "receive_update", recv)
    step = pgs.make_gossip_step(cfg, sc, device="cpu",
                                invariants=piv.InvariantConfig())
    one = []
    for p, s in pairs[:1]:
        pgs.gossip_run(p, piv.attach(s), 12, step, device="cpu")
        one.append(dict(counts))
    counts.update(select=0, receive=0)
    params = pgs.stack_trees([p for p, _ in pairs])
    state = pgs.stack_trees([piv.attach(s) for _, s in pairs])
    pgs.gossip_run_batch(params, state, 12, step, device="cpu")
    assert counts == one[0]
    assert counts["select"] > 0 and counts["receive"] == 0
