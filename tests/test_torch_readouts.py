"""The port's snapshot runners and readouts against the JAX reference's.

Same configs, seeds and build inputs (numpy) go to both packages
(``test_torch_knobs``' families, faulted by ``with_schedule``):

- ``gossip_run_mesh_snapshots``, ``gossip_run_acq_snapshots`` and
  ``gossip_run_rpc_snapshots`` for 6 ticks, each leaf ``[T, ...]`` equal
  to the reference's runner (``mesh_b`` paired; the probe dict with the
  telemetry step too), and the end state equal;
- after 12 ticks: ``first_tick_matrix``, ``reach_by_hops`` (with and
  without an honest mask), ``mesh_matrix``, ``transfer_mask`` (of the mesh
  matrix and of seeded masks), ``mesh_symmetry_fraction`` and
  ``score_snapshot`` (scored, P3 tracking, paired, at a knob point);
- ``gossip_run_rpc_snapshots`` on a replica stack raises ``batched_probe``.

Tolerance: exact (integer leaves bitwise, f32 by bit pattern; the
symmetry fraction is one f32 division of the same integer counts).
``score_snapshot`` copies the reference's operation order term by term, so
its f32 components compare bitwise too.
"""

import numpy as np
import pytest
import torch

import test_torch_loops as loops
from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.interop.export import host_snapshots
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import plan
from go_libp2p_pubsub_tpu_torch.models import telemetry as ptl
from test_torch_gossipsub import _assert_tree_equal
from test_torch_knobs import (  # noqa: F401  (one_thread: autouse)
    FAMILIES,
    arm_port,
    arm_ref,
    build_plain,
    family_point,
    one_thread,
)
from test_torch_knobs_faults import with_schedule
from test_torch_loops_split import P3
from test_torch_rpc_probe import TEL, ref  # noqa: F401
from torch_ref import tree_to_numpy

TICKS = 6


def _runner_pair(ref, name, runner, **step_kw):
    """A runner of each package over the faulted family ``name``: the
    snapshot dicts (the reference's as numpy, the port's on the host) and
    both end states."""
    import jax

    (cfg_r, sc_r, p_r, s_r), (cfg_p, sc_p, p_p, s_p) = with_schedule(
        ref, build_plain(ref, FAMILIES[name]))
    kw_r = dict(step_kw)
    kw_p = dict(step_kw, device="cpu")
    if "telemetry" in step_kw:
        kw_r["telemetry"] = ref.telemetry.TelemetryConfig(**TEL)
        kw_p["telemetry"] = ptl.TelemetryConfig(**TEL)
    out_r, snaps_r = getattr(ref.gs, runner)(
        p_r, s_r, TICKS, jax.jit(ref.gs.make_gossip_step(cfg_r, sc_r,
                                                          **kw_r)))
    out_p, snaps_p = getattr(pgs, runner)(
        p_p, s_p, TICKS, pgs.make_gossip_step(cfg_p, sc_p, **kw_p),
        device="cpu")
    return ({k: np.asarray(v) for k, v in snaps_r.items()},
            host_snapshots(snaps_p), out_r, out_p)


RUNNERS = {
    "mesh_scored": ("gossip_run_mesh_snapshots", "scored", {}),
    "mesh_paired": ("gossip_run_mesh_snapshots", "paired", {}),
    "acq_scored": ("gossip_run_acq_snapshots", "scored", {}),
    "acq_paired_unscored": ("gossip_run_acq_snapshots", "paired_unscored",
                            {}),
    "acq_telemetry": ("gossip_run_acq_snapshots", "unscored",
                      dict(telemetry=True)),
    "rpc_full": ("gossip_run_rpc_snapshots", "full", dict(rpc_probe=True)),
    "rpc_telemetry": ("gossip_run_rpc_snapshots", "scored",
                      dict(rpc_probe=True, telemetry=True)),
}


@pytest.mark.parametrize("case", sorted(RUNNERS))
def test_snapshot_runners_match_reference(ref, case):
    runner, name, step_kw = RUNNERS[case]
    want, got, out_r, out_p = _runner_pair(ref, name, runner, **step_kw)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape[0] == TICKS, k
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    if name.startswith("paired") and runner != "gossip_run_rpc_snapshots":
        assert "mesh_b" in got
    if runner == "gossip_run_acq_snapshots":
        assert got["have"].shape == (TICKS, *out_p.have.shape)
        assert got["mesh"].shape == (TICKS, out_p.mesh.shape[0])
    _assert_tree_equal(tree_to_numpy(out_r), convert.state_to_numpy(out_p),
                       "end state")


def test_rpc_runner_refuses_a_replica_stack():
    from test_torch_port_rules import _stack, _step

    with pytest.raises(plan.SliceRefusal) as err:
        pgs.gossip_run_rpc_snapshots(*_stack(), 1, _step(rpc_probe=True),
                                     device="cpu")
    assert err.value.name == "batched_probe"


# -- the readouts -------------------------------------------------------------

def _ran(ref, built, ticks=12):
    """Both packages' sims stepped ``ticks`` heartbeats (states equal)."""
    import jax

    (cfg_r, sc_r, p_r, s_r), (cfg_p, sc_p, p_p, s_p) = built
    step_r = jax.jit(ref.gs.make_gossip_step(cfg_r, sc_r))
    step_p = pgs.make_gossip_step(cfg_p, sc_p, device="cpu")
    for _ in range(ticks):
        s_r = step_r(p_r, s_r)[0]
        s_p = step_p(p_p, s_p)[0]
    _assert_tree_equal(tree_to_numpy(s_r), convert.state_to_numpy(s_p),
                       "state")
    return (cfg_r, sc_r, p_r, s_r), (cfg_p, sc_p, p_p, s_p)


def _eq(got, want, where):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    np.testing.assert_array_equal(
        np.ascontiguousarray(np.atleast_1d(got)).view(np.uint8),
        np.ascontiguousarray(np.atleast_1d(want)).view(np.uint8),
        err_msg=where)


@pytest.mark.parametrize("name", ["scored", "paired", "ihave_spam"])
def test_delivery_and_mesh_readouts_match_reference(ref, name):
    import jax.numpy as jnp

    (cfg_r, _, p_r, s_r), (cfg_p, _, p_p, s_p) = _ran(
        ref, with_schedule(ref, build_plain(ref, FAMILIES[name])))
    m = int(p_p.publish_tick.shape[0])
    _eq(pgs.first_tick_matrix(s_p, m), ref.gs.first_tick_matrix(s_r, m),
        "first_tick_matrix")
    _eq(pgs.reach_by_hops(p_p, s_p, 8), ref.gs.reach_by_hops(p_r, s_r, 8),
        "reach_by_hops")
    honest = ~p_p.sybil.numpy() if p_p.sybil is not None else \
        np.arange(p_p.subscribed.shape[0]) % 3 != 0
    _eq(pgs.reach_by_hops(p_p, s_p, 8, mask=torch.from_numpy(honest)),
        ref.gs.reach_by_hops(p_r, s_r, 8, mask=jnp.asarray(honest)),
        "reach_by_hops honest")
    mm_p = pgs.mesh_matrix(s_p, cfg_p)
    _eq(mm_p, ref.gs.mesh_matrix(s_r, cfg_r), "mesh_matrix")
    _eq(pgs.transfer_mask(mm_p, cfg_p),
        ref.gs.transfer_mask(ref.gs.mesh_matrix(s_r, cfg_r), cfg_r),
        "transfer_mask")
    rng = np.random.default_rng(7)
    mask = rng.random(tuple(mm_p.shape)) < 0.3
    _eq(pgs.transfer_mask(torch.from_numpy(mask), cfg_p),
        ref.gs.transfer_mask(jnp.asarray(mask), cfg_r), "transfer_mask")
    frac = pgs.mesh_symmetry_fraction(s_p, cfg_p)
    _eq(frac, ref.gs.mesh_symmetry_fraction(s_r, cfg_r),
        "mesh_symmetry_fraction")
    assert 0.0 < float(frac) <= 1.0


SCORE_CASES = {
    "scored": lambda ref: with_schedule(
        ref, build_plain(ref, FAMILIES["scored"])),
    "paired": lambda ref: build_plain(ref, FAMILIES["paired"]),
    "full": lambda ref: build_plain(ref, FAMILIES["full"]),
    "p3": lambda ref: loops.build(ref, dict(sc=P3, per_tick=True)),
    "knob_point": "knobs",
}


@pytest.mark.parametrize("name", sorted(SCORE_CASES))
def test_score_snapshot_matches_reference(ref, name):
    build = SCORE_CASES[name]
    if build == "knobs":
        family = FAMILIES["ihave_spam"]
        r_sim, p_sim = build_plain(ref, family)
        point = family_point(p_sim[0], True)
        built = (arm_ref(ref, r_sim, sim_knobs=point, px=family[2]),
                 arm_port(p_sim, sim_knobs=point, px=family[2]))
    else:
        built = build(ref)
    (cfg_r, sc_r, p_r, s_r), (cfg_p, sc_p, p_p, s_p) = _ran(ref, built)
    want = ref.gs.score_snapshot(sc_r, p_r, s_r)
    got = pgs.score_snapshot(sc_p, p_p, s_p)
    assert set(got) == set(want)
    for k in want:
        _eq(got[k], want[k], k)
    assert (got["score"] != 0).any()
    if name == "paired":
        assert "p1b_time_in_mesh" in got
    if name == "p3":
        assert (got["p3_mesh_delivery_deficit"] != 0).any()
