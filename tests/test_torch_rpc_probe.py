"""The port's RPC probe (``make_gossip_step(rpc_probe=True)``) against the
JAX reference's, on every per-tick family the port steps.

Same configs, seeds and build inputs (numpy) go to both packages, at the
earlier slices' test shapes (``test_torch_knobs``' families: scored,
unscored, the four attacks and the IWANT flood, the full variant with
flood publishing, paired scored and unscored; the receive loops'
byzantine, P3 and C = 24 cases; the delayed families of
``test_torch_delays_steps`` built with ``delays_probe=True``), for 6
ticks:

- every probe leaf (the attempt masks, content and fault words; paired
  the slot-B masks and the slot-split payload; delayed the arrival
  masks) equals the reference's snapshot, dtype and bits;
- the probe step's state and delivered words equal the reference's, and
  the port's probe-free step's: the probe is a readout;
- each family clean and under a fault schedule.

With telemetry, knobs and the checker, on the receive loops and on the
delay lines: ``test_torch_rpc_probe_paths.py`` (it shares ``probe_pair``).

Tolerance: exact (words, bools and counters bitwise; frames as
``test_torch_telemetry`` compares them).
"""

import numpy as np
import pytest

from go_libp2p_pubsub_tpu_torch import convert
from go_libp2p_pubsub_tpu_torch.interop.export import host_snapshots
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import invariants as piv
from go_libp2p_pubsub_tpu_torch.models import telemetry as ptl
from test_torch_gossipsub import _assert_tree_equal
from test_torch_knobs import (  # noqa: F401  (one_thread: autouse)
    FAMILIES,
    IWANT_FLOOD,
    build_plain,
    one_thread,
)
from test_torch_knobs_faults import with_schedule
from test_torch_receive import _np
from test_torch_telemetry import assert_frames_equal
from torch_ref import imported_reference, tree_to_numpy

TICKS = 6
TEL = dict(latency_hist=True, latency_buckets=16)
#: short delays so arrivals land inside the 6 ticks
DELAYS = dict(base=1, jitter=2, k_slots=4)


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        import go_libp2p_pubsub_tpu.models.delays as rdl
        import go_libp2p_pubsub_tpu.models.faults as rfl
        import go_libp2p_pubsub_tpu.models.invariants as riv
        import go_libp2p_pubsub_tpu.models.knobs as rkn
        import go_libp2p_pubsub_tpu.models.telemetry as rtl
        r.delays, r.faults, r.invariants = rdl, rfl, riv
        r.knobs, r.telemetry = rkn, rtl
        yield r


def assert_snaps_equal(want: dict, got: dict, where: str):
    """The reference's probe dict (arrays) against the port's (tensors):
    the same keys, every leaf the same dtype and bits (int32 words as the
    uint32 words they hold)."""
    assert set(got) == set(want), (where, sorted(set(got) ^ set(want)))
    got = host_snapshots(got)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype, f"{where}.{k}: {got[k].dtype}"
        np.testing.assert_array_equal(got[k], w, err_msg=f"{where}.{k}")


def probe_pair(ref, ref_sim, port_sim, *, telemetry=None, invariants=False,
               force_split=False, ticks=TICKS):
    """Step the reference's and the port's probe steps and the port's
    probe-free step ``ticks`` times: the snapshots, states, delivered
    words (and frames) equal; the port's last snapshot."""
    import jax

    cfg_r, sc_r, p_r, s_r = ref_sim
    cfg_p, sc_p, p_p, s_p = port_sim
    _assert_tree_equal(tree_to_numpy(p_r), convert.params_to_numpy(p_p),
                       "params")
    icfg_r = icfg_p = None
    if invariants:
        icfg_r, icfg_p = ref.invariants.InvariantConfig(), \
            piv.InvariantConfig()
        s_r, s_p = ref.invariants.attach(s_r), piv.attach(s_p)
    tcfg_r = tcfg_p = None
    if telemetry is not None:
        tcfg_r = ref.telemetry.TelemetryConfig(**telemetry)
        tcfg_p = ptl.TelemetryConfig(**telemetry)
    step_r = jax.jit(ref.gs.make_gossip_step(
        cfg_r, sc_r, rpc_probe=True, telemetry=tcfg_r, invariants=icfg_r,
        force_split=force_split))
    kw = dict(device="cpu", telemetry=tcfg_p, invariants=icfg_p,
              force_split=force_split)
    step_p = pgs.make_gossip_step(cfg_p, sc_p, rpc_probe=True, **kw)
    step_plain = pgs.make_gossip_step(cfg_p, sc_p, **kw)
    s_plain = s_p
    snap = None
    for t in range(ticks):
        out_r = step_r(p_r, s_r)
        out_p = step_p(p_p, s_p)
        out_plain = step_plain(p_p, s_plain)
        assert len(out_p) == len(out_r) == len(out_plain) + 1
        assert_snaps_equal(out_r[-1], out_p[-1], f"tick {t}")
        s_r, s_p, s_plain = out_r[0], out_p[0], out_plain[0]
        got = convert.state_to_numpy(s_p)
        _assert_tree_equal(tree_to_numpy(s_r), got, f"tick {t}")
        # the probe-free step carries the probe line unread: every other
        # leaf is the same
        _assert_tree_equal(dict(convert.state_to_numpy(s_plain),
                                probe_line=None), got,
                           f"probe-free tick {t}")
        np.testing.assert_array_equal(_np(out_p[1]), np.asarray(out_r[1]),
                                      err_msg=f"tick {t}")
        np.testing.assert_array_equal(_np(out_p[1]), _np(out_plain[1]))
        if telemetry is not None:
            fr = convert.frame_to_numpy(out_p[2])
            assert_frames_equal(fr, tree_to_numpy(out_r[2]), f"tick {t}")
            assert_frames_equal(fr, convert.frame_to_numpy(out_plain[2]),
                                f"probe-free tick {t}")
        snap = out_p[-1]
    return snap


# -- every family, clean and faulted -----------------------------------------

FAMILY_CASES = dict(FAMILIES, iwant_flood=IWANT_FLOOD)


@pytest.mark.parametrize("faulted", [False, True],
                         ids=["clean", "faulted"])
@pytest.mark.parametrize("name", sorted(FAMILY_CASES))
def test_probe_matches_reference(ref, name, faulted):
    built = build_plain(ref, FAMILY_CASES[name])
    if faulted:
        built = with_schedule(ref, built)
    snap = probe_pair(ref, *built)
    if faulted:
        # the schedule shows in the fault words
        assert (~snap["alive"]).any() or not snap["send_ok"].all()
    if name == "full":
        # flood-publish sends are captured: the flood word is live
        assert snap["flood"].any()
    if name.startswith("paired"):
        assert {"fwd_b", "graft_b", "prune_b", "fresh_a",
                "fresh_b"} <= set(snap)
