"""The port's split receive loops under ``force_split`` and at 24 and 32
candidates, scored and unscored, against the JAX reference's unpadded
XLA step for 30 ticks (every state leaf and the delivered words, bit for
bit); and the packed-word helpers at C = 32, where bit 31 of a word is
an edge, against the reference's uint32 results.
"""

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import plan
from go_libp2p_pubsub_tpu_torch.ops import graph
from go_libp2p_pubsub_tpu_torch.ops.kernels import select as kselect
from test_torch_knobs import one_thread  # noqa: F401  (autouse)
from test_torch_loops import N, T, ref, run_pair  # noqa: F401

WIDE = {
    "force_split_scored": dict(force_split=True),
    "force_split_unscored": dict(force_split=True, sc=None),
    "c24_scored": dict(c=24),
    "c24_unscored": dict(c=24, sc=None),
    "c32_scored": dict(c=32),
    "c32_unscored": dict(c=32, sc=None),
}


@pytest.mark.parametrize("name", sorted(WIDE))
def test_split_loops_match_reference_30_ticks(ref, name):
    case = WIDE[name]
    cfg, sc, params, end, _ = run_pair(ref, case)
    assert plan.receive_path(cfg, sc, params, force_split=case.get(
        "force_split", False)) == plan.SPLIT
    deg = pgs.mesh_degrees(end)
    assert int(deg.max()) >= cfg.d and bool(end.have.any())
    if cfg.n_candidates == 32:
        # a mesh edge on bit 31, the int32 sign bit
        assert bool(((end.mesh >> 31) & 1).any())


def _words(rng, n):
    """u32 words with every bit, bit 31 included, set about half the
    time."""
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


HELPERS = ("expand_bits", "pack_rows", "bit_row", "popcount32",
           "select_k_bits", "select_k_by_priority_bits", "transfer_bits")


@pytest.mark.parametrize("helper", HELPERS)
def test_helpers_at_c32_match_reference(ref, helper):
    import jax.numpy as jnp

    rg = ref.graph
    C, n = 32, 4096
    rng = np.random.default_rng(32)
    bits = _words(rng, n)
    assert (bits >> 31).any()
    if helper == "expand_bits":
        got, want = graph.expand_bits(_t(bits), C), rg.expand_bits(
            jnp.asarray(bits), C)
    elif helper == "pack_rows":
        rows = rng.random((C, n)) < 0.5
        got = graph.pack_rows(torch.from_numpy(rows))
        want = rg.pack_rows(jnp.asarray(rows))
    elif helper == "bit_row":
        got = torch.stack([graph.bit_row(_t(bits), c) for c in range(C)])
        want = jnp.stack([rg.bit_row(jnp.asarray(bits), c)
                          for c in range(C)])
    elif helper == "popcount32":
        got, want = graph.popcount32(_t(bits)), rg.popcount32(
            jnp.asarray(bits))
    elif helper == "select_k_bits":
        kk = rng.integers(0, C + 3, n).astype(np.int32)
        seed = graph.lane_seed(5, 2, 7)
        got = kselect.select_k_bits(_t(bits), torch.from_numpy(kk), C,
                                    seed, n)
        want = rg.select_k_bits(jnp.asarray(bits), jnp.asarray(kk),
                                (C, jnp.int32(5), 2, jnp.uint32(7)))
    elif helper == "select_k_by_priority_bits":
        prio = rng.normal(size=(C, n)).astype(np.float32)
        kk = rng.integers(0, C, n).astype(np.int32)
        got = graph.select_k_by_priority_bits(
            _t(bits), torch.from_numpy(prio), torch.from_numpy(kk))
        want = rg.select_k_by_priority_bits(
            jnp.asarray(bits), jnp.asarray(prio), jnp.asarray(kk))
    else:
        offsets = ref.gs.make_gossip_offsets(T, C, N, seed=1)
        bits = bits[:N]
        got = pgs.transfer_bits(_t(bits), pgs.GossipSimConfig(
            offsets=offsets, n_topics=T))
        want = ref.gs.transfer_bits(jnp.asarray(bits), ref.gs.GossipSimConfig(
            offsets=offsets, n_topics=T))
    got, want = got.numpy(), np.asarray(want)
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want)
    # non-vacuous: the sign bit's row or word is live
    if want.dtype == np.uint32:
        assert (want >> 31).any() or helper == "popcount32"
