"""The PyTorch port's packed-word primitives against the JAX reference
(ops/graph.py and the select kernel in interpret mode).  Exact: every
comparison is bit for bit."""

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch.ops import graph as pg
from go_libp2p_pubsub_tpu_torch.ops.kernels import select as pselect
from torch_ref import imported_reference


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        yield r


def _words(rng, shape, bits=32):
    a = rng.integers(0, 1 << bits, size=shape, dtype=np.uint64)
    return a.astype(np.uint32)


def _t(a):
    """numpy uint32 -> int32 tensor of the same bits."""
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _u(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("tick,phase,salt,stride", [
    (0, 1, 0, None), (7, 6, 12345, 1000), (123456, 3, 0xDEADBEEF, 997),
    (2 ** 31 - 5, 4, 0xFFFFFFFF, 2 ** 31 + 7)])
def test_lane_uniform_bit_identical(ref, tick, phase, salt, stride):
    import jax.numpy as jnp

    shape = (16, 1000)
    want = np.asarray(ref.graph.lane_uniform(
        shape, jnp.int32(tick) if tick < 2 ** 31 else jnp.uint32(tick),
        phase, jnp.uint32(salt), stride=stride))
    got = pg.lane_uniform(shape, tick, phase, salt, stride=stride).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  want.view(np.uint32))
    seed = np.asarray(ref.graph.lane_seed(
        jnp.uint32(tick), phase, jnp.uint32(salt)))
    assert pg.lane_seed(tick, phase, salt) == int(seed)


def test_lane_uniform_flat_shape(ref):
    import jax.numpy as jnp

    want = np.asarray(ref.graph.lane_uniform((3, 5, 7), jnp.int32(9), 2,
                                             jnp.uint32(77)))
    got = pg.lane_uniform((3, 5, 7), 9, 2, 77).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_lane_uniform_cols_slice_the_field():
    full = pg.lane_uniform((16, 500), 3, 5, 99, stride=500)
    cols = torch.tensor([0, 17, 250, 499])
    sub = pg.lane_uniform((16, 500), 3, 5, 99, stride=500, cols=cols)
    assert torch.equal(full[:, cols], sub)


def test_pack_expand_popcount(ref):
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    w = _words(rng, (1000,))
    w[:5] = [0, 0xFFFFFFFF, 0x80000000, 1, 0x7FFFFFFF]
    np.testing.assert_array_equal(
        pg.popcount32(_t(w)).numpy(),
        np.asarray(ref.graph.popcount32(jnp.asarray(w))))
    for c in (8, 16, 32):
        e = pg.expand_bits(_t(w), c)
        np.testing.assert_array_equal(
            e.numpy(), np.asarray(ref.graph.expand_bits(jnp.asarray(w), c)))
        np.testing.assert_array_equal(
            _u(pg.pack_rows(e)),
            np.asarray(ref.graph.pack_rows(jnp.asarray(e.numpy()))))
        np.testing.assert_array_equal(
            pg.bit_row(_t(w), c - 1).numpy(),
            np.asarray(ref.graph.bit_row(jnp.asarray(w), c - 1)))


@pytest.mark.parametrize("m", [1, 32, 40, 77])
def test_pack_unpack_count(ref, m):
    import jax.numpy as jnp

    rng = np.random.default_rng(m)
    bits = rng.random((300, m)) < 0.3
    want = np.asarray(ref.graph.pack_bits(jnp.asarray(bits)))
    got = pg.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(_u(got), want)
    np.testing.assert_array_equal(
        _u(pg.pack_bits_pm(torch.from_numpy(bits))),
        np.asarray(ref.graph.pack_bits_pm(jnp.asarray(bits))))
    np.testing.assert_array_equal(pg.unpack_bits(got, m).numpy(), bits)
    pm = np.ascontiguousarray(want.T)
    np.testing.assert_array_equal(
        pg.count_bits_per_position(_t(pm), m).numpy(),
        np.asarray(ref.graph.count_bits_per_position(jnp.asarray(pm), m)))
    np.testing.assert_array_equal(
        pg.popcount_words(_t(pm)).numpy(),
        np.asarray(ref.graph.popcount_words(jnp.asarray(pm))).astype(
            np.int32))


@pytest.mark.parametrize("n_classes,degree,n,seed", [
    (4, 16, 1024, 0), (100, 16, 1_000_000, 0), (1, 8, 101, 7)])
def test_circulant_offsets(ref, n_classes, degree, n, seed):
    np.testing.assert_array_equal(
        pg.make_circulant_offsets(n_classes, degree, n, seed),
        ref.graph.make_circulant_offsets(n_classes, degree, n, seed))


def _select_case(c, n=1000, seed=0):
    rng = np.random.default_rng(seed + c)
    elig = _words(rng, (n,), bits=c) & _words(rng, (n,), bits=c)
    k = rng.integers(0, c + 4, size=n).astype(np.int32)
    k[:10] = 0
    return elig, k


@pytest.mark.parametrize("c", [8, 16, 32])
def test_select_k_bits_plain_matches_reference(ref, c):
    import jax.numpy as jnp

    n = 1000
    elig, k = _select_case(c, n)
    tick, phase, salt = 11, 4, 0xC0FFEE
    seed = pg.lane_seed(tick, phase, salt)
    got = _u(pselect.select_k_bits_plain(_t(elig), torch.from_numpy(k), c,
                                         seed, n))
    want_xla = np.asarray(ref.graph.select_k_bits(
        jnp.asarray(elig), jnp.asarray(k),
        (c, jnp.int32(tick), phase, jnp.uint32(salt), n)))
    want_pallas = np.asarray(ref.select.select_k_bits_pallas(
        jnp.asarray(elig), jnp.asarray(k), jnp.uint32(seed), c,
        interpret=True, stride=n))
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got, want_pallas)
    # non-vacuous: some selections are partial, some k exceed the pool
    pc = pg.popcount32(_t(elig)).numpy()
    assert ((k > 0) & (k < pc)).any() and (k > pc).any()
    # the wrapper runs the plain version on CPU tensors
    np.testing.assert_array_equal(
        _u(pselect.select_k_bits(_t(elig), torch.from_numpy(k), c, seed,
                                 n)), got)


def test_select_k_by_priority_bits_matches_reference(ref):
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    c, n = 16, 800
    elig = _words(rng, (n,), bits=c)
    prio = rng.normal(size=(c, n)).astype(np.float32)
    prio[:, :50] = 0.5                       # ties broken by the tiebreak
    tb = rng.random((c, n)).astype(np.float32)
    k = rng.integers(0, c, size=n).astype(np.int32)
    got = pg.select_k_by_priority_bits(
        _t(elig), torch.from_numpy(prio), torch.from_numpy(k),
        tiebreak=torch.from_numpy(tb))
    want = ref.graph.select_k_by_priority_bits(
        jnp.asarray(elig), jnp.asarray(prio), jnp.asarray(k),
        tiebreak=jnp.asarray(tb))
    np.testing.assert_array_equal(_u(got), np.asarray(want))
    np.testing.assert_array_equal(
        pg.ranks_desc(torch.from_numpy(prio)).numpy(),
        np.asarray(ref.graph.ranks_desc(jnp.asarray(prio))))
