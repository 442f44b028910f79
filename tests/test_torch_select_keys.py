"""B3's selection by integer keys (``csrc/lane.cuh`` ``select_k``, used by
the select kernel, B2's exact-k draws and B1's exact-k targets), written
here in PyTorch as the CUDA code computes it, against
``ops.graph.select_k_bits`` given the same lane_uniform priorities.

The formulation: no draw where k <= 0 or no bit is eligible (0), or where
k covers every eligible bit (elig itself); else each eligible bit i keys
2^29 | (h_i >> 8) << 5 | (31 - i) from its lane hash h_i (an ineligible
one 0), the keys are sorted in descending order, and the bits kept are
those the k largest keys name in their low five bits (31 - i).  The
priority (h >> 8) * 2^-24 is exact in f32, so the key order is the
priority order with ties to the lower index.  The CUDA kernel
cannot run here; this fixes the arithmetic it follows, and the card tests
(``test_torch_cuda.py``) hold the kernel to the plain version.

Tolerance: exact (packed words compared as integers).
"""

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch.ops import graph

MASK32 = 0xFFFFFFFF


def lane_hash(c: int, n: int, seed: int, stride: int) -> torch.Tensor:
    """h [C, N] (int64 holding u32) of lane c * stride + p."""
    lane = (torch.arange(c, dtype=torch.int64)[:, None] * stride
            + torch.arange(n, dtype=torch.int64)[None, :]) & MASK32
    return graph.fmix32(graph.to_i32(lane ^ seed)).to(torch.int64) & MASK32


def select_by_keys(elig: torch.Tensor, k: torch.Tensor, h: torch.Tensor,
                   c: int) -> torch.Tensor:
    """The kernel's integer-key selection: int32 [N] from elig, k int32
    [N] and the lane hashes h [C, N]."""
    bits = elig.to(torch.int64) & ((1 << c) - 1)
    on = ((bits[None, :] >> torch.arange(c)[:, None]) & 1) == 1
    idx = torch.arange(c, dtype=torch.int64)[:, None]
    key = torch.where(on, (1 << 29) | ((h >> 8) << 5) | (31 - idx),
                      torch.zeros_like(h))
    count = on.sum(0)
    kk = k.to(torch.int64)
    # sorted descending; the first k keys (0 < k < count: all eligible)
    # name their bits in the low five bits
    srt = key.sort(dim=0, descending=True).values
    first = idx < kk[None, :]
    named = torch.where(first, 1 << (31 - (srt & 31)), 0)
    sel = named.sum(0)
    sel = torch.where(kk <= 0, 0, torch.where(kk >= count, bits, sel))
    return graph.to_i32(sel)


def reference(elig, k, c, seed, stride):
    n = elig.shape[0]
    rand = graph.lane_uniform_from_seed((c, n), seed, stride=stride)
    return graph.select_k_bits(elig, k, rand)


def _check(elig, k, c, seed=0x2545F491, stride=None):
    n = elig.shape[0]
    stride = n if stride is None else stride
    got = select_by_keys(elig, k, lane_hash(c, n, seed, stride), c)
    want = reference(elig, k, c, seed, stride)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kk", list(range(-1, 10)))
def test_every_8_bit_word(kk):
    """Every 8-bit eligibility word at C = 8, each k in -1..9."""
    elig = torch.arange(256, dtype=torch.int32)
    _check(elig, torch.full((256,), kk, dtype=torch.int32), 8)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_random_16_bit_words(seed):
    """Random 16-bit words at C = 16 with random k (-1..C + 2), at a
    lane stride apart from N."""
    rng = np.random.default_rng(seed)
    n = 5000
    elig = torch.from_numpy(rng.integers(0, 1 << 16, n).astype(np.int32))
    k = torch.from_numpy(rng.integers(-1, 19, n).astype(np.int32))
    _check(elig, k, 16, seed=int(rng.integers(0, 1 << 32)),
           stride=n + 3 * seed)


def _priorities(h: torch.Tensor) -> torch.Tensor:
    """lane_uniform's f32 priorities of the hashes h."""
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


@pytest.mark.parametrize("seed", [0, 1])
def test_ties_go_to_the_lower_index(seed):
    """Hashes with equal h >> 8 on two lanes i < j of every peer (the
    lane hash rarely ties: the hashes are built here and both sides take
    them): against select_k_bits on the same priorities at random k, and
    with only the pair eligible and k = 1 the lower index wins."""
    rng = np.random.default_rng(seed)
    c, n = 16, 4000
    h = torch.from_numpy(rng.integers(0, 1 << 32, size=(c, n),
                                      dtype=np.uint64).astype(np.int64))
    i = torch.from_numpy(rng.integers(0, c - 1, size=n))
    j = i + 1 + torch.from_numpy(rng.integers(0, c, size=n)) % (c - 1 - i)
    cols = torch.arange(n)
    low = torch.from_numpy(rng.integers(0, 256, size=n))
    h[j, cols] = (h[i, cols] & ~0xFF) | low
    assert torch.equal(h[i, cols] >> 8, h[j, cols] >> 8)
    pair = (1 << i) | (1 << j)
    elig = graph.to_i32(torch.from_numpy(
        rng.integers(0, 1 << c, size=n)) | pair)
    k = torch.from_numpy(rng.integers(1, c, size=n).astype(np.int32))
    want = graph.select_k_bits(elig, k, _priorities(h))
    assert torch.equal(select_by_keys(elig, k, h, c), want)
    one = torch.ones(n, dtype=torch.int32)
    got = select_by_keys(graph.to_i32(pair), one, h, c)
    assert torch.equal(got, graph.to_i32(1 << i))
    assert torch.equal(
        got, graph.select_k_bits(graph.to_i32(pair), one, _priorities(h)))


@pytest.mark.parametrize("c", [8, 16, 32])
def test_k_at_or_above_the_count_keeps_every_eligible_bit(c):
    """k >= popcount(elig): elig itself, without a draw; k <= 0: none."""
    rng = np.random.default_rng(c)
    n = 2000
    elig = torch.from_numpy(rng.integers(0, 1 << 31, n).astype(np.int32))
    if c < 32:
        elig = elig & ((1 << c) - 1)
    count = graph.popcount32(elig)
    k = (count + torch.from_numpy(rng.integers(0, 3, n))).to(torch.int32)
    got = select_by_keys(elig, k, lane_hash(c, n, 5, n), c)
    assert torch.equal(got, elig)
    _check(elig, k, c, seed=5)
    zero = torch.zeros(n, dtype=torch.int32)
    assert torch.equal(select_by_keys(elig, zero - 1,
                                      lane_hash(c, n, 5, n), c), zero)
