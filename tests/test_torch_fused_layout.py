"""The fused-window kernel's indexing (``csrc/fused.cu``), held in numpy.

The kernel runs only on the card; what it computes with its indices is
restated here and held against direct indexing, for the shapes and peer
counts the repository runs:

- each block's peer range (one block a multiprocessor, P peers each, a
  multiple of 4; the last block the ragged rest) and its threads' 4-peer
  groups: every peer exactly once;
- the read of a group's four senders' ctrl bytes at q = p + o mod N as
  two aligned words and a funnel shift, from a stage row with its halo
  (entries 0..2 again at N..N+2): the bytes of peers q..q+3 mod N for
  every q, across the wrap, inside the padded row;
- the ctrl word of four senders (one byte a peer, built a nibble at a
  time) and the receiver's handshake masks taken back out of it, against
  ``receive.ctrl_bytes``, and two such masks packed into a front word;
- the front's on-chip bytes against a block's shared-memory budget for
  every shape and N the repository runs (so no configuration that runs
  today is refused or moved to the device-memory front).

Exact: integer indices and words.
"""

import re

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch.ops.kernels import fused as pfused
from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as prc

#: peer counts: tiny, off the 4-peer groups, below one block's threads'
#: groups, the tests' and the main path's
NS = (1, 2, 3, 5, 37, 1001, 4093, 4094, 4096, 8192, 100_000, 1_024_000,
      1 << 20)
HALO = 3


def _groups(plan: dict, n: int):
    """(block, thread, p0, valid peers) of every group the kernel's loops
    visit: block b's groups g = thread, thread + THREADS, ..."""
    P, T = plan["peers"], plan["threads"]
    for b in range(plan["blocks"]):
        left = n - b * P
        groups = (min(left, P) + 3) // 4
        for g in range(groups):
            p0 = b * P + 4 * g
            yield b, g % T, p0, min(4, n - p0)


@pytest.mark.parametrize("sms", [132, 3])
@pytest.mark.parametrize("n", NS)
def test_block_ranges_cover_each_peer_once(n, sms):
    plan = pfused.launch_plan(1, n, sms=sms)
    P = plan["peers"]
    assert P % 4 == 0 and P * sms >= n and plan["blocks"] <= sms
    assert (plan["blocks"] - 1) * P < n <= plan["blocks"] * P
    seen = np.zeros(n, dtype=np.int64)
    if n > 200_000:
        # vectorised: each block's groups, then the last block's tail
        starts = np.arange(0, n, 4)
        valid = np.minimum(4, n - starts)
        assert np.all(starts // P < plan["blocks"])
        for i in range(4):
            np.add.at(seen, starts[valid > i] + i, 1)
    else:
        per_thread = np.zeros((plan["blocks"], plan["threads"]), int)
        for b, t, p0, nv in _groups(plan, n):
            assert p0 % 4 == 0 and b * P <= p0 < (b + 1) * P
            assert 1 <= nv <= 4 and (nv == 4 or p0 + nv == n)
            seen[p0:p0 + nv] += 1
            per_thread[b, t] += 1
        assert per_thread.max() <= -(-(-(-P // 4)) // plan["threads"])
    assert np.all(seen == 1)


def _stage_row(vals: np.ndarray, stride: int, rng) -> np.ndarray:
    """A stage row as the kernel writes it: entries 0..N-1, the halo
    N..N+2 (peer k mod N, written by the group of peer 0), the padding
    left as it was (random)."""
    n = len(vals)
    row = rng.integers(0, 256, stride, dtype=np.uint64).astype(vals.dtype)
    row[:n] = vals
    for k in range(HALO):
        row[n + k] = vals[k if k < n else 0]
    return row


def _funnel4(row: np.ndarray, q: int) -> list[int]:
    """The kernel's read of bytes q..q+3: the aligned words at q & ~3 and
    the next, funnel-shifted right by 8 (q & 3) bits."""
    words = row.view("<u4")
    lo, hi = int(words[q >> 2]), int(words[(q >> 2) + 1])
    x = ((hi << 32 | lo) >> (8 * (q & 3))) & 0xFFFFFFFF
    return [(x >> (8 * i)) & 0xFF for i in range(4)]


@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 7, 37, 1001, 4093, 4096])
def test_funnel_read_of_four_ctrl_bytes_across_the_wrap(n):
    rng = np.random.default_rng(n)
    sc, sp = pfused.stage_strides(n)
    assert sc % 128 == 0 and sp % 32 == 0 and sc >= n + 8 and sp >= n + 8
    vals = rng.integers(0, 256, n).astype(np.uint8)
    row = _stage_row(vals, sc, rng)
    for q in range(n):
        assert (q & ~3) + 7 < sc
        assert _funnel4(row, q) == [int(vals[(q + i) % n]) for i in range(4)]
    # a receiver group p0..p0+3 reads q = p0 + o (mod N) for every offset
    for p0 in range(0, n, 4):
        for o in {0, 1, n - 1, n // 2, max(n - 3, 0)}:
            q = p0 + o % n
            q = q - n if q >= n else q
            got = _funnel4(row, q)
            for i in range(min(4, n - p0)):
                assert got[i] == vals[(p0 + i + o) % n]
    # the payload rows: words q..q+3 with the same halo, never past the row
    words = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    prow = _stage_row(words, sp, rng)
    for q in range(n):
        assert q + 3 < sp
        assert list(prow[q:q + 4]) == [words[(q + i) % n] for i in range(4)]


def _masks(rng, c, n=4):
    return rng.integers(0, 1 << c, n, dtype=np.int64).astype(np.uint32)


def _ctrl_words(c, flags):
    """The kernel's ctrl words of one 4-peer group: per four edges, each
    flag's bytes of the four peers (byte_perm), the nibble of the edges,
    then each edge's bit of each flag into its peer's byte."""
    out = []
    for c0 in range(0, c, 4):
        byte, nib = c0 >> 3, 4 if c0 & 4 else 0
        m = {pos: sum(((int(f[i]) >> (8 * byte)) & 0xFF) << (8 * i)
                      for i in range(4)) >> nib & 0x0F0F0F0F
             for pos, f in flags}
        for k in range(4):
            out.append(sum(((v >> k) & 0x01010101) << pos
                           for pos, v in m.items()))
    return out


@pytest.mark.parametrize("c", [8, 16])
def test_ctrl_word_and_handshake_masks_match_ctrl_bytes(c):
    rng = np.random.default_rng(c)
    for _ in range(50):
        out, tgt, graft, drop, a = (_masks(rng, c) for _ in range(5))
        flags = [(prc.CTRL_OUT, out), (prc.CTRL_TGT, tgt),
                 (prc.CTRL_GRAFT, graft), (prc.CTRL_DROP, drop),
                 (prc.CTRL_A, a), (prc.CTRL_ADV, tgt)]
        want = prc.ctrl_bytes(c, **{
            name: torch.from_numpy(v.view(np.int32)) for name, (_, v) in zip(
                ("out", "tgt", "graft", "drop", "a", "adv"), flags)})
        words = _ctrl_words(c, flags)
        got = np.array([[(w >> (8 * i)) & 0xFF for i in range(4)]
                        for w in words], dtype=np.uint8)
        np.testing.assert_array_equal(got, want.numpy())
        # the receiver's masks: edge j's bit of each peer's byte, gathered
        # into byte lanes (j < 8 low, else high) and taken out per peer
        for pos, f in flags[2:5]:
            lo = hi = 0
            for j, x in enumerate(words):
                bits = (x >> pos) & 0x01010101
                if j < 8:
                    lo |= bits << j
                else:
                    hi |= bits << (j - 8)
            for i in range(4):
                m = ((lo >> (8 * i)) & 0xFF) | (((hi >> (8 * i)) & 0xFF) << 8)
                assert m == int(f[i]), (pos, i)
        # the front keeps two such C-bit masks a word (grafts | dropped <<
        # 16): at C = 16 the high mask's bit 15 is the word's top bit
        gd = (graft.astype(np.uint64) | drop.astype(np.uint64) << 16)
        assert np.all(gd < 1 << 32)
        np.testing.assert_array_equal(gd & 0xFFFF, graft)
        np.testing.assert_array_equal(gd >> 16, drop)


#: (C, W, N, telemetry latency buckets or None) of every fused window the
#: repository runs: the resident main path and its chip_smoke.py phases
#: (5e exact-k, 5j faulted, 5m telemetry L = 16, 7-9) and kernel_ab.py's
#: windows at 1,048,576 peers; the card tests' windows (tests/
#: test_torch_cuda.py: 4,096 and 8,192 peers at C in {8, 16}, W in
#: {1, 2}, telemetry L = 16; the range-edge cases)
RUN_SHAPES = (
    [(16, 1, 1 << 20, lat) for lat in (None, 16)]
    + [(c, w, n, lat) for c in (8, 16) for w in (1, 2)
       for n in (37, 1001, 4093, 4094, 4096, 8192) for lat in (None, 16)])


def _tel_rows(lat):
    return 0 if lat is None else (len(prc.TEL_ROWS) + lat
                                  + pfused.TEL_FUSED_EXTRA)


@pytest.mark.parametrize("c,w,n,lat", RUN_SHAPES)
def test_front_fits_on_chip_for_every_run_shape(c, w, n, lat):
    plan = pfused.launch_plan(w, n, _tel_rows(lat))
    front = pfused.front_words(w) * 4 * plan["peers"]
    tel = -(-_tel_rows(lat) * 4 // 16) * 16
    assert front + tel <= pfused.H100["smem_optin"]
    assert not plan["front_global"]
    assert plan["smem_bytes"] == front + tel


def test_front_moves_to_device_memory_only_past_the_budget():
    # the main path: 7,944 peers a block, 190,656 B of front (186 KB)
    plan = pfused.launch_plan(1, 1 << 20, _tel_rows(16))
    assert plan["peers"] == 7944 and plan["blocks"] == 132
    assert plan["smem_bytes"] == 7944 * 24 + 112
    # W = 2 at 1M peers (32 B/peer) and N past ~1.28M at W = 1 do not fit
    assert pfused.launch_plan(2, 1 << 20)["front_global"]
    assert pfused.launch_plan(1, 1_300_000)["front_global"]
    assert not pfused.launch_plan(1, 1_270_000)["front_global"]
    assert pfused.launch_plan(2, 1 << 20)["smem_bytes"] == 0


#: constants the Python side restates, with their csrc/fused.cu definitions
C_CONSTANTS = {
    "THREADS": (r"constexpr int THREADS = (\d+);", pfused.THREADS),
    "MAX_WINDOW": (r"constexpr int MAX_WINDOW = (\d+);",
                   pfused.plan.MAX_WINDOW),
    "front words": (r"constexpr int front_words\(int w\) \{ return 2 \* w "
                    r"\+ (\d+); \}", pfused.front_words(0)),
}


@pytest.mark.parametrize("name", sorted(C_CONSTANTS))
def test_restated_constants_match_the_kernel_source(name):
    pattern, value = C_CONSTANTS[name]
    src = (pfused._build.CSRC / "fused.cu").read_text()
    found = {int(m) for m in re.findall(pattern, src)}
    assert found == {value}
