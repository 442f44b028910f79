"""Packed-word primitives of the simulator, in PyTorch.

Counterpart of ``go_libp2p_pubsub_tpu/ops/graph.py``.  Packed u32 words
are ``torch.int32`` tensors holding the u32 bit patterns, because torch's
CPU ``uint32`` has no shifts:

- a logical right shift is ``(x >> s) & mask`` (``shr``);
- an unsigned compare or sum goes through ``int64``;
- popcount is SWAR (torch has no popcount op);
- the ``fmix32`` multiplies stay in int32: the low 32 bits of a wrapping
  product are the same signed or unsigned.

Host-side scalars (lane seeds, salts, ticks) are plain Python ints holding
u32 values.  Layouts match the reference: words ``[W, N]`` and candidate
rows ``[C, N]``, peer axis last.
"""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32
MASK32 = 0xFFFFFFFF


def i32(v: int) -> int:
    """A u32 value as the int32 holding the same bits."""
    v &= MASK32
    return v - (1 << 32) if v >= (1 << 31) else v


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of u32 values -> int32 tensor of the same bits."""
    x = x & MASK32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32-held u32 words by a static ``s``."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


# -- the counter-based lane hash ---------------------------------------------

def fmix32_int(x: int) -> int:
    """``_fmix32`` on one host-side u32."""
    x &= MASK32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & MASK32
    x ^= x >> 15
    x = (x * 0x846CA68B) & MASK32
    x ^= x >> 16
    return x


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit finalizer hash (splitmix32 variant) on int32-held words."""
    x = x ^ shr(x, 16)
    x = x * i32(0x7FEB352D)
    x = x ^ shr(x, 15)
    x = x * i32(0x846CA68B)
    x = x ^ shr(x, 16)
    return x


def lane_seed(tick: int, phase: int, salt: int) -> int:
    """The mixed per-(tick, phase, salt) u32 seed feeding lane_uniform."""
    return fmix32_int(((tick * 0x9E3779B9) & MASK32)
                      ^ ((salt + phase * 0x85EBCA6B) & MASK32))


def lane_uniform_from_seed(shape: tuple[int, ...], seed: int,
                           stride: int | None = None,
                           device: torch.device | str = "cpu",
                           cols: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """f32 uniforms in [0, 1) hashed from (lane index, mixed ``seed``).

    For a 2-D ``(R, N)`` shape the lane is ``r * stride + p`` (u32 wrap,
    ``stride`` defaults to N).  ``cols`` (int64 peer indices) draws only
    those columns of the ``(R, N)`` stream — the same values as slicing
    the full field."""
    if len(shape) == 2:
        rows = torch.arange(shape[0], dtype=torch.int64, device=device)
        if cols is None:
            cols = torch.arange(shape[1], dtype=torch.int64, device=device)
        stride = shape[1] if stride is None else stride
        lane = rows[:, None] * stride + cols[None, :]
    else:
        total = int(np.prod(shape))
        lane = torch.arange(total, dtype=torch.int64,
                            device=device).reshape(shape)
    h = fmix32(to_i32(lane ^ seed))
    return shr(h, 8).to(torch.float32) * (1.0 / (1 << 24))


def lane_uniform(shape: tuple[int, ...], tick: int, phase: int, salt: int,
                 stride: int | None = None,
                 device: torch.device | str = "cpu",
                 cols: torch.Tensor | None = None) -> torch.Tensor:
    """Stateless per-lane uniforms for (tick, phase, salt): the
    simulator's RNG, bit-identical to the reference's lane_uniform."""
    return lane_uniform_from_seed(shape, lane_seed(tick, phase, salt),
                                  stride, device, cols)


# -- packed candidate masks --------------------------------------------------

def _cidx(c: int, device) -> torch.Tensor:
    return torch.arange(c, dtype=torch.int32, device=device)[:, None]


def expand_bits(bits: torch.Tensor, c: int) -> torch.Tensor:
    """int32 [N] candidate bitmask -> bool [C, N] (bit i = row i)."""
    return ((bits[None, :] >> _cidx(c, bits.device)) & 1) != 0


def pack_rows(bools: torch.Tensor) -> torch.Tensor:
    """bool [C, N] -> int32 [N] bitmask (row i -> bit i)."""
    c = bools.shape[0]
    shifts = torch.arange(c, dtype=torch.int64, device=bools.device)
    return to_i32((bools.to(torch.int64) << shifts[:, None]).sum(0))


def bit_row(bits: torch.Tensor, c: int) -> torch.Tensor:
    """Row c of a packed candidate mask: bool [N]."""
    return ((bits >> c) & 1) != 0


def popcount32(bits: torch.Tensor) -> torch.Tensor:
    """Set bits per int32-held u32 word (SWAR), as int32."""
    x = bits - ((bits >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return shr(x * 0x01010101, 24)


popcount_words = popcount32


def ranks_desc(prio: torch.Tensor,
               tiebreak: torch.Tensor | None = None) -> torch.Tensor:
    """Rank of each candidate row per peer under DESCENDING priority
    ([C, N] -> int32 [C, N]); ties break by ascending ``tiebreak`` when
    given, else by candidate index."""
    pi, pj = prio[:, None, :], prio[None, :, :]
    beats = pj > pi                              # [i, j, N]: j outranks i
    if tiebreak is None:
        cidx = torch.arange(prio.shape[0], device=prio.device)
        beats |= (pj == pi) & (cidx[None, :, None] < cidx[:, None, None])
    else:
        ti, tj = tiebreak[:, None, :], tiebreak[None, :, :]
        beats |= (pj == pi) & (tj < ti)
    return beats.sum(1, dtype=torch.int32)


def select_k_bits(elig_bits: torch.Tensor, k: torch.Tensor,
                  rand) -> torch.Tensor:
    """Uniformly choose up to k[n] set bits of elig_bits[n].

    ``rand``: f32 [C, N] priorities, or a lane_uniform spec
    ``(c, tick, phase, salt[, stride])``.  Returns packed int32 [N]."""
    if isinstance(rand, tuple):
        c, tick, phase, salt = rand[:4]
        stride = rand[4] if len(rand) > 4 else None
        rand = lane_uniform((c, elig_bits.shape[0]), tick, phase, salt,
                            stride=stride, device=elig_bits.device)
    c = rand.shape[0]
    elig = expand_bits(elig_bits, c)
    prio = torch.where(elig, rand, -1.0)
    sel = elig & (ranks_desc(prio) < k[None, :])
    return pack_rows(sel)


def select_k_by_priority_bits(elig_bits: torch.Tensor,
                              priority: torch.Tensor, k: torch.Tensor,
                              tiebreak: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Top-k of the eligible bits by descending f32 [C, N] priority, ties
    by ascending ``tiebreak``."""
    c = priority.shape[0]
    elig = expand_bits(elig_bits, c)
    prio = torch.where(elig, priority, -torch.inf)
    sel = elig & (ranks_desc(prio, tiebreak) < k[None, :])
    return pack_rows(sel)


# -- message possession words ------------------------------------------------

def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack bool [..., M] into int32-held u32 words [..., ceil(M/32)]."""
    *lead, m = bits.shape
    w = (m + WORD_BITS - 1) // WORD_BITS
    pad = w * WORD_BITS - m
    if pad:
        bits = torch.cat(
            [bits, torch.zeros((*lead, pad), dtype=bits.dtype,
                               device=bits.device)], dim=-1)
    bits = bits.reshape(*lead, w, WORD_BITS).to(torch.int64)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=bits.device)
    return to_i32((bits << shifts).sum(-1))


def pack_bits_pm(bits: torch.Tensor) -> torch.Tensor:
    """Pack bool [N, M] into peer-minor words [W, N]."""
    return pack_bits(bits).T.contiguous()


def unpack_bits(words: torch.Tensor, m: int) -> torch.Tensor:
    """Unpack words [..., W] into bool [..., m]."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    *lead, w, _ = bits.shape
    return bits.reshape(*lead, w * WORD_BITS)[..., :m] != 0


def count_bits_per_position(words: torch.Tensor, m: int) -> torch.Tensor:
    """Peer-minor words [W, N] -> int32 [m]: peers with bit j set."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[:, None, :] >> shifts[None, :, None]) & 1
    return bits.sum(2, dtype=torch.int32).reshape(-1)[:m]


def make_circulant_offsets(n_classes: int, degree: int, n_peers: int,
                           seed: int = 0) -> np.ndarray:
    """Random circulant offsets, all multiples of ``n_classes`` and
    closed under negation (host-side numpy, the reference's draw)."""
    rng = np.random.default_rng(seed)
    max_k = n_peers // n_classes
    # k strictly below max_k/2, or two offsets could alias one peer
    half = (max_k - 1) // 2
    if degree // 2 > half:
        raise ValueError("degree too large for the residue-class size")
    ks = rng.choice(np.arange(1, half + 1), size=degree // 2, replace=False)
    offs = np.concatenate([ks, -ks]) * n_classes
    return offs.astype(np.int64)
