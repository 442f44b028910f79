"""Packed top-k selection: the CUDA kernel ``csrc/select.cu`` and its
plain PyTorch version.

Counterpart of ``go_libp2p_pubsub_tpu/ops/pallas/select.py``
(``select_k_bits_pallas``): every ``sel_k`` call of the port's step goes
through ``select_k_bits`` here, which launches the kernel for CUDA
tensors and runs ``select_k_bits_plain`` (= ``ops.graph.select_k_bits``
with lane_uniform priorities) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import graph
from . import _build

#: launches of the CUDA kernel (a plain integer; chip_smoke.py resets it
#: before the main path and reads it after)
launches = 0


def _check(elig: torch.Tensor, k: torch.Tensor, c: int, seed) -> None:
    if elig.device != k.device:
        raise ValueError(f"elig on {elig.device}, k on {k.device}")
    if elig.dtype != torch.int32 or k.dtype != torch.int32:
        raise TypeError("elig and k must be int32")
    if isinstance(seed, torch.Tensor):
        if (elig.dim() != 2 or k.shape != elig.shape
                or tuple(seed.shape) != (elig.shape[0],)):
            raise ValueError("a replica stack takes matching [B, N] elig "
                             "and k and [B] seeds")
        if seed.dtype not in (torch.int32, torch.int64):
            raise TypeError("seeds must be int32 or int64 u32 values")
        if seed.device != elig.device:
            raise ValueError(f"seeds on {seed.device}, elig on "
                             f"{elig.device}")
    elif elig.dim() != 1 or k.shape != elig.shape:
        raise ValueError("elig and k must be matching 1-D [N] tensors")
    if not (1 <= c <= 32):
        raise ValueError(f"c={c} outside [1, 32]")


def select_k_bits_plain(elig: torch.Tensor, k: torch.Tensor, c: int,
                        seed, stride: int) -> torch.Tensor:
    """Plain version: ops.graph.select_k_bits on the lane stream of the
    already-mixed ``seed`` (graph.lane_seed) with row ``stride``; a
    replica stack's [B] seeds draw each row of ``elig`` [B, N] from its
    own."""
    _check(elig, k, c, seed)
    rand = graph.lane_uniform_from_seed((c, elig.shape[-1]), seed,
                                        stride=stride, device=elig.device)
    return graph.select_k_bits(elig, k, rand)


def select_k_bits(elig: torch.Tensor, k: torch.Tensor, c: int,
                  seed, stride: int) -> torch.Tensor:
    """Uniformly choose up to k[p] of the C eligible bits of elig[p].

    elig, k: int32 [N]; seed: the mixed u32 lane seed; stride: the lane
    stream's row stride (the true peer count).  Returns int32 [N].  A
    replica stack: elig and k int32 [B, N], seed a [B] tensor of the
    replicas' lane seeds (``graph.lane_seed`` on a stacked salt), one
    launch for the B rows, each drawing the lanes of its own peers.
    CUDA tensors launch the kernel (a failed build or launch raises);
    CPU tensors run the plain version."""
    global launches
    _check(elig, k, c, seed)
    if elig.device.type == "cpu":
        return select_k_bits_plain(elig, k, c, seed, stride)
    # the kernel moves four peers a thread by 16-byte loads and stores:
    # an operand that starts off a 16-byte boundary is copied (``out`` is
    # a fresh allocation)
    elig, k = (v.contiguous() for v in (elig, k))
    elig, k = (v.clone() if v.data_ptr() % 16 else v for v in (elig, k))
    out = torch.empty_like(elig)
    lib = _build.load("select")
    if isinstance(seed, torch.Tensor):
        seeds = seed.to(torch.int32).contiguous()
        fn = lib.gossip_select_k_bits_batched
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p]
        with torch.cuda.device(elig.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(elig.data_ptr(), k.data_ptr(), out.data_ptr(),
                     elig.shape[0], elig.shape[1], c, seeds.data_ptr(),
                     stride & graph.MASK32, stream)
        _build.check(err, "select_k_bits")
        launches += 1
        return out
    fn = lib.gossip_select_k_bits
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_uint,
                   ctypes.c_uint, ctypes.c_void_p]
    with torch.cuda.device(elig.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(elig.data_ptr(), k.data_ptr(), out.data_ptr(),
                 elig.shape[0], c, seed & graph.MASK32,
                 stride & graph.MASK32, stream)
    _build.check(err, "select_k_bits")
    launches += 1
    return out


def launch_config(n: int, c: int) -> dict:
    """The kernel's launch at ``n`` peers and ``c`` candidates: peers a
    block, blocks a multiprocessor, dynamic shared memory (bytes), grid."""
    out = (ctypes.c_int * 4)()
    fn = _build.load("select").gossip_select_launch_config
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    _build.check(fn(n, c, out), "select launch_config")
    return dict(zip(("tile", "blocks_per_sm", "smem_bytes", "grid"), out))
