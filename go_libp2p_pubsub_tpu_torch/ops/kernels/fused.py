"""The tick-resident fused window: the CUDA kernel ``csrc/fused.cu`` and
its plain PyTorch version.

Counterpart of ``go_libp2p_pubsub_tpu/ops/pallas/receive.py``
(``make_fused_gossip_update`` / ``_fused_gossip_kernel``), single
device, without telemetry or the sharded halo: T ticks of the unscored
(v1.0) step in one launch, the carry read once and written once per
window; Bernoulli or exact-k gossip targets
(``binomial_gossip_sampling``), no PX and no direct peers; with or
without a fault schedule's per-tick rows, and with cold restart.

Operands (peer axis last, packed u32 words as int32):

- ``tick0``: host int, the window's first tick;
- ``seeds``: T host tuples of mixed u32 lane seeds, per tick t
  ``(lane_seed(t, 4), lane_seed(t, 2), lane_seed(t, 3),
  lane_seed(t + 1, 1))`` — fanout refill, graft, prune, next tick's
  targets;
- ``due`` int32 [T, W]: the publish-due words of each tick;
- static: ``sub_all``, ``cand_sub`` [N], ``origin`` [W, N];
- the carry: ``have`` [W, N], ``recent`` [Hg, W, N] (the mcache ring),
  ``mesh``, ``fanout`` [N], ``last_pub`` int32 [N], ``backoff`` int16
  [C, N], ``tgt`` and ``bog`` [N] (the carried targets and backoff gate
  rows);
- under faults (``models/faults.py`` ``tick_masks`` of each tick of the
  window), int32 [T, N] rows: ``alive`` (a live peer's all-ones word),
  ``send_ok`` (the edges a peer may send on) and ``cand_alive`` (its live
  candidates); with cold restart also ``rejoin`` (all-ones at a peer
  coming back up that tick).

Returns ``(have, recent, mesh, fanout, last_pub, backoff, tgt, bog, acq
[T, W, N])`` — the carry after the window and each tick's acquisitions.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import torch

from .. import graph
from ...models import plan
from . import _build
from . import receive as krecv

#: launches of the CUDA kernel, without and with fault rows (plain
#: integers; chip_smoke.py resets them before a main path and reads them
#: after)
launches = 0
launches_faults = 0

#: (C, W) shapes the CUDA kernel is instantiated for
KERNEL_SHAPES = {(8, 1), (8, 2), (16, 1), (16, 2)}


@dataclass(frozen=True)
class FusedConsts:
    """The static scalars of one unscored config, folded on the host."""

    receive: krecv.ReceiveConsts   # the exchange/handshake/targets part
    d: int
    d_lo: int
    d_hi: int
    fanout_ttl: int
    history_gossip: int

    @property
    def n_candidates(self) -> int:
        return self.receive.n_candidates


def fused_consts(cfg) -> FusedConsts:
    """Check the options (named refusals outside the slice) and fold the
    constants of the unscored step."""
    return FusedConsts(receive=krecv.receive_consts(cfg, None), d=cfg.d,
                       d_lo=cfg.d_lo, d_hi=cfg.d_hi,
                       fanout_ttl=cfg.fanout_ttl_ticks,
                       history_gossip=cfg.history_gossip)


def window_seeds(tick0: int, ticks: int, salt: int) -> list[tuple]:
    """The per-tick lane seeds of a window (operand ``seeds``)."""
    return [(graph.lane_seed(t, 4, salt), graph.lane_seed(t, 2, salt),
             graph.lane_seed(t, 3, salt), graph.lane_seed(t + 1, 1, salt))
            for t in range(tick0, tick0 + ticks)]


def select_plain(elig: torch.Tensor, k: torch.Tensor, c: int,
                 seed: int) -> torch.Tensor:
    """sel_k: ops.graph.select_k_bits over the lane stream of ``seed``."""
    n = elig.shape[0]
    return graph.select_k_bits(
        elig, k, graph.lane_uniform_from_seed((c, n), seed, n, elig.device))


def fused_gossip_update_plain(k: FusedConsts, *, tick0, seeds, due,
                              sub_all, cand_sub, origin, have, recent, mesh,
                              fanout, last_pub, backoff, tgt, bog,
                              alive=None, send_ok=None, cand_alive=None,
                              rejoin=None):
    """Plain PyTorch version of the fused kernel: the unscored tick body
    looped over the window (same operands, same outputs,
    bit-identical), under faults with the step's fault masks."""
    C = k.n_candidates
    Hg = k.history_gossip
    ALL = (1 << C) - 1
    subbed = sub_all != 0
    faults = alive is not None
    k_recv = dataclasses.replace(k.receive, faults=faults)
    acqs = []
    for t, (s_fan, s_graft, s_prune, s_tgt) in enumerate(seeds):
        tick = tick0 + t
        if rejoin is not None:
            # cold restart: a rejoiner's possession and ring are cleared
            # before anything reads them
            have = have & ~rejoin[t]
            recent = recent & ~rejoin[t]
        fault_ops = {}
        so = -1                 # the edges a peer may send on: all
        if faults:
            aw, so, ca = alive[t], send_ok[t], cand_alive[t]
            up = aw & ALL
            fault_ops["alive_w"] = aw
        # 1. publish injection
        inj = origin & due[t][:, None] & ~have
        if faults:
            inj = inj & aw
        publishing = (inj != 0).any(0)
        # 1b. fanout TTL + refill
        last_pub = torch.where(publishing, tick, last_pub)
        alive_f = ~subbed & ((tick - last_pub) < k.fanout_ttl)
        fanout = torch.where(alive_f, fanout, 0)
        f_need = torch.where(alive_f, k.d - graph.popcount32(fanout), 0)
        f_elig = cand_sub & ~fanout
        if faults:
            f_elig = f_elig & ca
        fanout = fanout | select_plain(f_elig, f_need.to(torch.int32), C,
                                       s_fan)
        # 2/3a. fresh and advert windows from the ring
        fresh = recent[(tick - 1) % Hg] | inj
        adv = inj
        for h in range(Hg):
            adv = adv | recent[h]
        # 4. maintenance: graft below Dlo, v1.0 random prune above Dhi;
        # under faults, edges to or at a dead peer drop (PRUNE and
        # backoff at both ends) and nobody grafts at or by a dead peer
        mesh_ng, dead = mesh, 0
        if faults:
            dead = mesh & ~(ca & up)
            mesh_ng = mesh & ~dead
        deg = graph.popcount32(mesh_ng)
        need = torch.where(deg < k.d_lo, k.d - deg, 0).to(torch.int32)
        can_graft = cand_sub & ~mesh_ng & ~bog & sub_all
        if faults:
            can_graft = can_graft & ca & up
        grafts = select_plain(can_graft, need, C, s_graft)
        over = deg > k.d_hi         # retention drawn where it prunes
        keep = select_plain(mesh_ng,
                            torch.where(over, k.d, 0).to(torch.int32), C,
                            s_prune)
        prunes = torch.where(over, mesh_ng & ~keep, 0)
        dropped = prunes | dead
        would_accept = sub_all & ~(bog | dropped)
        # the exchange, handshake, backoff and next tick's gate rows; a
        # dead peer or either end of a down link sends nothing
        targets = tgt & so
        ctrl = krecv.ctrl_bytes(C, out=(mesh | fanout) & so, tgt=targets,
                                graft=grafts & so, drop=dropped & so,
                                a=would_accept & so, adv=targets)
        acq, mesh, backoff, tgt, bog = krecv.receive_update_plain(
            k_recv, gseeds=(0, s_tgt), ctrl=ctrl, fresh=fresh, adv=adv,
            sub_all=sub_all, cand_sub=cand_sub, fanout=fanout,
            wa=would_accept, grafts=grafts, dropped=dropped,
            meshsel=(mesh_ng | grafts) & ~prunes, seen=have | inj,
            injected=inj, backoff=backoff, **fault_ops)
        have = have | acq
        recent = recent.clone()
        recent[tick % Hg] = acq
        acqs.append(acq)
    return (have, recent, mesh, fanout, last_pub, backoff, tgt, bog,
            torch.stack(acqs))


class _Args(ctypes.Structure):
    """Mirror of ``struct FusedArgs`` in csrc/fused.cu."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "sub_all", "cand_sub", "origin", "due", "have_in", "rec_in",
            "mesh_in", "fan_in", "lp_in", "bo_in", "tgt_in", "bog_in",
            "have", "rec", "mesh", "fan", "lp", "bo", "tgt", "bog", "acq",
            "stage_ctrl", "stage_pay")]
        + [("n", ctypes.c_longlong), ("ticks", ctypes.c_int),
           ("tick0", ctypes.c_int), ("hg", ctypes.c_int),
           ("offsets", ctypes.c_int * 16), ("cinv", ctypes.c_int * 16)]
        + [(name, ctypes.c_int) for name in (
            "d", "d_lo", "d_hi", "fanout_ttl", "backoff_restart",
            "d_lazy")]
        + [("gossip_factor", ctypes.c_float), ("stride", ctypes.c_uint),
           ("seeds", (ctypes.c_uint * 4) * plan.MAX_WINDOW),
           ("exact_k", ctypes.c_int)]
        # the fault rows, last
        + [(name, ctypes.c_void_p) for name in (
            "alive", "sok", "cal", "rej")]
        + [("faults", ctypes.c_int), ("cold", ctypes.c_int)])


_CARRY = ("have", "recent", "mesh", "fanout", "last_pub", "backoff", "tgt",
          "bog")
#: the per-tick fault rows (``rejoin`` with cold restart only)
FAULT_ROWS = ("alive", "send_ok", "cand_alive", "rejoin")


def _check_operands(k: FusedConsts, ops: dict) -> None:
    C = k.n_candidates
    W, n = ops["have"].shape
    T = len(ops["seeds"])
    if (C, W) not in KERNEL_SHAPES:
        plan.refuse("kernel_shape")
    if not 1 <= T <= plan.MAX_WINDOW:
        plan.refuse("fused_window")
    want = {"due": ((T, W), torch.int32),
            "sub_all": ((n,), torch.int32), "cand_sub": ((n,), torch.int32),
            "origin": ((W, n), torch.int32), "have": ((W, n), torch.int32),
            "recent": ((k.history_gossip, W, n), torch.int32),
            "mesh": ((n,), torch.int32), "fanout": ((n,), torch.int32),
            "last_pub": ((n,), torch.int32),
            "backoff": ((C, n), torch.int16), "tgt": ((n,), torch.int32),
            "bog": ((n,), torch.int32)}
    rows = [name for name in FAULT_ROWS if ops.get(name) is not None]
    if rows and rows[:3] != list(FAULT_ROWS[:3]):
        raise ValueError(f"fault rows {rows}: alive, send_ok and "
                         "cand_alive go together (rejoin with them)")
    want.update({name: ((T, n), torch.int32) for name in rows})
    device = ops["have"].device
    for name, (shape, dtype) in want.items():
        t = ops[name]
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, have on {device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


#: cudaErrorCooperativeLaunchTooLarge: the card cannot keep one block of
#: the kernel resident, so its cooperative grid cannot run
COOPERATIVE_TOO_LARGE = 720


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused")
    lib.gossip_fused_window.restype = ctypes.c_int
    lib.gossip_fused_window.argtypes = [
        ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def check_launch(err: int) -> None:
    """Raise if the launch failed: the named ``fused_grid`` refusal for a
    grid the card cannot hold, else the CUDA error."""
    if err == COOPERATIVE_TOO_LARGE:
        plan.refuse("fused_grid")
    _build.check(err, "fused_gossip_update")


def fused_gossip_update(k: FusedConsts, **ops):
    """T unscored ticks in one launch (operands and outputs: module
    docstring).

    CUDA tensors launch the kernel (a failed build or launch raises);
    CPU tensors run ``fused_gossip_update_plain``."""
    global launches, launches_faults
    _check_operands(k, ops)
    if ops["have"].device.type == "cpu":
        return fused_gossip_update_plain(k, **ops)
    C = k.n_candidates
    W, n = ops["have"].shape
    T = len(ops["seeds"])
    Hg = k.history_gossip
    dev = ops["have"].device
    outs = {name: torch.empty_like(ops[name]) for name in _CARRY}
    acq = torch.empty((T, W, n), dtype=torch.int32, device=dev)
    stage_ctrl = torch.empty((2, C, n), dtype=torch.uint8, device=dev)
    stage_pay = torch.empty((2, 2 * W, n), dtype=torch.int32, device=dev)
    a = _Args()
    for name in ("sub_all", "cand_sub", "origin", "due"):
        setattr(a, name, ops[name].data_ptr())
    for field, name in (("have", "have"), ("rec", "recent"),
                        ("mesh", "mesh"), ("fan", "fanout"),
                        ("lp", "last_pub"), ("bo", "backoff"),
                        ("tgt", "tgt"), ("bog", "bog")):
        setattr(a, f"{field}_in", ops[name].data_ptr())
        setattr(a, field, outs[name].data_ptr())
    a.acq = acq.data_ptr()
    a.stage_ctrl = stage_ctrl.data_ptr()
    a.stage_pay = stage_pay.data_ptr()
    r = k.receive
    a.n, a.ticks, a.tick0, a.hg = n, T, int(ops["tick0"]), Hg
    for j in range(C):
        a.offsets[j] = r.offsets[j] % n
        a.cinv[j] = r.cinv[j]
    a.d, a.d_lo, a.d_hi = k.d, k.d_lo, k.d_hi
    a.fanout_ttl = k.fanout_ttl
    a.backoff_restart = r.backoff_restart
    a.d_lazy = r.d_lazy
    a.gossip_factor = r.gossip_factor
    a.stride = n & graph.MASK32
    a.exact_k = int(r.exact_k)
    for field, name in zip(("alive", "sok", "cal", "rej"), FAULT_ROWS):
        if ops.get(name) is not None:
            setattr(a, field, ops[name].data_ptr())
    a.faults = int(ops.get("alive") is not None)
    a.cold = int(ops.get("rejoin") is not None)
    for t, tick_seeds in enumerate(ops["seeds"]):
        for i, seed in enumerate(tick_seeds):
            a.seeds[t][i] = int(seed) & graph.MASK32
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gossip_fused_window(ctypes.byref(a), C, W, stream)
    check_launch(err)
    if a.faults:
        launches_faults += 1
    else:
        launches += 1
    return (*(outs[name] for name in _CARRY), acq)


def window_operand_bytes(ops: dict) -> int:
    """Bytes the window function must move: the carry read and written
    once, the static rows and the fault rows read once, each tick's
    acquisitions written once (the kernel's own stage is not the
    function's and is counted apart, ``stage_bytes``)."""
    carry = sum(ops[name].numel() * ops[name].element_size()
                for name in _CARRY)
    static = sum(ops[name].numel() * ops[name].element_size()
                 for name in ("sub_all", "cand_sub", "origin", "due",
                              *FAULT_ROWS)
                 if ops.get(name) is not None)
    W, n = ops["have"].shape
    return 2 * carry + static + 4 * len(ops["seeds"]) * W * n


def stage_bytes(k: FusedConsts, ops: dict) -> int:
    """Bytes of this kernel's stage over a window: each tick's ctrl bytes
    and fresh and advert words written once and read once (an
    intermediate of the design, which fits in L2 at 1M peers)."""
    W, n = ops["have"].shape
    return 2 * len(ops["seeds"]) * n * (k.n_candidates + 8 * W)
