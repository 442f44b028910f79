"""Per-tick protocol telemetry: the frame a telemetry step returns beside
its state, the wire-size constants, the histograms and the runners.

Counterpart of ``go_libp2p_pubsub_tpu/models/telemetry.py``:

- ``TelemetryConfig`` is the static knob with the reference's fields,
  defaults and validation messages (both packages take the same keyword
  arguments).
- ``TelemetryFrame`` holds one tick's aggregates as 0-d device tensors
  with the reference's field names and dtypes (i32 counts, f32 bytes and
  gauges); a histogram field is ``None`` when its group is off.  A
  telemetry step (``make_gossip_step(telemetry=...)``) returns ``(state,
  delivered, frame)``; the runners keep every frame on the device and
  stack them once at the end (``stack_frames``: leaves ``[T, ...]``).
- ``wire_sizes`` measures the bytes-on-wire constants from the port's own
  copy of the RPC encodings (``pb/``).

The RPC and duplicate counters come out of the receive kernel's tally
(``ops/kernels/receive.py``, the ``+tel`` variants); the gauges
(``degree_stats``, ``score_stats``) and histograms are reductions over
the tick's end-of-tick mesh and start-of-tick scores in plain PyTorch,
with no host sync (``torch.where`` on device values, never a Python
``if``).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..ops.graph import count_bits_per_position, pack_bits


@dataclass(frozen=True)
class TelemetryConfig:
    """Static telemetry knob (the reference's ``TelemetryConfig``).

    Groups: ``counters`` (RPC sends by type and duplicates suppressed),
    ``wire`` (bytes-on-wire estimates from the counters, needs
    ``counters``), ``mesh`` (mesh-degree min/mean/max over subscribed
    peers), ``scores`` (score summary over live candidate edges, zero
    unscored), ``faults`` (down peers and dropped edge-ticks, zero without
    a fault schedule); the histograms ``latency_hist`` (this tick's
    deliveries by ticks since publish, the last bucket absorbing the
    rest), ``degree_hist`` (subscribed peers by end-of-tick mesh degree)
    and ``score_hist`` (live candidate edges by start-of-tick score
    against ``score_bucket_edges``), off by default.  The framing
    assumptions of the wire estimates: ``payload_data_bytes`` per message
    body, ``msg_id_bytes`` per message id, ``peer_id_bytes`` per peer id,
    ``topic_bytes`` per topic string."""

    counters: bool = True
    wire: bool = True
    mesh: bool = True
    scores: bool = True
    faults: bool = True
    latency_hist: bool = False
    degree_hist: bool = False
    score_hist: bool = False
    latency_buckets: int = 16
    degree_buckets: int = 16
    score_bucket_edges: tuple = (-50.0, -10.0, -1.0, 0.0, 1.0, 10.0,
                                 50.0)
    payload_data_bytes: int = 64
    msg_id_bytes: int = 8
    peer_id_bytes: int = 8
    topic_bytes: int = 8

    def __post_init__(self):
        if self.wire and not self.counters:
            raise ValueError(
                "TelemetryConfig: wire=True needs counters=True (byte "
                "estimates are derived from the RPC counters)")
        for name in ("payload_data_bytes", "msg_id_bytes",
                     "peer_id_bytes", "topic_bytes"):
            if getattr(self, name) < 1:
                raise ValueError(f"TelemetryConfig: {name} must be >= 1")
        for name in ("latency_buckets", "degree_buckets"):
            if getattr(self, name) < 2:
                raise ValueError(
                    f"TelemetryConfig: {name} must be >= 2 (one real "
                    "bucket plus the overflow bucket)")
        edges = tuple(float(e) for e in self.score_bucket_edges)
        object.__setattr__(self, "score_bucket_edges", edges)
        if len(edges) < 1:
            raise ValueError(
                "TelemetryConfig: score_bucket_edges needs >= 1 edge")
        if any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(
                "TelemetryConfig: score_bucket_edges must be strictly "
                f"increasing (got {edges})")


@dataclass(frozen=True)
class WireSizes:
    """Per-frame byte constants measured from the RPC encodings, each with
    the varint length prefix of the delimited stream framing."""

    payload_frame: int   # one published message in its own RPC frame
    ihave_base: int      # an RPC carrying one merged IHAVE, zero ids
    ihave_per_id: int    # marginal bytes per advertised id
    iwant_base: int      # an RPC carrying one IWANT, zero ids
    iwant_per_id: int    # marginal bytes per requested id
    graft_frame: int     # an RPC carrying one GRAFT
    prune_frame: int     # an RPC carrying one PRUNE (no PX records)


def wire_sizes(tcfg: TelemetryConfig) -> WireSizes:
    """The framing constants from actual encodings; the per-id marginals
    between the 2-id and 1-id encodings (the reference's method)."""
    from ..pb import rpc as rpcpb
    from ..pb.proto import write_delimited

    mid = b"\x00" * tcfg.msg_id_bytes
    pid = b"\x00" * tcfg.peer_id_bytes
    topic = "t" * tcfg.topic_bytes

    def fsz(msg):
        return len(write_delimited(msg))

    payload = fsz(rpcpb.RPC(publish=[rpcpb.PubMessage(
        from_peer=pid, data=b"\x00" * tcfg.payload_data_bytes,
        seqno=b"\x00" * 8, topic=topic)]))

    def ih(k):
        return fsz(rpcpb.RPC(control=rpcpb.ControlMessage(
            ihave=[rpcpb.ControlIHave(topic_id=topic,
                                      message_ids=[mid] * k)])))

    def iw(k):
        return fsz(rpcpb.RPC(control=rpcpb.ControlMessage(
            iwant=[rpcpb.ControlIWant(message_ids=[mid] * k)])))

    ihave_per = ih(2) - ih(1)
    iwant_per = iw(2) - iw(1)
    graft = fsz(rpcpb.RPC(control=rpcpb.ControlMessage(
        graft=[rpcpb.ControlGraft(topic_id=topic)])))
    prune = fsz(rpcpb.RPC(control=rpcpb.ControlMessage(
        prune=[rpcpb.ControlPrune(topic_id=topic)])))
    return WireSizes(
        payload_frame=payload,
        ihave_base=ih(1) - ihave_per, ihave_per_id=ihave_per,
        iwant_base=iw(1) - iwant_per, iwant_per_id=iwant_per,
        graft_frame=graft, prune_frame=prune)


I32_FIELDS = ("payload_sent", "ihave_rpcs", "ihave_ids", "iwant_rpcs",
              "iwant_ids_requested", "iwant_ids_served", "graft_sends",
              "prune_sends", "dup_suppressed", "mesh_deg_min",
              "mesh_deg_max", "down_peers", "dropped_edge_ticks")
F32_FIELDS = ("bytes_payload", "bytes_control", "mesh_deg_mean",
              "score_mean", "score_min", "score_frac_neg",
              "score_frac_below_gossip")
HIST_FIELDS = ("latency_hist", "mesh_deg_hist", "score_hist")


@dataclass(frozen=True)
class TelemetryFrame:
    """One tick's network-wide aggregates, 0-d device tensors (stacked
    frames: leading ``[T]``).  The reference's counter semantics:
    ``payload_sent`` eager copies transmitted (mesh, fanout, direct,
    flood publish, slot B); ``ihave_rpcs`` / ``ihave_ids`` edges carrying
    a nonempty IHAVE and the ids advertised (withholding spammers
    included); ``iwant_ids_requested`` advertised ids the receiver lacked,
    ``iwant_ids_served`` ids delivered by the gossip pull; ``graft_sends``
    / ``prune_sends`` handshake RPCs transmitted; ``dup_suppressed``
    received copies that were no new acquisition (the combined path: one
    merged word is one received copy)."""

    payload_sent: torch.Tensor         # int32
    ihave_rpcs: torch.Tensor           # int32
    ihave_ids: torch.Tensor            # int32
    iwant_rpcs: torch.Tensor           # int32
    iwant_ids_requested: torch.Tensor  # int32
    iwant_ids_served: torch.Tensor     # int32
    graft_sends: torch.Tensor          # int32
    prune_sends: torch.Tensor          # int32
    dup_suppressed: torch.Tensor       # int32
    bytes_payload: torch.Tensor        # float32 (estimated wire bytes)
    bytes_control: torch.Tensor        # float32
    mesh_deg_min: torch.Tensor         # int32 (subscribed peers)
    mesh_deg_mean: torch.Tensor        # float32
    mesh_deg_max: torch.Tensor         # int32
    score_mean: torch.Tensor           # float32 (live candidate edges)
    score_min: torch.Tensor            # float32
    score_frac_neg: torch.Tensor       # float32 (fraction < 0)
    score_frac_below_gossip: torch.Tensor  # float32 (< gossip threshold)
    down_peers: torch.Tensor           # int32
    dropped_edge_ticks: torch.Tensor   # int32 (link loss + partition)
    latency_hist: torch.Tensor | None = None   # int32 [latency_buckets]
    mesh_deg_hist: torch.Tensor | None = None  # int32 [degree_buckets]
    score_hist: torch.Tensor | None = None     # int32 [n_edges + 1]


def make_frame(device, shape=(), **kw) -> TelemetryFrame:
    """A frame with the given fields set and the rest zero, each cast to
    its field's dtype on ``device``; histogram fields default to None.
    ``shape``: a scalar field's (a replica stack's ``(B,)``: each field a
    [B] tensor, the zeros too)."""
    vals = {}
    for name, dt, zero in ([(f, torch.int32, 0) for f in I32_FIELDS]
                           + [(f, torch.float32, 0.0) for f in F32_FIELDS]):
        v = kw.pop(name, zero)
        # a fill on the device, never a copy from the host (which would
        # sync the stream every tick)
        vals[name] = (v.to(dt) if isinstance(v, torch.Tensor)
                      else torch.full(tuple(shape), v, dtype=dt,
                                      device=device))
    for name in HIST_FIELDS:
        vals[name] = kw.pop(name, None)
    if kw:
        raise TypeError(f"unknown TelemetryFrame fields: {sorted(kw)}")
    return TelemetryFrame(**vals)


def stack_frames(frames) -> TelemetryFrame:
    """A list of frames -> one frame with every leaf stacked ``[T, ...]``
    (``None`` histogram fields stay ``None``)."""
    out = {}
    for f in fields(TelemetryFrame):
        vals = [getattr(fr, f.name) for fr in frames]
        out[f.name] = None if vals[0] is None else torch.stack(vals)
    return TelemetryFrame(**out)


def concat_frames(frames) -> TelemetryFrame:
    """Stacked frames ``[T_i, ...]`` -> one ``[sum T_i, ...]``."""
    out = {}
    for f in fields(TelemetryFrame):
        vals = [getattr(fr, f.name) for fr in frames]
        out[f.name] = None if vals[0] is None else torch.cat(vals)
    return TelemetryFrame(**out)


def degree_stats(deg: torch.Tensor, subscribed: torch.Tensor):
    """(min i32, mean f32, max i32) of ``deg`` over subscribed peers, all
    zero when nobody subscribes (no host sync); a replica stack's [B, N]
    gives [B] each."""
    sub = subscribed
    n_sub = sub.sum(-1, dtype=torch.int32).clamp(min=1)
    any_sub = sub.any(-1)
    big = torch.iinfo(torch.int32).max
    mn = torch.where(sub, deg, big).amin(-1)
    mx = torch.where(sub, deg, -1).amax(-1)
    mean = torch.where(sub, deg, 0).sum(-1, dtype=torch.float32) / n_sub
    return (torch.where(any_sub, mn, 0).to(torch.int32),
            torch.where(any_sub, mean, 0.0),
            torch.where(any_sub, mx, 0).to(torch.int32))


def _f32(x: float) -> float:
    return float(np.float32(x))


def score_stats(score: torch.Tensor, mask: torch.Tensor,
                gossip_threshold: float):
    """(mean, min, fraction below 0, fraction below the gossip
    threshold) of the [C, N] per-edge score over edges where ``mask``
    holds, all zero without a live edge; a replica stack's [B, C, N]
    gives [B] each."""
    dims = (-2, -1)
    n_live = mask.sum(dims, dtype=torch.int32).clamp(min=1)
    any_live = mask.any(-1).any(-1)
    mean = torch.where(mask, score, 0.0).sum(dims, dtype=torch.float32) \
        / n_live
    mn = torch.where(mask, score, torch.inf).amin(dims)
    frac_neg = (mask & (score < 0.0)).sum(dims, dtype=torch.float32) / n_live
    frac_gsp = (mask & (score < _f32(gossip_threshold))).sum(
        dims, dtype=torch.float32) / n_live
    return tuple(torch.where(any_live, x, 0.0)
                 for x in (mean, mn, frac_neg, frac_gsp))


def latency_histogram(delivered_now: torch.Tensor,
                      publish_tick: torch.Tensor, tick: int,
                      n_buckets: int) -> torch.Tensor:
    """i32 [n_buckets]: this tick's deliveries by latency in ticks since
    publish (bucket b = latency b, the last absorbing the rest); sums to
    the tick's delivered count.  A replica stack's words [B, W, N] and
    publish ticks [B, M] give [B, n_buckets]."""
    m = publish_tick.shape[-1]
    per_msg = count_bits_per_position(delivered_now, m)       # [.., M]
    lat = (tick - publish_tick).clamp(0, n_buckets - 1)
    onehot = lat.unsqueeze(-2) == torch.arange(
        n_buckets, dtype=lat.dtype, device=lat.device)[:, None]
    return torch.where(onehot, per_msg.unsqueeze(-2), 0).sum(
        -1, dtype=torch.int32)


def latency_bucket_masks(publish_tick: torch.Tensor, tick,
                         n_buckets: int, w_words: int) -> torch.Tensor:
    """int32 [n_buckets, w_words]: message m's bit set in row b iff its
    latency this tick lands in bucket b (``latency_histogram``'s
    bucketing) — the receive and fused kernels' bucket operand, made on
    the device from the host ``tick`` (an int, or an int32 [T, 1] tensor
    of ticks for a stack of masks); a replica stack's publish ticks [B, M]
    give [B, n_buckets, w_words]."""
    lat = (tick - publish_tick).clamp(0, n_buckets - 1)       # [..., M]
    sel = lat[..., None, :] == torch.arange(
        n_buckets, dtype=lat.dtype, device=lat.device)[:, None]
    words = pack_bits(sel)
    pad = w_words - words.shape[-1]
    if pad:
        words = torch.nn.functional.pad(words, (0, pad))
    return words.contiguous()


def degree_histogram(deg: torch.Tensor, subscribed: torch.Tensor,
                     n_buckets: int) -> torch.Tensor:
    """i32 [n_buckets]: subscribed peers by mesh degree (the last bucket
    absorbing the overflow); a replica stack's [B, N] gives [B,
    n_buckets]."""
    b = deg.clamp(0, n_buckets - 1)
    onehot = ((b.unsqueeze(-2) == torch.arange(
        n_buckets, dtype=b.dtype, device=b.device)[:, None])
        & subscribed.unsqueeze(-2))
    return onehot.sum(-1, dtype=torch.int32)


def score_histogram(score: torch.Tensor, mask: torch.Tensor,
                    edges: tuple, batch_dims: int = 0) -> torch.Tensor:
    """i32 [len(edges) + 1]: masked scores against the ascending
    ``edges`` (bucket 0 below the first edge, bucket i in [edges[i-1],
    edges[i]), the last at or above the final edge), summed over every
    axis but the first ``batch_dims`` (a replica stack's: [B, len(edges)
    + 1] with ``batch_dims`` 1)."""
    idx = torch.zeros(score.shape, dtype=torch.int32, device=score.device)
    for e in edges:
        idx = idx + (score >= _f32(e)).to(torch.int32)
    n_b = len(edges) + 1
    lanes = torch.arange(n_b, dtype=torch.int32, device=score.device)
    nd = score.ndim - batch_dims
    onehot = ((idx.unsqueeze(batch_dims)
               == lanes.reshape((n_b,) + (1,) * nd))
              & mask.unsqueeze(batch_dims))
    return onehot.sum(dim=tuple(range(batch_dims + 1, onehot.ndim)),
                      dtype=torch.int32)


# -- runners (any step returning (state, delivered, frame)) -----------------

def telemetry_run(params, state, n_ticks: int, step):
    """Advance ``n_ticks`` collecting each tick's frame: ``(state,
    frames)``, every leaf stacked ``[n_ticks, ...]`` once at the end (the
    frames stay on the device)."""
    frames = []
    for _ in range(n_ticks):
        state, _, frame = step(params, state)
        frames.append(frame)
    return state, stack_frames(frames)


def telemetry_run_curve(params, state, n_ticks: int, step, n_msgs: int):
    """``telemetry_run`` with the per-tick delivered counts: ``(state,
    counts int32 [n_ticks, n_msgs], frames)``."""
    frames, rows = [], []
    for _ in range(n_ticks):
        state, delivered, frame = step(params, state)
        rows.append(count_bits_per_position(delivered, n_msgs))
        frames.append(frame)
    return state, torch.stack(rows), stack_frames(frames)


def telemetry_run_batch(params, state, n_ticks: int, step):
    """``telemetry_run`` over B stacked replicas (``stack_sims`` /
    ``stack_trees``): ONE step a tick for the whole stack (B1 once, B3 as
    often as for one replica), ``(state_B, frames)`` with every scalar
    frame leaf ``[n_ticks, B]`` and every histogram ``[n_ticks, B, L]``.
    Per replica the frames and the state equal ``telemetry_run`` on that
    replica alone (the reference's ``telemetry_run_batch``)."""
    if not isinstance(state.salt, torch.Tensor) or \
            params.subscribed.dim() != 2:
        raise ValueError("telemetry_run_batch takes a replica stack "
                         "(stack_sims / stack_trees): one sim runs on "
                         "telemetry_run")
    return telemetry_run(params, state, n_ticks, step)


# -- host-side aggregation ----------------------------------------------------

def frames_to_arrays(frames: TelemetryFrame) -> dict:
    """Frame -> {field: np.ndarray} (whatever leading axes the runner
    gave: ``[T]``, a stack's ``[T, B]``); histogram fields only when their
    group was on."""
    out = {name: getattr(frames, name).cpu().numpy()
           for name in I32_FIELDS + F32_FIELDS}
    for name in HIST_FIELDS:
        val = getattr(frames, name)
        if val is not None:
            out[name] = val.cpu().numpy()
    return out


def summarize_frames(frames: TelemetryFrame) -> dict:
    """Whole-run totals and the control-overhead ratio (control bytes /
    payload bytes): counts summed over every axis (a stack's replicas
    too), the mesh gauge's last value (the reference's
    ``summarize_frames``)."""
    arrs = frames_to_arrays(frames)
    totals = {name: int(arrs[name].sum()) for name in I32_FIELDS
              if name not in ("mesh_deg_min", "mesh_deg_max",
                              "down_peers")}
    bytes_payload = float(arrs["bytes_payload"].sum())
    bytes_control = float(arrs["bytes_control"].sum())
    out = dict(totals)
    out["bytes_payload"] = bytes_payload
    out["bytes_control"] = bytes_control
    out["control_overhead_ratio"] = (
        bytes_control / bytes_payload if bytes_payload > 0 else 0.0)
    out["final_mesh_deg_mean"] = float(
        np.asarray(arrs["mesh_deg_mean"]).reshape(-1)[-1])
    if "latency_hist" in arrs:
        hist = arrs["latency_hist"].reshape(
            -1, arrs["latency_hist"].shape[-1]).sum(axis=0)
        out["latency_hist"] = [int(c) for c in hist]
        out["latency_ticks"] = hist_percentiles(hist)
    return out


def hist_percentiles(hist, pcts=(50, 90, 99)) -> dict:
    """Percentile bucket values of a summed histogram
    (``histutil.hist_percentiles``)."""
    from ..histutil import hist_percentiles as _hp
    return _hp(hist, pcts)


def latency_hists_by_topic(counts, publish_tick, msg_topic,
                           n_buckets: int, start_tick: int = 0,
                           topic_name=lambda t: f"topic-{t}") -> dict:
    """Per-topic latency histograms from a curve runner's per-tick
    delivered counts (int [T, M]): every copy of message j delivered at
    tick t has latency t - publish_tick[j]."""
    counts = np.asarray(counts.cpu() if isinstance(counts, torch.Tensor)
                        else counts)
    pub = np.asarray(publish_tick.cpu() if isinstance(
        publish_tick, torch.Tensor) else publish_tick)
    tpc = np.asarray(msg_topic)
    out: dict = {}
    t_ticks, _ = counts.shape
    for tau in sorted(set(int(x) for x in tpc)):
        hist = np.zeros(n_buckets, dtype=np.int64)
        for j in np.flatnonzero(tpc == tau):
            lat = np.clip(start_tick + np.arange(t_ticks) - int(pub[j]),
                          0, n_buckets - 1)
            np.add.at(hist, lat, counts[:, j])
        out[topic_name(tau)] = [int(c) for c in hist]
    return out
