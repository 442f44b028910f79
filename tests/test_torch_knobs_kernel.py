"""B1's plain version with the knob vector against the JAX reference's
Pallas receive kernel ``make_receive_update(with_knobs=True)`` in
interpret mode, on seeded random operands (``n_true`` = 1,024, block 128:
the wrap-extended layout), every family of the port's receive variants:
the flagship's scored options (with ``topic_weight`` 0.7 and a P4 weight
of -10.9, where the knob's float32 product and the baked rounding
differ), the attack options (both spams), the full variant's options
(flood publishing, exact-k, PX, the shared-IP gater, both spams), paired
topics scored and unscored, and unscored; each without and with faults
and telemetry (the flagship's and unscored also with each alone).  A
non-default knob vector in the reference's ``KNOB_*`` order; every output
equal, the tally to the kernel's lane partials summed; and the vector
moves the outputs it feeds (the knob-free plain version differs).

Tolerance: exact (integer words bitwise, f32/bf16 counters by bit
pattern).
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_paired as paired
import test_torch_surface as surface
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import telemetry as ptl
from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as prc
from test_torch_receive import BLOCK, N, _bits, _np, _operands
from test_torch_knobs import one_thread  # noqa: F401  (autouse)
from test_torch_unscored import unscored_operands
from torch_ref import imported_reference

T = 4
#: a non-default vector: gossip_factor, d_lazy, backoff_ticks; the P4 and
#: P7 weights, the graylist and gossip thresholds
KNOBS = (0.4, 3.0, 13.0, -10.9, -40.0, -60.0, -5.0)
SMALL = dict(d=3, d_lo=2, d_hi=6, d_score=2, d_out=1, d_lazy=2,
             gossip_factor=0.25, backoff_ticks=8)

#: family: (C, scored, paired, score config, receive_consts options)
FAMILIES = {
    "scored": (16, True, False, dict(topic_weight=0.7,
                                     invalid_message_deliveries_weight=-10.9),
               {}),
    "attacks": (16, True, False, dict(sybil_ihave_spam=True,
                                      sybil_iwant_spam=True), {}),
    "full": (16, True, False, dict(sybil_ihave_spam=True,
                                   sybil_iwant_spam=True,
                                   flood_publish=True),
             dict(px=True, same_ip=True, exact_k=True)),
    "paired": (16, True, True, dict(topic_score_cap=25.0,
                                    sybil_ihave_spam=True,
                                    flood_publish=True),
               dict(px=True, same_ip=True, exact_k=True)),
    "paired_unscored": (8, False, True, None, dict(px=True, exact_k=True)),
    "unscored": (8, False, False, None, {}),
}
#: (family, faults, telemetry)
CASES = ([(f, x, x) for f in sorted(FAMILIES) for x in (False, True)]
         + [(f, x, not x) for f in ("scored", "unscored")
            for x in (False, True)])


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        yield r


def _case(family, faults, tel, seed):
    """The port's receive consts of a case, its seeded operands (with
    the knob vector) and the reference's (cfg, score config)."""
    c, scored, is_paired, sc_kw, opts = FAMILIES[family]
    exact = opts.get("exact_k", False)
    offsets = pgs.make_gossip_offsets(T, c, N, seed=3, paired=is_paired)
    cfg_kw = dict(offsets=offsets, n_topics=T, paired_topics=is_paired,
                  binomial_gossip_sampling=not exact,
                  **(SMALL if c == 8 else {}))
    lat = 5 if tel else 0
    k = prc.receive_consts(
        pgs.GossipSimConfig(**cfg_kw),
        pgs.ScoreSimConfig(**sc_kw) if scored else None,
        px=opts.get("px", False), same_ip=opts.get("same_ip", False),
        faults=faults, telemetry=tel, tel_lat_buckets=lat, knobs=True)
    rng = np.random.default_rng(seed)
    if scored:
        ops = _operands(rng, 1, False, pgs.ScoreSimConfig(**sc_kw))
    else:
        ops = unscored_operands(rng, c, N, 1)
    if is_paired:
        ops = paired._paired_operands(rng, ops, c, N, 1, scored)
    if k.flood_publish:
        ops["ctrl"] = torch.from_numpy(
            rng.integers(0, 128, size=(c, N)).astype(np.uint8))
        ops["inj_send"] = (ops["fresh"] & ops["adv"]).contiguous()
    if k.with_same_ip:
        ops["same_ip"] = surface._sibling_words(rng)
    if k.attacks:
        ops["syb"] = torch.from_numpy(np.where(
            rng.random(N) < 0.2, (1 << c) - 1, 0).astype(np.int32))
        ops["iws"] = torch.from_numpy(rng.integers(
            0, 4 * 32, size=(c, N)).astype(np.int16))
    if faults:
        ops["alive_w"] = torch.from_numpy(np.where(
            rng.random(N) < 0.1, 0, -1).astype(np.int32))
        if k.iwant_spam:
            ops["flood_ok"] = torch.from_numpy(rng.integers(
                0, 1 << c, size=N).astype(np.int32))
    if lat:
        pub = torch.from_numpy(rng.integers(0, 40, 32).astype(np.int32))
        ops["lat_masks"] = ptl.latency_bucket_masks(pub, 30, lat, 1)
        ops["dlv_eff"] = torch.from_numpy(rng.integers(
            0, 1 << 32, size=(1, N), dtype=np.uint64).astype(
                np.uint32).view(np.int32))
    ops["knobs"] = torch.tensor(KNOBS[:7 if scored else 3],
                                dtype=torch.float32)
    return k, ops, cfg_kw, sc_kw


def _pallas(ref, k, ops, cfg_kw, sc_kw):
    """The reference kernel on the same operands, in its operand order."""
    import jax.numpy as jnp

    cfg = ref.gs.GossipSimConfig(**cfg_kw)
    sc = ref.gs.ScoreSimConfig(**sc_kw) if k.scored else None
    rc = ref.receive
    pln = rc.plan(N, cfg.offsets, BLOCK)

    def flat(name, p, e):
        return jnp.concatenate([
            rc.extend_wrap(jnp.asarray(r), N, pln["n_pad"], pln[p], pln[e])
            for r in list(_np(ops[name]))])

    krn = rc.make_receive_update(
        cfg, sc, N, BLOCK, jnp.bfloat16 if k.scored else jnp.float32, 1,
        track_promises=k.track_promises, interpret=True, with_static=False,
        with_px=k.with_px, with_same_ip=k.with_same_ip,
        with_faults=k.faults, with_telemetry=k.telemetry,
        tel_lat_buckets=k.tel_lat_buckets, with_knobs=True)
    head = [jnp.asarray(_np(ops["valid"]))] if k.scored else []
    head += [jnp.asarray(np.array(ops["gseeds"], dtype=np.uint32)),
             jnp.asarray(ops["knobs"].numpy())]
    if k.tel_lat_buckets:
        head.append(jnp.asarray(_np(ops["lat_masks"])))
    head.append(jnp.zeros((1,), dtype=jnp.uint32))
    flats = [flat("ctrl", "p8", "e8")]
    if k.paired:
        flats.append(flat("ctrl2", "p8", "e8"))
    flats.append(flat("fresh", "p32", "e32"))
    if k.paired:
        flats.append(flat("fresh_b", "p32", "e32"))
    flats.append(flat("adv", "p32", "e32"))
    if k.flood_publish:
        flats.append(flat("inj_send", "p32", "e32"))
    zero = np.zeros(N, dtype=np.uint32)

    def get(name):
        return _np(ops[name]) if name in ops else zero

    names = (["pay", "gsp", "acc"] if k.scored else []) + [
        "sub_all", "cand_sub", "fanout", "syb", "wa", "bo2", "grafts",
        "dropped", "meshsel"]
    if k.paired:
        names += ["wa_b", "bo2_b", "grafts_b", "dropped_b", "meshsel_b"]
    names += ["seen", "injected", "backoff"]
    if k.paired:
        names.append("backoff_b")
    if k.scored:
        names += ["fd", "inv", "bp", "tim"] + (["tim_b"] if k.paired
                                               else []) + ["iws"]
        if k.with_same_ip:
            names.append("same_ip")
    if k.faults:
        names.append("alive_w")
        if k.iwant_spam:
            names.append("flood_ok")
    if k.tel_lat_buckets:
        names.append("dlv_eff")
    return krn(*head, *flats, *[jnp.asarray(get(n_)) for n_ in names])


@pytest.mark.parametrize("family,faults,tel", CASES)
def test_knob_receive_plain_matches_pallas_kernel(ref, family, faults, tel):
    k, ops, cfg_kw, sc_kw = _case(family, faults, tel,
                                  seed=900 + 4 * len(family) + 2 * faults
                                  + tel)
    got = prc.receive_update(k, **ops)        # CPU tensors: plain version
    want = _pallas(ref, k, ops, cfg_kw, sc_kw)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if tel and i == len(got) - 1:
            # the tally against the kernel's lane partials, summed
            np.testing.assert_array_equal(
                g.numpy(), np.asarray(w).sum(axis=1, dtype=np.int32))
        else:
            np.testing.assert_array_equal(_bits(_np(g)), _bits(w),
                                          err_msg=f"output {i}")
    # non-vacuous: the vector moved the backoff rows and the gates
    base = prc.receive_update(dataclasses.replace(k, knobs=False),
                              **{n_: v for n_, v in ops.items()
                                 if n_ != "knobs"})
    i_bo = 3 if k.paired else 2
    assert not torch.equal(got[i_bo], base[i_bo])
    assert any(not torch.equal(g, b) for g, b in zip(got[i_bo + 1:],
                                                       base[i_bo + 1:]))
