"""The port's receive_update_plain against the reference's Pallas receive
kernel (make_receive_update, interpret mode) on seeded random operands.

The JAX-side flats are built with the reference's own plan/extend_wrap
(n_true=1024, block=128: the wrap-extended layout); the port reads the
sender at (p + o_j) mod N directly.  Every output must be EXACTLY equal:
integer words bitwise, f32/bf16 counters by bit pattern.
"""

import numpy as np
import pytest
import torch

from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.ops import graph as pg
from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as prc
from torch_ref import imported_reference

N, BLOCK, C, T = 1024, 128, 16, 4


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        yield r


def _bf16_edges(rng, shape, dtz, decay):
    """bf16-representable counters drawn across decay_to_zero (values
    that decay to just above / below it), the gater's pressure range and
    wide magnitudes."""
    kind = rng.integers(0, 4, size=shape)
    edge = dtz / decay * (1 + rng.normal(0, 0.02, size=shape))
    v = np.where(kind == 0, 0.0,
                 np.where(kind == 1, edge,
                          np.where(kind == 2, rng.uniform(0, 3, shape),
                                   rng.uniform(0, 60, shape))))
    return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)


def _operands(rng, w_words, with_static, sc):
    """Seeded operands in the port's layout (torch, int32-held words)."""
    def words(shape, bits=32):
        a = rng.integers(0, 1 << bits, size=shape, dtype=np.uint64)
        return torch.from_numpy(a.astype(np.uint32).view(np.int32))

    def sparse(shape):
        a = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
        b = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
        return torch.from_numpy((a & b).astype(np.uint32).view(np.int32))

    sub = rng.random(N) < 0.8
    dtz = sc.decay_to_zero
    tim = rng.integers(0, 60, size=(C, N))
    tim[:, :40] = 32760 + rng.integers(0, 7, size=(C, 40))
    return dict(
        valid=words((w_words,)),
        gseeds=(int(rng.integers(0, 1 << 32)), int(rng.integers(0, 1 << 32))),
        ctrl=torch.from_numpy(rng.integers(0, 64, size=(C, N)).astype(
            np.uint8)),
        fresh=sparse((w_words, N)), adv=words((w_words, N)),
        pay=words((N,), C), gsp=words((N,), C), acc=words((N,), C),
        sub_all=torch.from_numpy(np.where(sub, (1 << C) - 1, 0).astype(
            np.int32)),
        cand_sub=words((N,), C), fanout=sparse((N,)) & ((1 << C) - 1),
        wa=words((N,), C), bo2=words((N,), C), grafts=sparse((N,)) & 0xFFFF,
        dropped=sparse((N,)) & 0xFFFF, meshsel=words((N,), C),
        seen=sparse((w_words, N)), injected=sparse((w_words, N)) & 0x0F0F,
        backoff=torch.from_numpy(rng.integers(0, 61, size=(C, N)).astype(
            np.int16)),
        static=(torch.from_numpy(rng.normal(0, 1, (C, N)).astype(np.float32))
                if with_static else None),
        fd=_bf16_edges(rng, (C, N), dtz, sc.first_message_deliveries_decay),
        inv=_bf16_edges(rng, (C, N), dtz,
                        sc.invalid_message_deliveries_decay),
        bp=_bf16_edges(rng, (C, N), dtz, sc.behaviour_penalty_decay),
        tim=torch.from_numpy(tim.astype(np.int16)),
        iws=torch.from_numpy(rng.integers(0, 30001, size=(C, N)).astype(
            np.int16)))


def _np(t):
    """A torch operand as the numpy array the reference takes."""
    if t.dtype == torch.int32:
        return t.numpy().view(np.uint32)
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _bits(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    if a.dtype == np.float32:
        return a.view(np.uint32)
    return a


def _reference_outputs(ref, cfg, sc, ops, w_words, with_static):
    import jax.numpy as jnp

    rc = ref.receive
    pln = rc.plan(N, cfg.offsets, BLOCK)
    ctrl = _np(ops["ctrl"])

    def flat8(rows):
        return jnp.concatenate([
            rc.extend_wrap(jnp.asarray(r), N, pln["n_pad"], pln["p8"],
                           pln["e8"]) for r in rows])

    def flat32(rows):
        return jnp.concatenate([
            rc.extend_wrap(jnp.asarray(r), N, pln["n_pad"], pln["p32"],
                           pln["e32"]) for r in rows])

    krn = rc.make_receive_update(cfg, sc, N, BLOCK, jnp.bfloat16, w_words,
                                 interpret=True, with_static=with_static)
    head = [jnp.asarray(_np(ops["valid"])),
            jnp.asarray(np.array(ops["gseeds"], dtype=np.uint32))]
    flats = [flat8(list(ctrl)), flat32(list(_np(ops["fresh"]))),
             flat32(list(_np(ops["adv"])))]
    syb = np.zeros(N, dtype=np.uint32)
    blocked = [ops[k_] for k_ in ("pay", "gsp", "acc", "sub_all",
                                   "cand_sub", "fanout")]
    blocked = [_np(t) for t in blocked] + [syb] + [
        _np(ops[k_]) for k_ in ("wa", "bo2", "grafts", "dropped",
                                 "meshsel", "seen", "injected", "backoff")]
    if with_static:
        blocked.append(_np(ops["static"]))
    blocked += [_np(ops[k_]) for k_ in ("fd", "inv", "bp", "tim", "iws")]
    base0 = jnp.zeros((1,), dtype=jnp.uint32)
    return krn(*head, base0, *flats, *[jnp.asarray(b) for b in blocked])


NAMES = ("acq", "mesh", "backoff", "g_accept", "g_gossip", "g_publish",
         "g_nonneg", "g_payload", "g_targets", "g_backoff", "fd", "inv",
         "bp", "tim", "iws")


@pytest.mark.parametrize("w_words", [1, 2])
@pytest.mark.parametrize("with_static", [False, True])
def test_receive_plain_matches_pallas_kernel(ref, w_words, with_static):
    offsets = ref.gs.make_gossip_offsets(T, C, N, seed=3)
    cfg = ref.gs.GossipSimConfig(offsets=offsets, n_topics=T)
    sc = ref.gs.ScoreSimConfig()
    k = prc.receive_consts(pgs.GossipSimConfig(offsets=offsets, n_topics=T),
                           pgs.ScoreSimConfig())
    rng = np.random.default_rng(10 * w_words + with_static)
    ops = _operands(rng, w_words, with_static, sc)
    got = prc.receive_update(k, **ops)        # CPU tensors: plain version
    want = _reference_outputs(ref, cfg, sc, ops, w_words, with_static)
    assert len(got) == len(want) == len(NAMES)
    for name, g, w in zip(NAMES, got, want):
        gb = _bits(_np(g))
        np.testing.assert_array_equal(gb, _bits(w), err_msg=name)
    # non-vacuous: the gater engaged somewhere and the handshake moved
    gate_pay, gate_acc = got[7], got[3]
    assert (gate_pay != gate_acc).any()
    assert (got[1] != ops["meshsel"]).any()
    assert (pg.popcount32(got[0]).sum() > 0)
