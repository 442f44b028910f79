"""B1's plain version in delay mode against the JAX reference's Pallas
receive kernel ``make_receive_update(with_delays=True)`` in interpret
mode, on seeded random operands (``n_true`` = 1,024, block 128), each
family the port's delayed variants serve: the flagship's scored options,
the attack options tracking promises (the IHAVE spam: the IWANT flood is
refused under delays), the full variant's options (flood publishing,
exact-k, PX, the shared-IP gater, the IHAVE spam) and unscored; each
without and with the knob vector.  The delay mode's operands (this tick's
arrivals [C·W, N], the GRAFT, PRUNE and retraction words and, tracking
promises, the broken-promise adverts arriving) in place of the sender
streams; every output equal, and each is shown to move what it feeds (the
arrivals the possession and P2/P4 counters, the retractions the mesh, the
broken-promise adverts P7); and the delay mode's refusals.

Tolerance: exact (integer words bitwise, f32/bf16 counters by bit
pattern).
"""

import dataclasses

import numpy as np
import pytest
import torch

import test_torch_surface as surface
from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
from go_libp2p_pubsub_tpu_torch.models import plan
from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as prc
from test_torch_knobs import one_thread  # noqa: F401  (autouse)
from test_torch_knobs_kernel import KNOBS, SMALL
from test_torch_receive import BLOCK, N, _bits, _np, _operands
from test_torch_unscored import unscored_operands
from torch_ref import imported_reference

T = 4
#: family: (C, scored, score config, receive_consts options)
FAMILIES = {
    "scored": (16, True, dict(topic_weight=0.7,
                              invalid_message_deliveries_weight=-10.9), {}),
    "attacks": (16, True, dict(sybil_ihave_spam=True), {}),
    "full": (16, True, dict(sybil_ihave_spam=True, flood_publish=True,
                            topic_score_cap=25.0),
             dict(px=True, same_ip=True, exact_k=True)),
    "unscored": (8, False, None, dict(px=True)),
}
CASES = [(f, kn) for f in sorted(FAMILIES) for kn in (False, True)]


@pytest.fixture(scope="module")
def ref():
    with imported_reference() as r:
        yield r


def _case(family, knobs, seed):
    """The port's receive consts of a case, its seeded delay-mode operands
    and the reference's (cfg, score config) keywords."""
    c, scored, sc_kw, opts = FAMILIES[family]
    exact = opts.get("exact_k", False)
    offsets = pgs.make_gossip_offsets(T, c, N, seed=3)
    cfg_kw = dict(offsets=offsets, n_topics=T,
                  binomial_gossip_sampling=not exact,
                  **(SMALL if c == 8 else {}))
    k = prc.receive_consts(
        pgs.GossipSimConfig(**cfg_kw),
        pgs.ScoreSimConfig(**sc_kw) if scored else None,
        px=opts.get("px", False), same_ip=opts.get("same_ip", False),
        knobs=knobs, delays=True)
    rng = np.random.default_rng(seed)
    if scored:
        ops = _operands(rng, 1, False, pgs.ScoreSimConfig(**sc_kw))
    else:
        ops = unscored_operands(rng, c, N, 1)
    for name in prc.SENDER_OPERANDS:
        ops.pop(name, None)

    def words(shape, bits=32):
        a = rng.integers(0, 1 << bits, size=shape, dtype=np.uint64)
        b = rng.integers(0, 1 << bits, size=shape, dtype=np.uint64)
        return torch.from_numpy((a & b).astype(np.uint32).view(np.int32))

    ops.update(arr=words((c, N)), graft_arr=words((N,), c),
               prune_arr=words((N,), c), retract=words((N,), c))
    if k.track_promises:
        ops["cheat_arr"] = words((N,), c)
    if k.with_same_ip:
        ops["same_ip"] = surface._sibling_words(rng)
    if k.attacks:
        ops["syb"] = torch.from_numpy(np.where(
            rng.random(N) < 0.2, (1 << c) - 1, 0).astype(np.int32))
    if knobs:
        ops["knobs"] = torch.tensor(KNOBS[:7 if scored else 3],
                                    dtype=torch.float32)
    return k, ops, cfg_kw, sc_kw


def _pallas(ref, k, ops, cfg_kw, sc_kw):
    """The reference kernel in delay mode on the same operands, in its
    operand order: no sender streams; the arrivals, handshake words and
    (tracking promises) broken-promise adverts first among the blocked
    operands."""
    import jax.numpy as jnp

    cfg = ref.gs.GossipSimConfig(**cfg_kw)
    sc = ref.gs.ScoreSimConfig(**sc_kw) if k.scored else None
    krn = ref.receive.make_receive_update(
        cfg, sc, N, BLOCK, jnp.bfloat16 if k.scored else jnp.float32, 1,
        track_promises=k.track_promises, interpret=True, with_static=False,
        with_px=k.with_px, with_same_ip=k.with_same_ip,
        with_knobs=k.knobs, with_delays=True)
    head = [jnp.asarray(_np(ops["valid"]))] if k.scored else []
    head.append(jnp.asarray(np.array(ops["gseeds"], dtype=np.uint32)))
    if k.knobs:
        head.append(jnp.asarray(ops["knobs"].numpy()))
    head.append(jnp.zeros((1,), dtype=jnp.uint32))
    zero = np.zeros(N, dtype=np.uint32)

    def get(name):
        return _np(ops[name]) if name in ops else zero

    names = ["arr", "graft_arr", "prune_arr", "retract"]
    if k.track_promises:
        names.append("cheat_arr")
    names += ["sub_all", "cand_sub", "fanout", "syb", "wa", "bo2", "grafts",
              "dropped", "meshsel", "seen", "injected", "backoff"]
    if k.scored:
        names += ["fd", "inv", "bp", "tim", "iws"]
        if k.with_same_ip:
            names.append("same_ip")
    return krn(*head, *[jnp.asarray(get(n_)) for n_ in names])


@pytest.mark.parametrize("family,knobs", CASES)
def test_delayed_receive_plain_matches_pallas_kernel(ref, family, knobs):
    k, ops, cfg_kw, sc_kw = _case(family, knobs,
                                  seed=1300 + 4 * len(family) + knobs)
    got = prc.receive_update(k, **ops)        # CPU tensors: plain version
    want = _pallas(ref, k, ops, cfg_kw, sc_kw)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_bits(_np(g)), _bits(w),
                                      err_msg=f"output {i}")
    # non-vacuous: no arrivals, no retractions, no broken promises each
    # move what they feed
    for name, idx in (("arr", 0), ("retract", 1)):
        quiet = dict(ops, **{name: torch.zeros_like(ops[name])})
        assert not torch.equal(prc.receive_update(k, **quiet)[idx], got[idx])
    if k.track_promises:
        quiet = dict(ops, cheat_arr=torch.zeros_like(ops["cheat_arr"]))
        i_bp = 2 + 1 + prc.n_gates(True, False) + 2     # bp after fd, inv
        assert not torch.equal(prc.receive_update(k, **quiet)[i_bp],
                               got[i_bp])


def test_the_delay_mode_checks_its_operands_and_options():
    k, ops, cfg_kw, sc_kw = _case("scored", False, seed=5)
    with pytest.raises(ValueError, match="missing \\['retract'\\]"):
        prc.receive_update(k, **{n_: v for n_, v in ops.items()
                                 if n_ != "retract"})
    with pytest.raises(ValueError, match="unexpected \\['ctrl'\\]"):
        prc.receive_update(k, **dict(ops, ctrl=torch.zeros(
            (16, N), dtype=torch.uint8)))
    cfg = pgs.GossipSimConfig(**cfg_kw)
    with pytest.raises(ValueError) as err:
        prc.receive_consts(cfg, pgs.ScoreSimConfig(sybil_iwant_spam=True),
                           delays=True)
    assert str(err.value) == plan.MSG_KERNEL_DELAY_IWANT_SPAM
    with pytest.raises(ValueError, match="no fault or telemetry"):
        prc.receive_consts(cfg, pgs.ScoreSimConfig(), delays=True,
                           faults=True)
    paired = pgs.GossipSimConfig(**dict(cfg_kw, paired_topics=True))
    with pytest.raises(NotImplementedError) as err:
        prc.receive_consts(paired, None, delays=True)
    assert str(err.value) == plan.MSG_DELAYS_PAIRED
    assert prc.variant(k) == "scored+delays"
    assert prc.variant(dataclasses.replace(k, knobs=True)) == (
        "scored+delays+knobs")
    assert prc.library(k) == "receive_delays"
