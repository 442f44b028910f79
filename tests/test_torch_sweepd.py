"""The port's sweep server (``go_libp2p_pubsub_tpu_torch/sweepd.py``)
against the JAX package's ``tools/sweepd.py``.

- The batched server (batch 3) and the kernel server (batch 1) give the
  reference's result rows for the same scenario lists: ids,
  ``delivery_fraction``, ``honest_delivery_fraction``, ``inv_bits``,
  ``inv_first``, the batch index and every error row — clean cells, knob
  points, link loss, churn, spam, eclipse and byzantine.  The batched
  server runs the reference's test shape (200 peers, 2 topics, 6
  messages, 8 ticks); the kernel server 256 peers (the reference pads its
  kernel server to the block, 128, and its padded path refuses a ragged
  count).
- ``compiles()`` is 0, then 1, then 1 across waves.
- The line protocol: error rows, ``flush`` / ``stats`` / ``metrics``, an
  unknown ``cmd``; a journal the reference wrote (with a torn tail) is
  replayed and compacted; two threads share one server through
  ``serve_lines(lock=)``; ``main`` over stdin in a subprocess with
  ``--device cpu``; SIGTERM drains and a SIGKILLed server's journal
  replays (``sweepd_bench.restart_check`` at 200 peers).
- Every refusal by name: ``--devices``, ``--k-slots`` on the batched
  server, the kernel server's batch, and under ``--multi`` (served since
  the serving slice) ``--kernel`` and the front end's own config errors;
  the kernel server's attack axis and its refusal hints equal the
  reference's.
"""

import io
import json
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from go_libp2p_pubsub_tpu_torch import obs as pobs
from go_libp2p_pubsub_tpu_torch import sweepd as psw
from go_libp2p_pubsub_tpu_torch import sweepd_bench
from go_libp2p_pubsub_tpu_torch.models import plan
from go_libp2p_pubsub_tpu_torch.parallel import checkpoint as pck
from test_torch_knobs import one_thread  # noqa: F401  (autouse)
from torch_ref import imported_reference

ROOT = Path(__file__).resolve().parents[1]
SHAPE = dict(n=200, t=2, m=6, ticks=8, seed=0)
KERNEL_SHAPE = dict(n=256, t=2, m=6, ticks=8, seed=0)

BATCHED_REQUESTS = [
    {"id": "a", "seed": 1},
    {"id": "b", "knobs": {"d": 5, "gossip_factor": 0.4}},
    {"id": "c", "drop_prob": 0.05},
    {"id": "d", "attack": "spam", "attack_frac": 0.1},
    {"id": "e", "attack": "eclipse", "attack_frac": 0.15},
    {"id": "f", "attack": "byzantine", "attack_frac": 0.1,
     "knobs": {"invalid_message_deliveries_weight": 0.0}},
    {"id": "g", "churn": True, "drop_prob": 0.2, "seed": 4},
    {"id": "bad", "knobs": {"offsets": [1, -1]}},
    {"id": "h", "knobs": {"backoff_ticks": 4, "d_lazy": 3}},
    {"id": "frac", "attack": "spam", "attack_frac": 0.9},
    {"id": "delay", "knobs": {"delay_base": 2}},
    {"id": "twice", "drop_prob": 0.1, "knobs": {"drop_prob": 0.2}},
    {"id": "typed", "knobs": [1, 2]},
]

KERNEL_REQUESTS = [
    {"id": "ref"}, {"id": "d5", "knobs": {"d": 5, "d_hi": 9}},
    {"id": "gf40", "knobs": {"gossip_factor": 0.4, "backoff_ticks": 6}},
    {"id": "loss", "drop_prob": 0.05, "churn": True},
    {"id": "spam", "attack": "spam", "attack_frac": 0.1},
    {"id": "ecl", "attack": "eclipse", "attack_frac": 0.1},
    {"id": "byz", "attack": "byzantine"},
]


@pytest.fixture(scope="module")
def ref():
    """One reference server of each kind, and its rows for the lists."""
    with imported_reference() as r:
        import tools.sweepd as rsw
        from go_libp2p_pubsub_tpu.parallel import checkpoint as rck
        r.sweepd, r.ck = rsw, rck
        r.batched = rsw.SweepServer(batch=3, **SHAPE)
        r.batched_rows = r.batched.submit([dict(q)
                                           for q in BATCHED_REQUESTS])
        r.kernel = rsw.SweepServer(batch=1, kernel=True, receive_block=128,
                                   interpret=True, **KERNEL_SHAPE)
        r.kernel_rows = r.kernel.submit([dict(q) for q in KERNEL_REQUESTS])
        yield r


def _server(batch=3, **kw):
    return psw.SweepServer(**dict(SHAPE, batch=batch, device="cpu", **kw))


def test_batched_rows_equal_the_references(ref):
    srv = _server()
    assert srv.compiles() == 0
    rows = srv.submit([dict(q) for q in BATCHED_REQUESTS])
    assert rows == ref.batched_rows
    assert srv.compiles() == 1
    # a second wave of other scenarios: still one step
    more = srv.submit([{"id": "w2", "knobs": {"d": 8, "d_hi": 12}},
                       {"id": "w3", "attack": "eclipse"}])
    assert all(r["ok"] for r in more) and srv.compiles() == 1
    # non-vacuous: the attacks and faults move the fractions, and the
    # bad requests are error rows
    by_id = {r["id"]: r for r in rows}
    assert by_id["g"]["delivery_fraction"] < 1.0
    assert by_id["d"]["delivery_fraction"] < 1.0
    assert "offsets" in by_id["bad"]["error"]
    assert not by_id["delay"]["ok"] and "--k-slots" in by_id["delay"]["error"]
    st = srv.stats()
    assert st["served"] == len([r for r in rows if r["ok"]]) + 2
    assert st["compiles"] == 1 and st["shape"]["devices"] == 1


def test_kernel_rows_attack_axis_and_hints_equal_the_references(ref):
    srv = psw.SweepServer(**dict(KERNEL_SHAPE, batch=1, kernel=True,
                                 device="cpu"))
    assert srv.attack_kinds == ref.kernel.attack_kinds == (
        "clean", "spam", "eclipse")
    assert srv._kind_refusals == ref.kernel._kind_refusals
    assert dict(vars(srv.sc)) == {
        f: getattr(ref.kernel.sc, f) for f in vars(srv.sc)}
    rows = srv.submit([dict(q) for q in KERNEL_REQUESTS])
    assert rows == ref.kernel_rows
    assert srv.compiles() == 1
    assert not rows[-1]["ok"] and "pallas step" in rows[-1]["error"]


def test_kernel_capability_follows_the_route():
    from go_libp2p_pubsub_tpu_torch.models import gossipsub as pgs
    kinds, armed, refusals = psw._kernel_attack_axis("cpu")
    assert armed == {"sybil_ihave_spam": True, "sybil_eclipse": True}
    assert refusals["sybil_iwant_spam"] == plan.MSG_KERNEL_KNOB_IWANT_SPAM
    assert refusals["byzantine"] == plan.MSG_KERNEL_CONFIG
    assert pgs.kernel_capability.__doc__


def test_server_capability_and_refusals_by_name(ref):
    for kw in (dict(kernel=True, batch=2), dict(kernel=True, devices=2),
               dict(kernel=True, batch=1), dict(batch=6)):
        assert psw.server_capability(**kw) == ref.sweepd.server_capability(
            **kw)
    with pytest.raises(ValueError) as err:
        psw.SweepServer(**dict(SHAPE, batch=2, kernel=True, device="cpu"))
    assert str(err.value) == plan.MSG_SERVE_KERNEL_BATCH
    with pytest.raises(ValueError) as err:
        psw.SweepServer(**dict(SHAPE, batch=1, kernel=True, devices=2,
                               device="cpu"))
    assert str(err.value) == plan.MSG_SERVE_KERNEL_DEVICES
    with pytest.raises(plan.SliceRefusal) as err:
        psw.SweepServer(**dict(SHAPE, batch=3, devices=4, device="cpu"))
    assert err.value.name == "serve_devices" and "A9" in str(err.value)
    with pytest.raises(plan.SliceRefusal) as err:
        psw.SweepServer(**dict(SHAPE, batch=3, k_slots=4, device="cpu"))
    assert err.value.name == "loops_delays"


def test_the_kernel_server_serves_delay_knobs_with_k_slots():
    srv = psw.SweepServer(**dict(KERNEL_SHAPE, batch=1, kernel=True,
                                 k_slots=4, device="cpu"))
    rows = srv.submit([{"id": "d2", "knobs": {"delay_base": 2,
                                              "delay_jitter": 1}},
                       {"id": "d1"}])
    assert all(r["ok"] for r in rows), rows
    assert rows[0]["delivery_fraction"] <= rows[1]["delivery_fraction"]


def _lines(out: str) -> list[dict]:
    return [json.loads(ln) for ln in out.strip().splitlines()]


#: stats fields that are timings (host-clock dependent)
TIMING = ("replica_hbps", "requests_per_sec", "wall_s", "device_s")


def test_line_protocol_equals_the_references(ref):
    lines = [json.dumps({"id": "ok1"}), "{not json",
             json.dumps([1, 2]),
             json.dumps({"id": "bad", "knobs": {"offsets": [1, -1]}}),
             json.dumps({"cmd": "flush"}),
             json.dumps({"id": "ok2", "knobs": {"d_lazy": 4}}),
             json.dumps({"cmd": "nope"}),
             json.dumps({"cmd": "stats"}),
             json.dumps({"cmd": "metrics"})]
    mine = _server()
    # the same counters before the lines as the reference's server
    mine.submit([dict(q) for q in BATCHED_REQUESTS])
    outs = []
    for srv in (ref.batched, mine):
        out = io.StringIO()
        srv.serve_lines(lines, out)
        outs.append(_lines(out.getvalue()))
    assert len(outs[1]) == len(outs[0])
    for got, want in zip(outs[1], outs[0]):
        if want.get("stats"):
            want = {k: v for k, v in want.items() if k not in TIMING}
            got = {k: v for k, v in got.items() if k not in TIMING}
        if want.get("error", "").startswith("bad JSON"):
            assert got["error"].startswith("bad JSON")
            continue
        assert got == want


def test_metrics_verb_needs_a_bundle_and_publishes_the_counters():
    srv = psw.SweepServer(n=64, t=1, m=2, ticks=4, batch=2,
                          invariants=False, device="cpu")
    out = io.StringIO()
    srv.serve_lines([json.dumps({"cmd": "metrics"})], out)
    assert "no observability bundle" in _lines(out.getvalue())[0]["error"]
    o = pobs.Observability()
    srv2 = psw.SweepServer(n=64, t=1, m=2, ticks=4, batch=2,
                           invariants=False, obs=o, device="cpu")
    out2 = io.StringIO()
    reqs = [json.dumps({"id": f"q{i}", "seed": i}) for i in range(2)]
    srv2.serve_lines(reqs + [json.dumps({"cmd": "metrics"})], out2)
    met = next(r for r in _lines(out2.getvalue()) if r.get("metrics"))
    fam = {f["name"]: f for f in met["families"]}
    assert fam["pubsub_sweepd_served_total"]["samples"][0]["value"] == 2
    assert fam["pubsub_sweepd_compiles"]["samples"][0]["value"] == 1


def test_journal_written_by_the_reference_replays_and_compacts(ref,
                                                               tmp_path):
    """The reference's journal codec, a legacy (suffix-less) line and a
    torn tail: the port replays the intact lines (a full batch
    dispatches), drops the torn one, and compacts the journal to the
    partial batch left, which EOF then serves."""
    journal = tmp_path / "j"
    raws = [json.dumps({"id": f"j{i}", "seed": i}) for i in range(4)]
    text = "".join(ref.ck.journal_encode_line(r) + "\n" for r in raws[:3])
    text += raws[3] + "\n"                         # legacy line
    torn = ref.ck.journal_encode_line(json.dumps({"id": "torn"}))
    text += torn[:-3] + "\n"
    journal.write_text(text)
    assert pck.read_journal(str(journal)) == ref.ck.read_journal(
        str(journal))
    assert pck.journal_encode_line(raws[0]) == ref.ck.journal_encode_line(
        raws[0])
    with pytest.raises(ValueError, match="newline-free"):
        pck.journal_encode_line("a\nb")
    srv = _server()
    out = io.StringIO()
    srv.serve_lines([json.dumps({"id": "new"})], out, journal=str(journal))
    rows = _lines(out.getvalue())
    ids = [r.get("id") for r in rows if "id" in r]
    assert ids == ["j0", "j1", "j2", "j3", "new"]
    assert rows[-1]["stats"] and rows[-1]["served"] == 5
    assert pck.read_journal(str(journal)) == ([], 0)
    # the same journal through the reference gives the same rows
    journal.write_text(text)
    out_r = io.StringIO()
    ref.batched.serve_lines([json.dumps({"id": "new"})], out_r,
                            journal=str(journal))
    def strip(rs):      # the reference's server has dispatched before
        return [{k: v for k, v in r.items() if k != "batch"}
                for r in rs if "id" in r]
    assert strip(_lines(out_r.getvalue())) == strip(rows)


def test_two_threads_share_one_server():
    srv = _server()
    lock = threading.RLock()
    outs = [io.StringIO(), io.StringIO()]

    def client(k):
        lines = [json.dumps({"id": f"c{k}-{i}", "seed": i % 2})
                 for i in range(4)]
        srv.serve_lines(lines, outs[k], lock=lock)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    rows = [r for o in outs for r in _lines(o.getvalue())]
    terminal = [r for r in rows if not r.get("stats")]
    assert len(terminal) == 8 and all(r["ok"] for r in terminal)
    assert srv.compiles() == 1


def test_main_over_stdin_on_the_cpu(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    lines = [{"id": "m0"}, {"id": "m1", "attack": "spam"},
             {"id": "m2", "drop_prob": 0.1}]
    out = subprocess.run(
        [sys.executable, "-m", "go_libp2p_pubsub_tpu_torch.sweepd",
         "--peers", "200", "--topics", "2", "--msgs", "6", "--ticks", "8",
         "--batch", "2", "--device", "cpu"],
        cwd=ROOT, input="".join(json.dumps(q) + "\n" for q in lines),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rows = _lines(out.stdout)
    want = _server(batch=2).submit([dict(q) for q in lines])
    assert rows[:-1] == want
    assert rows[-1]["stats"] and rows[-1]["compiles"] == 1


@pytest.mark.parametrize("args,name", [
    (["--devices", "2"], "serve_devices"),
    (["--multi", "--kernel"], "sweepd: --multi refuses --kernel"),
    (["--multi", "--batch", "1"], "batch=1 is sweepd's sequential"),
    (["--multi", "--long-ticks", "9"], "long_ticks > 0 needs ckpt_dir"),
    (["--k-slots", "4"], "loops_delays"),
    (["--kernel", "--devices", "2"], "sweepd: --devices shards"),
])
def test_main_refuses_by_name(args, name, capsys):
    rc = psw.main(["--peers", "64", "--topics", "1", "--msgs", "2",
                   "--ticks", "4", "--device", "cpu", *args])
    err = capsys.readouterr().err
    assert rc == 2
    assert name in err and "Traceback" not in err
    assert not pck.stop_requested()


def test_sigterm_drains_and_a_killed_server_replays_its_journal(
        monkeypatch, tmp_path):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(sweepd_bench, "RESTART_SHAPE", (200, 2, 6, 8, 3))
    out = sweepd_bench.restart_check("cpu", str(tmp_path))
    assert out["ok"], out
    assert out["exit_codes"]["sigterm_drain"] == 0
    assert out["exit_codes"]["sigkill"] != 0
