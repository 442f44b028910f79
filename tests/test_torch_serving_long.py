"""The port's front end on its long path, journal, runner records and
metrics, against the JAX package's front end where the result is
deterministic.

- The long path (``ckpt_gossip_run`` a request, snapshots every 4 ticks
  of 16): its digest equals the reference's, uninterrupted and resumed
  after ``request_stop`` (the request parked in the journal, then
  replayed by a new front end); so do its fractions; the digest at the
  serving row's shape is ``serving_bench.REFERENCE_KILL_DIGEST``.
- Journal replay past a torn tail: the intact lines replay, the torn one
  is named on stderr as by the reference, the journal compacts to empty.
- Runner records (``--aot-dir``): a round trip serves identical rows with
  ``compiles() == 0``; a stale record (another library hash, spec or
  layout) gets the reference's named stderr line and a fresh build.
- The ``metrics`` verb: families and span summary, the accounting
  identity on every snapshot taken between requests.
"""

import io
import json
import os

import pytest

from go_libp2p_pubsub_tpu_torch import serving_bench
from go_libp2p_pubsub_tpu_torch.parallel import checkpoint as pck
from go_libp2p_pubsub_tpu_torch.serving import (
    FrontendConfig, ScenarioFrontend, buckets)
from test_torch_knobs import one_thread  # noqa: F401  (autouse)
from torch_ref import imported_reference

T = {"n": 64, "t": 2, "m": 4, "ticks": 16}
RAW = json.dumps(dict(T, id="long1", seed=5), sort_keys=True)


def _long_cfg(root, tag, **server_kw):
    return dict(batch=2, max_buckets=2, default_shape=(64, 2, 4, 8),
                long_ticks=16, ckpt_dir=os.path.join(root, tag),
                ckpt_every=4, server_kw=dict({"seed": 113}, **server_kw))


def _serve(fe, lines, journal=None):
    buf = io.StringIO()
    fe.serve_lines(lines, buf, journal=journal)
    return [json.loads(x) for x in buf.getvalue().splitlines()]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's long row for RAW, served uninterrupted."""
    root = str(tmp_path_factory.mktemp("ref_long"))
    with imported_reference() as r:
        import tools.sweepd  # noqa: F401  (the front end's lazy import)
        from go_libp2p_pubsub_tpu import serving as rserving
        fe = rserving.ScenarioFrontend(rserving.FrontendConfig(
            **_long_cfg(root, "ref")))
        rows = _serve(fe, [RAW])
        r.long_row = next(x for x in rows if x.get("long"))
        r.stats = rows[-1]
        yield r


def _fe(root, tag):
    return ScenarioFrontend(FrontendConfig(**_long_cfg(
        root, tag, device="cpu")))


def test_long_path_digest_equals_the_references(ref, tmp_path):
    rows = _serve(_fe(str(tmp_path), "port"), [RAW])
    row = next(x for x in rows if x.get("long"))
    assert row == ref.long_row
    assert row["ok"] and not row["resumed"]
    assert len(row["digest"]) == 32
    st = rows[-1]
    assert st["long_served"] == 1 and st["served"] == 1
    for k in ("admitted", "served", "errors", "long_served",
              "long_resumed", "traced_buckets", "parked", "queued"):
        assert st[k] == ref.stats[k], k
    # the snapshot directory is removed once the digest is proven
    assert not os.listdir(os.path.join(str(tmp_path), "port"))


def test_long_path_resumes_after_a_stop_to_the_references_digest(
        ref, tmp_path):
    journal = str(tmp_path / "serve.journal")
    pck.request_stop()
    try:
        rows = _serve(_fe(str(tmp_path), "live"), [RAW], journal=journal)
    finally:
        pck.clear_stop()
    parked = next(r for r in rows if r.get("interrupted"))
    assert parked["journaled"] and "bit-identical" in parked["error"]
    assert "tick 4/16" in parked["error"]
    assert rows[-1]["parked"] == 1 and rows[-1]["served"] == 0
    assert pck.read_journal(journal)[0] == [RAW]
    rows = _serve(_fe(str(tmp_path), "live"), [], journal=journal)
    res = next(r for r in rows if r.get("long"))
    assert res["resumed"] and res["ok"]
    assert res["digest"] == ref.long_row["digest"]
    assert {k: v for k, v in res.items() if k != "resumed"} == {
        k: v for k, v in ref.long_row.items() if k != "resumed"}
    assert rows[-1]["long_resumed"] == 1 and rows[-1]["journal_replays"] == 1
    assert pck.read_journal(journal)[0] == []


def test_kill_scenario_digest_is_the_references(tmp_path):
    """The serving row's kill scenario (256 peers, 400 ticks) served whole
    on the CPU gives the JAX package's digest (SERVE_r18.json's)."""
    row = serving_bench.uninterrupted_digest("cpu", 400, str(tmp_path))
    assert row["digest"] == serving_bench.REFERENCE_KILL_DIGEST


def test_frontend_replays_intact_lines_past_a_torn_tail(tmp_path, capsys):
    journal = tmp_path / "serve.journal"
    short = {"n": 64, "t": 2, "m": 4, "ticks": 4}
    raws = [json.dumps(dict(short, id=f"r{i}", seed=i)) for i in range(2)]
    torn = pck.journal_encode_line(json.dumps(dict(short, id="r9")))[:-4]
    journal.write_text("".join(pck.journal_encode_line(r) + "\n"
                               for r in raws) + torn)
    fe = ScenarioFrontend(FrontendConfig(
        batch=2, server_kw={"seed": 109, "device": "cpu"}))
    rows = _serve(fe, [], journal=str(journal))
    err = capsys.readouterr().err
    assert "dropping 1 torn journal line(s)" in err
    assert "replaying 2 journaled request line(s)" in err
    assert [r["id"] for r in rows if r.get("ok")] == ["r0", "r1"]
    assert rows[-1]["stats"] and rows[-1]["admitted"] == 2
    assert rows[-1]["journal_replays"] == 2
    assert journal.read_text() == ""


def _aot_fe(aot, seed=112):
    return ScenarioFrontend(FrontendConfig(
        batch=2, aot_dir=aot, server_kw={"seed": seed, "device": "cpu"}))


def _aot_rows(fe):
    short = {"n": 64, "t": 2, "m": 4, "ticks": 8}
    fe.admit(dict(short, id="a"))
    fe.admit(dict(short, id="b", knobs={"d": 5, "d_lo": 4, "d_hi": 8}))
    rows = fe.drain()
    assert all(r["ok"] for r in rows), rows
    return [{k: v for k, v in r.items() if k != "queue_s"} for r in rows]


def test_runner_record_round_trip_adds_no_compile(tmp_path):
    aot = str(tmp_path / "aot")
    fe1 = _aot_fe(aot)
    want = _aot_rows(fe1)
    st1 = fe1.stats()
    assert st1["aot_exports"] == 1 and st1["aot_loads"] == 0
    assert st1["traced_buckets"] == 1
    (name,) = os.listdir(aot)
    assert name.startswith("bucket-n64-t2-m4-ticks8-k0-")
    rec = json.loads((tmp_path / "aot" / name).read_text())
    assert rec["format"] == buckets.AOT_FORMAT and rec["route"] == "combined"
    assert set(rec["libraries"]) == {"select"}
    assert rec["leaves"]["honest"] == {"": [[2, 64], "bool"]}
    fe2 = _aot_fe(aot)
    got = _aot_rows(fe2)
    st2 = fe2.stats()
    assert st2["aot_loads"] == 1 and st2["compiles"] == 0
    assert st2["traced_buckets"] == 0 and got == want
    (bucket,) = [fe2.buckets.get(s) for s in fe2.buckets.specs()]
    assert bucket.aot and bucket.server.stats()["shape"]["aot"]


@pytest.mark.parametrize("field,value", [
    ("libraries", {"select": "0" * 16}), ("spec", [128, 2, 4, 8, 0]),
    ("route", "kernel"), ("version", 0), ("format", "jax.export")])
def test_a_stale_runner_record_is_named_and_rebuilt(tmp_path, capsys,
                                                    field, value):
    aot = str(tmp_path / "aot")
    want = _aot_rows(_aot_fe(aot, seed=114))
    (name,) = os.listdir(aot)
    path = tmp_path / "aot" / name
    rec = json.loads(path.read_text())
    rec[field] = value
    path.write_text(json.dumps(rec))
    capsys.readouterr()
    fe = _aot_fe(aot, seed=114)
    got = _aot_rows(fe)
    err = capsys.readouterr().err
    assert f"serving: AOT blob {path} unusable (ValueError: " in err
    assert "falling back to tracing" in err
    st = fe.stats()
    assert st["aot_loads"] == 0 and st["traced_buckets"] == 1
    assert st["aot_exports"] == 1 and got == want
    # the rewritten record loads again
    assert json.loads(path.read_text())[field] != value


def test_metrics_verb_and_the_identity_on_every_snapshot():
    short = {"n": 64, "t": 1, "m": 2, "ticks": 4}
    lines = []
    for i in range(5):
        lines.append(json.dumps(dict(short, id=f"s{i}", seed=i)))
        lines.append('{"cmd": "metrics"}')
    lines.append(json.dumps(dict(short, id="late", deadline_s=-1.0)))
    lines += ['{"cmd": "flush"}', '{"cmd": "metrics"}', '{"cmd": "nope"}']
    fe = ScenarioFrontend(FrontendConfig(
        batch=2, server_kw={"seed": 115, "device": "cpu"}))
    rows = _serve(fe, lines)
    snaps = [r for r in rows if r.get("metrics")]
    assert len(snaps) == 6

    def val(snap, name):
        fam = {f["name"]: f for f in snap["families"]}["pubsub_" + name]
        return sum(s["value"] for s in fam["samples"] if not s["labels"])

    for snap in snaps:
        admitted = val(snap, "serving_admitted_total")
        accounted = sum(val(snap, "serving_" + k) for k in (
            "served_total", "errors_total", "deadline_timeouts_total",
            "transient_failures_total", "queue_depth", "parked"))
        assert admitted == accounted, snap
        assert snap["spans"]["traces"] == admitted
    assert val(snaps[0], "serving_queue_depth") == 1
    assert val(snaps[-1], "serving_deadline_timeouts_total") == 1
    assert any("unknown cmd 'nope'" in str(r.get("error")) for r in rows)
    st = rows[-1]
    assert st["stats"] and st["admitted"] == 6 and st["timeouts"] == 1
    assert st["traces"] == 6 and st["compiles"] <= 1
