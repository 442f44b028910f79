"""The port's serving and metrics benchmarks on the CPU at a cut size, and
its copies of the JAX package's ``tools/loadgen.py``, ``servestat.py``
and ``obsstat.py``.

- ``serving_bench.run("cpu")`` with 60 requests and a 40-tick kill
  scenario: every gate of the row (the overload's 176 / 124, a SIGKILLed
  child's restart to the uninterrupted digest, the cold start's two
  children with 0 compiles and 2 loads and the JAX package's cold rows);
  ``full_width`` at a cut pool: 3 compiles, rows equal to
  ``SweepServer.submit``'s.
- ``metrics_bench.run("cpu")``: the fleet of three spawned clients
  against a ``sweepd --multi`` child, every scrape's identity, the span
  ledger, delay parity equal to the JAX package's totals.
- ``servestat`` / ``obsstat``: the port's copies print the same table,
  messages and exit code as the reference's tools on the same artifacts
  (clean, each regression, unusable input), with ``--check`` against the
  committed SERVE_r18.json / METRICS_r19.json.
"""

import copy
import json
import subprocess
import sys
from pathlib import Path

import pytest

from go_libp2p_pubsub_tpu_torch import (metrics_bench, obsstat,
                                        serving_bench, servestat)
from test_torch_knobs import one_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def serve_art():
    # the row's child processes: one PyTorch thread each under load
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        return serving_bench.run("cpu", n_reqs=60, kill_ticks=40)


@pytest.fixture(scope="module")
def metrics_art():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        return metrics_bench.run("cpu")


def test_serving_row_gates_on_the_cpu(serve_art):
    a = serve_art
    assert a["compiles"] == a["traced_buckets"] == 5 and a["evictions"] > 0
    assert a["load"]["admitted"] == 60 and a["load"]["queued"] == 0
    assert a["load"]["errors"] == a["load"]["transient_failures"] == 0
    assert (a["overload"]["admitted"], a["overload"]["rejected_overload"]) \
        == (176, 124)
    kill = a["kill_recovery"]
    assert kill["digest_match"] and kill["resumed"] == 1
    assert kill["served"] == 1 and kill["parked"] == 0
    cold = a["cold_start"]
    assert cold["aot_compiles"] == 0 and cold["aot_loads"] == 2
    assert cold["bit_identical"]
    assert a["cold_rows"] == serving_bench.REFERENCE_COLD_ROWS
    assert a["sources_built"] == [0, 0, 0, 0]
    assert [r["id"] for r in a["rows"]] == [
        "load", "overload", "kill_recovery", "cold_start"]


def test_full_width_rows_equal_submits_at_a_cut_pool(monkeypatch):
    monkeypatch.setattr(serving_bench, "FULL_POOL", [
        (300, 3, 4, 8), (150, 3, 4, 6), (600, 3, 4, 8)])
    fw = serving_bench.full_width("cpu")
    st = fw["stats"]
    assert fw["distinct_shapes"] == 3 == st["compiles"]
    assert st["evictions"] > 0 and fw["rows_equal_submit"]
    assert st["admitted"] == 36 == st["served"] + st["timeouts"]


def test_metrics_row_gates_on_the_cpu(metrics_art):
    f, sp, par = (metrics_art["fleet"], metrics_art["spans"],
                  metrics_art["delay_parity"])
    assert f["rows_received"] == f["requests_sent"] == 18
    assert f["identity_ok"] and f["cross_match"] and f["spans_match"]
    assert f["trace_events"] > 0 and f["mid_flight_scrapes"] >= 1
    assert all(s["identity_ok"] for s in metrics_art["scrapes"])
    assert sp["traces"] == sp["admitted"] == sp["terminal"] == 10
    assert sp["open_spans"] == sp["dropped_events"] == 0
    assert {k: par[k] for k in metrics_bench.REFERENCE_PARITY} \
        == metrics_bench.REFERENCE_PARITY


def _tool(name, path, *args):
    r = subprocess.run([sys.executable, f"tools/{name}.py", str(path),
                        *args], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    return r.returncode, r.stdout, r.stderr


def _port(mod, path, *args, capsys):
    capsys.readouterr()
    try:
        rc = mod.main([str(path), *args])
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


def _serve_cases(art):
    cases = {"clean": art}
    bad = copy.deepcopy(art)
    bad["compiles"] = 6
    cases["recompiled"] = bad
    bad = copy.deepcopy(art)
    bad["kill_recovery"]["digest_match"] = False
    bad["kill_recovery"]["served"] = 0
    cases["digest_and_drop"] = bad
    bad = copy.deepcopy(art)
    bad["cold_start"]["aot_compiles"] = 2
    bad["overload"]["rejected_overload"] = 0
    cases["cold_and_overload"] = bad
    bad = copy.deepcopy(art)
    bad["load"]["throughput_rps"] = 0.5
    bad["bucket_count"] = 1
    cases["slow"] = bad
    cases["no_rows"] = dict(art, rows=[])
    return cases


@pytest.mark.parametrize("case", ["clean", "recompiled", "digest_and_drop",
                                  "cold_and_overload", "slow", "no_rows"])
def test_servestat_equals_the_references_tool(serve_art, tmp_path, capsys,
                                              case):
    path = tmp_path / "serving.json"
    path.write_text(json.dumps(_serve_cases(serve_art)[case]))
    args = ("--check", str(ROOT / "SERVE_r18.json"))
    got = _port(servestat, path, *args, capsys=capsys)
    want = _tool("servestat", path, *args)
    assert got == want
    assert got[0] == {"clean": 0, "no_rows": 2}.get(case, 1)


def _metrics_cases(art):
    cases = {"clean": art}
    bad = copy.deepcopy(art)
    bad["scrapes"][0]["identity_ok"] = False
    bad["fleet"]["rows_received"] = 17
    cases["lost"] = bad
    bad = copy.deepcopy(art)
    bad["spans"]["open_spans"] = 1
    bad["spans"]["phases"].pop("pad")
    cases["spans"] = bad
    bad = copy.deepcopy(art)
    bad["delay_parity"]["max_abs_diff"] = 3
    bad["cross_check"]["served"]["scrape"] = -1
    cases["parity"] = bad
    cases["no_scrapes"] = dict(art, scrapes=[])
    return cases


@pytest.mark.parametrize("case", ["clean", "lost", "spans", "parity",
                                  "no_scrapes"])
def test_obsstat_equals_the_references_tool(metrics_art, tmp_path, capsys,
                                            case):
    path = tmp_path / "metrics.json"
    path.write_text(json.dumps(_metrics_cases(metrics_art)[case]))
    args = ("--check", str(ROOT / "METRICS_r19.json"))
    got = _port(obsstat, path, *args, capsys=capsys)
    want = _tool("obsstat", path, *args)
    assert got == want
    assert got[0] == {"clean": 0, "no_scrapes": 2}.get(case, 1)


def test_loadgen_refuses_an_empty_fleet_as_the_reference():
    from go_libp2p_pubsub_tpu_torch import loadgen
    with pytest.raises(ValueError, match="must both be >= 1"):
        loadgen.run_fleet("unused", procs=0)
    r = subprocess.run([sys.executable, "tools/loadgen.py", "unused",
                        "--procs", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert "must both be >= 1" in r.stderr
