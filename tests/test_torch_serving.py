"""The port's multi-tenant front end (``go_libp2p_pubsub_tpu_torch/
serving/``) against the JAX package's (``go_libp2p_pubsub_tpu/serving/``).

- ``quantize_shape``, its named rejections, ``BucketLRU``'s order and
  ``FrontendConfig``'s messages equal the reference's.
- A scripted request stream (64 and 128 peers, 4 and 8 ticks, two
  resident buckets of three specs, the clock injected through ``now=``)
  gives the reference's rows on both front ends: results, priority order,
  a deadline timeout, overload rejections, a validation error row, an
  admission error; and the same ``stats()`` counters but the seconds.
- ``compiles()`` counts distinct traced bucket specs (two specs that
  differ only in ``ticks`` count 2) and a rebuilt evicted bucket adds 0.
- A ``k_slots`` bucket, which the port's batched server refuses by name
  (``loops_delays``), comes back as one terminal error row a request,
  counted in ``errors`` and never retried; the reference serves it.
- Retry, transient rows and validation rows on a patched ``submit``.
- ``sweepd --multi``: over stdin on the CPU, and ``--multi --kernel``
  refused with the reference's message.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from go_libp2p_pubsub_tpu_torch import sweepd as psw
from go_libp2p_pubsub_tpu_torch.models import plan
from go_libp2p_pubsub_tpu_torch.serving import (
    BucketLRU, BucketSpec, FrontendConfig, ScenarioFrontend, frontend,
    quantize_shape)
from test_torch_knobs import one_thread  # noqa: F401  (autouse)
from torch_ref import imported_reference

ROOT = Path(__file__).resolve().parents[1]
T = {"n": 64, "t": 2, "m": 4, "ticks": 4}

#: the scripted stream: (request, clock at admission), then the dispatch
#: clock after each admission is that plus 0.05 s
STREAM = [
    dict(T, id="a", seed=1),
    dict(T, id="b", seed=2, priority=1),
    dict(T, id="neg", n=-5),
    dict(T, id="c", n=128, seed=3, deadline_s=0.05),
    dict(T, id="d", n=100, seed=4),
    dict(T, id="e", ticks=8, seed=5),
    dict(T, id="f", ticks=7, knobs={"d": 5, "d_lo": 4, "d_hi": 8}),
    dict(T, id="h", drop_prob=0.1, seed=7, n=128),
    dict(T, id="g", attack="spam", attack_frac=0.1),
    dict(T, id="i", n=128, seed=8, priority=2, deadline_s=9.0),
    dict(T, id="bad", knobs={"offsets": [1, -1]}),
    dict(T, id="j", ticks=8, seed=9),
    dict(T, id="q", ticks=8, seed=10),
    dict(T, id="k", attack="eclipse", attack_frac=0.15, seed=3, n=128),
    dict(T, id="l", churn=True, seed=4, ticks=8),
    dict(T, id="m", n=128, seed=5, ticks=8),
    dict(T, id="o", seed=6, priority=1),
    dict(T, id="p", attack="byzantine", attack_frac=0.1),
]
STREAM_CFG = dict(batch=2, max_buckets=2, queue_cap=4, tick_quantum=4,
                  default_shape=(64, 2, 4, 4))


def scripted(fe):
    """The stream through ``fe`` (either package's), the clock injected:
    ``(rows, stats)``."""
    rows = []
    now = 100.0
    for i, req in enumerate(STREAM):
        t = now + 0.1 * i
        rej = fe.admit(dict(req), now=t)
        if rej is not None:
            rows.append(rej)
        rows += fe.dispatch_ready(now=t + 0.05)
    end = now + 0.1 * len(STREAM) + 1.0
    while fe.queued():
        rows += fe.dispatch_ready(force=True, now=end)
    return rows, fe.stats()


def _no_seconds(st):
    return {k: v for k, v in st.items()
            if k not in ("wall_s", "device_s", "requests_per_sec")}


@pytest.fixture(scope="module")
def ref():
    """The reference's serving module and its run of the stream (its
    bucket servers import ``tools.sweepd`` lazily: imported here)."""
    with imported_reference() as r:
        import tools.sweepd as rsw
        from go_libp2p_pubsub_tpu import serving as rserving
        r.sweepd, r.serving = rsw, rserving
        fe = rserving.ScenarioFrontend(rserving.FrontendConfig(
            server_kw={"seed": 0}, **STREAM_CFG))
        r.rows, r.stats = scripted(fe)
        yield r


def _fe(**kw):
    cfg = dict(STREAM_CFG, server_kw={"seed": 0, "device": "cpu"})
    cfg.update(kw)
    return ScenarioFrontend(FrontendConfig(**cfg))


@pytest.mark.parametrize("shape", [
    (200, 3, 5, 13, 0, 8), (1, 1, 1, 1, 0, 8), (64, 2, 4, 8, 5, 8),
    (65, 2, 4, 9, 0, 8), (1000, 7, 9, 33, 0, 8), (64, 2, 4, 8, 0, 16),
    (10_000, 10, 16, 100, 0, 8), (5_000, 10, 16, 60, 0, 8)])
def test_quantize_shape_equals_the_references(ref, shape):
    *args, q = shape
    got = quantize_shape(*args, tick_quantum=q)
    want = ref.serving.quantize_shape(*args, tick_quantum=q)
    assert (got.n, got.t, got.m, got.ticks, got.k_slots) == (
        want.n, want.t, want.m, want.ticks, want.k_slots)
    assert got.key() == want.key()


@pytest.mark.parametrize("bad", [
    {"n": 0}, {"t": -1}, {"m": "x"}, {"ticks": 1.5}, {"n": True},
    {"k_slots": -1}])
def test_quantize_shape_rejects_by_name_as_the_reference(ref, bad):
    kw = dict(n=64, t=2, m=4, ticks=8)
    kw.update(bad)
    with pytest.raises(ValueError, match="shape:") as got:
        quantize_shape(**kw)
    with pytest.raises(ValueError) as want:
        ref.serving.quantize_shape(**kw)
    assert str(got.value) == str(want.value)


def test_bucket_lru_order_equals_the_references(ref):
    def drive(lru_cls, spec_cls):
        lru = lru_cls(2)
        a, b, c = (spec_cls(64, 1, 1, 8), spec_cls(128, 1, 1, 8),
                   spec_cls(256, 1, 1, 8))
        out = [lru.put(a, "A"), lru.put(b, "B"), lru.get(a),
               lru.put(c, "C"), lru.get(b), lru.put(b, "B2")]
        keys = [[(s.key(), e) for s, e in x] if isinstance(x, list) else x
                for x in out]
        return keys, [s.key() for s in lru.specs()], lru.evictions
    assert drive(BucketLRU, BucketSpec) == drive(ref.serving.BucketLRU,
                                                 ref.serving.BucketSpec)
    with pytest.raises(ValueError, match="max_buckets"):
        BucketLRU(0)


def test_frontend_config_messages_equal_the_references(ref):
    for kw in (dict(batch=1), dict(long_ticks=8)):
        with pytest.raises(ValueError) as got:
            FrontendConfig(**kw)
        with pytest.raises(ValueError) as want:
            ref.serving.FrontendConfig(**kw)
        assert str(got.value) == str(want.value)


def test_scripted_stream_equals_the_references(ref):
    rows, st = scripted(_fe())
    assert rows == ref.rows
    assert _no_seconds(st) == _no_seconds(ref.stats)
    # non-vacuous: the stream reaches every kind of terminal row
    kinds = {("overloaded" if r.get("overloaded") else "timeout"
              if r.get("timeout") else "ok" if r.get("ok") else "error")
             for r in rows}
    assert kinds == {"ok", "overloaded", "timeout", "error"}
    assert st["evictions"] > 0 and st["compiles"] == st["traced_buckets"]
    order = [r["id"] for r in rows if r.get("ok")]
    assert order[:2] == ["b", "a"]                 # priority 1 first
    assert {r["bucket"] for r in rows if r.get("ok")} == {
        "n64-t2-m4-ticks4-k0", "n64-t2-m4-ticks8-k0",
        "n128-t2-m4-ticks4-k0"}


def test_compile_count_is_traced_buckets_and_eviction_is_free():
    fe = _fe(max_buckets=1, queue_cap=64,
             server_kw={"seed": 31, "device": "cpu"})
    waves = [dict(T, ticks=4), dict(T, ticks=8), dict(T, ticks=4)]
    for w, shape in enumerate(waves):
        for i in range(2):
            assert fe.admit(dict(shape, id=f"w{w}-{i}", seed=i)) is None
        rows = fe.drain()
        assert all(r["ok"] for r in rows), rows
        assert fe.compiles() == (1 if w == 0 else 2)
    st = fe.stats()
    # the two specs differ only in ticks: two runners, and the evicted
    # bucket's rebuild (the third wave) adds none
    assert st["compiles"] == st["traced_buckets"] == 2
    assert st["evictions"] == 2 and st["bucket_count"] == 1
    # a second front end in the process serving the same key registers
    # nothing new
    fe2 = _fe(max_buckets=1, queue_cap=64,
              server_kw={"seed": 31, "device": "cpu"})
    fe2.admit(dict(T, id="again"))
    fe2.drain()
    assert fe2.compiles() == 0 and fe2.stats()["traced_buckets"] == 1


def test_k_slots_bucket_is_one_terminal_error_row_never_retried(
        monkeypatch):
    fe = _fe(queue_cap=64, max_retries=3, backoff_base_s=0.0)
    for i in range(3):
        fe.admit(dict(T, id=f"k{i}", k_slots=4, seed=i))
    fe.admit(dict(T, id="plain", seed=1))
    fe.admit(dict(T, id="plain2", seed=2))
    rows = {r["id"]: r for r in fe.drain()}
    for i in range(3):
        r = rows[f"k{i}"]
        assert not r["ok"] and r["error"].startswith("loops_delays: ")
        assert r["bucket"] == "n64-t2-m4-ticks4-k4"
        assert "transient" not in r
    assert rows["plain"]["ok"] and rows["plain2"]["ok"]
    st = fe.stats()
    assert st["errors"] == 3 and st["retries"] == 0
    assert st["transient_failures"] == 0
    assert "n64-t2-m4-ticks4-k4" not in st["buckets"]
    # the same refusal on the long path
    long_fe = _fe(long_ticks=4, ckpt_dir="unused", queue_cap=64)
    long_fe.admit(dict(T, id="long", k_slots=2))
    (row,) = long_fe.drain()
    assert row["error"].startswith("loops_delays: ")
    assert long_fe.errors == 1 and long_fe.retries == 0
    assert issubclass(plan.SliceRefusal, RuntimeError)


def _patched_submit(monkeypatch, fn):
    monkeypatch.setattr(psw.SweepServer, "submit", fn)


def test_transient_failures_retry_then_fail_with_named_rows(monkeypatch):
    calls = {"n": 0}

    def flaky(self, reqs):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("device briefly gone")
        return [{"id": r.get("id"), "ok": True} for r in reqs]
    _patched_submit(monkeypatch, flaky)
    fe = _fe(max_retries=2, backoff_base_s=0.001)
    fe.admit(dict(T, id="r0"))
    fe.admit(dict(T, id="r1"))
    rows = fe.drain()
    assert all(r["ok"] for r in rows) and calls["n"] == 3
    assert fe.retries == 2 and fe.transient_failures == 0

    def dead(self, reqs):
        raise RuntimeError("CUDA launch failed with error 719")
    _patched_submit(monkeypatch, dead)
    fe = _fe(max_retries=1, backoff_base_s=0.001)
    fe.admit(dict(T, id="r0"))
    fe.admit(dict(T, id="r1"))
    rows = fe.drain()
    assert all(r["transient"] and "after 2 attempts" in r["error"]
               for r in rows)
    assert fe.transient_failures == 2 and fe.retries == 1


def test_validation_errors_never_retry(monkeypatch):
    calls = {"n": 0}

    def reject(self, reqs):
        calls["n"] += 1
        raise ValueError("scenario: unknown field(s) ['bogus']")
    _patched_submit(monkeypatch, reject)
    fe = _fe(max_retries=5)
    fe.admit(dict(T, id="r0", bogus=1))
    fe.admit(dict(T, id="r1", bogus=1))
    rows = fe.drain()
    assert calls["n"] == 1
    assert all("unknown field" in r["error"] for r in rows)
    assert fe.errors == 2 and fe.retries == 0


def test_multi_over_stdin_on_the_cpu(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    lines = [dict(T, id="m0"), dict(T, id="m1", seed=3),
             {"cmd": "stats"}, dict(T, id="m2", n=128)]
    out = subprocess.run(
        [sys.executable, "-m", "go_libp2p_pubsub_tpu_torch.sweepd",
         "--multi", "--peers", "64", "--topics", "2", "--msgs", "4",
         "--ticks", "4", "--batch", "2", "--device", "cpu"],
        cwd=ROOT, input="".join(json.dumps(q) + "\n" for q in lines),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rows = [json.loads(ln) for ln in out.stdout.splitlines()]
    assert [r.get("id") for r in rows] == ["m0", "m1", None, "m2", None]
    assert rows[2]["stats"] and rows[2]["served"] == 2
    assert rows[-1]["stats"] and rows[-1]["compiles"] == 2
    want = psw.SweepServer(n=64, t=2, m=4, ticks=8, batch=2, seed=0,
                           device="cpu").submit(
        [{"id": "m0"}, {"id": "m1", "seed": 3}])
    strip = ("bucket", "queue_s", "trace_id")
    assert [{k: v for k, v in r.items() if k not in strip}
            for r in rows[:2]] == want


def test_multi_kernel_is_refused_with_the_references_message(ref, capsys):
    assert psw.main(["--multi", "--kernel"]) == 2
    got = capsys.readouterr().err
    assert ref.sweepd.main(["--multi", "--kernel"]) == 2
    want = capsys.readouterr().err
    assert got == want and "sequential demonstration" in got
    assert "serve_multi" not in plan.REFUSALS


def test_step_memo_and_registry_are_process_global():
    fe = _fe(queue_cap=64, server_kw={"seed": 32, "device": "cpu"})
    fe.admit(dict(T, id="x"))
    fe.drain()
    (bucket,) = [fe.buckets.get(s) for s in fe.buckets.specs()]
    assert frontend._STEP_MEMO[bucket.key] is bucket.server.step
    assert bucket.key in frontend._BATCH_RUNNERS
    assert frontend._segment_lengths(10, 4) == {4, 2}
    assert frontend._segment_lengths(8, 4) == {4}
