"""The port's load generator (`paddle_tpu_torch.obs.load`,
`tools/load_cli.py`) against the JAX package's (`paddle_tpu.obs.load`,
tests/test_obs_load.py), on the CPU.

- traffic mixes and schedules (uniform, Poisson, burst phases, ramp)
  equal the JAX package's for the same seed, exactly;
- an access log written by the JAX package's server replays through
  the port against the port's loopback server to the same request count
  and bucket mix, and the reverse;
- open loop against closed loop on a stalled loopback engine (the
  coordinated-omission asymmetry) and on the JAX tests' fake target;
- `Retry-After`, the report's percentiles, `join_tail`, exemplars and
  `format_report` equal the JAX package's on the same samples;
- the latency gate's opt-in, same-key and mode cases;
- `load_cli --selftest --use_gpu=0`.
"""

import json
import random
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.obs import load as jload
from paddle_tpu.obs import perf as jperf
from paddle_tpu.obs.registry import MetricsRegistry as JRegistry
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.obs import load as tload
from paddle_tpu_torch.obs import perf as tperf
from paddle_tpu_torch.obs import registry as tregistry
from paddle_tpu_torch.obs.registry import MetricsRegistry
from paddle_tpu_torch.tools import load_cli

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh_port_registry():
    tregistry.reset_registry()
    yield


# ---------------------------------------------------------------------------
# traffic mix + schedules
# ---------------------------------------------------------------------------

def test_mix_parse_weights_sample_match_jax():
    for spec in ("1:6,4:3,8:1", "1,4,8", "1:6,2:3,4:1"):
        t, j = tload.TrafficMix.parse(spec), jload.TrafficMix.parse(spec)
        assert t.weights == j.weights and t.fractions() == j.fractions()
        rt, rj = random.Random(5), random.Random(5)
        assert [t.sample(rt) for _ in range(500)] == \
            [j.sample(rj) for _ in range(500)]
    assert tload.TrafficMix.parse("1:6,4:3,8:1").fractions()[1] == \
        pytest.approx(0.6)
    with pytest.raises(ValueError):
        tload.TrafficMix.parse("0:1")
    with pytest.raises(ValueError):
        tload.TrafficMix({})


SCHEDULES = {
    "uniform": dict(rate=100.0, n=50, arrival="uniform"),
    "poisson": dict(rate=200.0, n=500, arrival="poisson", seed=1),
    "poisson_mix": dict(rate=64.0, n=128, arrival="poisson", seed=7,
                        mix="1:6,2:3,4:1"),
    "phases": dict(rate=10.0, duration_s=2.0, arrival="uniform",
                   phases="1:1000"),
    "ramp": dict(rate=100.0, n=300, arrival="poisson", seed=3,
                 ramp_s=2.0, phases="2.5:400,2.7:50", mix="1,2,4,8"),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedules_equal_jax_exactly(case):
    spec = dict(SCHEDULES[case])
    out = []
    for load in (jload, tload):
        kw = dict(spec)
        if "mix" in kw:
            kw["mix"] = load.TrafficMix.parse(kw["mix"])
        if "phases" in kw:
            kw["phases"] = load.parse_phases(kw["phases"])
        out.append(load.build_schedule(**kw))
    assert out[0] == out[1] and len(out[1]) > 10


def test_schedule_properties_and_rate():
    sched = tload.build_schedule(100.0, n=50, arrival="uniform")
    gaps = [b[0] - a[0] for a, b in zip(sched, sched[1:])]
    assert sched[0][0] == 0.0 and all(abs(g - 0.01) < 1e-9 for g in gaps)
    pois = tload.build_schedule(200.0, n=500, arrival="poisson", seed=1)
    gaps = [b[0] - a[0] for a, b in zip(pois, pois[1:])]
    assert 1 / 200 * 0.7 < sum(gaps) / len(gaps) < 1 / 200 * 1.3
    assert tload.build_schedule(200.0, n=500, seed=2) != pois
    phases = tload.parse_phases("5:400,6:100")
    assert phases == jload.parse_phases("5:400,6:100")
    for t, kw in ((0.0, {"phases": phases}), (5.5, {"phases": phases}),
                  (7.0, {"phases": phases}), (1.0, {"ramp_s": 2.0}),
                  (0.0, {"ramp_s": 2.0}), (3.0, {"ramp_s": 2.0})):
        assert tload.rate_at(t, 100.0, **kw) == jload.rate_at(t, 100.0, **kw)
    with pytest.raises(ValueError):
        tload.build_schedule(100.0)
    with pytest.raises(ValueError):
        tload.build_schedule(100.0, n=10, arrival="bursty")


# ---------------------------------------------------------------------------
# access-log replay across the packages
# ---------------------------------------------------------------------------

def _jax_server(log):
    from paddle_tpu.serving import InferenceServer, ServerConfig

    engine = jload.build_tiny_engine(dim=8, classes=3, buckets=(1, 2, 4, 8))
    return InferenceServer(engine, ServerConfig(
        max_batch=8, max_wait_ms=1.0, queue_size=256, warmup=False,
        model_name="jax", access_log=log))


def _port_server(log=None, engine=None):
    from paddle_tpu_torch.serving import InferenceServer, ServerConfig

    engine = engine or tload.build_tiny_engine(
        dim=8, classes=3, buckets=(1, 2, 4, 8), place=tfluid.CPUPlace())
    return InferenceServer(engine, ServerConfig(
        max_batch=8, max_wait_ms=1.0, queue_size=256, warmup=False,
        model_name="torch", access_log=log, slo_ms=100.0,
        tail_slow_ms=0.0, tail_capacity=256))


def _drive_and_replay(writer, reader, load_w, load_r, tmp_path):
    """Requests of a seeded mix through `writer`'s loopback server (its
    access log), then that log replayed by `load_r` against `reader`."""
    log = str(tmp_path / "access.jsonl")
    server = writer(log)
    server.batcher.start()
    try:
        schedule = load_w.build_schedule(
            400.0, n=24, arrival="poisson", seed=11,
            mix=load_w.TrafficMix.parse("1:2,2:1,4:1"))
        load_w.run_open_loop(load_w.LoopbackTarget(server), schedule,
                             load_w.vector_payload("img", 8),
                             max_inflight=8,
                             registry=(JRegistry() if load_w is jload
                                       else MetricsRegistry()))
    finally:
        server.shutdown()
    entries = load_r.load_access_log(log)
    assert len(entries) == 24
    assert load_r.replay_schedule(entries, speed=10.0) == \
        load_w.replay_schedule(load_w.load_access_log(log), speed=10.0)
    want = {}
    for e in entries:
        b = "b%d" % max(1, int(e.get("batch") or 1))
        want[b] = want.get(b, 0) + 1
    server = reader(None)
    server.batcher.start()
    try:
        report = load_r.run_open_loop(
            load_r.LoopbackTarget(server),
            load_r.replay_schedule(entries, speed=10.0),
            load_r.vector_payload("img", 8), max_inflight=8,
            registry=(JRegistry() if load_r is jload
                      else MetricsRegistry()))
    finally:
        server.shutdown()
    assert report["n"] == 24
    assert {b: st["n"] for b, st in report["by_bucket"].items()} == want
    assert report["by_status"] == {"200": 24}


def test_jax_access_log_replays_through_the_port(tmp_path):
    _drive_and_replay(_jax_server, _port_server, jload, tload, tmp_path)


def test_port_access_log_replays_through_jax(tmp_path):
    _drive_and_replay(_port_server, _jax_server, tload, jload, tmp_path)


def test_access_log_replay_preserves_gaps_and_batches(tmp_path):
    entries = [
        {"t": 100.0, "batch": 2, "status": 200, "request_id": "a"},
        {"t": 100.5, "batch": 1, "status": 200, "request_id": "b"},
        {"t": 101.5, "batch": 4, "status": 429, "request_id": "c"},
    ]
    path = tmp_path / "access.jsonl"
    with open(path, "w") as f:
        f.write("not json, torn append\n")
        for e in reversed(entries):
            f.write(json.dumps(e) + "\n")
        f.write("\n")
    loaded = tload.load_access_log(str(path))
    assert loaded == jload.load_access_log(str(path))
    assert [e["request_id"] for e in loaded] == ["a", "b", "c"]
    assert tload.replay_schedule(loaded, speed=2.0) == \
        [(0.0, 2), (0.25, 1), (0.75, 4)]
    with pytest.raises(ValueError):
        tload.replay_schedule(loaded, speed=0.0)


# ---------------------------------------------------------------------------
# open vs closed loop
# ---------------------------------------------------------------------------

class _StallingTarget:
    """The JAX tests' fake target: one armed call stalls."""

    def __init__(self, stall_at=3, stall_s=0.2, fast_s=0.001):
        self.stall_at = stall_at
        self.stall_s = stall_s
        self.fast_s = fast_s
        self.calls = 0
        self._lock = threading.Lock()

    def infer(self, payload, ctx, timeout_s=None):
        with self._lock:
            self.calls += 1
            stall = self.calls == self.stall_at
        time.sleep(self.stall_s if stall else self.fast_s)
        return 200, {"request_id": ctx.request_id}, {}


def _payload(batch):
    return {"batch": batch}


def test_open_loop_measures_from_schedule():
    target = _StallingTarget(stall_at=3, stall_s=0.2)
    sched = [(i * 0.001, 1) for i in range(10)]
    report = tload.run_open_loop(target, sched, _payload, max_inflight=1,
                                 registry=MetricsRegistry(), slo_ms=100.0)
    assert report["mode"] == "open" and report["n"] == 10
    assert report["percentiles_ms"]["p90_ms"] >= 100.0
    assert report["slo"]["violations"] >= 5
    assert report["worst"][0]["latency_ms"] >= 150.0
    assert len([w for w in report["worst"] if w["service_ms"] >= 150.0]) \
        <= 1


def test_closed_loop_hides_the_same_stall():
    target = _StallingTarget(stall_at=3, stall_s=0.2)
    report = tload.run_closed_loop(target, _payload, workers=1, n=10,
                                   seed=3, registry=MetricsRegistry(),
                                   slo_ms=100.0)
    assert report["mode"] == "closed" and report["n"] == 10
    assert report["max_ms"] >= 150.0
    assert report["percentiles_ms"]["p50_ms"] < 100.0
    assert report["slo"]["violations"] == 1


def test_stalled_loopback_engine_open_against_closed():
    """load_cli's `_StallEngine` on the port's loopback server: one
    0.3 s stall inflates the open loop's p99 (every arrival scheduled
    inside it waits), while the closed loop's single worker sees it
    once; the slowest open-loop request joins its /debug/tail tree."""
    engine = load_cli._StallEngine(tload.build_tiny_engine(
        dim=8, classes=3, buckets=(1, 2, 4, 8), place=tfluid.CPUPlace()))
    server = _port_server(engine=engine)
    server.batcher.start()
    try:
        target = tload.LoopbackTarget(server)
        payload = tload.vector_payload("img", 8)
        mix = tload.TrafficMix.parse("1:2,2:1,4:1")
        engine.arm(after_calls=10, stall_s=0.3)
        open_r = tload.run_open_loop(
            target, tload.build_schedule(100.0, n=100, mix=mix, seed=7),
            payload, slo_ms=100.0, max_inflight=64,
            registry=MetricsRegistry())
        engine.arm(after_calls=10, stall_s=0.3)
        closed_r = tload.run_closed_loop(
            target, payload, workers=1, n=100, mix=mix, seed=7,
            slo_ms=100.0, registry=MetricsRegistry())
        tail = target.get("/debug/tail")
        metrics_text = target.get("/metrics")
    finally:
        server.shutdown()
    assert open_r["percentiles_ms"]["p99_ms"] >= 150.0
    assert closed_r["max_ms"] >= 240.0
    assert closed_r["percentiles_ms"]["p90_ms"] < \
        open_r["percentiles_ms"]["p99_ms"] / 2.0
    assert tload.join_tail(open_r, tail) >= 1
    assert open_r["worst"][0]["tail"]["spans"]
    assert tload.parse_exemplars(metrics_text)


class _RetryAfterTarget:
    def __init__(self):
        self.calls = 0

    def infer(self, payload, ctx, timeout_s=None):
        self.calls += 1
        if self.calls == 1:
            return 429, {"error": "full", "request_id": ctx.request_id}, \
                {"Retry-After": "0.01"}
        return 200, {"request_id": ctx.request_id}, {}


def test_closed_loop_honors_retry_after():
    t0 = time.perf_counter()
    report = tload.run_closed_loop(_RetryAfterTarget(), _payload,
                                   workers=1, n=3,
                                   registry=MetricsRegistry())
    assert time.perf_counter() - t0 >= 0.01
    assert report["by_status"] == {"200": 2, "429": 1}
    shed = [w for w in report["worst"] if w["status"] == 429]
    assert shed and shed[0]["retry_after"] == "0.01"


def test_loopback_429_carries_retry_after():
    """The port's server, its queue full: the loopback target answers
    429 with the JAX module's Retry-After (ceil of retry_after_s)."""
    from paddle_tpu_torch.serving import InferenceServer, ServerConfig

    engine = tload.build_tiny_engine(dim=8, classes=3, buckets=(1, 2),
                                     place=tfluid.CPUPlace())
    server = InferenceServer(engine, ServerConfig(
        max_batch=2, queue_size=1, warmup=False, retry_after_s=1.5))
    target = tload.LoopbackTarget(server)
    # the batcher is not started: the first request fills the queue
    from paddle_tpu_torch.obs.context import TraceContext

    first = threading.Thread(target=target.infer, args=(
        {"inputs": {"img": [[0.5] * 8]}, "timeout_ms": 200},
        TraceContext()), daemon=True)
    first.start()
    time.sleep(0.1)
    status, _, headers = target.infer({"inputs": {"img": [[0.5] * 8]}},
                                      TraceContext())
    first.join(timeout=5)
    assert status == 429 and headers == {"Retry-After": "2"}


def test_open_loop_latency_histogram_lands_in_registry():
    reg = MetricsRegistry()
    target = _StallingTarget(stall_at=99, stall_s=0.0, fast_s=0.0)
    tload.run_open_loop(target, [(0.0, 1), (0.0, 2), (0.0, 2)], _payload,
                        max_inflight=2, registry=reg)
    text = reg.render_text()
    assert 'load_latency_seconds_count{bucket="b2",status="200"} 2' in text
    assert "load_offered_rps" in text and "load_inflight 0" in text


# ---------------------------------------------------------------------------
# report math and joins, against the JAX module
# ---------------------------------------------------------------------------

def _samples(lats, batch=1, status=200):
    return [{"batch": batch, "bucket": "b%d" % batch, "status": status,
             "latency_ms": float(v), "service_ms": float(v),
             "trace_id": "%032x" % i, "request_id": "req-%d" % i}
            for i, v in enumerate(lats)]


@pytest.mark.parametrize("lats,kw", [
    (list(range(1, 101)), dict(slo_ms=90.0, offered_rps=50.0)),
    ([1.0, 2.0, 300.0], dict(slo_ms=100.0)),
    ([5.0] * 7 + [9.0], {}),
])
def test_report_and_format_match_jax(lats, kw):
    samples = _samples(lats) + _samples([3.0, 4.0], batch=4, status=429)
    t = tload.build_report(samples, mode="open", wall_s=2.0, **kw)
    j = jload.build_report(samples, mode="open", wall_s=2.0, **kw)
    assert t == j
    assert tload.format_report(t) == jload.format_report(j)
    assert tload.latency_blob(t) == jload.latency_blob(j)
    for p in (50.0, 90.0, 99.0, 99.9):
        srt = sorted(lats)
        assert tload.percentile(srt, p) == jload.percentile(srt, p)
    assert tload.percentile([], 99.0) is None
    with pytest.raises(ValueError):
        tload.build_report([None], mode="open", wall_s=1.0)


def test_report_percentiles_and_slo():
    report = tload.build_report(_samples(range(1, 101)), mode="open",
                                wall_s=2.0, slo_ms=90.0, offered_rps=50.0)
    pct = report["percentiles_ms"]
    assert (pct["p50_ms"], pct["p90_ms"], pct["p99_ms"],
            pct["p99_9_ms"]) == (50.0, 90.0, 99.0, 100.0)
    assert report["slo"] == {"slo_ms": 90.0, "attainment": 0.9,
                             "violations": 10}
    assert report["achieved_rps"] == 50.0


def test_join_tail_and_exemplars_match_jax():
    tail_doc = {"requests": [
        {"request_id": "req-2", "trace_id": "nope", "reason": "slow",
         "latency_ms": 49.0, "status": 200,
         "spans": [{"name": "serving/request"}]},
        {"request_id": "other", "trace_id": "%032x" % 1, "reason": "slow",
         "latency_ms": 2.0, "status": 200, "spans": []}]}
    reports = [load.build_report(_samples([1.0, 2.0, 50.0]), mode="open",
                                 wall_s=1.0) for load in (tload, jload)]
    assert tload.join_tail(reports[0], tail_doc) == \
        jload.join_tail(reports[1], tail_doc) == 2
    assert reports[0] == reports[1]
    assert reports[0]["worst"][0]["tail"]["spans"]
    assert tload.join_tail(reports[0], {"requests": []}) == 0
    text = "\n".join([
        "# TYPE serving_total_seconds histogram",
        'serving_total_seconds_bucket{le="0.05"} 7 '
        '# {trace_id="%s"} 0.021 1700000000.000' % ("ab" * 16),
        'serving_total_seconds_bucket{le="+Inf"} 8',
        "serving_total_seconds_count 8"])
    assert tload.parse_exemplars(text) == jload.parse_exemplars(text)
    hit = tload.parse_exemplars(text)["ab" * 16][0]
    assert hit["le"] == "0.05" and hit["value"] == pytest.approx(0.021)
    sample = [{"batch": 1, "bucket": "b1", "status": 200,
               "latency_ms": 21.0, "service_ms": 21.0,
               "trace_id": "ab" * 16, "request_id": "req-x"}]
    report = tload.build_report(sample, mode="open", wall_s=1.0)
    assert tload.join_exemplars(report, text) == 1
    assert report["worst"][0]["exemplars"][0]["le"] == "0.05"


# ---------------------------------------------------------------------------
# latency blob -> history -> gate
# ---------------------------------------------------------------------------

def _lat_record(blob, value=100.0):
    return {"metric": "serving_slo_openloop_rps", "value": value,
            "unit": "req/s", "platform": "gpu", "latency": blob}


def _blob(scale=1.0, mode="open", **extra):
    blob = {"mode": mode, "n": 200, "p50_ms": 5.0 * scale,
            "p90_ms": 8.0 * scale, "p99_ms": 20.0 * scale,
            "p99_9_ms": 45.0 * scale, "slo_ms": 50.0,
            "slo_attainment": 0.99, "offered_rps": 100.0,
            "achieved_rps": 99.0}
    blob.update(extra)
    return blob


def _gate(perf, records, **kw):
    return perf.gate_history(
        [perf.normalize_record(r, leg="pload", ts=1000.0 + i)
         for i, r in enumerate(records)], **kw)


LATENCY_CASES = {
    "opt_in": ([_blob()] * 5 + [_blob(scale=3.0)], {}, True),
    "regression": ([_blob()] * 5 + [_blob(scale=3.0)],
                   {"latency_tolerance": 0.25}, False),
    "within": ([_blob()] * 5 + [_blob(scale=1.1)],
               {"latency_tolerance": 0.25}, True),
    "same_key": ([_blob()] * 5 + [{"mode": "open", "n": 10,
                                   "p50_ms": 50.0}],
                 {"latency_tolerance": 0.25}, False),
    "mode": ([_blob(mode="closed")] * 5 + [_blob(scale=3.0)],
             {"latency_tolerance": 0.25}, True),
}


@pytest.mark.parametrize("case", sorted(LATENCY_CASES))
def test_latency_gate_matches_jax(case):
    blobs, kw, ok = LATENCY_CASES[case]
    records = [_lat_record(dict(b)) for b in blobs]
    got = _gate(tperf, records, **kw)
    assert got.to_dict() == _gate(jperf, records, **kw).to_dict()
    assert got.ok is ok
    if case == "regression":
        f = got.failures[0]
        assert f["kind"] == "latency"
        assert "p99_9_ms" in f["why"] and "open loop" in f["why"]
    if case == "same_key":
        assert "p50_ms" in got.failures[0]["why"]


def test_latency_blob_survives_normalize_record():
    report = tload.build_report(_samples([1.0, 2.0, 3.0]), mode="open",
                                wall_s=1.0, slo_ms=2.5, offered_rps=3.0)
    blob = tload.latency_blob(report)
    assert blob["slo_attainment"] == pytest.approx(2 / 3, abs=1e-4)
    norm = tperf.normalize_record(_lat_record(blob), leg="pload", ts=1.0)
    assert norm == jperf.normalize_record(_lat_record(blob), leg="pload",
                                          ts=1.0)
    assert norm["latency"]["p99_ms"] == blob["p99_ms"]
    assert "latency" not in tperf.normalize_record(
        {"metric": "m", "value": 1.0}, ts=1.0)


def test_serving_bench_record_names_its_place(monkeypatch):
    monkeypatch.setenv("BENCH_SERVING_N", "24")
    monkeypatch.setenv("BENCH_SERVING_RATE", "400")
    rec = tload.run_serving_bench(place=tfluid.CPUPlace())
    assert rec["platform"] == "cpu" and rec["latency"]["n"] == 24
    assert rec["metric"] == "serving_slo_openloop_rps"
    assert tperf.normalize_record(rec, ts=1.0)["latency"]["mode"] == "open"


def test_build_tiny_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default place is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tload.build_tiny_engine()


def test_load_cli_selftest_on_the_cpu(capsys):
    assert load_cli.main(["--selftest", "--use_gpu=0"]) == 0
    assert "[pload] selftest green" in capsys.readouterr().out


def test_load_cli_history_names_the_platform(tmp_path, monkeypatch):
    """`run --history` appends a latency record whose platform is the
    one the measured server's /healthz names for its engine's place,
    whatever the client's --use_gpu; a server that names none is
    refused before the run."""
    from paddle_tpu_torch.serving import InferenceServer, ServerConfig

    engine = tload.build_tiny_engine(dim=16, classes=3, buckets=(1, 2, 4),
                                     place=tfluid.CPUPlace())
    server = InferenceServer(engine, ServerConfig(
        port=0, max_batch=4, warmup=False)).start()
    hist = str(tmp_path / "h.jsonl")
    run = ["run", "--url", None, "--rate", "200", "--n", "12", "--mix",
           "1,2,4", "--history", hist]
    try:
        run[2] = "http://%s:%d" % server.address
        for use_gpu in ("0", "1"):
            assert load_cli.main(run + ["--use_gpu=" + use_gpu]) == 0
        signals = server.health_signals
        monkeypatch.setattr(server, "health_signals", lambda: {
            k: v for k, v in signals().items() if k != "platform"})
        with pytest.raises(SystemExit, match="names no platform"):
            load_cli.main(run)
    finally:
        server.shutdown()
    recs = tperf.load_history(hist)
    assert [r["platform"] for r in recs] == ["cpu", "cpu"]
    assert all(r["latency"]["n"] == 12 for r in recs)
    assert np.isfinite(recs[0]["value"])
