"""The port's step profiler, bottleneck classifier and perf-history gate
(`paddle_tpu_torch.obs.perf`, `tools/perf_cli.py`) against the JAX
package's (`paddle_tpu.obs.perf`, tests/test_perf.py), on the CPU.

- `classify_split`'s four verdicts and its degenerate cases give the
  JAX package's dicts for the same arguments;
- `roofline_floors` and `leg_perf_blob` on one ProgramDesc built by the
  JAX package and parsed by the port, at explicit peaks, agree within
  1e-9 relative; the port's default peak is the f32 cores' 67 TFLOP/s
  (989 under bf16 activations), where the JAX package halves its bf16
  peak;
- `StepProfiler` over 8 steps of v2 fit-a-line through
  `v2.trainer.SGD` from one state in both packages: the record keys are
  JAX's, and `examples`, `sampled`, `h2d_bytes` and `d2h_bytes` are
  equal; the sampled steps' `device_s` is the wall of their executor
  runs on the CPU (the card's busy time on the card); the ring bound,
  the exports and the tracer left alone, as in the JAX tests;
- one synthetic history gated by both packages gives the same
  `to_dict()`, and a history file written by either is gated by the
  other with the same verdict; `perf_cli gate`'s exit codes;
- the executor's telemetry: one fit-a-line run gives the JAX package's
  h2d and d2h counters, and a feed already on the device counts
  nothing;
- the SLO burn on a loopback server, and `perf_cli --selftest
  --use_gpu=0`.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.fluid as jfluid
import paddle_tpu.v2 as jv2
from paddle_tpu.obs import perf as jperf
from paddle_tpu.obs import telemetry as jtele
from paddle_tpu.core import scope as jscope
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.v2 as tv2
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.core.desc import ProgramDesc
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.obs import perf as tperf
from paddle_tpu_torch.obs import registry as tregistry
from paddle_tpu_torch.obs import telemetry as ttele
from paddle_tpu_torch.obs import trace as ttrace
from paddle_tpu_torch.tools import perf_cli
from paddle_tpu_torch.tools.obs_dump import validate_chrome_trace
from paddle_tpu_torch.v2 import config as tconfig

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

REL = 1e-9


@pytest.fixture(autouse=True)
def fresh_port():
    """The port's process-global state reset around every test (the
    conftest does it for the JAX package): registry, tracer, profiler,
    default programs and scope, the v2 API on the CPU."""
    tregistry.reset_registry()
    ttrace.disable()
    ttrace.reset()
    old_main = tframework.switch_main_program(tframework.Program())
    old_startup = tframework.switch_startup_program(tframework.Program())
    old_scope = tscope._global_scope
    tscope._global_scope = tscope.Scope()
    old_state = dict(tconfig._state)
    tv2.init(use_gpu=False)
    jv2.init(use_gpu=False)
    yield
    tperf.uninstall()
    ttele.install_step_observer(None)
    ttrace.disable()
    ttrace.reset()
    tframework.switch_main_program(old_main)
    tframework.switch_startup_program(old_startup)
    tscope._global_scope = old_scope
    tconfig._state.update(old_state)


def _tiny_train_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        h = fluid.layers.fc(input=x, size=3)
        cost = fluid.layers.mean(x=h)
        fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(cost)
    return main, startup, cost


# ---------------------------------------------------------------------------
# classifier
# ---------------------------------------------------------------------------

CLASSIFY_CASES = {
    "input_bound": ((0.1,), dict(device_s=0.05, input_s=0.04)),
    "host_bound": ((0.1,), dict(device_s=0.04, input_s=0.01)),
    "compute_bound": ((0.1,), dict(device_s=0.095, input_s=0.0,
                                   t_mxu_s=0.08, t_hbm_s=0.02,
                                   dominant="conv2d")),
    "hbm_bound": ((0.1,), dict(device_s=0.095, input_s=0.0,
                               t_mxu_s=0.01, t_hbm_s=0.07)),
    "no_wall": ((0.0,), {}),
    "no_roofline": ((0.1,), dict(device_s=0.09)),
    "host_given": ((0.2,), dict(device_s=0.05, input_s=0.01,
                                host_s=0.14)),
    "no_split": ((0.1,), dict(input_s=0.01)),
    "thresholds": ((0.1,), dict(device_s=0.06, input_s=0.02,
                                input_share=0.1, host_share=0.5)),
}


@pytest.mark.parametrize("case", sorted(CLASSIFY_CASES))
def test_classify_split_matches_jax(case):
    args, kw = CLASSIFY_CASES[case]
    got = tperf.classify_split(*args, **kw)
    assert got == jperf.classify_split(*args, **kw)
    if case in tperf.VERDICTS:
        assert got["verdict"] == case
    assert tperf.VERDICTS == jperf.VERDICTS


def _close(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=REL, abs=1e-12)
    else:
        assert a == b


@pytest.mark.parametrize("bf16_act", [False, True])
def test_roofline_floors_and_leg_blob_match_jax(bf16_act):
    """One ProgramDesc built by the JAX package, parsed by the port, at
    explicit peaks: the two packages' floors and blobs agree."""
    main, _, _ = _tiny_train_program(jfluid)
    desc = ProgramDesc.from_dict(json.loads(json.dumps(
        main.desc.to_dict())))
    kw = dict(peak_tflops=100.0, hbm_gbps=500.0, bf16_act=bf16_act)
    _close(tperf.roofline_floors(desc, **kw),
           jperf.roofline_floors(main, **kw))
    for extra in ({}, {"input_s": 0.001, "host_s": 0.002},
                  {"xla_flops": 1e6, "xla_bytes": 1e12}):
        got = tperf.leg_perf_blob(desc, step_s=0.005, **dict(kw, **extra))
        _close(got, jperf.leg_perf_blob(main, step_s=0.005,
                                        **dict(kw, **extra)))
        json.dumps(got)
    assert tperf.leg_perf_blob(desc, 0.005, xla_flops=1e6,
                               xla_bytes=1e12, **kw)["verdict"] \
        == "hbm_bound"
    blob = tperf.leg_perf_blob(object(), step_s=0.01)
    assert blob == jperf.leg_perf_blob(object(), step_s=0.01)
    assert "floors_ms" not in blob


def test_roofline_defaults_are_the_cards():
    """f32 programs price at the f32 cores' 67 TFLOP/s (the port runs
    f32 products with TF32 off), bf16-activation ones at 989; the
    bandwidth is 3,350 GB/s.  The JAX package takes half its bf16 peak
    for f32."""
    from paddle_tpu_torch.fluid import analysis

    main, _, _ = _tiny_train_program(tfluid)
    f32 = tperf.roofline_floors(main)
    assert f32["peak_tflops"] == 67.0 and f32["hbm_gbps"] == 3350.0
    rep = analysis.roofline_report(main, peak_tflops=67.0, hbm_gbps=3350.0)
    assert f32["t_mxu_s"] == pytest.approx(rep["total_gflops"] / 67e3,
                                           rel=REL)
    assert f32["floor_ms_serial"] == pytest.approx(rep["floor_ms_serial"],
                                                   rel=REL)
    assert tperf.roofline_floors(main, bf16_act=True)["peak_tflops"] \
        == 989.0
    assert tperf.leg_perf_blob(main, 0.005)["peak_tflops"] == 67.0


def test_attribution_floors_scope_to_segments():
    """The JAX test's gauges, set by hand (nothing in the port publishes
    them until compiled segments): the same sums, None when absent."""
    assert tperf.attribution_floors(1.0, 1.0) is None
    reg = tregistry.get_registry()
    for seg, flops in (("jit_segment[0:mul..mean x3]", 1e9),
                       ("jit_segment[1:sgd x1]", 2e9),
                       ("bench/step", 3e9)):
        reg.gauge("xla_flops", labelnames=("segment",)) \
           .labels(segment=seg).set(flops)
        reg.gauge("xla_bytes_accessed", labelnames=("segment",)) \
           .labels(segment=seg).set(flops)
    floors = tperf.attribution_floors(peak_tflops=1.0, hbm_gbps=1.0)
    assert floors["t_mxu_s"] == pytest.approx(3e9 / 1e12)
    assert floors["dominant"].startswith("jit_segment[1")
    assert tperf.attribution_floors(1.0, 1.0, segment_prefix="bench/")[
        "t_mxu_s"] == pytest.approx(3e9 / 1e12)
    assert tperf.attribution_floors(
        1.0, 1.0, segment_prefix="nomatch") is None


# ---------------------------------------------------------------------------
# the executor's telemetry
# ---------------------------------------------------------------------------

def _counters(tele):
    snap = tele.snapshot()
    return {d: snap.get("executor_transfer_bytes_total{direction=%s}" % d,
                        0) for d in ("h2d", "d2h")}


def test_transfer_counters_match_jax():
    """One fit-a-line training run from numpy feeds: the same h2d and
    d2h bytes in both packages (on the CPU, counted as the JAX package
    counts them on its CPU backend), and feed seconds counted."""
    rs = np.random.RandomState(0)
    feed = {"x": rs.rand(20, 13).astype(np.float32),
            "y": rs.rand(20, 1).astype(np.float32),
            "w": rs.rand(20, 1).astype(np.float64)}
    got = {}
    for name, fluid, tele in (("jax", jfluid, jtele),
                              ("torch", tfluid, ttele)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[13], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
            w = fluid.layers.data(name="w", shape=[1], dtype="float32")
            pred = fluid.layers.fc(input=x, size=1)
            loss = fluid.layers.mean(x=fluid.layers.elementwise_mul(
                x=fluid.layers.square_error_cost(input=pred, label=y),
                y=w))
            fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            exe.run(startup)
            before = _counters(tele)
            snap = tele.snapshot()
            exe.run(main, feed=feed, fetch_list=[loss, pred])
            after = _counters(tele)
            delta = tele.snapshot_delta(snap)
        got[name] = {d: after[d] - before[d] for d in after}
        assert delta.get("executor_feed_seconds_total", 0) > 0
    # x and y in f32, w cast to its declared f32; the loss and the
    # prediction fetched
    assert got["torch"] == got["jax"] == {"h2d": 20 * 15 * 4,
                                          "d2h": 4 + 20 * 4}


def test_feed_already_on_the_device_counts_nothing():
    main, startup, cost = _tiny_train_program(tfluid)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    before = _counters(ttele)
    exe.run(main, feed={"x": torch.ones(2, 4)}, fetch_list=[cost],
            scope=scope, return_numpy=False)
    after = _counters(ttele)
    assert after == before


# ---------------------------------------------------------------------------
# step profiler
# ---------------------------------------------------------------------------

def _fit_a_line(v2):
    x = v2.layer.data(name="x", type=v2.data_type.dense_vector(13))
    y_predict = v2.layer.fc(input=x, size=1, act=v2.activation.Linear())
    y = v2.layer.data(name="y", type=v2.data_type.dense_vector(1))
    cost = v2.layer.square_error_cost(input=y_predict, label=y)
    params = v2.parameters.create(cost)
    trainer = v2.trainer.SGD(cost=cost, parameters=params,
                             update_equation=v2.optimizer.Momentum(
                                 momentum=0.9, learning_rate=1e-3))
    return trainer


def _limited(reader, n):
    def limited():
        for i, batch in enumerate(reader()):
            if i >= n:
                return
            yield batch
    return limited


def test_step_profiler_v2_fit_a_line_matches_jax():
    """8 steps of v2 fit-a-line through v2.trainer.SGD from one state,
    each package under its own profiler (sample_every=2)."""
    jtrainer = _fit_a_line(jv2)
    ttrainer = _fit_a_line(tv2)
    js = jscope.global_scope()
    names = {n for b in tfluid.default_main_program().desc.blocks
             for n, vd in b.vars.items() if vd.persistable}
    tfluid.io.params_from_numpy(
        tscope.global_scope(),
        {n: np.asarray(js.get(n)) for n in sorted(names)
         if js.get(n) is not None}, "cpu")
    feeding = {"x": 0, "y": 1}
    recs = {}
    for name, perf, v2, trainer, pkg in (
            ("jax", jperf, jv2, jtrainer, jpaddle),
            ("torch", tperf, tv2, ttrainer, tpaddle)):
        reader = _limited(v2.batch(pkg.dataset.uci_housing.train(),
                                   batch_size=20), 8)
        profiler = perf.install(capacity=16, sample_every=2)
        try:
            trainer.train(reader=reader, num_passes=1, feeding=feeding)
        finally:
            perf.uninstall()
        recs[name] = profiler.records()
    assert len(recs["torch"]) == len(recs["jax"]) == 8
    for j, t in zip(recs["jax"], recs["torch"]):
        assert sorted(t) == sorted(j)
        for key in ("step", "trainer", "examples", "sampled", "failed",
                    "h2d_bytes", "d2h_bytes"):
            assert t[key] == j[key], key
        assert t["retraces"] == t["pcache_hits"] == t["pcache_misses"] == 0
        assert t["input_s"] > 0 and t["wall_s"] > 0
        if t["sampled"]:
            # one executor run a step: on the CPU its wall is device_s
            assert t["segments"]["count"] == 1
            assert t["segments"]["slowest"] == "executor/run"
            assert t["device_s"] == pytest.approx(
                t["segments"]["slowest_ms"] / 1e3, abs=1e-6)
            assert 0 < t["device_s"] <= t["wall_s"]
            assert t["host_s"] == pytest.approx(
                max(0.0, t["wall_s"] - t["device_s"] - t["input_s"]),
                abs=2e-6)
        else:
            assert t["device_s"] is None and t["host_s"] is None
    assert [r["step"] for r in recs["torch"] if r["sampled"]] == [0, 2, 4, 6]
    assert recs["torch"][0]["d2h_bytes"] == 4  # the mean cost, f32


def _run_steps(n, exe, main, cost, scope):
    for _ in range(n):
        with ttele.step("t1", examples=2):
            exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                    fetch_list=[cost], scope=scope)


def _tiny_exe():
    main, startup, cost = _tiny_train_program(tfluid)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    return exe, main, cost, scope


def test_step_profiler_records_ring_and_split():
    exe, main, cost, scope = _tiny_exe()
    profiler = tperf.install(capacity=8, sample_every=2)
    try:
        _run_steps(5, exe, main, cost, scope)
    finally:
        tperf.uninstall()
    recs = profiler.records()
    assert len(recs) == 5
    sampled = [r for r in recs if r["sampled"]]
    assert [r["step"] for r in sampled] == [0, 2, 4]
    for r in recs:
        assert r["wall_s"] > 0 and r["input_s"] > 0
        assert r["h2d_bytes"] == 2 * 4 * 4 and r["d2h_bytes"] == 4
        assert r["trainer"] == "t1" and r["examples"] == 2
    for r in sampled:
        assert 0 < r["device_s"] <= r["wall_s"]
    # the port never retraces, so every sampled step joins the mean
    s = profiler.summary()
    assert s["steps"] == 5 and s["sampled_steps"] == 3
    assert s["split_ms"]["device"] > 0
    assert profiler.classify()["verdict"] in tperf.VERDICTS
    fam = tregistry.get_registry().counter("perf_steps_profiled_total",
                                           labelnames=("trainer",))
    assert fam.labels(trainer="t1").value == 5


def test_step_profiler_ring_bounded_and_exports(tmp_path):
    exe, main, cost, scope = _tiny_exe()
    profiler = tperf.install(capacity=3, sample_every=0)
    try:
        _run_steps(5, exe, main, cost, scope)
    finally:
        tperf.uninstall()
    recs = profiler.records()
    assert [r["step"] for r in recs] == [2, 3, 4]
    assert profiler.dropped() == 2
    assert all(not r["sampled"] for r in recs)
    out = tmp_path / "steps.jsonl"
    profiler.export_jsonl(str(out))
    lines = out.read_text().strip().splitlines()
    assert len(lines) == 3 and all(json.loads(line) for line in lines)
    trace_out = tmp_path / "steps_trace.json"
    profiler.export_chrome_trace(str(trace_out))
    events = validate_chrome_trace(str(trace_out))
    assert sum(1 for e in events if e["ph"] == "X") == 3
    doc = json.load(open(str(trace_out)))
    assert doc["otherData"]["dropped_steps"] == 2
    assert doc["otherData"]["producer"] == "paddle_tpu_torch.obs.perf"


def test_step_profiler_leaves_tracer_state_alone():
    exe, main, cost, scope = _tiny_exe()
    ttrace.enable(clear=True)
    ttrace.instant("user_marker", cat="user")
    ttrace.disable()
    kept = ttrace.event_count()
    epoch0 = ttrace.epoch()
    profiler = tperf.install(sample_every=1)
    try:
        assert not ttrace.is_enabled()
        _run_steps(1, exe, main, cost, scope)
        assert not ttrace.is_enabled()
        assert ttrace.event_count() == kept
        assert ttrace.epoch() == epoch0
        assert any(ev["name"] == "user_marker" for ev in ttrace.events())
        ttrace.enable(clear=True)
        _run_steps(1, exe, main, cost, scope)
        assert ttrace.is_enabled()
        assert any(ev["name"].startswith("perf/device")
                   for ev in ttrace.events())
    finally:
        ttrace.disable()
        tperf.uninstall()
    assert profiler.records()[-1]["sampled"]


def test_device_span_only_in_a_sampled_step():
    """An unsampled step leaves no device span, even with the trace on;
    a sampled one leaves one `perf/device` span, which on the CPU
    carries its executor runs' wall."""
    exe, main, cost, scope = _tiny_exe()
    ttrace.enable(clear=True)
    profiler = tperf.install(sample_every=2)
    try:
        _run_steps(2, exe, main, cost, scope)
        exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                fetch_list=[cost], scope=scope)
    finally:
        tperf.uninstall()
        ttrace.disable()
    spans = [ev for ev in ttrace.events()
             if ev["name"].startswith("perf/device")]
    assert len(spans) == 1 and spans[0]["name"] == "perf/device[1 runs]"
    assert spans[0]["args"] == {"busy": "wall", "profiler_stop_s": None}
    rec = profiler.records()[0]
    assert rec["sampled"] and spans[0]["dur"] == pytest.approx(
        rec["device_s"] * 1e6, abs=1.0)


# ---------------------------------------------------------------------------
# history + gate
# ---------------------------------------------------------------------------

def _rec(metric, value, platform="gpu", step_ms=None, leg=None, ts=0.0,
         **extra):
    return dict({"ts": ts, "metric": metric, "value": value,
                 "unit": "img/s", "step_ms": step_ms, "mfu": None,
                 "amp_bf16": True, "platform": platform,
                 "verdict": "hbm_bound", "dominant": "conv2d", "leg": leg},
                **extra)


def _lat(scale=1.0, mode="open"):
    return {"mode": mode, "n": 200, "p50_ms": 5.0 * scale,
            "p90_ms": 8.0 * scale, "p99_ms": 20.0 * scale,
            "p99_9_ms": 45.0 * scale}


def _base(n=5, **kw):
    return [_rec("m", 1000.0 * f, ts=i, **kw)
            for i, f in enumerate([1.0, 0.99, 1.01, 0.985, 1.012][:n])]


GATE_CASES = {
    "within_noise": (_base() + [_rec("m", 995.0)], {}),
    "regression": (_base() + [_rec("m", 800.0, leg="default-b128")], {}),
    "outlier_baseline": ([_rec("m", v, ts=i) for i, v in
                          enumerate([1000, 400, 1005, 995, 1010])]
                         + [_rec("m", 700.0)], {}),
    "step_ms": ([_rec("m", 1000.0, step_ms=10.0, ts=i) for i in range(5)]
                + [_rec("m", 1000.0, step_ms=13.0)], {}),
    "stale": (_base(3) + [_rec("m", 1000.0, platform="gpu-stale")], {}),
    "stale_allowed": (_base(3) + [_rec("m", 1000.0, platform="gpu-stale")],
                      {"allow_stale": True}),
    "fallback": (_base(3) + [_rec("m", 1000.0, platform="cpu-fallback")],
                 {}),
    "mismatch": (_base(3) + [_rec("m", 1000.0, platform="cpu")], {}),
    "tolerance": (_base(4) + [_rec("m", 900.0)],
                  {"metric_tolerance": {"m": 0.15}}),
    "filter": (_base(4) + [_rec("m", 900.0)], {"metrics": {"other"}}),
    "solo": ([_rec("solo", 10.0)], {}),
    "memory": ([_rec("m", 1000.0, ts=i, memory={"device_peak_bytes": 1e9})
                for i in range(4)]
               + [_rec("m", 1000.0, memory={"device_peak_bytes": 2e9})],
               {"mem_tolerance": 0.1}),
    "latency": ([_rec("m", 100.0, ts=i, latency=_lat()) for i in range(5)]
                + [_rec("m", 100.0, latency=_lat(3.0))],
                {"latency_tolerance": 0.25}),
    "latency_mode": ([_rec("m", 100.0, ts=i, latency=_lat(mode="closed"))
                      for i in range(5)]
                     + [_rec("m", 100.0, latency=_lat(3.0))],
                     {"latency_tolerance": 0.25}),
    "comm": ([_rec("m", 100.0, ts=i, comm={"measured_s": 0.01})
              for i in range(4)]
             + [_rec("m", 100.0, comm={"measured_s": 0.02})],
             {"comm_tolerance": 0.2}),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_matches_jax(case):
    records, kw = GATE_CASES[case]
    got = tperf.gate_history(records, **kw)
    assert got.to_dict() == jperf.gate_history(records, **kw).to_dict()
    assert tperf.format_gate(got) == jperf.format_gate(
        jperf.gate_history(records, **kw))
    want_ok = case in ("within_noise", "stale_allowed", "tolerance",
                       "filter", "solo", "latency_mode")
    assert got.ok == want_ok and got.exit_code == (0 if want_ok else 1)


def _write_history(perf, path, regress):
    for i, v in enumerate([1000.0, 1005.0, 995.0, 998.0,
                           600.0 if regress else 1001.0]):
        perf.append_history(
            {"metric": "m", "value": v, "unit": "img/s", "step_ms": 10.0,
             "platform": "gpu", "perf": {"verdict": "compute_bound",
                                         "dominant": "mul"},
             "latency": _lat(), "memory": {"device_peak_bytes": 1e9}},
            path, leg="l", ts=float(i))


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("regress", [False, True])
def test_history_files_cross_both_ways(tmp_path, writer, regress):
    path = str(tmp_path / "hist.jsonl")
    _write_history(jperf if writer == "jax" else tperf, path, regress)
    with open(path, "a") as f:
        f.write('{"metric": "m", "val')  # a torn append
    jr, tr = jperf.load_history(path), tperf.load_history(path)
    assert tr == jr and len(tr) == 5
    for kw in ({}, {"latency_tolerance": 0.5, "mem_tolerance": 0.1}):
        got = tperf.gate_history(tr, **kw)
        assert got.to_dict() == jperf.gate_history(jr, **kw).to_dict()
        assert got.ok is (not regress)
    assert tperf.prune_stale_history(path) == \
        jperf.prune_stale_history(path)


def test_normalize_record_matches_jax():
    rec = {"metric": "m1", "value": 100.0, "unit": "img/s",
           "step_ms": 10.0, "mfu": 0.3, "amp_bf16": True,
           "platform": "gpu", "n_devices": 1,
           "perf": {"verdict": "compute_bound", "dominant": "conv2d",
                    "reason": "dropped"},
           "compile_cache": {"hits": 0, "misses": 0},
           "latency": dict(_lat(), extra="dropped"),
           "config": {"model": "resnet50"}}
    assert tperf.normalize_record(rec, leg="l", ts=1.0) == \
        jperf.normalize_record(rec, leg="l", ts=1.0)
    assert tperf.normalize_record({"metric": "m", "skipped": "x"}) is None
    for r in ({"platform": "gpu"}, {"platform": "cpu", "n_devices": 8,
                                    "mesh": {"dp": 8}},
              {"platform_class": "gpu:d4"}):
        assert tperf.platform_class(r) == jperf.platform_class(r)
    for p in ("gpu", "gpu-stale", "cpu-fallback", "", None):
        assert tperf.is_stale_platform(p) == jperf.is_stale_platform(p)
    assert (tperf.DEFAULT_TOLERANCE, tperf.DEFAULT_BASELINE_N,
            tperf.DEFAULT_INPUT_SHARE, tperf.DEFAULT_HOST_SHARE,
            tperf.HISTORY_BASENAME) == \
        (jperf.DEFAULT_TOLERANCE, jperf.DEFAULT_BASELINE_N,
         jperf.DEFAULT_INPUT_SHARE, jperf.DEFAULT_HOST_SHARE,
         jperf.HISTORY_BASENAME)
    assert tperf.platform_of(tfluid.CPUPlace()) == "cpu"
    assert tperf.platform_of(tfluid.CUDAPlace(0)) == "gpu"


def test_perf_cli_gate_exit_codes(tmp_path):
    path = str(tmp_path / "h.jsonl")
    for i, v in enumerate([1000.0, 1005.0, 995.0, 998.0]):
        tperf.append_history({"metric": "m", "value": v, "unit": "img/s",
                              "platform": "gpu"}, path, ts=float(i))
    assert perf_cli.main(["gate", "--history", path]) == 0
    tperf.append_history({"metric": "m", "value": 600.0, "unit": "img/s",
                          "platform": "gpu"}, path, ts=99.0)
    assert perf_cli.main(["gate", "--history", path]) == 1
    assert perf_cli.main(["gate", "--history",
                          str(tmp_path / "none.jsonl")]) == 2
    assert perf_cli.main(["history", "--history", path]) == 0


def test_perf_cli_classify_matches_jax(capsys):
    """`classify --json` on the same bench model at explicit figures:
    the port's private copy of the bench-model builder gives the JAX
    builder's program, and the floors agree."""
    import __graft_entry__
    from paddle_tpu import models as jmodels
    from paddle_tpu_torch.fluid import analysis

    argv = ["classify", "--model", "smallnet", "--batch", "8",
            "--image-size", "32", "--class-dim", "10", "--f32",
            "--peak-tflops", "100", "--hbm-gbps", "500", "--json"]
    assert perf_cli.main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    jmain, _, _, _ = __graft_entry__._build_model(
        jmodels.smallnet_mnist_cifar, 8, 32, 10, with_loss=True)
    _close(got, json.loads(json.dumps(jperf.roofline_floors(
        jmain, peak_tflops=100.0, hbm_gbps=500.0, topk=12))))
    tmain, _, _, _ = perf_cli._build_model(
        tpaddle.models.smallnet_mnist_cifar, 8, 32, 10, with_loss=True)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    # the default figures: f32 at the f32 cores' 67 TFLOP/s
    assert perf_cli.main(argv[:-5] + ["--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    rep = analysis.roofline_report(tmain, peak_tflops=67.0,
                                   hbm_gbps=3350.0)
    assert got["peak_tflops"] == 67.0
    assert got["floor_ms_serial"] == pytest.approx(rep["floor_ms_serial"],
                                                   rel=REL)
    assert perf_cli.main(argv[:-5] + ["--step-ms", "5"]) == 0
    assert "measured 5.00 ms ->" in capsys.readouterr().out
    assert not tfluid.amp.bf16_enabled()


# ---------------------------------------------------------------------------
# SLO burn
# ---------------------------------------------------------------------------

def test_slo_tracker_burn_windows():
    from paddle_tpu_torch.serving.metrics import ServingMetrics, SLOTracker

    m = ServingMetrics()
    slo = SLOTracker(m, objective_ms=100.0, target=0.9, model="mdl")
    assert slo.update() == 0.0
    for _ in range(8):
        m.total_seconds.observe(0.01)
    for _ in range(2):
        m.total_seconds.observe(5.0)
    assert slo.update() == pytest.approx(2.0, rel=0.05)
    for _ in range(5):
        m.total_seconds.observe(0.01)
    assert slo.update() == pytest.approx(0.0, abs=1e-9)
    fam = tregistry.get_registry().gauge("slo_burn_rate",
                                         labelnames=("model",))
    assert fam.labels(model="mdl").value == 0.0
    with pytest.raises(ValueError):
        SLOTracker(m, objective_ms=50, target=1.0)
    with pytest.raises(ValueError):
        SLOTracker(m, objective_ms=60_000)


def test_server_healthz_carries_slo_burn():
    from paddle_tpu_torch.fluid import io as fluid_io
    from paddle_tpu_torch.serving import (EngineConfig, InferenceEngine,
                                          InferenceServer, ServerConfig)

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        img = tfluid.layers.data(name="img", shape=[4], dtype="float32")
        out = tfluid.layers.fc(input=img, size=2)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    program = fluid_io.prune_program(main, [out])
    engine = InferenceEngine(program, ["img"], [out],
                             place=tfluid.CPUPlace(), scope=scope,
                             config=EngineConfig(batch_buckets=[2]))
    server = InferenceServer(engine, ServerConfig(
        warmup=False, slo_ms=30_000, slo_target=0.99, model_name="m0"))
    server.batcher.start()
    try:
        status, _ = server.handle_infer(
            {"inputs": {"img": np.zeros((1, 4)).tolist()}})
        assert status == 200
        health = server.health_signals()
    finally:
        server.batcher.close()
    assert health["slo"]["objective_ms"] == 30_000
    assert health["slo_burn_rate"] == 0.0
    server2 = InferenceServer(engine, ServerConfig(warmup=False))
    assert "slo_burn_rate" not in server2.health_signals()


def test_perf_cli_selftest_on_the_cpu(capsys):
    assert perf_cli.main(["--selftest", "--use_gpu=0"]) == 0
    out = capsys.readouterr().out
    assert "[pperf] selftest green" in out
    assert "waits with the persistent executable cache (ROADMAP A2)" in out
