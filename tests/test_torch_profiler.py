"""`fluid.profiler` of the port against the JAX package's, on the CPU.

- The per-op table of 2 steps of an MLP with SGD under `profiler()`:
  the same event names and call counts as the JAX package's eager run
  (`eager=True` in both packages: their per-op interpreters; a captured
  segment records no op), and the same `profiler_event_calls_total`
  counters.
- `record_event` puts an `op` span on the obs trace while tracing is
  on in an eager run, without the table; while both are off the
  executor opens none.
- `profiler(trace_dir=...)` writes a Chrome trace, `trace.json`, whose
  events name the executor's ops; the printed table is sorted by the
  key asked for.
- The serving metrics mirror each stage's latency into the table.
"""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.fluid import profiler as j_profiler
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import profiler as t_profiler
from paddle_tpu_torch.obs import registry as t_registry
from paddle_tpu_torch.obs import trace as t_trace

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh_port_obs():
    t_registry.reset_registry()
    t_trace.disable()
    t_trace.reset()
    t_profiler.reset_profiler()
    yield
    t_trace.disable()
    t_trace.reset()
    t_profiler.reset_profiler()


def _mlp(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        h = fluid.layers.fc(input=x, size=6, act="relu")
        cost = fluid.layers.mean(x=fluid.layers.fc(input=h, size=3))
        fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(cost)
    return main, startup, cost


FEED = {"x": np.ones((2, 4), np.float32)}


def _port_run(steps=2, **kw):
    main, startup, cost = _mlp(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    with t_profiler.profiler(**kw):
        for _ in range(steps):
            exe.run(main, feed=FEED, fetch_list=[cost], scope=scope,
                    eager=True)
    return main


def test_table_names_and_counts_match_jax_eager(capsys):
    jmain, jstartup, jcost = _mlp(jfluid)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    with jfluid.scope_guard(scope):
        exe.run(jstartup)
        with j_profiler.profiler():
            for _ in range(2):
                exe.run(jmain, feed=FEED, fetch_list=[jcost], eager=True)
    want = {k: v["calls"] for k, v in j_profiler.get_profile_records()
            .items()}
    main = _port_run()
    got = {k: v["calls"] for k, v in t_profiler.get_profile_records()
           .items()}
    assert got == want
    assert sum(got.values()) == 2 * len(main.desc.block(0).ops)
    for rec in t_profiler.get_profile_records().values():
        assert 0.0 <= rec["min"] <= rec["max"] <= rec["total"]
    calls = t_registry.get_registry().counter(
        "profiler_event_calls_total", labelnames=("event",))
    assert {s["labels"]["event"]: s["value"] for s in calls.samples()} \
        == got
    out = capsys.readouterr().out
    assert out.splitlines()[-len(got) - 1].split()[:2] == ["Event", "Calls"]


def test_table_sorted_by_key(capsys):
    _port_run(steps=1, sorted_key="calls")
    rows = capsys.readouterr().out.splitlines()[1:]
    calls = [int(r.split()[1]) for r in rows]
    assert calls == sorted(calls, reverse=True)


def test_record_event_spans_while_tracing_only():
    main, startup, cost = _mlp(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    assert not t_profiler.active()
    t_trace.enable()
    assert t_profiler.active()
    exe.run(main, feed=FEED, fetch_list=[cost], scope=scope, eager=True)
    spans = [e["name"] for e in t_trace.events() if e.get("cat") == "op"]
    assert spans == [op.type for op in main.desc.block(0).ops]
    assert t_profiler.get_profile_records() == {}


def test_no_record_event_while_both_are_off(monkeypatch):
    main, startup, cost = _mlp(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)

    def refuse(name):
        raise AssertionError("record_event opened for %s" % name)

    monkeypatch.setattr(t_profiler, "record_event", refuse)
    out = exe.run(main, feed=FEED, fetch_list=[cost], scope=scope)[0]
    assert np.isfinite(out).all()


def test_trace_dir_writes_a_chrome_trace(tmp_path):
    main = _port_run(steps=1, trace_dir=str(tmp_path / "trace"))
    path = tmp_path / "trace" / t_profiler.TRACE_FILE
    with open(str(path)) as f:
        doc = json.load(f)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {op.type for op in main.desc.block(0).ops} <= names
    assert os.path.getsize(str(path)) > 0


def test_serving_stages_feed_the_table():
    from paddle_tpu_torch.serving.metrics import ServingMetrics

    m = ServingMetrics()
    with t_profiler.profiler():
        m.observe_stage("queue", 0.5)
        m.observe_stage("queue", 0.25)
    rec = t_profiler.get_profile_records()["serving/queue"]
    assert rec["calls"] == 2 and rec["total"] == 0.75
    assert m.queue_seconds.count == 2
    assert set(t_profiler.__all__) == set(j_profiler.__all__)
