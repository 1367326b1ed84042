"""Dump and check the port's observability state: Chrome trace-event
JSON (Perfetto-loadable) and the unified metrics registry.

    # validate a trace file someone handed you:
    python -m paddle_tpu_torch.tools.obs_dump --check trace.json

    # pretty-print a crash flight bundle (obs.flight):
    python -m paddle_tpu_torch.tools.obs_dump --flight flight_1234_001.json

    # pretty-print a tail-capture dump (obs.tail / GET /debug/tail):
    python -m paddle_tpu_torch.tools.obs_dump --tail tail.json

    # the end-to-end check, on the card (--use_gpu=0: on the CPU):
    python -m paddle_tpu_torch.tools.obs_dump --selftest

    # IN-PROCESS, at the end of a run you instrumented with
    # obs.trace.tracing() (trace and registry state live in the process
    # that ran the workload):
    from paddle_tpu_torch.tools import obs_dump
    obs_dump.main(["--trace-out", "trace.json",
                   "--metrics-out", "metrics.prom"])

Counterpart of paddle_tpu/tools/obs_dump.py.  The validators and
renderers are the JAX module's, so each accepts what the JAX one
accepts, and the two packages' bundles, tail dumps, traces and
expositions cross both ways.  `--selftest` runs a tiny real workload
under tracing at the place `--use_gpu` names: a v2 SGD trainer (the
executor underneath), a serving InferenceEngine request pair (a
bucket's first run and a repeat), a request-tracing leg (a loopback
server: traceparent continued and request_id echoed, also on an error
reply; a request slowed by an injected `latency` fault at `serving/run`
leaves its exemplar in /metrics and its span tree in the tail ring), and
a deliberately-NaN health and flight leg (NumericsMonitor counts,
locate_nonfinite names the op, an induced crash writes a flight bundle).
It then checks that the exported trace is valid Chrome trace-event JSON
with executor runs nested in trainer steps and op spans nested in
executor runs, and that ONE registry render carries the executor, trainer
and serving metrics.  The JAX selftest's jit-segment spans, trace and
transfer counters and XLA memory and cost gauges have no counterpart in
the port's eager executor.
"""

import argparse
import json
import os
import sys
import tempfile

from . import cli_place, use_gpu_arg


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="paddle_obs_dump")
    p.add_argument("--trace-out", default=None,
                   help="write the collected trace as Chrome "
                        "trace-event JSON")
    p.add_argument("--metrics-out", default=None,
                   help="write the unified metrics registry ('-' for "
                        "stdout)")
    p.add_argument("--format", choices=("prom", "jsonl"),
                   default="prom",
                   help="metrics format: Prometheus text or JSONL")
    p.add_argument("--check", default=None, metavar="TRACE_JSON",
                   help="validate an existing Chrome trace file and "
                        "exit")
    p.add_argument("--flight", default=None, metavar="BUNDLE_JSON",
                   help="validate and pretty-print a flight-recorder "
                        "bundle (obs.flight) and exit")
    p.add_argument("--tail", default=None, metavar="TAIL_JSON",
                   help="validate and pretty-print a tail-capture "
                        "dump (obs.tail / the server's /debug/tail "
                        "body) and exit")
    p.add_argument("--use_gpu", type=use_gpu_arg, default=True,
                   help="1 (default): the selftest runs on CUDAPlace(0); "
                        "0: on the CPU")
    p.add_argument("--selftest", action="store_true",
                   help="run a tiny traced workload and assert the "
                        "whole obs pipeline works end to end")
    return p.parse_args(argv)


# ---------------------------------------------------------------------------
# validation helpers (also used by tests): the JAX module's, line for line
# ---------------------------------------------------------------------------

def validate_chrome_trace(doc):
    """Assert `doc` (dict or path) is a loadable Chrome trace-event
    document; returns the traceEvents list."""
    if not isinstance(doc, dict):
        with open(doc) as f:
            doc = json.load(f)
    events = doc.get("traceEvents")
    assert isinstance(events, list) and events, \
        "traceEvents missing or empty"
    for ev in events:
        assert isinstance(ev.get("name"), str), ev
        assert ev.get("ph") in ("X", "B", "E", "i", "M", "C"), ev
        if ev["ph"] in ("X", "B", "E", "i"):
            assert isinstance(ev.get("ts"), (int, float)), ev
            assert "pid" in ev and "tid" in ev, ev
        if ev["ph"] == "X":
            assert isinstance(ev.get("dur"), (int, float)), ev
    return events


def validate_prometheus_text(text):
    """Assert every exposition line parses as comment or
    `name[{labels}] value[ # {exemplar} value ts]` (the bracketed
    suffix is OpenMetrics exemplar syntax on histogram buckets);
    returns the set of metric names seen."""
    names = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        sample, _, exemplar = line.partition(" # ")
        if exemplar:
            labels, _, rest = exemplar.partition("} ")
            assert labels.startswith("{"), "bad exemplar: %r" % line
            ex_value, _, ex_ts = rest.partition(" ")
            float(ex_value)
            if ex_ts:
                float(ex_ts)
        body, _, value = sample.rpartition(" ")
        assert body, "unparseable line: %r" % line
        float(value)  # raises if the sample value isn't numeric
        name = body.split("{", 1)[0]
        assert name and " " not in name, "bad metric name: %r" % line
        names.add(name)
    assert names, "no metric samples in exposition"
    return names


def validate_flight_bundle(doc):
    """Assert `doc` (dict or path) is a well-formed flight-recorder
    bundle; returns the loaded dict."""
    if not isinstance(doc, dict):
        with open(doc) as f:
            doc = json.load(f)
    assert doc.get("kind") == "paddle_tpu.flight", \
        "not a flight bundle (kind=%r)" % doc.get("kind")
    assert isinstance(doc.get("version"), int)
    assert isinstance(doc.get("steps"), list)
    assert isinstance(doc.get("registry"), dict)
    assert isinstance(doc.get("notes"), list)
    for rec in doc["steps"]:
        assert "step" in rec and "trainer" in rec, rec
        assert isinstance(rec.get("telemetry_delta", {}), dict)
    exc = doc.get("exception")
    if exc is not None:
        assert "type" in exc and "message" in exc, exc
    return doc


def render_flight(doc, max_steps=8):
    """Human-readable summary of a flight bundle (the --flight CLI
    output)."""
    doc = validate_flight_bundle(doc)
    lines = []
    lines.append("flight bundle v%d  reason=%s  steps=%d (%d dropped)"
                 % (doc["version"], doc.get("reason"),
                    len(doc["steps"]), doc.get("dropped_steps", 0)))
    ctx = doc.get("trace_context")
    if ctx:
        lines.append("request: id=%s trace=%s span=%s"
                     % (ctx.get("request_id"), ctx.get("trace_id"),
                        ctx.get("span_id")))
    exc = doc.get("exception")
    if exc:
        lines.append("exception: %s: %s" % (exc["type"], exc["message"]))
        tb = exc.get("traceback") or ""
        lines.extend("  " + l for l in tb.rstrip().splitlines()[-3:])
    for note in doc.get("notes", []):
        ctx = {k: v for k, v in note.items()
               if k not in ("t", "origin", "oom")}
        lines.append("note [%s] %s" % (note.get("origin"), ctx))
        oom = note.get("oom")
        if oom:
            # the obs.mem post-mortem: name WHICH buffers were
            # resident, not just "out of memory"
            if oom.get("total_peak_bytes") is not None:
                lines.append(
                    "  OOM post-mortem: static peak %.1f MiB "
                    "(params+state %.1f + activations %.1f at op "
                    "%s %s)"
                    % (oom["total_peak_bytes"] / 2**20,
                       oom.get("params_bytes", 0) / 2**20,
                       oom.get("static_peak_bytes", 0) / 2**20,
                       oom.get("peak_op"), oom.get("peak_op_type")))
            for b in oom.get("top_buffers", [])[:5]:
                lines.append("    %-40s %10.2f MiB  def op %s (%s)"
                             % (b["name"], b["bytes"] / 2**20,
                                b.get("def_op"),
                                b.get("def_op_type")))
            for k, v in sorted((oom.get("mem_gauges") or {}).items()):
                lines.append("    gauge %s = %g" % (k, v))
            for dev, stats in sorted((oom.get("device") or {}).items()):
                lines.append("    device %s: %.1f MiB in use, peak "
                             "%.1f MiB"
                             % (dev,
                                stats.get("bytes_in_use", 0) / 2**20,
                                stats.get("peak_bytes_in_use", 0)
                                / 2**20))
    steps = doc["steps"][-max_steps:]
    if steps:
        lines.append("last %d step(s):" % len(steps))
    for rec in steps:
        delta = rec.get("telemetry_delta") or {}
        bits = ["step=%s" % rec.get("step"),
                "trainer=%s" % rec.get("trainer")]
        if rec.get("loss") is not None:
            bits.append("loss=%.6g" % rec["loss"])
        if rec.get("feeds"):
            bits.append("feeds=%s" % rec["feeds"])
        bits.append("%d metric(s) moved" % len(delta))
        lines.append("  " + "  ".join(bits))
    reg = doc.get("registry", {})
    interesting = {k: v for k, v in sorted(reg.items())
                   if k.startswith(("numerics_", "grad_global_norm",
                                    "amp_loss_scale", "xla_", "mem_",
                                    "trainer_last_loss",
                                    "executor_jit_traces_total"))}
    lines.append("registry: %d metric sample(s)%s"
                 % (len(reg), "" if not interesting
                    else ", notable:"))
    for k, v in interesting.items():
        lines.append("  %s = %g" % (k, v))
    lines.append("recent spans: %d" % len(doc.get("recent_spans", [])))
    return "\n".join(lines)


def validate_tail_dump(doc):
    """Assert `doc` (dict or path) is a well-formed tail-capture dump
    (obs.tail.TailRecorder.dump / the /debug/tail body); returns the
    loaded dict."""
    if not isinstance(doc, dict):
        with open(doc) as f:
            doc = json.load(f)
    assert doc.get("kind") == "paddle_tpu.tail", \
        "not a tail dump (kind=%r)" % doc.get("kind")
    assert isinstance(doc.get("version"), int)
    assert isinstance(doc.get("requests"), list)
    for rec in doc["requests"]:
        assert rec.get("reason") in ("slow", "error"), rec
        assert "trace_id" in rec and "request_id" in rec, rec
        assert isinstance(rec.get("latency_ms"), (int, float)), rec
        assert isinstance(rec.get("spans"), list), rec
    return doc


def _render_span_node(node, depth, lines):
    args = node.get("args") or {}
    arg_str = "" if not args else "  %s" % args
    lines.append("  %s%s %.3fms%s"
                 % ("  " * depth, node["name"],
                    node.get("dur_ms", 0.0), arg_str))
    for child in node.get("children", []):
        _render_span_node(child, depth + 1, lines)


def render_tail(doc, max_requests=8):
    """Human-readable summary of a tail dump (the --tail CLI output):
    one block per captured request with its indented span tree."""
    doc = validate_tail_dump(doc)
    lines = ["tail dump v%d  slow_ms=%s  captured=%d (%d evicted)"
             % (doc["version"], doc.get("slow_ms"),
                doc.get("total_captured", len(doc["requests"])),
                doc.get("evicted", 0))]
    for rec in doc["requests"][-max_requests:]:
        head = ("request %s  trace %s  %s  %.1fms  status=%s"
                % (rec["request_id"], rec["trace_id"], rec["reason"],
                   rec["latency_ms"], rec.get("status")))
        if rec.get("error"):
            head += "  error=%s" % rec["error"]
        lines.append(head)
        for root in rec["spans"]:
            _render_span_node(root, 0, lines)
    return "\n".join(lines)


def _find_span(events, prefix):
    return [ev for ev in events
            if ev["ph"] == "X" and ev["name"].startswith(prefix)]


def _nested_within(outer, inner):
    return (outer["tid"] == inner["tid"]
            and outer["ts"] <= inner["ts"] + 1e-3
            and inner["ts"] + inner.get("dur", 0)
            <= outer["ts"] + outer["dur"] + 1e-3)


# ---------------------------------------------------------------------------
# selftest workload
# ---------------------------------------------------------------------------

def _train_tiny_v2(use_gpu):
    """Three SGD steps through the v2 trainer (the executor
    underneath)."""
    import numpy as np

    from .. import v2 as paddle

    paddle.init(use_gpu=use_gpu)
    x = paddle.layer.data(name="x",
                          type=paddle.data_type.dense_vector(4))
    y = paddle.layer.data(name="y",
                          type=paddle.data_type.dense_vector(1))
    pred = paddle.layer.fc(input=x, size=1)
    cost = paddle.layer.square_error_cost(input=pred, label=y)
    params = paddle.parameters.create(cost)
    trainer = paddle.trainer.SGD(
        cost=cost, parameters=params,
        update_equation=paddle.optimizer.Momentum(momentum=0.9,
                                                  learning_rate=0.1))
    rs = np.random.RandomState(0)

    def reader():
        for _ in range(3):
            yield [(rs.rand(4).astype("f"), rs.rand(1).astype("f"))
                   for _ in range(4)]

    trainer.train(reader=reader, num_passes=1,
                  feeding={"x": 0, "y": 1})


def _tiny_classifier(place):
    """(pruned inference program, fetch var, scope) of an 8 -> 3 softmax
    classifier, its startup run at `place`."""
    from .. import fluid
    from ..fluid import io as fluid_io

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[8], dtype="float32")
        probs = fluid.layers.fc(input=img, size=3, act="softmax")
    scope = fluid.Scope()
    fluid.Executor(place).run(startup, scope=scope)
    return fluid_io.prune_program(main, [probs]), probs, scope


def _serve_tiny(place):
    """A bucket's first run and a repeat of it through the serving
    engine, with ServingMetrics mounted on the unified registry."""
    import numpy as np

    from ..serving import EngineConfig, InferenceEngine
    from ..serving.metrics import ServingMetrics

    program, probs, scope = _tiny_classifier(place)
    metrics = ServingMetrics()
    engine = InferenceEngine(
        program, ["img"], [probs], place=place, scope=scope,
        metrics=metrics, config=EngineConfig(batch_buckets=[2, 4]))
    engine.run({"img": np.zeros((2, 8), np.float32)})  # first run
    engine.run({"img": np.ones((1, 8), np.float32)})   # same bucket
    assert metrics.cache_miss_total.value >= 1
    assert metrics.cache_hit_total.value >= 1
    return metrics


def _trace_serve_tiny(workdir, place):
    """The request-tracing contract end to end over a real loopback
    server: a traceparent header is continued and echoed with a minted
    request_id (also on an error reply), a request slowed by an injected
    fault leaves an OpenMetrics exemplar carrying its trace id on the
    /metrics latency histogram, and the tail ring keeps that request's
    span tree, rendered by this CLI's own --tail path."""
    import http.client

    from ..resilience import faults as r_faults
    from ..serving import (EngineConfig, InferenceEngine, InferenceServer,
                           ServerConfig)

    program, probs, scope = _tiny_classifier(place)
    engine = InferenceEngine(program, ["img"], [probs], place=place,
                             scope=scope,
                             config=EngineConfig(batch_buckets=[2]))
    server = InferenceServer(engine, ServerConfig(
        port=0, tail_slow_ms=50.0)).start()
    host, port = server.address

    def post(payload, headers=None):
        conn = http.client.HTTPConnection(host, port, timeout=30)
        try:
            conn.request("POST", "/v1/infer", json.dumps(payload),
                         dict({"Content-Type": "application/json"},
                              **(headers or {})))
            resp = conn.getresponse()
            return (resp.status, json.loads(resp.read()),
                    dict(resp.getheaders()))
        finally:
            conn.close()

    def get(path, headers=None):
        conn = http.client.HTTPConnection(host, port, timeout=30)
        try:
            conn.request("GET", path, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, resp.read().decode()
        finally:
            conn.close()

    trace_id = "0af7651916cd43dd8448eb211c80319c"
    traceparent = "00-%s-b7ad6b7169203331-01" % trace_id
    # the slow request gets a trace id of its own: the exemplar and
    # tail checks below must not be met by the fast request
    slow_trace_id = "deadbeefcafe43dd8448eb211c80319c"
    slow_traceparent = "00-%s-b7ad6b7169203331-01" % slow_trace_id
    payload = {"inputs": {"img": [[0.5] * 8]}}
    try:
        # traceparent continued, request_id minted and echoed
        status, body, headers = post(payload,
                                     {"traceparent": traceparent})
        assert status == 200 and body.get("request_id"), body
        assert headers.get("traceparent", "").split("-")[1] \
            == trace_id, headers
        assert headers.get("x-request-id") == body["request_id"]

        # an injected slow request (a deterministic fault, not a sleep
        # race) leaves an exemplar and a tail capture
        plan = r_faults.enable(seed=0)
        plan.inject("serving/run", "latency", latency_s=0.12, times=1)
        try:
            status, _, _ = post(payload,
                                {"traceparent": slow_traceparent})
            assert status == 200
        finally:
            r_faults.disable()

        # exemplars render only on a negotiated OpenMetrics scrape; a
        # plain 0.0.4 scrape stays free of the suffix syntax
        _, plain_text = get("/metrics")
        validate_prometheus_text(plain_text)
        assert not any(" # " in line
                       for line in plain_text.splitlines()), \
            "plain text-format scrape leaked OpenMetrics exemplars"
        _, metrics_text = get(
            "/metrics",
            {"Accept": "application/openmetrics-text"})
        validate_prometheus_text(metrics_text)
        assert any("serving_total_seconds_bucket" in line
                   and " # " in line and slow_trace_id in line
                   for line in metrics_text.splitlines()), \
            "no latency-bucket exemplar carries the slow request's " \
            "trace id"

        tail_path = os.path.join(workdir, "tail.json")
        server.tail.dump(tail_path)
        rendered = render_tail(tail_path)
        for needed in ("serving/queue_wait", "serving/device_execute",
                       slow_trace_id):
            assert needed in rendered, \
                "%s missing from --tail render:\n%s" % (needed,
                                                        rendered)
        status, tail_body = get("/debug/tail")
        assert status == 200 and \
            validate_tail_dump(json.loads(tail_body))["requests"]

        # error replies still carry the request_id
        server.draining = True
        status, body, _ = post(payload)
        server.draining = False
        assert status == 503 and body.get("request_id"), body
        error_request_id = body["request_id"]
    finally:
        server.shutdown()
    return {"trace_id": slow_trace_id, "tail_path": tail_path,
            "error_request_id": error_request_id}


def _health_flight_tiny(workdir, place):
    """The diagnosis loop end to end: a deliberately-NaN step makes the
    NumericsMonitor count, locate_nonfinite names the offending op, and
    an induced crash leaves a flight bundle this CLI can render."""
    import numpy as np

    from .. import fluid
    from ..obs import flight as obs_flight
    from ..obs import health as obs_health
    from ..utils import flags

    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        h = fluid.layers.fc(input=x, size=3)
        cost = fluid.layers.mean(x=h)
        _, pg = fluid.optimizer.SGDOptimizer(
            learning_rate=0.1).minimize(cost)
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    with fluid.scope_guard(scope):
        exe.run(startup)
        monitor = obs_health.NumericsMonitor.for_train_program(
            main_prog, cost=cost, params_grads=pg).install()
        bad = np.full((2, 4), np.nan, np.float32)
        outs = exe.run(main_prog, feed={"x": bad},
                       fetch_list=[cost] + monitor.fetch_names)
        summary = monitor.record(dict(zip(monitor.fetch_names,
                                          outs[1:])))
        assert summary["found_nonfinite"], summary
        report = obs_health.locate_nonfinite(main_prog, {"x": bad},
                                             scope=scope, place=place)
        assert report and report["op_type"], report

        # an induced crash through the executor's exception hook
        recorder = obs_flight.install(out_dir=workdir, capacity=8)
        flag_prev = flags.get_flag("check_nan_inf")
        flags.set_flag("check_nan_inf", True)
        try:
            exe.run(main_prog, feed={"x": bad}, fetch_list=[cost])
            raise AssertionError("NaN feed did not trip check_nan_inf")
        except fluid.executor.NonfiniteError:
            pass
        finally:
            flags.set_flag("check_nan_inf", flag_prev)
            obs_flight.uninstall()
    bundle = recorder.last_bundle_path
    assert bundle and os.path.exists(bundle), "no flight bundle written"
    rendered = render_flight(bundle)
    assert "NonfiniteError" in rendered
    return report, bundle


def selftest(args):
    from ..obs import registry as obs_registry
    from ..obs import telemetry as obs_tele
    from ..obs import trace as obs_trace

    place = cli_place(args.use_gpu)
    workdir = tempfile.mkdtemp(prefix="paddle_obs_")
    obs_trace.enable(clear=True)
    try:
        _train_tiny_v2(args.use_gpu)
        metrics = _serve_tiny(place)
        tracing_report = _trace_serve_tiny(workdir, place)
        health_report, flight_bundle = _health_flight_tiny(workdir, place)
    finally:
        obs_trace.disable()

    # the trace: valid Chrome JSON, executor runs nested in trainer
    # steps, op spans nested in executor runs
    trace_path = args.trace_out or os.path.join(workdir, "trace.json")
    obs_trace.export_chrome_trace(trace_path)
    events = validate_chrome_trace(trace_path)
    steps = _find_span(events, "v2/step")
    runs = _find_span(events, "executor/run")
    ops = [ev for ev in events if ev["ph"] == "X" and ev.get("cat") == "op"]
    serving_spans = _find_span(events, "serving/engine_run")
    assert steps, "no trainer spans in trace"
    assert runs, "no executor spans in trace"
    assert ops, "no op spans in trace"
    assert serving_spans, "no serving spans in trace"
    assert any(_nested_within(st, r) for st in steps for r in runs), \
        "executor/run span not nested inside a v2/step span"
    assert any(_nested_within(r, op) for r in runs for op in ops), \
        "op span not nested inside an executor/run span"

    # the metrics: ONE registry render carries all three layers
    text = metrics.render_text()
    names = validate_prometheus_text(text)
    for needed in ("executor_runs_total", "trainer_steps_total",
                   "trainer_step_seconds",
                   "serving_compile_cache_miss_total",
                   "serving_compile_cache_hit_total",
                   "faults_injected_total"):
        # histograms expose only _bucket/_sum/_count sample names
        assert any(n == needed or n.startswith(needed + "_")
                   for n in names), \
            "%s missing from unified exposition:\n%s" % (needed, text)

    # the health side: the NaN loop counted
    snap = obs_tele.snapshot()
    assert any(k.startswith("numerics_nonfinite_total{") and v > 0
               for k, v in snap.items()), \
        "NaN run left no numerics_nonfinite_total samples"

    # the same data as JSONL for offline diffing
    jsonl = obs_registry.get_registry().render_jsonl()
    for line in jsonl.strip().splitlines():
        json.loads(line)

    if args.metrics_out:
        _write_metrics(args, text if args.format == "prom" else jsonl)
    print("[obs] selftest green on %r: %d trace events (%d trainer "
          "steps, %d executor runs, %d op spans, %d serving spans), "
          "unified /metrics has %d metric families, first nonfinite op "
          "%r, flight bundle at %s, trace at %s; tracing leg: exemplar "
          "trace %s in /metrics, tail dump at %s, error reply request_id "
          "%s"
          % (place, len(events), len(steps), len(runs), len(ops),
             len(serving_spans), len(names), health_report["op_type"],
             flight_bundle, trace_path, tracing_report["trace_id"],
             tracing_report["tail_path"],
             tracing_report["error_request_id"]), flush=True)
    return 0


# ---------------------------------------------------------------------------
# plain dump modes
# ---------------------------------------------------------------------------

def _write_metrics(args, payload):
    if args.metrics_out == "-":
        sys.stdout.write(payload)
        return
    with open(args.metrics_out, "w") as f:
        f.write(payload)


def main(argv=None):
    args = parse_args(argv)
    if args.selftest:
        return selftest(args)
    if args.check:
        events = validate_chrome_trace(args.check)
        print("[obs] %s: valid Chrome trace with %d events"
              % (args.check, len(events)), flush=True)
        return 0
    if args.flight:
        print(render_flight(args.flight), flush=True)
        return 0
    if args.tail:
        print(render_tail(args.tail), flush=True)
        return 0
    if not args.trace_out and not args.metrics_out:
        raise SystemExit("nothing to do: pass --selftest, --check, "
                         "--flight, --tail, --trace-out and/or "
                         "--metrics-out")
    from ..obs import registry as obs_registry
    from ..obs import trace as obs_trace

    if args.trace_out:
        doc = obs_trace.export_chrome_trace(args.trace_out)
        n = sum(1 for e in doc["traceEvents"] if e["ph"] != "M")
        print("[obs] wrote trace: %s (%d events)%s"
              % (args.trace_out, n,
                 "" if n else " — EMPTY: dump modes export THIS "
                 "process's state; call obs_dump.main() in-process "
                 "after obs.trace.tracing()"), flush=True)
    if args.metrics_out:
        reg = obs_registry.get_registry()
        _write_metrics(args, reg.render_text() if args.format == "prom"
                       else reg.render_jsonl())
        if args.metrics_out != "-":
            print("[obs] wrote metrics: %s" % args.metrics_out,
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
