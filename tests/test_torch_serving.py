"""The served slice as a whole: a small transformer built, initialised
and exported by the JAX package is loaded and served by the port on the
CPU, and its logits agree with the JAX package's InferenceEngine.

Model: batch 4, seq 32, vocab 64, 2 layers, 4 heads, d_model 32, the
same program `bench.py` serves at full width.  Tolerance: logits at atol
1e-4 (f32 on both sides; matmuls and attention sum in other orders
through two layers).
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.fluid import io as jio
from paddle_tpu.models.transformer_program import build_transformer_program
from paddle_tpu.serving import InferenceEngine as JEngine
from paddle_tpu_torch.core.desc import ProgramDesc
from paddle_tpu_torch.fluid import CPUPlace, Executor, Scope, io
from paddle_tpu_torch.models.transformer_program import (
    build_transformer_inference_program, init_transformer_params,
    logits_name, transformer_feeds)
from paddle_tpu_torch.serving import (EngineConfig, InferenceEngine,
                                      InferenceServer, ServerConfig)

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

B, T, V, N_LAYER, N_HEAD, D = 4, 32, 64, 2, 4, 32
ATOL = 1e-4
LOGITS = logits_name(N_LAYER)


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    """(export dir, {param name: ndarray} of the JAX scope)."""
    d = str(tmp_path_factory.mktemp("jax_transformer"))
    main, startup, _, logits = build_transformer_program(
        B, T, V, n_layer=N_LAYER, n_head=N_HEAD, d_model=D)
    assert logits.name == LOGITS
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = JScope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        jio.save_inference_model(
            d, ["tokens", "positions"], [logits], exe, main_program=main,
            bucket_hints={"batch_buckets": [1, 2, 4]})
    params = {n: np.asarray(scope.get(n)) for n in scope.local_var_names()
              if scope.get(n) is not None}
    return d, params


@pytest.fixture(scope="module")
def jax_engine(jax_export):
    # warmup stays off: the JAX side's warmup cannot run this export
    return JEngine.from_saved_model(jax_export[0],
                                    place=jfluid.CPUPlace())


@pytest.fixture(scope="module")
def port_engine(jax_export):
    return InferenceEngine.from_saved_model(jax_export[0],
                                            place=CPUPlace())


@pytest.mark.parametrize("batch,seed", [(4, 0), (1, 1), (2, 2)])
def test_logits_match_jax_engine(jax_engine, port_engine, batch, seed):
    feeds = transformer_feeds(batch, T, V, seed=seed)
    want = jax_engine.run(feeds)[0]
    got = port_engine.run(feeds)[0]
    assert got.shape == want.shape == (batch, T, V)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_batch_of_three_pads_to_bucket_four(jax_engine, port_engine):
    feeds = transformer_feeds(3, T, V, seed=3)
    timings = {}
    got = port_engine.run(feeds, timings=timings)[0]
    assert timings["bucket"] == 4
    assert got.shape == (3, T, V)
    np.testing.assert_allclose(got, jax_engine.run(feeds)[0], atol=ATOL,
                               rtol=0)
    padded, true_batch, bucket = port_engine.pad_feeds(feeds)
    assert (true_batch, bucket) == (3, 4)
    assert padded["tokens"].shape == (4, T)
    assert padded["tokens"].dtype == np.int32
    assert not padded["tokens"][3].any()


def test_params_from_numpy_of_jax_scope(jax_export, jax_engine):
    d, params = jax_export
    with open(d + "/__model__") as f:
        program = ProgramDesc.from_dict(json.load(f)["program"])
    scope = Scope()
    io.params_from_numpy(scope, params, "cpu")
    feeds = transformer_feeds(B, T, V, seed=4)
    got = Executor(CPUPlace()).run(program, feed=feeds,
                                   fetch_list=[LOGITS], scope=scope)[0]
    np.testing.assert_allclose(got, jax_engine.run(feeds)[0], atol=ATOL,
                               rtol=0)
    # the port-built desc runs the JAX parameters to the same logits
    ported = build_transformer_inference_program(
        B, T, V, n_layer=N_LAYER, n_head=N_HEAD, d_model=D)
    again = Executor(CPUPlace()).run(ported, feed=feeds,
                                     fetch_list=[LOGITS], scope=scope)[0]
    np.testing.assert_array_equal(again, got)


def test_port_warmup_runs_every_bucket(jax_export):
    engine = InferenceEngine.from_saved_model(jax_export[0],
                                              place=CPUPlace())
    assert engine.config.batch_buckets == (1, 2, 4)
    assert engine.warmup() == 3
    assert engine.last_warmup_stats["buckets"] == 3
    assert engine._seen_buckets == {1, 2, 4}


@pytest.mark.parametrize("shape,batch,want", [
    ([4, 32], 2, (2, 32)),     # batch-major, append_batch_size=False
    ([-1, 13], 8, (8, 13)),    # append_batch_size=True
    ([-1], 3, (3,))])
def test_synthetic_feed_shapes(shape, batch, want):
    meta = {"shape": shape, "dtype": np.dtype(np.int32), "lod_level": 0}
    assert InferenceEngine._synthetic_feed(meta, batch).shape == want


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_server_answers_with_jax_logits(jax_export, jax_engine):
    engine = InferenceEngine.from_saved_model(jax_export[0],
                                              place=CPUPlace())
    server = InferenceServer(engine, ServerConfig(port=0, max_wait_ms=1.0))
    server.start()
    try:
        host, port = server.address
        base = "http://%s:%d" % (host, port)
        feeds = transformer_feeds(2, T, V, seed=5)
        status, body = _post(base + "/v1/infer", {"inputs": {
            n: v.tolist() for n, v in feeds.items()}})
        assert status == 200 and body["batch"] == 2
        got = np.asarray(body["outputs"][LOGITS], np.float32)
        np.testing.assert_allclose(got, jax_engine.run(feeds)[0],
                                   atol=ATOL, rtol=0)

        status, body = _post(base + "/v1/infer", {"inputs": {
            "tokens": [[0] * (T + 1)], "positions": [[0] * (T + 1)]}})
        assert status == 400 and "per-sample shape" in body["error"]

        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok"
        assert health["responses_total"] == 1
        assert health["compile_cache_miss_total"] == 0  # warmed
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            text = r.read().decode()
        assert "serving_requests_total 1" in text
        assert 'serving_batch_rows_bucket{le="2"} 1' in text
    finally:
        server.shutdown()
    status, body = server.handle_infer({"inputs": {}})
    assert status == 503


def test_micro_batcher_merges_concurrent_requests(jax_export):
    import threading

    engine = InferenceEngine.from_saved_model(jax_export[0],
                                              place=CPUPlace())

    server = InferenceServer(engine, ServerConfig(
        port=0, max_batch=4, max_wait_ms=2000.0, warmup=False))
    server.batcher.start()
    feeds = transformer_feeds(3, T, V, seed=6)
    results = [None] * 3

    def call(i):
        results[i] = server.handle_infer({"inputs": {
            n: v[i:i + 1].tolist() for n, v in feeds.items()}})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    server.shutdown()
    assert all(r is not None and r[0] == 200 for r in results)
    assert server.metrics.batch_rows.count >= 1
    assert server.metrics.batch_rows.sum == 3
    whole = engine.run(feeds)[0]
    for i, (_, body) in enumerate(results):
        np.testing.assert_allclose(
            np.asarray(body["outputs"][LOGITS], np.float32)[0], whole[i],
            atol=ATOL, rtol=0)


def test_port_export_loads_in_jax(tmp_path):
    prog = build_transformer_inference_program(
        B, T, V, n_layer=N_LAYER, n_head=N_HEAD, d_model=D)
    params = init_transformer_params(prog, seed=7)
    scope = Scope()
    io.params_from_numpy(scope, params, "cpu")
    io.save_inference_model(str(tmp_path), ["tokens", "positions"],
                            [LOGITS], scope, prog,
                            bucket_hints={"batch_buckets": [4]})
    with open(str(tmp_path / "__model__")) as f:
        meta = json.load(f)
    assert meta["feed_meta"]["tokens"] == {
        "shape": [B, T], "dtype": "int32", "lod_level": 0}
    feeds = transformer_feeds(B, T, V, seed=8)
    want = JEngine.from_saved_model(str(tmp_path),
                                    place=jfluid.CPUPlace()).run(feeds)[0]
    got = InferenceEngine.from_saved_model(
        str(tmp_path), place=CPUPlace(),
        config=EngineConfig(batch_buckets=None)).run(feeds)[0]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_int64_ids_beyond_int32_raise(port_engine):
    feeds = transformer_feeds(1, T, V)
    feeds["tokens"][0, 0] = 2 ** 31
    with pytest.raises(OverflowError):
        Executor(CPUPlace()).run(port_engine.program, feed=feeds,
                                 fetch_list=[LOGITS],
                                 scope=port_engine.scope)


def test_sequence_parallel_export_serves_as_in_jax(tmp_path):
    # a transformer built with sp_axis="sp" carries that axis on every
    # flash_attention op; with no device mesh both packages serve it with
    # the local kernel
    main, startup, _, logits = build_transformer_program(
        2, T, V, n_layer=N_LAYER, n_head=N_HEAD, d_model=D, sp_axis="sp")
    ops = [op for op in main.global_block().ops
           if op.type == "flash_attention"]
    assert ops and all(op.attr("sequence_parallel_axis") == "sp"
                       for op in ops)
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(JScope()):
        exe.run(startup)
        jio.save_inference_model(str(tmp_path), ["tokens", "positions"],
                                 [logits], exe, main_program=main)
    feeds = transformer_feeds(2, T, V, seed=9)
    want = JEngine.from_saved_model(str(tmp_path),
                                    place=jfluid.CPUPlace()).run(feeds)[0]
    engine = InferenceEngine.from_saved_model(str(tmp_path),
                                              place=CPUPlace())
    served = [op for op in engine.program.block(0).ops
              if op.type == "flash_attention"]
    assert len(served) == N_LAYER and all(
        op.attr("sequence_parallel_axis") == "sp" for op in served)
    got = engine.run(feeds)[0]
    assert got.shape == want.shape == (2, T, V)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# -- request tracing, the tail, the access log, SLO and /metrics ---------------

TRACEPARENT = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"


def _http(method, url, payload=None, headers=None):
    """(status, body, headers) of one request; JSON bodies decoded."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            status, raw, hdrs = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as err:
        status, raw, hdrs = err.code, err.read(), err.headers
    text = raw.decode()
    body = json.loads(text) if hdrs.get_content_type() == \
        "application/json" else text
    return status, body, hdrs


def _families(text):
    """{family: sorted label names} of a Prometheus text exposition."""
    import re

    fams = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            fams.setdefault(line.split()[2], set())
        elif line and not line.startswith("#"):
            m = re.match(r"([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})?", line)
            name = m.group(1)
            fam = next((f for f in fams if name == f or name.startswith(
                f + "_")), name)
            labels = {kv.split("=")[0] for kv in
                      (m.group(3) or "").split(",") if kv}
            fams.setdefault(fam, set()).update(labels - {"le"})
    return {k: sorted(v) for k, v in fams.items()}


def _serve_both(jax_export, tmp_path, feeds):
    """The JAX and port servers (warmup off: ROADMAP C2) with the same
    observability config, each answering `feeds` one row per request:
    ({family: labels} of each /metrics, each /healthz body)."""
    from paddle_tpu.serving import InferenceServer as JServer
    from paddle_tpu.serving import ServerConfig as JConfig
    from paddle_tpu.serving import EngineConfig as JEngineConfig
    from paddle_tpu_torch.obs import registry as t_registry

    t_registry.reset_registry()
    kw = dict(port=0, max_wait_ms=1.0, warmup=False, slo_ms=500.0,
              tail_slow_ms=1e6)
    servers = [
        JServer(JEngine.from_saved_model(
            jax_export[0], place=jfluid.CPUPlace(),
            config=JEngineConfig(batch_buckets=[1, 2, 4],
                                 check_numerics=True)),
            JConfig(access_log=str(tmp_path / "jax.jsonl"), **kw)),
        InferenceServer(InferenceEngine.from_saved_model(
            jax_export[0], place=CPUPlace(),
            config=EngineConfig(batch_buckets=[1, 2, 4],
                                check_numerics=True)),
            ServerConfig(access_log=str(tmp_path / "port.jsonl"), **kw))]
    metrics, health = [], []
    for server in servers:
        server.start()
        try:
            base = "http://%s:%d" % server.address
            for i in range(feeds["tokens"].shape[0]):
                status, _, _ = _http("POST", base + "/v1/infer", {
                    "inputs": {n: v[i:i + 1].tolist()
                               for n, v in feeds.items()}},
                    {"traceparent": TRACEPARENT,
                     "Content-Type": "application/json"})
                assert status == 200
            metrics.append(_families(_http("GET", base + "/metrics")[1]))
            health.append(_http("GET", base + "/healthz")[1])
        finally:
            server.shutdown()
    return metrics, health


def test_metrics_families_labels_and_healthz_match_jax(jax_export,
                                                        tmp_path):
    (jfam, tfam), (jhealth, thealth) = _serve_both(
        jax_export, tmp_path, transformer_feeds(2, T, V, seed=10))
    serving = {f for f in jfam if f.startswith("serving_")}
    assert serving and {f for f in tfam if f.startswith("serving_")} \
        == serving
    for fam in serving | {"slo_burn_rate", "numerics_nonfinite_total",
                          "profiler_event_seconds_total",
                          "profiler_event_calls_total"}:
        assert tfam[fam] == jfam[fam], fam
    assert tfam["slo_burn_rate"] == ["model"]
    assert tfam["numerics_nonfinite_total"] == ["tensor"]
    # the JAX server's /healthz keys, but its jit-trace count (the port
    # compiles nothing) and the memory section (ROADMAP A2)
    assert set(thealth) == set(jhealth) - {"jit_traces_total", "memory"}
    assert thealth["slo"] == jhealth["slo"]
    assert thealth["numerics_nonfinite_total"] == \
        jhealth["numerics_nonfinite_total"] == 0
    assert thealth["responses_total"] == jhealth["responses_total"] == 2
    jlog = [json.loads(line) for line in open(str(tmp_path / "jax.jsonl"))]
    tlog = [json.loads(line) for line in open(str(tmp_path / "port.jsonl"))]
    assert [sorted(r) for r in tlog] == [sorted(r) for r in jlog]
    assert [(r["status"], r["batch"], r["bucket"], r["trace_id"])
            for r in tlog] == [(r["status"], r["batch"], r["bucket"],
                                r["trace_id"]) for r in jlog]


def test_server_tracing_tail_and_access_log(jax_export, tmp_path):
    from paddle_tpu.tools import obs_dump

    log = str(tmp_path / "access.jsonl")
    engine = InferenceEngine.from_saved_model(jax_export[0],
                                              place=CPUPlace())
    server = InferenceServer(engine, ServerConfig(
        port=0, max_wait_ms=1.0, tail_slow_ms=150.0, access_log=log))
    real_run = engine.run

    def slow_once(feeds, timings=None):
        import time as _time

        if feeds["tokens"][0, 0] == 7:
            _time.sleep(0.2)
        return real_run(feeds, timings=timings)

    engine.run = slow_once
    server.start()
    base = "http://%s:%d" % server.address
    feeds = transformer_feeds(1, T, V, seed=11)
    slow = {n: v.copy() for n, v in feeds.items()}
    slow["tokens"][0, 0] = 7
    try:
        st, body, hdrs = _http("POST", base + "/v1/infer", {"inputs": {
            n: v.tolist() for n, v in feeds.items()}},
            {"traceparent": TRACEPARENT})
        assert st == 200 and body["request_id"]
        assert hdrs["traceparent"].split("-")[1] == TRACEPARENT.split("-")[1]
        assert hdrs["x-request-id"] == body["request_id"]
        st, slow_body, _ = _http("POST", base + "/v1/infer", {
            "inputs": {n: v.tolist() for n, v in slow.items()}})
        assert st == 200
        st, body400, hdrs400 = _http("POST", base + "/v1/infer",
                                     {"inputs": {}})
        assert st == 400 and body400["request_id"] \
            and hdrs400["x-request-id"] == body400["request_id"]
        st, tail, _ = _http("GET", base + "/debug/tail")
        doc = obs_dump.validate_tail_dump(tail)
        assert st == 200 and [r["request_id"] for r in doc["requests"]] \
            == [slow_body["request_id"]]
        names = set()

        def walk(nodes):
            for n in nodes:
                names.add(n["name"])
                walk(n["children"])

        walk(doc["requests"][0]["spans"])
        assert {"serving/request", "serving/admission",
                "serving/queue_wait", "serving/batch_assemble",
                "serving/pad_bucket", "serving/device_execute",
                "serving/split_serialize", "serving/serialize"} <= names
        server.draining = True
        st, body503, _ = _http("POST", base + "/v1/infer", {"inputs": {
            n: v.tolist() for n, v in feeds.items()}})
        server.draining = False
        assert st == 503 and body503["request_id"]
        assert len(server.tail.records()) == 1
        om = _http("GET", base + "/metrics",
                   headers={"Accept": "application/openmetrics-text"})[1]
        assert om.endswith("# EOF\n")
        assert any("serving_total_seconds_bucket" in line and " # " in line
                   for line in om.splitlines())
    finally:
        server.shutdown()
    lines = [json.loads(line) for line in open(log)]
    assert [r["status"] for r in lines] == [200, 200, 400, 503]
    assert lines[0]["trace_id"] == TRACEPARENT.split("-")[1]
    assert lines[1]["request_id"] == slow_body["request_id"]
    assert lines[1]["latency_ms"] >= 150.0 > lines[0]["latency_ms"]
    assert lines[0]["bucket"] == 1 and lines[0]["batch"] == 1


def test_429_carries_retry_after_and_skips_the_tail(jax_export):
    from paddle_tpu_torch.serving import QueueFullError

    engine = InferenceEngine.from_saved_model(jax_export[0],
                                              place=CPUPlace())
    server = InferenceServer(engine, ServerConfig(
        port=0, warmup=False, retry_after_s=2, tail_slow_ms=0.0))
    server.start()

    def full(*a, **kw):
        raise QueueFullError("admission queue full (64 waiting)")

    server.batcher.submit_and_wait = full
    try:
        st, body, hdrs = _http("POST", "http://%s:%d/v1/infer"
                               % server.address, {"inputs": {
                                   n: v.tolist() for n, v in
                                   transformer_feeds(1, T, V).items()}})
    finally:
        server.shutdown()
    assert st == 429 and body["request_id"]
    assert hdrs["Retry-After"] == "2"
    assert server.tail.records() == []


def test_engine_check_numerics_counts_nonfinite_outputs(jax_export):
    from paddle_tpu_torch.obs import registry as t_registry

    t_registry.reset_registry()
    engine = InferenceEngine.from_saved_model(
        jax_export[0], place=CPUPlace(),
        config=EngineConfig(batch_buckets=[2], check_numerics=True))
    feeds = transformer_feeds(2, T, V, seed=12)
    engine.run(feeds)
    fam = t_registry.get_registry().counter("numerics_nonfinite_total",
                                            labelnames=("tensor",))
    assert [s["value"] for s in fam.samples()] == [0]
    engine.scope.get("embedding_0.w_0")[feeds["tokens"][0, 0]] = \
        float("nan")
    engine.run(feeds)
    assert sum(s["value"] for s in fam.samples()) > 0
