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
