"""bench.py's stacked-LSTM text classifier (`BENCH_MODEL=lstm`) in the
port against the JAX package, on the CPU, and its export served with
ragged requests.

- Descs: the program `bench.py:_build_lstm` builds (dict 10,000,
  embedding 128, hidden 256, 2 stacked layers, 2 classes, peepholes,
  mean(cross_entropy), Adam at lr 1e-3), main and startup, equal the
  JAX package's through `to_dict()`, in f32 and built under the bf16
  policy (as bench.py builds it with `BENCH_AMP=1`).  Descs only.
- Training: 3 Adam steps at a narrow width (dict 50, embedding 16,
  hidden 8) over 6 sequences of 0 to 11 words padded to a bucket of 16
  rows, from the JAX package's startup state moved into the port:
  f32, each loss at atol 1e-5 and every parameter and both Adam moments
  after them at atol 1e-5 times the larger of 1 and the largest
  magnitude (the same f32 arithmetic summed in other orders).  Under
  the bf16 policy the grads carry bf16 roundings made in other orders
  (products rounded to bf16 after f32 sums, through 2 recurrences of up
  to 11 steps): each loss at atol 2e-3 (observed 6.6e-4 at step 3), and
  each parameter's and each Adam moment's change over the steps (final
  minus initial) against the JAX package's change in relative L2:
  moments within 0.1 (observed at most 0.055), parameters within 0.3
  (observed at most 0.148, lstm_1.w_0; Adam's first steps move an entry
  by about lr times the sign of its grad, so grads near 0 that the
  roundings flip weigh more than in the moments).  A state the port
  left unchanged reads 1.0 and one stepped the wrong way about 2.0.
  The learning rate and the beta powers are exact (atol 1e-5), and
  every final dtype equals JAX's: the biases and weights declared bf16
  under the policy are promoted to f32 by their first update.
- The inference export (`tests/test_inference_sequence_roundtrip.py`'s
  model): trained, pruned and saved by either package, loaded by the
  other, and its probabilities on DataFeeder batches equal at atol 1e-5.
- Serving: `InferenceEngine`, `MicroBatcher` and `InferenceServer` on
  ragged requests of different lengths, as lists of sequences, as a
  RaggedTensor and as JSON: a merged batch gives each request what it
  gets alone (atol 1e-6: the same kernels, padded to other buckets).
"""

import contextlib
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.core import scope as jscope_mod
from paddle_tpu.core.ragged import RaggedTensor as JRagged
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.fluid import io as jio
from paddle_tpu.models.text import stacked_lstm_text_classifier as j_model
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.ragged import RaggedTensor
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.models.text import stacked_lstm_text_classifier \
    as t_model
from paddle_tpu_torch.serving import (BatcherConfig, EngineConfig,
                                      InferenceEngine, InferenceServer,
                                      MicroBatcher, ServerConfig)

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
STEPS = 3
ATOL = 1e-5
AMP_LOSS_ATOL = 2e-3
AMP_MOMENT_RL2 = 0.1
AMP_PARAM_RL2 = 0.3
ADAM_LR = 1e-3
SERVE_ATOL = 1e-6


def _guard(fluid, amp):
    return fluid.amp.bf16_guard() if amp else contextlib.nullcontext()


def _build_lstm(fluid, model, dict_dim, hidden, emb_dim=128):
    """bench.py's `_build_lstm` through `fluid`: (main, startup, loss,
    probs)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        data = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                 lod_level=1)
        probs = model(data, dict_dim, hid_dim=hidden, emb_dim=emb_dim)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=probs, label=label))
        fluid.optimizer.Adam(learning_rate=ADAM_LR).minimize(loss)
    return main, startup, loss, probs


@pytest.mark.parametrize("amp", [False, True])
def test_bench_lstm_descs_equal_jax(amp):
    with _guard(jfluid, amp):
        jmain, jstartup, _, _ = _build_lstm(jfluid, j_model, 10000, 256)
    with _guard(tfluid, amp):
        tmain, tstartup, _, _ = _build_lstm(tfluid, t_model, 10000, 256)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    assert tstartup.desc.to_dict() == jstartup.desc.to_dict()
    block = tmain.desc.block(0)
    lstm = [op for op in block.ops if op.type == "lstm"]
    assert len(lstm) == 2
    assert block.vars[lstm[0].input("Weight")[0]].shape == (256, 1024)
    assert block.vars[lstm[0].input("Bias")[0]].shape == (1, 7 * 256)
    assert block.vars[lstm[1].output("Hidden")[0]].lod_level == 1
    pooled = [op for op in block.ops if op.type == "sequence_pool"]
    assert [op.attrs["pooltype"] for op in pooled] == ["MAX", "MAX"]
    assert block.vars[pooled[0].output("Out")[0]].lod_level == 0


def _train_feeds(seed=0, n=6, dict_dim=50):
    rs = np.random.RandomState(seed)
    lengths = list(rs.randint(1, 12, size=n))
    lengths[3] = 0
    seqs = [rs.randint(0, dict_dim, size=(k, 1)).astype(np.int64)
            for k in lengths]
    label = rs.randint(0, 2, size=(n, 1)).astype(np.int64)
    return seqs, label


@pytest.mark.parametrize("amp", [False, True])
def test_three_adam_steps_match_jax(amp):
    seqs, label = _train_feeds()
    with _guard(jfluid, amp):
        jmain, jstartup, jloss, _ = _build_lstm(jfluid, j_model, 50, 8,
                                                emb_dim=16)
    persist = [n for n, v in jmain.desc.block(0).vars.items()
               if v.persistable]
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    with jfluid.scope_guard(scope), _guard(jfluid, amp):
        exe.run(jstartup)
        init = {n: np.array(scope.get(n)) for n in persist}
        jlosses = [float(exe.run(
            jmain, feed={"words": JRagged.from_sequences(seqs, bucket=16),
                         "label": label},
            fetch_list=[jloss])[0][0]) for _ in range(STEPS)]
        jfinal = {n: np.array(scope.get(n)) for n in persist}

    with _guard(tfluid, amp):
        tmain, _, tloss, _ = _build_lstm(tfluid, t_model, 50, 8,
                                         emb_dim=16)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    texe, tscope = tfluid.Executor(CPU), tfluid.Scope()
    tio.params_from_numpy(tscope, init, "cpu")
    with _guard(tfluid, amp):
        tlosses = [float(texe.run(
            tmain, feed={"words": RaggedTensor.from_sequences(seqs,
                                                              bucket=16),
                         "label": label},
            fetch_list=[tloss], scope=tscope)[0][0]) for _ in range(STEPS)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=0,
                               atol=AMP_LOSS_ATOL if amp else ATOL)
    assert any(n.endswith("_moment1_0") for n in jfinal)
    params = {p.name for p in tmain.global_block().all_parameters()}
    promoted = [n for n in params if init[n].dtype != jfinal[n].dtype]
    assert bool(promoted) == amp, promoted
    for n, want in jfinal.items():
        got_t = tscope.get(n)
        assert str(got_t.dtype) == "torch." + want.dtype.name, n
        got = got_t.float().numpy()
        want = want.astype(np.float32)
        assert got.shape == want.shape, n
        if amp and (n in params or "_moment" in n):
            before = init[n].astype(np.float64)
            num = np.linalg.norm(got.astype(np.float64) - want)
            den = np.linalg.norm(want.astype(np.float64) - before)
            assert den > 0, n
            limit = AMP_MOMENT_RL2 if "_moment" in n else AMP_PARAM_RL2
            assert num <= limit * den, (n, num / den)
        else:
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=ATOL * max(1.0, float(np.abs(want).max())), err_msg=n)


# -- the inference export, crossing both ways ---------------------------------

V, E, H = 40, 8, 8


def _seq_model(fluid):
    """`test_inference_sequence_roundtrip.py`'s model: (main, startup,
    probs, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                  lod_level=1)
        emb = fluid.layers.embedding(input=words, size=[V, E])
        lstm = fluid.layers.dynamic_lstm(
            input=fluid.layers.fc(input=emb, size=4 * H), size=4 * H)[0]
        pooled = fluid.layers.sequence_pool(input=lstm, pool_type="max")
        probs = fluid.layers.fc(input=pooled, size=2, act="softmax")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=probs, label=label))
        fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, probs, loss


def _seqs(n=5, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, V, size=(rs.randint(2, 7), 1)).astype(np.int64)
            for _ in range(n)]


def _train_rows(seqs):
    return [(s, np.asarray([i % 2], np.int64)) for i, s in enumerate(seqs)]


def _jax_export(model_dir):
    """Train 3 steps in the JAX package and export; (expected probs on
    the DataFeeder batch of `_seqs()`)."""
    main, startup, probs, loss = _seq_model(jfluid)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    words, label = main.global_block().var("words"), \
        main.global_block().var("label")
    with jfluid.scope_guard(scope):
        exe.run(startup)
        tfeed = jfluid.DataFeeder([words, label], jfluid.CPUPlace(),
                                  main).feed(_train_rows(_seqs()))
        for _ in range(STEPS):
            exe.run(main, feed=tfeed, fetch_list=[loss])
        infer = jio.save_inference_model(model_dir, ["words"], [probs], exe,
                                         main)
        feed = jfluid.DataFeeder([words], jfluid.CPUPlace(), main).feed(
            [(s,) for s in _seqs()])
        expect, = exe.run(infer, feed=feed, fetch_list=[probs])
    return np.asarray(expect)


def _port_export(model_dir):
    main, startup, probs, loss = _seq_model(tfluid)
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    words, label = main.global_block().var("words"), \
        main.global_block().var("label")
    exe.run(startup, scope=scope)
    tfeed = tfluid.DataFeeder([words, label], CPU, main).feed(
        _train_rows(_seqs()))
    for _ in range(STEPS):
        exe.run(main, feed=tfeed, fetch_list=[loss], scope=scope)
    with tfluid.scope_guard(scope):
        infer = tio.save_inference_model(model_dir, ["words"], [probs], exe,
                                         main)
    feed = tfluid.DataFeeder([words], CPU, main).feed(
        [(s,) for s in _seqs()])
    expect, = exe.run(infer, feed=feed, fetch_list=[probs], scope=scope)
    return expect


def _jax_load_and_run(model_dir):
    jscope_mod.reset_global_scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    prog, feed_names, fetch_vars = jio.load_inference_model(model_dir, exe)
    assert feed_names == ["words"]
    feed = jfluid.DataFeeder([feed_names[0]], jfluid.CPUPlace(),
                             program=prog).feed([(s,) for s in _seqs()])
    got, = exe.run(prog, feed=feed, fetch_list=fetch_vars)
    return np.asarray(got)


def _port_load_and_run(model_dir):
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    with tfluid.scope_guard(scope):
        desc, feed_names, fetch_vars = tio.load_inference_model(model_dir,
                                                                exe)
    prog = tfluid.Program.from_desc(desc)
    assert feed_names == ["words"]
    optypes = [op.type for op in prog.global_block().ops]
    assert "adam" not in optypes and "cross_entropy" not in optypes
    assert "lstm" in optypes and "sequence_pool" in optypes
    feed = tfluid.DataFeeder([feed_names[0]], CPU, program=prog).feed(
        [(s,) for s in _seqs()])
    got, = exe.run(prog, feed=feed, fetch_list=fetch_vars, scope=scope)
    return got


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_sequence_export_crosses(saved_by, tmp_path):
    model_dir = str(tmp_path / "seq_model")
    if saved_by == "jax":
        expect = _jax_export(model_dir)
        got = _port_load_and_run(model_dir)
    else:
        expect = _port_export(model_dir)
        got = _jax_load_and_run(model_dir)
        # and the port reads its own export back
        np.testing.assert_allclose(_port_load_and_run(model_dir), expect,
                                   atol=ATOL, rtol=0)
    assert got.shape == (5, 2)
    np.testing.assert_allclose(got, expect, atol=ATOL, rtol=0)


# -- serving ragged requests --------------------------------------------------

@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_engine_reads_token_bucket_hint(saved_by, tmp_path):
    """The export's bucket hints (batch buckets and the ragged token
    bucket), written by either package, configure the port's engine,
    and the port's hints configure the JAX package's."""
    from paddle_tpu.serving import InferenceEngine as JEngine

    model_dir = str(tmp_path / "m")
    hints = {"batch_buckets": [1, 4], "token_bucket": 128}
    if saved_by == "jax":
        main, startup, probs, _ = _seq_model(jfluid)
        exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
        with jfluid.scope_guard(scope):
            exe.run(startup)
            jio.save_inference_model(model_dir, ["words"], [probs], exe,
                                     main, bucket_hints=hints)
    else:
        main, startup, probs, _ = _seq_model(tfluid)
        exe, scope = tfluid.Executor(CPU), tfluid.Scope()
        exe.run(startup, scope=scope)
        tio.save_inference_model(model_dir, ["words"], [probs], scope,
                                 main, bucket_hints=hints)
        jengine = JEngine.from_saved_model(model_dir)
        assert jengine.config.token_bucket == 128
        assert tuple(jengine.config.batch_buckets) == (1, 4)
    engine = InferenceEngine.from_saved_model(model_dir, place=CPU)
    assert engine.config.token_bucket == 128
    assert engine.config.batch_buckets == (1, 4)
    padded, true_batch, bucket = engine.pad_feeds({"words": _seqs(3)})
    assert (true_batch, bucket) == (3, 4)
    assert padded["words"].values.shape[0] == 128
    assert engine.run({"words": _seqs(3)})[0].shape == (3, 2)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(export dir, per-sequence probabilities each alone) of a port
    export of the sequence model."""
    model_dir = str(tmp_path_factory.mktemp("served") / "m")
    _port_export(model_dir)
    engine = InferenceEngine.from_saved_model(model_dir, place=CPU)
    alone = [engine.run({"words": [s]})[0] for s in _seqs(8, seed=1)]
    return model_dir, alone


def test_engine_pads_ragged_batches(served):
    model_dir, alone = served
    engine = InferenceEngine.from_saved_model(
        model_dir, place=CPU, config=EngineConfig(batch_buckets=(1, 4, 16),
                                                  token_bucket=8))
    assert engine._feed_meta["words"]["lod_level"] == 1
    assert engine.warmup() == 3
    seqs = _seqs(8, seed=1)
    timings = {}
    out, = engine.run({"words": seqs}, timings=timings)
    assert timings["bucket"] == 16 and out.shape == (8, 2)
    np.testing.assert_allclose(out, np.concatenate(alone), atol=SERVE_ATOL,
                               rtol=0)
    # a RaggedTensor feed, padded to its own bucket, answers the same
    rt, = engine.run({"words": RaggedTensor.from_sequences(seqs[:3],
                                                           bucket=64)})
    np.testing.assert_allclose(rt, np.concatenate(alone[:3]),
                               atol=SERVE_ATOL, rtol=0)
    # warmup_ragged=False leaves a ragged program cold
    assert InferenceEngine.from_saved_model(
        model_dir, place=CPU,
        config=EngineConfig(warmup_ragged=False)).warmup() == 0
    # exact shapes: no bucket padding at all
    exact = InferenceEngine.from_saved_model(
        model_dir, place=CPU, config=EngineConfig(batch_buckets=None))
    np.testing.assert_allclose(exact.run({"words": seqs[:2]})[0],
                               np.concatenate(alone[:2]), atol=SERVE_ATOL,
                               rtol=0)


def test_engine_slices_ragged_fetches(served):
    """A ragged fetch (the embedding rows) comes back as a host
    RaggedTensor of the true batch's sequences."""
    model_dir, _ = served
    engine = InferenceEngine.from_saved_model(model_dir, place=CPU)
    engine.fetch_names = ["embedding_0.tmp_0"] + engine.fetch_names
    seqs = _seqs(3, seed=2)
    rows, probs = engine.run({"words": seqs})
    assert isinstance(rows, RaggedTensor) and rows.nseq() == 3
    assert rows.lod() == [np.cumsum([0] + [len(s) for s in seqs]).tolist()]
    assert rows.values.shape == (sum(len(s) for s in seqs), E)
    assert probs.shape == (3, 2)


def test_batcher_merges_ragged_requests(served):
    model_dir, alone = served
    engine = InferenceEngine.from_saved_model(model_dir, place=CPU)
    batcher = MicroBatcher(engine, BatcherConfig(max_batch=16,
                                                 max_wait_ms=200)).start()
    seqs = _seqs(8, seed=1)
    try:
        futures = [batcher.submit({"words": seqs[0:3]}),
                   batcher.submit({"words": RaggedTensor.from_sequences(
                       seqs[3:4])}),
                   batcher.submit({"words": seqs[4:8]})]
        outs = [f.result(timeout=60)[0] for f in futures]
    finally:
        batcher.close()
    for got, (lo, hi) in zip(outs, ((0, 3), (3, 4), (4, 8))):
        np.testing.assert_allclose(got, np.concatenate(alone[lo:hi]),
                                   atol=SERVE_ATOL, rtol=0)


def test_batcher_splits_ragged_fetches(served):
    model_dir, _ = served
    engine = InferenceEngine.from_saved_model(model_dir, place=CPU)
    engine.fetch_names = ["embedding_0.tmp_0"]
    batcher = MicroBatcher(engine, BatcherConfig(max_batch=16,
                                                 max_wait_ms=200)).start()
    seqs = _seqs(5, seed=3)
    try:
        futures = [batcher.submit({"words": seqs[:2]}),
                   batcher.submit({"words": seqs[2:]})]
        outs = [f.result(timeout=60)[0] for f in futures]
    finally:
        batcher.close()
    for got, part in zip(outs, (seqs[:2], seqs[2:])):
        assert isinstance(got, RaggedTensor)
        assert got.lod() == [np.cumsum([0] + [len(s) for s in part])
                             .tolist()]


def test_server_answers_ragged_json(served):
    model_dir, alone = served
    engine = InferenceEngine.from_saved_model(model_dir, place=CPU)
    server = InferenceServer(engine, ServerConfig(port=0, max_wait_ms=100))
    server.start()
    seqs = _seqs(8, seed=1)
    host, port = server.address
    url = "http://%s:%d/v1/infer" % (host, port)
    parts = [(0, 1), (1, 4), (4, 6)]
    results = [None] * len(parts)

    def post(i):
        lo, hi = parts[i]
        body = json.dumps({"inputs": {"words": [s.tolist()
                                                for s in seqs[lo:hi]]}})
        req = urllib.request.Request(url, body.encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            results[i] = json.loads(r.read())

    try:
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(parts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.shutdown()
    fetch = engine.fetch_names[0]
    for res, (lo, hi) in zip(results, parts):
        assert res["batch"] == hi - lo
        np.testing.assert_allclose(np.asarray(res["outputs"][fetch]),
                                   np.concatenate(alone[lo:hi]),
                                   atol=SERVE_ATOL, rtol=0)
