"""The CTR DeepFM model (`examples/ctr_deepfm_sparse.py`, BASELINE.json's
CTR workload) in the port against the JAX package, on the CPU, at
`tests/test_ctr_deepfm.py`'s size: 120 features, 4 fields, embedding 8,
hidden (32, 16), `is_sparse=True`.

- Descs: main and startup programs equal the JAX package's through
  `to_dict()` under each of the nine optimizers, with exactly two
  SELECTED_ROWS grads (the two embedding tables).
- Training: 3 Adam and 3 Adagrad steps at batch 64 from the JAX
  package's startup state moved into the port: each loss at atol 1e-5
  and every parameter and optimizer state after them at atol 1e-5
  times the larger of 1 and its largest magnitude (the same f32
  arithmetic, the scatter-adds of repeated ids summed in other orders).
- The JAX test's own criterion: 60 Adam steps on one batch of 256 take
  the loss below 0.7 of the first.
- A table looked up twice with `is_sparse=True`: its two SelectedRows
  grads meet in a `sum` typed SELECTED_ROWS, and 3 SGD and 3 Adagrad
  steps match JAX's at the tolerance above.
- The inference export of `predict` from the `ids` feed, saved by
  either package and run by the other (atol 1e-6), and served by the
  port's engine, MicroBatcher and InferenceServer on requests of 1, 5
  and 32 rows (each answer within 1e-6 of the row's answer alone).
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.core import scope as jscope_mod
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.fluid import io as jio
from paddle_tpu.models.ctr import deepfm_ctr as j_model
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.types import VarType
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.models.ctr import deepfm_ctr as t_model
from paddle_tpu_torch.serving import (BatcherConfig, InferenceEngine,
                                      InferenceServer, MicroBatcher,
                                      ServerConfig)

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
NUM_FEATURES = 120
NUM_FIELDS = 4
STEPS = 3
ATOL = 1e-5
SERVE_ATOL = 1e-6

OPTIMIZERS = {
    "SGD": {"learning_rate": 0.05},
    "Momentum": {"learning_rate": 0.05, "momentum": 0.9},
    "Adagrad": {"learning_rate": 0.05},
    "Adam": {"learning_rate": 1e-2},
    "Adamax": {"learning_rate": 1e-2},
    "DecayedAdagrad": {"learning_rate": 0.05},
    "Adadelta": {},
    "RMSProp": {"learning_rate": 1e-2},
    "Ftrl": {"learning_rate": 0.05, "l1": 0.01},
}


def _make_ctr_data(n=256, seed=0):
    """`tests/test_ctr_deepfm.py`'s synthetic batch: ids per field from
    the field's slice of the feature space, clicks from a linear and a
    pairwise signal."""
    rs = np.random.RandomState(seed)
    per_field = NUM_FEATURES // NUM_FIELDS
    ids = np.stack([rs.randint(f * per_field, (f + 1) * per_field, size=n)
                    for f in range(NUM_FIELDS)], axis=1).astype(np.int64)
    w = rs.randn(NUM_FEATURES) * 0.7
    latent = rs.randn(NUM_FEATURES, 3)
    logit = w[ids].sum(axis=1)
    logit += np.einsum("nd,nd->n", latent[ids[:, 0]], latent[ids[:, 1]])
    label = (rs.rand(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    return ids, label.reshape(-1, 1)


def _build(fluid, model, opt="Adam"):
    """(main, startup, loss, predict, params_grads) of the JAX test's
    DeepFM under optimizer `opt`."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[NUM_FIELDS],
                                dtype="int64")
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        loss, predict = model(ids, label, NUM_FEATURES, NUM_FIELDS,
                              embed_dim=8, hidden_sizes=(32, 16))
        _, params_grads = getattr(fluid.optimizer, opt)(
            **OPTIMIZERS[opt]).minimize(loss)
    return main, startup, loss, predict, params_grads


def test_chip_smoke_keeps_the_examples_reader_and_program():
    """chip_smoke.py's phase 10 drives a copy of the example's reader
    (it imports nothing of the JAX package's tree): its batches equal
    `examples/ctr_deepfm_sparse.py`'s, and its program at the example's
    width equals the JAX package's."""
    import importlib.util
    import os

    import chip_smoke

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "ctr_example", os.path.join(root, "examples",
                                    "ctr_deepfm_sparse.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    assert (example.NUM_FEATURES, example.NUM_FIELDS, example.BATCH,
            example.STEPS) == (chip_smoke.CTR_FEATURES,
                               chip_smoke.CTR_FIELDS, chip_smoke.CTR_BATCH,
                               chip_smoke.CTR_STEPS)
    ours, theirs = chip_smoke.ctr_reader(chip_smoke.CTR_FEATURES), \
        example.synthetic_ctr_reader()
    for _ in range(2):
        for a, b in zip(next(ours), next(theirs)):
            np.testing.assert_array_equal(a, b)
    tmain = chip_smoke.build_ctr(chip_smoke.CTR_FEATURES)[0]
    jmain, jstartup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(jmain, jstartup):
        ids = jfluid.layers.data(name="ids", shape=[example.NUM_FIELDS],
                                 dtype="int64")
        label = jfluid.layers.data(name="label", shape=[1], dtype="float32")
        loss, _ = j_model(ids, label, example.NUM_FEATURES,
                          example.NUM_FIELDS, embed_dim=16,
                          hidden_sizes=(128, 64))
        jfluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_deepfm_descs_equal_jax(opt):
    jmain, jstartup, _, _, jpg = _build(jfluid, j_model, opt)
    tmain, tstartup, _, _, tpg = _build(tfluid, t_model, opt)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    assert tstartup.desc.to_dict() == jstartup.desc.to_dict()
    sparse = [g.name for _, g in tpg if g.type == VarType.SELECTED_ROWS]
    assert sparse == [g.name for _, g in jpg
                      if g.type == VarType.SELECTED_ROWS]
    assert sparse == ["embedding_0.w_0@GRAD", "embedding_1.w_0@GRAD"]
    ops = [op for op in tmain.desc.block(0).ops
           if op.type == "lookup_table_grad"]
    assert [op.attrs["is_sparse"] for op in ops] == [True, True]


def _train_both(build, feeds):
    """Run `feeds` through the JAX package's program from its startup
    state, and through the port's from the same state: (jax losses, jax
    final state, port losses, port scope, initial state)."""
    jmain, jstartup, jloss = build(jfluid)
    persist = [n for n, v in jmain.desc.block(0).vars.items()
               if v.persistable]
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    with jfluid.scope_guard(scope):
        exe.run(jstartup)
        init = {n: np.array(scope.get(n)) for n in persist}
        jlosses = [float(np.asarray(exe.run(jmain, feed=f,
                                            fetch_list=[jloss])[0])
                         .reshape(-1)[0]) for f in feeds]
        jfinal = {n: np.array(scope.get(n)) for n in persist}
    tmain, _, tloss = build(tfluid)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    texe, tscope = tfluid.Executor(CPU), tfluid.Scope()
    tio.params_from_numpy(tscope, {n: a.copy() for n, a in init.items()},
                          "cpu")
    tlosses = [float(texe.run(tmain, feed=f, fetch_list=[tloss],
                              scope=tscope)[0].reshape(-1)[0])
               for f in feeds]
    return jlosses, jfinal, tlosses, tscope, init


def _assert_state_matches(jfinal, tscope, init):
    moved = 0
    for n, want in jfinal.items():
        got = tscope.get(n).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, n
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=ATOL * max(1.0, float(np.abs(want).max())), err_msg=n)
        moved += not np.array_equal(want, init[n])
    return moved


@pytest.mark.parametrize("opt", ["Adam", "Adagrad"])
def test_three_steps_match_jax(opt):
    ids, label = _make_ctr_data(n=64 * STEPS, seed=1)
    feeds = [{"ids": ids[k::STEPS], "label": label[k::STEPS]}
             for k in range(STEPS)]

    def build(fluid):
        main, startup, loss, _, _ = _build(
            fluid, j_model if fluid is jfluid else t_model, opt)
        return main, startup, loss

    jlosses, jfinal, tlosses, tscope, init = _train_both(build, feeds)
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=ATOL)
    state = "_moment1_0" if opt == "Adam" else "_moment_0"
    assert "embedding_0.w_0" + state in jfinal
    # every one of the 8 parameters and its moments moved (and Adam's 2
    # beta powers), and the port moved them alike
    moved = 8 * 3 + 2 if opt == "Adam" else 8 * 2
    assert _assert_state_matches(jfinal, tscope, init) == moved


def test_deepfm_local_convergence():
    """`tests/test_ctr_deepfm.py::test_deepfm_local_convergence` on the
    port: 60 Adam steps at lr 1e-2 on one batch of 256."""
    main, startup, loss, _, _ = _build(tfluid, t_model)
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    block = main.global_block()
    feeder = tfluid.DataFeeder(place=CPU, feed_list=[block.var("ids"),
                                                     block.var("label")])
    ids, label = _make_ctr_data()
    feed = feeder.feed([(ids[i], label[i]) for i in range(len(ids))])
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0].reshape(-1)[0])
              for _ in range(60)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])


def _twice_looked_up(fluid, opt):
    """One table looked up by two id feeds (its grads meet in a `sum`):
    (main, startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        a = fluid.layers.data(name="a", shape=[3], dtype="int64")
        b = fluid.layers.data(name="b", shape=[2], dtype="int64")
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        attr = fluid.ParamAttr(name="shared_emb")
        ea = fluid.layers.embedding(input=a, size=[NUM_FEATURES, 8],
                                    is_sparse=True, param_attr=attr)
        eb = fluid.layers.embedding(input=b, size=[NUM_FEATURES, 8],
                                    is_sparse=True, param_attr=attr)
        pooled = fluid.layers.elementwise_add(
            x=fluid.layers.reduce_sum(ea, dim=1),
            y=fluid.layers.reduce_sum(eb, dim=1))
        logit = fluid.layers.fc(input=pooled, size=1)
        loss = fluid.layers.mean(
            x=fluid.layers.sigmoid_cross_entropy_with_logits(x=logit,
                                                             label=label))
        getattr(fluid.optimizer, opt)(**OPTIMIZERS[opt]).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("opt", ["SGD", "Adagrad"])
def test_table_looked_up_twice_trains_through_sparse_sum(opt):
    tmain = _twice_looked_up(tfluid, opt)[0]
    block = tmain.desc.block(0)
    sums = [op for op in block.ops if op.type == "sum"]
    assert len(sums) == 1
    assert sums[0].output("Out") == ["shared_emb@GRAD"]
    for n in sums[0].input("X") + sums[0].output("Out"):
        assert block.vars[n].type == VarType.SELECTED_ROWS, n
    rs = np.random.RandomState(2)
    feeds = [{"a": rs.randint(0, NUM_FEATURES, size=(32, 3)),
              "b": rs.randint(0, 8, size=(32, 2)),   # repeats ids often
              "label": (rs.rand(32, 1) < 0.5).astype(np.float32)}
             for _ in range(STEPS)]
    jlosses, jfinal, tlosses, tscope, init = _train_both(
        lambda fluid: _twice_looked_up(fluid, opt), feeds)
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=ATOL)
    assert _assert_state_matches(jfinal, tscope, init) >= 1


# -- the inference export -----------------------------------------------------

def _export(fluid, model_dir):
    """Train 3 Adam steps in `fluid`'s package and export `predict` from
    the `ids` feed; its probabilities on a batch of 7."""
    model = j_model if fluid is jfluid else t_model
    main, startup, loss, predict, _ = _build(fluid, model)
    ids, label = _make_ctr_data(n=64, seed=3)
    probe = _make_ctr_data(n=7, seed=4)[0]
    if fluid is jfluid:
        exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
        with jfluid.scope_guard(scope):
            exe.run(startup)
            for _ in range(STEPS):
                exe.run(main, feed={"ids": ids, "label": label},
                        fetch_list=[loss])
            infer = jio.save_inference_model(model_dir, ["ids"], [predict],
                                             exe, main)
            out, = exe.run(infer, feed={"ids": probe},
                           fetch_list=[predict])
        return np.asarray(out), probe
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(STEPS):
        exe.run(main, feed={"ids": ids, "label": label}, fetch_list=[loss],
                scope=scope)
    with tfluid.scope_guard(scope):
        infer = tio.save_inference_model(model_dir, ["ids"], [predict], exe,
                                         main)
    out, = exe.run(infer, feed={"ids": probe}, fetch_list=[predict],
                   scope=scope)
    return out, probe


def _port_load_and_run(model_dir, probe):
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    with tfluid.scope_guard(scope):
        desc, feed_names, fetch_vars = tio.load_inference_model(model_dir,
                                                                exe)
    assert feed_names == ["ids"]
    types = {op.type for op in desc.block(0).ops}
    assert "lookup_table" in types and "sigmoid" in types
    assert not types & {"adam", "lookup_table_grad",
                        "sigmoid_cross_entropy_with_logits"}
    return exe.run(desc, feed={"ids": probe}, fetch_list=fetch_vars,
                   scope=scope)[0]


def _jax_load_and_run(model_dir, probe):
    jscope_mod.reset_global_scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    prog, feed_names, fetch_vars = jio.load_inference_model(model_dir, exe)
    assert feed_names == ["ids"]
    return np.asarray(exe.run(prog, feed={"ids": probe},
                              fetch_list=fetch_vars)[0])


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_ctr_export_crosses(saved_by, tmp_path):
    model_dir = str(tmp_path / "ctr")
    if saved_by == "jax":
        expect, probe = _export(jfluid, model_dir)
        got = _port_load_and_run(model_dir, probe)
    else:
        expect, probe = _export(tfluid, model_dir)
        got = _jax_load_and_run(model_dir, probe)
        np.testing.assert_allclose(_port_load_and_run(model_dir, probe),
                                   expect, atol=SERVE_ATOL, rtol=0)
    assert got.shape == (7, 1)
    assert ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got, expect, atol=SERVE_ATOL, rtol=0)


def test_engine_batcher_and_server_answer_id_requests(tmp_path):
    model_dir = str(tmp_path / "ctr")
    _export(tfluid, model_dir)
    engine = InferenceEngine.from_saved_model(model_dir, place=CPU)
    ids = _make_ctr_data(n=38, seed=5)[0]
    alone = np.concatenate([engine.run({"ids": ids[i:i + 1]})[0]
                            for i in range(len(ids))])
    assert alone.shape == (38, 1)
    parts = [(0, 1), (1, 6), (6, 38)]   # requests of 1, 5 and 32 rows

    batcher = MicroBatcher(engine, BatcherConfig(max_batch=64,
                                                 max_wait_ms=200)).start()
    try:
        futures = [batcher.submit({"ids": ids[lo:hi]}) for lo, hi in parts]
        outs = [f.result(timeout=60)[0] for f in futures]
    finally:
        batcher.close()
    for got, (lo, hi) in zip(outs, parts):
        np.testing.assert_allclose(got, alone[lo:hi], atol=SERVE_ATOL,
                                   rtol=0)

    server = InferenceServer(engine, ServerConfig(port=0, max_wait_ms=100))
    server.start()
    host, port = server.address
    url = "http://%s:%d/v1/infer" % (host, port)
    results = [None] * len(parts)

    def post(i):
        lo, hi = parts[i]
        body = json.dumps({"inputs": {"ids": ids[lo:hi].tolist()}})
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
                                   alone[lo:hi], atol=SERVE_ATOL, rtol=0)
