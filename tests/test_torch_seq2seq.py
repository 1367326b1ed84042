"""The seq2seq translation model (`models/text.py` `seq2seq`, the
machine-translation book loop of `tests/test_machine_translation.py`)
in the port against the JAX package, on the CPU.

- Descs: the book program (dict 1,000, embedding 32, hidden 32,
  mean(cross_entropy), Adam at lr 0.02), main and startup, equal the
  JAX package's through `to_dict()`; at the model's full dictionary of
  30,000 too, with 2 blocks, 42 ops in block 0, the step block's 8 ops
  and 2,920,624 parameter values.
- Training: 3 Adam steps at dict 1,000 over the reader's first three
  batches of 8 through DataFeeder (three ragged slots), from the JAX
  package's startup state carried into the port by
  `params_from_numpy`.  The losses and both Adam moments agree at atol
  1e-5 times the larger of 1 and the largest magnitude (the same f32
  arithmetic summed in other orders).  The parameters' change over the
  3 steps agrees in relative L2 within 1e-4, and every entry within
  2e-4, a hundredth of the learning rate: Adam divides each moment by
  the root of the second, so an entry whose grads are at the f32
  rounding floor of the table's largest grad, which the two packages
  round apart, moves by a different share of lr in each.  Observed:
  3.3e-5 in relative L2 (the source embedding) and 7.7e-5 for one
  entry of the 32,000 in that table.
- The book loop through the port, from CONV_INITS initial states: 60
  full batches, every loss finite, and the comparison that tells
  learning from noise. The JAX test's own (the mean of the last 6
  losses below the mean of the first 6) compares different batches,
  and one run's outcome turns on its initial state and on the order of
  its f32 sums (the JAX package's loop fails it from 1 of 8 states, the
  port from 6 of 16; run this file as a script to print each).  Here
  the first 6 batches' loss after the steps, against the losses
  recorded on them, falls by more than CONV_FALL on average over the
  states (16 states read -0.002 to 0.310, mean 0.217, standard
  deviation 0.077: the 5-state mean varies by about 0.034).
- `dataset.wmt14`: the first 32 samples of `train(1000)` and of
  `test(1000)` equal the JAX package's.
- The inference export of `prob` from the feeds `src_word_id` and
  `target_language_word`, saved by either package: the port's
  InferenceEngine (warmup included) and InferenceServer serve it, and
  the valid rows of `prob` equal the JAX engine's at atol 1e-5; the
  JAX engine loads the port's export.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.fluid as jfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.fluid import io as jio
from paddle_tpu.models import seq2seq as j_seq2seq
from paddle_tpu.serving import InferenceEngine as JEngine
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.models import seq2seq as t_seq2seq
from paddle_tpu_torch.serving import (InferenceEngine, InferenceServer,
                                      ServerConfig)

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
DICT = 1000
FULL_DICT = 30000
BATCH = 8
STEPS = 3
LR = 0.02
ATOL = 1e-5
PARAM_RL2 = 1e-4
PARAM_ATOL = 1e-2 * LR
SERVE_ATOL = 1e-5
FEEDS = ["src_word_id", "target_language_word"]
CONV_INITS = 5
CONV_FALL = 0.1


def _build(fluid, model, dict_size):
    """The book program: (main, startup, loss, prob, feed vars)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.layers.data(name="src_word_id", shape=[1],
                                dtype="int64", lod_level=1)
        trg_in = fluid.layers.data(name="target_language_word", shape=[1],
                                   dtype="int64", lod_level=1)
        trg_next = fluid.layers.data(name="target_language_next_word",
                                     shape=[1], dtype="int64", lod_level=1)
        prob = model(src, trg_in, dict_size, dict_size, emb_dim=32,
                     hidden_dim=32)
        loss = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=prob, label=trg_next))
        fluid.optimizer.Adam(learning_rate=LR).minimize(loss)
    return main, startup, loss, prob, [src, trg_in, trg_next]


def _batches(paddle, n, dict_size=DICT):
    out = []
    for b in paddle.batch(paddle.dataset.wmt14.train(dict_size),
                          batch_size=BATCH)():
        if len(b) == BATCH:
            out.append(b)
        if len(out) == n:
            return out
    return out


@pytest.mark.parametrize("dict_size", [DICT, FULL_DICT])
def test_seq2seq_descs_equal_jax(dict_size):
    jmain, jstartup, _, _, _ = _build(jfluid, j_seq2seq, dict_size)
    tmain, tstartup, _, _, _ = _build(tfluid, t_seq2seq, dict_size)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    assert tstartup.desc.to_dict() == jstartup.desc.to_dict()
    blocks = tmain.desc.blocks
    assert len(blocks) == 2 and len(blocks[0].ops) == 42
    assert sorted(op.type for op in blocks[1].ops) == sorted(
        ["mul"] * 3 + ["elementwise_add"] * 2 + ["sum", "tanh", "softmax"])
    rec = [op for op in blocks[0].ops if op.type == "recurrent"]
    assert len(rec) == 1 and rec[0].attrs["has_mask"]
    if dict_size == FULL_DICT:
        n = sum(int(np.prod(v.shape)) for v in blocks[0].vars.values()
                if v.is_parameter)
        assert n == 2920624


def test_wmt14_reader_equals_jax():
    for split in ("train", "test"):
        want = getattr(jpaddle.dataset.wmt14, split)(DICT)()
        got = getattr(tpaddle.dataset.wmt14, split)(DICT)()
        for _ in range(32):
            assert next(got) == next(want)
    assert (tpaddle.dataset.wmt14.ID_MARK_START,
            tpaddle.dataset.wmt14.ID_MARK_END,
            tpaddle.dataset.wmt14.ID_MARK_UNK) == (0, 1, 2)


def test_three_adam_steps_match_jax():
    jmain, jstartup, jloss, _, jvars = _build(jfluid, j_seq2seq, DICT)
    tmain, _, tloss, _, tvars = _build(tfluid, t_seq2seq, DICT)
    batches = _batches(jpaddle, STEPS)
    persist = [n for n, v in jmain.desc.block(0).vars.items()
               if v.persistable]
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    with jfluid.scope_guard(scope):
        exe.run(jstartup)
        init = {n: np.array(scope.get(n)) for n in persist}
        feeder = jfluid.DataFeeder(feed_list=jvars, place=jfluid.CPUPlace())
        jlosses = [float(np.asarray(exe.run(
            jmain, feed=feeder.feed(b), fetch_list=[jloss])[0]).reshape(-1)[0])
            for b in batches]
        jfinal = {n: np.array(scope.get(n)) for n in persist}

    texe, tscope = tfluid.Executor(CPU), tfluid.Scope()
    tio.params_from_numpy(tscope, init, "cpu")
    feeder = tfluid.DataFeeder(feed_list=tvars, place=CPU)
    tlosses = [float(texe.run(tmain, feed=feeder.feed(b), fetch_list=[tloss],
                              scope=tscope)[0].reshape(-1)[0])
               for b in batches]
    np.testing.assert_allclose(tlosses, jlosses, atol=ATOL, rtol=0)
    params = {p.name for p in tmain.global_block().all_parameters()}
    assert len(params) == 11
    for n, want in jfinal.items():
        got = tscope.get(n).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, n
        if n in params:
            before = init[n].astype(np.float64)
            den = np.linalg.norm(want - before)
            assert den > 0, n
            assert np.linalg.norm(got - want) <= PARAM_RL2 * den, n
            np.testing.assert_allclose(got, want, atol=PARAM_ATOL, rtol=0,
                                       err_msg=n)
        else:
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=ATOL * max(1.0, float(np.abs(want).max())), err_msg=n)


def _book_loop(run, run_eval, batches):
    """(mean of the first 6 losses, of the last 6, the first 6 batches'
    mean loss after the steps): the book loop of `batches` through
    `run(batch) -> loss`, then `run_eval(batch) -> loss` forward only."""
    losses = [run(b) for b in batches]
    assert np.isfinite(losses).all()
    after = [run_eval(b) for b in batches[:6]]
    return np.mean(losses[:6]), np.mean(losses[-6:]), np.mean(after)


def _port_book_loop(seed, batches):
    main, startup, loss, _, fvars = _build(tfluid, t_seq2seq, DICT)
    feeder = tfluid.DataFeeder(feed_list=fvars, place=CPU)
    evaluate = tio.prune_program(main, [loss.name])
    startup.random_seed = seed
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)

    def run(program, b):
        return float(exe.run(program, feed=feeder.feed(b), fetch_list=[loss],
                             scope=scope)[0].reshape(-1)[0])

    return _book_loop(lambda b: run(main, b), lambda b: run(evaluate, b),
                      batches)


def _jax_book_loop(seed, batches):
    main, startup, loss, _, fvars = _build(jfluid, j_seq2seq, DICT)
    feeder = jfluid.DataFeeder(feed_list=fvars, place=jfluid.CPUPlace())
    evaluate = jio.prune_program(main, [loss.name])
    startup.random_seed = seed
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    with jfluid.scope_guard(scope):
        exe.run(startup)

        def run(program, b):
            return float(np.asarray(exe.run(
                program, feed=feeder.feed(b),
                fetch_list=[loss])[0]).reshape(-1)[0])

        return _book_loop(lambda b: run(main, b),
                          lambda b: run(evaluate, b), batches)


def test_book_loop_converges_through_the_port():
    """tests/test_machine_translation.py's loop, run by the port from
    CONV_INITS initial states (random_seed 0, 1, ...): every loss
    finite, and the first 6 batches' loss after the steps lower than
    recorded on them by CONV_FALL on average (see the module
    docstring)."""
    batches = _batches(tpaddle, 60)
    assert len(batches) == 60
    runs = [_port_book_loop(seed, batches) for seed in range(CONV_INITS)]
    firsts, _, afters = (np.array(r) for r in zip(*runs))
    assert np.mean(firsts - afters) > CONV_FALL, (firsts, afters)


# -- the inference export, served -------------------------------------------

def _pairs(n, seed):
    """n (src, trg_in) pairs of the test reader, as [len, 1] id arrays."""
    rows = []
    for k, (src, trg_in, _) in enumerate(
            tpaddle.dataset.wmt14.test(DICT)()):
        if k >= seed:
            rows.append((np.asarray(src, np.int64).reshape(-1, 1),
                         np.asarray(trg_in, np.int64).reshape(-1, 1)))
        if len(rows) == n:
            return rows
    return rows


def _feeds(pairs):
    return {FEEDS[0]: [p[0] for p in pairs], FEEDS[1]: [p[1] for p in pairs]}


def _export(saved_by, model_dir):
    """Train 2 steps in `saved_by`'s package and export `prob`."""
    hints = {"batch_buckets": [1, 4]}
    if saved_by == "jax":
        main, startup, loss, prob, fvars = _build(jfluid, j_seq2seq, DICT)
        exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
        with jfluid.scope_guard(scope):
            exe.run(startup)
            feeder = jfluid.DataFeeder(feed_list=fvars,
                                       place=jfluid.CPUPlace())
            for b in _batches(jpaddle, 2):
                exe.run(main, feed=feeder.feed(b), fetch_list=[loss])
            jio.save_inference_model(model_dir, FEEDS, [prob], exe, main,
                                     bucket_hints=hints)
    else:
        main, startup, loss, prob, fvars = _build(tfluid, t_seq2seq, DICT)
        exe, scope = tfluid.Executor(CPU), tfluid.Scope()
        exe.run(startup, scope=scope)
        feeder = tfluid.DataFeeder(feed_list=fvars, place=CPU)
        for b in _batches(tpaddle, 2):
            exe.run(main, feed=feeder.feed(b), fetch_list=[loss], scope=scope)
        tio.save_inference_model(model_dir, FEEDS, [prob], scope, main,
                                 bucket_hints=hints)


def _valid_rows(rt):
    """Each sequence's rows of a host ragged fetch (JAX or port)."""
    values = np.asarray(rt.values)
    splits = rt.lod()[-1]
    return [values[a:b] for a, b in zip(splits[:-1], splits[1:])]


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_export_served_by_the_port_engine(saved_by, tmp_path):
    model_dir = str(tmp_path / "s2s")
    _export(saved_by, model_dir)
    pairs = _pairs(3, seed=0)
    jengine = JEngine.from_saved_model(model_dir)
    want = _valid_rows(jengine.run(_feeds(pairs))[0])

    engine = InferenceEngine.from_saved_model(model_dir, place=CPU)
    assert engine.feed_names == FEEDS
    assert engine.config.batch_buckets == (1, 4)
    assert engine.warmup() == 2
    blocks = engine.program.blocks
    assert len(blocks) == 2
    assert "recurrent" in [op.type for op in blocks[0].ops]
    assert not any("grad" in op.type or op.type == "adam"
                   for op in blocks[0].ops)
    got = _valid_rows(engine.run(_feeds(pairs))[0])
    assert [len(g) for g in got] == [len(p[1]) for p in pairs]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=SERVE_ATOL, rtol=0)
        np.testing.assert_allclose(g.sum(1), 1.0, atol=1e-5)


def test_server_answers_sentence_pairs(tmp_path):
    model_dir = str(tmp_path / "s2s")
    _export("port", model_dir)
    pairs = _pairs(6, seed=3)
    engine = InferenceEngine.from_saved_model(model_dir, place=CPU)
    alone = [_valid_rows(engine.run(_feeds([p]))[0])[0] for p in pairs]
    server = InferenceServer(engine, ServerConfig(port=0, max_batch=8,
                                                  max_wait_ms=100))
    server.start()
    host, port = server.address
    url = "http://%s:%d/v1/infer" % (host, port)
    parts = [(0, 1), (1, 3), (3, 6)]
    results = [None] * len(parts)

    def post(i):
        lo, hi = parts[i]
        body = json.dumps({"inputs": {
            FEEDS[0]: [p[0].tolist() for p in pairs[lo:hi]],
            FEEDS[1]: [p[1].tolist() for p in pairs[lo:hi]]}})
        req = urllib.request.Request(url, body.encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            results[i] = json.loads(r.read())

    try:
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(parts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.shutdown()
    fetch = engine.fetch_names[0]
    for res, (lo, hi) in zip(results, parts):
        assert res["batch"] == hi - lo
        seqs = res["outputs"][fetch]
        assert len(seqs) == hi - lo
        for got, want in zip(seqs, alone[lo:hi]):
            np.testing.assert_allclose(np.asarray(got, np.float32), want,
                                       atol=SERVE_ATOL, rtol=0)


if __name__ == "__main__":
    # The book loop's criterion from several initial states, in the JAX
    # package and in the port, on the CPU; from the repo's root:
    #     PYTHONPATH=. python tests/test_torch_seq2seq.py [JAX [port]]
    # (the numbers of states, 8 and 16 by default)
    import sys

    jax_states = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    port_states = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    torch.set_num_threads(2)
    batches = _batches(tpaddle, 60)
    for name, loop, n in (("JAX", _jax_book_loop, jax_states),
                          ("port", _port_book_loop, port_states)):
        falls = []
        for seed in range(n):
            first, last, after = loop(seed, batches)
            falls.append(first - after)
            print("%s random_seed %d: the JAX test's criterion %.4f -> "
                  "%.4f (%s); the first 6 batches after the steps %.4f "
                  "lower" % (name, seed, first, last, "holds" if last < first
                             else "fails", first - after), flush=True)
        print("%s: fixed-batch falls %.4f-%.4f, mean %.4f, standard "
              "deviation %.4f" % (name, min(falls), max(falls),
                                  np.mean(falls), np.std(falls)), flush=True)
