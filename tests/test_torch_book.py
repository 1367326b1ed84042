"""The Fluid book's chapters that the port runs since its sequence-op
slice, in the port against the JAX package, on the CPU: sentiment
(`conv_text_classifier`), semantic role labeling (two LSTMs, the
linear-chain CRF and Viterbi decoding), word2vec (`word2vec_ngram`),
the recommender (`cos_sim` over two towers, summed sequence pools) and
fit-a-line.

- Descs: each chapter's program, as its JAX test builds it
  (tests/test_understand_sentiment.py, test_label_semantic_roles.py,
  test_word2vec.py, test_recommender_system.py, test_fit_a_line.py),
  main and startup, equals the JAX package's through `to_dict()`; the
  sentiment model also at its own defaults (embedding 128, hidden 128).
- Training: 3 steps of each chapter's optimizer at its test's batch,
  over its dataset's first batches through each package's DataFeeder,
  from the JAX package's startup state moved into the port: each loss
  within 1e-5, and every parameter and optimizer state after them
  within 1e-5 times the larger of 1 and its largest magnitude (the same
  f32 arithmetic summed in other orders).  Under Adam (sentiment) the
  moments are held so, and the parameters' change over the steps within
  1e-4 in relative L2: Adam moves an entry by about lr times the sign
  of its grad, so an embedding grad near 0 that rounds the other way
  moves its entry by twice that.  The SRL chapter's Viterbi
  paths from the first step's state equal the JAX package's exactly.
- Datasets: the synthetic readers of imdb, conll05, imikolov, movielens
  and uci_housing give the JAX package's samples, and the dictionaries
  have the JAX package's sizes.
- Serving: the sentiment model trained 3 steps, exported and served by
  InferenceEngine on the CPU gives each ragged request the program's
  probabilities (atol 1e-6: the same kernels, padded to other buckets).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.fluid as jfluid
from paddle_tpu.core.scope import Scope as JScope
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.serving import InferenceEngine

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
STEPS = 3
ATOL = 1e-5
ADAM_PARAM_RL2 = 1e-4
SERVE_ATOL = 1e-6


def _pick_srl(sample):
    """The slim SRL model's slots: word, predicate, mark, label."""
    return sample[0], sample[6], sample[7], sample[8]


def _sentiment(fluid, paddle, models, emb=32, hid=32):
    """tests/test_understand_sentiment.py's conv program."""
    L = fluid.layers
    data = L.data(name="words", shape=[1], dtype="int64", lod_level=1)
    label = L.data(name="label", shape=[1], dtype="int64")
    prob = models.conv_text_classifier(
        data, len(paddle.dataset.imdb.word_dict()), emb_dim=emb,
        hid_dim=hid)
    loss = L.mean(x=L.cross_entropy(input=prob, label=label))
    L.accuracy(input=prob, label=label)
    fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return loss, [data, label], prob, paddle.dataset.imdb.train(), 16


def _srl(fluid, paddle, models):
    """tests/test_label_semantic_roles.py's program."""
    L = fluid.layers
    word_dict, verb_dict, label_dict = paddle.dataset.conll05.get_dict()
    word, pred, mark, target = [
        L.data(name=n, shape=[1], dtype="int64", lod_level=1)
        for n in ("word_data", "verb_data", "mark_data", "target")]
    word_emb = L.embedding(input=word, size=[len(word_dict), 16])
    pred_emb = L.embedding(input=pred, size=[len(verb_dict), 16])
    mark_emb = L.embedding(input=mark, size=[2, 16])
    hidden0 = L.fc(input=[word_emb, pred_emb, mark_emb], size=32 * 4,
                   act="tanh")
    lstm0, _ = L.dynamic_lstm(input=hidden0, size=32 * 4)
    fc1 = L.fc(input=[hidden0, lstm0], size=32 * 4, act="tanh")
    lstm1, _ = L.dynamic_lstm(input=fc1, size=32 * 4, is_reverse=True)
    feature = L.fc(input=[fc1, lstm1], size=len(label_dict), act=None)
    crf_cost = L.linear_chain_crf(input=feature, label=target,
                                  param_attr=fluid.ParamAttr(name="crfw"))
    loss = L.mean(x=crf_cost)
    fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    path = L.crf_decoding(input=feature,
                          param_attr=fluid.ParamAttr(name="crfw"))
    reader = paddle.reader.map_readers(_pick_srl,
                                       paddle.dataset.conll05.test())
    return loss, [word, pred, mark, target], path, reader, 8


def _word2vec(fluid, paddle, models):
    """tests/test_word2vec.py's program."""
    L = fluid.layers
    word_dict = paddle.dataset.imikolov.build_dict()
    words = [L.data(name=n, shape=[1], dtype="int64")
             for n in ("firstw", "secondw", "thirdw", "forthw", "nextw")]
    predict = models.word2vec_ngram(words[:4], len(word_dict), emb_dim=32,
                                    hidden_size=256)
    loss = L.mean(x=L.cross_entropy(input=predict, label=words[4]))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss, words, predict, paddle.dataset.imikolov.train(word_dict), \
        64


def _recommender(fluid, paddle, models):
    """tests/test_recommender_system.py's program."""
    L = fluid.layers
    ml = paddle.dataset.movielens
    uid = L.data(name="user_id", shape=[1], dtype="int64")
    usr_fc = L.fc(input=L.embedding(input=uid, size=[ml.max_user_id() + 1,
                                                      32],
                                    param_attr="user_table"), size=32)
    gender = L.data(name="gender_id", shape=[1], dtype="int64")
    gender_fc = L.fc(input=L.embedding(input=gender, size=[2, 16],
                                       param_attr="gender_table"), size=16)
    age = L.data(name="age_id", shape=[1], dtype="int64")
    age_fc = L.fc(input=L.embedding(input=age, size=[len(ml.age_table), 16],
                                    param_attr="age_table"), size=16)
    job = L.data(name="job_id", shape=[1], dtype="int64")
    job_fc = L.fc(input=L.embedding(input=job, size=[ml.max_job_id() + 1,
                                                      16],
                                    param_attr="job_table"), size=16)
    usr = L.fc(input=[usr_fc, gender_fc, age_fc, job_fc], size=200,
               act="tanh")
    mid = L.data(name="movie_id", shape=[1], dtype="int64")
    mov_fc = L.fc(input=L.embedding(input=mid, size=[ml.max_movie_id() + 1,
                                                      32],
                                    param_attr="movie_table"), size=32)
    cat = L.data(name="category_id", shape=[1], dtype="int64", lod_level=1)
    cat_pool = L.sequence_pool(input=L.embedding(
        input=cat, size=[len(ml.movie_categories()), 32]), pool_type="sum")
    title = L.data(name="movie_title", shape=[1], dtype="int64",
                   lod_level=1)
    title_pool = L.sequence_pool(input=L.embedding(input=title,
                                                   size=[5000, 32]),
                                 pool_type="sum")
    mov = L.fc(input=[mov_fc, cat_pool, title_pool], size=200, act="tanh")
    scale_infer = L.scale(x=L.cos_sim(X=usr, Y=mov), scale=5.0)
    label = L.data(name="score", shape=[1], dtype="float32")
    loss = L.mean(x=L.square_error_cost(input=scale_infer, label=label))
    fluid.optimizer.SGD(learning_rate=0.2).minimize(loss)
    return loss, [uid, gender, age, job, mid, cat, title, label], \
        scale_infer, ml.train(), 64


def _fit_a_line(fluid, paddle, models):
    """tests/test_fit_a_line.py's program."""
    L = fluid.layers
    x = L.data(name="x", shape=[13], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    pred = L.fc(input=x, size=1, act=None)
    loss = L.mean(x=L.square_error_cost(input=pred, label=y))
    fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return loss, [x, y], pred, paddle.dataset.uci_housing.train(), 20


CHAPTERS = {"sentiment": _sentiment, "srl": _srl, "word2vec": _word2vec,
            "recommender": _recommender, "fit_a_line": _fit_a_line}


def _build(pkg, chapter, **kwargs):
    """(main, startup, loss, feed vars, the chapter's output, reader,
    batch) of `chapter` through the JAX package ("jax") or the port."""
    if pkg == "jax":
        fluid, paddle = jfluid, jpaddle
        import paddle_tpu.models as models
    else:
        fluid, paddle = tfluid, tpaddle
        import paddle_tpu_torch.models as models
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        loss, fvars, out, reader, batch = CHAPTERS[chapter](
            fluid, paddle, models, **kwargs)
    return main, startup, loss, fvars, out, reader, batch


def _batches(reader, batch, n):
    out = []
    for b in tpaddle.batch(reader, batch_size=batch)():
        out.append(b)
        if len(out) == n:
            return out
    raise AssertionError("the reader gave fewer than %d batches" % n)


@pytest.mark.parametrize("chapter", sorted(CHAPTERS))
def test_chapter_descs_equal_jax(chapter):
    jmain, jstartup = _build("jax", chapter)[:2]
    tmain, tstartup = _build("port", chapter)[:2]
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    assert tstartup.desc.to_dict() == jstartup.desc.to_dict()


def test_sentiment_descs_equal_jax_at_full_width():
    """conv_text_classifier at its own defaults: embedding 128, hidden
    128, filters 3 and 4 over the 5,147-word dictionary (about 0.77 M
    parameters)."""
    jmain, jstartup = _build("jax", "sentiment", emb=128, hid=128)[:2]
    tmain, tstartup = _build("port", "sentiment", emb=128, hid=128)[:2]
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    assert tstartup.desc.to_dict() == jstartup.desc.to_dict()
    block = tmain.desc.block(0)
    n = sum(int(np.prod(v.shape)) for v in block.vars.values()
            if v.is_parameter)
    assert n == 5147 * 128 + 3 * 128 * 128 + 128 + 4 * 128 * 128 + 128 \
        + 2 * 128 * 2 + 2
    convs = [op for op in block.ops if op.type == "sequence_conv"]
    assert [op.attrs["contextStart"] for op in convs] == [-1, -2]
    assert [block.vars[op.input("Filter")[0]].shape for op in convs] == \
        [(384, 128), (512, 128)]


@pytest.mark.parametrize("chapter", sorted(CHAPTERS))
def test_three_steps_match_jax(chapter):
    jmain, jstartup, jloss, jvars, jout, jreader, batch = _build("jax",
                                                                 chapter)
    tmain, _, tloss, tvars, tout, treader, _ = _build("port", chapter)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    batches = _batches(treader, batch, STEPS)
    for got, want in zip(batches, _batches(jreader, batch, STEPS)):
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    persist = [n for n, v in jmain.desc.block(0).vars.items()
               if v.persistable]
    decode = chapter == "srl"
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    jfeeder = jfluid.DataFeeder(jvars, jfluid.CPUPlace(), jmain)
    with jfluid.scope_guard(scope):
        exe.run(jstartup)
        init = {n: np.array(scope.get(n)) for n in persist}
        jlosses, jpaths = [], []
        for b in batches:
            outs = exe.run(jmain, feed=jfeeder.feed(b),
                           fetch_list=[jloss] + ([jout] if decode else []))
            jlosses.append(float(np.asarray(outs[0]).reshape(-1)[0]))
            if decode:
                jpaths.append(np.asarray(outs[1].values))
        jfinal = {n: np.array(scope.get(n)) for n in persist}

    texe, tscope = tfluid.Executor(CPU), tfluid.Scope()
    tio.params_from_numpy(tscope, init, "cpu")
    tfeeder = tfluid.DataFeeder(tvars, CPU, tmain)
    tlosses = []
    for i, b in enumerate(batches):
        outs = texe.run(tmain, feed=tfeeder.feed(b),
                        fetch_list=[tloss] + ([tout] if decode else []),
                        scope=tscope)
        tlosses.append(float(np.asarray(outs[0]).reshape(-1)[0]))
        if decode and i == 0:
            # the first step's paths come from the same state
            np.testing.assert_array_equal(outs[1].values.numpy(),
                                          jpaths[0])
            assert outs[1].values.numpy().max() > 0
    assert np.isfinite(tlosses).all()
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=ATOL)
    moved = 0
    params = {p.name for p in tmain.global_block().all_parameters()}
    adam = any(n.endswith("_moment1_0") for n in jfinal)
    for n, want in jfinal.items():
        got = tscope.get(n).numpy()
        assert got.shape == want.shape, n
        moved += not np.array_equal(want, init[n])
        if adam and n in params:
            # Adam moves an entry by about lr times the sign of its
            # grad, so a grad near 0 that rounds the other way moves
            # it by 2 lr: the parameters' change, in relative L2
            change = np.linalg.norm(want.astype(np.float64) - init[n])
            assert change > 0, n
            assert np.linalg.norm(got.astype(np.float64) - want) <= \
                ADAM_PARAM_RL2 * change, n
            continue
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=ATOL * max(1.0, float(np.abs(want).max())), err_msg=n)
    assert moved >= len(tmain.global_block().all_parameters())


DATASETS = [("imdb", "train"), ("imdb", "test"), ("conll05", "test"),
            ("imikolov", "train"), ("imikolov", "test"),
            ("movielens", "train"), ("movielens", "test"),
            ("uci_housing", "train"), ("uci_housing", "test")]


@pytest.mark.parametrize("name,split", DATASETS)
def test_synthetic_samples_equal_jax(name, split):
    got = list(getattr(getattr(tpaddle.dataset, name), split)()())
    want = list(getattr(getattr(jpaddle.dataset, name), split)()())
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_dictionaries_equal_jax():
    assert tpaddle.dataset.imdb.word_dict() == jpaddle.dataset.imdb.word_dict()
    assert len(tpaddle.dataset.imdb.word_dict()) == 5147
    assert tpaddle.dataset.conll05.get_dict() == \
        jpaddle.dataset.conll05.get_dict()
    assert [len(d) for d in tpaddle.dataset.conll05.get_dict()] == \
        [4000, 300, 59]
    assert tpaddle.dataset.imikolov.build_dict() == \
        jpaddle.dataset.imikolov.build_dict()
    ml, jml = tpaddle.dataset.movielens, jpaddle.dataset.movielens
    assert (ml.max_user_id(), ml.max_movie_id(), ml.max_job_id(),
            ml.age_table, ml.movie_categories()) == \
        (jml.max_user_id(), jml.max_movie_id(), jml.max_job_id(),
         jml.age_table, jml.movie_categories())
    np.testing.assert_array_equal(
        tpaddle.dataset.conll05.get_embedding(dim=8),
        jpaddle.dataset.conll05.get_embedding(dim=8))


def test_sentiment_export_served_matches_the_program(tmp_path):
    main, startup, loss, fvars, prob, reader, batch = _build("port",
                                                             "sentiment")
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    feeder = tfluid.DataFeeder(fvars, CPU, main)
    for b in _batches(reader, batch, STEPS):
        exe.run(main, feed=feeder.feed(b), fetch_list=[loss], scope=scope)
    model_dir = str(tmp_path / "sentiment")
    with tfluid.scope_guard(scope):
        infer = tio.save_inference_model(model_dir, ["words"], [prob], exe,
                                         main)
    seqs = [np.asarray(s, np.int64).reshape(-1, 1)
            for s, _ in list(tpaddle.dataset.imdb.test()())[:5]]
    want, = exe.run(infer, feed=tfluid.DataFeeder(
        [fvars[0]], CPU, main).feed([(s,) for s in seqs]),
        fetch_list=[prob], scope=scope)
    engine = InferenceEngine.from_saved_model(model_dir, place=CPU)
    assert "sequence_conv" in [op.type for op in
                               engine.program.block(0).ops]
    together = engine.run({"words": seqs})[0]
    assert together.shape == (5, 2)
    np.testing.assert_allclose(together, want, atol=SERVE_ATOL, rtol=0)
    for i, s in enumerate(seqs[:3]):
        alone = engine.run({"words": [s]})[0]
        np.testing.assert_allclose(alone, want[i:i + 1], atol=SERVE_ATOL,
                                   rtol=0)
