"""The v2 API of the port (`paddle_tpu_torch.v2`) against the JAX
package's (`paddle_tpu.v2`), on the CPU (`init(use_gpu=False)`), at
narrow widths.

Each flow is built by both packages' v2 layers into their default
programs: the main and startup descs are equal through `to_dict()`.
The JAX package's initial state (after `parameters.create` and the
trainer's startup of its optimizer state) is carried into the port's
scope by name, both run the same batches, and:

- the flows of tests/test_v2_api.py (fit-a-line, the mnist convnet, the
  sequence LSTM), tests/test_v2_recurrent.py (11, the nested
  SubsequenceInput groups included), tests/test_v2_networks.py (every
  case: the GRU and LSTM groups, both attention-NMT tests, dot-product
  and multi-head attention, small_vgg and vgg_16_network) and
  tests/test_v2_trainer_semantics.py (4) give the JAX package's
  results: integer, copied and summed-in-order outputs exactly; the
  first 3 training losses at rtol 1e-5 (f32 on both sides, sums in
  other orders through the recurrences and products); each flow's own
  criterion on the port's whole run.  Flows with dropout hold the
  first loss only to being finite, as the JAX tests do (the packages'
  random streams differ).
- beam generation from the same parameters gives the JAX package's ids
  exactly and its scores at rtol 1e-5; the states used have no ties
  among the candidates a beam keeps (the top-k order of tied scores is
  the one place the port may differ).
- the book's attention NMT (chip_smoke.py's `build_nmt`, BASELINE.json
  configs[3]): the training and generation descs equal at the book's
  full width (dictionaries of 30,000, 512 wide, Adam at 5e-5 with an L2
  rate of 8e-4); at a narrow width 2 `SGD` steps through both packages
  from one state (losses at rtol 1e-5, each tensor's change in relative
  L2 at 1e-4), then a beam decode from one decode state with equal ids
  (scores at atol 5e-3: that state's logits reach about 1e3).
- v2 parameter tars written by either package load in the other, bit
  for bit.
- the zoo names whose ops the port lacks raise NotImplementedError
  naming their ROADMAP item; without `use_gpu=False` the v2 API runs on
  CUDAPlace(0) and raises where there is no CUDA device.
"""

import io
import os
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.fluid as jfluid
import paddle_tpu.v2 as jv2
from paddle_tpu.core import scope as jscope
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.v2 as tv2
from paddle_tpu_torch.core import scope as tscope
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.v2 import config as tconfig

import chip_smoke

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

LOSS_RTOL = 1e-5
CHANGE_RL2 = 1e-4


@pytest.fixture(autouse=True)
def fresh_port():
    """Fresh default programs and global scope for the port (the
    conftest gives the JAX package its own), and the v2 API on the
    CPU."""
    old_main = tframework.switch_main_program(tframework.Program())
    old_startup = tframework.switch_startup_program(tframework.Program())
    old_scope = tscope._global_scope
    tscope._global_scope = tscope.Scope()
    old_state = dict(tconfig._state)
    tv2.init(use_gpu=False)
    jv2.init(use_gpu=False)
    yield
    tframework.switch_main_program(old_main)
    tframework.switch_startup_program(old_startup)
    tscope._global_scope = old_scope
    tconfig._state.update(old_state)


def _both(build):
    """build(v2) run with each package's v2: (JAX result, port result)."""
    return build(jv2), build(tv2)


def _descs_equal():
    assert tfluid.default_main_program().desc.to_dict() == \
        jfluid.default_main_program().desc.to_dict()
    assert tfluid.default_startup_program().desc.to_dict() == \
        jfluid.default_startup_program().desc.to_dict()


def _persistables(program):
    return {n for b in program.desc.blocks for n, vd in b.vars.items()
            if vd.persistable}


def _jax_state():
    """{name: ndarray} of the JAX global scope's persistables that the
    port's programs declare."""
    js = jscope.global_scope()
    names = _persistables(tfluid.default_main_program()) \
        | _persistables(tfluid.default_startup_program())
    return {n: np.asarray(js.get(n)) for n in sorted(names)
            if js.get(n) is not None}


def _carry():
    """The JAX package's state set in the port's global scope."""
    state = _jax_state()
    tfluid.io.params_from_numpy(tscope.global_scope(), state, "cpu")
    return state


def _start_both():
    """Each package's startup run on the CPU, then the JAX package's
    state carried into the port's scope: (JAX executor, port executor)."""
    exes = []
    for fluid in (jfluid, tfluid):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        exes.append(exe)
    _carry()
    return exes


def _port_state(names):
    s = tscope.global_scope()
    return {n: s.get(n).numpy().copy() for n in names}


def _close_losses(port, ref, n=3):
    np.testing.assert_allclose(port[:n], ref[:n], rtol=LOSS_RTOL, atol=1e-6)


def _change_rl2(got, ref, before):
    num = sum(float(((got[n] - ref[n]).astype(np.float64) ** 2).sum())
              for n in before)
    den = sum(float(((ref[n] - before[n]).astype(np.float64) ** 2).sum())
              for n in before)
    return (num / max(den, 1e-300)) ** 0.5


def _sgd(v2, cost, update):
    params = v2.parameters.create(cost)
    return params, v2.trainer.SGD(cost=cost, parameters=params,
                                  update_equation=update)


def _costs_of(trainer, reader, **kw):
    costs = []
    trainer.train(reader=reader, event_handler=lambda e: costs.append(
        e.cost) if type(e).__name__ == "EndIteration" else None, **kw)
    return costs


# -- tests/test_v2_api.py --------------------------------------------------------

def _fit_a_line(v2):
    x = v2.layer.data(name="x", type=v2.data_type.dense_vector(13))
    y_predict = v2.layer.fc(input=x, size=1, act=v2.activation.Linear())
    y = v2.layer.data(name="y", type=v2.data_type.dense_vector(1))
    cost = v2.layer.square_error_cost(input=y_predict, label=y)
    params, trainer = _sgd(v2, cost, v2.optimizer.Momentum(
        momentum=0.9, learning_rate=1e-3))
    return y_predict, cost, params, trainer


def test_v2_fit_a_line_matches_jax():
    """tests/test_v2_api.py:12: SGD.train, test, Parameters and infer,
    from one state over the same (unshuffled) batches; then the JAX
    test's own flow (its shuffled reader, 12 passes) through the port,
    whose cost must fall."""
    (jpred, _, jparams, jtrainer), (tpred, _, tparams, ttrainer) = \
        _both(_fit_a_line)
    _descs_equal()
    _carry()
    feeding = {"x": 0, "y": 1}
    jreader = jv2.batch(jpaddle.dataset.uci_housing.train(), batch_size=20)
    treader = tv2.batch(tpaddle.dataset.uci_housing.train(), batch_size=20)
    jc = _costs_of(jtrainer, jreader, num_passes=2, feeding=feeding)
    tc = _costs_of(ttrainer, treader, num_passes=2, feeding=feeding)
    np.testing.assert_allclose(tc, jc, rtol=LOSS_RTOL, atol=1e-6)
    assert tparams.keys() == jparams.keys()
    for k in tparams.keys():
        np.testing.assert_allclose(tparams.get(k), jparams.get(k),
                                   rtol=1e-5, atol=1e-6)
    jt = jtrainer.test(reader=jv2.batch(jpaddle.dataset.uci_housing.test(),
                                        batch_size=20), feeding=feeding)
    tt = ttrainer.test(reader=tv2.batch(tpaddle.dataset.uci_housing.test(),
                                        batch_size=20), feeding=feeding)
    np.testing.assert_allclose(tt.cost, jt.cost, rtol=1e-5)
    data = [(s[0],) for s in tpaddle.dataset.uci_housing.test()()][:8]
    jp = jv2.infer(output_layer=jpred, parameters=jparams, input=data,
                   feeding=feeding)
    tp = tv2.infer(output_layer=tpred, parameters=tparams, input=data,
                   feeding=feeding)
    assert tp.shape == (8, 1)
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-6)

    # the JAX test's flow, through the port alone
    costs = _costs_of(ttrainer, tv2.batch(tv2.reader.shuffle(
        tpaddle.dataset.uci_housing.train(), buf_size=500), batch_size=20),
        num_passes=12, feeding=feeding)
    assert costs[-1] < costs[0], (costs[0], costs[-1])


def _mnist(v2):
    images = v2.layer.data(name="pixel", type=v2.data_type.dense_array(
        784, [1, 28, 28]))
    label = v2.layer.data(name="label",
                          type=v2.data_type.integer_value(10))
    conv_pool = v2.networks.simple_img_conv_pool(
        input=images, filter_size=5, num_filters=8, pool_size=2,
        pool_stride=2, act=v2.activation.Relu())
    predict = v2.layer.fc(input=conv_pool, size=10,
                          act=v2.activation.Softmax())
    cost = v2.layer.classification_cost(input=predict, label=label)
    return _sgd(v2, cost, v2.optimizer.Adam(learning_rate=0.01))


def _limited(reader, n):
    def limited():
        for i, b in enumerate(reader()):
            if i >= n:
                return
            yield b
    return limited


def test_v2_mnist_convnet_matches_jax():
    """tests/test_v2_api.py:70: 12 Adam steps of the conv net over the
    mnist reader from one state; the JAX test's criterion (the last 3
    costs' mean below the first 3's) on the port's run."""
    (_, jtrainer), (_, ttrainer) = _both(_mnist)
    _descs_equal()
    _carry()
    jc = _costs_of(jtrainer, _limited(jv2.batch(
        jpaddle.dataset.mnist.train(), batch_size=32), 12))
    tc = _costs_of(ttrainer, _limited(tv2.batch(
        tpaddle.dataset.mnist.train(), batch_size=32), 12))
    _close_losses(tc, jc)
    assert np.mean(tc[-3:]) < np.mean(tc[:3]), tc


def _seq_lstm(v2):
    data = v2.layer.data(name="words",
                         type=v2.data_type.integer_value_sequence(200))
    label = v2.layer.data(name="label", type=v2.data_type.integer_value(2))
    emb = v2.layer.embedding(input=data, size=16)
    lstm = v2.networks.simple_lstm(input=emb, size=8)
    pooled = v2.layer.pool(input=lstm, pooling_type=v2.pooling.Max())
    predict = v2.layer.fc(input=pooled, size=2,
                          act=v2.activation.Softmax())
    cost = v2.layer.classification_cost(input=predict, label=label)
    return _sgd(v2, cost, v2.optimizer.Adam(learning_rate=0.05))


def _lstm_reader():
    rs = np.random.RandomState(3)

    def reader():
        for _ in range(10):
            batch = []
            for _ in range(8):
                words = rs.randint(0, 200, size=int(rs.randint(3, 12)))
                batch.append((words.tolist(), int(words.sum() % 2)))
            yield batch
    return reader


def test_v2_sequence_lstm_matches_jax():
    """tests/test_v2_api.py:115: the LSTM classifier, 2 passes over the
    JAX test's seeded reader (each pass draws new batches) from one
    state; finite costs."""
    (_, jtrainer), (_, ttrainer) = _both(_seq_lstm)
    _descs_equal()
    _carry()
    jc = _costs_of(jtrainer, _lstm_reader(), num_passes=2)
    tc = _costs_of(ttrainer, _lstm_reader(), num_passes=2)
    _close_losses(tc, jc)
    assert np.isfinite(tc).all()


# -- tests/test_v2_trainer_semantics.py --------------------------------------------

def _linear(v2):
    x = v2.layer.data(name="x", type=v2.data_type.dense_vector(4))
    y = v2.layer.data(name="y", type=v2.data_type.dense_vector(1))
    pred = v2.layer.fc(input=x, size=1)
    cost = v2.layer.square_error_cost(input=pred, label=y)
    return pred, cost


def test_test_does_not_update_parameters():
    (_, jcost), (_, tcost) = _both(_linear)
    results = []
    for v2, cost in ((jv2, jcost), (tv2, tcost)):
        params, trainer = _sgd(v2, cost, v2.optimizer.Momentum(
            momentum=0.9, learning_rate=0.1))
        if v2 is tv2:
            _carry()
        key = params.keys()[0]
        before = params.get(key).copy()
        rs = np.random.RandomState(0)

        def reader():
            for _ in range(3):
                yield [(rs.rand(4).astype("f"), rs.rand(1).astype("f"))
                       for _ in range(5)]

        res = trainer.test(reader=reader, feeding={"x": 0, "y": 1})
        np.testing.assert_array_equal(params.get(key), before)
        results.append(res.cost)
    assert np.isfinite(results[1])
    np.testing.assert_allclose(results[1], results[0], rtol=1e-6)


def test_loaded_weights_survive_trainer_construction():
    """Parameters.set before SGD() survives the trainer's startup of its
    optimizer state; a step then moves it."""
    _, cost = _linear(tv2)
    params = tv2.parameters.create(cost)
    k = params.keys()[0]
    params.set(k, np.full(params.get(k).shape, 7.0, np.float32))
    trainer = tv2.trainer.SGD(cost=cost, parameters=params,
                              update_equation=tv2.optimizer.Adam(
                                  learning_rate=0.01))
    np.testing.assert_array_equal(params.get(k), 7.0)
    trainer.train(reader=lambda: iter([[(np.ones(4, "f"), np.ones(1, "f"))
                                        for _ in range(4)]]), num_passes=1)
    assert not np.allclose(params.get(k), 7.0)


def test_infer_rejects_wrong_feed_width():
    pred, cost = _linear(tv2)
    tv2.parameters.create(cost)
    with pytest.raises(ValueError):
        tv2.infer(output_layer=pred,
                  input=[(np.ones(4, "f"), np.ones(1, "f"))],
                  feeding={"x": 0, "y": 1})


def test_train_save_dir_writes_pass_tars(tmp_path):
    """One parameters tar a pass, loadable by Parameters.from_tar of
    both packages."""
    _, cost = _linear(tv2)
    params, trainer = _sgd(tv2, cost, tv2.optimizer.Momentum(
        learning_rate=0.01))
    rs = np.random.RandomState(0)

    def reader():
        for _ in range(4):
            yield (rs.rand(4).astype(np.float32),
                   rs.rand(1).astype(np.float32))

    save_dir = str(tmp_path / "passes")
    trainer.train(tv2.batch(reader, batch_size=2), num_passes=3,
                  feeding={"x": 0, "y": 1}, save_dir=save_dir)
    tars = sorted(os.listdir(save_dir))
    assert tars == ["pass_00000.tar", "pass_00001.tar", "pass_00002.tar"]
    trained = {n: params.get(n) for n in params.names()}
    for n in trained:
        params.set(n, np.zeros_like(trained[n]))
    with open(os.path.join(save_dir, tars[-1]), "rb") as f:
        restored = tv2.parameters.Parameters.from_tar(f)
    for name, want in trained.items():
        np.testing.assert_array_equal(restored.get(name), want)
    # the JAX package reads the port's tar
    _linear(jv2)
    with open(os.path.join(save_dir, tars[-1]), "rb") as f:
        jrestored = jv2.parameters.Parameters.from_tar(f)
    for name, want in trained.items():
        np.testing.assert_array_equal(np.asarray(jrestored.get(name)), want)


# -- v2 parameter tars across the packages -----------------------------------------

def _tar_members(data):
    with tarfile.open(fileobj=io.BytesIO(data)) as tar:
        return {m.name: tar.extractfile(m).read() for m in tar.getmembers()}


def test_parameter_tars_cross_both_ways():
    """A tar the JAX package writes loads in the port and one the port
    writes loads in the JAX package, bit for bit; from the same values
    the two packages write the same members with the same bytes."""
    (_, jcost), (_, tcost) = _both(_linear)
    jparams = jv2.parameters.create(jcost)
    tparams = tv2.parameters.create(tcost)
    state = _carry()
    names = tparams.keys()
    assert names == jparams.keys()
    jbuf, tbuf = io.BytesIO(), io.BytesIO()
    jparams.to_tar(jbuf)
    tparams.to_tar(tbuf)
    assert _tar_members(jbuf.getvalue()) == _tar_members(tbuf.getvalue())

    rs = np.random.RandomState(5)
    new = {n: rs.randn(*state[n].shape).astype(np.float32) for n in names}
    for n in names:
        jparams.set(n, new[n])
    jbuf = io.BytesIO()
    jparams.to_tar(jbuf)
    jbuf.seek(0)
    tparams.init_from_tar(jbuf)
    for n in names:
        np.testing.assert_array_equal(tparams.get(n), new[n])
        tparams.set(n, new[n] * 2)
    tbuf = io.BytesIO()
    tparams.to_tar(tbuf)
    tbuf.seek(0)
    jparams.init_from_tar(tbuf)
    for n in names:
        np.testing.assert_array_equal(np.asarray(jparams.get(n)), new[n] * 2)


# -- tests/test_v2_recurrent.py ----------------------------------------------------

def _run_seq(fluid, out, feeds, lod_feeds, state=None):
    """The JAX test's `_run_seq` through `fluid` (startup, then one run
    of the default main program): (values without padding rows, lod) or
    (array, None).  The port runs from `state` when given."""
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    if state is not None:
        tfluid.io.params_from_numpy(tscope.global_scope(), state, "cpu")
    blk = fluid.default_main_program().global_block()
    feeder = fluid.DataFeeder(place=fluid.CPUPlace(),
                              feed_list=[blk.var(n) for n in feeds])
    rows = [tuple(lod_feeds[n][i] for n in feeds)
            for i in range(len(lod_feeds[feeds[0]]))]
    res, = exe.run(fluid.default_main_program(), feed=feeder.feed(rows),
                   fetch_list=[out], return_numpy=False)
    if hasattr(res, "values"):
        lod = [list(map(int, np.asarray(rs))) for rs in res.row_splits]
        return np.asarray(res.values)[:lod[-1][-1]], lod
    return np.asarray(res), None


def _seq_both(build, feeds, lod_feeds, exact=True):
    jout, tout = _both(build)
    _descs_equal()
    jv, jlod = _run_seq(jfluid, jout, feeds, lod_feeds)
    tv, tlod = _run_seq(tfluid, tout, feeds, lod_feeds, state=_jax_state())
    assert tlod == jlod
    if exact:
        np.testing.assert_array_equal(tv, jv)
    else:
        np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
    return tv, tlod


def test_recurrent_group_accumulator():
    def build(v2):
        x = v2.layer.data(name="x",
                          type=v2.data_type.dense_vector_sequence(3))

        def step(y):
            mem = v2.layer.memory(name="acc", size=3)
            out = v2.layer.addto(input=[mem, y], act=None)
            mem.set_input(out)
            return out

        return v2.layer.recurrent_group(step=step, input=x)

    seqs = [[[1, 1, 1], [2, 2, 2], [3, 3, 3]], [[10, 0, 0], [1, 1, 1]]]
    vals, lod = _seq_both(build, ["x"], {"x": seqs})
    assert vals.tolist() == [[1, 1, 1], [3, 3, 3], [6, 6, 6],
                             [10, 0, 0], [11, 1, 1]]
    assert lod == [[0, 3, 5]]


def test_recurrent_group_reverse():
    def build(v2):
        x = v2.layer.data(name="x",
                          type=v2.data_type.dense_vector_sequence(2))

        def step(y):
            mem = v2.layer.memory(name="racc", size=2)
            out = v2.layer.addto(input=[mem, y], act=None)
            mem.set_input(out)
            return out

        return v2.layer.recurrent_group(step=step, input=x, reverse=True)

    vals, _ = _seq_both(build, ["x"], {"x": [[[1, 0], [2, 0], [4, 0]]]})
    assert vals.tolist() == [[7, 0], [6, 0], [4, 0]]


def test_recurrent_group_static_input():
    def build(v2):
        x = v2.layer.data(name="x",
                          type=v2.data_type.dense_vector_sequence(2))
        s = v2.layer.data(name="s", type=v2.data_type.dense_vector(2))
        return v2.layer.recurrent_group(
            step=lambda y, st: v2.layer.addto(input=[y, st], act=None),
            input=[x, v2.layer.StaticInput(input=s)])

    vals, _ = _seq_both(build, ["x", "s"], {"x": [[[1, 1], [2, 2]]],
                                           "s": [[10.0, 20.0]]})
    assert vals.tolist() == [[11, 21], [12, 22]]


def test_recurrent_group_named_memory_link():
    def build(v2):
        x = v2.layer.data(name="x",
                          type=v2.data_type.dense_vector_sequence(2))

        def step(y):
            mem = v2.layer.memory(name="state", size=2)
            return v2.layer.addto(input=[mem, y], name="state")

        return v2.layer.recurrent_group(step=step, input=x)

    vals, _ = _seq_both(build, ["x"], {"x": [[[1, 2], [3, 4]]]})
    assert vals.tolist() == [[1, 2], [4, 6]]


def test_lstm_step_group():
    H = 4

    def build(v2):
        x = v2.layer.data(name="x",
                          type=v2.data_type.dense_vector_sequence(4 * H))

        def step(y):
            v2.layer.memory(name="h", size=H)
            cell_mem = v2.layer.memory(name="c", size=H)
            h = v2.layer.lstm_step_layer(input=y, state=cell_mem, size=H,
                                         name="h")
            v2.layer.get_output_layer(input=h, arg_name="state", name="c")
            return h

        return v2.layer.recurrent_group(step=step, input=x)

    rs = np.random.RandomState(0)
    seqs = [rs.rand(3, 4 * H).tolist(), rs.rand(2, 4 * H).tolist()]
    vals, lod = _seq_both(build, ["x"], {"x": seqs}, exact=False)
    assert vals.shape == (5, H) and lod == [[0, 3, 5]]


def test_recurrent_layer_matches_numpy():
    def build(v2):
        x = v2.layer.data(name="x",
                          type=v2.data_type.dense_vector_sequence(2))
        return v2.layer.recurrent(
            input=x, act=v2.activation.Linear(),
            param_attr=v2.attr.Param(initial_std=0.0, initial_mean=0.5),
            bias_attr=False)

    vals, _ = _seq_both(build, ["x"], {"x": [[[1.0, 1.0], [1.0, 1.0]]]})
    W = np.full((2, 2), 0.5, np.float32)
    h, expect = np.zeros(2, np.float32), []
    for _ in range(2):
        h = np.ones(2, np.float32) + h @ W
        expect.append(h.copy())
    np.testing.assert_allclose(vals, np.asarray(expect), rtol=1e-5)


def _ids_to_seqs(ids):
    seqs, cur = [], []
    for w in ids:
        if w == -1:
            seqs.append(cur)
            cur = []
        else:
            cur.append(int(w))
    return seqs


def _gen_topology(v2, V=7, E=4, H=4):
    layer = v2.layer
    src = layer.data(name="src", type=v2.data_type.integer_value_sequence(V))
    enc = layer.pool(input=layer.embedding(input=src, size=E),
                     pooling_type=v2.pooling.Sum)
    boot = layer.fc(input=enc, size=H, act=v2.activation.Tanh())

    def gen_step(cur_emb):
        mem = layer.memory(name="dec", size=H, boot_layer=boot)
        inp = layer.fc(input=[cur_emb, mem], size=H * 3, act=None)
        g = layer.gru_step_layer(input=inp, output_mem=mem, size=H,
                                 name="dec")
        return layer.fc(input=g, size=V, act=v2.activation.Softmax())

    return layer.beam_search(
        step=gen_step,
        input=[layer.GeneratedInput(size=V, embedding_name="trg_emb",
                                    embedding_size=E)],
        bos_id=0, eos_id=1, beam_size=3, max_length=6)


def test_beam_search_generation():
    """tests/test_v2_recurrent.py:172: generation with parameters only
    the generation topology declares (the throwaway startup makes them
    on the caller's place).  From the JAX package's values of them, the
    port's ids equal the JAX package's and its scores agree."""
    jbeam, tbeam = _both(_gen_topology)
    _descs_equal()
    data = [([2, 3, 4],), ([5, 6],)]
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    jprobs, jids = jpaddle.infer(output_layer=jbeam, input=data,
                                 field=["prob", "id"])
    _carry()
    tprobs, tids = tpaddle.infer(output_layer=tbeam, input=data,
                                 field=["prob", "id"])
    assert tids == list(jids)
    np.testing.assert_allclose(tprobs, np.asarray(jprobs), rtol=1e-5)
    assert np.asarray(tprobs).shape == (2, 3)
    assert np.all(np.diff(tprobs, axis=1) <= 1e-6)
    seqs = _ids_to_seqs(tids)
    assert len(seqs) == 6
    assert all(s[0] == 0 and s[-1] == 1 and len(s) <= 8 for s in seqs)


def test_beam_search_generation_makes_missing_parameters():
    """Parameters only the generation step reads, without a value (a
    generation topology built after the training startup ran): the port
    makes them by running the startup program on the caller's place
    into a throwaway scope, sets them in the scope and generates 2 x 3
    results, bos ... eos."""
    beam = _gen_topology(tv2)
    tfluid.Executor(tfluid.CPUPlace()).run(tfluid.default_startup_program())
    spec = beam._v2_beam_spec
    block = spec.program.desc.block(spec.block_idx)
    params = spec.program.global_block().desc.vars
    step_only = sorted({n for op in block.ops for n in op.input_names()
                        if n in params and params[n].is_parameter})
    assert "trg_emb" in step_only
    scope = tscope.global_scope()
    for n in step_only:
        scope.set(n, None)
    probs, ids = tpaddle.infer(output_layer=beam,
                               input=[([2, 3, 4],), ([5, 6],)],
                               field=["prob", "id"])
    assert all(scope.get(n) is not None for n in step_only)
    assert np.asarray(probs).shape == (2, 3)
    seqs = _ids_to_seqs(ids)
    assert len(seqs) == 6
    assert all(s[0] == 0 and s[-1] == 1 for s in seqs)


def _seqgen(v2):
    V, E, H = 6, 4, 4
    layer, Param = v2.layer, v2.attr.Param
    src = layer.data(name="src", type=v2.data_type.integer_value_sequence(V))
    enc = layer.pool(input=layer.embedding(input=src, size=E),
                     pooling_type=v2.pooling.Sum)
    boot = layer.fc(input=enc, size=H, act=v2.activation.Tanh(),
                    param_attr=Param(name="boot_w"))
    trg = layer.data(name="trg", type=v2.data_type.integer_value_sequence(V))
    trg_emb = layer.embedding(input=trg, size=E,
                              param_attr=Param(name="trg_emb"))
    lbl = layer.data(name="lbl", type=v2.data_type.integer_value_sequence(V))

    def dec_step(cur_emb):
        mem = layer.memory(name="dec", size=H, boot_layer=boot)
        inp = layer.fc(input=[cur_emb, mem], size=H * 3, act=None,
                       param_attr=[Param(name="dec_in_x"),
                                   Param(name="dec_in_h")])
        g = layer.gru_step_layer(input=inp, output_mem=mem, size=H,
                                 name="dec", param_attr=Param(name="dec_gru"))
        return layer.fc(input=g, size=V, act=v2.activation.Softmax(),
                        param_attr=Param(name="dec_out"))

    cost = layer.classification_cost(
        input=layer.recurrent_group(step=dec_step, input=trg_emb),
        label=lbl)
    params, trainer = _sgd(v2, cost, v2.optimizer.Adam(learning_rate=0.05))
    return dec_step, trainer


def _seqgen_reader():
    rs = np.random.RandomState(7)
    for _ in range(8):
        yield [(rs.randint(2, 6, size=3).tolist(), [0, 2, 3], [2, 3, 1])
               for _ in range(8)]


def test_seqgen_train_then_decode():
    """tests/test_v2_recurrent.py:202: train a tiny seq2seq decoder
    (teacher forcing) from one state, then beam-decode with the trained
    parameters: the port's losses follow the JAX package's and its best
    beam is the taught sequence."""
    (jstep, jtrainer), (tstep, ttrainer) = _both(_seqgen)
    _descs_equal()
    _carry()
    feeding = {"src": 0, "trg": 1, "lbl": 2}
    jc = _costs_of(jtrainer, _seqgen_reader, num_passes=6, feeding=feeding)
    tc = _costs_of(ttrainer, _seqgen_reader, num_passes=6, feeding=feeding)
    _close_losses(tc, jc)
    assert tc[-1] < tc[0]
    beams = []
    for v2, step in ((jv2, jstep), (tv2, tstep)):
        beams.append(v2.layer.beam_search(
            step=step, input=[v2.layer.GeneratedInput(
                size=6, embedding_name="trg_emb", embedding_size=4)],
            bos_id=0, eos_id=1, beam_size=2, max_length=5))
    _, ids = tpaddle.infer(output_layer=beams[1], input=[([2, 3, 4],)],
                           field=["prob", "id"])
    assert _ids_to_seqs(ids)[0] == [0, 2, 3, 1]


def test_nested_group_inner_accumulation():
    """tests/test_v2_recurrent.py:281: an inner recurrence per
    subsequence of a nested input; the outputs nest again."""
    def build(v2):
        x = v2.layer.data(name="x",
                          type=v2.data_type.dense_vector_sub_sequence(2))

        def outer_step(sent):
            def inner_step(w):
                mem = v2.layer.memory(name="nacc", size=2)
                out = v2.layer.addto(input=[mem, w], act=None)
                mem.set_input(out)
                return out

            return v2.layer.recurrent_group(step=inner_step, input=sent)

        return v2.layer.recurrent_group(step=outer_step,
                                        input=v2.layer.SubsequenceInput(x))

    seqs = [[[[1, 0], [2, 0]], [[5, 0], [1, 0], [1, 0]]], [[[7, 0]]]]
    vals, lod = _seq_both(build, ["x"], {"x": seqs})
    assert vals.tolist() == [[1, 0], [3, 0], [5, 0], [6, 0], [7, 0],
                             [7, 0]]
    assert lod == [[0, 2, 3], [0, 2, 5, 6]]


def _sentence_encoder(v2, fluid):
    layer = v2.layer
    words = layer.data(name="words",
                       type=v2.data_type.dense_vector_sub_sequence(4))
    glob = layer.data(name="glob", type=v2.data_type.dense_vector(4))
    label = layer.data(name="label", type=v2.data_type.dense_vector(1))

    def encode_sentence(sent, g):
        h = layer.fc(input=sent, size=6, act=v2.activation.Tanh())
        h2 = layer.fc(input=g, size=6)
        return layer.addto(input=[layer.last_seq(input=h), h2], act=None)

    sent_seq = layer.recurrent_group(
        step=encode_sentence,
        input=[layer.SubsequenceInput(words), layer.StaticInput(glob)])
    pred = layer.fc(input=layer.last_seq(input=sent_seq), size=1)
    cost = layer.mse_cost(input=pred, label=label)
    return cost


def test_nested_group_sentence_encoder_trains():
    """tests/test_v2_recurrent.py:313: sentences encoded by the nested
    group, then a document cost; 10 SGD steps from one state: every
    loss at rtol 1e-5 of the JAX package's, and falling."""
    jcost = _sentence_encoder(jv2, jfluid)
    tcost = _sentence_encoder(tv2, tfluid)
    for fluid, cost in ((jfluid, jcost), (tfluid, tcost)):
        fluid.optimizer.SGD(learning_rate=0.05).minimize(cost)
    _descs_equal()
    rs = np.random.RandomState(0)
    docs = [[rs.rand(rs.randint(2, 5), 4).tolist()
             for _ in range(rs.randint(1, 4))] for _ in range(6)]
    globs = [rs.rand(4).tolist() for _ in range(6)]
    rows = list(zip(docs, globs, [[float(len(d))] for d in docs]))
    exes = _start_both()
    losses = []
    for fluid, exe, cost in zip((jfluid, tfluid), exes, (jcost, tcost)):
        blk = fluid.default_main_program().global_block()
        feeds = fluid.DataFeeder(place=fluid.CPUPlace(), feed_list=[
            blk.var(n) for n in ("words", "glob", "label")]).feed(rows)
        losses.append([float(np.asarray(exe.run(
            fluid.default_main_program(), feed=feeds,
            fetch_list=[cost])[0]).reshape(-1)[0]) for _ in range(10)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=LOSS_RTOL,
                               atol=1e-6)
    assert losses[1][-1] < losses[1][0]


def test_nested_group_outer_memory_raises():
    x = tv2.layer.data(name="x",
                       type=tv2.data_type.dense_vector_sub_sequence(2))

    def outer_step(sent):
        tv2.layer.memory(name="om", size=2)
        return tv2.layer.last_seq(input=sent)

    with pytest.raises(NotImplementedError, match="subsequence"):
        tv2.layer.recurrent_group(step=outer_step,
                                  input=tv2.layer.SubsequenceInput(x))


# -- tests/test_v2_networks.py -----------------------------------------------------

V, H = 30, 8


def _feed(fluid, names, data):
    blk = fluid.default_main_program().global_block()
    return fluid.DataFeeder(place=fluid.CPUPlace(), feed_list=[
        blk.var(n) for n in names]).feed(data)


def _train_both(jcost, tcost, names, data, iters, lr):
    """The JAX test's `_train` (Adam at `lr`, `iters` steps on one
    batch) through both packages from the JAX startup's state: (JAX
    losses, port losses)."""
    out = []
    for fluid, cost in ((jfluid, jcost), (tfluid, tcost)):
        fluid.optimizer.Adam(learning_rate=lr).minimize(cost)
    _descs_equal()
    exes = _start_both()
    for fluid, exe, cost in zip((jfluid, tfluid), exes, (jcost, tcost)):
        feed = _feed(fluid, names, data)
        out.append([float(np.asarray(exe.run(feed=feed, fetch_list=[
            cost])[0]).reshape(-1)[0]) for _ in range(iters)])
    return out


def test_recurrent_group_composites_train():
    def build(v2):
        layer, networks = v2.layer, v2.networks
        x = layer.data(name="x", type=v2.data_type.dense_vector_sequence(6))
        g = networks.gru_group(input=layer.fc(input=x, size=12), size=4)
        lstm = networks.lstmemory_group(input=layer.fc(input=x, size=16),
                                        size=4)
        bg = networks.bidirectional_gru(input=x, size=4)
        pooled = layer.pool(input=layer.concat(input=[g, lstm]))
        pred = layer.fc(input=layer.concat(input=[pooled, bg]), size=1)
        lab = layer.data(name="y", type=v2.data_type.dense_vector(1))
        return layer.mse_cost(input=pred, label=lab)

    jcost, tcost = _both(build)
    rs = np.random.RandomState(0)
    data = [(rs.rand(rs.randint(2, 5), 6).tolist(), [1.0]) for _ in range(4)]
    jl, tl = _train_both(jcost, tcost, ["x", "y"], data, 12, 5e-2)
    _close_losses(tl, jl)
    assert tl[-1] < tl[0] * 0.5, (tl[0], tl[-1])


def _nmt_data(rs, n=6):
    data = []
    for _ in range(n):
        s = rs.randint(0, V, size=rs.randint(2, 6)).tolist()
        t = rs.randint(0, V, size=rs.randint(2, 6)).tolist()
        data.append((s, t, t[1:] + [1]))
    return data


def test_attention_nmt_through_v2_dsl():
    def build(v2):
        layer, networks = v2.layer, v2.networks
        ity = v2.data_type.integer_value_sequence
        src, trg, nxt = (layer.data(name=n, type=ity(V))
                         for n in ("src", "trg", "nxt"))
        enc = networks.simple_gru(input=layer.embedding(input=src, size=H),
                                  size=H)
        enc_proj = layer.fc(input=enc, size=H, bias_attr=False)
        enc_last = layer.last_seq(input=enc)
        trg_emb = layer.embedding(input=trg, size=H)

        def decoder_step(cur_emb, enc_seq, enc_p):
            dec_mem = layer.memory(name="dec_state", size=H,
                                   boot_layer=enc_last)
            context = networks.simple_attention(
                encoded_sequence=enc_seq, encoded_proj=enc_p,
                decoder_state=dec_mem)
            gates = layer.fc(input=layer.concat(input=[cur_emb, context]),
                             size=H * 3, bias_attr=False)
            h = networks.gru_unit(input=gates, size=H, name="dec_state")
            return layer.fc(input=h, size=V, act=v2.activation.Softmax())

        probs = layer.recurrent_group(
            step=decoder_step,
            input=[trg_emb, layer.StaticInput(input=enc, is_seq=True),
                   layer.StaticInput(input=enc_proj, is_seq=True)])
        return layer.classification_cost(input=probs, label=nxt)

    jcost, tcost = _both(build)
    data = _nmt_data(np.random.RandomState(0))
    jl, tl = _train_both(jcost, tcost, ["src", "trg", "nxt"], data, 80,
                         3e-2)
    _close_losses(tl, jl)
    assert tl[0] < np.log(V) * 1.3
    assert tl[-1] < tl[0] * 0.3, (tl[0], tl[-1])


def test_dot_product_and_multi_head_attention():
    def build(v2):
        layer, networks = v2.layer, v2.networks
        src = layer.data(name="src", type=v2.data_type.dense_vector_sequence(H))
        lab = layer.data(name="y", type=v2.data_type.dense_vector(1))
        state = layer.pool(input=src, pooling_type="average")
        ctx_dot = networks.dot_product_attention(
            encoded_sequence=src, attended_sequence=src,
            transformed_state=state)
        heads = [networks.multi_head_attention(
            query=state, key=src, value=src, key_proj_size=4,
            value_proj_size=4, head_num=2, attention_type=kind)
            for kind in ("dot-product attention", "additive attention")]
        pred = layer.fc(input=layer.concat(input=[ctx_dot] + heads), size=1)
        return layer.mse_cost(input=pred, label=lab)

    jcost, tcost = _both(build)
    rs = np.random.RandomState(1)
    data = [(rs.rand(rs.randint(2, 5), H).tolist(), [float(i % 2)])
            for i in range(4)]
    jl, tl = _train_both(jcost, tcost, ["src", "y"], data, 15, 5e-2)
    _close_losses(tl, jl)
    assert tl[-1] < tl[0] * 0.6, (tl[0], tl[-1])


def _attention_nmt(v2, E=6):
    layer, networks, Param = v2.layer, v2.networks, v2.attr.Param
    src = layer.data(name="src", type=v2.data_type.integer_value_sequence(V))
    emb = layer.embedding(input=src, size=E, param_attr=Param(name="semb"))
    enc = networks.simple_gru(input=emb, size=H)
    proj = layer.fc(input=enc, size=H, bias_attr=False,
                    param_attr=Param(name="proj"))
    boot = layer.fc(input=layer.last_seq(input=enc), size=H,
                    act=v2.activation.Tanh(), param_attr=Param(name="boot"))

    def decoder_step(cur_emb, enc_seq, enc_p, boot):
        mem = layer.memory(name="att_dec", size=H, boot_layer=boot)
        ctx = networks.simple_attention(
            encoded_sequence=enc_seq, encoded_proj=enc_p, decoder_state=mem,
            name="att_head", transform_param_attr=Param(name="transform"),
            softmax_param_attr=Param(name="score"))
        gates = layer.fc(input=layer.concat(input=[cur_emb, ctx]),
                         size=H * 3, bias_attr=False,
                         param_attr=Param(name="gates"))
        h = networks.gru_unit(input=gates, size=H, name="att_dec",
                              gru_param_attr=Param(name="gru"),
                              gru_bias_attr=Param(name="gru.b"))
        return layer.fc(input=h, size=V, act=v2.activation.Softmax(),
                        param_attr=Param(name="out"),
                        bias_attr=Param(name="out.b"))

    trg = layer.data(name="trg", type=v2.data_type.integer_value_sequence(V))
    nxt = layer.data(name="nxt", type=v2.data_type.integer_value_sequence(V))
    trg_emb = layer.embedding(input=trg, size=E, param_attr=Param(name="temb"))
    probs = layer.recurrent_group(
        step=lambda cur, es, ep: decoder_step(cur, es, ep, boot),
        input=[trg_emb, layer.StaticInput(input=enc, is_seq=True),
               layer.StaticInput(input=proj, is_seq=True)])
    cost = layer.classification_cost(input=probs, label=nxt)
    beam = layer.beam_search(
        step=lambda cur, es, ep, b: decoder_step(cur, es, ep, b),
        input=[layer.GeneratedInput(size=V, embedding_name="temb",
                                    embedding_size=E),
               layer.StaticInput(input=enc, is_seq=True),
               layer.StaticInput(input=proj, is_seq=True),
               layer.StaticInput(input=boot)],
        bos_id=0, eos_id=1, beam_size=3, max_length=6)
    return cost, beam


def test_attention_nmt_train_then_beam_generate():
    """tests/test_v2_networks.py:137: train the attention decoder 60
    steps from one state through both packages, then beam-generate with
    simple_attention over the beam-expanded encoder sequence.  From the
    JAX package's trained parameters the port's ids equal the JAX
    package's; through the port's own trained parameters its best beams
    are the taught sequence."""
    (jcost, jbeam), (tcost, tbeam) = _both(_attention_nmt)
    data = [([2, 3, 4], [0, 2, 3], [2, 3, 1]),
            ([5, 4], [0, 2, 3], [2, 3, 1])] * 3
    jl, tl = _train_both(jcost, tcost, ["src", "trg", "nxt"], data, 60,
                         3e-2)
    _close_losses(tl, jl)
    assert tl[-1] < tl[0] * 0.3, (tl[0], tl[-1])
    inputs = [([2, 3, 4],), ([5, 4],)]
    _, own = tpaddle.infer(output_layer=tbeam, input=inputs,
                           field=["prob", "id"])
    seqs = _ids_to_seqs(own)
    assert len(seqs) == 6 and all(s[0] == 0 for s in seqs)
    assert [seqs[0], seqs[3]] == [[0, 2, 3, 1]] * 2, seqs
    jprobs, jids = jpaddle.infer(output_layer=jbeam, input=inputs,
                                 field=["prob", "id"])
    _carry()
    tprobs, tids = tpaddle.infer(output_layer=tbeam, input=inputs,
                                 field=["prob", "id"])
    assert tids == list(jids)
    np.testing.assert_allclose(tprobs, np.asarray(jprobs), rtol=1e-5)


@pytest.mark.parametrize("net", ["small_vgg", "vgg_16_network"])
def test_vgg_builds_and_steps(net):
    """small_vgg and vgg_16_network (32 x 32 images): descs equal, one
    Adam step through the port from the JAX startup's state, a finite
    loss (dropout draws from each package's own stream)."""
    def build(v2):
        img = v2.layer.data(name="img", type=v2.data_type.dense_array(
            3 * 32 * 32, [3, 32, 32]))
        lab = v2.layer.data(name="lbl", type=v2.data_type.integer_value(10))
        probs = getattr(v2.networks, net)(input_image=img, num_channels=3,
                                          num_classes=10)
        return v2.layer.classification_cost(input=probs, label=lab)

    jcost, tcost = _both(build)
    jfluid.optimizer.Adam(learning_rate=1e-2).minimize(jcost)
    tfluid.optimizer.Adam(learning_rate=1e-2).minimize(tcost)
    _descs_equal()
    _, exe = _start_both()
    rs = np.random.RandomState(0)
    data = [(rs.rand(3 * 32 * 32).tolist(), [rs.randint(0, 10)])
            for _ in range(2)]
    loss, = exe.run(feed=_feed(tfluid, ["img", "lbl"], data),
                    fetch_list=[tcost])
    assert np.isfinite(loss).all()


# -- the book's attention NMT (chip_smoke.build_nmt) ---------------------------------

def _nmt_topology(v2, generating, **widths):
    return chip_smoke.build_nmt(v2, generating=generating, **widths)


def _fresh_programs():
    """New default programs for both packages; the scopes stay."""
    from paddle_tpu.fluid import framework as jframework

    for framework in (tframework, jframework):
        framework.switch_main_program(framework.Program())
        framework.switch_startup_program(framework.Program())


def test_nmt_full_width_descs_equal_jax():
    """BASELINE.json configs[3] at the book's widths: the training
    topology with Adam at 5e-5 and L2 at 8e-4 (the regularizer's scale
    and sum ops on every grad), and the generation topology in a fresh
    program: descs equal; the generation step reads only parameters the
    training topology declares (same names), so a trained scope
    decodes."""
    jcost, tcost = _both(lambda v2: _nmt_topology(v2, False))
    for v2, cost in ((jv2, jcost), (tv2, tcost)):
        v2.optimizer.Adam(learning_rate=chip_smoke.NMT_LR,
                          regularization_rate=chip_smoke.NMT_L2) \
            .to_fluid().minimize(cost)
    _descs_equal()
    main = tfluid.default_main_program()
    ops = main.desc.block(0).ops
    params = {p.name: p.shape for p in main.global_block().all_parameters()}
    assert params["_target_language_embedding"] == (30000, 512)
    d, w, h = 30000, 512, 512
    gru = w * 3 * h + 3 * h + h * 3 * h + 3 * h     # fc and gru, one way
    step = h * h + h + 3 * h * (2 * h + w) + h * 3 * h + 3 * h + h * d + d
    assert sum(int(np.prod(s)) for s in params.values()) == \
        2 * d * w + 2 * gru + 2 * h * h + h * h + step
    types = [op.type for op in ops]
    assert types.count("recurrent") == 1 and types.count("gru") == 2
    assert types.count("adam") == len(params)
    decay = [op for op in ops if op.type == "scale"
             and op.attrs.get("scale") == chip_smoke.NMT_L2]
    assert sorted(op.input("X")[0] for op in decay) == sorted(params)
    train_params = set(params)
    _fresh_programs()
    jbeam, tbeam = _both(lambda v2: _nmt_topology(v2, True))
    _descs_equal()
    spec = tbeam._v2_beam_spec
    reads = {n for op in spec.program.desc.block(spec.block_idx).ops
             for n in op.input_names()
             if n in spec.program.global_block().desc.vars
             and spec.program.global_block().desc.vars[n].is_parameter}
    assert reads and reads <= train_params


def _nmt_batches(dict_size, batch, n):
    reader = tpaddle.dataset.wmt14.train(dict_size)
    rows = []
    for sample in reader():
        rows.append(sample)
        if len(rows) == batch * n:
            break
    return [rows[k * batch:(k + 1) * batch] for k in range(n)]


NARROW = {"dict_size": 50, "word": 8, "hidden": 8}


def test_nmt_narrow_two_steps_and_beam_match_jax():
    """The book's NMT at a narrow width (dictionaries of 50, 8 wide):
    2 SGD steps (Adam at 5e-5, L2 8e-4) over the wmt14 reader's first
    batches of 4 through both packages from one state (losses at rtol
    1e-5, each tensor's change in relative L2 at 1e-4); then beam 3 to
    at most 12 tokens from chip_smoke's decode state over the trained
    parameters: ids equal exactly, scores at chip_smoke's atol 5e-3."""
    jcost, tcost = _both(lambda v2: _nmt_topology(v2, False, **NARROW))
    trainers = []
    for v2, cost in ((jv2, jcost), (tv2, tcost)):
        trainers.append(_sgd(v2, cost, v2.optimizer.Adam(
            learning_rate=chip_smoke.NMT_LR,
            regularization_rate=chip_smoke.NMT_L2))[1])
    _descs_equal()
    before = _carry()
    batches = _nmt_batches(50, 4, 2)
    jc = _costs_of(trainers[0], lambda: iter(batches))
    tc = _costs_of(trainers[1], lambda: iter(batches))
    np.testing.assert_allclose(tc, jc, rtol=LOSS_RTOL)
    after_j = {n: np.asarray(jscope.global_scope().get(n)) for n in before}
    after_t = _port_state(before)
    trained = [n for n in before if not np.array_equal(after_j[n],
                                                       before[n])]
    assert len(trained) > 20
    assert _change_rl2(after_t, after_j, {n: before[n] for n in trained}) \
        < CHANGE_RL2

    main = tfluid.default_main_program()
    params = {p.name for p in main.global_block().all_parameters()}
    state = chip_smoke.nmt_decode_state(
        {n: v for n, v in after_j.items() if n in params}, main)
    _fresh_programs()
    jbeam, tbeam = _both(lambda v2: _nmt_topology(
        v2, True, beam_size=3, max_length=12, **NARROW))
    _descs_equal()
    for n, v in state.items():
        jscope.global_scope().set(n, v)
    tfluid.io.params_from_numpy(tscope.global_scope(), state, "cpu")
    inputs = [(s[0],) for s in batches[0]]
    jprobs, jids = jpaddle.infer(output_layer=jbeam, input=inputs,
                                 field=["prob", "id"])
    tprobs, tids = tpaddle.infer(output_layer=tbeam, input=inputs,
                                 field=["prob", "id"])
    assert tids == list(jids)
    # the decode state's logits reach about 1e3 (chip_smoke.NMT_SCORE_ATOL)
    np.testing.assert_allclose(tprobs, np.asarray(jprobs), rtol=0,
                               atol=chip_smoke.NMT_SCORE_ATOL)
    seqs = _ids_to_seqs(tids)
    assert len(seqs) == 12 and len({tuple(s) for s in seqs}) > 3


# -- the rest of the surface ----------------------------------------------------------

def test_v2_surface_matches_jax():
    """The same `__all__` in every v2 module and the same top-level
    names; every layer name is callable."""
    for mod in ("layer", "networks", "evaluator", "data_type",
                "activation", "pooling", "event", "optimizer", "attr",
                "parameters", "trainer", "inference", "image", "plot"):
        assert getattr(tv2, mod).__all__ == getattr(jv2, mod).__all__, mod
    assert set(tv2.__all__) >= set(jv2.__all__)
    for n in tv2.layer.__all__:
        assert callable(getattr(tv2.layer, n)), n
    assert tpaddle.layer is tv2.layer and tpaddle.infer is tv2.infer
    assert tpaddle.v2 is tv2


@pytest.mark.parametrize("name", ["rotate", "maxout", "nce", "priorbox"])
def test_waiting_zoo_names_raise(name):
    """A zoo name whose op the port does not register raises
    NotImplementedError naming the op and its ROADMAP item."""
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        getattr(tv2.layer, name)(None, None)


def test_v2_runs_on_the_card_unless_told():
    """init() without use_gpu=False puts the v2 API on CUDAPlace(0):
    without a CUDA device, making parameters raises."""
    tv2.init()
    assert repr(tconfig._place()) == "CUDAPlace(0)"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cost = _linear(tv2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tv2.parameters.create(cost)


def test_sgd_reports_step_telemetry():
    """The v2 trainer's step span, steps, examples and last-loss gauge
    land in the port's obs registry."""
    from paddle_tpu_torch.obs import registry, telemetry

    registry.reset_registry()
    _, cost = _linear(tv2)
    _, trainer = _sgd(tv2, cost, tv2.optimizer.Momentum(learning_rate=0.01))
    costs = _costs_of(trainer, lambda: iter([[(np.ones(4, "f"),
                                              np.ones(1, "f"))] * 3] * 2))
    snap = telemetry.snapshot()
    assert snap["trainer_steps_total{trainer=v2}"] == 2
    assert snap["trainer_examples_total{trainer=v2}"] == 6
    assert snap["trainer_last_loss{trainer=v2}"] == pytest.approx(costs[-1])
