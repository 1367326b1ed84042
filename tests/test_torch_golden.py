"""The port's program builder against the pinned golden programs.

`tests/fixtures/golden/{fit_a_line,conv_classifier,transformer,
dynamic_rnn,deepfm}.json` are the JAX package's serialized ProgramDescs
of the builders in `tests/test_golden_programs.py` (the five whose ops
the port has; `dynamic_rnn` has a step sub-block).  The port's
`fluid.layers` run the same builder code, and each program serializes
equal to its JSON, exactly (descs are data).  This file reads the
fixtures and imports nothing of JAX.  The port then trains on the
programs it built: fit-a-line's loss falls under SGD, and the others
take a finite step.
"""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.core.ragged import RaggedTensor
from paddle_tpu_torch.models.ctr import deepfm_ctr
from paddle_tpu_torch.models.transformer_program import (
    build_transformer_program, transformer_feeds)

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "golden")


def _defaults(loss):
    return (fluid.default_main_program().desc,
            fluid.default_startup_program().desc, loss.name)


def _fit_a_line():
    x = fluid.layers.data(name="x", shape=[13], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(input=x, size=1)
    loss = fluid.layers.mean(
        x=fluid.layers.square_error_cost(input=pred, label=y))
    fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return _defaults(loss)


def _conv_classifier():
    img = fluid.layers.data(name="img", shape=[1, 28, 28], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    conv = fluid.layers.conv2d(input=img, num_filters=8, filter_size=3,
                               act="relu")
    pool = fluid.layers.pool2d(input=conv, pool_size=2, pool_stride=2)
    logits = fluid.layers.fc(input=pool, size=10, act="softmax")
    loss = fluid.layers.mean(
        x=fluid.layers.cross_entropy(input=logits, label=label))
    fluid.optimizer.MomentumOptimizer(learning_rate=0.01,
                                      momentum=0.9).minimize(loss)
    return _defaults(loss)


def _transformer():
    main, startup, loss, _ = build_transformer_program(
        2, 8, 32, n_layer=1, n_head=2, d_model=16, sp_axis="sp")
    fluid.optimizer.MomentumOptimizer(learning_rate=0.01,
                                      momentum=0.9).minimize(loss, main,
                                                             startup)
    return main, startup, loss


def _dynamic_rnn():
    x = fluid.layers.data(name="x", shape=[8], dtype="float32",
                          lod_level=1)
    drnn = fluid.layers.DynamicRNN()
    with drnn.block():
        step = drnn.step_input(x)
        mem = drnn.memory(shape=[8], batch_ref=step, value=0.0)
        h = fluid.layers.fc(input=[step, mem], size=8, act="tanh")
        drnn.update_memory(mem, h)
        drnn.output(h)
    last = fluid.layers.sequence_last_step(input=drnn())
    loss = fluid.layers.mean(x=last)
    fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return _defaults(loss)


def _deepfm():
    ids = fluid.layers.data(name="ids", shape=[4], dtype="int64")
    label = fluid.layers.data(name="label", shape=[1], dtype="float32")
    loss, _ = deepfm_ctr(ids, label, num_features=64, num_fields=4,
                         embed_dim=4, hidden_sizes=(8,))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return _defaults(loss)


CASES = {"fit_a_line": _fit_a_line, "conv_classifier": _conv_classifier,
         "transformer": _transformer, "dynamic_rnn": _dynamic_rnn,
         "deepfm": _deepfm}


def _build(case):
    """(main desc, startup desc, loss name) of `case`, built into fresh
    default programs."""
    with fluid.program_guard(fluid.Program(), fluid.Program()):
        return CASES[case]()


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_builds_the_golden_program(case):
    desc, _, _ = _build(case)
    with open(os.path.join(GOLDEN_DIR, case + ".json")) as f:
        want = json.load(f)
    got = json.loads(json.dumps(desc.to_dict(), sort_keys=True))
    assert got == want


def _feeds(case, step):
    rs = np.random.RandomState(step)
    if case == "fit_a_line":
        x = rs.randn(20, 13).astype(np.float32)
        return {"x": x, "y": (x[:, :1] * 2.0 - 1.0).astype(np.float32)}
    if case == "conv_classifier":
        return {"img": rs.rand(8, 1, 28, 28).astype(np.float32),
                "label": rs.randint(0, 10, (8, 1)).astype(np.int64)}
    if case == "dynamic_rnn":
        return {"x": RaggedTensor.from_sequences(
            [rs.randn(n, 8).astype(np.float32) for n in (3, 1, 5)],
            bucket=16)}
    if case == "deepfm":
        return {"ids": rs.randint(0, 64, (8, 4)).astype(np.int64),
                "label": rs.randint(0, 2, (8, 1)).astype(np.float32)}
    return transformer_feeds(2, 8, 32, seed=step, targets=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_trains_the_golden_program(case):
    main, startup, loss = _build(case)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    steps = 30 if case == "fit_a_line" else 2
    losses = [float(exe.run(main, feed=_feeds(case, 0 if case ==
                                              "fit_a_line" else s),
                            fetch_list=[loss], scope=scope)[0][0])
              for s in range(steps)]
    assert np.isfinite(losses).all()
    if case == "fit_a_line":
        assert losses[-1] < 0.5 * losses[0]
