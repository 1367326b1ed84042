"""examples/train_image_classification.py's flow through the port, on
the CPU at a small batch: `smallnet_mnist_cifar` on the synthetic
CIFAR-10 reader under bf16 AMP, fed through `DataFeeder`,
`batch(shuffle(...))` and `device_prefetch`, with `layers.accuracy`;
a `CheckpointSaver` snapshot after step 2 restored by `load_checkpoint`
into a fresh scope and executor gives step 3 the same loss and accuracy
as the run that was not interrupted (equal: the same ops on the same
state and feed), and a snapshot torn by a fault is skipped.  The first
step's loss is held to the JAX package's under its bf16 policy on the
same feed and state, at atol 2e-2 (bf16 rounds every activation, at
points that differ between the packages; the loss is about 5.7, and
they read 7.2e-3 apart).
"""

import random

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.fluid as jfluid
from paddle_tpu import models as jmodels
from paddle_tpu.core.scope import Scope as JScope
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.fluid import checkpoint as tckpt
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.reader import device_prefetch
from paddle_tpu_torch.resilience import faults

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

BATCH, STEPS, SAVE_AT = 8, 3, 2
CPU = tfluid.CPUPlace()
AMP_LOSS_ATOL = 2e-2


def _build(fluid, models):
    """The example's program, built under the bf16 policy as the
    example builds it after `fluid.amp.enable_bf16()`."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.amp.bf16_guard(), fluid.program_guard(main, startup):
        image = fluid.layers.data(name="image", shape=[3, 32, 32],
                                  dtype="float32")
        logits = models.smallnet_mnist_cifar(image, class_dim=10)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss = fluid.layers.mean(x=fluid.layers.softmax_with_cross_entropy(
            logits=logits, label=label))
        acc = fluid.layers.accuracy(input=fluid.layers.softmax(logits),
                                    label=label)
        fluid.optimizer.MomentumOptimizer(
            learning_rate=0.01, momentum=0.9).minimize(loss)
    return main, startup, image, label, loss, acc


def _port_feeds(main, image, label):
    feeder = tfluid.DataFeeder(place=CPU, feed_list=[image, label],
                               program=main)
    random.seed(0)
    train_reader = tpaddle.batch(
        tpaddle.reader.shuffle(tpaddle.dataset.cifar.train10(),
                               buf_size=2048), batch_size=BATCH)
    feeds = device_prefetch(
        lambda: (feeder.feed(d) for d in train_reader()), place=CPU)
    out = []
    for feed in feeds():
        out.append(feed)
        if len(out) == STEPS:
            break
    return out


def test_example_flow_resumes_from_a_checkpoint(tmp_path):
    main, startup, image, label, loss, acc = _build(tfluid, tmodels)
    feeds = _port_feeds(main, image, label)
    assert feeds[0]["image"].shape == (BATCH, 3, 32, 32)
    assert feeds[0]["label"].dtype == torch.int32
    root = str(tmp_path)
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    saver = tckpt.CheckpointSaver(root, main_program=main)
    fetched = []
    with tfluid.amp.bf16_guard():
        for step, feed in enumerate(feeds, 1):
            fetched.append(exe.run(main, feed=feed, fetch_list=[loss, acc],
                                   scope=scope))
            if step == SAVE_AT:
                saver.save(step, scope)
                saver.wait()
                # a later snapshot torn before its manifest
                faults.enable(seed=0)
                try:
                    faults.inject("checkpoint/manifest", "io_error",
                                  times=None)
                    saver.save(step + 1, scope)
                    with pytest.raises(faults.InjectedIOError):
                        saver.wait()
                finally:
                    faults.disable()
    losses = [float(f[0][0]) for f in fetched]
    assert all(np.isfinite(losses)) and all(0 <= f[1][0] <= 1
                                            for f in fetched)
    assert fetched[0][1].dtype == np.float32

    exe2, scope2 = tfluid.Executor(CPU), tfluid.Scope()
    exe2.run(startup, scope=scope2)
    assert tckpt.load_checkpoint(root, scope2, place=CPU) == SAVE_AT
    with tfluid.amp.bf16_guard():
        resumed = exe2.run(main, feed=feeds[SAVE_AT],
                           fetch_list=[loss, acc], scope=scope2)
    np.testing.assert_array_equal(resumed[0], fetched[SAVE_AT][0])
    np.testing.assert_array_equal(resumed[1], fetched[SAVE_AT][1])


def test_example_first_step_against_jax():
    jmain, jstartup, _, _, jloss, jacc = _build(jfluid, jmodels)
    tmain, _, image, label, loss, acc = _build(tfluid, tmodels)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    feed = _port_feeds(tmain, image, label)[0]
    np_feed = {"image": feed["image"].numpy(),
               "label": feed["label"].numpy().astype(np.int64)}
    # the same first batch from the JAX package's reader stack
    random.seed(0)
    jbatch = next(jpaddle.batch(jpaddle.reader.shuffle(
        jpaddle.dataset.cifar.train10(), buf_size=2048), BATCH)())
    np.testing.assert_array_equal(
        np_feed["image"], np.stack([s[0] for s in jbatch]).reshape(
            BATCH, 3, 32, 32))
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    with jfluid.scope_guard(jscope), jfluid.amp.bf16_guard():
        jexe.run(jstartup)
        init = {v.name: np.array(jscope.get(v.name))
                for v in jmain.list_vars()
                if v.persistable and jscope.get(v.name) is not None}
        jout = jexe.run(jmain, feed=np_feed, fetch_list=[jloss, jacc])
    scope = tfluid.Scope()
    tio.params_from_numpy(scope, init, "cpu")
    with tfluid.amp.bf16_guard():
        tout = tfluid.Executor(CPU).run(tmain, feed=feed,
                                        fetch_list=[loss, acc], scope=scope)
    np.testing.assert_allclose(tout[0], np.asarray(jout[0]),
                               atol=AMP_LOSS_ATOL, rtol=0)
