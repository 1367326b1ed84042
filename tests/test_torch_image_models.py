"""bench.py's other image models, built and trained through the port's
fluid layers against the JAX package's, on the CPU.

- Descs: `mlp`, `lenet5`, `smallnet_mnist_cifar`, `alexnet`, `vgg16`,
  `vgg19` and `googlenet` as `__graft_entry__._build_model` builds them
  (data, the model, softmax_with_cross_entropy, mean, momentum 0.9 at
  lr 0.01) at the channels, image sizes and class counts of
  `paddle_tpu/tune/models.py` (mlp at lenet5's), main and startup,
  equal the JAX package's through `to_dict()`.  Descs only: nothing
  runs.
- Training: 3 momentum steps of `smallnet_mnist_cifar`, `lenet5`, `mlp`
  and a 2-block `vgg` (steps that draw no random numbers) from the JAX
  package's startup state, moved into the port with
  `params_from_numpy`: each loss at atol 1e-5, and every parameter and
  velocity after them at atol 1e-5 times the larger of 1 and the
  largest magnitude in the tensor (f32 on both sides; convolutions and
  products summed in other orders through at most 6 layers.  lenet5's
  first fc sums 800 products per grad, and its velocities reach 4.2,
  where they differ by 2.1e-5, about 40 ulps of 4.2: 4.9e-6 of it).
- `accuracy` after the steps: the layer's Accuracy, Correct and Total
  equal the JAX package's, int32 Correct and Total in a fetch.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu import models as jmodels
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.fluid import io as tio

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

STEPS = 3
ATOL = 1e-5

# name: (builder name, channels, image size, classes), the sizes of
# paddle_tpu/tune/models.py; mlp at lenet5's
DESC_MODELS = {
    "mlp": ("mlp", 1, 28, 10),
    "lenet5": ("lenet5", 1, 28, 10),
    "smallnet": ("smallnet_mnist_cifar", 3, 32, 10),
    "alexnet": ("alexnet", 3, 224, 1000),
    "vgg16": ("vgg16", 3, 224, 1000),
    "vgg19": ("vgg19", 3, 224, 1000),
    "googlenet": ("googlenet", 3, 224, 1000),
}


def _build(fluid, model, batch, channels, hw, with_acc=False):
    """`__graft_entry__._build_model`'s program: (main, startup,
    avg_loss, accuracy or None)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        image = fluid.layers.data(name="image",
                                  shape=[batch, channels, hw, hw],
                                  dtype="float32", append_batch_size=False)
        logits = model(image)
        label = fluid.layers.data(name="label", shape=[batch, 1],
                                  dtype="int64", append_batch_size=False)
        avg_loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        acc = fluid.layers.accuracy(input=logits, label=label) \
            if with_acc else None
        fluid.optimizer.MomentumOptimizer(learning_rate=0.01,
                                          momentum=0.9).minimize(avg_loss)
    return main, startup, avg_loss, acc


@pytest.mark.parametrize("name", sorted(DESC_MODELS))
def test_descs_equal_jax(name):
    builder, channels, hw, classes = DESC_MODELS[name]
    batch = 8

    def model(m):
        return lambda x: getattr(m, builder)(x, class_dim=classes)

    jmain, jstartup, _, _ = _build(jfluid, model(jmodels), batch,
                                   channels, hw)
    tmain, tstartup, _, _ = _build(tfluid, model(tmodels), batch,
                                   channels, hw)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    assert tstartup.desc.to_dict() == jstartup.desc.to_dict()


def test_model_op_types():
    """The new ops sit where the models put them."""
    _, channels, hw, classes = DESC_MODELS["alexnet"]
    main, _, _, _ = _build(
        tfluid, lambda x: tmodels.alexnet(x, class_dim=classes), 2,
        channels, hw, with_acc=True)
    types = [op.type for op in main.desc.block(0).ops]
    assert types.count("lrn") == 2 and types.count("lrn_grad") == 2
    assert types.count("dropout") == 2 and types.count("dropout_grad") == 2
    assert types.count("top_k") == 1 and types.count("accuracy") == 1
    assert "accuracy_grad" not in types and "top_k_grad" not in types


def _vgg2(m):
    """A 2-block VGG: the JAX and port `img_conv_group` at narrow
    widths, then the fc head of `vgg` (no dropout)."""
    def model(x):
        t = x
        for n_convs, ch in ((1, 4), (2, 8)):
            t = m.img_conv_group(
                input=t, conv_num_filter=[ch] * n_convs, pool_size=2,
                pool_stride=2, conv_filter_size=3, conv_act="relu")
        return t
    return model


TRAIN_MODELS = {
    # name: (JAX model fn, port model fn, batch, channels, size)
    "smallnet": (lambda x: jmodels.smallnet_mnist_cifar(x, class_dim=10),
                 lambda x: tmodels.smallnet_mnist_cifar(x, class_dim=10),
                 4, 3, 32),
    "lenet5": (lambda x: jmodels.lenet5(x, class_dim=10),
               lambda x: tmodels.lenet5(x, class_dim=10), 4, 1, 28),
    "mlp": (lambda x: jmodels.mlp(x, class_dim=10),
            lambda x: tmodels.mlp(x, class_dim=10), 4, 1, 28),
    "vgg2": (None, None, 4, 3, 16),
}


def _train_fns(name):
    jm, tm, batch, channels, hw = TRAIN_MODELS[name]
    if name == "vgg2":
        from paddle_tpu.fluid import nets as jnets
        from paddle_tpu_torch.fluid import nets as tnets

        def head(fluid, body):
            def model(x):
                t = body(x)
                t = fluid.layers.fc(input=t, size=16, act="relu")
                t = fluid.layers.fc(input=t, size=16, act="relu")
                return fluid.layers.fc(input=t, size=10)
            return model

        jm = head(jfluid, _vgg2(jnets))
        tm = head(tfluid, _vgg2(tnets))
    return jm, tm, batch, channels, hw


def _feeds(batch, channels, hw, seed=0):
    rs = np.random.RandomState(seed)
    return [{"image": rs.randn(batch, channels, hw, hw).astype(np.float32),
             "label": rs.randint(0, 10, (batch, 1)).astype(np.int64)}
            for _ in range(STEPS)]


@pytest.mark.parametrize("name", sorted(TRAIN_MODELS))
def test_three_momentum_steps_match_jax(name):
    jm, tm, batch, channels, hw = _train_fns(name)
    feeds = _feeds(batch, channels, hw)
    jmain, jstartup, jloss, jacc = _build(jfluid, jm, batch, channels, hw,
                                          with_acc=True)
    acc_op = next(op for op in jmain.desc.block(0).ops
                  if op.type == "accuracy")
    counts = acc_op.outputs["Correct"] + acc_op.outputs["Total"]
    persist = [n for n, v in jmain.desc.block(0).vars.items()
               if v.persistable]
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = JScope()
    with jfluid.scope_guard(scope):
        exe.run(jstartup)
        init = {n: np.array(scope.get(n)) for n in persist}
        jouts = [exe.run(jmain, feed=f, fetch_list=[jloss, jacc] + counts)
                 for f in feeds]
        jfinal = {n: np.array(scope.get(n)) for n in persist}

    tmain, _, tloss, tacc = _build(tfluid, tm, batch, channels, hw,
                                   with_acc=True)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    tio.params_from_numpy(tscope, init, "cpu")
    touts = [texe.run(tmain, feed=f, fetch_list=[tloss, tacc] + counts,
                      scope=tscope)
             for f in feeds]
    for jo, to in zip(jouts, touts):
        np.testing.assert_allclose(to[0], jo[0], atol=ATOL, rtol=0)
        # accuracy: f32 [1], Correct and Total int32 [1], equal
        assert to[1].dtype == np.float32 and to[1].shape == (1,)
        np.testing.assert_array_equal(to[1], np.asarray(jo[1]))
        for t, j in zip(to[2:], jo[2:]):
            assert t.dtype == np.int32 and t.shape == (1,)
            np.testing.assert_array_equal(t, np.asarray(j))
        assert int(to[3][0]) == batch
    moved = 0
    for n, want in jfinal.items():
        got = tscope.get(n).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, n
        np.testing.assert_allclose(
            got, want, atol=ATOL * max(1.0, float(np.abs(want).max())),
            rtol=0, err_msg=n)
        moved += not np.array_equal(want, init[n])
    assert moved >= len(jfinal) // 2
