"""The port's program builder (paddle_tpu_torch.fluid.framework, the
layer helper, the initializers and `fluid.io.prune_program`) against the
JAX package's.

- Program, Block, Variable and Parameter behaviour, per-program
  `unique_name` counters and `program_guard`.
- Shape inference: the port runs each op's kernel on meta tensors where
  the JAX side runs `jax.eval_shape`; the VarDescs (shape, dtype, -1
  dims, the grad vars after `append_backward`) equal the JAX package's
  through `to_dict()` for programs built by the same layer calls.
- `clone(for_test=True)` and `prune_program`, the executor's Program
  and Variable arguments, and the errors of a bad build.

All desc comparisons are exact (descs are data).
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import io as jio
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import framework as tfw
from paddle_tpu_torch.fluid import io as tio

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)


def _build_both(forward, backward=True, optimizer=None):
    """forward(fluid) -> loss Variable (or a list of targets), built by
    each package into fresh programs; returns ((jmain, jstartup, jout),
    (tmain, tstartup, tout))."""
    out = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            loss = forward(fluid)
            if optimizer is not None:
                optimizer(fluid).minimize(loss)
            elif backward:
                fluid.backward.append_backward(loss)
        out.append((main, startup, loss))
    return out


def _fc_dynamic_batch(fluid):
    x = fluid.layers.data(name="x", shape=[4, 6], dtype="float32")
    h = fluid.layers.fc(input=x, size=5, num_flatten_dims=2, act="relu")
    h = fluid.layers.layer_norm(h, begin_norm_axis=1)
    return fluid.layers.mean(fluid.layers.reshape(x=h, shape=[-1, 10]))


def _conv_pool_bn(fluid):
    img = fluid.layers.data(name="img", shape=[3, 12, 12], dtype="float32")
    t = fluid.layers.conv2d(input=img, num_filters=4, filter_size=3,
                            stride=2, padding=1, act="relu")
    t = fluid.layers.batch_norm(input=t, act="relu")
    t = fluid.layers.pool2d(input=t, pool_size=3, pool_stride=2,
                            pool_padding=1, pool_type="avg")
    t = fluid.layers.pool2d(input=t, pool_size=2, global_pooling=True)
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    logits = fluid.layers.fc(input=t, size=3)
    return fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))


def _split_embedding_arithmetic(fluid):
    ids = fluid.layers.data(name="ids", shape=[5], dtype="int64")
    e = fluid.layers.embedding(ids, size=[20, 6])
    a, b = fluid.layers.split(e, num_or_sections=[2, 4], dim=-1)
    s = fluid.layers.softmax(fluid.layers.fc(input=b, size=2,
                                             num_flatten_dims=2))
    t = (s * 2.0 - a) / (a + 3.0)
    return fluid.layers.mean(fluid.layers.scale(t, scale=0.5))


def _fixed_batch_attention(fluid):
    x = fluid.layers.data(name="x", shape=[2, 8, 16], dtype="float32",
                          append_batch_size=False)
    q, k, v = fluid.layers.split(fluid.layers.fc(
        input=x, size=48, num_flatten_dims=2), num_or_sections=3, dim=2)
    o = fluid.layers.flash_attention(q, k, v, num_heads=2, causal=True)
    return fluid.layers.mean(fluid.layers.cross_entropy(
        fluid.layers.softmax(fluid.layers.reshape(o, [-1, 16])),
        fluid.layers.fill_constant([16, 1], "int64", 3)))


FORWARDS = [_fc_dynamic_batch, _conv_pool_bn, _split_embedding_arithmetic,
            _fixed_batch_attention]


@pytest.mark.parametrize("forward", FORWARDS,
                         ids=lambda f: f.__name__.lstrip("_"))
def test_inferred_descs_equal_jax(forward):
    (jmain, jstartup, _), (tmain, tstartup, _) = _build_both(forward)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    assert tstartup.desc.to_dict() == jstartup.desc.to_dict()
    grads = [v for v in tmain.desc.block(0).vars.values()
             if v.name.endswith("@GRAD")]
    assert grads


def test_dynamic_dims_are_inferred_as_minus_one():
    (_, _, _), (tmain, _, _) = _build_both(_conv_pool_bn, backward=False)
    v = tmain.desc.block(0).vars
    assert v["conv2d_0.tmp_0"].shape == (-1, 4, 6, 6)
    assert v["pool2d_0.tmp_0"].shape == (-1, 4, 3, 3)
    assert v["pool2d_1.tmp_0"].shape == (-1, 4, 1, 1)
    assert v["fc_0.w_0"].shape == (4, 3)
    assert v["softmax_with_cross_entropy_0.tmp_1"].shape == (-1, 1)
    assert v["mean_0.tmp_0"].shape == (1,)


@pytest.mark.parametrize("optimizer", [
    lambda f: f.optimizer.SGD(learning_rate=0.1),
    lambda f: f.optimizer.MomentumOptimizer(learning_rate=0.1,
                                            momentum=0.5,
                                            use_nesterov=True)],
    ids=["sgd", "nesterov"])
def test_optimizer_descs_equal_jax(optimizer):
    def forward(fluid):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32")
        slow = fluid.ParamAttr(name="slow_w", learning_rate=0.5)
        h = fluid.layers.fc(input=x, size=4, param_attr=slow, act="tanh")
        frozen = fluid.ParamAttr(name="frozen_w", trainable=False)
        h = fluid.layers.fc(input=h, size=2, param_attr=frozen)
        return fluid.layers.mean(x=h)

    (jmain, jstartup, _), (tmain, tstartup, _) = _build_both(
        forward, optimizer=optimizer)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    assert tstartup.desc.to_dict() == jstartup.desc.to_dict()
    types = [op.type for op in tmain.desc.block(0).ops]
    assert "scale" in types               # slow_w's learning rate
    assert not any(op.input("Param") == ["frozen_w"]
                   for op in tmain.desc.block(0).ops)


def test_program_block_variable():
    prog = tfluid.Program()
    block = prog.global_block()
    v = block.create_var(name="v", shape=[2, 3], dtype="float64")
    assert (v.name, v.shape, v.dtype) == ("v", (2, 3), "float64")
    assert block.var("v") is v and block.has_var("v")
    with pytest.raises(ValueError):
        block.var("missing")
    # found again: the given fields update the same VarDesc
    again = block.create_var(name="v", shape=[4, 3], persistable=True)
    assert again.desc is v.desc and v.shape == (4, 3) and v.persistable
    v.stop_gradient = True
    assert v.desc.stop_gradient
    p = block.create_parameter(name="w", shape=[3, 2], dtype="float32")
    assert isinstance(p, tfluid.Parameter) and p.persistable
    assert p.desc.is_parameter and block.all_parameters() == [p]
    with pytest.raises(ValueError):
        block.create_parameter(name="bad", shape=[-1, 2], dtype="float32")
    # a Program over a desc built elsewhere finds its parameters
    wrapped = tfluid.Program.from_desc(prog.desc)
    assert [q.name for q in wrapped.global_block().all_parameters()] \
        == ["w"]
    assert wrapped.desc is prog.desc


def test_unique_name_counts_per_program():
    a, b = tfluid.Program(), tfluid.Program()
    assert tfluid.unique_name("fc", program=a) == "fc_0"
    assert tfluid.unique_name("fc", program=a) == "fc_1"
    assert tfluid.unique_name("fc", program=b) == "fc_0"
    with tfluid.program_guard(b):
        assert tfluid.default_main_program() is b
        assert tfluid.unique_name("fc") == "fc_1"
        x = tfluid.layers.data(name="x", shape=[2])
        # the layer takes the next name of the same counter
        assert tfluid.layers.fc(input=x, size=2).name == "fc_2.tmp_1"
    assert tfluid.default_main_program() is not b


def test_program_guard_restores_on_error():
    main, startup = tfluid.Program(), tfluid.Program()
    before = (tfluid.default_main_program(),
              tfluid.default_startup_program())
    with pytest.raises(RuntimeError):
        with tfluid.program_guard(main, startup):
            assert tfluid.default_startup_program() is startup
            raise RuntimeError
    assert (tfluid.default_main_program(),
            tfluid.default_startup_program()) == before


def test_clone_for_test():
    (jmain, _, _), (tmain, _, _) = _build_both(_conv_pool_bn,
                                               backward=False)
    jclone, tclone = jmain.clone(for_test=True), tmain.clone(for_test=True)
    assert tclone.desc.to_dict() == jclone.desc.to_dict()
    bn = [op for op in tclone.desc.block(0).ops if op.type == "batch_norm"]
    assert bn[0].attrs["is_test"]
    assert not [op for op in tmain.desc.block(0).ops
                if op.type == "batch_norm"][0].attrs["is_test"]
    assert tclone.desc is not tmain.desc
    # building goes on in the clone without a name collision
    with tfluid.program_guard(tclone):
        x = tfluid.layers.data(name="z", shape=[3])
        assert tfluid.layers.fc(input=x, size=1).name == "fc_1.tmp_1"
    assert "fc_1.tmp_1" not in tmain.desc.block(0).vars


def test_prune_program_equals_jax():
    def forward(fluid):
        img = fluid.layers.data(name="img", shape=[3, 8, 8])
        t = fluid.layers.conv2d(input=img, num_filters=4, filter_size=3)
        t = fluid.layers.batch_norm(input=t, act="relu")
        logits = fluid.layers.fc(input=t, size=5)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.MomentumOptimizer(0.01, 0.9).minimize(loss)
        return logits

    (jmain, _, jlogits), (tmain, _, tlogits) = _build_both(
        forward, backward=False)
    jp = jio.prune_program(jmain, [jlogits])
    tp = tio.prune_program(tmain, [tlogits])
    assert tp.desc.to_dict() == jp.desc.to_dict()
    ops = [op.type for op in tp.desc.block(0).ops]
    assert ops == ["conv2d", "elementwise_add", "batch_norm", "relu", "mul",
                   "elementwise_add"]
    assert tp.desc.block(0).ops[2].attrs["is_test"]
    # the same through the main program's desc and a target name
    again = tio.prune_program(tmain.desc, [tlogits.name])
    assert again.desc.to_dict() == tp.desc.to_dict()
    with tfluid.program_guard(tmain):
        assert tio.get_inference_program(tlogits).desc.to_dict() \
            == tp.desc.to_dict()
    for bad in ("img", "nowhere"):
        with pytest.raises(ValueError):
            jio.prune_program(jmain, [bad])
        with pytest.raises(ValueError):
            tio.prune_program(tmain, [bad])


def test_executor_takes_programs_and_variables():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[3])
        y = tfluid.layers.fc(input=x, size=2,
                             param_attr=tfluid.initializer.Constant(0.5))
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        with tfluid.scope_guard(scope):
            exe.run(startup)
            out, = exe.run(feed={"x": np.ones((4, 3), np.float32)},
                           fetch_list=[y])
            again, = exe.run(main.desc, feed={"x": np.ones((4, 3),
                                                           np.float32)},
                             fetch_list=[y.name])
    np.testing.assert_array_equal(out, np.full((4, 2), 1.5, np.float32))
    np.testing.assert_array_equal(again, out)
    with pytest.raises(TypeError):
        exe.run("not a program")


def test_bad_shapes_raise_infer_shape_error():
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        x = tfluid.layers.data(name="x", shape=[4])
        w = tfluid.layers.create_parameter([5, 2], "float32")
        with pytest.raises(tfw.InferShapeError) as err:
            tfluid.default_main_program().global_block().append_op(
                type="mul", inputs={"X": [x], "Y": [w]},
                outputs={"Out": [tfluid.layers.create_tensor("float32")]})
    assert err.value.op_type == "mul" and "mul" in str(err.value)


def test_initializers_equal_jax():
    def forward(fluid):
        init = fluid.initializer
        x = fluid.layers.data(name="x", shape=[2, 6, 6])
        for i, attr in enumerate([init.Uniform(-0.5, 0.5, seed=3),
                                  init.Normal(1.0, 0.1),
                                  init.Xavier(uniform=False),
                                  init.MSRA(), init.MSRA(uniform=False),
                                  init.Constant(0.25)]):
            x = fluid.layers.conv2d(input=x, num_filters=2, filter_size=1,
                                    param_attr=attr,
                                    name="conv%d" % i)
        return fluid.layers.mean(x)

    (_, jstartup, _), (_, tstartup, _) = _build_both(forward,
                                                     backward=False)
    assert tstartup.desc.to_dict() == jstartup.desc.to_dict()
    types = [op.type for op in tstartup.desc.block(0).ops]
    assert types.count("gaussian_random") == 3
    assert types.count("uniform_random") == 2


def test_gaussian_random_statistics_and_seed():
    prog = tfluid.Program()
    block = prog.global_block()
    for name, seed in (("a", 0), ("b", 5), ("c", 5)):
        v = block.create_var(name=name, shape=[256, 256], persistable=True)
        tfluid.initializer.Normal(0.5, 2.0, seed)(v, block)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(prog, scope=scope)
    a = scope.get("a")
    assert tuple(a.shape) == (256, 256) and a.dtype == torch.float32
    # 65536 draws: the mean's standard error is 2 / 256
    assert abs(float(a.mean()) - 0.5) < 5 * 2.0 / 256
    assert abs(float(a.std()) - 2.0) < 0.05
    assert torch.equal(scope.get("b"), scope.get("c"))
    assert not torch.equal(scope.get("b"), a)
