"""The NHWC relayout (`fluid.convert_layout`, fluid/data_transform.py)
of the port against the JAX package's pass, on the CPU.

- On ResNet-50 (batch 2, 3 x 32 x 32, 10 classes) and a conv-pool-bn
  net: the rewritten descs equal the JAX package's through `to_dict()`,
  with the same count of inserted transposes and the same `layout_out`;
  the backward and Momentum appended after it too.
- 3 Momentum steps of the conv-pool-bn net in NHWC from the JAX
  package's initial state: each loss and every parameter, velocity and
  running statistic after them within 1e-5 of the JAX package's NHWC
  steps (f32 on both sides, sums in other orders); and within 1e-5 of
  the port's own NCHW steps (the transposes are exact, the convolutions
  and pools the same sums in another memory order).
- An NHWC `conv2d` hands the convolution channels-last operands; the
  pass refuses a program with grad ops and any layout but NHWC.
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.models as jmodels
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.fluid.data_transform import convert_layout as j_convert
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.models as tmodels
from paddle_tpu_torch.fluid import data_transform

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

ATOL = 1e-5
STEPS = 3


def _convnet(fluid, models):
    """conv(+bias) -> bn(relu) -> max pool -> conv(relu) -> global avg
    pool -> fc -> softmax cross entropy over 4 images of 3 x 8 x 8."""
    image = fluid.layers.data(name="image", shape=[4, 3, 8, 8],
                              dtype="float32", append_batch_size=False)
    label = fluid.layers.data(name="label", shape=[4, 1], dtype="int64",
                              append_batch_size=False)
    t = fluid.layers.conv2d(input=image, num_filters=8, filter_size=3,
                            padding=1)
    t = fluid.layers.batch_norm(input=t, act="relu")
    t = fluid.layers.pool2d(input=t, pool_size=2, pool_stride=2)
    t = fluid.layers.conv2d(input=t, num_filters=16, filter_size=3,
                            padding=1, act="relu", bias_attr=False)
    t = fluid.layers.pool2d(input=t, pool_size=4, pool_type="avg",
                            global_pooling=True)
    logits = fluid.layers.fc(input=t, size=10)
    return fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))


def _resnet50(fluid, models):
    image = fluid.layers.data(name="image", shape=[3, 32, 32],
                              dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    logits = models.resnet50(image, class_dim=10)
    return fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))


NETS = {"convnet": _convnet, "resnet50": _resnet50}


def _build(fluid, models, net, nhwc, train=True):
    """(main, startup, loss, transposes inserted, layout_out)."""
    convert = j_convert if fluid is jfluid else tfluid.convert_layout
    main, startup = fluid.Program(), fluid.Program()
    layout_out = {}
    with fluid.program_guard(main, startup):
        loss = NETS[net](fluid, models)
        n = convert(main, layout_out=layout_out) if nhwc else 0
        if train:
            fluid.optimizer.MomentumOptimizer(
                learning_rate=0.1, momentum=0.9).minimize(loss)
    return main, startup, loss, n, layout_out


@pytest.mark.parametrize("net", sorted(NETS))
def test_rewrite_equals_jax(net):
    jmain, jstartup, _, jn, jlayout = _build(jfluid, jmodels, net, True)
    tmain, tstartup, _, tn, tlayout = _build(tfluid, tmodels, net, True)
    assert tn == jn > 0 and tlayout == jlayout
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    assert tstartup.desc.to_dict() == jstartup.desc.to_dict()
    types = [op.type for op in tmain.desc.block(0).ops]
    assert all(op.attr("data_layout") == "NHWC"
               for op in tmain.desc.block(0).ops
               if op.type in ("conv2d", "pool2d", "batch_norm"))
    # the framework's op views follow the rewritten desc
    assert [op.type for op in tmain.global_block().ops] == types


def test_forward_rewrite_count_and_layout_out():
    jmain, _, _, jn, jlayout = _build(jfluid, jmodels, "resnet50", True,
                                      train=False)
    tmain, _, _, tn, tlayout = _build(tfluid, tmodels, "resnet50", True,
                                      train=False)
    assert tn == jn and tlayout == jlayout
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    # into NHWC at the first conv, back to NCHW at the fc: 2 boundaries
    _, _, _, n, layout = _build(tfluid, tmodels, "convnet", True,
                                train=False)
    assert n == 2 and "image@NHWC" in layout


def _feeds(step):
    rs = np.random.RandomState(step)
    return {"image": rs.rand(4, 3, 8, 8).astype(np.float32),
            "label": rs.randint(0, 10, size=(4, 1)).astype(np.int64)}


def _jax_steps(nhwc):
    main, startup, loss, _, _ = _build(jfluid, jmodels, "convnet", nhwc)
    persist = [n for n, v in main.desc.block(0).vars.items()
               if v.persistable]
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.array(scope.get(n)) for n in persist}
        losses = [float(np.asarray(exe.run(main, feed=_feeds(s),
                                           fetch_list=[loss])[0]).ravel()[0])
                  for s in range(STEPS)]
        final = {n: np.array(scope.get(n)) for n in persist}
    return init, losses, final


def _port_steps(nhwc, init):
    main, _, loss, _, _ = _build(tfluid, tmodels, "convnet", nhwc)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.io.params_from_numpy(scope, init, "cpu")
    losses = [float(exe.run(main, feed=_feeds(s), fetch_list=[loss],
                            scope=scope)[0].ravel()[0])
              for s in range(STEPS)]
    return losses, {n: scope.get(n).numpy() for n in init}


def test_three_nhwc_momentum_steps_match_jax():
    init, jlosses, jfinal = _jax_steps(nhwc=True)
    losses, final = _port_steps(True, init)
    np.testing.assert_allclose(losses, jlosses, atol=ATOL, rtol=0)
    assert final.keys() == jfinal.keys()
    for name, want in jfinal.items():
        np.testing.assert_allclose(final[name], want, atol=ATOL, rtol=0,
                                   err_msg=name)
    nchw_losses, nchw_final = _port_steps(False, init)
    np.testing.assert_allclose(losses, nchw_losses, atol=ATOL, rtol=0)
    for name, want in nchw_final.items():
        np.testing.assert_allclose(final[name], want, atol=ATOL, rtol=0,
                                   err_msg=name)


def test_nhwc_conv_runs_channels_last(monkeypatch):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import conv

    seen = []
    real = F.conv2d

    def spy(x, w, *a, **kw):
        seen.append((x.is_contiguous(memory_format=torch.channels_last),
                     w.is_contiguous(memory_format=torch.channels_last)))
        return real(x, w, *a, **kw)

    monkeypatch.setattr(conv.F, "conv2d", spy)
    x = torch.randn(2, 8, 8, 3).permute(0, 3, 1, 2).permute(0, 2, 3, 1)
    view = torch.randn(2, 3, 8, 8).permute(0, 2, 3, 1)  # a transpose op's
    w = torch.randn(4, 3, 3, 3)
    outs = [conv.conv2d(None, {"Input": [v], "Filter": [w]},
                        {"data_layout": "NHWC", "paddings": [1, 1]})
            ["Output"][0] for v in (x, view)]
    assert seen == [(True, True), (True, True)]
    for v, out in zip((x, view), outs):
        want = real(v.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
        assert out.is_contiguous()  # NHWC memory, as the layout says


def test_refusals():
    main, _, _, _, _ = _build(tfluid, tmodels, "convnet", False)
    with pytest.raises(ValueError, match="append_backward"):
        tfluid.convert_layout(main)
    main, _, _, _, _ = _build(tfluid, tmodels, "convnet", False,
                              train=False)
    with pytest.raises(ValueError, match="NHWC"):
        data_transform.convert_layout(main, to="NCHW")
    assert data_transform.LAYOUT_CAPABLE == (
        "conv2d", "conv2d_transpose", "pool2d", "batch_norm")
    from paddle_tpu.fluid import data_transform as jdt

    assert data_transform.LAYOUT_AGNOSTIC == jdt.LAYOUT_AGNOSTIC
