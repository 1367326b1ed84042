"""The first two op groups of A10 — ops/nn.py's 5 types,
`conv2d_transpose`, the six losses and the three metrics — with the
layers and evaluators they let in: the port against the JAX package, on
the CPU, on inputs made from a numpy seed.

- Every case of `chip_smoke.cli_op_cases()` (which phase 18e also runs
  on the card), at the reference tests' shapes: each op through both
  executors' `apply_op`, and its grad (the port's generic vjp against the
  JAX generic vjp) with the same output grads.  Outputs within F32_ATOL
  of the larger of 1 and the reference's magnitude (the same f32
  arithmetic in other orders and other libm); the metrics' outputs and
  `cast_embedding_ids` exactly: auc's counts and area at scores equal
  to its thresholds, precision_recall's states and rates,
  positive_negative_pair's tied and weighted pairs.  The losses' grads
  at their ties (hinge and margin_rank at 0, huber at |r| = delta,
  modified huber at z = +-1) are the JAX grads.
- `auc`'s thresholds are the f32 values of `jnp.linspace(0, 1, n)`.
- `nce`: the cost and logits of `nce_cost` and the grad of `nce_grad`,
  fed the JAX op's own `SampleLabels`, against the JAX op's outputs and
  grad kernel (F32_ATOL); the port's draw from its random stream starts
  with the labels and is uniform over the classes (each class's count
  within 6 standard deviations); tests/test_op_coverage.py's nce
  training flow through the port.
- `conv2d_transpose` under `fluid.amp.bf16_guard()`
  (tests/test_amp_bf16.py::test_bf16_conv_transpose_grad): finite, f32
  grads of the input's shape, within bf16 rounding of the JAX package's;
  its registration asks for deterministic cuDNN.
- The descs of `fluid.layers.nce`, `lstm_unit` and `conv2d_transpose`,
  and of v2's `nce`, `conv_shift`, `tensor`, `rank_cost`,
  `huber_regression_cost` and `huber_classification_cost`, equal the
  JAX package's; the v2 layers' outputs from the JAX startup's state
  equal the JAX package's.
- tests/test_evaluators.py's v2 evaluator flows (precision_recall with a
  positive label and macro/micro, the auc evaluator) and a pnpair
  evaluator through both packages: the same metrics.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401 — registers the JAX kernels
import paddle_tpu.v2 as jv2
from paddle_tpu.core.desc import OpDesc as JOpDesc
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.fluid import executor as jexec
from paddle_tpu.ops.registry import get_op_info as j_op
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.v2 as tv2
from paddle_tpu_torch.ops import nn as tnn
from paddle_tpu_torch.ops.metrics import auc_thresholds
from paddle_tpu_torch.ops.registry import get_op_info as t_op

import chip_smoke
from test_torch_stack_ops import _compare, _grad_pairs, _run

# the suite runs several test workers at once: one torch thread each
torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
F32_ATOL = 1e-5

CASES = chip_smoke.cli_op_cases()
GRAD_CASES = [c for c in CASES if c[5]]

NEW_OPS = ["lstm_unit", "nce", "bilinear_tensor_product", "conv_shift",
           "cast_embedding_ids", "conv2d_transpose", "hinge_loss",
           "huber_loss", "log_loss", "rank_loss", "margin_rank_loss",
           "modified_huber_loss", "auc", "precision_recall",
           "positive_negative_pair"]


def test_the_cases_cover_every_new_op_type():
    assert len(NEW_OPS) == 15
    assert {c[1] for c in CASES} == set(NEW_OPS) - {"nce"}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    _, op, ins, outs, attrs, _, _, exact = case
    _compare(_run(op, ins, outs, attrs), exact)


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_grad_matches_jax(case):
    _compare(_grad_pairs(case), False)


@pytest.mark.parametrize("n", [2, 7, 200, 1000])
def test_auc_thresholds_are_jnp_linspace(n):
    np.testing.assert_array_equal(auc_thresholds(n),
                                  np.asarray(jnp.linspace(0.0, 1.0, n)))


def test_loss_grads_at_their_ties():
    """The ties by hand: hinge at 1 - (2l - 1) x = 0 and margin_rank at
    -l (x1 - x2) + margin = 0 split their grad in half (jnp.maximum),
    huber at |r| = delta takes the quadratic branch, modified huber at
    z = -1 and z = 1 the middle one; the port's grads are the JAX
    package's there."""
    by_id = {c[0]: c for c in GRAD_CASES}
    pairs = _grad_pairs(by_id["hinge_loss"])
    (j, t), = pairs.values()
    assert float(np.asarray(j)[0, 0]) == pytest.approx(
        -0.5 * float(by_id["hinge_loss"][6]["Loss"][0, 0]))
    np.testing.assert_array_equal(t.numpy()[:3], np.asarray(j)[:3])
    for case in ("huber_loss", "modified_huber_loss", "margin_rank_loss"):
        for j, t in _grad_pairs(by_id[case]).values():
            np.testing.assert_allclose(t.numpy()[:4], np.asarray(j)[:4],
                                       rtol=1e-6, atol=1e-7)


# -- nce ----------------------------------------------------------------------

def _jax_nce(ins, attrs, key=0):
    env = {s.lower(): jnp.asarray(v.numpy()) for s, v in ins.items()}
    ctx = jexec.ExecContext(None, None, 0, env,
                            rng=jax.random.PRNGKey(key))
    outs = {"Cost": ["cost"], "SampleLogits": ["logits"],
            "SampleLabels": ["samples"]}
    jexec.apply_op(ctx, JOpDesc("nce", {s: [s.lower()] for s in ins}, outs,
                                attrs))
    return {s: np.array(ctx.env[n[0]]) for s, n in outs.items()}


@pytest.mark.parametrize("bias", [True, False])
def test_nce_cost_and_grad_match_jax_given_its_samples(bias):
    ins, attrs, og = chip_smoke.nce_inputs()
    if not bias:
        ins.pop("Bias")
    jout = _jax_nce(ins, attrs)
    samples = torch.from_numpy(jout["SampleLabels"])
    cost, logits = tnn.nce_cost(
        ins["Input"], ins["Weight"], ins.get("Bias"), samples,
        attrs["num_total_classes"], 1)
    np.testing.assert_allclose(cost.numpy(), jout["Cost"], atol=F32_ATOL,
                               rtol=0)
    np.testing.assert_allclose(logits.numpy(), jout["SampleLogits"],
                               atol=F32_ATOL, rtol=0)
    jg = j_op("nce").grad_kernel(None, dict(
        {s: [jnp.asarray(v.numpy())] for s, v in ins.items()},
        **{"O@SampleLabels": [jnp.asarray(jout["SampleLabels"])],
           "OG@Cost": [jnp.asarray(og.numpy())]}), attrs)
    if bias:
        tg = chip_smoke.nce_grad_run(ins, attrs, samples, og,
                                     torch.device("cpu"))
    else:
        tg = t_op("nce").grad_kernel(None, dict(
            {s: [v] for s, v in ins.items()},
            **{"O@SampleLabels": [samples], "OG@Cost": [og]}), attrs)
        tg = {k: v[0] for k, v in tg.items()}
    assert set(tg) == set(jg) | ({"Bias@GRAD"} if bias else set())
    for slot, (j,) in jg.items():
        np.testing.assert_allclose(tg[slot].numpy(), np.asarray(j),
                                   atol=F32_ATOL, rtol=0, err_msg=slot)


def test_nce_grad_repeats_bit_for_bit():
    """A repeated sample's weight rows add in a fixed order."""
    ins, attrs, og = chip_smoke.nce_inputs(n=64, classes=6)
    samples = chip_smoke.nce_run(ins, attrs, torch.device("cpu"),
                                 torch.Generator().manual_seed(1))[
        "SampleLabels"]
    a, b = (chip_smoke.nce_grad_run(ins, attrs, samples, og,
                                    torch.device("cpu")) for _ in range(2))
    for slot in a:
        assert chip_smoke.same_bits(a[slot], b[slot]), slot


def test_nce_draw_is_uniform_and_starts_with_the_labels():
    ins, attrs, _ = chip_smoke.nce_inputs(
        n=chip_smoke.CLI_NCE_DRAWS, classes=chip_smoke.CLI_NCE_CLASSES)
    attrs["num_neg_samples"] = chip_smoke.CLI_NCE_NEG
    out = chip_smoke.nce_run(ins, attrs, torch.device("cpu"),
                             torch.Generator().manual_seed(0))
    worst = chip_smoke.nce_draw_check(
        out["SampleLabels"], ins["Label"].to(torch.int32),
        chip_smoke.CLI_NCE_CLASSES, chip_smoke.CLI_NCE_NEG)
    assert worst < 6
    jout = _jax_nce(ins, attrs)
    assert jout["SampleLabels"].shape == tuple(out["SampleLabels"].shape)
    assert jout["SampleLabels"].dtype == np.int32


def test_nce_trains_through_the_port():
    """tests/test_op_coverage.py's nce flow: cost positive, falling over
    5 SGD steps."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[6], dtype="float32")
        lab = tfluid.layers.data(name="lab", shape=[1], dtype="int64")
        cost = tfluid.layers.nce(input=x, label=lab, num_total_classes=20,
                                 num_neg_samples=5)
        loss = tfluid.layers.mean(x=cost)
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(0)
    feeds = {"x": rs.rand(8, 6).astype(np.float32),
             "lab": rs.randint(0, 20, (8, 1)).astype(np.int64)}
    vals = [float(exe.run(main, feed=feeds, fetch_list=[loss],
                          scope=scope)[0][0]) for _ in range(5)]
    assert all(v > 0 for v in vals) and vals[-1] < vals[0], vals


# -- conv2d_transpose under AMP ------------------------------------------------

def test_bf16_conv_transpose_grad_matches_jax():
    """tests/test_amp_bf16.py::test_bf16_conv_transpose_grad's inputs:
    the sum of squares of the output and its grads under bf16_guard()
    on both packages, finite, f32 grads of the inputs' shapes, within
    bf16 rounding (2^-8 of the magnitude) of each other."""
    rs = np.random.RandomState(1)
    x = rs.rand(2, 4, 8, 8).astype(np.float32)
    w = rs.rand(4, 3, 3, 3).astype(np.float32)
    attrs = {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1]}
    jk, tk = j_op("conv2d_transpose").kernel, t_op("conv2d_transpose").kernel

    def jloss(x_, w_):
        out = jk(None, {"Input": [x_], "Filter": [w_]}, attrs)
        return jnp.sum(out["Output"][0].astype(jnp.float32) ** 2)

    def tloss(x_, w_):
        out = tk(None, {"Input": [x_], "Filter": [w_]}, attrs)
        return (out["Output"][0].float() ** 2).sum()

    with jfluid.amp.bf16_guard():
        jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(w))
    with tfluid.amp.bf16_guard():
        tval, tvjp = torch.func.vjp(tloss, torch.from_numpy(x),
                                    torch.from_numpy(w))
        tgrads = tvjp(torch.tensor(1.0))
    assert np.isfinite(float(tval))
    for j, t, ref in zip(jgrads, tgrads, (x, w)):
        assert t.shape == ref.shape and t.dtype == torch.float32
        scale = float(np.abs(np.asarray(j)).max())
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=2 ** -7 * scale)
    np.testing.assert_allclose(float(tval), float(jval), rtol=2 ** -7)
    assert t_op("conv2d_transpose").deterministic


# -- layers and evaluators -------------------------------------------------------

def _fluid_layers(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        lab = fluid.layers.data(name="lab", shape=[1], dtype="int64")
        cost = fluid.layers.nce(input=x, label=lab, num_total_classes=20,
                                num_neg_samples=5,
                                bias_attr=fluid.ParamAttr(name="nce_b"))
        img = fluid.layers.data(name="img", shape=[4, 8, 8],
                                dtype="float32")
        up = fluid.layers.conv2d_transpose(input=img, num_filters=3,
                                           filter_size=3, stride=2,
                                           padding=1)
        up2 = fluid.layers.conv2d_transpose(input=img, num_filters=2,
                                            output_size=16)
        h0 = fluid.layers.data(name="h0", shape=[5], dtype="float32")
        c0 = fluid.layers.data(name="c0", shape=[5], dtype="float32")
        h, c = fluid.layers.lstm_unit(x, h0, c0, forget_bias=0.5)
        loss = fluid.layers.mean(x=cost)
        for v in (up, up2, h, c):
            loss = fluid.layers.elementwise_add(
                x=loss, y=fluid.layers.mean(x=v))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, (h, c, up, up2)


def test_fluid_layers_descs_match_jax():
    jmain, jstart, jouts = _fluid_layers(jfluid)
    tmain, tstart, touts = _fluid_layers(tfluid)
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    assert tstart.desc.to_dict() == jstart.desc.to_dict()
    assert [tuple(v.shape) for v in touts] == [tuple(v.shape) for v in jouts]
    assert touts[3].shape[2:] == (16, 16)


def _v2_layer(v2, fluid, name):
    L, dt = v2.layer, v2.data_type
    rs = np.random.RandomState(16)
    a = L.data(name="a", type=dt.dense_vector(5))
    feed = {"a": rs.randn(4, 5).astype(np.float32)}
    if name == "tensor":
        b = L.data(name="b", type=dt.dense_vector(3))
        feed["b"] = rs.randn(4, 3).astype(np.float32)
        out = L.tensor(a, b, size=2, act=v2.activation.Tanh())
    elif name == "conv_shift":
        b = L.data(name="b", type=dt.dense_vector(3))
        feed["b"] = rs.randn(4, 3).astype(np.float32)
        out = L.conv_shift(a, b)
    elif name == "nce":
        lab = L.data(name="lab", type=dt.integer_value(7))
        feed["lab"] = rs.randint(0, 7, (4, 1)).astype(np.int64)
        out = L.nce(a, lab, num_classes=7, num_neg_samples=3)
    elif name == "rank_cost":
        b = L.data(name="b", type=dt.dense_vector(1))
        lab = L.data(name="lab", type=dt.dense_vector(1))
        w = L.data(name="w", type=dt.dense_vector(1))
        left = L.fc(input=a, size=1)
        feed.update(b=rs.randn(4, 1).astype(np.float32),
                    lab=rs.randint(0, 2, (4, 1)).astype(np.float32),
                    w=rs.rand(4, 1).astype(np.float32))
        out = L.rank_cost(left, b, lab, weight=w)
    else:
        y = L.data(name="y", type=dt.dense_vector(1))
        feed["y"] = rs.randint(0, 2, (4, 1)).astype(np.float32)
        pred = L.fc(input=a, size=1)
        out = (L.huber_regression_cost(pred, y, delta=0.5)
               if name == "huber_regression_cost"
               else L.huber_classification_cost(pred, y))
    return out, feed


V2_NAMES = ["tensor", "conv_shift", "nce", "rank_cost",
            "huber_regression_cost", "huber_classification_cost"]


@pytest.mark.parametrize("name", V2_NAMES)
def test_v2_layer_matches_jax(name):
    """The layer left `_WAITING`; its descs equal the JAX package's and,
    but nce's (whose draws differ), its output from the JAX startup's
    state equals the JAX package's."""
    built = []
    for v2, fluid in ((jv2, jfluid), (tv2, tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            out, feed = _v2_layer(v2, fluid, name)
        built.append((main, startup, out, feed))
    (jmain, jstart, jout, feed), (tmain, tstart, tout, _) = built
    assert tmain.desc.to_dict() == jmain.desc.to_dict()
    assert tstart.desc.to_dict() == jstart.desc.to_dict()
    assert name not in tv2.layer._WAITING
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    state = {n: np.asarray(jscope.get(n))
             for n, vd in tstart.desc.block(0).vars.items()
             if vd.persistable}
    tscope = tfluid.Scope()
    tfluid.io.params_from_numpy(tscope, state, "cpu")
    t, = tfluid.Executor(CPU).run(tmain, feed=feed, fetch_list=[tout],
                                  scope=tscope)
    assert np.isfinite(t).all()
    if name == "nce":
        return
    j, = jexe.run(jmain, feed=feed, fetch_list=[jout], scope=jscope)
    np.testing.assert_allclose(t, np.asarray(j), atol=1e-5, rtol=1e-5)


def test_waiting_names_after_this_slice():
    """No v2 layer name and no evaluator op waits since A10's last op
    groups; the detection evaluator builds its op."""
    assert tv2.layer._WAITING == {}
    assert tv2.evaluator._WAITING_OPS == ()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        det = tfluid.layers.data(name="det", shape=[6], dtype="float32",
                                 lod_level=1)
        gt = tfluid.layers.data(name="gt", shape=[5], dtype="float32",
                                lod_level=1)
        tv2.evaluator.detection_map_evaluator(det, gt)
    assert main.desc.block(0).ops[-1].type == "detection_map"


def _evaluators(v2, fluid, which):
    main, startup = fluid.Program(), fluid.Program()
    rs = np.random.RandomState(0)
    with fluid.program_guard(main, startup):
        if which == "positive_label":
            x = v2.layer.data(name="x", type=v2.data_type.dense_vector(3))
            lab = v2.layer.data(name="lab",
                                type=v2.data_type.integer_value(3))
            fetch = [v2.evaluator.precision_recall_evaluator(
                input=x, label=lab, positive_label=1)]
            feed = {"x": np.array([[0.1, 0.8, 0.1], [0.2, 0.7, 0.1],
                                   [0.9, 0.05, 0.05], [0.1, 0.1, 0.8]],
                                  np.float32),
                    "lab": np.array([[1], [0], [1], [2]], np.int64)}
        elif which == "dsl":
            x = v2.layer.data(name="x", type=v2.data_type.dense_vector(4))
            lab = v2.layer.data(name="lab",
                                type=v2.data_type.integer_value(4))
            probs = v2.layer.fc(input=x, size=4,
                                act=v2.activation.Softmax())
            fetch = [v2.evaluator.classification_error_evaluator(
                         input=probs, label=lab),
                     v2.evaluator.precision_recall_evaluator(input=probs,
                                                             label=lab)]
            feed = {"x": rs.rand(6, 4).astype(np.float32),
                    "lab": rs.randint(0, 4, (6, 1)).astype(np.int64)}
        elif which == "auc":
            score = v2.layer.data(name="score",
                                  type=v2.data_type.dense_vector(2))
            blab = v2.layer.data(name="blab",
                                 type=v2.data_type.integer_value(2))
            fetch = [v2.evaluator.auc_evaluator(input=score, label=blab)]
            feed = {"score": np.array([[0.1, 0.9], [0.8, 0.2]], np.float32),
                    "blab": np.array([[1], [0]], np.int64)}
        else:
            s = v2.layer.data(name="s", type=v2.data_type.dense_vector(1))
            lab = v2.layer.data(name="lab",
                                type=v2.data_type.dense_vector(1))
            q = v2.layer.data(name="q", type=v2.data_type.integer_value(9))
            w = v2.layer.data(name="w", type=v2.data_type.dense_vector(1))
            fetch = v2.evaluator.pnpair_evaluator(input=s, label=lab,
                                                  query_id=q, weight=w)
            feed = {"s": np.array([[0.8], [0.2], [0.5], [0.6], [0.5]],
                                  np.float32),
                    "lab": np.array([[1], [0], [1], [0], [0]], np.float32),
                    "q": np.array([[1], [1], [2], [2], [2]], np.int64),
                    "w": np.array([[1], [2], [1], [3], [1]], np.float32)}
    return main, startup, fetch, feed


@pytest.mark.parametrize("which", ["positive_label", "dsl", "auc", "pnpair"])
def test_evaluators_match_jax(which):
    """tests/test_evaluators.py's flows (and a pnpair evaluator): the
    same descs, and the same metrics from the JAX startup's state."""
    (jm, js, jf, feed), (tm, ts, tf, _) = (
        _evaluators(jv2, jfluid, which), _evaluators(tv2, tfluid, which))
    assert tm.desc.to_dict() == jm.desc.to_dict()
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    state = {n: np.asarray(jscope.get(n))
             for n, vd in ts.desc.block(0).vars.items() if vd.persistable}
    tscope = tfluid.Scope()
    tfluid.io.params_from_numpy(tscope, state, "cpu")
    jv = jexe.run(jm, feed=feed, fetch_list=jf, scope=jscope)
    tv = tfluid.Executor(CPU).run(tm, feed=feed, fetch_list=tf,
                                  scope=tscope)
    for j, t in zip(jv, tv):
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-6, atol=1e-7)
    if which == "positive_label":
        np.testing.assert_allclose(tv[0].reshape(-1), [0.5] * 3,
                                   atol=1e-5)
    if which == "auc":
        assert float(tv[0].reshape(-1)[0]) > 0.9
